"""Coefficient views: the adapters that feed :func:`repro_torch.lpir.ir.emit_schedule_ir`.

A view presents one scheduling problem (or a whole packed bucket of them) to
the emitter through a uniform accessor protocol:

  attributes  ``m``, ``T`` (total cells), ``batch`` (None or B),
              ``load_of_cell`` ([T] ints), ``n_loads``,
              ``topology`` ("chain" | "star"),
              ``has_returns`` (bool — emit the result-return phase)
  accessors   ``z(i)``, ``K(i)``          — link i rate / latency
              ``tau(i)``                  — processor availability floor
              ``comm_floor(i)``           — link availability floor (4')
              ``vcomm(t)``, ``vcomp(t)``  — cell t volumes
              ``rel(t)``                  — cell t release date
              ``ret(t)``                  — cell t result-return ratio
              ``w(i, t)``                 — seconds/unit for P_i on cell t

Scalar views return Python floats; :class:`BucketView` returns ``[B]``
vectors.  numpy broadcasting makes the emitter's arithmetic identical over
both, which is what lets every constraint family be written exactly once.

``topology``/``has_returns`` are *structural* — they select which families
the emitter walks and therefore the row pattern — so for a bucket view they
must be shared by the whole batch (the arena's bucket key guarantees this).
"""

from __future__ import annotations

import numpy as np

__all__ = ["InstanceView", "BucketView", "EqualFinishView", "PerturbedView"]


class InstanceView:
    """One :class:`repro_torch.core.instance.Instance` — scalar coefficients."""

    batch = None

    def __init__(self, inst):
        self.inst = inst
        self.m = inst.m
        self.load_of_cell = [n for n, _ in inst.cells()]
        self.T = len(self.load_of_cell)
        self.n_loads = inst.N
        self.topology = inst.topology
        self.has_returns = inst.has_returns

    def z(self, i):
        return float(self.inst.platform.z[i])

    def K(self, i):
        return float(self.inst.platform.latency[i])

    def tau(self, i):
        return float(self.inst.platform.tau[i])

    def comm_floor(self, i):
        return 0.0  # links start free; heuristics override via EqualFinishView

    def vcomm(self, t):
        return float(self.inst.loads.v_comm[self.load_of_cell[t]])

    def vcomp(self, t):
        return float(self.inst.loads.v_comp[self.load_of_cell[t]])

    def rel(self, t):
        return float(self.inst.loads.release[self.load_of_cell[t]])

    def ret(self, t):
        return float(self.inst.loads.return_ratio[self.load_of_cell[t]])

    def w(self, i, t):
        return self.inst.w_of(i, self.load_of_cell[t])


class BucketView:
    """One exact ``(topology, returns, m, T, q)``
    :class:`repro_torch.engine.arena.PackedBucket` — every accessor returns the
    coefficient for ALL B instances at once."""

    def __init__(self, bucket):
        if bucket.m != bucket.m_real or bucket.T != bucket.T_real:
            raise ValueError("LP emission requires an exact (unpadded) bucket")
        self.bucket = bucket
        self.batch = bucket.B
        self.m = bucket.m
        self.T = bucket.T
        self.load_of_cell = [int(x) for x in bucket.load_of_cell]
        self.n_loads = bucket.n_loads
        self.topology = bucket.topology
        self.has_returns = bucket.has_returns

    def z(self, i):
        return self.bucket.z[:, i]

    def K(self, i):
        return self.bucket.latency[:, i]

    def tau(self, i):
        return self.bucket.tau[:, i]

    def comm_floor(self, i):
        return 0.0  # scalar zero broadcasts over the batch

    def vcomm(self, t):
        return self.bucket.vcomm_cell[:, t]

    def vcomp(self, t):
        return self.bucket.vcomp_cell[:, t]

    def rel(self, t):
        return self.bucket.rel_cell[:, t]

    def ret(self, t):
        return self.bucket.ret_cell[:, t]

    def w(self, i, t):
        return self.bucket.w_cell[:, i, t]


class PerturbedView:
    """A coefficient overlay on any base view — same structure, new numbers.

    The replanning building block: online events (a link slowing down, an
    availability date slipping, a release arriving late) change LP
    *coefficients* but not the row pattern, so a basis carried from the base
    view's solve is a legal warm-start seed for the perturbed LP.  This view
    makes that invariant explicit and testable: it delegates every
    structural attribute (``m``, ``T``, ``topology``, ``load_of_cell``, ...)
    to the base view verbatim and only overrides the named coefficient
    accessors.

    Overrides are per-index maps, e.g. ``PerturbedView(base, w={(1, 0):
    2.5}, z={0: 0.3}, tau={2: 1.0}, rel={1: 4.0})`` — any index not named
    falls through to the base.  Structural perturbations (processor loss, a
    new load) are NOT expressible here by design: those change the row
    pattern and must rebuild the view (and solve cold).
    """

    _SCALAR = ("z", "K", "tau", "comm_floor", "vcomm", "vcomp", "rel", "ret")

    def __init__(self, base, w: dict | None = None, **overrides):
        unknown = set(overrides) - set(self._SCALAR)
        if unknown:
            raise ValueError(
                f"unknown coefficient families {sorted(unknown)}; "
                f"perturbable: {sorted(self._SCALAR + ('w',))}")
        self.base = base
        self.m = base.m
        self.T = base.T
        self.batch = base.batch
        self.load_of_cell = base.load_of_cell
        self.n_loads = base.n_loads
        self.topology = base.topology
        self.has_returns = base.has_returns
        self._w = dict(w or {})
        self._over = {k: dict(v) for k, v in overrides.items()}

    def _get(self, family: str, idx):
        over = self._over.get(family)
        if over is not None and idx in over:
            return float(over[idx])
        return getattr(self.base, family)(idx)

    def z(self, i):
        return self._get("z", i)

    def K(self, i):
        return self._get("K", i)

    def tau(self, i):
        return self._get("tau", i)

    def comm_floor(self, i):
        return self._get("comm_floor", i)

    def vcomm(self, t):
        return self._get("vcomm", t)

    def vcomp(self, t):
        return self._get("vcomp", t)

    def rel(self, t):
        return self._get("rel", t)

    def ret(self, t):
        return self._get("ret", t)

    def w(self, i, t):
        if (i, t) in self._w:
            return float(self._w[(i, t)])
        return self.base.w(i, t)


class EqualFinishView:
    """The [18]/[19] per-load building block as a one-cell chain problem.

    One load ``n`` of ``inst``, distributed in a single installment, with the
    platform state injected as floors: ``proc_free`` becomes the availability
    family (10) and ``link_ready`` the link-availability family (4').  Paired
    with ``emit_schedule_ir(..., equal_finish=participants)`` this reproduces
    the equal-finish sub-LP the heuristics solve per load.  The heuristics
    are chain-only, so this view is always a chain with no return phase.
    """

    batch = None
    T = 1
    load_of_cell = (0,)
    n_loads = 1
    topology = "chain"
    has_returns = False

    def __init__(self, inst, n: int, proc_free, link_ready):
        self.inst = inst
        self.n = n
        self.m = inst.m
        self.proc_free = np.asarray(proc_free, dtype=np.float64)
        self.link_ready = np.asarray(link_ready, dtype=np.float64)

    def z(self, i):
        return float(self.inst.platform.z[i])

    def K(self, i):
        return float(self.inst.platform.latency[i])

    def tau(self, i):
        return float(self.proc_free[i])

    def comm_floor(self, i):
        return float(self.link_ready[i])

    def vcomm(self, t):
        return float(self.inst.loads.v_comm[self.n])

    def vcomp(self, t):
        return float(self.inst.loads.v_comp[self.n])

    def rel(self, t):
        return float(self.inst.loads.release[self.n])

    def ret(self, t):
        return 0.0

    def w(self, i, t):
        return self.inst.w_of(i, self.n)
