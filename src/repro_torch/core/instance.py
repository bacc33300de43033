"""Problem instances for divisible-load scheduling on linear and star platforms.

Faithful to Gallet–Robert–Vivien (INRIA RR-6235, 2007), §2, generalized to a
:class:`Topology` abstraction with two concrete families:

* :class:`Chain` — a linear chain of ``m`` processors ``P_1 .. P_m``; link
  ``l_i`` connects ``P_i -> P_{i+1}`` and data is store-and-forwarded down the
  chain (the paper's platform);
* :class:`Star` — a bus/one-port master ``P_0`` with ``m-1`` heterogeneous
  workers; link ``l_i`` connects the master directly to worker ``P_{i+1}``
  and the master's single port serializes all sends (Marchal–Rehn–Robert–
  Vivien, "Scheduling and data redistribution strategies on star platforms").

Both families share the same array shapes — ``w``/``tau`` are [m] and
``z``/``latency`` are [m-1] — so every packing/batching layer stays
shape-compatible; only the precedence structure (and hence the emitted LP
families and the ASAP recurrence) differs, dispatched on ``Topology.kind``.

Common model ingredients (paper §2/§5):

* ``P_i`` is available from ``tau_i`` and computes a unit load in ``w_i``
  seconds (optionally ``w_i^n`` per load — the *unrelated machines* extension
  of §5);
* link ``i`` transmits a unit load in ``z_i`` seconds; the §5 *affine*
  extension adds a per-message startup latency ``K_i`` (seconds) so a message
  of volume ``v`` costs ``K_i + z_i * v``;
* ``N`` divisible loads, load ``n`` with data volume ``V_comm(n)`` and compute
  volume ``V_comp(n)``, optionally a release date (§5 extension) and a
  *result-return ratio* ``r_n``: after a processor computes its fraction, a
  result message of ``r_n * V_comm(n) * fraction`` flows back toward the data
  source (Wu–Cao–Robertazzi-style result collection; ``r_n = 0`` — the
  default — is the paper's no-return model and produces bit-identical LPs);
* load ``n`` is distributed in ``Q_n`` installments; installment ``j`` assigns
  fraction ``gamma[i, n, j]`` to ``P_i``.

All arrays are numpy float64; indices are 0-based throughout the code base
(the paper is 1-based).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["Topology", "Chain", "Star", "Loads", "Instance", "random_instance"]


def _as1d(x, n: int, name: str) -> np.ndarray:
    a = np.asarray(x, dtype=np.float64)
    if a.ndim == 0:
        a = np.full(n, float(a))
    if a.shape != (n,):
        raise ValueError(f"{name}: expected shape ({n},), got {a.shape}")
    return a


@dataclasses.dataclass(frozen=True)
class Topology:
    """Shared platform state for every topology family.

    Attributes:
      w:       [m] seconds per unit compute volume on ``P_i`` (uniform-machine
               model).  For the unrelated-machine extension pass ``w_per_load``
               of shape [m, N] to :class:`Instance` instead.
      z:       [m-1] seconds per unit data volume over link ``i``.
      tau:     [m] availability date of ``P_i`` (default 0).
      latency: [m-1] per-message startup cost ``K_i`` in seconds (default 0 —
               the paper's linear model; >0 gives the §5 affine model).

    ``kind`` names the concrete family ("chain" / "star") and is what every
    topology-dispatched layer — the IR emitter, the simulators, the replay
    kernel — switches on.
    """

    w: np.ndarray
    z: np.ndarray
    tau: np.ndarray
    latency: np.ndarray

    kind = "abstract"  # class attribute, overridden by the concrete families

    def __init__(self, w, z, tau=0.0, latency=0.0):
        if self.kind not in ("chain", "star"):
            raise TypeError(
                "Topology is abstract — instantiate Chain or Star (or a "
                "subclass that sets a registered `kind`)"
            )
        w = np.asarray(w, dtype=np.float64)
        m = w.shape[0]
        if m < 1:
            raise ValueError("need at least one processor")
        object.__setattr__(self, "w", w)
        object.__setattr__(self, "z", _as1d(z, m - 1, "z"))
        object.__setattr__(self, "tau", _as1d(tau, m, "tau"))
        object.__setattr__(self, "latency", _as1d(latency, m - 1, "latency"))
        if np.any(self.w <= 0) or np.any(self.z < 0):
            raise ValueError("w must be > 0 and z >= 0")
        if np.any(self.latency < 0) or np.any(self.tau < 0):
            raise ValueError("latency and tau must be >= 0")

    @property
    def m(self) -> int:
        return int(self.w.shape[0])

    def with_speeds(self, w) -> "Topology":
        """Straggler mitigation: same platform with updated compute speeds."""
        return type(self)(w=w, z=self.z, tau=self.tau, latency=self.latency)


class Chain(Topology):
    """A heterogeneous linear chain of processors (the paper's platform).

    Link ``i`` connects ``P_i -> P_{i+1}``; data destined past ``P_i`` is
    store-and-forwarded, so link ``i`` carries the *suffix* volume
    ``sum_{k>i} gamma[k]`` of every installment.
    """

    kind = "chain"

    def drop_processor(self, i: int) -> "Chain":
        """Elasticity: remove processor ``i`` from the chain.

        The two links adjacent to ``P_i`` are fused: data that used to be
        forwarded through ``P_i`` now flows over a single link whose per-unit
        time is the sum (store-and-forward through a dead stage is simply the
        concatenated path; latencies add likewise).  Dropping ``P_0`` promotes
        ``P_1`` to chain head (it must already hold / receive the data, which
        the checkpoint-restore path guarantees).
        """
        m = self.m
        if not (0 <= i < m):
            raise IndexError(i)
        if m == 1:
            raise ValueError("cannot drop the only processor")
        w = np.delete(self.w, i)
        tau = np.delete(self.tau, i)
        if i == 0:
            z, lat = self.z[1:], self.latency[1:]
        elif i == m - 1:
            z, lat = self.z[:-1], self.latency[:-1]
        else:
            z = np.concatenate([self.z[: i - 1], [self.z[i - 1] + self.z[i]], self.z[i + 1 :]])
            lat = np.concatenate(
                [self.latency[: i - 1], [self.latency[i - 1] + self.latency[i]], self.latency[i + 1 :]]
            )
        return Chain(w=w, z=z, tau=tau, latency=lat)


class Star(Topology):
    """A bus/one-port master with heterogeneous workers.

    ``P_0`` is the master (it holds all load data and may compute itself);
    link ``i`` (``i = 0..m-2``) connects the master directly to worker
    ``P_{i+1}`` and carries only that worker's own fraction — no forwarding.
    The master's single send port serializes all outgoing messages in the
    fixed distribution order (cells lexicographic, workers in index order
    within a cell); result-return messages arrive on a separate receive port
    (full-duplex master), serialized among themselves in the same order.
    """

    kind = "star"

    def drop_processor(self, i: int) -> "Star":
        """Elasticity: remove worker ``i`` (its private link goes with it).

        The master (``i == 0``) cannot be dropped — it owns the data.
        """
        m = self.m
        if not (0 <= i < m):
            raise IndexError(i)
        if i == 0:
            raise ValueError("cannot drop the star master (it holds the data)")
        return Star(
            w=np.delete(self.w, i),
            z=np.delete(self.z, i - 1),
            tau=np.delete(self.tau, i),
            latency=np.delete(self.latency, i - 1),
        )


@dataclasses.dataclass(frozen=True)
class Loads:
    """The N divisible loads, all initially resident on the source processor.

    ``return_ratio[n]`` (default 0) activates the result-return phase for
    load ``n``: a fraction ``gamma`` computed by a processor produces a
    result message of volume ``return_ratio[n] * v_comm[n] * gamma`` that
    must flow back to the source before the load counts as finished.
    """

    v_comm: np.ndarray  # [N] data volume of load n
    v_comp: np.ndarray  # [N] compute volume of load n
    release: np.ndarray  # [N] release date of load n (default 0; §5 extension)
    return_ratio: np.ndarray  # [N] result volume per unit input volume (default 0)

    def __init__(self, v_comm, v_comp, release=0.0, return_ratio=0.0):
        v_comm = np.asarray(v_comm, dtype=np.float64)
        n = v_comm.shape[0]
        object.__setattr__(self, "v_comm", v_comm)
        object.__setattr__(self, "v_comp", _as1d(v_comp, n, "v_comp"))
        object.__setattr__(self, "release", _as1d(release, n, "release"))
        object.__setattr__(self, "return_ratio", _as1d(return_ratio, n, "return_ratio"))
        if np.any(self.v_comm < 0) or np.any(self.v_comp <= 0):
            raise ValueError("v_comm must be >= 0 and v_comp > 0")
        if np.any(self.return_ratio < 0):
            raise ValueError("return_ratio must be >= 0")

    @property
    def N(self) -> int:
        return int(self.v_comm.shape[0])


@dataclasses.dataclass(frozen=True)
class Instance:
    """A complete scheduling instance: platform + loads + installments per load.

    ``platform`` is any :class:`Topology` (``chain`` is kept as a read alias
    for the historical field name).  ``q[n]`` is the number of installments
    for load ``n`` (paper's ``Q_n``).  ``w_per_load`` (optional, [m, N])
    activates the unrelated-machine model of §5 (``w_i^n``); when given it
    overrides ``platform.w`` per load.
    """

    platform: Topology
    loads: Loads
    q: tuple
    w_per_load: np.ndarray | None = None

    def __init__(self, platform: Topology, loads: Loads, q: Sequence[int] | int = 1, w_per_load=None):
        object.__setattr__(self, "platform", platform)
        object.__setattr__(self, "loads", loads)
        if isinstance(q, (int, np.integer)):
            q = [int(q)] * loads.N
        q = tuple(int(x) for x in q)
        if len(q) != loads.N or any(x < 1 for x in q):
            raise ValueError("q must give >=1 installments for each of the N loads")
        object.__setattr__(self, "q", q)
        if w_per_load is not None:
            w_per_load = np.asarray(w_per_load, dtype=np.float64)
            if w_per_load.shape != (platform.m, loads.N):
                raise ValueError(f"w_per_load must be [m,N]={platform.m, loads.N}")
        object.__setattr__(self, "w_per_load", w_per_load)

    @property
    def chain(self) -> Topology:
        """Historical alias: the platform (not necessarily a Chain)."""
        return self.platform

    @property
    def topology(self) -> str:
        """The platform family tag every dispatch layer switches on."""
        return self.platform.kind

    @property
    def has_returns(self) -> bool:
        """True when any load activates the result-return phase."""
        return bool(np.any(self.loads.return_ratio > 0.0))

    @property
    def m(self) -> int:
        return self.platform.m

    @property
    def N(self) -> int:
        return self.loads.N

    def w_of(self, i: int, n: int) -> float:
        """Seconds per unit compute volume for processor i on load n."""
        if self.w_per_load is not None:
            return float(self.w_per_load[i, n])
        return float(self.platform.w[i])

    def with_q(self, q) -> "Instance":
        return Instance(self.platform, self.loads, q, self.w_per_load)

    def cells(self):
        """Iterate (n, j) in the fixed lexicographic distribution order."""
        for n in range(self.N):
            for j in range(self.q[n]):
                yield n, j

    @property
    def total_installments(self) -> int:
        return int(sum(self.q))


def random_instance(
    rng: np.random.Generator,
    m: int = 10,
    n_loads: int = 5,
    q: int = 1,
    heterogeneous: bool = True,
    comm_to_comp: float = 1.0,
    with_latency: bool = False,
    topology: str = "chain",
    return_ratio: float = 0.0,
) -> Instance:
    """Random instances following the experimental protocol of §6.

    Processing powers 10..100 MFLOPS (heterogeneous) or 100 MFLOPS
    (homogeneous); link speeds 10..100 Mb/s; latencies 0.1..1 ms anti-correlated
    with bandwidth; computation volumes 6..60 GFLOP; ``comm_to_comp`` bytes per
    FLOP fixes V_comm.  ``topology`` selects the platform family ("chain" or
    "star" — same parameter distributions, different precedence structure);
    ``return_ratio`` > 0 activates the result-return phase (result bytes per
    input byte, same for every load).
    """
    if heterogeneous:
        power = rng.uniform(10e6, 100e6, size=m)  # FLOP/s
    else:
        power = np.full(m, 100e6)
    w = 1.0 / power
    bw = rng.uniform(10e6 / 8, 100e6 / 8, size=max(m - 1, 0))  # bytes/s from Mb/s
    z = 1.0 / bw
    if with_latency:
        # high bandwidth <-> small latency, as in §6
        frac = (bw - bw.min()) / max(float(np.ptp(bw)), 1e-30) if m > 1 else np.zeros(0)
        lat = (1.0 - frac) * (1e-3 - 1e-4) + 1e-4
    else:
        lat = np.zeros(max(m - 1, 0))
    v_comp = rng.uniform(6e9, 60e9, size=n_loads)  # FLOP
    v_comm = v_comp * comm_to_comp  # bytes
    if topology == "chain":
        platform: Topology = Chain(w=w, z=z, tau=0.0, latency=lat)
    elif topology == "star":
        platform = Star(w=w, z=z, tau=0.0, latency=lat)
    else:
        raise ValueError(f"unknown topology {topology!r} (expected 'chain' or 'star')")
    loads = Loads(v_comm=v_comm, v_comp=v_comp, return_ratio=return_ratio)
    return Instance(platform, loads, q=q)
