"""Instance arena: pack heterogeneous scheduling instances into fixed-shape
padded arrays so the engine can batch whole populations at once.

Two levels of grouping (DESIGN.md ## Engine):

* **exact buckets** — instances sharing the structural key
  ``(topology, has_returns, m, T, q)`` have identical recurrence *and* LP
  shapes; they batch with no padding at all.  This is what the batched
  simplex path requires (the completeness rows depend on the cell -> load
  map, which the ``q`` tuple fixes; the precedence-row pattern depends on
  the topology and on whether the result-return phase is active, which the
  two leading key components fix).
* **shape ladder** — for the simulator-only paths (adversary sweeps,
  Monte-Carlo what-ifs) the arena can additionally pad every bucket up to
  ladder dimensions ``(m_pad, T_pad)`` (next ladder rung >= the real size) so
  only a handful of compiled shapes ever exist.  Padding semantics:

    - fake processors get ``w_cell = 0`` rows (their compute durations are
      identically zero) and ``tau = 0``;
    - fake links get ``z = latency = 0`` (zero-duration messages);
    - fake trailing cells get ``vcomm = vcomp = release = return_ratio = 0``
      and are marked invalid in ``cell_valid`` — crucially their *latency
      contribution is masked to zero* (forward and return phases alike) so
      the ASAP recurrence over padded cells can never push any time past the
      real makespan (every padded comm/comp/return end is a max of
      already-existing times plus zero).

All packed arrays are float64 — the engine bit-matches the NumPy simulator.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.instance import Instance
from repro_torch.core.keys import instance_bucket_key
from repro_torch.obs import metrics as obs_metrics

__all__ = ["PackedBucket", "InstanceArena", "pack_instances"]

# default shape ladder: powers of two-ish rungs keep recompiles rare
_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _rung(x: int, ladder=_LADDER) -> int:
    for r in ladder:
        if x <= r:
            return r
    return x


@dataclasses.dataclass
class PackedBucket:
    """One fixed-shape batch of instances (all arrays numpy float64).

    ``m``/``T`` are the *padded* dims; ``m_real``/``T_real`` the common real
    dims of the member instances (exact bucketing means these agree across
    the batch).  ``indices`` maps batch rows back to the caller's order.
    """

    key: tuple  # (topology, has_returns, m_real, T_real, q)
    instances: list
    indices: list
    m: int
    T: int
    m_real: int
    T_real: int
    q: tuple
    topology: str  # "chain" | "star" — shared by the whole bucket
    has_returns: bool  # result-return phase active (shared by the bucket)
    w_cell: np.ndarray  # [B, m, T]   w_i(n_t)  (0 on padding)
    z: np.ndarray  # [B, m-1]    seconds/unit over link i (0 on padding)
    latency: np.ndarray  # [B, m-1]    K_i (0 on padding)
    tau: np.ndarray  # [B, m]      availability dates (0 on padding)
    vcomm_cell: np.ndarray  # [B, T]  V_comm(n_t) (0 on padding)
    vcomp_cell: np.ndarray  # [B, T]  V_comp(n_t) (0 on padding)
    rel_cell: np.ndarray  # [B, T]   release(n_t) (0 on padding)
    ret_cell: np.ndarray  # [B, T]   return_ratio(n_t) (0 on padding)
    cell_valid: np.ndarray  # [T] bool — trailing padding cells are False
    load_of_cell: np.ndarray  # [T] int — cell -> load (-1 on padding)
    n_loads: int

    @property
    def B(self) -> int:
        return len(self.instances)

    def gamma_padded(self, gammas: list) -> np.ndarray:
        """Stack per-instance gamma [m_real, T_real] into [B, m, T] with 0-pad."""
        out = np.zeros((self.B, self.m, self.T))
        for b, g in enumerate(gammas):
            g = np.asarray(g, dtype=np.float64)
            if g.shape != (self.m_real, self.T_real):
                raise ValueError(
                    f"gamma[{b}] must be [{self.m_real}, {self.T_real}], got {g.shape}"
                )
            out[b, : self.m_real, : self.T_real] = g
        return out

    def basis_padded(self, bases: list, n_rows: int) -> np.ndarray | None:
        """Stack per-instance warm-start bases into the [B, n_rows] int64
        array :func:`solve_simplex_batched` expects.

        ``bases`` holds one entry per batch row: a length-``n_rows`` int
        sequence (a carried exit basis) or ``None`` for a cold start.  Rows
        whose entry is missing — or whose length disagrees with this
        bucket's LP row count (a replan that changed ``q``/topology moved
        the instance to a different bucket shape) — are filled with ``-1``,
        which the solver treats as "no seed".  Returns ``None`` when no row
        carries a usable seed, so cold bulk solves pay nothing.
        """
        if n_rows <= 0:
            return None
        out = np.full((self.B, n_rows), -1, dtype=np.int64)
        any_seed = False
        for b, basis in enumerate(bases):
            if basis is None:
                continue
            arr = np.asarray(basis, dtype=np.int64).reshape(-1)
            if arr.shape[0] != n_rows:
                continue
            out[b] = arr
            any_seed = True
        return out if any_seed else None

    def unpad(self, arr: np.ndarray) -> np.ndarray:
        """Strip processor/cell padding from a [B, m(,−1), T]-shaped result."""
        if arr.ndim == 3 and arr.shape[1] == self.m:
            return arr[:, : self.m_real, : self.T_real]
        if arr.ndim == 3 and arr.shape[1] == self.m - 1:
            return arr[:, : max(self.m_real - 1, 0), : self.T_real]
        if arr.ndim == 2:
            return arr[:, : self.T_real]
        return arr


def _pack_group(members: list, m_pad: int, T_pad: int, locs: np.ndarray) -> dict:
    """Pack a group of same-shape instances into preallocated [B, ...] arrays
    (``locs`` [T_real] is the shared cell -> load map)."""
    B = len(members)
    m = members[0].m
    T = locs.shape[0]
    out = dict(
        w_cell=np.zeros((B, m_pad, T_pad)),
        z=np.zeros((B, max(m_pad - 1, 0))),
        latency=np.zeros((B, max(m_pad - 1, 0))),
        tau=np.zeros((B, m_pad)),
        vcomm_cell=np.zeros((B, T_pad)),
        vcomp_cell=np.zeros((B, T_pad)),
        rel_cell=np.zeros((B, T_pad)),
        ret_cell=np.zeros((B, T_pad)),
    )
    for b, inst in enumerate(members):
        if inst.w_per_load is not None:
            out["w_cell"][b, :m, :T] = inst.w_per_load[:, locs]
        else:
            out["w_cell"][b, :m, :T] = inst.platform.w[:, None]
        out["z"][b, : m - 1] = inst.platform.z
        out["latency"][b, : m - 1] = inst.platform.latency
        out["tau"][b, :m] = inst.platform.tau
        out["vcomm_cell"][b, :T] = inst.loads.v_comm[locs]
        out["vcomp_cell"][b, :T] = inst.loads.v_comp[locs]
        out["rel_cell"][b, :T] = inst.loads.release[locs]
        out["ret_cell"][b, :T] = inst.loads.return_ratio[locs]
    return out


def pack_instances(instances: list, pad_shapes: bool = False) -> list:
    """Group ``instances`` into :class:`PackedBucket`s.

    With ``pad_shapes=True`` the bucket dims are rounded up the shape ladder
    (simulator paths — few compiled shapes); with ``False`` the packed dims
    equal the real dims (LP paths — exact shapes required).
    """
    groups: dict[tuple, list] = {}
    for idx, inst in enumerate(instances):
        # the one canonical structural key (repro_torch.core.keys): identical
        # Problem.key() => identical bucket here, by construction
        groups.setdefault(instance_bucket_key(inst), []).append(idx)

    buckets = []
    for key in sorted(groups):
        topology, has_returns, m_real, T_real, q = key
        idxs = groups[key]
        m_pad = _rung(m_real) if pad_shapes else m_real
        T_pad = _rung(T_real) if pad_shapes else T_real
        members = [instances[i] for i in idxs]
        locs = np.array([n for n, _ in members[0].cells()], dtype=np.int64)
        stack = _pack_group(members, m_pad, T_pad, locs)
        cell_valid = np.zeros(T_pad, dtype=bool)
        cell_valid[:T_real] = True
        load_of_cell = np.full(T_pad, -1, dtype=np.int64)
        load_of_cell[:T_real] = locs
        buckets.append(
            PackedBucket(
                key=key,
                instances=members,
                indices=idxs,
                m=m_pad,
                T=T_pad,
                m_real=m_real,
                T_real=T_real,
                q=q,
                topology=topology,
                has_returns=has_returns,
                cell_valid=cell_valid,
                load_of_cell=load_of_cell,
                n_loads=members[0].N,
                **stack,
            )
        )
        # padded-cell fraction of the [B, m_pad, T_pad] arrays this bucket
        # ships to the device — the shape-ladder cost the metrics surface
        # (0.0 for the exact LP buckets, which never pad)
        waste = 1.0 - (m_real * T_real) / (m_pad * T_pad)
        met = obs_metrics.get_registry()
        met.set_gauge("repro_engine_bucket_padding_waste_ratio", waste,
                      topology=topology, m=m_real, T=T_real,
                      m_pad=m_pad, T_pad=T_pad)
        met.inc("repro_engine_bucket_packs_total", topology=topology,
                padded=str(bool(pad_shapes)).lower())
        met.inc("repro_engine_bucket_elements_total", len(members),
                topology=topology)
    return buckets


class InstanceArena:
    """The batching front door: pack once, fan results back in caller order."""

    def __init__(self, instances: list, pad_shapes: bool = False):
        self.instances = list(instances)
        self.buckets = pack_instances(self.instances, pad_shapes=pad_shapes)

    def __len__(self) -> int:
        return len(self.instances)

    def scatter(self, per_bucket_results: list) -> list:
        """Given one list of per-row results per bucket, restore caller order."""
        out = [None] * len(self.instances)
        for bucket, res in zip(self.buckets, per_bucket_results):
            if len(res) != bucket.B:
                raise ValueError(f"bucket expected {bucket.B} results, got {len(res)}")
            for i, r in zip(bucket.indices, res):
                out[i] = r
        return out
