"""Campaign specifications: a seeded, deterministic instance grid.

A :class:`CampaignSpec` names every axis of the §6-style experimental
protocol — topology x return_ratio x release x m x n_loads x q x
heterogeneity x comm_to_comp — plus the sampling and solving knobs, and
derives every instance of the campaign **deterministically** from its seed:

* the grid is the cartesian product of the axis tuples, in a fixed
  (sorted-axis) order; each grid point is a *cell* with a canonical
  ``cell_id`` string;
* each (cell, index) pair gets its own ``numpy`` generator seeded by
  ``blake2b(f"{seed}|{cell_id}|{index}")`` — so the instance drawn at a
  grid point depends only on the spec seed and the cell's axis values,
  never on how the grid is ordered or batched, and any single case can be
  re-materialized exactly (:meth:`CampaignSpec.materialize`) from the
  campaign report's ``(cell_id, index)`` coordinates;
* parameter distributions follow :func:`repro_torch.core.instance.random_instance`
  (the paper's §6 protocol: 10..100 MFLOPS, 10..100 Mb/s, 6..60 GFLOP),
  with the release axis drawing per-load release dates against the
  instance's own rough time scale.

Two presets bound the tiers: :func:`smoke_spec` (the >=200-instance CI
gate) and :func:`full_spec` (the >=1000-instance sweep whose result, from
the reference package, is the committed ``bench_out/campaign.json`` /
``benchmarks/campaign_baseline.json``).  A copy of the reference's module:
the grid and every instance are the same; the LP side defaults to the
port's ``"cuda"`` backend.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools

import numpy as np

from repro_torch.core.instance import Instance, Loads, random_instance

__all__ = ["CampaignSpec", "smoke_spec", "full_spec"]

# the grid axes, in canonical order (cell_id segments + slice keys)
AXES = (
    "topology",
    "return_ratio",
    "release",
    "m",
    "n_loads",
    "q",
    "heterogeneous",
    "comm_to_comp",
)


def _tup(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """One campaign: the instance grid + the solving/classification knobs.

    Axis fields (each a tuple of values; the grid is their product):

    * ``topologies`` — platform families ("chain" / "star");
    * ``return_ratios`` — result-return bytes per input byte (0 = the
      paper's no-return model);
    * ``releases`` — False: all loads released at 0; True: per-load release
      dates drawn in [0, 0.3 * rough-makespan];
    * ``m_values`` / ``n_loads_values`` — platform / workload sizes;
    * ``q_values`` — the LP's per-load installment count for the cell (the
      heuristics choose their own structure);
    * ``heterogeneity`` — heterogeneous vs uniform processor speeds;
    * ``comm_to_comp`` — bytes per FLOP (large = expensive communications,
      the regime where the [18]/[19] strategies collapse).

    Solving knobs: ``backend`` serves the LP side through the Session;
    ``matched_backend`` re-solves anomaly candidates at the heuristic's
    exact installment structure (a serial backend — no shape compilation);
    ``multiinst_limit`` bounds the uncapped MULTIINST construction;
    ``matched_t_cap`` bounds the structure size a matched re-solve will
    attempt; ``rtol`` is the classifier's relative tolerance.
    """

    name: str = "custom"
    seed: int = 0
    topologies: tuple = ("chain", "star")
    return_ratios: tuple = (0.0, 0.5)
    releases: tuple = (False, True)
    m_values: tuple = (3, 5)
    n_loads_values: tuple = (2,)
    q_values: tuple = (1, 2)
    heterogeneity: tuple = (True,)
    comm_to_comp: tuple = (0.2, 2.0)
    instances_per_cell: int = 2
    with_latency: bool = True
    backend: str = "cuda"
    matched_backend: str = "auto"
    multiinst_limit: int = 100
    matched_t_cap: int = 64
    rtol: float = 1e-9

    def __post_init__(self):
        for f in ("topologies", "return_ratios", "releases", "m_values",
                  "n_loads_values", "q_values", "heterogeneity", "comm_to_comp"):
            object.__setattr__(self, f, _tup(getattr(self, f)))
        if self.instances_per_cell < 1:
            raise ValueError("instances_per_cell must be >= 1")
        if any(m < 1 for m in self.m_values) or any(n < 1 for n in self.n_loads_values):
            raise ValueError("m_values and n_loads_values must be >= 1")
        if any(q < 1 for q in self.q_values):
            raise ValueError("q_values must be >= 1")

    # ---------------- the grid ----------------

    def cells(self) -> list:
        """Every grid point as an axis->value dict, in canonical order."""
        out = []
        for topo, ret, rel, m, n, q, het, cc in itertools.product(
            self.topologies, self.return_ratios, self.releases, self.m_values,
            self.n_loads_values, self.q_values, self.heterogeneity,
            self.comm_to_comp,
        ):
            out.append({
                "topology": topo, "return_ratio": float(ret),
                "release": bool(rel), "m": int(m), "n_loads": int(n),
                "q": int(q), "heterogeneous": bool(het),
                "comm_to_comp": float(cc),
            })
        return out

    @staticmethod
    def cell_id(cell: dict) -> str:
        """Canonical id string for a grid point (stable across grid order)."""
        return (
            f"{cell['topology']}/ret{cell['return_ratio']:g}"
            f"/rel{int(cell['release'])}/m{cell['m']}/n{cell['n_loads']}"
            f"/q{cell['q']}/het{int(cell['heterogeneous'])}"
            f"/cc{cell['comm_to_comp']:g}"
        )

    @property
    def n_instances(self) -> int:
        return len(self.cells()) * self.instances_per_cell

    # ---------------- deterministic materialization ----------------

    def _rng(self, cell_id: str, index: int) -> np.random.Generator:
        h = hashlib.blake2b(
            f"{self.seed}|{cell_id}|{index}".encode(), digest_size=8
        ).digest()
        return np.random.default_rng(int.from_bytes(h, "big"))

    def materialize(self, cell: dict, index: int) -> Instance:
        """The instance at (cell, index) — exactly reproducible from the
        spec seed and the report's coordinates."""
        rng = self._rng(self.cell_id(cell), index)
        inst = random_instance(
            rng,
            m=cell["m"],
            n_loads=cell["n_loads"],
            q=cell["q"],
            heterogeneous=cell["heterogeneous"],
            comm_to_comp=cell["comm_to_comp"],
            with_latency=self.with_latency,
            topology=cell["topology"],
            return_ratio=cell["return_ratio"],
        )
        if not cell["release"]:
            return inst
        # release dates against the instance's own rough (all-parallel)
        # makespan scale, drawn after the platform/load arrays so the
        # no-release variant of a cell shares nothing but the distribution
        scale = float(np.mean(inst.platform.w) * inst.loads.v_comp.sum()) / inst.m
        release = rng.uniform(0.0, 0.3 * scale, size=inst.N)
        loads = Loads(
            v_comm=inst.loads.v_comm, v_comp=inst.loads.v_comp,
            release=release, return_ratio=inst.loads.return_ratio,
        )
        return Instance(inst.platform, loads, q=inst.q)

    def instances(self):
        """Yield (cell, index, instance) over the whole campaign, in the
        canonical grid order."""
        for cell in self.cells():
            for index in range(self.instances_per_cell):
                yield cell, index, self.materialize(cell, index)

    # ---------------- serialization ----------------

    def to_dict(self) -> dict:
        """JSON-safe canonical form (recorded verbatim in campaign.json)."""
        return {
            "name": self.name,
            "seed": int(self.seed),
            "topologies": list(self.topologies),
            "return_ratios": [float(r) for r in self.return_ratios],
            "releases": [bool(r) for r in self.releases],
            "m_values": [int(m) for m in self.m_values],
            "n_loads_values": [int(n) for n in self.n_loads_values],
            "q_values": [int(q) for q in self.q_values],
            "heterogeneity": [bool(h) for h in self.heterogeneity],
            "comm_to_comp": [float(c) for c in self.comm_to_comp],
            "instances_per_cell": int(self.instances_per_cell),
            "with_latency": bool(self.with_latency),
            "backend": self.backend,
            "matched_backend": self.matched_backend,
            "multiinst_limit": int(self.multiinst_limit),
            "matched_t_cap": int(self.matched_t_cap),
            "rtol": float(self.rtol),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CampaignSpec":
        kw = dict(d)
        kw["topologies"] = tuple(kw.pop("topologies"))
        kw["return_ratios"] = tuple(kw.pop("return_ratios"))
        kw["releases"] = tuple(kw.pop("releases"))
        kw["m_values"] = tuple(kw.pop("m_values"))
        kw["n_loads_values"] = tuple(kw.pop("n_loads_values"))
        kw["q_values"] = tuple(kw.pop("q_values"))
        kw["heterogeneity"] = tuple(kw.pop("heterogeneity"))
        kw["comm_to_comp"] = tuple(kw.pop("comm_to_comp"))
        return cls(**kw)


def smoke_spec(backend: str = "cuda") -> CampaignSpec:
    """The CI tier: >=200 instances spanning topology x returns x release
    x q, with a bounded set of engine bucket shapes (compile time)."""
    return CampaignSpec(
        name="smoke",
        seed=20260808,
        topologies=("chain", "star"),
        return_ratios=(0.0, 0.5),
        releases=(False, True),
        m_values=(3, 5),
        n_loads_values=(2,),
        q_values=(1, 2),
        heterogeneity=(True,),
        # 0.02 is the cheap-communication regime where MULTIINST's lambda
        # stays below the divergence bound and the [19] strategies actually
        # produce schedules; 2.0 is the regime where they collapse (§3.4)
        comm_to_comp=(0.02, 2.0),
        instances_per_cell=4,
        backend=backend,
    )


def full_spec(backend: str = "cuda") -> CampaignSpec:
    """The nightly/manual tier: >=1000 instances, every axis widened.

    The reference package's result is the committed
    ``bench_out/campaign.json`` and the domination baseline
    ``benchmarks/campaign_baseline.json``."""
    return CampaignSpec(
        name="full",
        seed=20260808,
        topologies=("chain", "star"),
        return_ratios=(0.0, 0.25, 0.75),
        releases=(False, True),
        m_values=(2, 4, 8),
        n_loads_values=(1, 3),
        q_values=(1, 2, 4),
        heterogeneity=(True, False),
        comm_to_comp=(0.02, 0.5, 5.0),
        instances_per_cell=1,
        backend=backend,
    )
