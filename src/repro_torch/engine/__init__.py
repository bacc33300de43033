"""The batched scheduling engine on a device.

The port of ``repro.engine``: arena packing, the stacked LP build, the
batched two-phase simplex and the batched ASAP replay, behind
:func:`solve_bulk`.  ``device=None`` is the CUDA card; ``device="cpu"``
runs the kernels' plain versions.
"""

from .arena import InstanceArena, PackedBucket, pack_instances
from .batched_sim import makespans, simulate_bucket, simulate_many
from .batched_simplex import STATUS, BatchedSimplexResult, solve_simplex_batched
from .cache import CachedSolution, SolutionCache, instance_key
from .service import CudaBackend, PlanService, TorchBackend, solve_bulk

__all__ = [
    "InstanceArena",
    "PackedBucket",
    "pack_instances",
    "simulate_bucket",
    "simulate_many",
    "makespans",
    "STATUS",
    "BatchedSimplexResult",
    "solve_simplex_batched",
    "CachedSolution",
    "SolutionCache",
    "instance_key",
    "solve_bulk",
    "TorchBackend",
    "CudaBackend",
    "PlanService",
]
