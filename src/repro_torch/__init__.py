"""repro_torch — the divisible-load scheduling engine in PyTorch, for one
NVIDIA H100.

A port of the JAX package ``repro`` (which stays as the reference and is
never imported here).  The main path is :func:`repro_torch.engine.solve_bulk`:
cache lookup, arena packing, the stacked schedule-LP build, the batched
two-phase simplex and the batched ASAP replay that certifies every plan,
with the simplex pivot and the replay in hand-written CUDA kernels
(:mod:`repro_torch.kernels`, sources in ``csrc/``).

Device rule: ``device=None`` means the CUDA card and raises where there is
none; only an explicit ``device="cpu"`` runs on the CPU, through the
kernels' plain PyTorch versions.
"""

__all__ = ["core", "engine", "kernels", "lpir", "obs", "convert"]
