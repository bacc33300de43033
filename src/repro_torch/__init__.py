"""repro_torch — the divisible-load scheduling engine and the dense LM
serving path in PyTorch, for one NVIDIA H100.

A port of the JAX package ``repro`` (which stays as the reference and is
never imported here).  Two main paths:

* :func:`repro_torch.engine.solve_bulk`: cache lookup, arena packing, the
  stacked schedule-LP build, the batched two-phase simplex and the batched
  ASAP replay that certifies every plan, with the simplex pivot and the
  replay in hand-written CUDA kernels;
* :mod:`repro_torch.launch.serve`: prefill + token-by-token decode of a
  dense decoder LM (:mod:`repro_torch.models`), with attention in
  hand-written CUDA kernels (flash attention for the prefill, split-KV
  decode attention for each step).

The kernels live in :mod:`repro_torch.kernels`, their sources in ``csrc/``.

Device rule: ``device=None`` means the CUDA card and raises where there is
none; only an explicit ``device="cpu"`` runs on the CPU, through the
kernels' plain PyTorch versions.
"""

__all__ = ["config", "configs", "convert", "core", "data", "engine", "kernels", "launch",
           "lpir", "models", "obs", "runtime"]
