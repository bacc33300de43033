"""repro_torch — the divisible-load scheduling engine and the dense LM
serving path in PyTorch, for one NVIDIA H100.

A port of the JAX package ``repro`` (which stays as the reference and is
never imported here).  Its paths:

* :class:`repro_torch.api.Session`: the planner's front door (declarative
  ``Problem``/``Policy`` in, versioned ``PlanArtifact`` out, coalesced
  submits), and on it the golden campaign (:mod:`repro_torch.eval`) that
  holds the LP against the paper's §3 heuristics;
* :func:`repro_torch.engine.solve_bulk`: cache lookup, arena packing, the
  stacked schedule-LP build, the batched two-phase simplex and the batched
  ASAP replay that certifies every plan, with the simplex pivot and the
  replay in hand-written CUDA kernels;
* :mod:`repro_torch.launch.serve`: prefill + token-by-token decode of a
  dense decoder LM (:mod:`repro_torch.models`), with attention in
  hand-written CUDA kernels (flash attention for the prefill, split-KV
  decode attention for each step) and Mamba-2 / hybrid models (the SSD
  chunked scan).

The kernels live in :mod:`repro_torch.kernels`, their sources in ``csrc/``.

Device rule: ``device=None`` means the CUDA card and raises where there is
none; only an explicit ``device="cpu"`` runs on the CPU, through the
kernels' plain PyTorch versions.
"""

__all__ = ["api", "config", "configs", "convert", "core", "data", "engine", "eval", "kernels",
           "launch", "lpir", "models", "obs", "runtime"]
