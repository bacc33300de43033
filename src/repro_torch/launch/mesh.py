"""The chain of stages the DLT runner executes on, and the card's constants:
the port of the reference's ``launch/mesh.py``.

:func:`make_chain_mesh` is a function, not a module-level constant, so
importing this module touches no device and no process group.  In one
process it gives a :class:`repro_torch.runtime.dlt_runner.LocalChain`:
every stage in that process, on one device and one replica (the
counterpart of the reference's forced host devices).  Under an initialised
``torch.distributed`` group of ``n_stages`` processes (``torchrun
--nproc-per-node N``) it gives a
:class:`repro_torch.runtime.dlt_runner.DistChain`: rank = stage.

The reference's ``make_production_mesh`` (a 256/512-chip TPU data x model
mesh) comes with the sharding slice.
"""

from __future__ import annotations

import torch

from repro_torch.convert import resolve_device

__all__ = ["HW", "make_chain_mesh"]


class HW:
    """NVIDIA H100 SXM 80GB constants, per card: NVIDIA's data sheet, dense
    rates (no sparsity) at the 700 W power limit.  The attribute names the
    reference's TPU class has keep their meaning (``PEAK_FLOPS_BF16``,
    ``HBM_BW``, ``HBM_BYTES``)."""

    PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bfloat16 tensor cores, dense (data sheet)
    PEAK_FLOPS_TF32 = 495e12  # FLOP/s, TF32 tensor cores, dense (data sheet)
    PEAK_FLOPS_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores (data sheet)
    PEAK_FLOPS_FP64 = 34e12  # FLOP/s, float64 outside the tensor cores (data sheet)
    HBM_BW = 3.35e12  # B/s, HBM3 (data sheet)
    HBM_BYTES = 80e9  # capacity (data sheet)
    L2_BYTES = 50 << 20  # L2 cache (data sheet: 50 MB)
    NVLINK_BW = 900e9  # B/s, NVLink 4 per card, both directions together (data sheet)


def make_chain_mesh(n_stages: int, device=None):
    """A linear chain of ``n_stages`` stages for the DLT runner.

    With ``torch.distributed`` initialised, its world must be the chain
    (``world_size == n_stages``) and the stage group is a ``DistChain`` over
    it on ``device``; any other world size raises, as the reference raises
    for too few devices.  Otherwise a ``LocalChain`` of ``n_stages`` stages
    on ``device`` (``None``: the card, raising where there is none).
    """
    from repro_torch.runtime.dlt_runner import DistChain, LocalChain

    dev = resolve_device(device)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world != n_stages:
            raise RuntimeError(f"chain of {n_stages} needs a torch.distributed world of "
                               f"{n_stages} processes, found {world}")
        return DistChain(dev)
    return LocalChain(n_stages, dev)
