"""The meshes the port runs on, and the card's constants: the port of the
reference's ``launch/mesh.py``.

:func:`make_production_mesh` is the reference's production mesh as a
``torch.distributed`` ``DeviceMesh``: ``(data=16, model=16)``, 256 ranks,
or ``(pod=2, data=16, model=16)``, 512.  No machine of this project has
that many cards: the dry run (``python -m repro_torch.launch.dryrun --all
--mesh both``) builds it over a fake process group and reads each input's
per-rank shard from DTensor's placements.  :func:`make_data_mesh` is the
``(data=N, model=1)`` mesh of the ``N`` ranks at hand that the training
driver's standard mode shards its state over (FSDP), under ``torchrun``::

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch minitron-8b \\
      --steps 4 --batch 16 --seq 512

:func:`make_chain_mesh` is a function, not a module-level constant, so
importing this module touches no device and no process group.  In one
process it gives a :class:`repro_torch.runtime.dlt_runner.LocalChain`:
every stage in that process, on one device and one replica (the
counterpart of the reference's forced host devices).  Under an initialised
``torch.distributed`` group of ``n_stages`` processes (``torchrun
--nproc-per-node N``) it gives a
:class:`repro_torch.runtime.dlt_runner.DistChain`: rank = stage.
"""

from __future__ import annotations

import math

import torch

from repro_torch.convert import resolve_device

__all__ = ["HW", "make_chain_mesh", "make_production_mesh", "make_data_mesh"]


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


def _world() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _mesh_device_type(device_type) -> str:
    """``None``: the card (raising without one), as every entry point."""
    return resolve_device(device_type).type


def make_production_mesh(*, multi_pod: bool = False, devices=None, device_type=None):
    """The reference's production mesh over the initialised
    ``torch.distributed`` world: ``(16, 16)`` named ``("data", "model")``,
    or with ``multi_pod`` ``(2, 16, 16)`` named ``("pod", "data",
    "model")``, over ``devices`` (global ranks; default: the world's) or
    their first 256 / 512.  Fewer ranks raise, as the reference raises
    for fewer devices.  ``device_type``: ``None`` is the card; the dry run
    passes ``"cpu"`` with a fake process group."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = _mesh_device_type(device_type)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    ranks = list(range(_world())) if devices is None else list(devices)
    if len(ranks) < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, found {len(ranks)} — build it over a fake "
            "process group of that many ranks (dry-run only)")
    return DeviceMesh(device_type, torch.tensor(ranks[:need]).reshape(shape),
                      mesh_dim_names=axes)


def make_data_mesh(device_type=None):
    """The ``(data=N, model=1)`` mesh of the initialised world's ``N``
    ranks (one rank without a process group raises): the training
    driver's data parallelism, the model axis 1 as in the reference's
    ``run_standard``."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _mesh_device_type(device_type)
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the data mesh spans a torch.distributed world: initialise the "
                           "process group first (torchrun sets it up)")
    return init_device_mesh(device_type, (_world(), 1),
                            mesh_dim_names=("data", "model"))
