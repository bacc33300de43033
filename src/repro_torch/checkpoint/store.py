"""Atomic, async checkpointing: the port of the reference's
``checkpoint/store.py``, in its on-disk format.

Layout: ``<dir>/step_<k>/{manifest.json, arrays.npz}`` (written under
``step_<k>.tmp`` and renamed when complete, so a crash never leaves a torn
checkpoint).  The arrays are keyed by the reference's flatten of its tree:
a :class:`~repro_torch.runtime.TrainState` is stored as the reference's
``TrainState`` (``params/embed``, ``params/blocks/attn/w_q`` with the
blocks stacked ``[L, ...]``, ``opt/step``, ``opt/m/...``, ``opt/v/...``), so
a checkpoint of either package restores into the other.  Blocks are
stacked and split a leaf at a time on the host.  A bfloat16 leaf is stored
as the reference stores it: its 16-bit patterns (``|V2`` in the npz) and
``"bfloat16"`` in the manifest.

A tree to save is a ``TrainState`` or nested dicts of tensors or NumPy
arrays; a tree to restore into is a ``TrainState``.

A state sharded over data ranks (:func:`repro_torch.runtime.sharding.shard_model`)
is saved in the same format: every rank calls :func:`save_checkpoint` (or
the manager's ``save_async``, then synchronous), each leaf is gathered whole
in turn (``full_tensor()``, a collective), and rank 0 alone writes it, so the
host holds one leaf at a time.  It is restored into a sharded target, each
rank keeping its own shard of every leaf: the counterpart of the
reference's ``shardings=``, an elastic restore onto whatever mesh the
target was sharded over (or onto one process, into an unsharded target).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.convert import (array_to_tensor, flatten_tree, reference_key, resolve_device,
                                 tensor_to_numpy, train_state_to_reference)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager",
           "is_sharded_state"]


def _host_leaves(tree) -> dict:
    """The tree's leaves as NumPy by the reference's flat key (a flat dict
    of NumPy by such keys is its own result)."""
    from repro_torch.runtime.train import TrainState

    if isinstance(tree, TrainState):
        return flatten_tree(train_state_to_reference(tree))
    return {k: (tensor_to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in flatten_tree(tree).items()}


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype.kind == "V" and a.dtype.itemsize == 2 else str(a.dtype)


def is_sharded_state(tree) -> bool:
    """A TrainState whose parameters are split over data ranks."""
    from repro_torch.runtime.train import TrainState

    return isinstance(tree, TrainState) and any(isinstance(p, DTensor)
                                                for p in tree.params.parameters())


def _gathered(t: torch.Tensor, lead: bool):
    """A leaf whole on the host, on the lead rank (``None`` elsewhere); a
    DTensor is gathered first, a collective every rank joins."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return tensor_to_numpy(t) if lead else None


def _stream_sharded(state, lead: bool):
    """(key, array) of a sharded TrainState's leaves by the reference's flat
    key, one leaf at a time (``None`` arrays off the lead rank); every rank
    walks the leaves in the same order."""
    def leaves(named: dict, prefix: str):
        groups: dict = {}
        for name, t in named.items():
            key, layer = reference_key(name)
            groups.setdefault(key, []).append((-1 if layer is None else layer, t))
        for key, members in groups.items():
            parts = [_gathered(t, lead) for _, t in sorted(members, key=lambda m: m[0])]
            stacked = members[0][0] >= 0
            yield f"{prefix}{key}", (None if not lead else np.stack(parts) if stacked
                                     else parts[0])

    yield from leaves(dict(state.params.named_parameters()), "params/")
    yield "opt/step", np.asarray(int(state.opt.step), dtype=np.int32) if lead else None
    yield from leaves(state.opt.m, "opt/m/")
    yield from leaves(state.opt.v, "opt/v/")


def _write_leaves(directory: str, step: int, leaves, metadata) -> str:
    """Write (key, array) pairs as ``step_<k>/arrays.npz`` (the members
    ``np.savez`` writes, one at a time) and the manifest; returns the path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shapes, dtypes = {}, {}
    with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), mode="w",
                         compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in leaves:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)
            shapes[key], dtypes[key] = list(arr.shape), _dtype_name(arr)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(shapes),
        "shapes": shapes,
        "dtypes": dtypes,
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def save_checkpoint(directory: str, step: int, tree, metadata: dict | None = None) -> str:
    """Write a checkpoint synchronously; returns the final path.  A sharded
    TrainState is saved by every rank together (rank 0 writes; all return
    once the checkpoint is published)."""
    final = os.path.join(directory, f"step_{step:08d}")
    if is_sharded_state(tree):
        lead = dist.get_rank() == 0
        leaves = _stream_sharded(tree, lead)
        if lead:
            _write_leaves(directory, step, leaves, metadata)
        else:
            for _ in leaves:  # the gathers are collective
                pass
        dist.barrier()
        return final
    return _write_leaves(directory, step, _host_leaves(tree).items(), metadata)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and not name.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _slots(state) -> dict:
    """A TrainState's leaves by the reference's flat key, each as (shape,
    dtype, set): ``set(tensor)`` puts the checkpoint's leaf (stacked for
    the blocks) in its place, split over the layers."""
    from repro_torch.runtime.train import TrainState

    if not isinstance(state, TrainState):
        raise TypeError(f"restores into a TrainState, not a {type(state).__name__}")
    out = {f"params/{k}": v for k, v in
           _named_slots(dict(state.params.named_parameters()), _set_param).items()}
    opt = state.opt
    out["opt/step"] = ((), opt.step.dtype, lambda t: setattr(opt, "step", t), False)
    for what in ("m", "v"):
        out.update({f"opt/{what}/{k}": v
                    for k, v in _named_slots(getattr(opt, what), _set_moment).items()})
    return out


def _copy_shard(cur: DTensor, t: torch.Tensor) -> None:
    """This rank's shard of the whole leaf ``t`` into ``cur``'s local tensor."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(t.shape, cur.device_mesh,
                                                          cur.placements)
    piece = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    with torch.no_grad():
        cur.to_local().copy_(piece)


def _set_param(named: dict, name: str, t: torch.Tensor) -> None:
    if isinstance(named[name], DTensor):
        _copy_shard(named[name], t)
    else:
        named[name].data = t


def _set_moment(named: dict, name: str, t: torch.Tensor) -> None:
    if isinstance(named[name], DTensor):
        _copy_shard(named[name], t)
    else:
        named[name] = t


def _named_slots(named: dict, put) -> dict:
    """Slots of leaves by port name (``blocks.<l>.`` names stacked);
    ``put(named, name, tensor)`` stores one layer's leaf."""
    groups: dict = {}
    for name, t in named.items():
        key, layer = reference_key(name)
        groups.setdefault(key, []).append((layer, name, t))
    out = {}
    for key, members in groups.items():
        members.sort(key=lambda m: -1 if m[0] is None else m[0])
        t0 = members[0][2]
        stacked = members[0][0] is not None
        shape = (len(members), *t0.shape) if stacked else tuple(t0.shape)

        def put_all(t, members=members, stacked=stacked):
            for layer, name, _ in members:
                put(named, name, t[layer] if stacked else t)

        out[key] = (shape, t0.dtype, put_all, isinstance(t0, DTensor))
    return out


def restore_checkpoint(directory: str, step: int, target, device=None):
    """Restore into the structure of ``target``, a TrainState (shapes must
    match; a mismatch raises ``ValueError``): each leaf is read, cast to the
    target leaf's dtype, put on ``device`` (``None``: the card, raising
    without one) and set in ``target`` in place of its tensor.  A sharded
    target (DTensor leaves) keeps its placements: each rank reads the leaf
    and copies its own shard in.  Returns (target, metadata)."""
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, (shape, dtype, put, sharded) in _slots(target).items():
            arr = data[key]
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs target {shape}")
            t = array_to_tensor(arr)
            put(t if sharded else t.to(device=dev, dtype=dtype))  # a shard is cast by its copy
    return target, manifest["metadata"]


class CheckpointManager:
    """Async, bounded-retention checkpoint writer."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree, metadata=None):
        """Snapshot ``tree`` and write it in a thread.  A sharded state is
        saved synchronously by every rank (its gathers are collective; rank
        0 writes and prunes)."""
        self.wait()
        if is_sharded_state(tree):
            save_checkpoint(self.directory, step, tree, metadata)
            if dist.get_rank() == 0:
                self._gc()
            return
        host_tree = _host_leaves(tree)  # snapshot before the next step mutates it

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, metadata)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
