"""Devices, and the reference's state carried into the port.

:func:`resolve_device` is the port's one device rule: ``None`` means the
CUDA card, and asking for the card where there is none raises — nothing
moves to the CPU on its own.  Only an explicit ``device="cpu"`` runs there.

:func:`from_reference` turns state of the JAX package, given as NumPy
(instance arrays, packed bucket arrays, LP stacks, cached gammas, warm
bases), into tensors on a device, checking dtypes and shapes.  The port
never imports the JAX package; the state arrives as plain arrays or as
dataclasses whose fields are arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["resolve_device", "from_reference", "instance_from_reference", "to_tensor"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless the "
            "caller passes device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu'; got {dev}")
    return dev


_FLOAT_KINDS = ("f",)
_INT_KINDS = ("i", "u")


def to_tensor(arr, device, dtype=None) -> torch.Tensor:
    """One NumPy array as a contiguous tensor on ``device``.

    Floating arrays must be float64 (the engine is float64 end to end) and
    integer arrays keep their width; booleans stay booleans.  ``dtype``
    converts explicitly (e.g. a bool mask to float64)."""
    a = np.asarray(arr)
    if dtype is None:
        if a.dtype.kind in _FLOAT_KINDS and a.dtype != np.float64:
            raise TypeError(f"expected float64 state, got {a.dtype}")
        if a.dtype.kind not in _FLOAT_KINDS + _INT_KINDS + ("b",):
            raise TypeError(f"cannot carry {a.dtype} state into a tensor")
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype).contiguous()


# expected shapes of the reference's packed bucket fields, by field name,
# in terms of (B, m, T)
_BUCKET_SHAPES = {
    "w_cell": ("B", "m", "T"), "z": ("B", "m-1"), "latency": ("B", "m-1"),
    "tau": ("B", "m"), "vcomm_cell": ("B", "T"), "vcomp_cell": ("B", "T"),
    "rel_cell": ("B", "T"), "ret_cell": ("B", "T"), "cell_valid": ("T",),
    "load_of_cell": ("T",),
}


def _check_bucket(fields: dict) -> None:
    B, m, T = fields["w_cell"].shape
    dims = {"B": B, "m": m, "m-1": m - 1, "T": T}
    for name, spec in _BUCKET_SHAPES.items():
        want = tuple(dims[d] for d in spec)
        got = tuple(np.shape(fields[name]))
        if got != want:
            raise ValueError(f"bucket field {name} is {got}, expected {want}")


def _check_lp_stack(fields: dict) -> None:
    c = np.shape(fields["c"])
    for a, b in (("A_ub", "b_ub"), ("A_eq", "b_eq")):
        A, rhs = np.shape(fields[a]), np.shape(fields[b])
        if len(A) != 3 or rhs != A[:2] or A[2] != c[-1] or (len(c) == 2 and A[0] != c[0]):
            raise ValueError(f"LP stack {a} {A} / {b} {rhs} disagree with c {c}")


def from_reference(state, device=None):
    """The reference's state as tensors on ``device`` (see the module doc).

    ``state`` may be a NumPy array (-> a tensor), a mapping of arrays (->
    a dict of tensors), a dataclass such as the reference's
    ``PackedBucket``, ``BatchedLP`` or ``CachedSolution`` (-> a dict of its
    array fields as tensors; other fields are passed through), or a list of
    any of these.  Packed buckets (``w_cell`` ...) and LP stacks
    (``A_ub``/``b_ub``/``A_eq``/``b_eq`` beside ``c``) are checked for
    consistent shapes.  A list of warm bases with ``None`` rows converts row
    by row, keeping the ``None`` rows."""
    dev = resolve_device(device)
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return [from_reference(s, dev) for s in state]
    if isinstance(state, np.ndarray) or np.isscalar(state):
        return to_tensor(state, dev)
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    elif isinstance(state, dict):
        fields = dict(state)
    else:
        raise TypeError(f"cannot carry a {type(state).__name__} into the port")
    if _BUCKET_SHAPES.keys() <= fields.keys():
        _check_bucket(fields)
    if {"A_ub", "b_ub", "A_eq", "b_eq", "c"} <= fields.keys():
        _check_lp_stack(fields)
    return {k: to_tensor(v, dev) if isinstance(v, np.ndarray) else v
            for k, v in fields.items()}


def instance_from_reference(inst):
    """The port's :class:`~repro_torch.core.instance.Instance` with the same
    arrays as a reference instance (NumPy stays NumPy: instances are host
    data in both packages)."""
    from repro_torch.core.instance import Chain, Instance, Loads, Star

    kinds = {"chain": Chain, "star": Star}
    p, ld = inst.platform, inst.loads
    if p.kind not in kinds:
        raise ValueError(f"unknown topology {p.kind!r}")
    platform = kinds[p.kind](w=p.w.copy(), z=p.z.copy(), tau=p.tau.copy(),
                             latency=p.latency.copy())
    loads = Loads(v_comm=ld.v_comm.copy(), v_comp=ld.v_comp.copy(),
                  release=ld.release.copy(), return_ratio=ld.return_ratio.copy())
    wpl = None if inst.w_per_load is None else np.array(inst.w_per_load)
    return Instance(platform, loads, q=tuple(inst.q), w_per_load=wpl)
