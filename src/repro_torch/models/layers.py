"""Shared model layers: norms, RoPE, gated MLPs, the seeded initializer and
the sharding helpers.

The port of the reference's ``models/layers.py``.  Every function computes
in float32 inside and returns the input's dtype, as the reference does.

The sharding helpers: :class:`PartitionSpec` (one entry a tensor dim, as
JAX's), :func:`fix_spec` (drop the axes a mesh lacks), the training
driver's mesh (:func:`activate_mesh`, :func:`current_mesh`) and
:func:`constrain`, which returns its input unchanged (see its doc).  The
rules that give each weight its spec are in
:mod:`repro_torch.runtime.sharding`; sharded training runs under
``torchrun``::

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch minitron-8b \\
      --steps 4 --batch 16 --seq 512
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.convert import resolve_device

__all__ = ["PartitionSpec", "activate_mesh", "current_mesh", "constrain", "fix_spec",
           "Initializer", "rms_norm", "rope", "apply_rope", "init_glu_mlp", "glu_mlp",
           "cross_entropy"]


class PartitionSpec(tuple):
    """How a tensor's dims map onto mesh axes, one entry a dim: ``None``
    (not sharded), an axis name, or a tuple of names (sharded over their
    product, the first major), as JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec
_local = threading.local()


@contextlib.contextmanager
def activate_mesh(mesh):
    """Make ``mesh`` the current mesh (:func:`current_mesh`) inside the
    block.  The training driver's standard mode
    (:func:`repro_torch.launch.train.run_standard`) runs under its data
    mesh, as the reference's does."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def current_mesh():
    """The mesh of the innermost :func:`activate_mesh` on this thread, or
    ``None``.  The reference's :func:`constrain` reads it; the port's
    returns its input without reading it."""
    return getattr(_local, "mesh", None)


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def fix_spec(mesh, spec) -> PartitionSpec:
    """Drop axis names absent from the mesh (e.g. 'pod' on a single pod)."""
    names = set(_axis_names(mesh))

    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in names else None
        sub = tuple(a for a in entry if a in names)
        return sub if len(sub) > 1 else (sub[0] if sub else None)

    return PartitionSpec(*(fix(e) for e in spec))


def constrain(x, *spec_entries):
    """``x`` unchanged.  The reference pins an activation's layout to
    ``P(*spec_entries)`` under the active mesh for XLA's partitioner; the
    port has no such partitioner.  Under FSDP (the only sharding an entry
    point of either package runs: a model axis of 1) every activation is
    its rank's local tensor over its own rows, which is the layout the
    reference's constraints ask for on the data axes, and the model axis
    they name is 1 wide."""
    return x


class Initializer:
    """Seeded parameter factory with the reference's fan-in scaling: a
    normal draw times ``fan_in ** -0.5`` (``fan_in`` is ``shape[-2]``) unless
    a scale is given.  Draws come from an explicit :class:`torch.Generator`
    on ``device`` (``None``: the card, raising without one), so they are not
    the reference's numbers; tests carry the reference's parameters across
    instead."""

    def __init__(self, seed: int, dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.dtype = dtype

    def normal(self, shape, scale=None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = (fan_in ** -0.5) if scale is None else scale
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return (x * scale).to(self.dtype)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, dtype=dtype or self.dtype, device=self.device)


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope(positions, head_dim: int, theta: float):
    """Rotary tables: positions [...] -> cos/sin [..., head_dim//2], fp32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin broadcastable [..., S, 1, D/2]."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_glu_mlp(init: Initializer, d_model: int, d_ff: int):
    return {
        "w_gate": init.normal((d_model, d_ff)),
        "w_up": init.normal((d_model, d_ff)),
        "w_down": init.normal((d_ff, d_model)),
    }


def glu_mlp(p, x, act: str = "swiglu"):
    """Gated MLP; ``p`` has ``w_gate``, ``w_up`` ``[d_model, d_ff]`` and
    ``w_down`` ``[d_ff, d_model]``."""
    g = x @ p.w_gate
    u = x @ p.w_up
    if act == "swiglu":
        h = F.silu(g) * u
    elif act == "geglu":
        h = F.gelu(g, approximate="tanh") * u  # jax.nn.gelu's default
    else:
        raise ValueError(act)
    return h @ p.w_down


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in float32; logits [..., V], labels int
    [...]: logsumexp minus the gold logit, averaged over the tokens, or over
    ``mask`` (a masked mean over ``max(mask.sum(), 1)``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
