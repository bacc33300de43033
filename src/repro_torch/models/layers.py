"""Shared model layers: norms, RoPE, gated MLPs, the seeded initializer and
the sharding helpers.

The port of the reference's ``models/layers.py``.  Every function computes
in float32 inside and returns the input's dtype, as the reference does.

The sharding helpers: :class:`PartitionSpec` (one entry a tensor dim, as
JAX's), :func:`fix_spec` (drop the axes a mesh lacks), :func:`placements`
(a spec as DTensor placements), the active mesh (:func:`activate_mesh`,
:func:`current_mesh`, :func:`model_mesh`) and :func:`constrain`, the port
of ``with_sharding_constraint`` (see its doc).  The rules that give each
weight its spec are in :mod:`repro_torch.runtime.sharding`; sharded
training runs under ``torchrun``::

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch minitron-8b \\
      --steps 4 --batch 16 --seq 512

and the model axis (tensor parallelism) under ``scripts/tp_dist.py``.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.convert import resolve_device

__all__ = ["PartitionSpec", "DP", "activate_mesh", "current_mesh", "model_mesh", "batch_ranks",
           "constrain", "fix_spec", "placements", "replicated", "local_offset", "write_prefix", "write_slot",
           "Deferred", "Initializer", "rms_norm", "rope", "apply_rope", "init_glu_mlp", "glu_mlp",
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
    prev = getattr(_local, "mesh", None), getattr(_local, "model", None)
    _local.mesh, _local.model = mesh, (None if mesh is None else _model_submesh(mesh))
    try:
        yield mesh
    finally:
        _local.mesh, _local.model = prev


def current_mesh():
    """The mesh of the innermost :func:`activate_mesh` on this thread, or
    ``None``."""
    return getattr(_local, "mesh", None)


def model_mesh(mesh=None):
    """The 1-D 'model' submesh of ``mesh`` (default: the active mesh's)
    when its model axis is wider than 1, else ``None``: the mesh the
    model's weights and activations are DTensors on under tensor
    parallelism."""
    return getattr(_local, "model", None) if mesh is None else _model_submesh(mesh)


DP = ("pod", "data")  # the batch axes


def batch_ranks(mesh) -> int:
    """The ranks of ``mesh``'s batch axes ('pod' and 'data') together."""
    names = _axis_names(mesh)
    return math.prod(mesh.size(i) for i, a in enumerate(names) if a in DP)


def _model_submesh(mesh):
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return None
    return mesh["model"] if len(names) > 1 else mesh


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


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (axes the mesh lacks
    dropped): a tensor dim over several mesh axes is ``Shard`` on each of
    them, the first major, as JAX orders them."""
    spec = fix_spec(mesh, spec)
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in ((entry,) if isinstance(entry, str) else entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {dim} is sharded over mesh axes out of the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def constrain(x, *spec_entries):
    """The port of ``with_sharding_constraint(x, P(*spec_entries))``.

    Under :func:`activate_mesh` with a model axis wider than 1, ``x`` is a
    DTensor on the model submesh (:func:`model_mesh`) and is redistributed
    to the placements the spec's model entry gives there: ``Shard(d)`` for
    the dim it names, ``Replicate`` otherwise (an all-gather, all-to-all or
    all-reduce as the move needs; a no-op when ``x`` already has them).
    The spec's data entries need no move: each data rank holds its own
    rows, as under FSDP.  A plain tensor there raises: it would run
    unsharded.  Everywhere else (no mesh, a model axis of 1: the FSDP path
    and every single-card path) ``x`` is returned unchanged."""
    mesh = model_mesh()
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        raise ValueError("a model axis wider than 1 runs on DTensors: shard the model "
                         "(repro_torch.runtime.sharding.shard_model / tp_distribute) first")
    want = placements(mesh, PartitionSpec(*spec_entries))
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def replicated(t, like):
    """``t`` (a plain tensor equal on every rank: positions, RoPE tables) as
    a replicated DTensor on ``like``'s mesh when ``like`` is a DTensor;
    else ``t`` itself."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, [Replicate()] * like.device_mesh.ndim,
                              run_check=False)


def local_offset(x, dim: int) -> int:
    """Where this rank's piece of DTensor ``x`` starts along ``dim``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    _, offset = compute_local_shape_and_global_offset(x.shape, x.device_mesh, x.placements)
    return int(offset[dim])


def write_prefix(cache, new, first: int = 0) -> None:
    """``cache[:, :, first:first + n] = new`` into a sequence-sharded cache
    DTensor [L, B, S, ...]: each rank writes the entries of its own range.
    ``new`` is a DTensor, or a plain tensor on every rank: whole (``first``
    0), or the entries from ``first`` on (a rank's own range of one)."""
    if isinstance(new, DTensor):
        new = new.redistribute(placements=[Replicate()]).to_local()
    local, start = cache.to_local(), local_offset(cache, 2)
    lo, hi = max(start, first), min(first + new.shape[2], start + local.shape[2])
    if hi > lo:
        local[:, :, lo - start:hi - start] = new[:, :, lo - first:hi - first]


def write_slot(cache, slot, new) -> None:
    """``cache[:, slot] = new`` ([B, 1, ...]) into one layer's sequence-
    sharded cache DTensor [B, S, ...]: the rank whose range holds ``slot``
    writes it (the others rewrite an entry with itself), without reading
    ``slot`` back to the host.  ``new`` is a DTensor or a plain tensor
    whole on every rank.  An int8 cache takes int8 values only (quantized
    first, their scales written beside them): a float cast to int8 would
    truncate silently, so it raises ``TypeError``."""
    local = cache.to_local()
    if isinstance(new, DTensor):
        new = new.redistribute(placements=[Replicate()]).to_local()
    if local.dtype == torch.int8 and new.dtype != torch.int8:
        raise TypeError(f"an int8 cache takes quantized int8 values; got {new.dtype}")
    idx = slot - local_offset(cache, 1)
    mine = (idx >= 0) & (idx < local.shape[1])
    idx = torch.where(mine, idx, 0)
    new = new.to(local.dtype)
    local.index_copy_(1, idx, torch.where(mine, new, local.index_select(1, idx)))


WHOLE = 1 << 30  # a leaf of more elements is drawn in slabs
PIECE = 1 << 28  # about the elements of a slab


class Deferred:
    """A leaf made when called (what :class:`Initializer`'s methods return):
    its ``shape`` is known before it exists, and ``rows`` (a range of dim
    0) makes only those rows, the numbers the whole leaf holds there."""

    def __init__(self, shape, make):
        self.shape, self._make = tuple(shape), make

    def __call__(self, rows: slice | None = None):
        return self._make(rows)


def _rows(shape, rows) -> tuple:
    """(start, stop) of ``rows`` along dim 0 of ``shape`` (all of it for None)."""
    return (0, shape[0]) if rows is None else rows.indices(shape[0])[:2]


class Initializer:
    """Seeded parameter factory with the reference's fan-in scaling: a
    normal draw times ``fan_in ** -0.5`` (``fan_in`` is ``shape[-2]``) unless
    a scale is given.  Draws come from an explicit :class:`torch.Generator`
    on ``device`` (``None``: the card, raising without one), so they are not
    the reference's numbers; tests carry the reference's parameters across
    instead.

    Each method returns a :class:`Deferred` leaf, so the caller decides when
    each leaf exists (the draws follow the order of the calls) and how much
    of it: :func:`~repro_torch.models.init_params` makes and places a leaf
    at a time, and a rank can make only its rows of dim 0.  A leaf of more
    than ``WHOLE`` elements is drawn a slab of about ``PIECE`` elements
    along dim 0 at a time, so its float32 temporaries are a slab's
    (kimi-k2-1t-a32b's expert leaves hold 5.6 G elements, 45 GB as two
    float32 tensors); a part of its rows is made from every slab drawn in
    turn (the generator runs on) and keeps only the rows asked for.  A
    smaller leaf is drawn whole and cut."""

    def __init__(self, seed: int, dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.dtype = dtype

    def normal(self, shape, scale=None) -> Deferred:
        return Deferred(shape, functools.partial(self._normal, tuple(shape), scale))

    def zeros(self, shape, dtype=None) -> Deferred:
        return Deferred(shape, functools.partial(self._fill, tuple(shape), torch.zeros, dtype))

    def ones(self, shape, dtype=None) -> Deferred:
        return Deferred(shape, functools.partial(self._fill, tuple(shape), torch.ones, dtype))

    def _fill(self, shape, fill, dtype, rows):
        lo, hi = _rows(shape, rows)
        return fill((hi - lo, *shape[1:]), dtype=dtype or self.dtype, device=self.device)

    def _normal(self, shape, scale, rows):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = (fan_in ** -0.5) if scale is None else scale
        lo, hi = _rows(shape, rows)
        if math.prod(shape) <= WHOLE:
            x = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
            return ((x if rows is None else x[lo:hi]) * scale).to(self.dtype)
        out = torch.empty((hi - lo, *shape[1:]), dtype=self.dtype, device=self.device)
        step = max(1, PIECE // math.prod(shape[1:]))
        for i in range(0, shape[0], step):
            slab = torch.randn((min(step, shape[0] - i), *shape[1:]), generator=self.gen,
                               dtype=torch.float32, device=self.device)
            a, b = max(i, lo), min(i + step, hi)
            if a < b:
                out[a - lo:b - lo].copy_(slab[a - i:b - i].mul_(scale))
        return out


def rms_norm(x, weight, eps: float = 1e-5):
    """``x`` over its root mean square along the last dim, times ``weight``.
    A DTensor ``x`` sharded on that dim (the Mamba mixer's gated d_inner on
    a model axis) takes its mean square as each rank's sum of squares,
    summed over the model axis (an all-reduce of one number a row)."""
    xf = x.float()
    if isinstance(x, DTensor) and x.placements[0].is_shard(x.ndim - 1):
        ss = (xf * xf).sum(dim=-1, keepdim=True).redistribute(placements=[Replicate()])
        var = ss / x.shape[-1]
    else:
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


def glu_mlp(p, x, act: str = "swiglu", model_axis: str = "model", out_spec=None):
    """Gated MLP with Megatron tensor parallelism on d_ff; ``p`` has
    ``w_gate``, ``w_up`` ``[d_model, d_ff]`` and ``w_down`` ``[d_ff,
    d_model]``.  ``out_spec``: the residual stream's spec for the output.
    A sequence-sharded ``x`` (``sp_activations``) is gathered first, and
    the row-sharded ``w_down``'s partial sums reach a sequence-sharded
    ``out_spec`` by a reduce-scatter."""
    x = constrain(x, ("pod", "data"), None, None)
    g = constrain(x @ p.w_gate, ("pod", "data"), None, model_axis)
    u = constrain(x @ p.w_up, ("pod", "data"), None, model_axis)
    if act == "swiglu":
        h = F.silu(g) * u
    elif act == "geglu":
        h = F.gelu(g, approximate="tanh") * u  # jax.nn.gelu's default
    else:
        raise ValueError(act)
    return constrain(h @ p.w_down, *(out_spec or (("pod", "data"), None, None)))


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in float32; logits [..., V], labels int
    [...]: logsumexp minus the gold logit, averaged over the tokens, or over
    ``mask`` (a masked mean over ``max(mask.sum(), 1)``)."""
    logits = logits.float()
    logz = _logsumexp(logits)
    nll = logz - _gold(logits, labels.long())
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _logsumexp(logits):
    """``logsumexp`` over the last dim.  Vocabulary-sharded DTensor logits
    keep their shards: the row maxima and the sums of exp(logit - max) are
    each all-reduced over the model axis (DTensor's own ``logsumexp``
    gathers the logits whole on every rank)."""
    if not (isinstance(logits, DTensor) and tuple(logits.placements) == (Shard(logits.ndim - 1),)):
        return torch.logsumexp(logits, dim=-1)
    top = logits.detach().amax(dim=-1, keepdim=True).redistribute(placements=[Replicate()])
    total = torch.exp(logits - top).sum(dim=-1).redistribute(placements=[Replicate()])
    return top[..., 0] + torch.log(total)


def _gold(logits, labels):
    """``logits[..., labels]``.  Vocabulary-sharded DTensor logits: each
    rank picks the labels in its columns (zero elsewhere) and the picks
    are summed over the model axis (a ``Partial`` sum, reduced when
    read)."""
    if not (isinstance(logits, DTensor) and tuple(logits.placements) == (Shard(logits.ndim - 1),)):
        return torch.gather(logits, -1, replicated(labels, logits)[..., None])[..., 0]
    local = logits.to_local()
    idx = labels - local_offset(logits, logits.ndim - 1)
    mine = (idx >= 0) & (idx < local.shape[-1])
    pick = torch.gather(local, -1, torch.where(mine, idx, 0)[..., None])[..., 0]
    return DTensor.from_local(torch.where(mine, pick, 0.0), logits.device_mesh, [Partial()],
                              run_check=False)
