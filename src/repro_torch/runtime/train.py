"""Train and serve step builders: the port of the reference's
``runtime/train.py``.

``make_train_step`` computes the loss's gradients with autograd over
``microbatches`` installments of the global batch (the intra-step
counterpart of the paper's installments: activation memory stays bounded),
then takes one AdamW step.  It updates the state **in place** and returns
it, where the reference donates its buffers to a jitted step and returns
new ones.

Microbatch gradients accumulate in each parameter's ``.grad``: the loss of
microbatch i is scaled by ``1 / n_mb`` before its backward pass, so
``.grad`` sums ``grad(l_i) / n_mb`` in float32, as the reference's float32
accumulator does, without a second float32 copy of the parameters (12.85
GB at llama3.2-3b's full width).  Scaling the loss rather than the
gradient is exact when ``n_mb`` is a power of two; otherwise the two
differ by a rounding of each gradient element.  A leaf kept in another
dtype than float32 is summed into a float32 buffer after each microbatch
instead (its ``.grad`` is in its own dtype).

A model sharded with FSDP (:func:`repro_torch.runtime.sharding.shard_model`,
over a model axis too) takes the same step on each data rank over the
rank's own rows, under the mesh it was sharded over
(:func:`~repro_torch.models.layers.activate_mesh`): FSDP
reduce-scatters the gradients (their mean over the ranks) on the last
microbatch only (``set_requires_gradient_sync``), the leaves kept whole are
averaged after it, an MoE model's expert leaves (split over the batch
axes: expert parallelism, outside FSDP) have their gradients, which sum
every rank's loss's, divided by the ranks once, the update runs on each
rank's shards, and the logged loss is the mean of the ranks' losses, i.e.
the global batch's.

The training path runs no kernel: ``attention_impl="cuda"`` is refused.
The hand-written kernels have no backward, and the reference cannot
differentiate its Pallas calls either (``jax.grad`` through them raises),
so it trains through plain JAX and the port through plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import ArchConfig, ShardingPolicy, TrainConfig
from repro_torch.models import Transformer, decode_step, loss_fn
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_lr
from repro_torch.runtime.sharding import (is_sharded, mean_expert_grads, mean_over_ranks,
                                          reduce_replicated_grads)

__all__ = ["TrainState", "make_train_state", "make_train_step", "make_serve_step",
           "GradAccumulator", "apply_update", "refuse_kernel_attention"]


@dataclasses.dataclass
class TrainState:
    params: Transformer
    opt: AdamWState


def make_train_state(model: Transformer, tcfg: TrainConfig) -> TrainState:
    """The model's parameters switched to ``requires_grad=True`` (a serving
    model keeps ``False``) and zeroed AdamW moments in
    ``tcfg.optimizer_state_dtype`` beside them."""
    model.requires_grad_(True)
    dtype = getattr(torch, tcfg.optimizer_state_dtype)
    return TrainState(params=model, opt=adamw_init(model, state_dtype=dtype))


def _split_micro(batch: dict, n: int) -> list:
    """The batch as ``n`` microbatches of consecutive rows."""
    parts = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} not divisible by microbatches {n}")
        parts[k] = x.reshape(n, b // n, *x.shape[1:])
    return [{k: x[i] for k, x in parts.items()} for i in range(n)]


def refuse_kernel_attention(policy: ShardingPolicy) -> None:
    """Training runs no kernel: ``attention_impl="cuda"`` raises."""
    if policy.attention_impl == "cuda":
        raise ValueError(
            "training needs attention_impl 'chunked' or 'naive': the CUDA kernels have no "
            "backward kernels, and the reference cannot differentiate its Pallas calls "
            "either, so it trains through plain JAX")


class GradAccumulator:
    """Gradients of a step summed over several backward passes.

    Clears every ``.grad`` when made.  Float32 leaves sum in their
    ``.grad``; a leaf in another dtype is summed into a float32 buffer after
    each pass (its ``.grad`` is in its own dtype).  :meth:`gradients` gives
    every leaf's float32 gradient, zero for a leaf no pass reached, as
    ``jax.grad`` gives it."""

    def __init__(self, model: Transformer):
        self.named = dict(model.named_parameters())
        self.not_f32 = {n for n, p in self.named.items() if p.dtype != torch.float32}
        self.acc: dict = {}
        for p in self.named.values():
            p.grad = None

    def backward(self, loss: torch.Tensor) -> None:
        loss.backward()
        for n in self.not_f32:
            g = self.named[n].grad
            if g is not None:
                g = g.float()
                self.acc[n] = self.acc[n] + g if n in self.acc else g
                self.named[n].grad = None

    def gradients(self) -> dict:
        grads = {n: self.acc.get(n, p.grad) for n, p in self.named.items()}
        return {n: torch.zeros_like(self.named[n], dtype=torch.float32) if g is None else g
                for n, g in grads.items()}


def apply_update(state: TrainState, grads: dict, tcfg: TrainConfig) -> tuple:
    """One AdamW step of ``state`` in place at the schedule's lr; returns
    (lr, the optimizer's metrics)."""
    lr = cosine_lr(state.opt.step, tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
    _, _, om = adamw_update(grads, state.opt, state.params, lr=lr, beta1=tcfg.beta1,
                            beta2=tcfg.beta2, eps=tcfg.eps, weight_decay=tcfg.weight_decay,
                            grad_clip=tcfg.grad_clip)
    return lr, om


def make_train_step(cfg: ArchConfig, policy: ShardingPolicy, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics), with metrics
    ``{"loss": the total loss (aux included), "aux": the MoE aux loss (the
    global batch's on every rank), "lr", "grad_norm"}`` as scalar tensors.
    After the step each float32 parameter's ``.grad`` holds the gradient
    the update took (before clipping).  For a sharded model ``batch`` is
    this rank's rows and the loss is the ranks' mean."""
    refuse_kernel_attention(policy)

    def train_step(state: TrainState, batch: dict):
        model = state.params
        n_mb = tcfg.microbatches
        sharded = is_sharded(model)
        acc = GradAccumulator(model)
        loss = aux = torch.zeros((), dtype=torch.float32, device=model.embed.device)
        for i, mb in enumerate(_split_micro(batch, n_mb) if n_mb > 1 else [batch]):
            if sharded:  # reduce-scatter once, after the last microbatch
                model.set_requires_gradient_sync(i == n_mb - 1)
            total, parts = loss_fn(model, cfg, policy, mb)
            acc.backward(total / n_mb if n_mb > 1 else total)
            total, a = (t.full_tensor() if isinstance(t, DTensor) else t  # model-replicated
                        for t in (total.detach(), parts["aux"].detach()))
            loss = loss + total / n_mb if n_mb > 1 else total
            aux = aux + a / n_mb if n_mb > 1 else a
        if sharded:
            reduce_replicated_grads(model)
            loss = mean_over_ranks(loss, model)
        grads = acc.gradients()
        mean_expert_grads(model, grads)  # expert parallelism: a sum over the ranks' losses
        lr, om = apply_update(state, grads, tcfg)
        return state, {"loss": loss, "aux": aux, "lr": lr, **om}

    return train_step


def make_serve_step(cfg: ArchConfig, policy: ShardingPolicy):
    """Returns serve_step(model, cache, tokens, cache_len) -> (logits, cache);
    the cache is updated in place (see :func:`repro_torch.models.decode_step`)."""

    def serve_step(model, cache, tokens, cache_len):
        return decode_step(model, cfg, policy, cache, tokens, cache_len)

    return serve_step
