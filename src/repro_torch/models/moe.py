"""Mixture-of-Experts FFN: shared experts + routed top-k.

The port of the reference's ``models/moe.py``.  Two dispatch
implementations, as there:

  "gshard"  — capacity-bucketed dispatch: each (token, choice) slot goes to
              position ``pos`` of its expert's buffer [E, C, D], ``pos``
              counted by a cumsum over the slots in order; slots at or past
              the capacity ``C = max(1, round(cf * N * k / E))`` are dropped
              (their gate is 0 and they read the expert's last position, as
              in the reference).  In a decode step of 4 tokens C is 1, so a
              second token choosing the same expert loses it (ROADMAP C).
  "dense"   — every token through every expert, weighted by the router
              (exact; O(E) FLOPs), the oracle gshard is held to.

Router: softmax top-k with the Switch-style load-balancing auxiliary loss.

Plain PyTorch: the reference has no kernel here (its dispatch is ``jnp``
einsums and scatters).  The k slots of a token are summed in slot order
(a ``view(N, k, D).sum(1)``) instead of the reference's scatter-add, so
the card's result does not depend on the order of atomics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig

__all__ = ["init_moe", "moe_ffn", "capacity"]


def init_moe(init, cfg: ArchConfig):
    mo = cfg.moe
    d, f, E = cfg.d_model, mo.d_ff_expert, mo.num_experts
    p = {
        "router": init.normal((d, E), scale=0.02),
        "w_gate": init.normal((E, d, f)),
        "w_up": init.normal((E, d, f)),
        "w_down": init.normal((E, f, d)),
    }
    if mo.num_shared:
        p["shared"] = {
            "w_gate": init.normal((d, f * mo.num_shared)),
            "w_up": init.normal((d, f * mo.num_shared)),
            "w_down": init.normal((f * mo.num_shared, d)),
        }
    return p


def _act(cfg: ArchConfig):
    if cfg.act == "swiglu":
        return F.silu
    return lambda g: F.gelu(g, approximate="tanh")  # jax.nn.gelu's default


def _router(p, x2d, mo):
    """x2d [N, D] float32 -> (gates [N, k], experts [N, k] int64, aux loss)."""
    logits = x2d @ p.router.float()
    probs = torch.softmax(logits, dim=-1)  # [N, E]
    gates, experts = torch.topk(probs, mo.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = F.one_hot(experts[:, 0], mo.num_experts).float().mean(dim=0)
    aux = mo.num_experts * torch.sum(me * ce)
    return gates, experts, aux


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Positions of each expert's buffer for ``n_tokens`` tokens (gshard)."""
    mo = cfg.moe
    return max(1, int(round(mo.capacity_factor * n_tokens * mo.top_k / mo.num_experts)))


def _expert_ffn(p, buf, act_fn):
    """buf [E, C, D] -> [E, C, D] through each expert's gated MLP."""
    h = act_fn(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    return torch.bmm(h, p.w_down)


def moe_ffn(p, x, cfg: ArchConfig, impl: str = "gshard"):
    """x [B, S, D] -> ([B, S, D], aux loss times ``router_aux_weight``)."""
    mo = cfg.moe
    B, S, D = x.shape
    N, E, k = B * S, mo.num_experts, mo.top_k
    x2d = x.reshape(N, D)
    act_fn = _act(cfg)
    gates, experts, aux = _router(p, x2d.float(), mo)

    if impl == "dense":
        g = torch.einsum("nd,edf->nef", x2d, p.w_gate)
        u = torch.einsum("nd,edf->nef", x2d, p.w_up)
        per_e = torch.einsum("nef,efd->ned", act_fn(g) * u, p.w_down)  # [N, E, D]
        w = torch.zeros(N, E, dtype=torch.float32, device=x.device).scatter_add_(1, experts,
                                                                                gates)
        y = torch.einsum("ned,ne->nd", per_e.float(), w).to(x.dtype)
    elif impl == "gshard":
        C = capacity(cfg, N)
        flat_e = experts.reshape(-1)  # [N k] expert of each slot
        flat_g = gates.reshape(-1)
        # position of each slot within its expert (cumsum over slot order)
        pos = torch.cumsum(F.one_hot(flat_e, E), dim=0) - 1
        flat_pos = pos.gather(1, flat_e[:, None])[:, 0]
        keep = flat_pos < C
        flat_g = torch.where(keep, flat_g, 0.0)
        safe_pos = torch.where(keep, flat_pos, C - 1)
        # the kept slots into [E, C, D] (each position written once); the
        # dropped ones into one spare row past the buffer
        row = torch.where(keep, flat_e * C + flat_pos, E * C)
        buf = torch.zeros(E * C + 1, D, dtype=x.dtype, device=x.device)
        buf.index_copy_(0, row, x2d.repeat_interleave(k, dim=0))
        out_buf = _expert_ffn(p, buf[:E * C].view(E, C, D), act_fn)
        # gather back, weighted by gates; a token's k slots summed in order
        y2 = out_buf[flat_e, safe_pos] * flat_g[:, None].to(x.dtype)  # [N k, D]
        y = y2.float().view(N, k, D).sum(dim=1).to(x.dtype)
    else:
        raise ValueError(impl)

    y = y.reshape(B, S, D)
    if mo.num_shared:
        sp = p.shared
        y = y + (act_fn(x @ sp.w_gate) * (x @ sp.w_up)) @ sp.w_down
    return y, aux * mo.router_aux_weight
