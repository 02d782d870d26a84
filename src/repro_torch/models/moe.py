"""Mixture-of-experts layer, the counterpart of ``repro.models.moe``'s GSPMD
path: capacity-based top-k routing with scatter/gather dispatch.

Tokens are scattered into an (experts, capacity, d) buffer and gathered
back: O(T·k·d) data movement, positions from a per-round prefix sum over
the one-hot choice.  Top-k routing runs k rounds of top-1 dispatch against
a shared capacity budget; capacity-overflow tokens are dropped (standard
GShard semantics) and counted in the aux loss.  The manual expert-parallel
layer runs only under a mesh and is not ported (ROADMAP.md, "LM mesh").
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, mlp, normal_param
from repro_torch.runtime.compat import token_prefix_sum

__all__ = ["MoE", "Route", "moe_layer", "moe_route"]


class MoE(nn.Module):
    """Router and expert weights (the reference's ``init_moe_params``), with
    arctic's parallel dense MLP in ``dense``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator=None):
        super().__init__()
        d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
        kw = dict(device=device, generator=generator)
        self.router = normal_param((d, e), d ** -0.5, dtype=torch.float32, **kw)
        self.w_in = normal_param((e, d, f), d ** -0.5, dtype=dtype, **kw)
        self.w_gate = normal_param((e, d, f), d ** -0.5, dtype=dtype, **kw)
        self.w_out = normal_param((e, f, d), f ** -0.5, dtype=dtype, **kw)
        self.dense = (MLP(cfg, dtype=dtype, d_ff=cfg.moe.dense_d_ff, **kw)
                      if cfg.moe.dense_d_ff else None)


class Route(NamedTuple):
    """One round of top-1 dispatch: each token's slot (expert, position)
    and its gate, zeroed where the token was dropped."""

    dest_e: torch.Tensor   # (T,) int32
    dest_c: torch.Tensor   # (T,) int32
    keep: torch.Tensor     # (T,) bool
    gate: torch.Tensor     # (T,) float32


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    moe = cfg.moe
    # k dispatch slots per token spread over E experts.
    cap = int(moe.capacity_factor * n_tokens * moe.top_k / moe.n_experts) + 1
    # Round to a lane-friendly size; tiny smoke configs keep at least 4.
    return max(4, -(-cap // 4) * 4)


def moe_route(cfg: ModelConfig, probs: torch.Tensor) -> tuple[list[Route], torch.Tensor]:
    """Router probabilities (T, E) -> (one ``Route`` per round, the fraction
    of tokens each expert was chosen by, summed over rounds).  ``argmax``
    takes the first expert on ties, as ``jnp.argmax`` does."""
    e = cfg.moe.n_experts
    cap = _capacity(cfg, probs.shape[0])
    remaining = probs
    expert_fill = torch.zeros((e,), dtype=torch.int32, device=probs.device)
    frac_dispatched = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    routes = []
    for _ in range(cfg.moe.top_k):
        gate = torch.amax(remaining, dim=-1)                        # (T,)
        expert = torch.argmax(remaining, dim=-1)                    # (T,)
        onehot = F.one_hot(expert, e).float()                       # (T, E)
        csum = token_prefix_sum(onehot, axis=0)
        pos = (csum - 1.0) + expert_fill[None, :].float()
        pos_tok = torch.sum(pos * onehot, dim=-1)                   # (T,)
        keep = pos_tok < cap
        routes.append(Route(
            dest_e=torch.where(keep, expert, 0).to(torch.int32),
            dest_c=torch.clamp(pos_tok, 0, cap - 1).to(torch.int32),
            keep=keep,
            gate=torch.where(keep, gate, 0.0),
        ))
        expert_fill = expert_fill + torch.sum(onehot * keep[:, None].float(), dim=0).to(torch.int32)
        frac_dispatched = frac_dispatched + torch.mean(onehot, dim=0)
        remaining = remaining * (1.0 - onehot)
    return routes, frac_dispatched


def moe_layer(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out, aux_loss).  aux is the standard load-balancing
    loss (mean over experts of fraction_dispatched * mean_gate * E)."""
    moe = cfg.moe
    e = moe.n_experts
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs = torch.softmax(xt.float() @ p.router, dim=-1)            # (T, E)
    cap = _capacity(cfg, t)
    routes, frac_dispatched = moe_route(cfg, probs)

    # Slots as rows of a flat (E * C, d) buffer.  A kept token's slot is
    # unique across tokens and rounds (positions run on from each expert's
    # fill); a dropped token adds a zero row at (0, clip(pos)).  So only zeros
    # collide, and x + 0 == x: the atomic adds of index_add_ on the card (and
    # of its backward, index_select's) give the same sums in any order.
    slots = [r.dest_e.long() * cap + r.dest_c.long() for r in routes]
    buf = torch.zeros((e * cap, d), dtype=xt.dtype, device=x.device)
    for r, slot in zip(routes, slots):
        buf.index_add_(0, slot, torch.where(r.keep[:, None], xt, torch.zeros_like(xt)))
    buf = buf.view(e, cap, d)

    hidden = torch.bmm(buf, p.w_in)
    gated = F.silu(torch.bmm(buf, p.w_gate)) * hidden
    expert_out = torch.bmm(gated, p.w_out).view(e * cap, d)         # (E*C, d)

    combined = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for r, slot in zip(routes, slots):
        combined = combined + expert_out.index_select(0, slot).float() * r.gate[:, None]

    aux = torch.sum(frac_dispatched / moe.top_k * torch.mean(probs, dim=0)) * e
    out = combined.to(x.dtype).reshape(b, s, d)
    if p.dense is not None:
        out = out + mlp(cfg, p.dense, x)
    return out, aux
