"""Mixture-of-experts layer, the counterpart of ``repro.models.moe``'s GSPMD
path: capacity-based top-k routing with scatter/gather dispatch.

Tokens are scattered into an (experts, capacity, d) buffer and gathered
back: O(T·k·d) data movement, positions from a per-round prefix sum over
the one-hot choice.  Top-k routing runs k rounds of top-1 dispatch against
a shared capacity budget; capacity-overflow tokens are dropped (standard
GShard semantics) and counted in the aux loss.

Under a training mesh whose batch is split over the data axes, a rank
holds its rows' tokens only, and ``moe_layer`` keeps the global semantics
of the reference's GSPMD layer: the capacity comes from the global token
count, each round places a token after the earlier data ranks' tokens of
its expert (one all-gather of an (E,) count vector per round), and the
dispatch fractions and mean gates are global means.  The expert products
then run over the whole (E, C) buffer, of which a rank fills its own slots:
on a data axis of n ranks each rank does the expert work, and holds the
buffer, of the whole batch, n times its share.  ``moe_impl="manual"``
routes each data row on its own and does not pay this.

Under a scope that splits "model" (``sharding_ctx.split_of``; training
and serving) the router's columns and the experts are the rank's "model"
blocks: the router's logits are gathered over "model" (every rank routes
all E experts, the same routes on each), each rank dispatches only the
routes whose expert is one of its ``E / tp`` into an ``(E / tp) * C``
buffer, and the ranks' combined outputs are summed over "model".  In
training the tokens and the routes' gates enter the rank's work through
``split_input`` (their cotangents summed over "model"), the gathered
logits' backward keeps the rank's columns, and the sum's is the identity;
every rank issues them whether or not its experts received a token.

``moe_layer_manual`` (``moe_impl="manual"``) is the reference's
expert-parallel layer: each rank of a data row routes the row's tokens
against the full router, dispatches only to its ``E / tp`` experts with the
local capacity ``max(4, int(cf·t·k/E) + 4)``, and the row's "model" ranks
sum their outputs.  Its aux is each data row's statistic averaged over the
data axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding_ctx as S
from repro_torch.models.layers import MLP, mlp, normal_param
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.compat import token_prefix_sum

__all__ = ["MoE", "Route", "moe_layer", "moe_layer_manual", "moe_route"]


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


def _router_probs(p: MoE, xt: torch.Tensor) -> torch.Tensor:
    """Router probabilities (T, E) of tokens ``xt`` (T, d); a router split
    on its expert columns gives this rank's logits, gathered over "model"
    (the caller has passed ``xt`` through ``split_input``, once for the
    router and the experts)."""
    logits = xt.float() @ p.router
    split = S.split_of(p, "router")
    return torch.softmax(logits if split is None else S.model_whole(logits, 1), dim=-1)


def _local_route(r: Route, first: int, n: int) -> Route:
    """``r`` restricted to experts ``first .. first + n - 1`` (renumbered
    from 0); the other tokens dropped, as a capacity overflow is."""
    mine = r.keep & (r.dest_e >= first) & (r.dest_e < first + n)
    return Route(dest_e=torch.where(mine, r.dest_e - first, 0).to(torch.int32), dest_c=r.dest_c,
                 keep=mine, gate=torch.where(mine, r.gate, 0.0))


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    moe = cfg.moe
    # k dispatch slots per token spread over E experts.
    cap = int(moe.capacity_factor * n_tokens * moe.top_k / moe.n_experts) + 1
    # Round to a lane-friendly size; tiny smoke configs keep at least 4.
    return max(4, -(-cap // 4) * 4)


def _token_shards():
    """(mesh, data axes) when the scope splits the batch rows over data
    axes of more than one rank, else None."""
    scope = S.current_scope()
    if scope is None or sh.axis_size(scope.mesh, scope.batch_axes) == 1:
        return None
    return scope.mesh, scope.batch_axes


def _global_tokens(t: int, shards) -> int:
    """The token count of the whole batch of which a rank holds ``t``."""
    return t if shards is None else t * sh.axis_size(*shards)


def moe_route(cfg: ModelConfig, probs: torch.Tensor, shards=None
              ) -> tuple[list[Route], torch.Tensor]:
    """Router probabilities (T, E) -> (one ``Route`` per round, the fraction
    of tokens each expert was chosen by, summed over rounds).
    ``argmax`` takes the first expert on ties, as ``jnp.argmax`` does.

    With ``shards`` (mesh, data axes) ``probs`` is this rank's block of the
    global tokens, and positions, capacity and fractions are the global
    ones (module docstring).  Without, this rank is the only data rank."""
    e = cfg.moe.n_experts
    n_tokens = _global_tokens(probs.shape[0], shards)
    cap = _capacity(cfg, n_tokens)
    rank = 0 if shards is None else sh.axis_index(*shards)
    remaining = probs
    expert_fill = torch.zeros((e,), dtype=torch.int32, device=probs.device)
    frac_dispatched = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    routes = []
    for _ in range(cfg.moe.top_k):
        gate = torch.amax(remaining, dim=-1)                        # (T,)
        expert = torch.argmax(remaining, dim=-1)                    # (T,)
        onehot = F.one_hot(expert, e).float()                       # (T, E)
        csum = token_prefix_sum(onehot, axis=0)
        # every data rank's count of each expert's tokens, in rank order
        counts = (torch.sum(onehot, dim=0)[None] if shards is None
                  else sh.axis_rows(torch.sum(onehot, dim=0), *shards))   # (n, E)
        # a token's slot: after the fill and the earlier data ranks' tokens
        offset = torch.sum(counts[:rank], dim=0)
        pos = (csum - 1.0) + (offset + expert_fill.float())[None, :]
        pos_tok = torch.sum(pos * onehot, dim=-1)                   # (T,)
        keep = pos_tok < cap
        routes.append(Route(
            dest_e=torch.where(keep, expert, 0).to(torch.int32),
            dest_c=torch.clamp(pos_tok, 0, cap - 1).to(torch.int32),
            keep=keep,
            gate=torch.where(keep, gate, 0.0),
        ))
        # slots fill .. fill + total - 1 were asked for; those below cap kept
        total = torch.sum(counts, dim=0)
        kept = torch.minimum(torch.clamp(cap - expert_fill.float(), min=0.0), total)
        expert_fill = expert_fill + kept.to(torch.int32)
        frac_dispatched = frac_dispatched + total / float(n_tokens)
        remaining = remaining * (1.0 - onehot)
    return routes, frac_dispatched


def _dispatch(buf_rows: int, xt: torch.Tensor, routes: list[Route], slots: list, w_in, w_gate,
              w_out) -> torch.Tensor:
    """Scatter the kept tokens into a flat (E * C, d) buffer, run the
    experts' gated MLP on it and gather each round's slots back, weighted by
    its gates -> float32 (T, d).

    A kept token's slot is unique across tokens and rounds (positions run on
    from each expert's fill); a dropped token adds a zero row at (0,
    clip(pos)).  So only zeros collide, and x + 0 == x: the atomic adds of
    index_add_ on the card (and of its backward, index_select's) give the
    same sums in any order."""
    t, d = xt.shape
    e = w_in.shape[0]
    buf = torch.zeros((buf_rows, d), dtype=xt.dtype, device=xt.device)
    for r, slot in zip(routes, slots):
        buf.index_add_(0, slot, torch.where(r.keep[:, None], xt, torch.zeros_like(xt)))
    buf = buf.view(e, buf_rows // e, d)
    hidden = torch.bmm(buf, w_in)
    gated = F.silu(torch.bmm(buf, w_gate)) * hidden
    expert_out = torch.bmm(gated, w_out).view(buf_rows, d)          # (E*C, d)
    combined = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
    for r, slot in zip(routes, slots):
        combined = combined + expert_out.index_select(0, slot).float() * r.gate[:, None]
    return combined


def moe_layer(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out, aux_loss).  aux is the standard load-balancing
    loss (mean over experts of fraction_dispatched * mean_gate * E)."""
    moe = cfg.moe
    e = moe.n_experts
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    experts = S.split_of(p, "w_in")
    # the tokens and the whole routes' gates enter the rank's router columns
    # and experts; the aux statistic reads the probabilities whole
    xt = S.split_input(xt, experts)
    probs = _router_probs(p, xt)                                    # (T, E)
    shards = _token_shards()
    n_tokens = _global_tokens(t, shards)
    routes, frac_dispatched = moe_route(cfg, S.split_input(probs, experts), shards)
    cap = _capacity(cfg, n_tokens)
    if experts is not None:     # this rank's experts only
        n_local = p.w_in.shape[0]
        routes = [_local_route(r, experts.index * n_local, n_local) for r in routes]
    slots = [r.dest_e.long() * cap + r.dest_c.long() for r in routes]
    combined = _dispatch(p.w_in.shape[0] * cap, xt, routes, slots, p.w_in, p.w_gate, p.w_out)
    if experts is not None:     # summed in the activations' dtype, as the MLP's rows are
        combined = sh.tp_sum(combined.to(x.dtype), experts.mesh)
    prob_sums = torch.sum(probs, dim=0)
    if shards is not None:
        prob_sums = sh.psum(prob_sums, *shards)
    mean_probs = prob_sums / float(n_tokens)
    aux = torch.sum(frac_dispatched / moe.top_k * mean_probs) * e
    out = combined.to(x.dtype).reshape(b, s, d)
    if p.dense is not None:
        out = out + mlp(cfg, p.dense, x)
    return out, aux


def _moe_local(cfg: ModelConfig, p: MoE, xt: torch.Tensor, mesh):
    """One rank's share of the manual expert-parallel layer: this data
    row's tokens ``xt`` (T, d) against the full router, dispatched to the
    rank's ``E / tp`` consecutive experts (``p``'s expert weights are those
    blocks) under the local capacity; the combined output summed over
    "model".  The tokens enter the router's columns and the local dispatch,
    and the router's probabilities the local routes, through ``tp_enter``:
    each model rank's gradient through its own columns and experts' gates
    is partial and is summed over the row, while the aux statistic's
    gradient, the same on every model rank, is counted once."""
    moe = cfg.moe
    e = moe.n_experts
    t, d = xt.shape
    n_local = p.w_in.shape[0]
    first = sh.axis_index(mesh, "model") * n_local

    x_local = sh.tp_enter(xt, mesh)
    probs = _router_probs(p, x_local)
    # capacity against this data row's tokens (each row routes on its own)
    cap = max(4, int(moe.capacity_factor * t * moe.top_k / e) + 4)
    remaining = sh.tp_enter(probs, mesh)
    expert_fill = torch.zeros((e,), dtype=torch.int32, device=xt.device)
    frac_dispatched = torch.zeros((e,), dtype=torch.float32, device=xt.device)
    routes = []
    for _ in range(moe.top_k):
        gate = torch.amax(remaining, dim=-1)
        expert = torch.argmax(remaining, dim=-1)
        onehot = F.one_hot(expert, e).float()
        csum = token_prefix_sum(onehot, axis=0)
        pos_tok = torch.sum((csum - 1.0 + expert_fill[None].float()) * onehot, dim=-1)
        local = (expert >= first) & (expert < first + n_local)
        keep = (pos_tok < cap) & local
        routes.append(Route(
            dest_e=torch.where(keep, expert - first, 0).to(torch.int32),
            dest_c=torch.clamp(pos_tok, 0, cap - 1).to(torch.int32),
            keep=keep,
            gate=torch.where(keep, gate, 0.0),
        ))
        expert_fill = expert_fill + torch.sum(
            onehot * (pos_tok < cap)[:, None].float(), dim=0).to(torch.int32)
        frac_dispatched = frac_dispatched + torch.mean(onehot, dim=0)
        remaining = remaining * (1.0 - onehot)

    slots = [r.dest_e.long() * cap + r.dest_c.long() for r in routes]
    combined = _dispatch(n_local * cap, x_local, routes, slots, p.w_in, p.w_gate, p.w_out)
    # each token's experts live on exactly the ranks that contributed
    combined = sh.tp_sum(combined, mesh)
    aux = torch.sum(frac_dispatched / moe.top_k * torch.mean(probs, dim=0)) * e
    return combined.to(xt.dtype), aux


def moe_layer_manual(cfg: ModelConfig, p: MoE, x: torch.Tensor, mesh
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The manual expert-parallel MoE (``moe_impl="manual"``) on ``mesh``:
    ``p``'s expert weights are this rank's ``E / tp`` experts, its router
    the full one.  Falls back to ``moe_layer`` when the experts do not
    split evenly over "model"."""
    tp = sh.axis_size(mesh, "model")
    if cfg.moe.n_experts % tp:
        return moe_layer(cfg, p, x)
    b, s, d = x.shape
    out, aux = _moe_local(cfg, p, x.reshape(b * s, d), mesh)
    scope = S.current_scope()
    data = scope.batch_axes if scope is not None else ()
    n = sh.axis_size(mesh, data)
    if n > 1:   # replicate the load-balance statistic
        aux = sh.psum(aux, mesh, data) / float(n)
    out = out.reshape(b, s, d)
    if p.dense is not None:
        out = out + mlp(cfg, p.dense, x)
    return out, aux
