"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), the
counterpart of ``repro.models.rglru``.

Block structure (one "rec" temporal-mix):

    x -> W_branch (d -> 2 * lru_width)       split: [gate | signal]
    signal -> causal depthwise conv1d(width) -> RG-LRU -> * gelu(gate)
    -> W_out (lru_width -> d)

RG-LRU cell (c = 8):

    r_t = sigmoid(W_a u_t + b_a)             recurrence gate
    i_t = sigmoid(W_i u_t + b_i)             input gate
    log a_t = -c * softplus(Lambda) * r_t    (so a_t = sigmoid(Lambda)^(c r_t))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The reference's ``lax.scan`` over time is a loop here, one step per token,
with the state in float32.  Decode state: h (B, W) plus the conv ring (B,
width-1, W).

Under a scope that splits "model" (``sharding_ctx.split_of``; training and
serving) a rank computes on its blocks of the "state" channels: its columns
of ``w_branch`` (which lie in the gate half or the signal half: an
all-to-all re-pairs each rank's channels' gate and signal), its channels of
``conv``, ``lam``, ``b_a``, ``b_i`` and of the states, its rows of
``w_a``/``w_i`` (one reduce-scatter gives its columns of both gates) and of
``w_out`` (one sum over "model").  In training each collective is its
autograd pair (``runtime.sharding``): the reverse all-to-all, an all-gather
of the gates' cotangents, the identity after ``w_out``, and a sum of the
input's partial cotangents before ``w_branch``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding_ctx as S
from repro_torch.models.layers import const_param, normal_param, uniform_param
from repro_torch.runtime import sharding as sh

__all__ = ["RGLRU", "init_rglru_cache", "rglru_mix"]

_C = 8.0


class RGLRU(nn.Module):
    """RG-LRU weights (the reference's ``init_rglru_params``)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator=None):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width
        kw = dict(device=device, generator=generator)
        self.w_branch = normal_param((d, 2 * w), d ** -0.5, dtype=dtype, **kw)
        self.conv = normal_param((cfg.conv_width, w), 0.1, dtype=dtype, **kw)
        self.conv_bias = const_param((w,), 0.0, dtype=dtype, device=device)
        self.w_a = normal_param((w, w), w ** -0.5, dtype=dtype, **kw)
        self.b_a = const_param((w,), 0.0, dtype=torch.float32, device=device)
        self.w_i = normal_param((w, w), w ** -0.5, dtype=dtype, **kw)
        self.b_i = const_param((w,), 0.0, dtype=torch.float32, device=device)
        self.lam = uniform_param((w,), 2.0, 4.0, dtype=torch.float32, **kw)  # softplus -> decay
        self.w_out = normal_param((w, d), w ** -0.5, dtype=dtype, **kw)


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    w = cfg.lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
    }


def _conv1d(p: RGLRU, u: torch.Tensor, conv_state: torch.Tensor | None):
    """Causal depthwise conv over (B, S, W); ``conv_state`` (B, cw-1, W)
    carries the predecessors (zeros for a fresh sequence).  Works for any S
    including decode's S=1.  Returns (out, new_state)."""
    cw = p.conv.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    ext = torch.cat([conv_state, u], dim=1)                    # (B, S+cw-1, W)
    s = u.shape[1]
    out = sum(ext[:, i : i + s] * p.conv[i][None, None] for i in range(cw))
    return out + p.conv_bias[None, None], ext[:, -(cw - 1) :]


def _branches(p: RGLRU, x: torch.Tensor, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(gate, signal) of the rank's channels (every channel without a
    split).  ``w_branch`` is [gate | signal] cut in column blocks, so a
    rank's columns hold other ranks' channels: each rank sends each other
    the columns of its channels it holds (``_pairing``)."""
    cols = S.split_of(p, "w_branch")
    branch = S.split_input(x, cols) @ p.w_branch
    if cols is None:            # whole, and so are the channels
        return torch.chunk(branch, 2, dim=-1)
    if S.split_of(p, "lam") is None:     # 2 * width divides "model", width does not
        return torch.chunk(S.model_whole(branch, 2), 2, dim=-1)
    send, recv = _pairing(width, cols.size, cols.index)
    got = sh.tp_all_to_all([branch[..., lo:hi] for lo, hi in send], recv, cols.mesh, dim=2)
    return torch.chunk(got, 2, dim=-1)


def _pairing(width: int, n: int, rank: int) -> tuple[list, list]:
    """For rank ``rank`` of ``n`` over a ``w_branch`` of 2 * ``width``
    columns: the span (lo, hi) of its column block that each rank's
    channels need, and the number of columns it receives from each rank.
    A block meets at most one half of a rank's channels (the gate and the
    signal columns of a channel lie ``width`` apart), so that is one span."""
    block, chans = 2 * width // n, width // n

    def span(src: int, dst: int) -> tuple[int, int]:
        for start in (dst * chans, width + dst * chans):
            lo, hi = max(start, src * block), min(start + chans, (src + 1) * block)
            if lo < hi:
                return lo - src * block, hi - src * block
        return 0, 0

    return [span(rank, j) for j in range(n)], [hi - lo for lo, hi in (span(i, rank)
                                                                      for i in range(n))]


def _gates(p: RGLRU, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    rows = S.split_of(p, "w_a")
    if rows is None:
        r = torch.sigmoid((u @ p.w_a).float() + p.b_a)
        i = torch.sigmoid((u @ p.w_i).float() + p.b_i)
        return r, i
    # u's channels are the rank's rows of w_a and w_i: partial sums, of
    # which one reduce-scatter gives the rank's columns of both gates
    both = sh.tp_scatter_sum(torch.stack([u @ p.w_a, u @ p.w_i], dim=2), rows.mesh, dim=3)
    return (torch.sigmoid(both[:, :, 0].float() + p.b_a),
            torch.sigmoid(both[:, :, 1].float() + p.b_i))


def _lru_coeffs(p: RGLRU, r: torch.Tensor, i: torch.Tensor, u: torch.Tensor):
    softplus = torch.logaddexp(p.lam, torch.zeros_like(p.lam))   # jax.nn.softplus
    log_a = -_C * softplus[None, None] * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) * (i * u.float())
    return a, gated_in


def rglru_mix(cfg: ModelConfig, p: RGLRU, x: torch.Tensor, cache: dict | None = None):
    """Temporal mix over any sequence length; ``cache=None`` = fresh state.
    Returns (out (B,S,D), new cache)."""
    b = x.shape[0]
    gate, signal = _branches(p, x, cfg.lru_width)
    u, conv_state = _conv1d(p, signal, cache["conv"] if cache else None)
    r, i = _gates(p, u)
    a, gated_in = _lru_coeffs(p, r, i, u)

    h = cache["h"] if cache else torch.zeros((b, u.shape[-1]), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + gated_in[:, t]
        hs.append(h)
    h_seq = torch.stack(hs, dim=1).to(x.dtype)
    mixed = h_seq * F.gelu(gate, approximate="tanh")
    out = mixed @ p.w_out
    split = S.split_of(p, "w_out")
    if split is not None:
        out = sh.tp_sum(out, split.mesh)
    return out, {"h": h, "conv": conv_state}
