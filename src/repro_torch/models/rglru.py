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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import const_param, normal_param, uniform_param

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


def _gates(p: RGLRU, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    r = torch.sigmoid((u @ p.w_a).float() + p.b_a)
    i = torch.sigmoid((u @ p.w_i).float() + p.b_i)
    return r, i


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
    branch = x @ p.w_branch
    gate, signal = torch.chunk(branch, 2, dim=-1)
    u, conv_state = _conv1d(p, signal, cache["conv"] if cache else None)
    r, i = _gates(p, u)
    a, gated_in = _lru_coeffs(p, r, i, u)

    h = cache["h"] if cache else torch.zeros((b, cfg.lru_width), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + gated_in[:, t]
        hs.append(h)
    h_seq = torch.stack(hs, dim=1).to(x.dtype)
    mixed = h_seq * F.gelu(gate, approximate="tanh")
    out = mixed @ p.w_out
    return out, {"h": h, "conv": conv_state}
