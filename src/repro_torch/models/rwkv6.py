"""RWKV-6 "Finch" block (arXiv:2404.05892): time-mix with data-dependent
decay + channel-mix, attention-free.  The counterpart of
``repro.models.rwkv6``.

The WKV recurrence keeps a per-head (hd x hd) float32 state, updated by
rank-1 outer products, one step per token (the reference's ``lax.scan``
over time is a loop here).  Token-shift interpolation uses the Finch LoRA
form: one fused ``d -> 5*rank`` projection, tanh, and five ``rank -> d``
heads.

Under a scope that splits "model" (``sharding_ctx.split_of``; training and
serving) the time mix computes the rank's heads: its blocks of
``w_r``/``w_k``/``w_v``/``w_g``/``decay_b`` and of the ``wkv`` state, its
heads of the whole ``decay_base``/``bonus``/``ln_x`` (``model_block``: in
training their blocks' gradients are gathered, so each rank's gradient of
them is whole), and ``w_o``'s rows, summed over "model"; the channel mix
its columns of ``cm_k`` and rows of ``cm_v``, summed over "model" before
the receptance gate.  The token-shift LoRA and ``cm_r`` have no "model"
dim: every rank computes them whole, and the whole views and LoRA output
enter the split projections through ``split_input``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding_ctx as S
from repro_torch.models.layers import const_param, normal_param, proj_in, proj_out, rms_norm
from repro_torch.runtime import sharding as sh

__all__ = ["RWKV", "init_rwkv_cache", "rwkv_block"]

_MIX_RANK = 32
_DECAY_RANK = 64


def _ranks(cfg: ModelConfig) -> tuple[int, int]:
    mix = min(_MIX_RANK, max(4, cfg.d_model // 8))
    dec = min(_DECAY_RANK, max(4, cfg.d_model // 4))
    return mix, dec


class RWKV(nn.Module):
    """Time-mix and channel-mix weights (the reference's
    ``init_rwkv_params``)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator=None):
        super().__init__()
        d = cfg.d_model
        hd = cfg.rwkv_head_dim
        h = d // hd
        mix_rank, dec_rank = _ranks(cfg)
        kw = dict(dtype=dtype, device=device, generator=generator)
        f32 = dict(dtype=torch.float32, device=device)
        s = d ** -0.5
        # time-mix
        self.mu_x = const_param((5, d), 0.0, dtype=dtype, device=device)   # per-target static mix
        self.mix_a = normal_param((d, 5 * mix_rank), s, **kw)
        self.mix_b = normal_param((5, mix_rank, d), mix_rank ** -0.5, **kw)
        self.w_r = normal_param((d, h, hd), s, **kw)
        self.w_k = normal_param((d, h, hd), s, **kw)
        self.w_v = normal_param((d, h, hd), s, **kw)
        self.w_g = normal_param((d, h, hd), s, **kw)
        self.w_o = normal_param((h, hd, d), s, **kw)
        self.decay_base = const_param((h, hd), -1.0, **f32)                 # w0
        self.decay_a = normal_param((d, dec_rank), s, **kw)
        self.decay_b = normal_param((dec_rank, h, hd), dec_rank ** -0.5, **kw)
        self.bonus = const_param((h, hd), 0.0, **f32)                        # u ("faaaa")
        self.ln_x = const_param((h, hd), 1.0, **f32)                         # per-head groupnorm
        # channel-mix
        self.cm_mu_k = const_param((d,), 0.0, dtype=dtype, device=device)
        self.cm_mu_r = const_param((d,), 0.0, dtype=dtype, device=device)
        self.cm_k = normal_param((d, cfg.d_ff), s, **kw)
        self.cm_v = normal_param((cfg.d_ff, d), cfg.d_ff ** -0.5, **kw)
        self.cm_r = normal_param((d, d), s, **kw)


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    return {
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x (B,S,D) -> x_{t-1} with ``prev`` (B,D) as the t=0 predecessor."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix_targets(p: RWKV, x: torch.Tensor, x_prev: torch.Tensor) -> list[torch.Tensor]:
    """Finch data-dependent token-shift: five interpolated views of x."""
    xx = x_prev - x
    base = x + xx * p.mu_x[0][None, None, :]
    lora = torch.tanh(base @ p.mix_a)
    lora = lora.reshape(*lora.shape[:-1], 5, -1)
    outs = []
    for i in range(5):
        m = p.mu_x[i][None, None, :] + lora[..., i, :] @ p.mix_b[i]
        outs.append(x + xx * m)
    return outs  # order: w, k, v, r, g


def _decay(p: RWKV, x_w: torch.Tensor, heads: int | None = None) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1): w = exp(-exp(w0 + lora)),
    the exponent clipped to [-10, 4]; of the rank's heads where ``heads``
    (0, the heads dim of the whole ``decay_base``) is split."""
    t = torch.tanh(x_w @ p.decay_a)
    t = S.split_input(t, S.split_of(p, "decay_b"))
    core = S.model_block(p.decay_base, heads)[None, None] + proj_in(t, p.decay_b).float()
    return torch.exp(-torch.exp(torch.clamp(core, -10.0, 4.0)))


def _wkv_scan(r, k, v, w, u, state):
    """r/k/v/w: (B, S, H, hd); state (B, H, hd, hd) float32 mapping k-dim
    -> v-dim.

        y_t   = (S_{t-1} + u*k_t (x) v_t)^T r_t
        S_t   = diag(w_t) S_{t-1} + k_t (x) v_t
    """
    r, k, v, w = (a.float() for a in (r, k, v, w))
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]       # (B, H, hd)
        outer = kt[..., :, None] * vt[..., None, :]               # (B, H, hd, hd)
        y = (rt[..., None, :] @ (state + u[None, :, :, None] * outer))[..., 0, :]
        state = wt[..., :, None] * state + outer
        ys.append(y)
    return torch.stack(ys, dim=1), state   # (B, S, H, hd)


def _group_norm(y: torch.Tensor, g: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, unbiased=False)   # jnp.var: population
    return (y - mu) * torch.rsqrt(var + eps) * g[None, None]


def _time_mix(cfg: ModelConfig, p: RWKV, x: torch.Tensor, shift_prev, wkv_state):
    b = x.shape[0]
    hd = cfg.rwkv_head_dim
    split = S.split_of(p, "w_r")
    heads = 0 if split is not None else None
    x_prev = _token_shift(x, shift_prev)
    x_w, x_k, x_v, x_r, x_g = _mix_targets(p, x, x_prev)
    x_k, x_v, x_r, x_g = (S.split_input(t, split) for t in (x_k, x_v, x_r, x_g))
    r = proj_in(x_r, p.w_r)
    k = proj_in(x_k, p.w_k)
    v = proj_in(x_v, p.w_v)
    g = F.silu(proj_in(x_g, p.w_g))
    w = _decay(p, x_w, heads)
    if wkv_state is None:
        wkv_state = torch.zeros((b, r.shape[2], hd, hd), dtype=torch.float32, device=x.device)
    y, wkv_state = _wkv_scan(r, k, v, w, S.model_block(p.bonus, heads), wkv_state)
    y = _group_norm(y, S.model_block(p.ln_x, heads)).to(x.dtype) * g
    out = proj_out(y, p.w_o)
    if split is not None:
        out = sh.tp_sum(out, split.mesh)
    return out, x[:, -1], wkv_state


def _channel_mix(p: RWKV, x: torch.Tensor, shift_prev):
    x_prev = _token_shift(x, shift_prev)
    xx = x_prev - x
    x_k = x + xx * p.cm_mu_k[None, None]
    x_r = x + xx * p.cm_mu_r[None, None]
    split = S.split_of(p, "cm_v")
    k = torch.square(torch.relu(S.split_input(x_k, split) @ p.cm_k))
    kv = k @ p.cm_v
    if split is not None:
        # cm_k by columns, cm_v by rows: the sum comes before the gate
        kv = sh.tp_sum(kv, split.mesh)
    return torch.sigmoid(x_r @ p.cm_r) * kv, x[:, -1]


def rwkv_block(cfg: ModelConfig, p: RWKV, norm1_w, norm2_w, x: torch.Tensor,
               cache: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Full RWKV residual block over any sequence length (S=1 is decode).

    ``cache=None`` starts from zero state (training / fresh prefill); the
    returned cache always carries the final state, so train can drop it and
    prefill keeps it.
    """
    shift_tm = cache["shift_tm"] if cache else None
    shift_cm = cache["shift_cm"] if cache else None
    wkv = cache["wkv"] if cache else None
    h1 = rms_norm(x, norm1_w, cfg)
    tm_out, new_shift_tm, new_wkv = _time_mix(cfg, p, h1, shift_tm, wkv)
    x = x + tm_out
    h2 = rms_norm(x, norm2_w, cfg)
    cm_out, new_shift_cm = _channel_mix(p, h2, shift_cm)
    x = x + cm_out
    return x, {"wkv": new_wkv, "shift_tm": new_shift_tm, "shift_cm": new_shift_cm}
