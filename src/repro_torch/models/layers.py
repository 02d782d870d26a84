"""Shared transformer layer vocabulary of the LM wing, the counterpart of
``repro.models.layers``.

Parameters live in ``nn.Module``s whose attribute names are the reference's
leaf names (``wq``, ``wk``, ``w_in``...), in the reference's layouts (``wq``
is (d, H, hd), ``wo`` (H, hd, d)), so a reference pytree maps onto them leaf
for leaf (``repro_torch.models.convert``).  The computations are plain
functions over those modules and tensors, as in the reference, with the
reference's rounding order in bfloat16: rope's cos/sin and attention
probabilities are cast to the activation dtype before their products,
attention logits to float32 before the scale.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig

NEG_INF = -2.0e38


# ---------------------------------------------------------------- parameters

def normal_param(shape, scale: float, *, dtype, device, generator) -> nn.Parameter:
    """N(0, 1) * ``scale`` drawn from ``generator`` (on ``device``); with no
    generator the storage is left unset (a ``meta`` model, or one whose
    values are about to be copied in).  Parameters take no gradient until
    the train step turns it on (``model.requires_grad_(True)``): serving
    needs none."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if generator is not None:
        t.normal_(generator=generator).mul_(scale)
    return nn.Parameter(t, requires_grad=False)


def uniform_param(shape, lo: float, hi: float, *, dtype, device, generator) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if generator is not None:
        t.uniform_(lo, hi, generator=generator)
    return nn.Parameter(t, requires_grad=False)


def const_param(shape, value: float, *, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device), requires_grad=False)


def norm_param(cfg: ModelConfig, device) -> nn.Parameter:
    """An RMSNorm weight: zeros under the (1 + w) convention, else ones."""
    return const_param((cfg.d_model,), 0.0 if cfg.norm_plus_one else 1.0,
                       dtype=torch.float32, device=device)


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,dhk->...hk")``: x (..., d) by w (d, *rest)."""
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def proj_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``: x (b, s, h, k) by w (h, k, d)."""
    return x.reshape(*x.shape[:-2], -1) @ w.reshape(-1, w.shape[-1])


# ------------------------------------------------------------ remat policies
# A policy is the ``context_fn`` of ``torch.utils.checkpoint.checkpoint``:
# what a checkpointed group keeps from its forward for the backward.

def nothing_saveable():
    """Remat ``"full"`` (``jax.checkpoint_policies.nothing_saveable``): keep
    only the group's inputs, recompute the rest in the backward."""
    return contextlib.nullcontext(), contextlib.nullcontext()


def dots_with_no_batch_dims_saveable():
    """Remat ``"dots"`` (``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``): keep the outputs of unbatched matrix
    products (``aten.mm``/``aten.addmm``: the projections and MLPs), recompute
    everything else, batched products (attention scores, MoE experts)
    included."""
    return create_selective_checkpoint_contexts(
        [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


# --------------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, *, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if cfg.norm_plus_one else w.float()
    return (y * scale).to(x.dtype)


# ---------------------------------------------------------------------- rope

def rope_freqs(cfg: ModelConfig, device) -> torch.Tensor:
    half = cfg.resolved_head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32, device=device), exponent)


def rope_angles(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """positions (B, S) or (3, B, S) for M-RoPE -> angles (B, S, half).

    M-RoPE (Qwen2-VL): the ``half`` rotary pairs are split into sections
    (t, h, w); each section takes its angle from its own position stream.
    """
    inv = rope_freqs(cfg, positions.device)
    if positions.dim() == 2:
        return positions[..., None].float() * inv
    if cfg.mrope_sections is None:
        raise ValueError("3-D positions require mrope_sections")
    parts = []
    start = 0
    for idx, width in enumerate(cfg.mrope_sections):
        parts.append(positions[idx][..., None].float() * inv[start : start + width])
        start += width
    if start != inv.shape[0]:
        raise ValueError(f"mrope sections sum {start} != rotary half {inv.shape[0]}")
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd), angles (B, S, half) -> rotated x (pairs = split halves)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------- masks

def causal_mask(s: int, *, device) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return torch.where(j <= i, 0.0, NEG_INF).float()


def local_causal_mask(s: int, window: int, *, device) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    ok = (j <= i) & (j > i - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def decode_mask(q_pos: torch.Tensor, kv_positions: torch.Tensor, window: int | None) -> torch.Tensor:
    """One-token decode: q_pos (B,), kv_positions (B, T) absolute (or -1 for
    empty slots) -> (B, 1, T) additive mask."""
    ok = (kv_positions >= 0) & (kv_positions <= q_pos[:, None])
    if window is not None:
        ok &= kv_positions > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF).float()[:, None, :]


def vocab_pad_mask(cfg: ModelConfig, device) -> torch.Tensor | None:
    """Additive (V_pad,) mask: NEG_INF on the columns past ``cfg.vocab``."""
    if cfg.padded_vocab == cfg.vocab:
        return None
    return torch.where(torch.arange(cfg.padded_vocab, device=device) < cfg.vocab, 0.0, NEG_INF).float()


# ------------------------------------------------------------------ KV cache

class LayerCache(NamedTuple):
    """Per-layer attention cache.  ``positions`` carries absolute positions
    (-1 = empty), which uniformly handles global caches and local ring
    buffers (slot = position % capacity).  With ``cfg.kv_cache_dtype ==
    "int8"`` the k/v payloads are per-(b, t, kv)-row symmetric-quantized
    int8 with bfloat16 scales."""

    k: torch.Tensor                       # (B, T, KV, hd) model dtype or int8
    v: torch.Tensor                       # (B, T, KV, hd)
    positions: torch.Tensor               # (B, T) int32
    k_scale: torch.Tensor | None = None   # (B, T, KV) bfloat16, int8 mode only
    v_scale: torch.Tensor | None = None


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 payload + per-row scale.  The payload divides by the
    float32 scale; the scale is stored rounded to bfloat16.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x32 = x.float()
    s = torch.amax(torch.abs(x32), dim=-1) / 127.0
    s = torch.clamp_min(s, 1e-8)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return q.to(dtype) * s[..., None].to(dtype)


def init_layer_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device) -> LayerCache:
    kv = cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    positions = torch.full((batch, capacity), -1, dtype=torch.int32, device=device)
    if cfg.kv_cache_dtype == "int8":
        return LayerCache(
            k=torch.zeros((batch, capacity, kv, hd), dtype=torch.int8, device=device),
            v=torch.zeros((batch, capacity, kv, hd), dtype=torch.int8, device=device),
            positions=positions,
            k_scale=torch.zeros((batch, capacity, kv), dtype=torch.bfloat16, device=device),
            v_scale=torch.zeros((batch, capacity, kv), dtype=torch.bfloat16, device=device),
        )
    return LayerCache(
        k=torch.zeros((batch, capacity, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, capacity, kv, hd), dtype=dtype, device=device),
        positions=positions,
    )


def cache_write(cache: LayerCache, index: tuple, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor) -> LayerCache:
    """Write k/v rows and their absolute positions at ``index`` (indices of
    the cache's first two axes), in place, quantizing in int8 mode."""
    cache.positions[index] = positions.to(torch.int32)
    if cache.k_scale is not None:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache.k[index] = kq
        cache.v[index] = vq
        cache.k_scale[index] = ks
        cache.v_scale[index] = vs
    else:
        cache.k[index] = k
        cache.v[index] = v
    return cache


def fill_layer_cache(cache: LayerCache, k: torch.Tensor, v: torch.Tensor) -> LayerCache:
    """Prefill: lay the last ``min(S, capacity)`` positions of k/v (B, S, KV,
    hd) into the (possibly ring) cache at ``position % capacity``."""
    s = k.shape[1]
    cap = cache.k.shape[1]
    take = min(s, cap)
    pos = torch.arange(s - take, s, dtype=torch.int32, device=k.device)
    slots = (pos % cap).long()
    return cache_write(cache, (slice(None), slots), k[:, s - take :], v[:, s - take :],
                       pos[None, :].expand(k.shape[0], take))


def cache_insert(cache: LayerCache, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor) -> LayerCache:
    """Insert one decode step (k/v: (B, 1, KV, hd), pos: (B,)) at
    ``pos % capacity`` — a ring for local layers, the exact slot for global
    ones.  Unlike the reference, which returns a new cache, this writes the
    cache's tensors in place and returns the same cache."""
    cap = cache.k.shape[1]
    slot = (pos % cap).long()
    b = torch.arange(cache.k.shape[0], device=pos.device)
    return cache_write(cache, (b, slot), k[:, 0], v[:, 0], pos)


def cache_kv_values(cache: LayerCache, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize dequantized (B, T, KV, hd) k/v for attention."""
    if cache.k_scale is not None:
        return (
            dequantize_kv(cache.k, cache.k_scale, dtype),
            dequantize_kv(cache.v, cache.v_scale, dtype),
        )
    return cache.k, cache.v


# ----------------------------------------------------------------- attention

class Attention(nn.Module):
    """Attention weights (the reference's ``init_attention_params``)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator=None):
        super().__init__()
        hd, d = cfg.resolved_head_dim, cfg.d_model
        kw = dict(dtype=dtype, device=device, generator=generator)
        scale = d ** -0.5
        self.wq = normal_param((d, cfg.n_heads, hd), scale, **kw)
        self.wk = normal_param((d, cfg.n_kv_heads, hd), scale, **kw)
        self.wv = normal_param((d, cfg.n_kv_heads, hd), scale, **kw)
        self.wo = normal_param((cfg.n_heads, hd, d), scale, **kw)
        for name, heads in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
            bias = const_param((heads, hd), 0.0, dtype=dtype, device=device) if cfg.qkv_bias else None
            self.register_parameter(name, bias)


def kv_proj(p: Attention, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> k, v (B, S, KV, hd), biases added when the config has
    them (before rope)."""
    k, v = proj_in(x, p.wk), proj_in(x, p.wv)
    if p.bk is not None:
        k, v = k + p.bk, v + p.bv
    return k, v


def _softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _heads_first(qg: torch.Tensor) -> torch.Tensor:
    """(B, S, KV, G, hd) -> (B, KV, G*S, hd), rows ordered (g, s)."""
    b, s, kvh, g, hd = qg.shape
    return qg.permute(0, 2, 3, 1, 4).reshape(b, kvh, g * s, hd)


def _chunked_attention(
    cfg: ModelConfig,
    qg: torch.Tensor,      # (B, S, KV, G, hd), unscaled
    k: torch.Tensor,       # (B, T, KV, hd)
    v: torch.Tensor,       # (B, T, KV, hd)
    *,
    causal: bool,
    window: int | None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash-style): the (S, T)
    score tile exists one ``attn_chunk``-wide slab at a time, and masks are
    built from positions per chunk.  ``m`` starts at -inf and ``denom`` is
    clamped at 1e-30, as in the reference."""
    b, s, kvh, g, hd = qg.shape
    t = k.shape[1]
    chunk = min(cfg.attn_chunk, t)
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = hd ** -0.5
    dev = qg.device
    q_pos = torch.arange(s, device=dev)
    q = _heads_first(qg)                                   # (B, KV, G*S, hd)
    m = torch.full((b, kvh, g, s), -torch.inf, dtype=torch.float32, device=dev)
    denom = torch.zeros((b, kvh, g, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, s, hd), dtype=torch.float32, device=dev)
    for c_idx in range(n_chunks):
        k_c = k[:, c_idx * chunk : (c_idx + 1) * chunk].transpose(1, 2)   # (B, KV, C, hd)
        v_c = v[:, c_idx * chunk : (c_idx + 1) * chunk].transpose(1, 2)
        logits = (q @ k_c.transpose(-1, -2)).view(b, kvh, g, s, chunk).float() * scale
        logits = _softcap(logits, cfg.attn_softcap)
        kv_pos = c_idx * chunk + torch.arange(chunk, device=dev)
        ok = (kv_pos[None, :] < t).expand(s, chunk)  # padding slots
        if causal:
            ok = ok & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            ok = ok & (kv_pos[None, :] > q_pos[:, None] - window)
        logits = torch.where(ok, logits, NEG_INF)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        denom = denom * corr + torch.sum(p, dim=-1)
        pv = (p.to(v_c.dtype).view(b, kvh, g * s, chunk) @ v_c).view(b, kvh, g, s, hd)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp_min(denom, 1e-30)[..., None]
    # (B, KV, G, S, hd) -> (B, S, KV*G, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, hd).to(qg.dtype)


def attention(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,                        # (B, S, D)
    *,
    angles: torch.Tensor | None,            # rope angles (B, S, half) or None
    mask: torch.Tensor | None,              # additive (S, T) / (B, 1, T) / None
    cache: LayerCache | None = None,        # decode path when S == 1
    decode_pos: torch.Tensor | None = None,  # (B,) absolute positions of the new token
    window: int | None = None,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,  # cross-attention
    causal: bool = True,
) -> tuple[torch.Tensor, LayerCache | None]:
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    q = proj_in(x, p.wq)
    if p.bq is not None:
        q = q + p.bq
    k, v = kv_proj(p, x) if kv_override is None else kv_override
    if angles is not None:
        q = apply_rope(q, angles)
        if kv_override is None:
            k = apply_rope(k, angles)

    new_cache = None
    if cache is not None:
        new_cache = cache_insert(cache, k, v, decode_pos)
        k, v = cache_kv_values(new_cache, x.dtype)  # (B, T, KV, hd)
        mask = decode_mask(decode_pos, new_cache.positions, window)

    group = h // kvh
    qg = q.reshape(b, s, kvh, group, hd)

    # Flash-style path: full-sequence attention (train/prefill/encoder) with
    # chunking enabled; decode and cross-attention keep the dense path.
    if cfg.attn_chunk and cache is None and s > 1 and kv_override is None:
        ctx = _chunked_attention(cfg, qg, k, v, causal=causal, window=window)
        return proj_out(ctx, p.wo), None

    t = k.shape[1]
    scale = hd ** -0.5
    kt = k.permute(0, 2, 3, 1)                                   # (B, KV, hd, T)
    logits = (_heads_first(qg) @ kt).view(b, kvh, group, s, t).float() * scale
    logits = _softcap(logits, cfg.attn_softcap)
    if mask is not None:
        if mask.dim() == 2:                       # (S, T)
            logits = logits + mask[None, None, None, :, :]
        else:                                     # (B, 1, T) decode
            logits = logits + mask[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = probs.view(b, kvh, group * s, t) @ v.transpose(1, 2)   # (B, KV, G*S, hd)
    ctx = ctx.view(b, kvh, group, s, hd).permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return proj_out(ctx, p.wo), new_cache


# ----------------------------------------------------------------------- mlp

class MLP(nn.Module):
    """MLP weights (the reference's ``init_mlp_params``); ``w_gate`` only
    for the gated activations."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator=None, d_ff: int | None = None):
        super().__init__()
        d = cfg.d_model
        f = d_ff or cfg.d_ff
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.w_in = normal_param((d, f), d ** -0.5, **kw)
        self.w_out = normal_param((f, d), f ** -0.5, **kw)
        gate = normal_param((d, f), d ** -0.5, **kw) if cfg.activation in ("silu", "geglu") else None
        self.register_parameter("w_gate", gate)


def mlp(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    up = x @ p.w_in
    if cfg.activation == "silu":
        gated = F.silu(x @ p.w_gate) * up
    elif cfg.activation == "geglu":
        gated = F.gelu(x @ p.w_gate, approximate="tanh") * up
    elif cfg.activation == "gelu":
        gated = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    return gated @ p.w_out


# ------------------------------------------------------------------- softcap

def final_softcap(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    return _softcap(logits, cfg.final_softcap)
