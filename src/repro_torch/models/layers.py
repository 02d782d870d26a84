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
from repro_torch.models import sharding_ctx as S
from repro_torch.runtime import sharding as sh

NEG_INF = -2.0e38


# ---------------------------------------------------------------- parameters

def draw(t: torch.Tensor, law: tuple, generator) -> torch.Tensor:
    """Fill ``t`` in place by an init law: ``("normal", scale)``,
    ``("uniform", lo, hi)`` (from ``generator``) or ``("const", value)``."""
    kind = law[0]
    if kind == "normal":
        return t.normal_(generator=generator).mul_(law[1])
    if kind == "uniform":
        return t.uniform_(law[1], law[2], generator=generator)
    return t.fill_(law[1])


def _param(shape, law: tuple, *, dtype, device, generator) -> nn.Parameter:
    """A parameter drawn by ``law``; with no generator a random law leaves
    the storage unset (a ``meta`` model, or one whose values are about to be
    copied in).  The law stays on the parameter as ``init_law``, so one
    rank's blocks can be drawn a parameter at a time
    (``models.convert.init_blocks``).  Parameters take no gradient until the
    train step turns it on (``model.requires_grad_(True)``): serving needs
    none."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if law[0] == "const" or generator is not None:
        draw(t, law, generator)
    p = nn.Parameter(t, requires_grad=False)
    p.init_law = law
    return p


def normal_param(shape, scale: float, *, dtype, device, generator) -> nn.Parameter:
    """N(0, 1) * ``scale`` drawn from ``generator`` (on ``device``)."""
    return _param(shape, ("normal", scale), dtype=dtype, device=device, generator=generator)


def uniform_param(shape, lo: float, hi: float, *, dtype, device, generator) -> nn.Parameter:
    return _param(shape, ("uniform", lo, hi), dtype=dtype, device=device, generator=generator)


def const_param(shape, value: float, *, dtype, device) -> nn.Parameter:
    return _param(shape, ("const", value), dtype=dtype, device=device, generator=None)


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


def vocab_pad_mask(cfg: ModelConfig, device, first: int = 0, n: int | None = None
                   ) -> torch.Tensor | None:
    """Additive mask of the vocab columns ``first .. first + n - 1`` (all
    ``V_pad`` by default: a rank's block of them under a split): NEG_INF on
    the columns past ``cfg.vocab``, None when there are none."""
    n = cfg.padded_vocab if n is None else n
    if first + n <= cfg.vocab:
        return None
    cols = torch.arange(first, first + n, device=device)
    return torch.where(cols < cfg.vocab, 0.0, NEG_INF).float()


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, split: S.Split | None = None
                 ) -> torch.Tensor:
    """Rows ``ids`` of an embedding table; with ``split`` (``sharding_ctx.
    split_of`` the table) ``table`` is this rank's block of the vocab rows
    and the lookup is vocab-parallel (``runtime.sharding.vocab_lookup``)."""
    if split is None:
        return table[ids]
    return sh.vocab_lookup(table, ids, split.mesh)


def head_logits(cfg: ModelConfig, hidden: torch.Tensor, head: torch.Tensor,
                split: S.Split | None = None) -> torch.Tensor:
    """hidden (B, C, d) by the head (d, V_pad) -> float32 logits, final
    softcap, pad mask.  With ``split`` (``sharding_ctx.split_of`` the head)
    ``head`` is this rank's block of the vocab columns, and so are the
    logits (the mask at their global column indices)."""
    logits = (S.split_input(hidden, split) @ head).float()
    logits = final_softcap(cfg, logits)
    n = head.shape[-1]
    mask = vocab_pad_mask(cfg, hidden.device, split.index * n if split is not None else 0, n)
    if mask is not None:
        logits = logits + mask[None, None, :]
    return logits


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


class KVSplit(NamedTuple):
    """How an attention cache of ``slots`` full slots lies over "model"
    (``sharding_ctx.cache_dim``): k/v (and their int8 scales) on kv heads
    (``kv == 2``), on slots (``kv == 1``) or whole (None), ``positions`` on
    slots or whole, this rank being ``index`` of ``size``.  A slot's owner
    is ``slot // (slots / size)``.  Outside a split everything is whole."""

    slots: int
    kv: int | None = None
    positions: bool = False
    size: int = 1
    index: int = 0


def kv_split(cfg: ModelConfig, batch: int, slots: int) -> KVSplit:
    """The layout of a cache of ``slots`` full slots under the serve scope
    (trivial outside a split)."""
    split = S.model_split()
    if split is None:
        return KVSplit(slots)
    kv = S.cache_dim("k", (batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim))
    return KVSplit(slots, kv, S.cache_dim("positions", (batch, slots)) == 1, split.size,
                   split.index)


def layer_split(cfg: ModelConfig, cache: LayerCache, window: int | None) -> KVSplit:
    """The layout of a layer's cache: its own slots outside a split; under
    one, the scope's capacity, or a local layer's ring of ``min(capacity,
    window)``."""
    split = S.model_split()
    if split is None:
        return KVSplit(cache.k.shape[1])
    slots = split.capacity if window is None else min(split.capacity, window)
    return kv_split(cfg, cache.k.shape[0], slots)


def init_layer_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device) -> LayerCache:
    """An empty cache of ``capacity`` slots; under a serve scope that splits
    "model", this rank's block of it (``kv_split``)."""
    lay = kv_split(cfg, batch, capacity)
    kv = cfg.n_kv_heads // (lay.size if lay.kv == 2 else 1)
    t_kv = capacity // (lay.size if lay.kv == 1 else 1)
    t_pos = capacity // (lay.size if lay.positions else 1)
    hd = cfg.resolved_head_dim
    positions = torch.full((batch, t_pos), -1, dtype=torch.int32, device=device)
    if cfg.kv_cache_dtype == "int8":
        return LayerCache(
            k=torch.zeros((batch, t_kv, kv, hd), dtype=torch.int8, device=device),
            v=torch.zeros((batch, t_kv, kv, hd), dtype=torch.int8, device=device),
            positions=positions,
            k_scale=torch.zeros((batch, t_kv, kv), dtype=torch.bfloat16, device=device),
            v_scale=torch.zeros((batch, t_kv, kv), dtype=torch.bfloat16, device=device),
        )
    return LayerCache(
        k=torch.zeros((batch, t_kv, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, t_kv, kv, hd), dtype=dtype, device=device),
        positions=positions,
    )


def _kv_payload(cache: LayerCache, k: torch.Tensor, v: torch.Tensor) -> dict:
    """The k/v rows to store, by field: quantized with their scales in int8
    mode."""
    if cache.k_scale is not None:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def _owned_runs(lo: int, hi: int, slots: int, first: int, last: int) -> list:
    """Runs ``(a, b)`` of the positions ``lo .. hi - 1`` whose slot
    (``position % slots``) lies in ``first .. last - 1``."""
    runs = []
    for lap in range(lo // slots, (hi - 1) // slots + 1):
        a, b = max(lo, lap * slots + first), min(hi, lap * slots + last)
        if a < b:
            runs.append((a, b))
    return runs


def fill_layer_cache(cache: LayerCache, k: torch.Tensor, v: torch.Tensor, *, cfg: ModelConfig,
                     window: int | None = None) -> LayerCache:
    """Prefill: lay the last ``min(S, slots)`` positions of k/v (B, S, KV,
    hd) into the (possibly ring) cache at ``position % slots``, in place.
    Under a serve scope that splits the cache (``layer_split``; ``window``
    names a local layer's ring) each field on slots takes only the
    positions whose slots this rank's block holds: they are known on the
    host, and their indices are built on the device (no host wait)."""
    lay = layer_split(cfg, cache, window)
    b, s = k.shape[:2]
    take = min(s, lay.slots)
    block = lay.slots // lay.size
    dev = k.device

    def own(on_slots: bool):
        """(the positions a field's block holds, their slots in it)."""
        if not on_slots:
            pos = torch.arange(s - take, s, device=dev)
            return pos, pos % lay.slots
        first = lay.index * block
        parts = [torch.arange(a, c, device=dev)
                 for a, c in _owned_runs(s - take, s, lay.slots, first, first + block)]
        pos = (parts[0] if len(parts) == 1 else torch.cat(parts) if parts
               else torch.zeros(0, dtype=torch.long, device=dev))
        return pos, pos % lay.slots - first

    pos, slot = own(lay.positions)
    cache.positions[:, slot] = pos.to(torch.int32)[None].expand(b, -1)
    if lay.positions != (lay.kv == 1):
        pos, slot = own(lay.kv == 1)
    rows = pos if lay.kv == 1 else slice(s - take, s)
    for name, t in _kv_payload(cache, k[:, rows], v[:, rows]).items():
        getattr(cache, name)[:, slot] = t
    return cache


def cache_insert(cache: LayerCache, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                 lay: KVSplit | None = None) -> LayerCache:
    """Insert one decode step (k/v: (B, 1, KV, hd), pos: (B,)) at ``pos %
    slots`` — a ring for local layers, the exact slot for global ones.
    Under a split (``lay``: ``layer_split``) a field on slots is written
    only in the rows whose slot this rank owns (the others keep their
    values: no host wait on which rows those are).  Unlike the reference,
    which returns a new cache, this writes the cache's tensors in place and
    returns the same cache."""
    lay = lay or KVSplit(cache.k.shape[1])
    slot = (pos % lay.slots).long()
    b = torch.arange(cache.k.shape[0], device=pos.device)
    mine = local = None
    if lay.positions or lay.kv == 1:
        block = lay.slots // lay.size
        mine = slot // block == lay.index
        local = torch.clamp(slot - lay.index * block, 0, block - 1)

    def put(t: torch.Tensor, rows: torch.Tensor, on_slots: bool):
        if not on_slots:
            t[b, slot] = rows
            return
        keep = mine.view(-1, *([1] * (rows.dim() - 1)))
        t[b, local] = torch.where(keep, rows, t[b, local])

    put(cache.positions, pos.to(torch.int32), lay.positions)
    for name, rows in _kv_payload(cache, k[:, 0], v[:, 0]).items():
        put(getattr(cache, name), rows, lay.kv == 1)
    return cache


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


def _scores(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor | None
            ) -> torch.Tensor:
    """q (B, S, H, hd) against every slot of k (B, T, KV, hd) -> float32
    logits (B, KV, G, S, T), scaled, softcapped, plus the additive mask (S,
    T) or (B, 1, T) (decode)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    kt = k.permute(0, 2, 3, 1)                                   # (B, KV, hd, T)
    logits = (_heads_first(qg) @ kt).view(b, kvh, h // kvh, s, t).float() * hd ** -0.5
    logits = _softcap(logits, cfg.attn_softcap)
    if mask is not None:
        if mask.dim() == 2:                       # (S, T)
            logits = logits + mask[None, None, None, :, :]
        else:                                     # (B, 1, T) decode
            logits = logits + mask[:, None, None, :, :]
    return logits


def _dense_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor | None) -> torch.Tensor:
    """Softmax attention over every slot of k/v: q (B, S, H, hd), k/v (B, T,
    KV, hd), an additive mask (``_scores``) -> context (B, S, H, hd)."""
    b, s, h, hd = q.shape
    logits = _scores(cfg, q, k, mask)
    _, kvh, group, _, t = logits.shape
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    ctx = probs.view(b, kvh, group * s, t) @ v.transpose(1, 2)   # (B, KV, G*S, hd)
    return ctx.view(b, kvh, group, s, hd).permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def _partial_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor | None, split) -> torch.Tensor:
    """Attention of every head over slots split over "model", this rank
    holding ``k``/``v`` (B, T_local, KV, hd) of its slots: the partial max,
    denominator and weighted sum over its slots, combined over "model"
    (flash-decoding: the partial-softmax reductions GSPMD inserts).  q (B, S,
    H, hd) holds every head; ``mask`` (B, 1, T_local) is additive.  A rank
    whose slots are all masked adds exp(NEG_INF - max) = 0."""
    b, s, h, hd = q.shape
    logits = _scores(cfg, q, k, mask)
    _, kvh, group, _, t = logits.shape
    m = sh.tp_max(torch.amax(logits, dim=-1), split.mesh)                 # (B, KV, G, S)
    p = torch.exp(logits - m[..., None])
    pv = (p.to(v.dtype).view(b, kvh, group * s, t) @ v.transpose(1, 2)).view(b, kvh, group, s, hd)
    both = sh.tp_sum(torch.cat([pv.float(), torch.sum(p, dim=-1)[..., None]], dim=-1), split.mesh)
    out = both[..., :hd] / torch.clamp_min(both[..., hd:], 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def _kv_for_heads(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, first: int, n: int):
    """From k/v of every kv head, each of q heads ``first .. first + n -
    1``'s kv head (a q head per kv head)."""
    kv_of_q = torch.arange(first, first + n, device=k.device) // (cfg.n_heads // cfg.n_kv_heads)
    return k.index_select(2, kv_of_q), v.index_select(2, kv_of_q)


def _out_proj(p: "Attention", ctx: torch.Tensor) -> torch.Tensor:
    """``wo`` on the context; a ``wo`` split on heads over "model" is
    row-parallel, so its partial outputs are summed over "model"."""
    out = proj_out(ctx, p.wo)
    split = S.split_of(p, "wo")
    return out if split is None else sh.tp_sum(out, split.mesh)


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
    kv_slots_split: bool = False,           # kv_override holds this rank's slots only
) -> tuple[torch.Tensor, LayerCache | None]:
    """Self- or cross-attention.  Under a scope that splits "model"
    (``sharding_ctx.split_of``) this rank computes its block of the q heads
    where ``wq``/``bq``/``wo`` are split, with its kv heads where
    ``wk``/``wv``/``bk``/``bv`` are split too (each q head's kv head picked
    out where they are whole), and ``wo``'s outputs are summed over
    "model".  K/V split on slots (a decode cache, or ``kv_slots_split``
    cross K/V): flash-decoding over every head, then this rank's heads.  A
    cross K/V of ``kv_override`` is computed by the caller the same way
    (its kv heads where ``wk``/``wv`` are split, else whole)."""
    b, s, _ = x.shape

    heads = S.split_of(p, "wq")
    xs = S.split_input(x, heads)
    q = proj_in(xs, p.wq)
    if p.bq is not None:
        q = q + p.bq
    if kv_override is None:
        k, v = kv_proj(p, x if S.split_of(p, "wk") is None else xs)
    else:
        k, v = kv_override
    if angles is not None:
        q = apply_rope(q, angles)
        if kv_override is None:
            k = apply_rope(k, angles)

    on_slots = kv_slots_split
    new_cache = None
    if cache is not None:
        lay = layer_split(cfg, cache, window)
        new_cache = cache_insert(cache, k, v, decode_pos, lay)
        k, v = cache_kv_values(new_cache, x.dtype)  # (B, T, KV, hd)
        on_slots = lay.kv == 1
        positions = new_cache.positions
        if lay.positions and not on_slots:
            positions = S.model_whole(positions, 1)   # every slot's k/v is on this rank
        mask = decode_mask(decode_pos, positions, window)
    if on_slots:
        ctx = _partial_attention(cfg, S.model_whole(q, 2 if heads else None), k, v, mask,
                                 S.model_split())
        if heads is not None:
            ctx = ctx.narrow(2, heads.index * q.shape[2], q.shape[2])
        return _out_proj(p, ctx), new_cache
    if heads is not None and S.split_of(p, "wk") is None:
        # whole k/v: each rank's q heads read theirs, so each k/v cotangent
        # is partial on a rank and summed over "model"
        k, v = _kv_for_heads(cfg, S.split_input(k, heads), S.split_input(v, heads),
                             heads.index * q.shape[2], q.shape[2])

    # Flash-style path: full-sequence attention (train/prefill/encoder) with
    # chunking enabled; decode and cross-attention keep the dense path.
    if cfg.attn_chunk and cache is None and s > 1 and kv_override is None:
        h, kvh, hd = q.shape[2], k.shape[2], q.shape[3]
        ctx = _chunked_attention(cfg, q.reshape(b, s, kvh, h // kvh, hd), k, v, causal=causal,
                                 window=window)
        return _out_proj(p, ctx), None
    return _out_proj(p, _dense_attention(cfg, q, k, v, mask)), new_cache


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
    split = S.split_of(p, "w_out")
    x = S.split_input(x, split)
    up = x @ p.w_in
    if cfg.activation == "silu":
        gated = F.silu(x @ p.w_gate) * up
    elif cfg.activation == "geglu":
        gated = F.gelu(x @ p.w_gate, approximate="tanh") * up
    elif cfg.activation == "gelu":
        gated = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    out = gated @ p.w_out
    if split is not None:
        # w_in and w_gate by columns, w_out by rows: one sum over "model"
        out = sh.tp_sum(out, split.mesh)
    return out


# ------------------------------------------------------------------- softcap

def final_softcap(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    return _softcap(logits, cfg.final_softcap)
