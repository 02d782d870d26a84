"""Encoder-decoder stack (whisper-small), the counterpart of
``repro.models.encdec``.

The audio conv frontend is a stub: ``input_specs()`` supplies precomputed
frame embeddings (B, encoder_len, d) directly.  The encoder is
bidirectional (no mask, no rope, learned positions); the decoder is causal
self-attention + cross-attention over the encoded memory, with the
standard serve split: cross K/V are computed once at prefill and reused
every decode step.  Layers run in order (``cfg.scan_layers`` has no
effect); caches are one dict per decoder layer.  Under a mesh each block
gathers its weights where it runs (``sharding_ctx.gathered``); under a
scope that splits "model" (training and serving), the encoder's and the
decoder's self- and cross-attention, the MLPs, the embedding and the tied
head compute on this rank's blocks (``models.layers``), and a serve
step's caches are its blocks of the reference's layout (the cross K/V as
``cross_k``/``cross_v``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import sharding_ctx as S

__all__ = ["EncDec", "init_encdec_params", "init_cache", "encode", "forward_train",
           "prefill", "decode", "apply_head"]


def _ones(cfg, device):
    return L.const_param((cfg.d_model,), 1.0, dtype=torch.float32, device=device)


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.ln1, self.ln2 = _ones(cfg, kw["device"]), _ones(cfg, kw["device"])
        self.attn = L.Attention(cfg, **kw)
        self.mlp = L.MLP(cfg, **kw)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        dev = kw["device"]
        self.ln1, self.ln2, self.ln3 = _ones(cfg, dev), _ones(cfg, dev), _ones(cfg, dev)
        self.self_attn = L.Attention(cfg, **kw)
        self.cross_attn = L.Attention(cfg, **kw)
        self.mlp = L.MLP(cfg, **kw)


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, *, max_positions: int, device, generator=None):
        super().__init__()
        kw = dict(dtype=L.model_dtype(cfg), device=device, generator=generator)
        self.encoder = nn.ModuleList(EncBlock(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(DecBlock(cfg, **kw) for _ in range(cfg.n_layers))
        self.embed = L.normal_param((cfg.padded_vocab, cfg.d_model), 0.02, **kw)
        self.enc_pos = L.normal_param((cfg.encoder_len, cfg.d_model), 0.02, **kw)
        self.dec_pos = L.normal_param((max_positions, cfg.d_model), 0.02, **kw)
        self.enc_final_norm = _ones(cfg, device)
        self.final_norm = _ones(cfg, device)


def init_encdec_params(cfg: ModelConfig, *, generator: torch.Generator | None, device,
                       max_positions: int) -> EncDec:
    """Weights drawn from ``generator`` with the reference's scales;
    ``dec_pos`` holds ``max_positions`` learned positions."""
    return EncDec(cfg, max_positions=max_positions, device=device, generator=generator)


def _cross_dim(cfg: ModelConfig, batch: int) -> int | None:
    """The dim of the cross K/V (B, encoder_len, KV, hd) split over "model"
    under a serve scope: 2 (kv heads), 1 (frames) or None."""
    return S.cache_dim("cross_k", (batch, cfg.encoder_len, cfg.n_kv_heads,
                                   cfg.resolved_head_dim))


def _cross_block(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """Cross K or V computed on this rank (its kv heads, or all of them) ->
    the rank's block at rest: frames cut when they are split."""
    return S.model_block(t, 1 if _cross_dim(cfg, t.shape[0]) == 1 else None)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device) -> list:
    """Zero caches of prefill's layout: per decoder layer the self cache and
    the cross K/V over ``encoder_len`` frames (this rank's blocks under a
    split)."""
    cross = [batch, cfg.encoder_len, cfg.n_kv_heads, cfg.resolved_head_dim]
    d = _cross_dim(cfg, batch)
    if d is not None:
        cross[d] //= S.model_split().size
    return [{"self": L.init_layer_cache(cfg, batch, capacity, dtype, device),
             "cross_k": torch.zeros(cross, dtype=dtype, device=device),
             "cross_v": torch.zeros(cross, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _head_logits(cfg: ModelConfig, params: EncDec, x: torch.Tensor) -> torch.Tensor:
    return L.head_logits(cfg, x, params.embed.T, S.split_of(params, "embed"))


# ------------------------------------------------------------------ encoder

def encode(cfg: ModelConfig, params: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, enc_len, d) from the frontend stub -> memory (B, enc_len, d)."""
    x = frames.to(params.embed.dtype) + params.enc_pos[None, : frames.shape[1]]
    for p in params.encoder:
        with S.gathered(p):
            h, _ = L.attention(cfg, p.attn, L.rms_norm(x, p.ln1, cfg), angles=None, mask=None,
                               causal=False)
            x = x + h
            x = x + L.mlp(cfg, p.mlp, L.rms_norm(x, p.ln2, cfg))
    return L.rms_norm(x, params.enc_final_norm, cfg)


# ------------------------------------------------------------------ decoder

def _cross_kv(p_cross: L.Attention, memory: torch.Tensor):
    """Cross K/V of the memory: this rank's kv heads where ``wk``/``wv`` are
    split over "model", else every head."""
    memory = S.split_input(memory, S.split_of(p_cross, "wk"))
    return L.proj_in(memory, p_cross.wk), L.proj_in(memory, p_cross.wv)


def _dec_block(cfg, p: DecBlock, x, *, self_mask, memory=None, cross_kv=None, cache=None,
               decode_pos=None):
    """One decoder block; cross K/V either fresh from ``memory`` (train /
    prefill) or reused from ``cross_kv`` (decode: this rank's blocks)."""
    h, new_self = L.attention(
        cfg, p.self_attn, L.rms_norm(x, p.ln1, cfg),
        angles=None, mask=self_mask,
        cache=cache["self"] if cache is not None else None,
        decode_pos=decode_pos,
    )
    x = x + h
    kv = cross_kv if cross_kv is not None else _cross_kv(p.cross_attn, memory)
    h, _ = L.attention(cfg, p.cross_attn, L.rms_norm(x, p.ln2, cfg),
                       angles=None, mask=None, kv_override=kv,
                       kv_slots_split=cross_kv is not None and _cross_dim(cfg, x.shape[0]) == 1)
    x = x + h
    x = x + L.mlp(cfg, p.mlp, L.rms_norm(x, p.ln3, cfg))
    return x, new_self, kv


def apply_head(cfg: ModelConfig, params: EncDec, hidden: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden -> pad-masked float32 logits (tied to the
    embedding table)."""
    return _head_logits(cfg, params, hidden)


def forward_train(cfg: ModelConfig, params: EncDec, frames, tokens, *, return_hidden: bool = False):
    """Teacher-forced decoder logits (B, S, V) (or final hidden states)."""
    with S.gathered(params, recurse=False):
        memory = encode(cfg, params, frames)
        s = tokens.shape[1]
        x = (L.embed_lookup(params.embed, tokens, S.split_of(params, "embed"))
             + params.dec_pos[None, :s])
        mask = L.causal_mask(s, device=x.device)
        for p in params.decoder:
            with S.gathered(p):
                x, _, _ = _dec_block(cfg, p, x, self_mask=mask, memory=memory)
        x = L.rms_norm(x, params.final_norm, cfg)
        if return_hidden:
            return x
        return _head_logits(cfg, params, x)


def prefill(cfg: ModelConfig, params: EncDec, frames, tokens, *, cache_capacity: int | None = None):
    """Encode + run the prompt through the decoder, building self caches and
    cross K/V.  Returns (last logits (B, V), caches)."""
    with S.gathered(params, recurse=False):
        memory = encode(cfg, params, frames)
        b, s = tokens.shape
        cap = cache_capacity or s
        x = (L.embed_lookup(params.embed, tokens, S.split_of(params, "embed"))
             + params.dec_pos[None, :s])
        mask = L.causal_mask(s, device=x.device)
        caches = []
        for p in params.decoder:
            with S.gathered(p):
                x_out, _, kv = _dec_block(cfg, p, x, self_mask=mask, memory=memory)
                # Self cache from this layer's normed input (as
                # transformer._fill_cache), with the k/v biases that
                # self-attention adds.  The reference leaves them out here
                # (ROADMAP.md §3): for a config with qkv_bias its decode would
                # disagree with its forward; whisper-small has none.
                h = L.rms_norm(x, p.ln1, cfg)
                cache = L.init_layer_cache(cfg, b, cap, x.dtype, x.device)
                cache = L.fill_layer_cache(cache, *L.kv_proj(p.self_attn, h), cfg=cfg)
            caches.append({"self": cache, "cross_k": _cross_block(cfg, kv[0]),
                           "cross_v": _cross_block(cfg, kv[1])})
            x = x_out
        x = L.rms_norm(x[:, -1:], params.final_norm, cfg)
        return _head_logits(cfg, params, x)[:, 0], caches


def decode(cfg: ModelConfig, params: EncDec, token: torch.Tensor, pos: torch.Tensor, caches: list):
    """One decoder token against (self cache, cross K/V); the self caches
    are written in place."""
    with S.gathered(params, recurse=False):
        x = (L.embed_lookup(params.embed, token[:, None], S.split_of(params, "embed"))
             + params.dec_pos[pos][:, None])
        new_caches = []
        for p, cache in zip(params.decoder, caches):
            with S.gathered(p):
                x, new_self, _ = _dec_block(cfg, p, x, self_mask=None,
                                            cross_kv=(cache["cross_k"], cache["cross_v"]),
                                            cache=cache, decode_pos=pos)
            new_caches.append({"self": new_self, "cross_k": cache["cross_k"],
                               "cross_v": cache["cross_v"]})
        x = L.rms_norm(x, params.final_norm, cfg)
        return _head_logits(cfg, params, x)[:, 0], new_caches
