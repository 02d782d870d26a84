"""Decoder-only LM for every non-enc-dec arch in the zoo, the counterpart of
``repro.models.transformer``.

The layer stack is ``repeats`` copies of ``cfg.block_pattern`` plus a tail
(``n_layers = repeats * len(pattern) + len(tail)``), as in the reference.
The reference stacks each pattern position's parameters over the repeats
and scans them; here every layer is its own ``Block`` in an
``nn.ModuleList``, in layer order (``_layer_kinds``), and the layers run in
that order (``cfg.scan_layers`` has no effect).  Caches are a list with one
entry per layer in the same order.

Three execution modes share the block code:
    train   — full sequence, no caches; each repeat of the pattern
              optionally checkpointed (``remat_policy``)
    prefill — full sequence, returns caches (serve step 1)
    decode  — S=1 against caches (serve step N); attention caches are
              written in place

Under a scope that splits "model" (``sharding_ctx.model_split``; training
and serving) every layer computes on its "model" blocks.  A serve step's
caches are this rank's blocks of the reference's layout: attention caches
as ``layers.init_layer_cache`` lays them out, recurrent states on
"state"/heads.  The rg-lru and rwkv mixes compute on their blocks of the
channels and heads, so a layer steps its state blocks as they are.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import sharding_ctx as S

__all__ = ["Block", "Transformer", "init_params", "init_cache", "forward_train",
           "prefill", "decode", "stack_geometry", "apply_head"]


# ----------------------------------------------------------------- geometry

def stack_geometry(cfg: ModelConfig) -> tuple[int, tuple[str, ...]]:
    """(repeats, tail_kinds)."""
    k = len(cfg.block_pattern)
    return cfg.n_layers // k, cfg.block_pattern[: cfg.n_layers % k]


def _layer_kinds(cfg: ModelConfig) -> list[str]:
    reps, tail = stack_geometry(cfg)
    return list(cfg.block_pattern) * reps + list(tail)


# --------------------------------------------------------------------- init

class Block(nn.Module):
    """One residual block of kind ``attn``, ``local``, ``rwkv`` or ``rec``;
    parameters named as the reference's per-block leaves."""

    def __init__(self, cfg: ModelConfig, kind: str, *, dtype, device, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.kind = kind
        self.ln1 = L.norm_param(cfg, device)
        self.ln2 = L.norm_param(cfg, device)
        self.attn = self.mlp = self.moe = self.rwkv = self.rec = None
        self.pn1 = self.pn2 = None
        if kind in ("attn", "local"):
            self.attn = L.Attention(cfg, **kw)
            if cfg.moe is not None:
                from repro_torch.models.moe import MoE

                self.moe = MoE(cfg, **kw)
            else:
                self.mlp = L.MLP(cfg, **kw)
            if cfg.post_norms:
                self.pn1 = L.norm_param(cfg, device)
                self.pn2 = L.norm_param(cfg, device)
        elif kind == "rwkv":
            from repro_torch.models.rwkv6 import RWKV

            self.rwkv = RWKV(cfg, **kw)
        elif kind == "rec":
            from repro_torch.models.rglru import RGLRU

            self.rec = RGLRU(cfg, **kw)
            self.mlp = L.MLP(cfg, **kw)
        else:
            raise ValueError(f"unknown block kind {kind!r}")


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        dtype = L.model_dtype(cfg)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.layers = nn.ModuleList(Block(cfg, kind, **kw) for kind in _layer_kinds(cfg))
        self.embed = L.normal_param((cfg.padded_vocab, cfg.d_model), 0.02, **kw)
        self.final_norm = L.norm_param(cfg, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else L.normal_param((cfg.d_model, cfg.padded_vocab), 0.02, **kw))


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None, device) -> Transformer:
    """Weights drawn from ``generator`` (a generator on ``device``) with the
    reference's scales; ``generator=None`` leaves them unset."""
    return Transformer(cfg, device=device, generator=generator)


# ------------------------------------------------------------------- caches

def _init_state(cfg: ModelConfig, kind: str, batch: int, dtype, device) -> dict:
    """A recurrent layer's whole zero state."""
    if kind == "rwkv":
        from repro_torch.models.rwkv6 import init_rwkv_cache

        return init_rwkv_cache(cfg, batch, dtype, device)
    from repro_torch.models.rglru import init_rglru_cache

    return init_rglru_cache(cfg, batch, dtype, device)


def state_blocks(state: dict) -> dict:
    """A recurrent state (whole) -> this rank's block of each tensor under a
    serve scope that splits "model" (``sharding_ctx.cache_dim``)."""
    return {name: S.model_block(t, S.cache_dim(name, tuple(t.shape)))
            for name, t in state.items()}


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device) -> list:
    """One cache per layer, in layer order.  Local layers keep a ring of
    ``min(capacity, local_window)`` slots.  Under a serve scope that splits
    "model", each is this rank's block."""

    def one(kind: str):
        if kind == "attn":
            return L.init_layer_cache(cfg, batch, capacity, dtype, device)
        if kind == "local":
            return L.init_layer_cache(cfg, batch, min(capacity, cfg.local_window), dtype, device)
        if kind in ("rwkv", "rec"):
            return state_blocks(_init_state(cfg, kind, batch, dtype, device))
        raise ValueError(kind)

    return [one(kind) for kind in _layer_kinds(cfg)]


# ------------------------------------------------------------------- blocks

def _block(cfg: ModelConfig, p: Block, x: torch.Tensor, *, angles, mask, cache, decode_pos,
           mode: str):
    """One residual block.  Returns (x, new_cache, moe_aux or None)."""
    kind = p.kind
    if kind in ("attn", "local"):
        window = cfg.local_window if kind == "local" else None
        h = L.rms_norm(x, p.ln1, cfg)
        out, new_cache = L.attention(
            cfg, p.attn, h,
            angles=angles, mask=mask,
            cache=cache if mode == "decode" else None, decode_pos=decode_pos, window=window,
        )
        if mode == "prefill":
            new_cache = _fill_cache(cfg, cache, p, h, angles, window)
        if cfg.post_norms:
            out = L.rms_norm(out, p.pn1, cfg)
        x = x + out
        h2 = L.rms_norm(x, p.ln2, cfg)
        aux = None
        if p.moe is not None:
            from repro_torch.models.moe import moe_layer, moe_layer_manual

            mesh = S.current_mesh()
            if cfg.moe_impl == "manual" and mesh is not None:
                ff, aux = moe_layer_manual(cfg, p.moe, h2, mesh)
            else:
                ff, aux = moe_layer(cfg, p.moe, h2)
        else:
            ff = L.mlp(cfg, p.mlp, h2)
        if cfg.post_norms:
            ff = L.rms_norm(ff, p.pn2, cfg)
        return x + ff, new_cache, aux
    # decode continues the carried state; train/prefill start fresh (the
    # returned cache is the final state, which prefill keeps)
    state = cache if mode == "decode" else None
    if kind == "rwkv":
        from repro_torch.models.rwkv6 import rwkv_block

        x, new_cache = rwkv_block(cfg, p.rwkv, p.ln1, p.ln2, x, state)
    elif kind == "rec":
        from repro_torch.models.rglru import rglru_mix

        h = L.rms_norm(x, p.ln1, cfg)
        out, new_cache = rglru_mix(cfg, p.rec, h, state)
        x = x + out
        x = x + L.mlp(cfg, p.mlp, L.rms_norm(x, p.ln2, cfg))
    else:
        raise ValueError(kind)
    return x, new_cache, None


def _fill_cache(cfg, cache: L.LayerCache, p: Block, h_normed, angles, window) -> L.LayerCache:
    """Prefill: recompute k/v for the full sequence and lay them into the
    (possibly ring) cache with absolute positions."""
    k, v = L.kv_proj(p.attn, h_normed)
    if angles is not None:
        k = L.apply_rope(k, angles)
    return L.fill_layer_cache(cache, k, v, cfg=cfg, window=window)


# ------------------------------------------------------------------ forward

def _embed_inputs(cfg, params: Transformer, tokens, extra_embeds):
    parts = []
    if extra_embeds is not None:
        parts.append(extra_embeds.to(params.embed.dtype))
    if tokens is not None:
        parts.append(L.embed_lookup(params.embed, tokens, S.split_of(params, "embed")))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if cfg.embed_scale:
        # the scale is rounded to the activation dtype before the product
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=torch.float32, device=x.device).to(x.dtype)
    return x


def apply_head(cfg: ModelConfig, params: Transformer, hidden: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden (B, C, d) -> logits (B, C, V_pad), float32,
    softcapped, pad-masked (this rank's vocab columns under a split)."""
    if cfg.tie_embeddings:
        return L.head_logits(cfg, hidden, params.embed.T, S.split_of(params, "embed"))
    return L.head_logits(cfg, hidden, params.lm_head, S.split_of(params, "lm_head"))


def _logits(cfg, params: Transformer, x):
    return apply_head(cfg, params, L.rms_norm(x, params.final_norm, cfg))


def _train_masks(cfg: ModelConfig, s: int, device) -> dict:
    """Dense additive masks; none when chunked attention builds its masks
    per KV slab."""
    if cfg.attn_chunk:
        return {}
    return {
        "attn": L.causal_mask(s, device=device),
        "local": L.local_causal_mask(s, cfg.local_window, device=device),
    }


def _run_stacks(cfg, params: Transformer, x, *, angles, masks, caches, decode_pos, mode,
                remat_policy=None):
    """Every layer in order, one repeat of the block pattern at a time, then
    the tail.  Returns (x, new_caches, aux).

    With ``remat_policy`` (train only) each repeat runs under
    ``torch.utils.checkpoint`` with that policy as its ``context_fn``, as the
    reference checkpoints its scan body: the tail never is.  Under a mesh
    each group gathers its layers' weights inside the checkpointed function
    (``sharding_ctx.gathered``), so a recompute gathers them again."""
    reps, _ = stack_geometry(cfg)
    k = len(cfg.block_pattern)

    def run(x, first: int, n: int):
        """Layers ``first .. first + n - 1`` -> (x, their aux sum, caches)."""
        aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        cs = []
        with S.gathered(*params.layers[first:first + n]):
            for i in range(first, first + n):
                p = params.layers[i]
                x, new_c, aux = _block(
                    cfg, p, x,
                    angles=angles, mask=masks.get(p.kind) if masks else None,
                    cache=caches[i] if caches is not None else None, decode_pos=decode_pos,
                    mode=mode,
                )
                cs.append(new_c)
                if aux is not None:
                    aux_acc = aux_acc + aux
        return x, aux_acc, cs

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for r in range(reps):
        if remat_policy is None:
            x, aux, cs = run(x, r * k, k)
        else:
            x, aux = checkpoint(lambda x_, first=r * k: run(x_, first, k)[:2], x,
                                use_reentrant=False, context_fn=remat_policy,
                                preserve_rng_state=False)
            cs = [None] * k
        new_caches.extend(cs)
        aux_total = aux_total + aux
    for i in range(reps * k, len(params.layers)):
        x, aux, cs = run(x, i, 1)
        new_caches.extend(cs)
        aux_total = aux_total + aux
    return x, new_caches, aux_total


def forward_train(cfg: ModelConfig, params: Transformer, tokens, positions, *,
                  extra_embeds=None, remat_policy=None, return_hidden: bool = False):
    """Full-sequence forward -> (logits (B,S,V), moe_aux); with
    ``return_hidden`` the final-normed hidden states come back instead of
    logits.  ``remat_policy``: a policy of ``layers`` (``nothing_saveable``,
    ``dots_with_no_batch_dims_saveable``) or None.  Under a mesh the
    embedding, final norm and head are gathered for the whole call."""
    with S.gathered(params, recurse=False):
        x = _embed_inputs(cfg, params, tokens, extra_embeds)
        angles = L.rope_angles(cfg, positions) if cfg.rope_theta else None
        masks = _train_masks(cfg, x.shape[1], x.device)
        x, _, aux = _run_stacks(cfg, params, x, angles=angles, masks=masks, caches=None,
                                decode_pos=None, mode="train", remat_policy=remat_policy)
        if return_hidden:
            return L.rms_norm(x, params.final_norm, cfg), aux
        return _logits(cfg, params, x), aux


def prefill(cfg: ModelConfig, params: Transformer, tokens, positions, *,
            cache_capacity: int | None = None, extra_embeds=None):
    """Serve step 1: full forward building caches.  Returns (last-token
    logits (B,V), caches).  Under a mesh the embedding, final norm and head
    are gathered for the whole call."""
    with S.gathered(params, recurse=False):
        x = _embed_inputs(cfg, params, tokens, extra_embeds)
        b, s = x.shape[0], x.shape[1]
        caches = init_cache(cfg, b, cache_capacity or s, x.dtype, x.device)
        angles = L.rope_angles(cfg, positions) if cfg.rope_theta else None
        masks = _train_masks(cfg, s, x.device)
        x, caches, _ = _run_stacks(cfg, params, x, angles=angles, masks=masks, caches=caches,
                                   decode_pos=None, mode="prefill")
        logits = _logits(cfg, params, x[:, -1:])
    return logits[:, 0], caches


def decode(cfg: ModelConfig, params: Transformer, token: torch.Tensor, pos: torch.Tensor,
           caches: list):
    """Serve step N: one token (B,) at absolute positions ``pos`` (B,)
    through the caches -> (logits (B,V), caches).  Attention caches are
    written in place; recurrent states come back as new tensors."""
    with S.gathered(params, recurse=False):
        x = _embed_inputs(cfg, params, token[:, None], None)
        angles = L.rope_angles(cfg, pos[:, None]) if cfg.rope_theta else None
        x, caches, _ = _run_stacks(cfg, params, x, angles=angles, masks=None, caches=caches,
                                   decode_pos=pos, mode="decode")
        logits = _logits(cfg, params, x)
    return logits[:, 0], caches
