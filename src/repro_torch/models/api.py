"""Family dispatch + input specs of the LM wing, the counterpart of
``repro.models.api``: the one surface the serve steps, the tests and
``chip_smoke.py`` build against.

Models live on ``cuda`` unless the caller asks for another device; with no
card that is an error (``runtime.device.resolve_device``), never a quiet
move to the CPU.  ``input_specs`` gives ``(shape, torch.dtype)`` for every
input of an (arch x shape) cell, the vlm/audio stub embeddings included.
Under a serve scope that splits "model" (``train.serve_step``'s mesh arms)
``serve_prefill``, ``serve_decode`` and ``abstract_caches`` take and give
this rank's blocks.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime.device import resolve_device

__all__ = [
    "init_model",
    "abstract_params",
    "train_logits",
    "train_hidden",
    "apply_head",
    "serve_prefill",
    "serve_decode",
    "input_specs",
    "abstract_caches",
]


def init_model(cfg: ModelConfig, *, generator: torch.Generator | None, device="cuda",
               max_positions: int = 4096):
    """The model's modules on ``device``, weights drawn from ``generator``
    (a ``torch.Generator`` on that device) with the reference's scales.
    ``max_positions`` sizes whisper's learned decoder positions."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if cfg.family == "encdec":
        return E.init_encdec_params(cfg, generator=generator, device=dev,
                                    max_positions=max_positions)
    return T.init_params(cfg, generator=generator, device=dev)


def abstract_params(cfg: ModelConfig, *, max_positions: int = 4096):
    """The model's modules on the ``meta`` device: shapes and dtypes, no
    storage."""
    return init_model(cfg, generator=None, device="meta", max_positions=max_positions)


def train_logits(cfg: ModelConfig, params, batch: dict, *, remat_policy=None):
    """-> (logits (B, S, V), moe_aux).  ``remat_policy`` checkpoints each
    repeat of the block pattern (the encoder-decoder takes none, as in the
    reference)."""
    if cfg.family == "encdec":
        logits = E.forward_train(cfg, params, batch["frames"], batch["tokens"])
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
    return T.forward_train(cfg, params, batch.get("tokens"), batch["positions"],
                           extra_embeds=batch.get("vision_embeds"), remat_policy=remat_policy)


def train_hidden(cfg: ModelConfig, params, batch: dict, *, remat_policy=None):
    """-> (final-normed hidden (B, S, d), moe_aux) for the chunked loss."""
    if cfg.family == "encdec":
        h = E.forward_train(cfg, params, batch["frames"], batch["tokens"], return_hidden=True)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    return T.forward_train(cfg, params, batch.get("tokens"), batch["positions"],
                           extra_embeds=batch.get("vision_embeds"), remat_policy=remat_policy,
                           return_hidden=True)


def apply_head(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    """hidden (B, C, d) -> masked float32 logits (B, C, V_pad)."""
    if cfg.family == "encdec":
        return E.apply_head(cfg, params, hidden)
    return T.apply_head(cfg, params, hidden)


def serve_prefill(cfg: ModelConfig, params, batch: dict, *, cache_capacity: int):
    if cfg.family == "encdec":
        return E.prefill(cfg, params, batch["frames"], batch["tokens"],
                         cache_capacity=cache_capacity)
    return T.prefill(cfg, params, batch.get("tokens"), batch["positions"],
                     cache_capacity=cache_capacity, extra_embeds=batch.get("vision_embeds"))


def serve_decode(cfg: ModelConfig, params, token, pos, caches):
    if cfg.family == "encdec":
        return E.decode(cfg, params, token, pos, caches)
    return T.decode(cfg, params, token, pos, caches)


# ------------------------------------------------------------------- specs

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Model inputs of one cell as ``(shape, dtype)``.  decode cells
    describe the new-token inputs; the cache layout comes from
    ``abstract_caches``."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    emb = L.model_dtype(cfg)
    if shape.kind == "decode":
        return {"token": ((b,), i32), "pos": ((b,), i32)}
    specs: dict[str, tuple[tuple[int, ...], torch.dtype]] = {}
    if cfg.family == "encdec":
        specs["frames"] = ((b, cfg.encoder_len, cfg.d_model), emb)
        specs["tokens"] = ((b, s), i32)
    elif cfg.family == "vlm":
        patches = min(cfg.vision_stub_patches, max(s // 2, 1))
        specs["vision_embeds"] = ((b, patches, cfg.d_model), emb)
        specs["tokens"] = ((b, s - patches), i32)
        specs["positions"] = ((3, b, s), i32)
    else:
        specs["tokens"] = ((b, s), i32)
        specs["positions"] = ((b, s), i32)
    if shape.kind == "train":
        specs["labels"] = ((b, specs["tokens"][0][1]), i32)
    return specs


def abstract_caches(cfg: ModelConfig, shape: ShapeConfig) -> list:
    """The caches of a decode cell (capacity = ``shape.seq_len``) on the
    ``meta`` device: one entry per layer, as prefill builds them (this
    rank's blocks under a serve scope that splits "model")."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if cfg.family == "encdec":
        return E.init_cache(cfg, b, s, L.model_dtype(cfg), meta)
    return T.init_cache(cfg, b, s, L.model_dtype(cfg), meta)
