"""Serving steps of the LM wing: prefill (build caches) and decode (one
token), the counterparts of ``repro.train.serve_step`` with ``mesh=None``.

Both steps run under ``torch.inference_mode()`` on the device the
parameters live on; numpy inputs are moved there.  The serve steps' mesh
arms (tensor-parallel compute on "model", caches sharded on kv_heads or
kv_seq) are not ported yet, so ``mesh=`` other than None raises
``NotImplementedError`` (ROADMAP.md, Open items §1, "LM mesh").  Training
on a mesh is ported (``train_step.build_train_step(mesh=)``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api as M
from repro_torch.models.sharding_ctx import refuse_mesh

__all__ = ["build_prefill_step", "build_decode_step"]


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None) -> Callable:
    """``step(params, batch) -> (last-token logits (B, V_pad) float32,
    caches)``; the caches hold ``shape.seq_len`` positions (local layers a
    ring of ``min(seq_len, local_window)``)."""
    refuse_mesh(mesh)

    def step(params, batch: dict):
        dev = params.embed.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.inference_mode():
            return M.serve_prefill(cfg, params, batch, cache_capacity=shape.seq_len)

    return step


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None) -> Callable:
    """``step(params, token (B,), pos (B,), caches) -> (logits (B, V_pad)
    float32, caches)``.

    The step writes the attention caches it is given in place (the
    counterpart of the reference's ``donate_argnums=(3,)``): the caches
    passed in are consumed, and only the returned ones may be used again.
    """
    refuse_mesh(mesh)

    def step(params, token, pos, caches):
        dev = params.embed.device
        with torch.inference_mode():
            return M.serve_decode(cfg, params, torch.as_tensor(token, device=dev),
                                  torch.as_tensor(pos, device=dev), caches)

    return step
