"""Synthetic token pipeline for the LM wing's examples and tests.

A copy of ``repro.train.data`` (numpy only): the same seed gives the same
arrays, bit for bit.

Zipf-distributed token ids with a deterministic per-step seed so data is
reproducible across restarts (the checkpoint records only the step number).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["TokenStream", "make_batch"]


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, *, seed: int = 0) -> dict:
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    b, s = shape.global_batch, shape.seq_len
    zipf = rng.zipf(1.3, size=(b, s + 1))
    tokens = np.minimum(zipf, cfg.vocab - 1).astype(np.int32)
    batch = {
        "tokens": tokens[:, :s],
        "labels": tokens[:, 1:],
        "positions": np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy(),
    }
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 0.02, (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        batch.pop("positions")
    if cfg.family == "vlm":
        patches = min(cfg.vision_stub_patches, max(s // 2, 1))
        batch["vision_embeds"] = rng.normal(0, 0.02, (b, patches, cfg.d_model)).astype(np.float32)
        batch["tokens"] = batch["tokens"][:, : s - patches]
        batch["labels"] = batch["labels"][:, : s - patches]
        batch["positions"] = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
    return batch


class TokenStream:
    """Stateless iterable over steps (resume = start at step N)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0, start_step: int = 0):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = make_batch(self.cfg, self.shape, self.step, seed=self.seed)
        self.step += 1
        return batch
