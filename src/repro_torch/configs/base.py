"""Config dataclasses for the architecture zoo and the GWAS workload.

A field-for-field copy of ``repro.configs.base`` (which imports no JAX), so
the port and the reference read the same configurations.  Every assigned
architecture is a frozen ``ModelConfig``; shapes are the four assigned input
geometries.  ``reduced()`` produces the family-preserving small config the
tests instantiate on the CPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    dense_d_ff: int = 0            # arctic: parallel dense-FFN residual width
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    activation: str = "silu"       # silu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl (t, h, w) rotary split
    block_pattern: tuple[str, ...] = ("attn",)      # layer kinds, cycled
    local_window: int = 4096
    attn_softcap: float | None = None
    final_softcap: float | None = None
    post_norms: bool = False       # gemma2: norm after attn/mlp too
    embed_scale: bool = False      # gemma family: embeddings * sqrt(d_model)
    norm_plus_one: bool = False    # gemma family RMSNorm (1 + w) convention
    moe: MoEConfig | None = None
    # ssm / hybrid
    rwkv_head_dim: int = 64
    lru_width: int = 0             # recurrentgemma RG-LRU state width
    conv_width: int = 4
    # enc-dec
    encoder_layers: int = 0
    encoder_len: int = 1500        # whisper frame positions after conv stub
    # vlm
    vision_stub_patches: int = 0   # patches supplied by the frontend stub
    dtype: str = "bfloat16"
    # scan_layers: the reference's lax.scan over layer repeats (off: unrolled
    # for its dry-run).  The port always runs its layers in order, so the
    # field has no effect there; logits are identical either way (tested).
    scan_layers: bool = True
    kv_cache_dtype: str = "bfloat16"   # "int8": quantized KV cache (serve)
    # >0: flash-style online-softmax attention over KV chunks of this size —
    # the (S, T) logits tensor is never materialized (prefill_32k would
    # otherwise hold S^2 = 4 GB f32 score tiles per head group).
    attn_chunk: int = 0
    moe_impl: str = "gspmd"            # "manual": shard_map all-to-all dispatch

    # ------------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables padded to a 256 multiple so the vocab dim
        shards cleanly on any mesh axis (49155 % 16 != 0 would otherwise
        force the model's largest GEMM to replicate — measured 5x waste,
        EXPERIMENTS.md §Perf).  Logits beyond ``vocab`` are masked to -inf."""
        return -(-self.vocab // 256) * 256

    @property
    def attention_free(self) -> bool:
        return all(k in ("rwkv", "rec") for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when no layer kind attends over unbounded context."""
        return all(k in ("rwkv", "rec", "local") for k in self.block_pattern)

    def reduced(self) -> "ModelConfig":
        """Family-preserving smoke-test size: every structural feature kept,
        every dimension shrunk."""
        changes: dict = dict(
            n_layers=max(len(self.block_pattern), 2 if self.n_layers > 1 else 1),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=512,
            local_window=16,
        )
        if self.family == "hybrid":
            changes["n_layers"] = len(self.block_pattern) + 2  # pattern + tail coverage
        if self.moe is not None:
            changes["moe"] = MoEConfig(
                n_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                dense_d_ff=64 if self.moe.dense_d_ff else 0,
                capacity_factor=self.moe.capacity_factor,
            )
        if self.lru_width:
            changes["lru_width"] = 64
        if self.encoder_layers:
            changes["encoder_layers"] = 2
            changes["encoder_len"] = 32
        if self.mrope_sections is not None:
            changes["mrope_sections"] = (4, 2, 2)  # sums to head_dim//2 = 8
        if self.vision_stub_patches:
            changes["vision_stub_patches"] = 8
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name, seq_len=32, global_batch=2, kind=self.kind)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def supported_shapes(cfg: ModelConfig) -> dict[str, ShapeConfig | None]:
    """The assigned 4-cell row for an arch; None marks an assigned skip
    (recorded, never silently dropped).  Rules from the assignment:
    ``long_500k`` needs sub-quadratic attention; encoder-only archs would
    skip decode (none of ours are encoder-only)."""
    out: dict[str, ShapeConfig | None] = {}
    for name, shape in SHAPES.items():
        if name == "long_500k" and not cfg.sub_quadratic:
            out[name] = None
            continue
        out[name] = shape
    return out


@dataclass(frozen=True)
class GwasWorkloadConfig:
    """The paper's own benchmark workload (§3.1) as a dry-runnable config."""

    arch: str = "gwas_ukb"
    n_markers: int = 8_900_000
    n_samples: int = 23_000
    n_traits: int = 20_480
    n_covariates: int = 12
    batch_markers: int = 8_192
    engine: str = "fused"
    mode: str = "mp"
    block_m: int = 256
    block_n: int = 512
    block_p: int = 256

    def reduced(self) -> "GwasWorkloadConfig":
        return dataclasses.replace(
            self,
            n_markers=2_048,
            n_samples=512,
            n_traits=64,
            batch_markers=512,
            block_m=64,
            block_n=128,
            block_p=64,
        )
