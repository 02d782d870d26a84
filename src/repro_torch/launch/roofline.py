"""The analytic half of ``repro.launch.roofline``: parameter counts, model
FLOPs, the HBM-traffic floor and the recurrences' FLOPs, as pure arithmetic
on the configs (copied as they are), with the H100's peaks in place of the
TPU's.

The HLO half (``parse_collectives``, ``roofline_from_compiled``) reads XLA's
compiled text and is not ported (ROADMAP.md, Open items §1, "LM launch
tools").  Note that ``param_count`` counts only the matrices (attention,
MLP, experts, embeddings), as the reference's does: a model's norm vectors
and biases are not in it.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import GwasWorkloadConfig, ModelConfig, ShapeConfig

__all__ = [
    "HW",
    "model_flops",
    "param_count",
    "gwas_flops",
    "memory_floor_bytes",
    "recurrence_flops",
]


@dataclass(frozen=True)
class HW:
    """Published peaks of one NVIDIA H100 SXM (data sheet, dense): bf16 and
    TF32 on the tensor cores, fp32 outside them, HBM3 bandwidth."""

    peak_flops: float = 989e12        # bf16 per card
    peak_flops_tf32: float = 495e12
    peak_flops_f32: float = 67e12
    hbm_bw: float = 3.35e12           # bytes/s per card


# ------------------------------------------------------- analytic model FLOPs

def param_count(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts from the config (no allocation)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    mlp = (3 if cfg.activation in ("silu", "geglu") else 2) * d * cfg.d_ff
    embed = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)

    if cfg.family == "encdec":
        enc = cfg.encoder_layers * (attn + mlp)
        dec = cfg.n_layers * (2 * attn + mlp)   # self + cross attention
        total = enc + dec + embed
        return total, total

    total = active = 0
    for kind in _kinds(cfg):
        if kind in ("attn", "local"):
            if cfg.moe is not None:
                e = cfg.moe
                moe_p = e.n_experts * 3 * d * e.d_ff_expert + d * e.n_experts
                moe_a = e.top_k * 3 * d * e.d_ff_expert + d * e.n_experts
                dense = 3 * d * e.dense_d_ff if e.dense_d_ff else 0
                total += attn + moe_p + dense
                active += attn + moe_a + dense
            else:
                total += attn + mlp
                active += attn + mlp
        elif kind == "rwkv":
            layer = 5 * d * d + (2 * d * cfg.d_ff + d * d)  # time-mix + channel-mix
            total += layer
            active += layer
        elif kind == "rec":
            w = cfg.lru_width
            layer = (2 * d * w + 2 * w * w + w * d) + mlp
            total += layer
            active += layer
    return total + embed, active + embed


def _kinds(cfg: ModelConfig) -> list[str]:
    k = len(cfg.block_pattern)
    reps, tail = cfg.n_layers // k, cfg.n_layers % k
    return list(cfg.block_pattern) * reps + list(cfg.block_pattern[:tail])


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful FLOPs: 6 N_active D for train, 2 N_active per served token,
    plus the quadratic attention term where applicable, plus the intrinsic
    recurrence state work for SSM/hybrid families (the WKV outer-product
    updates are the architecture's compute, not overhead)."""
    _, active = param_count(cfg)
    b, s = shape.global_batch, shape.seq_len
    attn_flops = 0.0
    for kind in _kinds(cfg):
        if kind == "attn":
            attn_flops += 2 * 2 * b * cfg.n_heads * cfg.resolved_head_dim * s * s / 2
        elif kind == "local":
            w = min(cfg.local_window, s)
            attn_flops += 2 * 2 * b * cfg.n_heads * cfg.resolved_head_dim * s * w
    rec = recurrence_flops(cfg, shape)
    if shape.kind == "train":
        return 6.0 * active * b * s + 3.0 * attn_flops + rec
    if shape.kind == "prefill":
        return 2.0 * active * b * s + attn_flops + rec
    # decode: one token against a seq_len-deep cache
    per_tok_attn = 0.0
    for kind in _kinds(cfg):
        if kind == "attn":
            per_tok_attn += 2 * 2 * cfg.n_heads * cfg.resolved_head_dim * s
        elif kind == "local":
            per_tok_attn += 2 * 2 * cfg.n_heads * cfg.resolved_head_dim * min(cfg.local_window, s)
    return 2.0 * active * b + per_tok_attn * b + rec


def gwas_flops(g: GwasWorkloadConfig, *, batch_only: bool = True) -> float:
    """Useful FLOPs of one marker-batch step: 2 M N P (Eq. 2's GEMM)."""
    m = g.batch_markers if batch_only else g.n_markers
    return 2.0 * m * g.n_samples * g.n_traits


def memory_floor_bytes(
    cfg: ModelConfig, shape: ShapeConfig, n_devices: int, *,
    state_dtype_bytes: int = 4, kv_bytes: int = 2,
) -> float:
    """Analytic per-device HBM-traffic floor for one step.

    The CPU backend's ``bytes accessed`` is an upper bound (its fusion is far
    weaker than TPU's), so the roofline memory term is bracketed:
    ``floor <= true <= hlo``.  The floor counts only unavoidable traffic:

      train:   params read fwd+bwd + grads written/read + opt state r/w
               + ~6 activation-sized transfers per layer (bf16)
      prefill: params once + ~4 activation transfers per layer + KV write
      decode:  params once + full KV/state read + cache write
    """
    total, _ = param_count(cfg)
    p_bytes = 2 * total / n_devices               # bf16 params, fully sharded
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    dp = max(n_devices / 16, 1)                   # data-parallel ways
    act_unit = (b / dp) * s * d * 2               # one bf16 activation pass
    if shape.kind == "train":
        # params fwd + bwd + grads w/r + opt m,v r/w (state dtype)
        params_io = 3 * p_bytes + 2 * (4 * total / n_devices) + 4 * (
            state_dtype_bytes * total / n_devices
        )
        act_io = 6.0 * act_unit * cfg.n_layers
        return params_io + act_io
    if shape.kind == "prefill":
        return p_bytes + 4.0 * act_unit * cfg.n_layers
    # decode: params once + full cache/state read (+ small write).
    kv_bytes_total = 0.0
    for kind in _kinds(cfg):
        if kind == "attn":
            kv_bytes_total += 2 * b * s * cfg.n_kv_heads * cfg.resolved_head_dim * kv_bytes
        elif kind == "local":
            kv_bytes_total += 2 * b * min(cfg.local_window, s) * cfg.n_kv_heads * cfg.resolved_head_dim * kv_bytes
        elif kind == "rwkv":
            h = cfg.d_model // cfg.rwkv_head_dim
            kv_bytes_total += b * h * cfg.rwkv_head_dim**2 * 4
        elif kind == "rec":
            kv_bytes_total += b * cfg.lru_width * 4
    return p_bytes + kv_bytes_total / n_devices


def recurrence_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic FLOPs of the *time-scan* inner loops (WKV / RG-LRU), which
    XLA's cost analysis counts only once per while body.  Added to HLO FLOPs
    as ``corrected`` in the dry-run records (the multiplier is the scan trip
    count minus the one counted body)."""
    b = shape.global_batch
    steps = 1 if shape.kind == "decode" else shape.seq_len
    fwd_mult = 3.0 if shape.kind == "train" else 1.0
    per_step = 0.0
    for kind in _kinds(cfg):
        if kind == "rwkv":
            h = cfg.d_model // cfg.rwkv_head_dim
            per_step += 7.0 * b * h * cfg.rwkv_head_dim**2
        elif kind == "rec":
            per_step += 3.0 * b * cfg.lru_width
    return per_step * max(steps - 1, 0) * fwd_mult
