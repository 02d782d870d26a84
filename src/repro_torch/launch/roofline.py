"""Roofline terms of one rank's step, the counterpart of
``repro.launch.roofline``, in two halves.

The analytic half (parameter counts, model FLOPs, the HBM-traffic floor,
the recurrences' FLOPs) is pure arithmetic on the configs, copied as it is.
Note that ``param_count`` counts only the matrices (attention, MLP,
experts, embeddings), as the reference's does: a model's norm vectors and
biases are not in it.

The trace half takes the place of the reference's reading of XLA's compiled
artifacts (``parse_collectives``, ``roofline_from_compiled``).  The port
runs eagerly and compiles nothing, so ``trace_step`` runs one rank's step
(under ``FakeTensorMode`` for a dry run: the same ops, no storage) and
records what the reference read from the HLO:

    flops       ``torch.utils.flop_counter.FlopCounterMode``'s total (the
                kernels' custom ops count by their registered formulas)
    bytes       each dispatched op's input and output bytes, views aside:
                an unfused upper bound, as the reference's CPU
                ``bytes accessed`` is
    collectives every ``Collective`` the step issues
                (``runtime.sharding.record_collectives``)
    memory      argument (the device bytes of the step's inputs), output,
                alias (outputs that are inputs: state updated in place),
                peak (the most live device bytes) and
                temp = peak - argument - output + alias

Three terms per step, in seconds:

    compute    = flops / peak FLOP/s of a card
    memory     = bytes / HBM bandwidth
    collective = sum over collectives of wire_bytes / link bandwidth

Collective wire bytes use the reference's ring formulas on the group size
k, applied to the buffer its docstring names:

    all-reduce        2 (k-1)/k * bytes
    all-gather        (k-1)/k   * bytes   (bytes = full output buffer)
    reduce-scatter    (k-1)/k   * bytes   (bytes = full input buffer)
    all-to-all        (k-1)/k   * bytes
    collective-permute            bytes

(The reference parses a reduce-scatter's HLO result, which is the block;
here its ``out_bytes`` is the full input, as the formula reads it.)

Hardware model (``HW``): the H100 SXM's data sheet.  The TPU's ICI and DCN
links become NVLink and InfiniBand: a group whose ranks all sit in one node
of 8 consecutive ranks (a DGX H100) moves its bytes over NVLink at 450 GB/s
a direction; any other group over one 400 Gb/s NDR port a card, 50 GB/s.
"""
from __future__ import annotations

import collections
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.configs.base import GwasWorkloadConfig, ModelConfig, ShapeConfig

__all__ = [
    "HW",
    "Collective",
    "ring_wire_bytes",
    "StepTrace",
    "trace_step",
    "roofline_from_trace",
    "model_flops",
    "param_count",
    "gwas_flops",
    "memory_floor_bytes",
    "recurrence_flops",
]


@dataclass(frozen=True)
class HW:
    """Published figures of one NVIDIA H100 SXM (data sheet, dense): bf16
    and TF32 on the tensor cores, fp32 outside them, HBM3 bandwidth and
    size; NVLink 4 (450 GB/s each way to the other cards of a node of 8)
    and one 400 Gb/s InfiniBand NDR port a card between nodes."""

    peak_flops: float = 989e12        # bf16 per card
    peak_flops_tf32: float = 495e12
    peak_flops_f32: float = 67e12
    hbm_bw: float = 3.35e12           # bytes/s per card
    hbm_bytes: float = 80e9
    nvlink_bw: float = 450e9          # bytes/s per direction, inside a node
    ib_bw: float = 50e9               # bytes/s per card, between nodes
    node_cards: int = 8

    def link_bw(self, ranks) -> float:
        """NVLink when every rank of the group sits in one node of
        ``node_cards`` consecutive ranks, InfiniBand otherwise."""
        nodes = {int(r) // self.node_cards for r in ranks}
        return self.nvlink_bw if len(nodes) <= 1 else self.ib_bw


# ------------------------------------------------------------ collectives

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

# torch's dtypes by their HLO names
_HLO_NAMES = {
    "float64": "f64", "float32": "f32", "float16": "f16", "bfloat16": "bf16",
    "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2", "int64": "s64", "uint64": "u64",
    "int32": "s32", "uint32": "u32", "int16": "s16", "uint16": "u16", "int8": "s8",
    "uint8": "u8", "bool": "pred", "complex64": "c64", "complex128": "c128",
}

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def hlo_dtype(dtype) -> str:
    """A torch dtype's HLO name (``torch.bfloat16`` -> ``"bf16"``)."""
    return _HLO_NAMES[str(dtype).removeprefix("torch.")]


def ring_wire_bytes(kind: str, nbytes: float, k: int) -> float:
    """Bytes a rank puts on the wire for one collective of ``nbytes`` over
    a group of ``k`` ranks (the module docstring's ring formulas)."""
    if kind == "all-reduce":
        return 2.0 * nbytes * (k - 1) / max(k, 1)
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * (k - 1) / max(k, 1)
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}; expected one of {KINDS}")


@dataclass(frozen=True)
class Collective:
    """One collective a rank issued: its kind (the reference's names), the
    bytes of the buffer the ring formula reads (``out_bytes``; a
    reduce-scatter's full input), the group's size and its global ranks,
    and the rank's wire bytes."""

    kind: str
    out_bytes: int
    group_size: int
    wire_bytes: float = 0.0
    ranks: tuple[int, ...] = ()

    @classmethod
    def of(cls, kind: str, numel: int, dtype, ranks) -> "Collective":
        """The record of a collective over ``ranks`` whose buffer holds
        ``numel`` elements of ``dtype`` (a torch dtype)."""
        ranks = tuple(int(r) for r in ranks)
        nbytes = int(numel) * _DTYPE_BYTES[hlo_dtype(dtype)]
        return cls(kind, nbytes, len(ranks), ring_wire_bytes(kind, nbytes, len(ranks)), ranks)


# ------------------------------------------------------------- the trace


@dataclass
class StepTrace:
    """What ``trace_step`` saw of one rank's step (module docstring)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: list = field(default_factory=list)
    memory: dict = field(default_factory=dict)
    kernel_calls: dict = field(default_factory=dict)   # repro_torch custom ops by name
    seconds: float = 0.0


def _tensors(obj):
    """Every tensor in ``obj``: tensors, modules (parameters and buffers),
    dicts, lists, tuples and named tuples; anything else holds none."""
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _alloc_bytes(nbytes: int) -> int:
    """Bytes the card's allocator takes for ``nbytes``: the CUDA caching
    allocator hands out multiples of 512 bytes (a trace on the CPU predicts
    the card too)."""
    return -(-nbytes // 512) * 512


def _op_temporary(func, args) -> int:
    """Bytes an op's card kernel holds besides its outputs while it runs, for
    the ops where that is large: PyTorch's CUDA softmax backward takes a
    temporary the size of its gradient, contiguous or not, and the forward
    none (the card's ``max_memory_allocated`` around each op of a train
    step, torch 2.11 on an H100; without it a train step's peak reads ~12%
    low)."""
    import torch

    if func is torch.ops.aten._softmax_backward_data.default:
        grad = args[0]
        return _alloc_bytes(grad.numel() * grad.element_size())
    return 0


def _storages(tensors, device_type: str) -> dict:
    """id -> (storage, allocated bytes) of the distinct storages of
    ``tensors`` that lie on ``device_type``."""
    out = {}
    for t in tensors:
        if t.device.type != device_type:
            continue
        st = t.untyped_storage()
        out.setdefault(id(st), (st, _alloc_bytes(st.nbytes())))
    return out


def _live_mode(device_type: str, known: dict, trace: StepTrace):
    """A dispatch mode that tallies every op's bytes, counts the kernels'
    custom ops, and follows the device storages the ops create: each adds
    its bytes to the live count when first seen and takes them off when the
    storage is freed (a weak reference's callback).  The peak also counts
    the temporaries the card's kernels hold inside an op
    (``_op_temporary``)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class LiveBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = 0
            self.peak = 0
            self.seen = {k: weakref.ref(st) for k, (st, _) in known.items()}
            self.kernel_calls = collections.Counter()

        def _free(self, key, nbytes):
            self.live -= nbytes
            self.seen.pop(key, None)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "repro_torch":
                self.kernel_calls[func._opname] += 1
            outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
            if not func.is_view:
                ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
                trace.bytes_accessed += sum(t.numel() * t.element_size() for t in ins + outs)
            for t in outs:
                if t.device.type != device_type:
                    continue
                st = t.untyped_storage()
                key = id(st)
                ref = self.seen.get(key)
                if ref is not None and ref() is st:
                    continue
                nbytes = _alloc_bytes(st.nbytes())
                self.seen[key] = weakref.ref(st, lambda _, k=key, n=nbytes: self._free(k, n))
                self.live += nbytes
            self.peak = max(self.peak, self.live + _op_temporary(func, args))
            return out

    return LiveBytes()


def trace_step(step: Callable, *args, device) -> tuple[Any, StepTrace]:
    """Run ``step(*args)`` once and return (its outputs, its ``StepTrace``).

    ``device`` is the rank's device (its type decides which storages are
    device memory).  Under ``FakeTensorMode`` nothing runs and nothing is
    stored; with real tensors the step runs as it would.  The arguments'
    device bytes are the ``argument`` bytes; ``peak`` adds the most bytes
    the step's own storages held at once."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.runtime import sharding as sh

    kind = torch.device(device).type
    args_st = _storages(_tensors(args), kind)
    trace = StepTrace()
    mode = _live_mode(kind, args_st, trace)
    t0 = time.perf_counter()
    with sh.record_collectives() as colls, FlopCounterMode(display=False) as flop, mode:
        out = step(*args)
    trace.seconds = time.perf_counter() - t0
    trace.flops = float(flop.get_total_flops())
    trace.collectives = list(colls)
    trace.kernel_calls = dict(mode.kernel_calls)
    out_st = _storages(_tensors(out), kind)
    argument = sum(n for _, n in args_st.values())
    output = sum(n for _, n in out_st.values())
    alias = sum(n for k, (_, n) in out_st.items() if k in args_st)
    peak = argument + mode.peak
    trace.memory = {"argument_bytes": argument, "output_bytes": output,
                    "temp_bytes": peak - argument - output + alias, "alias_bytes": alias,
                    "peak_bytes": peak}
    return out, trace


def roofline_from_trace(trace: StepTrace, *, n_devices: int, hw: HW = HW()) -> dict:
    """All three terms + provenance from one rank's ``StepTrace``: the keys
    of the reference's ``roofline_from_compiled``.  ``n_devices`` is the
    world's size (the reference's argument; the trace is per rank)."""
    colls = trace.collectives
    coll_bytes = sum(c.wire_bytes for c in colls)
    by_kind: dict[str, float] = {}
    for c in colls:
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) + c.wire_bytes
    terms = {
        "compute_s": trace.flops / hw.peak_flops,
        "memory_s": trace.bytes_accessed / hw.hbm_bw,
        "collective_s": sum(c.wire_bytes / hw.link_bw(c.ranks) for c in colls),
    }
    dominant = max(terms, key=terms.get)
    return {
        "flops_per_device": trace.flops,
        "bytes_per_device": trace.bytes_accessed,
        "collective_wire_bytes": coll_bytes,
        "collectives_by_kind": by_kind,
        "n_collectives": len(colls),
        **terms,
        "dominant": dominant,
        "memory": dict(trace.memory) or None,
    }


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
