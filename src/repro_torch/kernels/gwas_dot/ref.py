"""Plain PyTorch version of the fused gwas_dot kernel.

The same mathematical contract as the CUDA kernel (decode -> standardize ->
missing->0 -> GEMM/N -> clip -> t) with no tiling: fp32 operands and
epilogue, and the sum over samples taken in float64 and rounded to fp32
once.  The wrapper in ``gwas_dot.py`` runs it for tensors that lie on the
CPU; the on-card check in ``chip_smoke.py`` holds the kernel against it.
"""
from __future__ import annotations

import torch

__all__ = ["unpack_tiled", "decode_standardize_ref", "gwas_dot_ref", "tf32_rna",
           "sample_order", "trait_operand_shape", "trait_operand_ref"]

# The kernel's trait operand (the prologue of csrc/gwas_dot.cu): traits are
# padded to whole 128-trait tiles, samples to a multiple of 64, and its
# columns follow the kernel's sample order (``sample_order``).
TRAIT_TILE = 128
SAMPLE_ALIGN = 64
STAGE_SAMPLES = {"bf16": 64, "fp32": 32}


def unpack_tiled(packed: torch.Tensor, block_n: int) -> torch.Tensor:
    """Tile-local packed bytes ``(M, N_pad/4) uint8`` -> codes ``(M, N_pad)``
    int32 (the inverse of ``ops.pack_tiled``): within each ``block_n``
    sample tile, byte ``b`` holds sample ``s * block_n/4 + b`` at slot ``s``."""
    if block_n % 4:
        raise ValueError("block_n must be a multiple of 4")
    m, width = packed.shape
    quarter = block_n // 4
    if width % quarter:
        raise ValueError(f"packed width {width} is not a multiple of block_n/4={quarter}")
    tiles = packed.to(torch.int32).reshape(m, width // quarter, 1, quarter)
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=packed.device)
    codes = (tiles >> shifts.reshape(1, 1, 4, 1)) & 3       # (M, T, slot, byte)
    return codes.reshape(m, width * 4)


def decode_standardize_ref(
    codes: torch.Tensor,      # (M, N) int PLINK 2-bit codes {0,1,2,3}
    mean: torch.Tensor,       # (M,)
    inv_std: torch.Tensor,    # (M,)
) -> torch.Tensor:
    """Code -> standardized dosage; missing (code 1) -> 0."""
    dosage = (2 - codes + (codes >> 1)).to(torch.float32)
    g = (dosage - mean.reshape(-1, 1)) * inv_std.reshape(-1, 1)
    return torch.where(codes == 1, torch.zeros((), dtype=g.dtype, device=g.device), g)


def gwas_dot_ref(
    codes: torch.Tensor,      # (M, N) int codes
    mean: torch.Tensor,
    inv_std: torch.Tensor,
    y: torch.Tensor,          # (N, P) f32
    *,
    n_samples: float,
    dof: float,
    eps: float = 1e-12,
    input_dtype: str = "fp32",
    trait_tile: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(r, t) for one batch.  ``input_dtype="bf16"`` rounds g and y to bf16
    first (the "bf16 inputs, fp32 accumulation" contract).  The sum over
    samples is the exactly rounded fp32 value: float64 products and sums
    (exact products, 2^-53 sums), rounded once.  A float32 chain over the
    paper's 23,000 samples is itself some 4e-6 off it at |r| = 0.8, which
    would hide any kernel's own error against the 2e-6 tolerance.
    ``trait_tile`` evaluates the product in fixed-width column chunks, so any
    decomposition of the trait axis into multiples of it computes identical
    columns."""
    g = decode_standardize_ref(codes, mean, inv_std)
    y = y.to(torch.float32)
    if input_dtype == "bf16":
        g = g.to(torch.bfloat16).to(torch.float32)
        y = y.to(torch.bfloat16).to(torch.float32)
    elif input_dtype != "fp32":
        raise ValueError(f"unknown input_dtype {input_dtype!r}")
    g = g.to(torch.float64)
    y = y.to(torch.float64)
    p = y.shape[1]
    if trait_tile is not None and 0 < trait_tile < p:
        acc = torch.cat(
            [g @ y[:, i : i + trait_tile] for i in range(0, p, trait_tile)], dim=1
        )
    else:
        acc = g @ y
    acc = acc.to(torch.float32)
    r = torch.clamp(acc / float(n_samples), -1.0, 1.0)
    t = r * torch.rsqrt(torch.clamp(1.0 - r * r, min=eps) / float(dof))
    return r, t


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32: round to 10 mantissa bits, to
    nearest with ties away from zero (add 0x1000 to the magnitude bits,
    clear the low 13)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    sign = bits & torch.iinfo(torch.int32).min
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (sign | mag).view(torch.float32)


def sample_order(n_pad: int, block_n: int, input_dtype: str) -> torch.Tensor:
    """The sample each column of the trait operand stands for (-1: none),
    the kernel's sample order.  The kernel walks each row's packed bytes in
    order, a stage of ``SK/4`` bytes at a time (SK = 64 samples bf16, 32
    fp32), each byte at its four 2-bit slots.  wgmma's A fragment gives
    thread ``t`` of four, per k-slice ``j``, the slice's columns ``{2t, 2t+1,
    2t+8, 2t+9}`` (bf16, k = 16) or ``{t, t+4}`` (tf32, k = 8); element ``e``
    of those is slot ``j`` of the thread's byte ``e``, its bytes being
    ``SK/16`` consecutive ones from ``SK/16 * t``.  In the tile-local layout
    byte ``B``, slot ``j`` holds sample ``(B // q) * block_n + j * q + B % q``
    (``q = block_n / 4``)."""
    sk = STAGE_SAMPLES[input_dtype]
    col = torch.arange(sk)
    if input_dtype == "bf16":
        j, c = col >> 4, col & 15
        byte, slot = 4 * ((c & 7) >> 1) + (c & 1) + 2 * (c >> 3), j
    else:
        byte, slot = 2 * (col & 3) + ((col >> 2) & 1), col >> 3
    stride = n_pad // 4
    k_pad = -(-n_pad // SAMPLE_ALIGN) * SAMPLE_ALIGN
    stage = torch.arange(k_pad // sk).reshape(-1, 1)
    byte = (stage * (sk // 4) + byte).reshape(-1)
    slot = slot.repeat(k_pad // sk)
    q = block_n // 4
    order = (byte // q) * block_n + slot * q + byte % q
    return torch.where(byte < stride, order, torch.full_like(order, -1))


def trait_operand_shape(p: int, n_pad: int, input_dtype: str) -> tuple[tuple[int, int], torch.dtype]:
    """Shape and type of the trait operand for ``p`` traits and ``n_pad``
    samples: bf16 ``(P_pad, K_pad)``, or float32 ``(2 * P_pad, K_pad)`` (the
    tf32 hi plane, then the lo plane)."""
    p_pad = -(-p // TRAIT_TILE) * TRAIT_TILE
    k_pad = -(-n_pad // SAMPLE_ALIGN) * SAMPLE_ALIGN
    if input_dtype == "bf16":
        return (p_pad, k_pad), torch.bfloat16
    return (2 * p_pad, k_pad), torch.float32


def trait_operand_ref(y: torch.Tensor, n_pad: int, input_dtype: str,
                      block_n: int) -> torch.Tensor:
    """Plain version of the kernel's prologue: ``y`` ``(n_y_rows, P)`` float32
    transposed to samples-contiguous rows in the kernel's sample order
    (``sample_order``), zero where a column stands for no sample of ``y``
    and past ``P``; bf16 rounded to nearest, or fp32 split into ``hi =
    tf32_rna(y)`` and ``lo = tf32_rna(y - hi)``."""
    (rows, k_pad), dtype = trait_operand_shape(y.shape[1], n_pad, input_dtype)
    p_pad = rows if input_dtype == "bf16" else rows // 2
    order = sample_order(n_pad, block_n, input_dtype).to(y.device)
    full = y.new_zeros((y.shape[0] + 1, p_pad), dtype=torch.float32)   # last row: zeros
    full[: y.shape[0], : y.shape[1]] = y
    pick = torch.where((order >= 0) & (order < y.shape[0]), order, torch.full_like(order, -1))
    yt = full[pick].T.contiguous()
    if input_dtype == "bf16":
        return yt.to(torch.bfloat16)
    hi = tf32_rna(yt)
    return torch.cat([hi, tf32_rna(yt - hi)])
