"""Plain PyTorch version of the fused gwas_dot kernel.

The same mathematical contract as the CUDA kernel (decode -> standardize ->
missing->0 -> GEMM/N -> clip -> t) with no tiling: fp32 operands and
epilogue, and the sum over samples taken in float64 and rounded to fp32
once.  The wrapper in ``gwas_dot.py`` runs it for tensors that lie on the
CPU; the on-card check in ``chip_smoke.py`` holds the kernel against it.
"""
from __future__ import annotations

import torch

__all__ = ["unpack_tiled", "decode_standardize_ref", "gwas_dot_ref"]


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
