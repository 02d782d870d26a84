"""Public wrapper around the fused gwas_dot kernel, plus its host helpers.

Owns everything the kernel does not: tile-local packing and marker-stat
computation from raw 2-bit counts (NumPy, on the host), and the device-side
byte fronts that turn PLINK bytes into the kernel's layout or into float
dosages (PyTorch integer ops on the tensor's device).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.gwas_dot.gwas_dot import gwas_dot_fused

__all__ = [
    "pack_tiled",
    "unpack_plink_to_codes",
    "repack_plink_tiled",
    "marker_stats_from_codes",
    "marker_stats_from_packed",
    "decode_packed_device",
    "repack_plink_tiled_device",
    "gwas_dot",
]


def _pad_to(x: np.ndarray, axis: int, multiple: int, fill) -> np.ndarray:
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def pack_tiled(codes: np.ndarray, block_n: int) -> np.ndarray:
    """Pack 2-bit codes ``(M, N)`` into the kernel's tile-local interleaved
    layout ``(M, N_pad/4) uint8``.

    Within each ``block_n``-sample tile, byte ``b`` carries the codes of
    samples ``tile_start + s * block_n/4 + b`` at slot ``s``.  Samples are
    padded to a tile multiple with the missing code (0b01), which the kernel
    standardizes to exactly 0, so padding never perturbs the GEMM.
    """
    if block_n % 4:
        raise ValueError("block_n must be a multiple of 4")
    c = _pad_to(np.asarray(codes, np.uint8), 1, block_n, 0b01)
    m, n_pad = c.shape
    quarter = block_n // 4
    tiles = c.reshape(m, n_pad // block_n, 4, quarter)  # (M, T, slot, byte)
    packed = (
        tiles[:, :, 0, :]
        | (tiles[:, :, 1, :] << 2)
        | (tiles[:, :, 2, :] << 4)
        | (tiles[:, :, 3, :] << 6)
    )
    return packed.reshape(m, n_pad // 4).astype(np.uint8)


def unpack_plink_to_codes(plink_packed: np.ndarray, n_samples: int) -> np.ndarray:
    """PLINK byte layout ``(M, ceil(N/4))`` -> raw codes ``(M, N) uint8``."""
    p = np.asarray(plink_packed, np.uint8)
    m = p.shape[0]
    codes = np.empty((m, p.shape[1] * 4), np.uint8)
    for s in range(4):
        codes[:, s::4] = (p >> (2 * s)) & 0b11
    return codes[:, :n_samples]


def repack_plink_tiled(plink_packed: np.ndarray, n_samples: int, block_n: int) -> np.ndarray:
    """Disk layout -> kernel layout in one host-side step (the scan's
    prefetch thread runs this; it is a byte shuffle, ~free next to decode)."""
    return pack_tiled(unpack_plink_to_codes(plink_packed, n_samples), block_n)


def marker_stats_from_codes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-marker (mean, inv_std, valid) from raw 2-bit codes, using the
    count identities (no float decode needed):

        sum d  = 2*n00 + n10,   sum d^2 = 4*n00 + n10
        var_imputed = (sum d^2 - n_present * mean^2) / N
    """
    c = np.asarray(codes)
    m, n = c.shape
    n00 = (c == 0b00).sum(axis=1).astype(np.float64)
    n10 = (c == 0b10).sum(axis=1).astype(np.float64)
    n11 = (c == 0b11).sum(axis=1).astype(np.float64)
    n_present = n00 + n10 + n11
    sum_d = 2.0 * n00 + n10
    sum_d2 = 4.0 * n00 + n10
    mean = sum_d / np.maximum(n_present, 1.0)
    var = (sum_d2 - n_present * mean**2) / n
    valid = (var > 1e-10) & (n_present > 0)
    inv_std = np.where(valid, 1.0 / np.sqrt(np.maximum(var, 1e-10)), 0.0)
    return mean.astype(np.float32), inv_std.astype(np.float32), valid


_PARTIAL_CODE_COUNTS = np.zeros((5, 256, 3), np.uint8)
for _r in range(1, 5):
    for _b in range(256):
        for _s in range(_r):
            _c = (_b >> (2 * _s)) & 0b11
            if _c == 0b00:
                _PARTIAL_CODE_COUNTS[_r, _b, 0] += 1
            elif _c == 0b10:
                _PARTIAL_CODE_COUNTS[_r, _b, 1] += 1
            elif _c == 0b11:
                _PARTIAL_CODE_COUNTS[_r, _b, 2] += 1


def marker_stats_from_packed(
    plink_packed: np.ndarray, n_samples: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``marker_stats_from_codes`` evaluated straight off PLINK bytes.

    A 256-entry count LUT tallies (n00, n10, n11) per byte — with a partial
    LUT for the tail byte when ``n_samples % 4 != 0`` so pad slots never
    count — then feeds the *identical* float64 count identities.  Bitwise
    equal to ``marker_stats_from_codes(unpack_plink_to_codes(p, n))`` at
    memcpy-level cost: the float decode of the genotype matrix never happens.
    """
    p = np.asarray(plink_packed, np.uint8)
    full, rem = divmod(int(n_samples), 4)
    counts = _PARTIAL_CODE_COUNTS[4][p[:, :full]].sum(axis=1, dtype=np.int64)
    if rem:
        counts = counts + _PARTIAL_CODE_COUNTS[rem][p[:, full]]
    n00 = counts[:, 0].astype(np.float64)
    n10 = counts[:, 1].astype(np.float64)
    n11 = counts[:, 2].astype(np.float64)
    n_present = n00 + n10 + n11
    sum_d = 2.0 * n00 + n10
    sum_d2 = 4.0 * n00 + n10
    mean = sum_d / np.maximum(n_present, 1.0)
    var = (sum_d2 - n_present * mean**2) / n_samples
    valid = (var > 1e-10) & (n_present > 0)
    inv_std = np.where(valid, 1.0 / np.sqrt(np.maximum(var, 1e-10)), 0.0)
    return mean.astype(np.float32), inv_std.astype(np.float32), valid


def _plink_codes(plink_packed: torch.Tensor, n_samples: int) -> torch.Tensor:
    """PLINK bytes ``(M, ceil(N/4)) uint8`` -> codes ``(M, N) uint8`` on the
    tensor's device (sample ``n`` at byte ``n // 4``, slot ``n % 4``)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=plink_packed.device)
    c = (plink_packed.unsqueeze(-1) >> shifts) & 0b11
    return c.reshape(plink_packed.shape[0], -1)[:, :n_samples]


def decode_packed_device(plink_packed: torch.Tensor, *, n_samples: int) -> torch.Tensor:
    """PLINK bytes ``(M, ceil(N/4)) uint8`` -> dosages ``(M, N) float32`` with
    missing as -9.0, decoded on the tensor's device by shift/mask ops.

    The code->dosage map matches the host ``_BYTE_LUT`` exactly
    (0b00 -> 2, 0b01 -> -9, 0b10 -> 1, 0b11 -> 0): pure integer arithmetic,
    so the emitted f32 values are bit-identical to the host decode.
    """
    c = _plink_codes(plink_packed, n_samples).to(torch.int32)
    dose = (2 - c + (c >> 1)).to(torch.float32)
    return torch.where(c == 0b01, torch.full_like(dose, -9.0), dose)


def repack_plink_tiled_device(
    plink_packed: torch.Tensor, *, n_samples: int, block_n: int, block_m: int
) -> torch.Tensor:
    """Disk layout -> kernel tile-local layout, as a device byte shuffle.

    Mirrors host ``repack_plink_tiled`` + the ``block_m`` row padding the
    fused step expects: unpack to codes, slice real samples, re-pad samples
    to a ``block_n`` multiple and rows to a ``block_m`` multiple with the
    missing code 0b01 (standardizes to exactly 0 under the padded
    mean/inv_std of 0), then interleave 4 slot-planes per tile.  Integer
    ops only — output bytes equal the host path's bit-for-bit.
    """
    if block_n % 4:
        raise ValueError("block_n must be a multiple of 4")
    m = plink_packed.shape[0]
    c = _plink_codes(plink_packed, n_samples)
    n_pad = n_samples + (-n_samples) % block_n
    m_pad = m + (-m) % block_m
    full = torch.full((m_pad, n_pad), 0b01, dtype=torch.uint8, device=plink_packed.device)
    full[:m, :n_samples] = c
    quarter = block_n // 4
    tiles = full.reshape(m_pad, n_pad // block_n, 4, quarter)
    packed = (
        tiles[:, :, 0, :]
        | (tiles[:, :, 1, :] << 2)
        | (tiles[:, :, 2, :] << 4)
        | (tiles[:, :, 3, :] << 6)
    )
    return packed.reshape(m_pad, n_pad // 4)


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def gwas_dot(
    packed_tiled,                 # (M, N_pad/4) uint8, kernel layout
    mean,                         # (M,)
    inv_std,                      # (M,)
    y,                            # (N_true_or_pad, P)
    *,
    n_samples: int,
    dof: int,
    block_n: int = 512,
    block_p: int = 256,
    input_dtype: str = "fp32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (R, T) for one genotype batch.  Returns float32 ``(M, P)``.

    Accepts tensors or arrays; everything is moved to where ``packed_tiled``
    lies (the CPU for an array).  ``y`` rows beyond the packed sample
    padding read as zeros.  On a CUDA device this launches the hand-written
    kernel; on the CPU it runs the plain version.
    """
    device = packed_tiled.device if isinstance(packed_tiled, torch.Tensor) else torch.device("cpu")
    return gwas_dot_fused(
        _as_tensor(packed_tiled, torch.uint8, device),
        _as_tensor(mean, torch.float32, device).reshape(-1),
        _as_tensor(inv_std, torch.float32, device).reshape(-1),
        _as_tensor(y, torch.float32, device),
        n_samples=int(n_samples),
        dof=int(dof),
        block_n=block_n,
        block_p=block_p,
        input_dtype=input_dtype,
    )
