"""Wrappers around the hand-written Hopper t-statistic kernels
(``kernels/csrc/tstat.cu``), the ports of the Pallas TPU kernels
``repro.kernels.tstat._tstat_kernel`` (``tstat``) and ``_screen_kernel``
(``screen_compact``).

Both wrappers check and allocate, then launch the CUDA kernel for tensors on
a CUDA device, or run the plain PyTorch version (``tstat_plain``,
``screen_compact_plain``) for tensors on the CPU.  There is no fallback: a
CUDA tensor either launches the kernel or raises.  ``tstat_launches`` and
``screen_launches`` count kernel launches (never the plain versions' runs).

The kernels and the plain versions compute ``t = r * rsqrt(denom / dof)``
(the kernels' formula), not ``stats.t_from_r``'s ``r * sqrt(dof / denom)``.
``block_m``/``block_p`` are the reference's tile shape; the CUDA kernels are
elementwise over the flat tile and take any shape, so they only validate
them.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = [
    "screen_compact",
    "screen_compact_plain",
    "screen_launches",
    "screen_tile",
    "screen_tile_plain",
    "tstat",
    "tstat_launches",
    "tstat_plain",
]

# Number of CUDA kernel launches so far, per kernel; reset by assignment.
tstat_launches = 0
screen_launches = 0

_lib = None
_threads = 0    # threads per CUDA block of the screen kernel, read at load


def _library():
    global _lib, _threads
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("tstat")
        lib.tstat_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.tstat_launch.restype = ctypes.c_int
        lib.screen_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.screen_launch.restype = ctypes.c_int
        lib.tstat_block_threads.restype = ctypes.c_int
        _threads = lib.tstat_block_threads()
        _lib = lib
    return _lib


def _check(r: torch.Tensor, block_m: int, block_p: int) -> None:
    if r.dtype != torch.float32 or r.dim() != 2:
        raise ValueError(f"r must be a 2-D float32 tensor, got {r.dtype} {tuple(r.shape)}")
    if block_m <= 0 or block_p <= 0:
        raise ValueError(f"block_m and block_p must be positive, got {block_m}, {block_p}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the tstat kernels run on cuda or cpu tensors, not {r.device.type}")


def _t_plain(r: torch.Tensor, dof: float, eps: float) -> torch.Tensor:
    """The kernels' arithmetic in PyTorch ops, one rounding per op."""
    r = torch.clamp(r, -1.0, 1.0)
    denom = torch.clamp(1.0 - r * r, min=eps)
    # a 0-dim tensor on r's device: a true division, not a reciprocal product
    dof_t = torch.full((), float(dof), dtype=torch.float32, device=r.device)
    return r * torch.rsqrt(denom / dof_t)


def tstat_plain(r: torch.Tensor, dof: float, *, eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version of ``tstat`` (any device)."""
    return _t_plain(r, dof, eps)


def screen_tile_plain(
    r: torch.Tensor, dof: float, t2_screen: float, *, eps: float = 1e-12
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``screen_tile`` (any device); the survivor
    count comes as one total."""
    t = _t_plain(r, dof, eps)
    keep = t * t >= t2_screen
    return t, keep.to(torch.int8), torch.sum(keep).to(torch.int32).reshape(1)


def screen_compact_plain(
    r: torch.Tensor, dof: float, t2_screen: float, capacity: int, *, eps: float = 1e-12
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``screen_compact`` (any device)."""
    t, mask, count = screen_tile_plain(r, dof, t2_screen, eps=eps)
    return t, _compact(mask.reshape(-1) != 0, capacity), count[0]


def _compact(keep: torch.Tensor, capacity: int) -> torch.Tensor:
    """Row-major flat indices of the survivors, the first ``capacity`` of
    them, padded with -1 to ``capacity``."""
    found = torch.nonzero(keep).reshape(-1)[:capacity].to(torch.int32)
    idx = torch.full((capacity,), -1, dtype=torch.int32, device=keep.device)
    idx[: found.shape[0]] = found
    return idx


def tstat(
    r: torch.Tensor,
    dof: float,
    *,
    block_m: int = 256,
    block_p: int = 256,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Elementwise ``t = clip(r) * rsqrt(max(1 - r^2, eps) / dof)`` over an
    ``(M, P)`` float32 tile."""
    global tstat_launches
    _check(r, block_m, block_p)
    if r.device.type == "cpu":
        return tstat_plain(r, dof, eps=eps)
    r = r.contiguous()
    t = torch.empty_like(r)
    lib = _library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.tstat_launch(r.data_ptr(), t.data_ptr(), r.numel(), float(dof),
                               float(eps), stream)
    if err != 0:
        raise RuntimeError(f"tstat kernel launch failed: cudaError_t {err}")
    tstat_launches += 1
    return t


def screen_tile(
    r: torch.Tensor, dof: float, t2_screen: float, *, eps: float = 1e-12
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The screen kernel alone: ``(t, mask, counts)`` — the ``(M, P)`` t
    tile, the int8 survivor mask ``t^2 >= t2_screen``, and int32 survivor
    counts, one per CUDA block of the flat tile (one total on the CPU)."""
    global screen_launches
    _check(r, 1, 1)
    if r.device.type == "cpu":
        return screen_tile_plain(r, dof, t2_screen, eps=eps)
    r = r.contiguous()
    n = r.numel()
    lib = _library()
    t = torch.empty_like(r)
    mask = torch.empty(r.shape, dtype=torch.int8, device=r.device)
    counts = torch.empty((max(1, -(-n // _threads)),), dtype=torch.int32, device=r.device)
    if n == 0:
        counts.zero_()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.screen_launch(r.data_ptr(), t.data_ptr(), mask.data_ptr(),
                                counts.data_ptr(), n, float(dof), float(t2_screen),
                                float(eps), stream)
    if err != 0:
        raise RuntimeError(f"screen kernel launch failed: cudaError_t {err}")
    screen_launches += 1
    return t, mask, counts


def screen_compact(
    r: torch.Tensor,
    dof: float,
    t2_screen: float,
    capacity: int,
    *,
    block_m: int = 256,
    block_p: int = 256,
    eps: float = 1e-12,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused t statistic + ``t^2 >= t2_screen`` survivor screen.

    Returns ``(t, hit_idx, screen_count)``: the ``(M, P)`` t tile, the
    row-major flat indices of the first ``capacity`` survivors (ascending,
    padded with -1), and the exact survivor total as an int32 scalar
    (trustworthy past ``capacity``).  ``t2_screen`` must be positive: lanes
    with ``r = 0`` give ``t = 0`` and must never survive.  The compaction
    runs here, after the kernel (``torch.nonzero`` keeps row-major order).
    """
    _check(r, block_m, block_p)
    if not float(t2_screen) > 0.0:
        raise ValueError(f"t2_screen must be positive, got {t2_screen}")
    t, mask, counts = screen_tile(r, dof, t2_screen, eps=eps)
    idx = _compact(mask.reshape(-1) != 0, int(capacity))
    return t, idx, torch.sum(counts).to(torch.int32)
