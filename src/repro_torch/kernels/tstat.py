"""Wrappers around the hand-written Hopper t-statistic kernels
(``kernels/csrc/tstat.cu``), the ports of the Pallas TPU kernels
``repro.kernels.tstat._tstat_kernel`` (``tstat``) and ``_screen_kernel``
(``screen_compact``), the t mode of the screen (``compact_survivors``),
which compacts the survivors of an existing t tile for the fused OLS path's
sparse epilogue, and the canonical refine on the card
(``refine_neglog10p_device``: ``core.stats.neglog10_p_from_t`` over a t
buffer, which the reference runs on the host; it replaces no Pallas kernel).

Each wrapper checks and allocates, then launches the CUDA kernel for tensors
on a CUDA device, or runs the plain PyTorch version (``tstat_plain``,
``screen_compact_plain``, ``compact_survivors_plain``) for tensors on the
CPU.  There is no fallback: a CUDA tensor either launches the kernel or
raises.  ``tstat_launches``, ``screen_launches``, ``compact_launches`` and
``refine_launches`` count kernel launches (never the plain versions' runs).
The refine's plain version is ``core.stats.neglog10_p_from_t`` itself, and
its host route is ``core.stats.refine_neglog10p``: its wrapper takes CUDA
tensors only.

The screen and its t mode compact inside the kernel (an ordered scatter
behind a decoupled look-back), so neither reads a device value back to the
host: the survivor count stays on the device.

The kernels and the plain versions compute ``t = r * rsqrt(denom / dof)``
(the kernels' formula), not ``stats.t_from_r``'s ``r * sqrt(dof / denom)``.
``block_m``/``block_p`` are the reference's tile shape; the CUDA kernels
work on the flat tile and take any shape, so they only validate them.

Under a dispatch mode (a trace) the launches go through the custom ops
``torch.ops.repro_torch.tstat`` and ``torch.ops.repro_torch.compact``:
under ``FakeTensorMode`` (a dry run) their registered fakes give the
outputs' shapes and nothing launches.  Outside one, the wrappers call the
ops' implementations themselves: a dispatched custom op takes a round trip
through the dispatcher and Python on every call, on kernels whose whole
call is a few tens of microseconds.
"""
from __future__ import annotations

import ctypes
import threading

import torch

__all__ = [
    "compact_launches",
    "compact_survivors",
    "compact_survivors_plain",
    "refine_launches",
    "refine_neglog10p_device",
    "screen_compact",
    "screen_compact_plain",
    "screen_launches",
    "tstat",
    "tstat_launches",
    "tstat_plain",
]

# Number of CUDA kernel launches so far, per entry; reset by assignment.
tstat_launches = 0
screen_launches = 0
compact_launches = 0
refine_launches = 0

# Survivor indices are int32, as in the reference.
_INDEX_LIMIT = 2**31
# Epochs of the look-back's status words run 1 .. 2^30 - 1 (30 bits).
_EPOCHS = 2**30 - 1

_lib = None
_tile = 0       # elements per tile of the compaction kernel, read at load
# (device index, stream) -> [int64 workspace, epoch of its last launch]
_workspaces: dict[tuple[int, int], list] = {}
_workspace_lock = threading.Lock()


def _library():
    global _lib, _tile
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("tstat")
        vp, ll, f32, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
        lib.tstat_launch.argtypes = [vp, vp, ll, f32, f32, i32, vp]
        lib.compact_launch.argtypes = [vp, vp, vp, vp, vp, ll, ll, ctypes.c_uint,
                                       f32, f32, f32, i32, i32, vp]
        lib.refine_launch.argtypes = [vp, vp, ll, f32, f32, f32, f32, f32, f32, i32, vp]
        for fn in (lib.tstat_launch, lib.compact_launch, lib.refine_launch,
                   lib.compact_tile_elems):
            fn.restype = ctypes.c_int
        _tile = lib.compact_tile_elems()
        _lib = lib
    return _lib


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream.  The private call skips
    building a ``torch.cuda.Stream`` object on every launch; the entry points
    switch to ``device`` themselves, so no device guard is needed either."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _workspace(device: torch.device, stream: int, n: int) -> tuple[torch.Tensor, int]:
    """The look-back's workspace on (device, stream) for ``n`` elements and a
    fresh epoch for one launch; call under ``_workspace_lock``.  Word 0 is
    the tile counter, which the kernel leaves at 0; words 1.. are the
    per-tile status words, and a word of another epoch reads as not yet
    posted, so the workspace is never reset.  One per stream: two streams'
    launches would otherwise race on the counter.  A CUDA graph that
    captures a launch keeps the capture stream's workspace, so replay it
    while nothing else launches on that workspace."""
    tiles = max(1, -(-n // _tile))
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < tiles + 1:
        ws = _workspaces[key] = [torch.zeros(tiles + 1, dtype=torch.int64, device=device), 0]
    ws[1] = ws[1] % _EPOCHS + 1
    return ws[0], ws[1]


def _check(r: torch.Tensor, block_m: int, block_p: int) -> None:
    if r.dtype != torch.float32 or r.dim() != 2:
        raise ValueError(f"r must be a 2-D float32 tensor, got {r.dtype} {tuple(r.shape)}")
    if block_m <= 0 or block_p <= 0:
        raise ValueError(f"block_m and block_p must be positive, got {block_m}, {block_p}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the tstat kernels run on cuda or cpu tensors, not {r.device.type}")


def _check_screen(x: torch.Tensor, t2_screen: float, capacity: int) -> None:
    if not float(t2_screen) > 0.0:
        raise ValueError(f"t2_screen must be positive, got {t2_screen}")
    if not 0 <= capacity < _INDEX_LIMIT or x.numel() >= _INDEX_LIMIT:
        raise ValueError(f"int32 survivor indices: need 0 <= capacity and {x.numel()} "
                         f"elements below 2^31, got capacity {capacity}")


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


def compact_survivors_plain(
    t: torch.Tensor, t2_screen: float, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``compact_survivors`` (any device).
    ``torch.nonzero`` sizes its output by the data, so on a card it waits
    for the device."""
    keep = (t * t).reshape(-1) >= t2_screen
    count = torch.sum(keep).to(torch.int32)
    found = torch.nonzero(keep).reshape(-1)[:capacity].to(torch.int32)
    idx = torch.full((capacity,), -1, dtype=torch.int32, device=t.device)
    idx[: found.shape[0]] = found
    return idx, count


def screen_compact_plain(
    r: torch.Tensor, dof: float, t2_screen: float, capacity: int, *, eps: float = 1e-12
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``screen_compact`` (any device)."""
    t = _t_plain(r, dof, eps)
    return (t, *compact_survivors_plain(t, t2_screen, capacity))


def _compact(
    src: torch.Tensor, t_mode: bool, t2_screen: float, capacity: int, dof: float, eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the compaction kernel on ``src``'s device: r mode
    (``src`` is r; the t tile is written too) or t mode (``src`` is t; the
    returned t is empty).  Returns (t, idx, count)."""
    launch = _compact_op if torch._C._len_torch_dispatch_stack() else _compact_launch
    return launch(src.contiguous(), t_mode, float(t2_screen), capacity, float(dof), float(eps))


def _compact_launch(src: torch.Tensor, t_mode: bool, t2_screen: float, capacity: int,
                    dof: float, eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global screen_launches, compact_launches
    t = src.new_empty((0,) if t_mode else src.shape)
    idx = torch.empty((capacity,), dtype=torch.int32, device=src.device)
    count = torch.empty((), dtype=torch.int32, device=src.device)
    lib = _library()
    stream = _stream(src.device)
    with _workspace_lock:
        work, epoch = _workspace(src.device, stream, src.numel())
        err = lib.compact_launch(
            src.data_ptr(), None if t_mode else t.data_ptr(), idx.data_ptr(),
            count.data_ptr(), work.data_ptr(), src.numel(), capacity, epoch, dof,
            t2_screen, eps, int(t_mode), src.device.index, stream)
    if err != 0:
        raise RuntimeError(f"compaction kernel launch failed: cudaError_t {err}")
    if t_mode:
        compact_launches += 1
    else:
        screen_launches += 1
    return t, idx, count


_compact_op = torch.library.custom_op("repro_torch::compact", _compact_launch, mutates_args=())


@_compact_op.register_fake
def _compact_fake(src, t_mode, t2_screen, capacity, dof, eps):
    return (src.new_empty((0,) if t_mode else src.shape),
            src.new_empty((capacity,), dtype=torch.int32), src.new_empty((), dtype=torch.int32))


def _tstat_launch(r: torch.Tensor, dof: float, eps: float) -> torch.Tensor:
    global tstat_launches
    t = torch.empty_like(r)
    lib = _library()
    err = lib.tstat_launch(r.data_ptr(), t.data_ptr(), r.numel(), dof, eps, r.device.index,
                           _stream(r.device))
    if err != 0:
        raise RuntimeError(f"tstat kernel launch failed: cudaError_t {err}")
    tstat_launches += 1
    return t


_tstat_op = torch.library.custom_op("repro_torch::tstat", _tstat_launch, mutates_args=())


@_tstat_op.register_fake
def _tstat_fake(r, dof, eps):
    return torch.empty_like(r)


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
    _check(r, block_m, block_p)
    if r.device.type == "cpu":
        return tstat_plain(r, dof, eps=eps)
    launch = _tstat_op if torch._C._len_torch_dispatch_stack() else _tstat_launch
    return launch(r.contiguous(), float(dof), float(eps))


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
    """Fused t statistic + ``t^2 >= t2_screen`` survivor screen, one kernel
    launch on a card.

    Returns ``(t, hit_idx, screen_count)``: the ``(M, P)`` t tile, the
    row-major flat indices of the first ``capacity`` survivors (ascending,
    padded with -1), and the exact survivor total as an int32 scalar
    (trustworthy past ``capacity``).  ``t2_screen`` must be positive: lanes
    with ``r = 0`` give ``t = 0`` and must never survive.
    """
    _check(r, block_m, block_p)
    capacity = int(capacity)
    _check_screen(r, t2_screen, capacity)
    if r.device.type == "cpu":
        return screen_compact_plain(r, dof, t2_screen, capacity, eps=eps)
    return _compact(r, False, t2_screen, capacity, dof, eps)


def compact_survivors(
    t: torch.Tensor, t2_screen: float, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The screen's t mode: ``(hit_idx, screen_count)`` of an existing
    ``(M, P)`` float32 t tile, as ``screen_compact`` returns them, in one
    kernel launch on a card."""
    _check(t, 1, 1)
    capacity = int(capacity)
    _check_screen(t, t2_screen, capacity)
    if t.device.type == "cpu":
        return compact_survivors_plain(t, t2_screen, capacity)
    return _compact(t, True, t2_screen, capacity, 1.0, 0.0)[1:]


def refine_neglog10p_device(t: torch.Tensor, scalars) -> torch.Tensor:
    """``core.stats.neglog10_p_from_t`` of a CUDA t buffer in one launch on
    its device's current stream: a 1-D float32 tensor of ``t.numel()``
    values there.  ``scalars`` is ``core.stats._refine_scalars(dof)``, the
    per-scan scalars both routes share.  Elementwise: a lane's bits depend
    on its t alone, never on its position or the buffer's length."""
    if t.device.type != "cuda":
        raise ValueError(f"the refine kernel runs on CUDA tensors, not {t.device.type}; "
                         "core.stats.refine_neglog10p refines host values on the host")
    global refine_launches
    t = t.to(torch.float32).contiguous().reshape(-1)
    out = torch.empty_like(t)
    if t.numel() == 0:
        return out
    err = _library().refine_launch(t.data_ptr(), out.data_ptr(), t.numel(), *scalars,
                                   t.device.index, _stream(t.device))
    if err != 0:
        raise RuntimeError(f"refine kernel launch failed: cudaError_t {err}")
    refine_launches += 1
    return out
