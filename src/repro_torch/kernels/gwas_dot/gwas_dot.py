"""Wrapper around the hand-written Hopper ``gwas_dot`` kernel
(``kernels/csrc/gwas_dot.cu``), the port of the Pallas TPU kernel
``repro.kernels.gwas_dot.gwas_dot.gwas_dot_kernel``.

``gwas_dot_fused`` checks and allocates (the outputs, and the scratch that
the kernel's prologue writes the trait operand into: ``ref.trait_operand_shape``),
then launches the CUDA kernel for tensors on a CUDA device, or runs the plain
PyTorch version (``ref.py``) for tensors on the CPU.  There is no fallback: a CUDA tensor either launches the
kernel or raises.  ``launches`` counts kernel launches (never the plain
version's runs), so a caller can show that a path went through the kernel.

Under a dispatch mode (a trace: ``FakeTensorMode``, ``FlopCounterMode``)
the launch goes through the custom op ``torch.ops.repro_torch.gwas_dot``:
under ``FakeTensorMode`` (a dry run) its registered fake gives the
outputs' shapes and nothing launches (the scratch is allocated outside the
op, so a trace counts its bytes), and ``FlopCounterMode`` counts it as
``2 M N P`` (N the sample rows of y), the product it computes.  Outside
one, the wrapper calls the op's implementation itself (a dispatched custom
op takes a round trip through the dispatcher and Python on every call).
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.gwas_dot.ref import gwas_dot_ref, trait_operand_shape, unpack_tiled

__all__ = ["gwas_dot_fused", "launches", "INPUT_DTYPES"]

INPUT_DTYPES = ("fp32", "bf16")

# Number of CUDA kernel launches so far; reset it by assignment.
launches = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels.build import load

        fn = load("gwas_dot").gwas_dot_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 5
            + [ctypes.c_float] * 3
            + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def smem_bytes(bf16: bool) -> int:
    """The main kernel's dynamic shared memory (its ring), in bytes."""
    from repro_torch.kernels.build import load

    return int(load("gwas_dot").gwas_dot_smem_bytes(1 if bf16 else 0))


def _check(packed, mean, inv_std, y, block_n, input_dtype) -> tuple[int, int, int]:
    if input_dtype not in INPUT_DTYPES:
        raise ValueError(f"unknown input_dtype {input_dtype!r}; expected {INPUT_DTYPES}")
    if block_n <= 0 or block_n % 4:
        raise ValueError(f"block_n must be a positive multiple of 4, got {block_n}")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed must be a 2-D uint8 tensor, got {packed.dtype} {tuple(packed.shape)}")
    m, width = packed.shape
    if width % (block_n // 4):
        raise ValueError(f"packed width {width} is not a multiple of block_n/4={block_n // 4}")
    n_pad = width * 4
    for name, v in (("mean", mean), ("inv_std", inv_std)):
        if v.dtype != torch.float32 or v.numel() != m:
            raise ValueError(f"{name} must be float32 with {m} elements, got {v.dtype} {tuple(v.shape)}")
    if y.dtype != torch.float32 or y.dim() != 2:
        raise ValueError(f"y must be a 2-D float32 tensor, got {y.dtype} {tuple(y.shape)}")
    if y.shape[0] > n_pad:
        raise ValueError(f"y has {y.shape[0]} sample rows but the packing holds {n_pad}")
    devices = {t.device for t in (packed, mean, inv_std, y)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
    return m, n_pad, int(y.shape[1])


def gwas_dot_fused(
    packed: torch.Tensor,     # (M, N_pad/4) uint8, tile-local layout of block_n
    mean: torch.Tensor,       # (M,) or (M, 1) float32
    inv_std: torch.Tensor,    # (M,) or (M, 1) float32
    y: torch.Tensor,          # (n_rows <= N_pad, P) float32; missing rows read as 0
    *,
    n_samples: int,
    dof: int,
    block_n: int,
    block_p: int = 256,
    input_dtype: str = "fp32",
    eps: float = 1e-12,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (r, t) float32 ``(M, P)`` for one genotype batch.

    ``block_n`` is a parameter of the packed *layout* only.  ``block_p`` is
    the trait-axis chunk of the plain version (CPU tensors), which keeps any
    decomposition of the trait axis into multiples of it bitwise-identical;
    the kernel's own tiles are fixed in the source and its sums run in one
    order whatever the shape.
    """
    m, n_pad, p = _check(packed, mean, inv_std, y, block_n, input_dtype)
    device = packed.device
    if device.type == "cpu":
        codes = unpack_tiled(packed, block_n)
        if y.shape[0] < n_pad:
            y = torch.cat([y, y.new_zeros((n_pad - y.shape[0], p))])
        return gwas_dot_ref(
            codes, mean.reshape(-1), inv_std.reshape(-1), y,
            n_samples=n_samples, dof=dof, eps=eps, input_dtype=input_dtype,
            trait_tile=block_p,
        )
    if device.type != "cuda":
        raise ValueError(f"gwas_dot runs on cuda or cpu tensors, not {device.type}")
    shape, dtype = trait_operand_shape(p, n_pad, input_dtype)
    scratch = torch.empty(shape, dtype=dtype, device=device)
    launch = _gwas_dot_op if torch._C._len_torch_dispatch_stack() else _launch
    return launch(packed.contiguous(), mean.reshape(-1).contiguous(),
                  inv_std.reshape(-1).contiguous(), y.contiguous(), scratch, block_n,
                  float(n_samples), float(dof), float(eps), input_dtype == "bf16")


def _launch(packed: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor,
            y: torch.Tensor, scratch: torch.Tensor, block_n: int,
            n_samples: float, dof: float, eps: float,
            bf16: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel (its prologue writes ``scratch``, then the
    main kernel runs) on checked, contiguous CUDA inputs."""
    global launches
    device = packed.device
    m, p = int(packed.shape[0]), int(y.shape[1])
    shape, dtype = trait_operand_shape(p, int(packed.shape[1]) * 4, "bf16" if bf16 else "fp32")
    if tuple(scratch.shape) != shape or scratch.dtype != dtype or not scratch.is_contiguous():
        raise ValueError(f"scratch must be a contiguous {dtype} {shape}, got "
                         f"{scratch.dtype} {tuple(scratch.shape)}")
    r = torch.empty((m, p), dtype=torch.float32, device=device)
    t = torch.empty((m, p), dtype=torch.float32, device=device)
    fn = _launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            packed.data_ptr(), mean.data_ptr(), inv_std.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), r.data_ptr(), t.data_ptr(),
            m, p, int(y.shape[0]), int(packed.shape[1]), int(block_n),
            n_samples, dof, eps, 1 if bf16 else 0, stream,
        )
    if err != 0:
        raise RuntimeError(f"gwas_dot kernel launch failed: cudaError_t {err}")
    launches += 1
    return r, t


_gwas_dot_op = torch.library.custom_op("repro_torch::gwas_dot", _launch,
                                       mutates_args=("scratch",))


@_gwas_dot_op.register_fake
def _gwas_dot_fake(packed, mean, inv_std, y, scratch, block_n, n_samples, dof, eps, bf16):
    shape = (packed.shape[0], y.shape[1])
    return tuple(packed.new_empty(shape, dtype=torch.float32) for _ in range(2))


@register_flop_formula(torch.ops.repro_torch.gwas_dot)
def _gwas_dot_flops(packed_shape, mean_shape, inv_std_shape, y_shape, *args, **kwargs) -> int:
    return 2 * packed_shape[0] * y_shape[0] * y_shape[1]
