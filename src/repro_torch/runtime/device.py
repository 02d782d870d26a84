"""Device resolution and the port's fp32 precision contract.

Entry points run on ``cuda`` unless the caller asks for the CPU; a missing
card is an error, never a quiet move to the CPU.  Resolving a device also
pins float32 products to full fp32: the reference computes them at
``Precision.HIGHEST`` and holds r to 2e-6, which TF32 would break.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["on_stream", "resolve_device", "synchronize"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``"cuda"`` (default), ``"cuda:i"`` or ``"cpu"`` -> ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(CLI: --device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} requested but only {torch.cuda.device_count()} CUDA device(s) exist"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for every kernel queued on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def on_stream(stream: "torch.cuda.Stream | None"):
    """Context in which the calling thread issues its CUDA work on
    ``stream``; ``None`` (the CPU, or the serial executor's default stream)
    changes nothing.  PyTorch's current stream is per thread, so every
    thread that works for one executor slot enters the slot's stream."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)
