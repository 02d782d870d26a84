"""Host-resident phenotype panels and trait-axis staging.

``PanelStore`` owns the residualized panel: host-side float32, tiled on the
trait axis, served as device-resident block slices through a small LRU.
``PanelPrefetcher`` overlaps the *next* trait block's host->device staging
with the current block's device step.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.engines import DeviceLRU, to_device
from repro_torch.core.residualize import residualize_and_standardize
from repro_torch.runtime.prefetch import TraitBlock

__all__ = ["PanelStore", "PanelPrefetcher"]


class PanelStore:
    """Host-resident residualized phenotype panel, tiled on the trait axis.

    The store residualizes + standardizes the panel in fixed ``quantum``-wide
    column chunks on ``device`` (peak device footprint during setup: one
    ``(N, quantum)`` slice), keeps the float32 results host-side, and serves
    device-resident block slices through a small LRU.  The chunk
    decomposition is the same regardless of ``trait_block``, so blocked and
    unblocked stores hold bitwise-identical panels.  Staged slices are the
    identical host float32 bytes.
    """

    def __init__(self, blocks: list[TraitBlock], panel: np.ndarray,
                 *, device: torch.device, max_resident: int = 4):
        self.blocks = list(blocks)
        self._panel = panel               # (N, P) float32, host
        self.device = torch.device(device)
        self._dev = DeviceLRU(            # block index -> staged device tensor
            max_resident,
            lambda idx: to_device(
                np.ascontiguousarray(self.host_block(self.blocks[idx])), self.device
            ),
        )

    @classmethod
    def residualized(
        cls,
        phenotypes: np.ndarray,
        q_basis: torch.Tensor,
        blocks: list[TraitBlock],
        *,
        quantum: int,
        max_resident: int = 4,
    ) -> "PanelStore":
        device = q_basis.device
        n, p = phenotypes.shape
        panel = np.empty((n, p), np.float32)
        for lo in range(0, p, quantum):
            hi = min(lo + quantum, p)
            chunk = residualize_and_standardize(
                to_device(np.asarray(phenotypes[:, lo:hi], np.float32), device), q_basis
            )
            panel[:, lo:hi] = chunk.y.cpu().numpy()
        return cls(blocks, panel, device=device, max_resident=max_resident)

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def host_block(self, block: TraitBlock) -> np.ndarray:
        return self._panel[:, block.lo : block.hi]

    def device_block(self, block: TraitBlock) -> torch.Tensor:
        """Device tensor for one block; the copy is launched asynchronously
        on CUDA, so staging overlaps the previous cell's compute."""
        return self._dev.get(block.index)


class PanelPrefetcher:
    """Single-worker look-ahead on the trait axis: stage block b+1 while the
    device chews on block b.  Results land in the thread-safe ``DeviceLRU``,
    so the consumer's own ``stage`` call finds them resident.  Best-effort: a
    staging error is swallowed here and surfaces on the consumer's
    synchronous call for the same block."""

    def __init__(self, stage: Callable[[Any, TraitBlock], Any], *, name: str = "panel-prefetch"):
        self._stage = stage
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True, name=name)
        self._worker.start()

    def _run(self) -> None:
        while not self._stop:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                return
            batch, block = item
            try:
                self._stage(batch, block)
            except Exception:  # noqa: BLE001 — see docstring: best-effort
                pass

    def request(self, batch: Any, block: TraitBlock) -> None:
        """Enqueue one look-ahead staging; drops the request when the worker
        is saturated (the synchronous path will stage it anyway)."""
        if self._stop:
            return
        try:
            self._q.put_nowait((batch, block))
        except queue.Full:
            pass

    def shutdown(self, *, join_timeout: float = 5.0) -> None:
        self._stop = True
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._worker.is_alive() and self._worker is not threading.current_thread():
            self._worker.join(timeout=join_timeout)
