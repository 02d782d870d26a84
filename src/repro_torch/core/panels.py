"""Host-resident phenotype panels and trait-axis staging.

``PanelStore`` owns the residualized panel: host-side float32, tiled on the
trait axis, served as device-resident block slices through a small LRU per
device (``PanelView``).  ``PanelPrefetcher`` overlaps the *next* trait
block's host->device staging with the current block's device step.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.engines import DeviceLRU, to_device
from repro_torch.core.residualize import residualize_and_standardize
from repro_torch.runtime.device import on_stream
from repro_torch.runtime.prefetch import TraitBlock

__all__ = ["PanelStore", "PanelView", "PanelPrefetcher"]


class PanelView:
    """One device's residency of a shared host panel: a per-executor-slot
    LRU of staged block slices.

    Each slot of the multi-device executor holds its own view onto the one
    host-side ``PanelStore`` and stages blocks onto its own device; the
    slices are the identical host float32 bytes, so every device computes
    on bit-equal panels.  A copy is issued on the calling thread's current
    stream: the executor's slot threads (and the slot's look-ahead thread)
    run on the slot's stream, so the copy is ordered before every step that
    reads the block.
    """

    def __init__(self, store: "PanelStore", *, device: torch.device, max_resident: int = 4):
        self.device = torch.device(device)
        self._dev = DeviceLRU(            # block index -> staged device tensor
            max_resident,
            lambda idx: to_device(
                np.ascontiguousarray(store.host_block(store.blocks[idx])), self.device
            ),
        )

    def device_block(self, block: TraitBlock) -> torch.Tensor:
        """Device tensor for one block; the copy is launched asynchronously
        on CUDA, so staging overlaps the previous cell's compute."""
        return self._dev.get(block.index)

    def pin_block(self, block: TraitBlock) -> None:
        """Ref-count-pin one staged block against LRU eviction."""
        self._dev.pin(block.index)

    def unpin_block(self, block: TraitBlock) -> None:
        self._dev.unpin(block.index)

    def cache_stats(self) -> dict:
        """Hit/miss/eviction counters of this view's staging LRU."""
        return self._dev.stats()

    def release(self) -> None:
        """Drop every staged block (executor-slot teardown).  The view stays
        usable: the next ``device_block`` restages the same bytes."""
        self._dev.clear()


class PanelStore:
    """Host-resident residualized phenotype panel, tiled on the trait axis.

    The store residualizes + standardizes the panel in fixed ``quantum``-wide
    column chunks on ``device`` (peak device footprint during setup: one
    ``(N, quantum)`` slice), keeps the float32 results host-side, and serves
    device-resident block slices through a small LRU.  The chunk
    decomposition is the same regardless of ``trait_block``, so blocked and
    unblocked stores hold bitwise-identical panels.  Staged slices are the
    identical host float32 bytes.  ``device_view`` hands each executor slot
    its own LRU over the same host panel; the store's own ``device_block``
    is the default view on the scan's device.
    """

    def __init__(self, blocks: list[TraitBlock], panel: np.ndarray,
                 *, device: torch.device, max_resident: int = 4):
        self.blocks = list(blocks)
        self._panel = panel               # (N, P) float32, host
        self.device = torch.device(device)
        self.max_resident = max_resident
        self._default = PanelView(self, device=self.device, max_resident=max_resident)

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

    @property
    def host_panel(self) -> np.ndarray:
        """The whole residualized ``(N, P)`` float32 panel, host-side."""
        return self._panel

    def host_block(self, block: TraitBlock) -> np.ndarray:
        return self._panel[:, block.lo : block.hi]

    def device_block(self, block: TraitBlock) -> torch.Tensor:
        """Device tensor for one block on the scan's device (the serial
        executor's path; see ``PanelView``)."""
        return self._default.device_block(block)

    def cache_stats(self) -> dict:
        """The shared default view's staging-LRU counters."""
        return self._default.cache_stats()

    def device_view(self, device: torch.device | None = None, *,
                    max_resident: int | None = None) -> PanelView:
        """A per-executor-slot view staging blocks onto ``device``.

        ``device=None`` returns the store's shared default view (not a fresh
        LRU): the serial executor and its look-ahead then hit one cache."""
        if device is None:
            return self._default
        return PanelView(
            self, device=device,
            max_resident=self.max_resident if max_resident is None else max_resident,
        )


class PanelPrefetcher:
    """Single-worker look-ahead on the trait axis: stage block b+1 while the
    device chews on block b.  Results land in the thread-safe ``DeviceLRU``,
    so the consumer's own ``stage`` call finds them resident.  Best-effort: a
    staging error is swallowed here and surfaces on the consumer's
    synchronous call for the same block.  ``stream`` is the executor slot's
    CUDA stream: the worker issues its copies there, in order with the
    slot's steps (``None``: the thread's default stream)."""

    def __init__(self, stage: Callable[[Any, TraitBlock], Any], *, name: str = "panel-prefetch",
                 stream: "torch.cuda.Stream | None" = None):
        self._stage = stage
        self._stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True, name=name)
        self._worker.start()

    def _run(self) -> None:
        with on_stream(self._stream):
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
