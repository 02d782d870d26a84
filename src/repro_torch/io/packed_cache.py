"""Shared packed-slab host cache (DESIGN.md §17).

One process-wide LRU of raw 2-bit genotype slabs keyed by
``(source identity, marker range)``, so every consumer of the same cohort —
the scan's `prepare_batch`, the streamed GRM pass, `repro.serve` warm
windows, and checkpoint-resume re-preps — performs **one** disk read per
batch instead of one per consumer.  Entries are read-only materialized
copies (a memmap view would pin the page cache but re-fault per consumer;
a materialized slab is ceil(N/4) bytes/marker, 16x smaller than f32, so a
default 256 MiB budget holds ~1M markers of a 4k-sample cohort).

Source identity comes from ``source.packed_cache_key()`` — stable across
source *instances* over the same files (realpath/size/mtime), which is what
makes serve's per-request sources and resumed scans hit.  Sources without a
stable identity (in-memory, synthetic) bypass the cache transparently.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

__all__ = ["PackedSlabCache", "default_cache", "configure_default", "read_packed_cached"]


class PackedSlabCache:
    """Thread-safe LRU over packed genotype slabs with a bytes budget."""

    def __init__(self, capacity_bytes: int = 256 << 20):
        if capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._slabs: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bypasses = 0

    def read(self, source, lo: int, hi: int) -> np.ndarray:
        """``source.read_packed(lo, hi)`` through the cache.

        Returns a read-only slab; callers must not mutate it (the scan and
        GRM only ever stage it to device).
        """
        key_fn = getattr(source, "packed_cache_key", None)
        if key_fn is None:
            with self._lock:
                self.bypasses += 1
            return np.asarray(source.read_packed(lo, hi))
        key = (key_fn(), int(lo), int(hi))
        with self._lock:
            slab = self._slabs.get(key)
            if slab is not None:
                self._slabs.move_to_end(key)
                self.hits += 1
                return slab
            self.misses += 1
        # Read outside the lock: concurrent DecodePool workers may race on a
        # miss and read twice; both insert the same bytes, which is benign.
        slab = np.array(source.read_packed(lo, hi), dtype=np.uint8, copy=True)
        slab.setflags(write=False)
        with self._lock:
            if key not in self._slabs and slab.nbytes <= self.capacity_bytes:
                self._slabs[key] = slab
                self._bytes += slab.nbytes
                self._evict_locked()
        return slab

    def _evict_locked(self) -> None:
        while self._bytes > self.capacity_bytes and self._slabs:
            _, old = self._slabs.popitem(last=False)
            self._bytes -= old.nbytes
            self.evictions += 1

    def resize(self, capacity_bytes: int) -> None:
        with self._lock:
            self.capacity_bytes = int(capacity_bytes)
            self._evict_locked()

    def clear(self) -> None:
        with self._lock:
            self._slabs.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._slabs),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "bypasses": self.bypasses,
            }


_default = PackedSlabCache()


def default_cache() -> PackedSlabCache:
    return _default


def configure_default(capacity_mb: int) -> PackedSlabCache:
    """Resize the shared cache (``--packed-cache-mb``).  Resizing preserves
    resident slabs that still fit, so a serve process re-planning per request
    keeps its warm windows."""
    _default.resize(int(capacity_mb) << 20)
    return _default


def read_packed_cached(source, lo: int, hi: int) -> np.ndarray:
    return _default.read(source, lo, hi)
