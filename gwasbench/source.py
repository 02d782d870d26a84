"""A genotype source that presents a long scan over one short ``.bed`` file.

Virtual marker ``i`` is file marker ``i mod period``.  Reads go through the
port's ``PlinkBed`` (a memmap of the file), and every virtual range has a
packed-cache key of its own, so the port's packed-slab cache sees no more
reuse than in a scan whose markers are all distinct.
"""
from __future__ import annotations

import numpy as np


class CycledIds:
    """Lazy marker ids of the virtual scan: ``<file id>.<cycle>``."""

    def __init__(self, ids: list[str], n: int):
        self._ids, self._n = ids, int(n)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> str:
        i = int(i)
        if not 0 <= i < self._n:
            raise IndexError(i)
        cycle, j = divmod(i, len(self._ids))
        return f"{self._ids[j]}.{cycle}"


class CycledSource:
    """The ``GenotypeSource`` protocol over ``bed`` cycled to ``n_markers``."""

    supports_packed = True

    def __init__(self, bed, n_markers: int):
        self.bed = bed
        self.period = int(bed.n_markers)
        self.n_markers = int(n_markers)
        self.n_samples = bed.n_samples
        self.sample_ids = bed.sample_ids
        self.marker_ids = CycledIds(bed.marker_ids, n_markers)

    def _pieces(self, lo: int, hi: int):
        if not 0 <= lo <= hi <= self.n_markers:
            raise IndexError(f"[{lo}, {hi}) outside [0, {self.n_markers})")
        while lo < hi:
            f = lo % self.period
            take = min(hi - lo, self.period - f)
            yield f, f + take
            lo += take

    def read_packed(self, lo: int, hi: int) -> np.ndarray:
        parts = [self.bed.read_packed(a, b) for a, b in self._pieces(lo, hi)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def read_dosages(self, lo: int, hi: int) -> np.ndarray:
        return np.concatenate([self.bed.read_dosages(a, b) for a, b in self._pieces(lo, hi)])

    def packed_cache_key(self) -> tuple:
        return ("cycled", self.period, self.bed.packed_cache_key())
