"""Multi-file genotype source: N per-chromosome shards, one global index.

Real cohorts ship split by chromosome (``cohort_chr1.bed .. cohort_chr22.bed``
— the layout UK Biobank, imputation servers, and qctool all emit), so the
scan must treat a fileset as one contiguous marker axis.  ``MultiFileSource``
wraps any mix of backends behind the unchanged ``GenotypeSource`` protocol:

    n_samples, n_markers, sample_ids, marker_ids
    read_dosages(lo, hi) / read_packed(lo, hi)   — global marker indexing

plus ``shard_boundaries``, which ``runtime.prefetch.BatchPlanner`` uses to
keep every scan batch inside one file: each work item is then a single
contiguous read from a single container, and the prefetch worker pool
streams batches from *different* chromosomes concurrently (DESIGN.md §3).

All shards must agree on the sample axis (count and ids, in order) —
per-chromosome filesets of one cohort always do; anything else is a data
bug worth failing loudly on.
"""
from __future__ import annotations

import glob as _glob
import os
import re
from typing import Any, Sequence

import numpy as np

__all__ = ["MultiFileSource", "natural_key", "expand_genotype_paths"]


def natural_key(path: str) -> tuple:
    """Numeric-aware sort key so ``chr2`` orders before ``chr10``."""
    return tuple(
        int(tok) if tok.isdigit() else tok.lower()
        for tok in re.split(r"(\d+)", path)
    )


def expand_genotype_paths(spec: str) -> list[str]:
    """``'a.bed,b.bed'`` or ``'cohort_chr*.bed'`` -> ordered path list."""
    if "," in spec:
        return [p.strip() for p in spec.split(",") if p.strip()]
    # A literal file whose name contains glob metacharacters wins over
    # pattern interpretation (e.g. 'data[2024].bed').
    if any(ch in spec for ch in "*?[") and not os.path.exists(spec):
        matches = sorted(_glob.glob(spec), key=natural_key)
        if not matches:
            raise FileNotFoundError(f"genotype glob matched nothing: {spec}")
        return matches
    return [spec]


def _describe(source: Any) -> str:
    """Short identity for error messages (dataclass reprs embed whole
    sample/marker tables)."""
    for attr in ("path", "bed_path"):
        p = getattr(source, attr, None)
        if p:
            return str(p)
    return type(source).__name__


class MultiFileSource:
    """Concatenate genotype shards along the marker axis (samples shared)."""

    def __init__(self, sources: Sequence[Any]):
        if not sources:
            raise ValueError("MultiFileSource needs at least one shard")
        self.sources = list(sources)
        first = self.sources[0]
        for s in self.sources[1:]:
            if s.n_samples != first.n_samples:
                raise ValueError(
                    f"shard sample counts differ: {first.n_samples} vs {s.n_samples} "
                    f"({_describe(s)})"
                )
            if list(s.sample_ids) != list(first.sample_ids):
                raise ValueError(
                    "shard sample ids differ or are reordered; per-chromosome "
                    "filesets of one cohort must share the sample axis"
                )
        self.n_samples = first.n_samples
        self.sample_ids = list(first.sample_ids)
        counts = [s.n_markers for s in self.sources]
        self.shard_boundaries: tuple[int, ...] = tuple(np.cumsum([0] + counts).tolist())
        self.n_markers = self.shard_boundaries[-1]
        self.marker_ids: list[str] = []
        for s in self.sources:
            self.marker_ids.extend(s.marker_ids)

    @property
    def n_shards(self) -> int:
        return len(self.sources)

    @property
    def supports_packed(self) -> bool:
        """Packed staging needs every shard to speak native 2-bit bytes
        (rows are ceil(N/4) bytes for all shards, so slabs concatenate)."""
        return all(getattr(s, "supports_packed", False) for s in self.sources)

    def packed_cache_key(self) -> tuple:
        keys = []
        for s in self.sources:
            fn = getattr(s, "packed_cache_key", None)
            if fn is None:
                raise ValueError(f"{_describe(s)} has no stable packed identity")
            keys.append(fn())
        return ("multi", tuple(keys))

    def _segments(self, lo: int, hi: int) -> list[tuple[int, int, int]]:
        """Split global [lo, hi) into (shard_id, local_lo, local_hi) runs."""
        if not (0 <= lo <= hi <= self.n_markers):
            raise IndexError(f"marker range [{lo}, {hi}) outside [0, {self.n_markers})")
        bounds = self.shard_boundaries
        segs: list[tuple[int, int, int]] = []
        sid = int(np.searchsorted(bounds, lo, side="right")) - 1
        while lo < hi:
            base, end = bounds[sid], bounds[sid + 1]
            take = min(hi, end)
            segs.append((sid, lo - base, take - base))
            lo = take
            sid += 1
        return segs

    def read_dosages(self, lo: int, hi: int) -> np.ndarray:
        parts = [self.sources[sid].read_dosages(a, b) for sid, a, b in self._segments(lo, hi)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def read_packed(self, lo: int, hi: int) -> np.ndarray:
        # Rows are ceil(N/4) bytes for every shard (same N), so slabs concat.
        parts = [self.sources[sid].read_packed(a, b) for sid, a, b in self._segments(lo, hi)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
