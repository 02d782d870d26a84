"""Session-level per-cell timing and throughput (the ROADMAP
"session progress/metrics" item).

``ScanSession.events()`` is the one loop every consumer drives, so the
metrics hook lives there: each completed grid cell records a
``CellTiming`` — wall time, extent, and which executor slot computed it —
into the session's ``ScanMetrics``.  Three surfaces read it:

    CLI        a live progress line (cells done, markers/s, device count)
    summary    ``summary.json``'s ``metrics`` block via ``summary()``
    gwasbench  window deltas of ``summary()`` (its per-layer metrics)

While ``runtime.spans`` records, ``summary()`` also carries the spans and
counters recorded since the session began (its ``spans`` block).

Timing is observational only: recording happens after the cell's arrays
are materialized (the commit/writer path forces that synchronization
anyway), so the hook never adds device syncs of its own.  Replayed
(checkpoint) cells are recorded but excluded from throughput — they cost
one ``np.load``, not a device step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from repro_torch.runtime import spans as _spans

__all__ = ["CellTiming", "ScanMetrics"]


@dataclass(frozen=True)
class CellTiming:
    """One grid cell's accounting row."""

    batch_index: int
    block_index: int
    n_markers: int
    n_traits: int
    wall_s: float              # compute + payload materialization
    # Executor slot label: "serial", "dev<i>", or — under a distributed
    # scheduler backend — host-qualified "<host_id>/dev<i>", since N
    # processes share one grid and a bare slot index is ambiguous.
    device: str = "-"
    replayed: bool = False     # loaded from a checkpoint shard, not computed
    # wall_s split (DESIGN.md §13): device step (dispatch .. results ready)
    # vs host payload extraction (D2H pulls + hit globalization).  Both 0.0
    # when the executor did not measure the split (checkpoint replay).
    step_s: float = 0.0
    extract_s: float = 0.0
    # Upstream host stages (DESIGN.md §15): genotype decode
    # (``prepare_batch``) and the H2D staging copy.  Attributed to the cell
    # that *first* used the batch/staged arrays; 0.0 for cells reusing a
    # still-staged batch, for replay, and when a pipeline overlapped the
    # stage entirely off the critical path.  These are NOT components of
    # ``wall_s`` — a pipelined executor pays them concurrently with another
    # cell's step, which is exactly what their per-device totals make
    # visible.
    decode_s: float = 0.0
    stage_s: float = 0.0
    # Bytes of host batch payload staged over H2D for this cell, attributed
    # like ``stage_s`` (first cell per fresh staging, 0 on reuse/replay).
    # The observable packed genotype staging (DESIGN.md §17) drives down
    # ~16x: ceil(N/4) packed bytes/marker vs 4N decoded float32.
    h2d_bytes: int = 0


class ScanMetrics:
    """Fold of a session's ``CellTiming`` rows, cheap enough to keep always
    on.  ``wall_s`` is the stream's wall clock (``start()`` .. ``finish()``),
    against which per-device busy time yields utilization."""

    def __init__(self, n_cells_total: int = 0):
        self.n_cells_total = n_cells_total
        self._t0: float | None = None
        self.wall_s = 0.0
        # Running folds only — no per-cell row retention, so the metrics
        # footprint and the per-cell progress hook are both O(1) no matter
        # how many grid cells a paper-scale scan streams.
        self.cells_done = 0
        self._live_cells = 0
        self._live_batches: set[int] = set()
        self._markers = 0
        self._trait_markers = 0
        self._step_s = 0.0
        self._extract_s = 0.0
        self._decode_s = 0.0
        self._stage_s = 0.0
        self._h2d_bytes = 0
        self._per_device: dict[str, dict] = {}     # label -> cells/busy_s/...
        # Serve-mode observability (repro.serve): per-request wall-clock
        # latencies (requests are few relative to cells, so retaining them
        # for exact percentiles is cheap), a queue-depth gauge, and cache
        # counter snapshots (device-state slots, panel blocks).
        self._request_lat: dict[str, list[float]] = {}
        self._queue_depth = 0
        self._caches: dict[str, dict] = {}
        self._spans_base = _spans.snapshot()

    # ------------------------------------------------------------ recording

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def record(self, row: CellTiming) -> None:
        self.start()
        self.cells_done += 1
        if not row.replayed:
            self._live_cells += 1
            if row.batch_index not in self._live_batches:
                self._live_batches.add(row.batch_index)
                self._markers += row.n_markers
            self._trait_markers += row.n_markers * row.n_traits
            self._step_s += row.step_s
            self._extract_s += row.extract_s
            self._decode_s += row.decode_s
            self._stage_s += row.stage_s
            self._h2d_bytes += row.h2d_bytes
            d = self._per_device.setdefault(
                row.device,
                {"cells": 0, "busy_s": 0.0, "decode_s": 0.0, "stage_s": 0.0,
                 "h2d_bytes": 0},
            )
            d["cells"] += 1
            d["busy_s"] += row.wall_s
            d["decode_s"] += row.decode_s
            d["stage_s"] += row.stage_s
            d["h2d_bytes"] += row.h2d_bytes

    def finish(self) -> None:
        """Freeze the stream's wall clock — once.  The session calls this
        when the live stream ends and again after checkpoint replay; only
        the first call sticks, so replay (np.load, not compute) never
        dilutes the reported throughput."""
        if self._t0 is not None and self.wall_s == 0.0:
            self.wall_s = time.perf_counter() - self._t0

    # ------------------------------------------------------------ serve mode

    def record_request(self, wall_s: float, *, kind: str = "panel") -> None:
        """One served request's end-to-end latency (admission to final
        result), bucketed by request kind (``panel`` upload vs resident
        ``window`` query — their cost profiles differ by design)."""
        self._request_lat.setdefault(kind, []).append(float(wall_s))

    def set_queue_depth(self, depth: int) -> None:
        """Gauge: work items pending + leased on the serve queue."""
        self._queue_depth = int(depth)

    def set_cache_stats(self, name: str, stats: dict) -> None:
        """Counter snapshot of one warm cache (``device_state`` slots,
        ``panel`` blocks) — taken from ``DeviceLRU.stats()``."""
        self._caches[name] = dict(stats)

    @staticmethod
    def _percentile(xs: list[float], q: float) -> float:
        """Linear-interpolated percentile of a non-empty sample."""
        s = sorted(xs)
        if len(s) == 1:
            return s[0]
        pos = (len(s) - 1) * q
        lo = int(pos)
        frac = pos - lo
        hi = min(lo + 1, len(s) - 1)
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def request_latency(self, kind: str | None = None) -> dict | None:
        """p50/p95/p99/max/mean over recorded request walls (one kind, or
        all kinds pooled); ``None`` until a request completes."""
        if kind is None:
            xs = [x for v in self._request_lat.values() for x in v]
        else:
            xs = list(self._request_lat.get(kind, ()))
        if not xs:
            return None
        return {
            "n": len(xs),
            "p50_s": round(self._percentile(xs, 0.50), 4),
            "p95_s": round(self._percentile(xs, 0.95), 4),
            "p99_s": round(self._percentile(xs, 0.99), 4),
            "max_s": round(max(xs), 4),
            "mean_s": round(sum(xs) / len(xs), 4),
        }

    def serve_summary(self) -> dict | None:
        """The ``summary()`` ``serve`` block; ``None`` when this metrics
        object never saw serve traffic."""
        if not self._request_lat and not self._caches:
            return None
        by_kind = {
            kind: self.request_latency(kind) for kind in sorted(self._request_lat)
        }
        return {
            "requests": sum(len(v) for v in self._request_lat.values()),
            "latency": self.request_latency(),
            "latency_by_kind": by_kind,
            "queue_depth": self._queue_depth,
            "caches": dict(self._caches),
        }

    # -------------------------------------------------------------- reading

    def markers_done(self) -> int:
        """Distinct markers computed live (each batch counted once, however
        many trait blocks it swept)."""
        return self._markers

    def trait_markers_done(self) -> int:
        """Total (marker x trait) statistics computed live — the unit the
        paper's throughput claim is denominated in."""
        return self._trait_markers

    def extract_share(self) -> float | None:
        """Measured fraction of busy time spent in payload extraction
        (D2H + host epilogue work) rather than the device step — the
        observable the sparse epilogue (DESIGN.md §13) drives down.  None
        until an executor that measures the split has recorded a cell."""
        busy = self._step_s + self._extract_s
        if busy <= 0:
            return None
        return self._extract_s / busy

    def _wall(self) -> float:
        if self.wall_s > 0:
            return self.wall_s
        return time.perf_counter() - self._t0 if self._t0 is not None else 0.0

    def summary(self) -> dict:
        """The ``summary.json`` ``metrics`` block."""
        wall = self._wall()
        per_device = {
            label: {
                "cells": d["cells"],
                "busy_s": round(d["busy_s"], 4),
                "utilization": round(d["busy_s"] / wall, 3) if wall > 0 else None,
                "decode_s": round(d.get("decode_s", 0.0), 4),
                "stage_s": round(d.get("stage_s", 0.0), 4),
                "h2d_bytes": d.get("h2d_bytes", 0),
            }
            for label, d in self._per_device.items()
        }
        markers = self.markers_done()
        tm = self.trait_markers_done()
        share = self.extract_share()
        serve = self.serve_summary()
        extra = {"serve": serve} if serve is not None else {}
        spans = _spans.summary(self._spans_base)
        if spans is not None:
            extra["spans"] = spans
        return {
            **extra,
            "cells": self.cells_done,
            "cells_total": self.n_cells_total,
            "live_cells": self._live_cells,
            "replayed_cells": self.cells_done - self._live_cells,
            "wall_s": round(wall, 4),
            "markers_per_s": round(markers / wall, 1) if wall > 0 else None,
            "trait_markers_per_s": round(tm / wall, 1) if wall > 0 else None,
            "step_s": round(self._step_s, 4),
            "extract_s": round(self._extract_s, 4),
            "decode_s": round(self._decode_s, 4),
            "stage_s": round(self._stage_s, 4),
            "h2d_bytes": self._h2d_bytes,
            "h2d_bytes_per_marker": (
                round(self._h2d_bytes / markers, 1) if markers > 0 else None
            ),
            "extract_share": round(share, 3) if share is not None else None,
            "per_device": per_device,
        }

    def progress_line(self) -> str:
        """One-line human rendering for the CLI progress hook; O(1) — it
        runs once per cell."""
        wall = time.perf_counter() - self._t0 if self._t0 is not None else 0.0
        rate = self.markers_done() / wall if wall > 0 else 0.0
        total = f"/{self.n_cells_total}" if self.n_cells_total else ""
        share = self.extract_share()
        tail = f"  extract {share:.0%}" if share is not None else ""
        host = self._decode_s + self._stage_s
        if host > 0 and self._step_s > 0:
            tail += f"  decode+stage {host / self._step_s:.0%} of step"
        return (
            f"[scan] {self.cells_done}{total} cells  "
            f"{rate:,.0f} markers/s  {len(self._per_device) or 1} device(s)"
            f"{tail}"
        )
