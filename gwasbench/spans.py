"""The port's own spans over the window (``repro_torch.runtime.spans``).

From the first cell after a torch profiler starts (a ``--trace 1`` run's
window opens it) to the scan's end, the port records a span at each layer
boundary of the scan and folds them into the ``spans`` block of
``ScanMetrics.summary()``: per name ``n``, ``total_s``, ``self_s`` and, for
the spans it brackets with CUDA events (``prolog``, ``product``,
``epilogue``), ``device_s``; and the counters (``d2h_bytes``).  The
window's snapshots of that summary (``Run.metrics_start``,
``Run.metrics_end``) hold the totals at its open and at its last counted
cell, so their difference covers the cells of the window's other
``ScanMetrics`` deltas.  A program without spans, or an untraced run, has
no block: every reading is then None.
"""
from __future__ import annotations


def _block(snap: dict) -> dict | None:
    return snap.get("spans")


def recorded(run) -> bool:
    return _block(run.metrics_end) is not None


def delta(run, name: str, key: str = "total_s") -> float:
    """The window's change in one total of span ``name``."""
    def get(snap):
        return float(((_block(snap) or {}).get("by_name") or {}).get(name, {}).get(key, 0.0))
    return get(run.metrics_end) - get(run.metrics_start)


def counter(run, name: str) -> float:
    def get(snap):
        return float(((_block(snap) or {}).get("counters") or {}).get(name, 0))
    return get(run.metrics_end) - get(run.metrics_start)


def cells(run) -> float:
    """Cells whose extraction the spans cover (one ``extract`` span a
    cell)."""
    return delta(run, "extract", "n") if recorded(run) else 0.0


def ms_per_cell(run, name: str, key: str = "total_s") -> float | None:
    """Milliseconds of span ``name`` a cell; None without spans, or where
    the span (or, for ``device_s``, its device time) was not recorded."""
    n = cells(run)
    if n <= 0 or delta(run, name, "n") <= 0:
        return None
    if key == "device_s" and delta(run, name, "device_s") <= 0:
        return None
    return 1e3 * delta(run, name, key) / n
