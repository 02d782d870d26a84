"""The readers of the port's spans (``gwasbench/spans.py`` and the six
metrics built on it), on window snapshots made by hand: each is the
window's change in a span total over the cells the spans cover, and None
where the program recorded no spans (an untraced run, or a program without
them)."""
from __future__ import annotations

import os

import pytest

from gwasbench import harness
from gwasbench import run as entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN_METRICS = ["refine_ms_per_cell", "pull_ms_per_cell", "d2h_mib_per_cell",
                "batch_wait_ms_per_cell", "product_ms_per_cell", "epilogue_ms_per_cell"]


def _block(cells, scale, *, device=True, waits=True):
    by = {"extract": {"n": cells, "total_s": 0.2 * cells * scale},
          "step": {"n": cells, "total_s": 0.18 * cells * scale},
          "refine": {"n": 2 * cells, "total_s": 0.15 * cells * scale},
          "pull": {"n": 9 * cells, "total_s": 0.004 * cells * scale},
          "product": {"n": cells, "total_s": 0.001 * cells * scale},
          "epilogue": {"n": cells, "total_s": 0.01 * cells * scale}}
    if device:
        by["product"]["device_s"] = 0.152 * cells * scale
        by["epilogue"]["device_s"] = 0.025 * cells * scale
    if waits:
        by["batch_wait"] = {"n": cells, "total_s": 0.002 * cells * scale}
    return {"by_name": by, "counters": {"d2h_bytes": 3 * 2**18 * cells}}


def _run(start, end) -> harness.Run:
    cell = harness.load_cell("ols_dense_p20k", ROOT)
    return harness.Run(cell, window_cells=50, metrics_start=start, metrics_end=end)


def test_span_readers_read_the_windows_change():
    # 4 cells before the window's open, 24 at its last counted cell: 20 traced
    run = _run({"step_s": 1.0, "spans": _block(4, 1.0)}, {"step_s": 9.0, "spans": _block(24, 1.0)})
    read = entry.read_metric
    assert read("refine_ms_per_cell", run) == pytest.approx(150.0)
    assert read("pull_ms_per_cell", run) == pytest.approx(4.0)
    assert read("d2h_mib_per_cell", run) == pytest.approx(0.75)
    assert read("batch_wait_ms_per_cell", run) == pytest.approx(2.0)
    assert read("product_ms_per_cell", run) == pytest.approx(152.0)
    assert read("epilogue_ms_per_cell", run) == pytest.approx(25.0)
    # the window opened before the program recorded: no block at its open
    late = _run({"step_s": 1.0}, {"step_s": 9.0, "spans": _block(20, 1.0)})
    assert read("refine_ms_per_cell", late) == pytest.approx(150.0)
    # spans without device times (the CPU), and no wait for a batch at all
    cpu = _run({}, {"spans": _block(10, 1.0, device=False, waits=False)})
    assert read("product_ms_per_cell", cpu) is None and read("epilogue_ms_per_cell", cpu) is None
    assert read("batch_wait_ms_per_cell", cpu) == 0.0
    assert read("refine_ms_per_cell", cpu) == pytest.approx(150.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_give_none_without_spans(name):
    run = _run({"step_s": 1.0, "extract_s": 0.5}, {"step_s": 9.0, "extract_s": 2.5})
    assert entry.read_metric(name, run) is None
