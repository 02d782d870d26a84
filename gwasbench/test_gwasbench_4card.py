"""The four-card cell (``ols_dense_p20k_4card``) on the CPU: whole harness
runs with four executor slots sharing the CPU, at ``test_gwasbench_runs.py``'s
sizes, held against the float64 reference; a fault on one slot's thread is
refused; and the cell's two executor readers on window snapshots made by
hand.  A ``gpu``-marked case repeats the sound run on four cards."""
from __future__ import annotations

import dataclasses
import os
import threading
import time

import pytest
import torch

from gwasbench import harness
from gwasbench import run as entry
from gwasbench.test_gwasbench_runs import SMALL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD = "ols_dense_p20k_4card"


def _cell() -> harness.Cell:
    cell = harness.load_cell(WORKLOAD)
    cfg = dict(cell.config, **SMALL)
    traffic = dict(cell.traffic, n_traits=64, n_planted=32, planted_effect=[0.25, 0.45])
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def _run(device_type="cpu", seconds=3.0):
    return harness.run_cell(_cell(), seed=2**31 + 91, seconds=seconds, trace_on=False,
                            t_process=time.perf_counter(), device_type=device_type)


def test_the_cell_is_ols_dense_on_four_slots_with_the_executor_defaults():
    from repro_torch.api import ExecSpec

    one, four = harness.load_cell("ols_dense_p20k"), harness.load_cell(WORKLOAD)
    assert four.chips == four.config["devices"] == 4 and four.traffic == one.traffic
    same = {k: v for k, v in one.config.items() if k not in ("source", "deployment", "devices")}
    assert {k: four.config[k] for k in same} == same and set(four.config) == set(one.config)
    # the deployment the configuration states is ExecSpec's defaults
    spec = ExecSpec()
    assert (spec.backend, spec.placement, spec.lease_batches, spec.slot_prefetch,
            spec.autotune_lease) == ("threads", "marker-major", 2, 1, True)
    for word in ("threads backend", "marker-major", "lease_batches 2", "slot_prefetch 1",
                 "autotune on"):
        assert word in four.config["deployment"]


def test_four_slots_are_correct_and_every_slot_fills_the_window():
    run, verdict = _run()
    assert verdict.correct, verdict.numbers
    assert verdict.cells > 0 and run.window_cells > 0
    start, end = run.metrics_start["per_device"], run.metrics_end["per_device"]
    assert sorted(end) == ["dev0", "dev1", "dev2", "dev3"]
    for label in end:
        assert end[label]["cells"] > start.get(label, {}).get("cells", 0), label
    assert run.executor_info["kind"] == "multi-device" and run.executor_info["devices"] == 4


def test_a_fault_on_one_slot_is_not_correct(monkeypatch):
    from repro_torch.core import engines

    sparse = engines.sparse_epilogue_outputs
    faulted = []

    def hit_r_altered_on_slot_2(r, t, dof, plan, **kw):
        out = sparse(r, t, dof, plan, **kw)
        if threading.current_thread().name == "scan-device-2":
            faulted.append(1)
            out["hit_r"] = torch.where(out["hit_idx"] >= 0, out["hit_r"] + 1e-3, out["hit_r"])
        return out

    monkeypatch.setattr(engines, "sparse_epilogue_outputs", hit_r_altered_on_slot_2)
    _, verdict = _run(seconds=0.5)
    assert faulted and not verdict.correct, verdict.numbers
    assert 0 < verdict.failed_cells < verdict.cells


@pytest.mark.gpu
def test_four_cards_are_correct():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    run, verdict = _run(device_type="cuda")
    assert verdict.correct, verdict.numbers
    assert sorted(run.metrics_end["per_device"]) == ["dev0", "dev1", "dev2", "dev3"]


# ------------------------------------------------------------ the readers


def _block(cells, *, claims, batch_wait=0.0, tail_wait=0.0, result_wait=0.0):
    by = {"extract": {"n": cells, "total_s": 0.002 * cells},
          "step": {"n": cells, "total_s": 0.18 * cells}}
    if claims:
        by["claim"] = {"n": claims, "total_s": 1e-4 * claims}
    for name, s in (("batch_wait", batch_wait), ("tail_wait", tail_wait),
                    ("result_wait", result_wait)):
        if s:
            by[name] = {"n": cells, "total_s": s}
    return {"by_name": by, "counters": {}}


def _fake(start, end, seconds=10.0) -> harness.Run:
    cell = harness.load_cell(WORKLOAD, ROOT)
    return harness.Run(cell, seconds=seconds, window_cells=200, metrics_start=start,
                       metrics_end=end)


READERS = ["executor_wait_pct", "result_wait_ms_per_cell"]


@pytest.mark.parametrize("name", READERS)
def test_executor_readers_give_none_without_the_executor_spans(name):
    untraced = _fake({"step_s": 1.0}, {"step_s": 9.0})
    serial = _fake({}, {"spans": _block(40, claims=0, batch_wait=0.5)})
    assert entry.read_metric(name, untraced) is None
    assert entry.read_metric(name, serial) is None


@pytest.mark.parametrize("name", READERS)
def test_executor_readers_read_zero_without_waits(name):
    run = _fake({}, {"spans": _block(40, claims=0)})
    run.metrics_end["spans"]["by_name"]["claim"] = {"n": 24, "total_s": 0.0}
    assert entry.read_metric(name, run) == 0.0


def test_executor_readers_read_the_windows_change():
    # 8 cells before the window's open, 208 at its last counted cell
    start = {"spans": _block(8, claims=8, batch_wait=0.01, tail_wait=0.02, result_wait=0.1)}
    end = {"spans": _block(208, claims=108, batch_wait=0.41, tail_wait=1.22, result_wait=2.1)}
    run = _fake(start, end)
    # claims 100 x 0.1 ms, batch 0.4 s, tail 1.2 s, over 10 s x 4 cards
    assert entry.read_metric("executor_wait_pct", run) == pytest.approx(100 * 1.61 / 40)
    assert entry.read_metric("result_wait_ms_per_cell", run) == pytest.approx(10.0)
    short = _fake(start, end, seconds=5.0)   # a scan that ended inside the window
    assert entry.read_metric("executor_wait_pct", short) == pytest.approx(100 * 1.61 / 20)
