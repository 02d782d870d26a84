"""The port's span recorder (``runtime.spans``) and its spans inside the scan.

Off, a call site reads no clock and records nothing; on, spans nest per
thread (parent, self time, counters, the cell), record from any thread, and
follow a running ``torch.profiler``.  In a scan, serial and on the
two-slot multi-device executor, every live cell has one ``step`` and one
``extract`` span whose totals are ``ScanMetrics``' ``step_s`` and
``extract_s``, the decodes run on worker threads and the extractions on the
slot tails; the outputs are bitwise the same with recording on and off; and
the spans share the profiler's clock.  On four slots every claim of a worker
is a ``claim`` span, and a put onto the consumer's full results queue a
``result_wait`` span; with recording off nothing is recorded.
``gpu``-marked cases check the clock and the CUDA-event device times on a
card.
"""
from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.api import ExecSpec, GridSpec, Study
from repro_torch.api.session import _SlotTail
from repro_torch.core import stats
from repro_torch.io import plink, synth
from repro_torch.runtime import spans
from repro_torch.runtime.prefetch import DecodePool, Prefetcher

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.stop()
    spans.take()
    yield
    spans.stop()
    spans.take()


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    cohort = synth.make_cohort(n_samples=300, n_markers=400, n_traits=8, n_causal=6,
                               effect_size=0.6, missing_rate=0.02, seed=11)
    files = synth.write_cohort_files(cohort, str(tmp_path_factory.mktemp("spans") / "toy"))
    return Study.from_arrays(plink.PlinkBed(files["bed"]), cohort.phenotypes,
                             cohort.covariates, device="cpu")


def _scan(study, *, devices=1, multivariate=False, device="cpu", record=True):
    plan = study.plan(device=device, multivariate=multivariate,
                      grid=GridSpec(batch_markers=96, block_p=4),
                      executor=ExecSpec(devices=devices))
    plan.prepare()
    session = plan.run(resume=False)
    if record:
        spans.start()
    try:
        cells = [(c.batch_index, c.block_index, c.payload()) for c in session.events()]
    finally:
        spans.stop()
    return session, sorted(cells, key=lambda c: c[:2]), spans.take()


# ------------------------------------------------------------------ recorder


def test_off_reads_no_clock_and_records_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with recording off")

    monkeypatch.setattr(spans.time, "time_ns", no_clock)
    before = spans.snapshot()
    with spans.span("step", batch=1, block=2) as sp:
        with spans.span("pull"):
            spans.count("d2h_bytes", 10)
    spans.follow_profiler()       # no profiler runs: stays off
    with spans.span("step"):
        pass
    assert sp is None
    assert spans.snapshot() == before and spans.take() == []
    assert spans.summary(before) is None


def test_nesting_parent_self_time_cells_and_counters():
    base = spans.snapshot()
    spans.start()
    with spans.span("extract", batch=3, block=1):
        time.sleep(0.01)
        with spans.span("pull"):
            spans.count("d2h_bytes", 100)
            time.sleep(0.02)
        with spans.span("pull"):
            spans.count("d2h_bytes", 28)
    with spans.span("decode", batch=4):
        pass
    spans.count("d2h_bytes", 1)          # outside any span: the total only
    spans.stop()
    recs = spans.take()
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
    (ext,), pulls, (dec,) = by["extract"], by["pull"], by["decode"]
    assert [p["parent"] for p in pulls] == ["extract", "extract"] and ext["parent"] is None
    assert [p["cell"] for p in pulls] == [(3, 1), (3, 1)] and dec["cell"] == 4
    assert [p["counters"] for p in pulls] == [{"d2h_bytes": 100}, {"d2h_bytes": 28}]
    assert ext["counters"] == {}
    assert all(p["t0_ns"] >= ext["t0_ns"] and p["t1_ns"] <= ext["t1_ns"] for p in pulls)
    block = spans.summary(base)
    child = sum(p["t1_ns"] - p["t0_ns"] for p in pulls) / 1e9
    e = block["by_name"]["extract"]
    assert e["n"] == 1 and e["self_s"] == pytest.approx(e["total_s"] - child, abs=2e-6)
    assert e["self_s"] >= 0.009 and block["by_name"]["pull"]["total_s"] >= 0.019
    assert block["by_name"]["pull"]["self_s"] == block["by_name"]["pull"]["total_s"]
    assert block["counters"] == {"d2h_bytes": 129}


def test_summary_is_the_change_since_a_snapshot():
    first = spans.snapshot()
    spans.start()
    with spans.span("refine"):
        pass
    base = spans.snapshot()
    assert spans.summary(base) is None
    for _ in range(3):
        with spans.span("refine"):
            pass
    spans.stop()
    with spans.span("refine"):     # off again: not counted
        pass
    assert spans.summary(base)["by_name"]["refine"]["n"] == 3
    assert spans.summary(first)["by_name"]["refine"]["n"] == 4
    assert len(spans.take()) == 4 and spans.take() == []


def test_records_from_several_threads():
    """More threads than cores on a short switch interval: a lost update
    of the totals, the counters or the record buffer would show."""
    import os
    import sys

    n_threads, per = 2 * (os.cpu_count() or 2) + 2, 200
    base = spans.snapshot()
    spans.start()
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait()
        for _ in range(per):
            with spans.span("decode", batch=i):
                with spans.span("pull"):
                    spans.count("d2h_bytes", i)

    threads = [threading.Thread(target=work, args=(i,), name=f"w-{i}") for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans.stop()
    recs = spans.take()
    assert len(recs) == 2 * n_threads * per
    assert {r["thread_name"] for r in recs} == {f"w-{i}" for i in range(n_threads)}
    assert len({r["thread"] for r in recs}) == n_threads
    for r in recs:
        if r["name"] == "pull":
            assert r["parent"] == "decode" and r["thread_name"] == f"w-{r['cell']}"
    block = spans.summary(base)
    assert block["by_name"]["decode"]["n"] == block["by_name"]["pull"]["n"] == n_threads * per
    assert block["counters"] == {"d2h_bytes": per * n_threads * (n_threads - 1) // 2}


def test_recording_follows_a_running_profiler():
    from torch.profiler import ProfilerActivity, profile

    spans.follow_profiler()
    with spans.span("step") as off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        spans.follow_profiler()
        with spans.span("step") as on:
            pass
    spans.follow_profiler()          # stays on after the profiler, ...
    with spans.span("step") as after:
        pass
    spans.follow_profiler(end=True)  # ... to the scan's end
    with spans.span("step") as ended:
        pass
    assert off is None and on is not None and after is not None and ended is None
    # only start() keeps records; the profiler's spans reach the totals
    assert spans.take() == []
    spans.start()
    spans.follow_profiler(end=True)  # start() holds recording on
    with spans.span("step") as held:
        pass
    assert held is not None


def test_a_profiled_scan_records_from_the_next_cell_to_its_end(study):
    from torch.profiler import ProfilerActivity, profile

    plan = study.plan(device="cpu", grid=GridSpec(batch_markers=96, block_p=4))
    session = plan.run(resume=False)
    base = spans.snapshot()
    prof = profile(activities=[ProfilerActivity.CPU])
    for i, _ in enumerate(session.events()):
        if i == 1:
            prof.__enter__()
        elif i == 2:
            prof.__exit__(None, None, None)
    block = spans.summary(base)
    assert block["by_name"]["step"]["n"] == block["by_name"]["extract"]["n"] == 3
    with spans.span("step") as after:
        pass
    assert after is None


def test_program_span_holds_the_profilers_host_record():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    spans.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with spans.span("epilogue"):
                x = x * 1.0001
    spans.stop()
    recs = spans.take()
    muls = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                  if e.name() == "aten::mul")
    ends = sorted(e.start_ns() + e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.name() == "aten::mul")
    assert len(muls) == len(recs) == 20
    for r, s, e in zip(sorted(recs, key=lambda r: r["t0_ns"]), muls, ends):
        assert r["t0_ns"] <= s and e <= r["t1_ns"]


# --------------------------------------------------------- waits of the host


def test_prefetcher_consumer_wait_is_a_batch_wait():
    spans.start()
    out = list(Prefetcher(range(3), lambda i: (time.sleep(0.02), i)[1], depth=1,
                          num_workers=1))
    spans.stop()
    waits = [r for r in spans.take() if r["name"] == "batch_wait"]
    assert out == [0, 1, 2] and len(waits) >= 2
    assert {r["thread_name"] for r in waits} == {threading.current_thread().name}
    assert sum(r["t1_ns"] - r["t0_ns"] for r in waits) >= 0.03e9


def test_decode_pool_result_wait_is_a_batch_wait():
    pool = DecodePool(lambda i: (time.sleep(0.05), i * 2)[1], num_workers=1)
    try:
        spans.start()
        pool.submit("a", 3)
        assert pool.result("a") == 6
        pool.submit("b", 4)
        time.sleep(0.15)             # landed before it is asked for: no wait
        assert pool.result("b") == 8
        with pytest.raises(KeyError):
            pool.result("never")
        spans.stop()
    finally:
        pool.shutdown()
    waits = [r for r in spans.take() if r["name"] == "batch_wait"]
    assert len(waits) == 2 and waits[0]["t1_ns"] - waits[0]["t0_ns"] >= 0.03e9


def test_full_slot_tail_is_a_tail_wait():
    stop = threading.Event()
    gate = threading.Event()
    tail = _SlotTail(stop=stop, on_error=lambda e: None, name="slot-tail-x")
    try:
        spans.start()
        tail.submit(gate.wait)
        while not tail._q.empty():   # the tail thread holds the blocked task
            time.sleep(0.001)
        for _ in range(4):           # fills the queue behind the blocked task
            tail.submit(lambda: None)
        threading.Timer(0.1, gate.set).start()
        tail.submit(lambda: None)    # waits for the tail to take one
        spans.stop()
    finally:
        gate.set()
        tail.close()
    waits = [r for r in spans.take() if r["name"] == "tail_wait"]
    assert len(waits) == 1 and waits[0]["t1_ns"] - waits[0]["t0_ns"] >= 0.05e9


def test_refine_waits_for_the_lock_in_refine_wait():
    t = np.linspace(-8, 8, 300).astype(np.float32)
    held = threading.Event()

    def hold():
        with stats._REFINE_LOCK:
            held.set()
            time.sleep(0.1)

    spans.start()
    h = threading.Thread(target=hold)
    h.start()
    held.wait()
    got = stats.refine_neglog10p(t, 100.0)
    h.join()
    spans.stop()
    recs = {r["name"]: r for r in spans.take()}
    np.testing.assert_array_equal(got, stats._refine(t, 100.0, stats.REFINE_WIDTH))
    assert recs["refine_wait"]["t1_ns"] - recs["refine_wait"]["t0_ns"] >= 0.05e9
    assert recs["refine"]["t0_ns"] >= recs["refine_wait"]["t1_ns"]


# -------------------------------------------------------------------- scans


@pytest.mark.parametrize("devices", [1, 2])
def test_scan_spans_match_the_scan_metrics(study, devices):
    session, cells, recs = _scan(study, devices=devices)
    m = session.metrics.summary()
    live = {(b, k) for b, k, _ in cells}
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
    for name in ("step", "extract"):
        assert sorted(r["cell"] for r in by[name]) == sorted(live)
        assert m["spans"]["by_name"][name]["total_s"] == pytest.approx(m[f"{name}_s"], abs=2e-4)
    for name in ("prolog", "product", "epilogue"):
        assert [r["parent"] for r in by[name]] == ["step"] * len(live)
    assert {r["cell"] for r in by["refine"]} == live
    assert {r["parent"] for r in by["refine"] + by["pull"]} == {"extract"}
    assert {r["thread_name"].rsplit("-", 1)[0] for r in by["decode"]} == (
        {"prefetch-worker"} if devices == 1 else {"slot-decode"})
    extractors = {r["thread_name"] for r in by["extract"]}
    steppers = {r["thread_name"] for r in by["step"]}
    if devices == 1:
        assert extractors == steppers == {threading.current_thread().name}
    else:
        assert extractors == {"slot-tail-0", "slot-tail-1"} or extractors <= {
            "slot-tail-0", "slot-tail-1"}
        assert steppers <= {"scan-device-0", "scan-device-1"}
    # nothing left the CPU: every emitted value took the host refine, and
    # every cell's product the library GEMM
    counters = m["spans"]["counters"]
    assert set(counters) == {"refine_lanes_host", "product_cells_library"}
    assert counters["refine_lanes_host"] > 0
    assert counters["product_cells_library"] == len(live)


@pytest.mark.parametrize("multivariate", [False, True])
def test_cpu_scan_counts_every_cell_on_the_library_route(study, multivariate):
    """A CPU scan (packed staging, the paper's dof) multiplies every cell
    with the library GEMM: ``product_cells_library`` counts its cells, one
    ``product`` span each, and the kernel route never engages."""
    session, cells, recs = _scan(study, multivariate=multivariate)
    assert session.prepared.ctx.genotype_staging == "packed"
    counters = session.metrics.summary()["spans"]["counters"]
    assert counters["product_cells_library"] == len(cells) > 1
    assert "product_cells_kernel" not in counters
    product = [r for r in recs if r["name"] == "product"]
    assert [r["counters"] for r in product] == [{"product_cells_library": 1}] * len(cells)


@pytest.mark.parametrize("multivariate", [False, True])
def test_outputs_are_bitwise_the_same_with_spans_on(study, multivariate):
    _, on, recs = _scan(study, multivariate=multivariate)
    session, off, none = _scan(study, multivariate=multivariate, record=False)
    assert recs and none == [] and "spans" not in session.metrics.summary()
    assert [c[:2] for c in on] == [c[:2] for c in off]
    for (_, _, a), (_, _, b) in zip(on, off):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _toy_study(tmp_path, *, n_markers):
    cohort = synth.make_cohort(n_samples=120, n_markers=n_markers, n_traits=4, n_causal=2,
                               effect_size=0.6, seed=3)
    files = synth.write_cohort_files(cohort, str(tmp_path / "toy"))
    return Study.from_arrays(plink.PlinkBed(files["bed"]), cohort.phenotypes,
                             cohort.covariates, device="cpu")


def _four_slot_events(study, *, batch_markers, record=True, pause_after_first=0.0):
    """A four-slot CPU scan's cells, its session and the records; the
    consumer sleeps ``pause_after_first`` seconds after the first cell."""
    plan = study.plan(device="cpu", grid=GridSpec(batch_markers=batch_markers, block_p=4),
                      executor=ExecSpec(devices=4))
    plan.prepare()
    session = plan.run(resume=False)
    if record:
        spans.start()
    try:
        cells = []
        for c in session.events():
            if not cells:
                time.sleep(pause_after_first)
            cells.append((c.batch_index, c.block_index))
    finally:
        spans.stop()
    return session, cells, spans.take()


def test_four_slot_scan_records_its_claims(tmp_path):
    study = _toy_study(tmp_path, n_markers=200)
    session, cells, recs = _four_slot_events(study, batch_markers=20)
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
    claimed = sum(w["claimed"] for w in session.executor_info["workers"].values())
    # every claim that found an item, and each slot's last, empty one
    assert len(by["claim"]) >= claimed + 4 and claimed > 0
    assert {r["thread_name"] for r in by["claim"]} <= {f"scan-device-{i}" for i in range(4)}
    assert {r["parent"] for r in by["claim"]} == {None}
    assert sorted(r["cell"] for r in by["extract"]) == sorted(cells) and len(cells) == 10
    # ten cells and four slots' ends never fill the results queue (4 x 4)
    assert "result_wait" not in by
    assert session.metrics.summary()["spans"]["by_name"]["claim"]["n"] == len(by["claim"])


def test_a_slow_consumer_is_a_result_wait(tmp_path):
    study = _toy_study(tmp_path, n_markers=480)
    # 60 cells: the fleet fills the 16-deep queue while the consumer sleeps
    _, cells, recs = _four_slot_events(study, batch_markers=8, pause_after_first=2.0)
    waits = [r for r in recs if r["name"] == "result_wait"]
    assert len(cells) == 60 and waits
    assert {r["thread_name"].rsplit("-", 1)[0] for r in waits} == {"slot-tail"}
    assert max(r["t1_ns"] - r["t0_ns"] for r in waits) >= 0.2e9


def test_four_slot_scan_records_nothing_with_spans_off(tmp_path):
    study = _toy_study(tmp_path, n_markers=200)
    before = spans.snapshot()
    session, cells, recs = _four_slot_events(study, batch_markers=20, record=False)
    assert len(cells) == 10 and recs == [] and spans.snapshot() == before
    assert "spans" not in session.metrics.summary()


def test_cli_trace_spans_writes_the_spans_block(tmp_path):
    from repro_torch.launch.gwas import main

    cohort = synth.make_cohort(n_samples=200, n_markers=150, n_traits=4, n_causal=3,
                               effect_size=0.6, seed=5)
    files = synth.write_cohort_files(cohort, str(tmp_path / "toy"))
    argv = ["scan", "--genotypes", files["bed"], "--pheno", files["pheno"], "--covar",
            files["cov"], "--device", "cpu", "--batch-markers", "64"]
    main(argv + ["--out", str(tmp_path / "on"), "--trace-spans"])
    main(argv + ["--out", str(tmp_path / "off")])
    with open(tmp_path / "on" / "summary.json") as fh:
        on = json.load(fh)["metrics"]
    with open(tmp_path / "off" / "summary.json") as fh:
        off = json.load(fh)["metrics"]
    assert "spans" not in off and on["spans"]["by_name"]["step"]["n"] == 3
    assert {"decode", "step", "extract", "refine", "pull", "deliver"} <= set(
        on["spans"]["by_name"])
    assert spans.take() == []


# ------------------------------------------------------------------ on a card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA activity and events exist only there")


@pytest.mark.gpu
def test_card_launches_and_device_times_fall_in_their_spans(study):
    """On a card the kernels' launch records lie inside their program spans
    on the profiler's clock, and a scan's dense-step spans carry the card's
    time between their CUDA events, as the profiler sees their kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _card()
    x = torch.randn(4096, 4096, device="cuda")
    x = (x @ x) * 1e-3               # the library's set-up, outside the spans
    torch.cuda.synchronize()
    spans.start()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            # milliseconds of work a span: the card never waits for the host
            # inside one, so the events' interval is its kernels' time
            with spans.span("product", device_of=x):
                x = (x @ x) * 1e-3
        torch.cuda.synchronize()
    spans.stop()
    recs = sorted(spans.take(), key=lambda r: r["t0_ns"])
    evs = list(prof.profiler.kineto_results.events())
    launches = sorted(e.start_ns() for e in evs if e.device_type() != DeviceType.CUDA
                      and e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    kernels = [e for e in evs if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()]
    assert len(recs) == 10 and len(launches) >= 20
    for t in launches:
        assert any(r["t0_ns"] <= t <= r["t1_ns"] for r in recs), t
    kernel_s = sum(e.duration_ns() for e in kernels) / 1e9
    device_s = sum(r["device_ns"] for r in recs) / 1e9
    assert kernel_s <= device_s * 1.02 and device_s <= kernel_s * 1.1

    cuda_study = Study.from_arrays(study.source, np.asarray(study.phenotypes),
                                   study.covariates, device="cuda")
    session, _, _ = _scan(cuda_study, device="cuda")
    block = session.metrics.summary()["spans"]
    for name in ("prolog", "product", "epilogue"):
        assert block["by_name"][name]["device_s"] > 0
    assert block["counters"]["d2h_bytes"] > 0
    # packed staging on a card: every cell's product is a gwas_dot call
    assert block["counters"]["product_cells_kernel"] == block["by_name"]["product"]["n"]
    assert "product_cells_library" not in block["counters"]
