"""The port's multi-device grid executor (``MultiDeviceExecutor``) on the CPU.

The contract under test is the reference's (``tests/test_executor.py``): the
(marker-batch x trait-block) grid drained by N executor slots through the
work-stealing ``CellScheduler`` produces bitwise the outputs of the port's
serial walk — for the dense, dense exact-dof, fused and lmm (LOCO) engines,
under both placements, unpipelined, and across resumes whose slot count
differs from the run that wrote the checkpoint.  On the CPU the N slots share
the CPU device (the counterpart of the reference's fake host devices), which
runs every thread, queue and lease of the executor; the slots' CUDA streams
are checked on a card only (``gpu``).  The port's multi-slot outputs are also
held against the reference's own multi-device run on 3 fake XLA devices, at
the fused parity tolerances, and its ``executor`` summary block against the
reference's keys.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch.api import ExecSpec, GridSpec, LmmSpec, NpzShardWriter, Study, TsvWriter
from repro_torch.api.session import MultiDeviceExecutor, ScanSession, SerialExecutor
from repro_torch.core.association import AssocOptions
from repro_torch.io import open_genotypes, plink, synth
from repro_torch.runtime.prefetch import MarkerBatch, TraitBlock
from repro_torch.runtime.scheduler import CellScheduler

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("hits.tsv", "per_trait_best.tsv", "qc.tsv")


@pytest.fixture(scope="module")
def source(cohort_files):
    return plink.PlinkBed(cohort_files["bed"])


@pytest.fixture(scope="module")
def study(source, cohort):
    return Study.from_arrays(source, cohort.phenotypes, cohort.covariates, device="cpu")


def _grid(**kw):
    base = dict(batch_markers=128, block_m=64, block_n=128, block_p=4)
    base.update(kw)
    return GridSpec(**base)


def _plan(study, **kw):
    return study.plan(device="cpu", **kw)


def _batches(n, size=10):
    return [
        MarkerBatch(index=i, lo=i * size, hi=(i + 1) * size, source_id=0,
                    local_lo=i * size, local_hi=(i + 1) * size)
        for i in range(n)
    ]


def _blocks(n, width=4):
    return [TraitBlock(index=k, lo=k * width, hi=(k + 1) * width) for k in range(n)]


# ---------------------------------------------------------------- scheduler


def test_scheduler_marker_major_items_sweep_blocks():
    sched = CellScheduler(_batches(3), _blocks(2), placement="marker-major")
    assert sched.n_items == 3 and sched.n_cells == 6
    for run in sched.items:
        assert [k.index for k in run.blocks] == [0, 1]
    assert [run.batch.index for run in sched.items] == [0, 1, 2]


def test_scheduler_trait_major_items_are_block_major_cells():
    sched = CellScheduler(_batches(3), _blocks(2), placement="trait-major")
    assert sched.n_items == 6 and sched.n_cells == 6
    assert [(r.batch.index, r.blocks[0].index) for r in sched.items] == [
        (0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1)
    ]


def test_scheduler_pending_filter_mid_panel():
    pending = {(0, 1), (2, 0), (2, 1)}   # batch 0 half done, batch 1 done
    sched = CellScheduler(_batches(3), _blocks(2), pending)
    assert [(r.batch.index, [k.index for k in r.blocks]) for r in sched.items] == [
        (0, [1]), (2, [0, 1])
    ]
    assert sched.n_cells == 3


def test_scheduler_lease_capped_to_spread_over_workers():
    sched = CellScheduler(_batches(6), _blocks(3), lease_size=2, n_workers=4)
    assert sched.lease_size == 1
    assert all(sched.claim(f"w{i}") is not None for i in range(4))
    assert CellScheduler(_batches(24), _blocks(1), lease_size=2, n_workers=4).lease_size == 2
    assert CellScheduler(_batches(6), _blocks(1), lease_size=4).lease_size == 4


def test_scheduler_rejects_unknown_placement():
    with pytest.raises(ValueError, match="placement"):
        CellScheduler(_batches(1), _blocks(1), placement="diagonal")


def test_scheduler_drains_under_contention():
    sched = CellScheduler(_batches(24), _blocks(3), lease_size=4)
    seen, lock = [], threading.Lock()

    def drain(worker):
        while True:
            claim = sched.claim(worker)
            if claim is None:
                return
            idx, run = claim
            with lock:
                seen.extend((run.batch.index, k.index) for k in run.blocks)
            sched.complete(worker, idx)

    threads = [threading.Thread(target=drain, args=(f"w{i}",)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(seen) == sorted((b, k) for b in range(24) for k in range(3))
    assert len(seen) == len(set(seen))
    assert sched.remaining() == 0


# ------------------------------------------------------------------- specs


def test_exec_spec_validation(study):
    with pytest.raises(ValueError, match="devices"):
        ExecSpec(devices=-1).validate()
    with pytest.raises(ValueError, match="placement"):
        _plan(study, executor=ExecSpec(placement="diag"))
    with pytest.raises(ValueError, match="lease_batches"):
        _plan(study, executor=ExecSpec(lease_batches=0))


def test_exec_spec_roundtrip_and_fingerprint_free():
    from repro_torch.api.specs import ScanConfig

    cfg = ScanConfig.from_specs(
        executor=ExecSpec(devices=4, placement="trait-major", lease_batches=3)
    )
    assert cfg.exec_spec() == ExecSpec(4, "trait-major", 3)
    assert cfg.fingerprint_payload() == ScanConfig().fingerprint_payload()


def test_plan_no_longer_refuses_the_executor(study, tmp_path):
    """``devices != 1`` and ``shared-fs`` plan and run; mesh and the
    multivariate screen stay refused (``tests/test_torch_scan.py``)."""
    _plan(study, grid=_grid(), executor=ExecSpec(devices=2)).run()
    _plan(study, grid=_grid(), checkpoint_dir=str(tmp_path),
          executor=ExecSpec(backend="shared-fs")).run()


def test_more_devices_than_visible_rejected(study, monkeypatch):
    """On CUDA the executor takes cuda:0 .. cuda:N-1 and refuses more slots
    than visible cards, as the reference refuses more than its devices."""
    prep = _plan(study, grid=_grid(), executor=ExecSpec(devices=97)).prepare()
    on_card = dataclasses.replace(prep, device=torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="devices=97"):
        MultiDeviceExecutor(on_card, n_devices=97)
    with pytest.raises(ValueError, match="devices=97"):
        next(ScanSession(on_card).events())
    assert MultiDeviceExecutor(on_card, n_devices=2).devices == [
        torch.device("cuda", 0), torch.device("cuda", 1)
    ]
    # devices=0 means every visible card
    every = dataclasses.replace(
        on_card, config=dataclasses.replace(prep.config, devices=0))
    assert ScanSession(every).n_devices == 2
    # the CPU has no such limit: N slots share it
    assert MultiDeviceExecutor(prep, n_devices=3).devices == [torch.device("cpu")] * 3


def test_custom_step_rejected_under_multi_device(study):
    prep = _plan(study, grid=_grid(), executor=ExecSpec(devices=2)).prepare()
    session = ScanSession(prep, step=lambda *a: {})
    with pytest.raises(ValueError, match="custom step"):
        next(session.events())


def test_custom_step_runs_on_the_serial_walk(study):
    """The ``step=`` seam: a swapped step sees the decoded staging currency
    (the packed bytes go through the same device front as the engine
    prolog), so a pass-through wrapper reproduces the plan's cells."""
    prep = _plan(study, grid=_grid(trait_block=4), engine="fused").prepare()
    assert prep.ctx.genotype_staging == "packed"
    calls = []
    from repro_torch.core.engines import build_fused_step

    plain = build_fused_step(
        n_samples=prep.ctx.n_samples, n_covariates=prep.ctx.n_covariates,
        options=prep.ctx.options, hit_threshold=prep.ctx.hit_threshold,
        block_m=prep.ctx.block_m, block_n=prep.ctx.block_n, block_p=prep.ctx.block_p,
        sparse_epilogue=prep.ctx.sparse_epilogue, hit_capacity=prep.ctx.hit_capacity,
    )

    def swapped(*args):
        calls.append(args[0].shape)
        return plain(*args)

    got = {(c.batch_index, c.block_index): c for c in ScanSession(prep, step=swapped).events()}
    want = {(c.batch_index, c.block_index): c for c in ScanSession(prep).events()}
    assert calls and set(got) == set(want)
    for key, cell in want.items():
        for k, v in cell.arrays.items():
            np.testing.assert_array_equal(got[key].arrays[k], v, err_msg=f"{key}:{k}")


def test_injected_executor_replaces_the_sessions_own(study):
    """The ``executor=`` seam: a pre-built executor handle drains the grid
    in place of the one the session would construct (serial here)."""
    prep = _plan(study, grid=_grid(trait_block=4)).prepare()
    session = ScanSession(prep, executor=MultiDeviceExecutor(prep, n_devices=2))
    cells = list(session.events())
    assert len(cells) == session.n_batches * session.n_trait_blocks
    assert session.executor_info["kind"] == "multi-device"
    assert session.executor_info["devices"] == 2


# ----------------------------------------- executor machinery (one slot)


def _collect(executor, todo, pending=None):
    out = {}
    for cell, timing in executor.cells(todo, pending):
        out[(cell.batch_index, cell.block_index)] = cell
        assert timing.wall_s >= 0 and timing.n_markers == cell.n_markers
    return out


def test_multi_executor_machinery_matches_serial(study):
    plan = _plan(study, grid=_grid(trait_block=4), hit_threshold_nlp=2.0)
    prep = plan.prepare()
    ref = _collect(SerialExecutor(prep), prep.batches)
    for placement in ("marker-major", "trait-major"):
        got = _collect(MultiDeviceExecutor(prep, n_devices=1, placement=placement),
                       prep.batches)
        assert set(got) == set(ref)
        for key, cell in got.items():
            for k, v in ref[key].arrays.items():
                np.testing.assert_array_equal(v, cell.arrays[k], err_msg=f"{key}:{k}")


_PIPELINE_THREADS = ("scan-device", "slot-decode", "slot-tail", "panel-prefetch-dev")


def _leaked_pipeline_threads():
    import time as _time

    for _ in range(50):
        alive = [
            t for t in threading.enumerate()
            if t.name.startswith(_PIPELINE_THREADS) and t.is_alive()
        ]
        if not alive:
            return []
        _time.sleep(0.02)
    return alive


def test_multi_executor_propagates_worker_errors(study):
    prep = _plan(study, grid=_grid(trait_block=4)).prepare()
    ex = MultiDeviceExecutor(prep, n_devices=1)
    boom_calls = {"n": 0}
    real_prepare = prep.engine.prepare_batch

    def exploding(source, batch, ctx):
        boom_calls["n"] += 1
        if boom_calls["n"] > 1:
            raise RuntimeError("decode exploded")
        return real_prepare(source, batch, ctx)

    prep.engine.prepare_batch = exploding
    try:
        with pytest.raises(RuntimeError, match="decode exploded"):
            list(ex.cells(prep.batches, None))
    finally:
        prep.engine.prepare_batch = real_prepare
    assert not _leaked_pipeline_threads()


def _break(site, monkeypatch):
    """Make one thread of the slot pipeline raise ``RuntimeError(site)``: a
    slot's worker (the step), its tail (payload extraction), its panel
    look-ahead, or the shared decode pool.  The look-ahead is best-effort,
    as in the reference: it swallows its own error, and the worker's
    synchronous staging of the same block raises it.  Returns the names of
    the threads that raised."""
    import repro_torch.api.session as session_mod
    from repro_torch.core import engines, panels

    raised = []

    def boom(*a, **k):
        raised.append(threading.current_thread().name)
        raise RuntimeError(site)

    if site == "step":
        monkeypatch.setattr(session_mod._Slot, "step", boom)
    elif site == "tail":
        monkeypatch.setattr(session_mod, "_live_cell", boom)
    elif site == "prefetch":
        real = panels.PanelStore.host_block

        def host_block(self, block):
            # block 0 stages on the worker; block 1 first on the look-ahead
            return boom() if block.index > 0 else real(self, block)

        monkeypatch.setattr(panels.PanelStore, "host_block", host_block)
    elif site == "decode":
        monkeypatch.setattr(engines.DenseEngine, "prepare_batch", boom)
    return raised


@pytest.mark.parametrize("site", ["step", "tail", "prefetch", "decode"])
def test_thread_errors_end_the_cli_scan(site, cohort_files, tmp_path, monkeypatch):
    """An error on a slot's worker, tail, panel look-ahead or decode thread
    reaches the consumer and ends ``gwas scan --devices 2``: nothing drops to
    the CPU or to a serial walk, and no pipeline thread outlives the scan."""
    from repro_torch.launch.gwas import main

    raised = _break(site, monkeypatch)
    with pytest.raises(RuntimeError, match=site):
        main(["scan", "--genotypes", cohort_files["bed"], "--pheno", cohort_files["pheno"],
              "--covar", cohort_files["cov"], "--out", str(tmp_path / "out"),
              "--device", "cpu", "--batch-markers", "128", "--trait-block", "4",
              "--block-p", "4", "--devices", "2"])
    thread = {"step": "scan-device", "tail": "slot-tail", "prefetch": "panel-prefetch-dev",
              "decode": "slot-decode"}[site]
    assert any(name.startswith(thread) for name in raised), raised
    assert not (tmp_path / "out" / "summary.json").exists()
    assert not _leaked_pipeline_threads()


def test_tail_error_exits_nonzero(cohort_files, tmp_path):
    """The same through a process: a tail-thread error gives a nonzero exit
    and no summary."""
    code = textwrap.dedent(
        """
        import sys
        import repro_torch.api.session as s

        def boom(*a, **k):
            raise RuntimeError("tail exploded")

        s._live_cell = boom
        from repro_torch.launch.gwas import main
        main(sys.argv[1:])
        """
    )
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, "scan", "--genotypes", cohort_files["bed"],
         "--pheno", cohort_files["pheno"], "--covar", cohort_files["cov"],
         "--out", str(out), "--device", "cpu", "--devices", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode != 0
    assert "tail exploded" in proc.stderr
    assert not (out / "summary.json").exists()


def test_multi_executor_early_close_joins_workers(study):
    prep = _plan(study, grid=_grid(trait_block=4)).prepare()
    gen = MultiDeviceExecutor(prep, n_devices=1).cells(prep.batches, None)
    next(gen)
    gen.close()
    assert not _leaked_pipeline_threads()


def test_pipelined_teardown_releases_slots_mid_stream(study, monkeypatch):
    import repro_torch.api.session as session_mod

    prep = _plan(study, grid=_grid(trait_block=4)).prepare()
    resets = []
    real_reset = session_mod._Slot.reset

    def spy(self):
        resets.append(self.label)
        return real_reset(self)

    monkeypatch.setattr(session_mod._Slot, "reset", spy)
    ex = MultiDeviceExecutor(prep, n_devices=1, slot_prefetch=2)
    gen = ex.cells(prep.batches, None)
    next(gen)
    gen.close()
    assert resets
    assert not _leaked_pipeline_threads()


def test_panel_view_release_drops_staged_blocks(study):
    prep = _plan(study, grid=_grid(trait_block=4)).prepare()
    view = prep.panels.device_view(torch.device("cpu"))
    assert view is not prep.panels.device_view(None)
    assert prep.panels.device_view(None) is prep.panels.device_view()
    blk = prep.trait_blocks[0]
    before = view.device_block(blk).clone()
    assert len(view._dev) == 1
    view.pin_block(blk)
    assert view.cache_stats()["pinned"] == 1
    view.unpin_block(blk)
    view.release()
    assert len(view._dev) == 0
    assert torch.equal(view.device_block(blk), before)
    assert torch.equal(prep.panels.device_block(blk), before)
    assert view.cache_stats()["misses"] == 2


def test_slot_device_state_places_its_own_tensors(study):
    """``make_device_state(device=...)``: a slot's state carries its own
    device context and a step of its own; ``device=None`` is the serial
    slot on the plan's step."""
    prep = _plan(study, grid=_grid(), options=AssocOptions(dof_mode="exact")).prepare()
    serial = prep.engine.make_device_state(prep.ctx, step=prep.step)
    assert serial.step is prep.step and serial.ctx is prep.ctx
    slot = prep.engine.make_device_state(prep.ctx, device=torch.device("cpu"))
    assert slot.step is not prep.step and slot.device == torch.device("cpu")
    assert torch.equal(slot.ctx.q_basis, prep.ctx.q_basis)


def test_refine_is_bitwise_under_concurrent_callers():
    """Slot tails refine concurrently: under more threads than cores and a
    short switch interval, each caller gets the bits a lone call gives."""
    from repro_torch.core import stats

    rng = np.random.default_rng(11)
    t = (rng.standard_normal(5000) * 4).astype(np.float32)
    want = stats.refine_neglog10p(t, 398.0).tobytes()
    n_threads = 2 * (os.cpu_count() or 4)
    got, errors = [], []

    def work():
        try:
            for _ in range(2):
                got.append(stats.refine_neglog10p(t, 398.0).tobytes())
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors and len(got) == 2 * n_threads
    assert all(g == want for g in got)


# ----------------------------------------------------------------- metrics


def test_session_metrics_recorded(study):
    session = _plan(study, grid=_grid(trait_block=4)).run()
    seen = []
    session.progress = lambda m: seen.append(m.cells_done)
    cells = list(session.events())
    m = session.metrics
    assert m.cells_done == len(cells) == session.n_batches * session.n_trait_blocks
    assert seen == list(range(1, len(cells) + 1))
    s = m.summary()
    assert s["cells"] == s["live_cells"] == len(cells)
    assert s["replayed_cells"] == 0
    assert s["markers_per_s"] > 0 and s["trait_markers_per_s"] > 0
    assert set(s["per_device"]) == {"serial"}
    assert s["per_device"]["serial"]["cells"] == len(cells)
    assert m.markers_done() == session.n_markers
    assert "cells" in m.progress_line()
    assert session.executor_info == {"kind": "serial", "devices": 1, "device": "cpu"}


def test_multi_slot_metrics_per_device(study):
    session = _plan(study, grid=_grid(trait_block=4), executor=ExecSpec(devices=2)).run()
    cells = list(session.events())
    s = session.metrics.summary()
    assert s["live_cells"] == len(cells) == session.n_batches * session.n_trait_blocks
    assert set(s["per_device"]) <= {"dev0", "dev1"}
    assert all("decode_s" in v and "stage_s" in v for v in s["per_device"].values())
    assert s["decode_s"] > 0
    info = session.executor_info
    assert info["kind"] == "multi-device" and info["devices"] == 2
    assert sum(w["completed"] for w in info["workers"].values()) > 0


def test_session_metrics_separate_replayed_cells(study, tmp_path):
    ck = str(tmp_path / "ck")
    kw = dict(grid=_grid(trait_block=4), checkpoint_dir=ck)
    list(_plan(study, **kw).run().events())
    session = _plan(study, executor=ExecSpec(devices=2), **kw).run()
    cells = list(session.events())
    assert all(c.replayed for c in cells)
    s = session.metrics.summary()
    assert s["live_cells"] == 0 and s["replayed_cells"] == len(cells)
    assert s["markers_per_s"] == 0.0


# ----------------------------------------------- out-of-order cell folding


def test_best_trait_fold_is_completion_order_invariant():
    from repro_torch.core.sinks import BestTraitSink

    a = (np.asarray([2.5, 0.0, 3.0], np.float32), np.asarray([1, 0, 2], np.int32), 0)
    b = (np.asarray([2.5, 0.0, 1.0], np.float32), np.asarray([4, 0, 0], np.int32), 100)
    for order in ([a, b], [b, a]):
        sink = BestTraitSink(3)
        for best, row, lo in order:
            sink._fold(best, row, lo, 0)
        np.testing.assert_array_equal(sink.best_nlp, [2.5, 0.0, 3.0])
        np.testing.assert_array_equal(sink.best_marker, [1, -1, 2])


def test_session_cells_fold_identically_in_any_order(study, source, tmp_path):
    from repro_torch.api.session import CheckpointReplay

    ck = str(tmp_path / "ck")
    session = _plan(study, grid=_grid(trait_block=4), hit_threshold_nlp=1.0,
                    checkpoint_dir=ck).run()
    ref_dir = tmp_path / "ref"
    session.stream_to(TsvWriter(str(ref_dir)))
    ref = {f: (ref_dir / f).read_text() for f in FILES}
    replay = CheckpointReplay(ck, marker_ids=source.marker_ids, trait_names=study.trait_names)
    cells = list(replay.events())
    rng = np.random.default_rng(0)
    for trial in range(3):
        out = tmp_path / f"perm{trial}"
        w = TsvWriter(str(out))
        w.open(replay)
        for i in rng.permutation(len(cells)):
            w.write(cells[i])
        w.close()
        assert {f: (out / f).read_text() for f in FILES} == ref


# ----------------------- multi-slot semantics (the reference's child cases)


@pytest.fixture(scope="module")
def split_study(tmp_path_factory):
    """The reference child script's cohort: N=200, M=400 in 3 PLINK shards
    (so LOCO has scopes), P=12 in blocks of 4."""
    co = synth.make_cohort(n_samples=200, n_markers=400, n_traits=12, n_causal=4, seed=5)
    beds = synth.write_split_plink(co, str(tmp_path_factory.mktemp("split") / "toy"),
                                   n_shards=3)
    return Study.from_arrays(open_genotypes(",".join(beds)), co.phenotypes,
                             co.covariates, device="cpu")


SPLIT_GRID = GridSpec(batch_markers=128, block_m=64, block_n=128, block_p=4, trait_block=4)
CASES = {
    "dense": {},
    "dense_exact": {"options": AssocOptions(dof_mode="exact")},
    "fused": {"engine": "fused"},
    "lmm_loco": {"engine": "lmm", "lmm": LmmSpec(loco=True)},
}


def _read(out):
    """Every file a scan wrote (TSV text, npz arrays by bytes) plus its
    lambda_gc."""
    got = {}
    for name in sorted(os.listdir(out)):
        path = os.path.join(out, name)
        if name.endswith(".npz"):
            with np.load(path) as z:
                got[name] = {k: (z[k].dtype.str, z[k].tobytes()) for k in z.files}
        else:
            with open(path, "rb") as f:
                got[name] = f.read()
    return got


def _scan(study, out, *, executor=None, checkpoint_dir=None, **kw):
    session = _plan(study, grid=SPLIT_GRID, hit_threshold_nlp=2.0, executor=executor,
                    checkpoint_dir=checkpoint_dir, **kw).run()
    summary = session.stream_to(TsvWriter(str(out)), NpzShardWriter(str(out)))
    got = _read(str(out))
    got["lambda_gc"] = summary["lambda_gc"]
    return got, session


@pytest.fixture(scope="module")
def serial_runs(split_study, tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            out = tmp_path_factory.mktemp(f"serial_{name}")
            cache[name] = _scan(split_study, out, **CASES[name])[0]
        return cache[name]

    return get


@pytest.mark.parametrize("engine", list(CASES))
def test_multi_slot_bitwise_identical(engine, split_study, serial_runs, tmp_path):
    got, session = _scan(split_study, tmp_path / "md",
                         executor=ExecSpec(devices=8 if engine == "fused" else 3),
                         **CASES[engine])
    assert got == serial_runs(engine)
    assert session.executor_info["kind"] == "multi-device"
    assert len(session.executor_info["workers"]) >= 2
    assert len(session.metrics.summary()["per_device"]) >= 2


def test_trait_major_placement_bitwise_identical(split_study, serial_runs, tmp_path):
    got, session = _scan(split_study, tmp_path / "tm", executor=ExecSpec(
        devices=4, placement="trait-major", lease_batches=1))
    assert got == serial_runs("dense")
    assert session.executor_info["placement"] == "trait-major"


def test_unpipelined_bitwise_identical(split_study, serial_runs, tmp_path):
    """slot_prefetch=0 (one staged batch, no tail or look-ahead threads) and
    the pipelined default give the same bytes."""
    got, session = _scan(split_study, tmp_path / "unp", executor=ExecSpec(
        devices=3, slot_prefetch=0, autotune_lease=False))
    assert got == serial_runs("dense")
    assert session.executor_info["slot_prefetch"] == 0
    assert session.executor_info["autotune"]["enabled"] is False


def test_autotune_and_pipeline_reported(split_study, tmp_path):
    _, session = _scan(split_study, tmp_path / "at", executor=ExecSpec(devices=3))
    at = session.executor_info["autotune"]
    assert at["enabled"] is True
    assert at["initial_lease"] >= 1 and at["final_lease"] >= 1
    assert at["final_lease"] <= at["initial_lease"]
    assert at["adjustments"] >= 0
    assert session.executor_info["slot_prefetch"] == 1
    md = session.metrics.summary()
    assert all("decode_s" in v and "stage_s" in v for v in md["per_device"].values())
    assert md["decode_s"] > 0


def test_resume_across_slot_counts(split_study, tmp_path):
    """A full 2-slot checkpointed run, cut by one whole batch plus a
    mid-panel cell, resumed on 4 slots under trait-major placement: the same
    bytes, every cell exactly once."""
    ck = str(tmp_path / "ck")
    full, _ = _scan(split_study, tmp_path / "full", executor=ExecSpec(devices=2),
                    checkpoint_dir=ck)
    mpath = os.path.join(ck, "manifest.json")
    with open(mpath) as f:
        mani = json.load(f)
    lost = [k for k in mani["completed"] if k.startswith("1.")] + ["2.1"]
    for k in lost:
        mani["completed"].pop(k)
    with open(mpath, "w") as f:
        json.dump(mani, f)
    resumed, session = _scan(split_study, tmp_path / "resumed",
                             executor=ExecSpec(devices=4, placement="trait-major"),
                             checkpoint_dir=ck)
    assert resumed == full
    m = session.metrics.summary()
    assert m["replayed_cells"] > 0 and m["live_cells"] == len(lost)
    assert m["replayed_cells"] + m["live_cells"] == session.n_batches * session.n_trait_blocks


# ------------------------------------------------ against the reference


_REF_CHILD = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
    import json, sys
    from repro.api import ExecSpec, GridSpec, Study, TsvWriter

    bed, pheno, cov, out_root = sys.argv[1:5]
    study = Study.from_files(bed, pheno, cov)
    grid = GridSpec(batch_markers=128, block_m=64, block_n=128, block_p=4, trait_block=4)
    info = {}
    for engine in ("dense", "fused"):
        session = study.plan(engine=engine, grid=grid, executor=ExecSpec(devices=3)).run()
        out = os.path.join(out_root, engine)
        summary = session.stream_to(TsvWriter(out))
        with open(os.path.join(out, "summary.json"), "w") as f:
            json.dump({"lambda_gc": summary["lambda_gc"]}, f)
        info[engine] = len(session.metrics.summary()["per_device"])
    print(json.dumps(info))
    """
)


@pytest.fixture(scope="module")
def reference_multi_device(cohort_files, tmp_path_factory):
    """One reference run of the dense and fused engines on 3 fake XLA host
    devices (a subprocess: this process must keep seeing one)."""
    pytest.importorskip("jax")
    root = tmp_path_factory.mktemp("ref_md")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_CHILD, cohort_files["bed"], cohort_files["pheno"],
         cohort_files["cov"], str(root)],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(root),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    used = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(n >= 2 for n in used.values()), used
    return root


@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_multi_slot_matches_reference_multi_device(engine, cohort_files,
                                                   reference_multi_device, tmp_path):
    """The port's 3-slot scan against the reference's 3-device scan on the
    same files: the parity tolerances of ``tests/test_torch_scan.py``."""
    from test_torch_scan import _assert_outputs_close

    study = Study.from_files(cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"])
    session = study.plan(engine=engine, device="cpu", executor=ExecSpec(devices=3),
                         grid=GridSpec(batch_markers=128, block_m=64, block_n=128,
                                       block_p=4, trait_block=4)).run()
    out = tmp_path / "port"
    summary = session.stream_to(TsvWriter(str(out)))
    with open(out / "summary.json", "w") as f:
        json.dump({"lambda_gc": summary["lambda_gc"]}, f)
    assert len(session.metrics.summary()["per_device"]) >= 2
    _assert_outputs_close(str(out), str(reference_multi_device / engine))


def test_executor_summary_block_has_the_reference_keys(cohort_files, tmp_path):
    """``summary.json``'s ``executor`` block: the reference's keys at every
    level (autotune, per-worker stats, host_id under shared-fs), from both
    CLIs on the same files with ``--exec-backend shared-fs``, and without
    ``host_id`` under the threads backend."""
    pytest.importorskip("jax")
    from repro.launch.gwas import main as ref_main
    from repro_torch.launch.gwas import main

    common = ["--genotypes", cohort_files["bed"], "--pheno", cohort_files["pheno"],
              "--covar", cohort_files["cov"], "--batch-markers", "128",
              "--exec-backend", "shared-fs", "--host-id", "h0"]
    ref_main(["scan", *common, "--out", str(tmp_path / "ref"),
              "--checkpoint-dir", str(tmp_path / "ref_ck")])
    main(["scan", *common, "--out", str(tmp_path / "port"), "--device", "cpu",
          "--checkpoint-dir", str(tmp_path / "port_ck")])
    blocks = {}
    for name in ("ref", "port"):
        with open(tmp_path / name / "summary.json") as f:
            blocks[name] = json.load(f)["executor"]
    ref, port = blocks["ref"], blocks["port"]
    assert set(port) == set(ref)
    assert set(port["autotune"]) == set(ref["autotune"])
    worker_keys = {frozenset(w) for w in ref["workers"].values()}
    assert {frozenset(w) for w in port["workers"].values()} == worker_keys
    assert list(port["workers"]) == ["h0/dev0"] == list(ref["workers"])
    assert port["host_id"] == "h0" and port["backend"] == "shared-fs"

    main(["scan", *common[:-4], "--out", str(tmp_path / "threads"), "--device", "cpu",
          "--devices", "2"])
    with open(tmp_path / "threads" / "summary.json") as f:
        threads = json.load(f)["executor"]
    assert set(threads) == set(ref) - {"host_id"}
    assert {frozenset(w) for w in threads["workers"].values()} == worker_keys


# ------------------------------------------------------------- on the card


def _stream_audit(monkeypatch):
    """Record, for every staging copy, kernel launch and device-to-host pull,
    the calling thread and the current CUDA stream of the tensor's device."""
    from repro_torch.core import engines, panels, sinks
    from repro_torch.kernels import tstat
    from repro_torch.kernels.gwas_dot import gwas_dot

    seen = []

    def spy(mod, name, device_of):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            dev = device_of(*a, **k)
            if dev is not None and dev.type == "cuda":
                seen.append((name, threading.current_thread().name,
                             torch.cuda.current_stream(dev).cuda_stream))
            return real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    spy(engines, "to_device", lambda arr, device: device)
    spy(panels, "to_device", lambda arr, device: device)
    spy(sinks, "_host", lambda x: x.device if isinstance(x, torch.Tensor) else None)
    spy(gwas_dot, "gwas_dot_fused", lambda packed, *a, **k: packed.device)
    spy(tstat, "compact_survivors", lambda t, *a, **k: t.device)
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["fused", "dense"])
def test_slot_stream_on_card(engine, cohort_files, tmp_path, monkeypatch):
    """On a card a slot's staging, kernels and pulls all run on the slot's
    own (non-default) stream, from its worker, look-ahead and tail threads,
    and the output equals the serial scan on the default stream bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: slot streams exist only on a card")
    study = Study.from_files(cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"],
                             device="cuda")
    kw = dict(engine=engine, device="cuda", grid=GridSpec(batch_markers=128, trait_block=4,
                                                          block_p=4))
    serial = study.plan(**kw).run().stream_to(TsvWriter(str(tmp_path / "serial")))
    seen = _stream_audit(monkeypatch)
    session = study.plan(executor=ExecSpec(devices=1, backend="shared-fs"),
                         checkpoint_dir=str(tmp_path / "ck"), **kw).run()
    multi = session.stream_to(TsvWriter(str(tmp_path / "multi")))
    assert multi["lambda_gc"] == serial["lambda_gc"]
    assert _read(str(tmp_path / "multi")) == _read(str(tmp_path / "serial"))
    default = torch.cuda.default_stream(torch.device("cuda", 0)).cuda_stream
    slot_work = [s for s in seen if s[1].startswith(("scan-device", "slot-tail", "panel-prefetch"))]
    assert {s[0] for s in slot_work} >= {"to_device", "_host", "compact_survivors"}
    assert len({s[2] for s in slot_work}) == 1 and slot_work[0][2] != default
