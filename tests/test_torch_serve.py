"""The port's serve layer (``repro_torch.serve``) and the marker window of a
session, on the CPU (``device="cpu"``), at the reference's serve grid.

The cases of ``tests/test_serve.py`` on the port: every table a serve
request produces is byte-identical to a fresh offline scan of the port on
the same panel or window, under concurrent interleaved clients, warm-cache
eviction and readmission, and fair-share scheduling; the policy, queue,
cache and metrics mechanics unit-tested directly.  Then the port against
``repro`` on the same files: the same lease order from both packages'
deficit round robin, and windowed scans (offline and served) with the same
``covered`` extent, the same hits away from the threshold, the same
per-trait winners, values at the dense oracle tolerances (r 2e-5, t 2e-4,
nlp 2e-3 rel / 5e-3 abs, each plus the TSV's rounding) and the same QC
table.  Last, an HTTP round trip through ``ServeServer``/``ServeClient``.
"""
from __future__ import annotations

import dataclasses
import filecmp
import os
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.api import GridSpec as RefGridSpec  # noqa: E402
from repro.api import Study as RefStudy  # noqa: E402
from repro.api import TsvWriter as RefTsvWriter  # noqa: E402
from repro.serve import DeficitRoundRobin as RefDeficitRoundRobin  # noqa: E402
from repro_torch.api import GridSpec, Study, TsvWriter  # noqa: E402

# Several worker processes share the cores; one intra-op thread each.
torch.set_num_threads(1)

TABLES = ("hits.tsv", "per_trait_best.tsv", "qc.tsv")
GRID = dict(batch_markers=128, block_m=64, block_n=128, block_p=4,
            trait_block=4)
THRESHOLD = 2.0
BAND = 0.05
# dense oracle tolerances (tests/test_oracle.py): r atol, t rtol=atol,
# nlp rtol, nlp atol; plus the TSV's rounding (r 5 dp, t 4 dp, nlp 3 dp)
DENSE_TOL = (2e-5, 2e-4, 2e-3, 5e-3)
ROUND = (1e-5, 1e-4, 1e-3)


# --------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def study(cohort_files):
    return Study.from_files(
        cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"], device="cpu"
    )


@pytest.fixture(scope="module")
def plan_kwargs():
    return dict(grid=GridSpec(**GRID), hit_threshold_nlp=THRESHOLD, device="cpu")


def _offline(study, plan_kwargs, out_dir, **run_kwargs):
    session = study.plan(**plan_kwargs).run(resume=False, **run_kwargs)
    session.stream_to(TsvWriter(str(out_dir)))
    return session


def _ref_offline(cohort_files, out_dir, **run_kwargs):
    study = RefStudy.from_files(
        cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"]
    )
    plan = study.plan(grid=RefGridSpec(**GRID), hit_threshold_nlp=THRESHOLD)
    session = plan.run(resume=False, **run_kwargs)
    session.stream_to(RefTsvWriter(str(out_dir)))
    return session


def _same_tables(dir_a, dir_b):
    for name in TABLES:
        assert filecmp.cmp(
            os.path.join(str(dir_a), name), os.path.join(str(dir_b), name),
            shallow=False,
        ), f"{name} differs between {dir_a} and {dir_b}"


def _served_dir(host, rid):
    return os.path.dirname(host.result_path(rid, TABLES[0]))


def _rows(path):
    with open(path) as f:
        header = f.readline()
        return header, [line.rstrip("\n").split("\t") for line in f]


def _assert_close_to_reference(got_dir, want_dir):
    """The reference contract: the same hits away from the threshold and the
    same per-trait winners, values at the dense oracle tolerances, the same
    QC table."""
    tol_r, tol_t, nlp_rtol, nlp_atol = DENSE_TOL
    hits = []
    for d in (got_dir, want_dir):
        _, rows = _rows(os.path.join(str(d), "hits.tsv"))
        hits.append({(m, t): tuple(float(v) for v in rest) for m, t, *rest in rows})
    got, want = hits
    for a, b in ((got, want), (want, got)):
        missing = [k for k, v in a.items() if v[2] >= THRESHOLD + BAND and k not in b]
        assert not missing, missing
    common = set(got) & set(want)
    assert common
    for k in common:
        (r1, t1, n1), (r2, t2, n2) = got[k], want[k]
        assert abs(r1 - r2) <= tol_r + ROUND[0], (k, r1, r2)
        assert abs(t1 - t2) <= tol_t + tol_t * abs(t2) + ROUND[1], (k, t1, t2)
        assert abs(n1 - n2) <= nlp_atol + nlp_rtol * abs(n2) + ROUND[2], (k, n1, n2)
    h1, best_got = _rows(os.path.join(str(got_dir), "per_trait_best.tsv"))
    h2, best_want = _rows(os.path.join(str(want_dir), "per_trait_best.tsv"))
    assert h1 == h2 and len(best_got) == len(best_want)
    for (tr1, m1, n1), (tr2, m2, n2) in zip(best_got, best_want):
        assert tr1 == tr2 and m1 == m2, (tr1, m1, m2)
        assert abs(float(n1) - float(n2)) <= nlp_atol + nlp_rtol * abs(float(n2)) + ROUND[2]
    with open(os.path.join(str(got_dir), "qc.tsv")) as f1, \
            open(os.path.join(str(want_dir), "qc.tsv")) as f2:
        assert f1.read() == f2.read()


# ------------------------------------------------- deficit round robin


class TestDeficitRoundRobin:
    def test_weighted_shares(self):
        from repro_torch.serve import DeficitRoundRobin

        drr = DeficitRoundRobin(quantum=1.0)
        drr.enroll("a", range(0, 100), weight=1.0)
        drr.enroll("b", range(100, 200), weight=3.0)
        leased = [drr.select(1)[0] for _ in range(40)]
        from_b = sum(1 for i in leased if i >= 100)
        # 3:1 weights -> b gets ~3/4 of the leases
        assert 24 <= from_b <= 36

    def test_small_request_bounded_by_rounds(self):
        from repro_torch.serve import DeficitRoundRobin

        drr = DeficitRoundRobin(quantum=2.0)
        drr.enroll("big", range(1000), weight=1.0)
        drr.enroll("small", range(1000, 1003), weight=1.0)
        order = [drr.select(1)[0] for _ in range(20)]
        # all three small items leased within the first few rounds
        assert {i for i in order if i >= 1000} == {1000, 1001, 1002}
        assert max(order.index(i) for i in (1000, 1001, 1002)) < 10

    def test_retire_returns_unleased(self):
        from repro_torch.serve import DeficitRoundRobin

        drr = DeficitRoundRobin(quantum=1.0)
        drr.enroll("r", [1, 2, 3, 4])
        got = drr.select(2)
        assert sorted(got + drr.retire("r")) == [1, 2, 3, 4]
        assert drr.pending_count() == 0
        assert drr.retire("r") == []            # idempotent

    def test_drained_queue_leaves_rotation(self):
        from repro_torch.serve import DeficitRoundRobin

        drr = DeficitRoundRobin(quantum=10.0)
        drr.enroll("a", [1, 2])
        assert drr.select(8) == [1, 2]
        assert drr.queue_sizes() == {}
        drr.enroll("b", [5])
        assert drr.select(1) == [5]

    def test_validation(self):
        from repro_torch.serve import DeficitRoundRobin

        with pytest.raises(ValueError, match="quantum"):
            DeficitRoundRobin(quantum=0.0)
        with pytest.raises(ValueError, match="weight"):
            DeficitRoundRobin().enroll("r", [1], weight=-1.0)

    @pytest.mark.parametrize("quantum", [0.5, 1.0, 2.0, 3.5])
    def test_lease_order_matches_reference(self, quantum):
        """The same enrolment (weights, a late joiner, a retire) gives the
        same lease order from both packages' policies, at every select
        size."""
        from repro_torch.serve import DeficitRoundRobin

        rng = np.random.default_rng(int(quantum * 10))
        ks = rng.integers(1, 6, size=60).tolist()
        orders = []
        for cls in (DeficitRoundRobin, RefDeficitRoundRobin):
            drr = cls(quantum=quantum)
            drr.enroll("a", range(0, 40), weight=1.0)
            drr.enroll("b", range(100, 130), weight=2.5)
            drr.enroll("c", range(200, 203), weight=0.5)
            out = []
            for step, k in enumerate(ks):
                if step == 5:
                    drr.enroll("d", range(300, 320), weight=1.5)
                if step == 9:
                    out.append(("retired", sorted(drr.retire("b"))))
                if step == 12:
                    drr.enroll("a", range(40, 45))
                out.append(drr.select(k))
            out.append(drr.queue_sizes())
            orders.append(out)
        assert orders[0] == orders[1]


# ------------------------------------------------- persistent work queue


class TestPersistentWorkQueue:
    def test_claim_blocks_until_extend(self):
        from repro_torch.runtime.workqueue import WorkQueue

        wq = WorkQueue(0, persistent=True)
        got = []

        def worker():
            while (idx := wq.claim("w", block=True)) is not None:
                got.append(idx)
                wq.complete("w", idx)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        time.sleep(0.1)
        assert got == []                        # parked on the empty queue
        wq.extend([7, 8])
        deadline = time.time() + 5.0
        while len(got) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert sorted(got) == [7, 8]
        wq.stop()                               # releases the blocked claim
        t.join(timeout=5.0)
        assert not t.is_alive()

    def test_policy_orders_leases(self):
        from repro_torch.runtime.workqueue import WorkQueue
        from repro_torch.serve import DeficitRoundRobin

        drr = DeficitRoundRobin(quantum=1.0)
        wq = WorkQueue(0, policy=drr, persistent=True)
        drr.enroll("a", [0, 1], weight=1.0)
        drr.enroll("b", [10, 11], weight=1.0)
        wq.kick()
        got = []
        while (idx := wq.claim("w", block=False)) is not None:
            got.append(idx)
            wq.complete("w", idx)
        assert sorted(got) == [0, 1, 10, 11]
        # round-robin: the two requests interleave rather than run back-to-back
        assert got[0] // 10 != got[1] // 10
        assert wq.remaining() == 0


# ----------------------------------------------------- cache mechanics


class TestDeviceLRUPinning:
    def test_pins_block_eviction_and_stats(self):
        from repro_torch.core.engines import DeviceLRU

        made, lru = [], DeviceLRU(2, lambda k: made.append(k) or f"v{k}")
        lru.pin("a")
        lru.get("a")
        lru.get("b")
        lru.get("c")                            # capacity 2: evicts b, not a
        assert lru.get("a") == "va"             # still resident (pinned)
        st = lru.stats()
        assert st["evictions"] >= 1 and st["pinned"] == 1
        lru.unpin("a")
        lru.get("d")
        lru.get("e")                            # now a can go
        assert lru.n_pinned == 0
        assert lru.stats()["resident"] <= 2

    def test_unpin_underflow_raises(self):
        from repro_torch.core.engines import DeviceLRU

        lru = DeviceLRU(2, lambda k: k)
        with pytest.raises(KeyError):
            lru.unpin("never-pinned")


# ------------------------------------------------------ serve metrics


def test_metrics_request_latency_percentiles():
    from repro_torch.api.metrics import ScanMetrics

    m = ScanMetrics()
    assert m.serve_summary() is None            # no serve traffic: absent
    for w in (0.1, 0.2, 0.3, 0.4, 1.0):
        m.record_request(w, kind="window")
    m.record_request(5.0, kind="panel")
    m.set_queue_depth(3)
    m.set_cache_stats("device_state", {"hits": 9, "misses": 1})
    s = m.serve_summary()
    assert s["requests"] == 6
    assert s["latency"]["p50_s"] == pytest.approx(0.35, abs=1e-6)
    assert s["latency"]["max_s"] == 5.0
    assert s["latency_by_kind"]["window"]["n"] == 5
    assert s["queue_depth"] == 3
    assert s["caches"]["device_state"]["hits"] == 9
    assert "serve" in m.summary()


# ------------------------------------------------------- the marker window


def test_marker_window_validation(study, plan_kwargs):
    plan = study.plan(**plan_kwargs)
    with pytest.raises(ValueError, match="marker_window"):
        plan.run(resume=False, marker_window=(50, 50))
    with pytest.raises(ValueError, match="marker_window"):
        plan.run(resume=False, marker_window=(-1, 50))
    with pytest.raises(ValueError, match="marker_window"):
        plan.run(resume=False, marker_window=(0, 601))
    session = plan.run(resume=False, marker_window=(130, 140))
    # widened outward to batch boundaries (batch_markers=128)
    assert session.window_covered == (128, 256)
    assert session.metrics.n_cells_total == 3    # 1 batch x 3 trait blocks
    assert plan.run(resume=False).window_covered is None


@pytest.mark.parametrize("window", [(130, 140), (200, 500)], ids=["inside", "across"])
def test_window_matches_reference(window, study, plan_kwargs, cohort_files, tmp_path):
    """An offline windowed scan of the port against the reference's on the
    same files: a window inside one batch and one across batch boundaries."""
    got = _offline(study, plan_kwargs, tmp_path / "port", marker_window=window)
    want = _ref_offline(cohort_files, tmp_path / "ref", marker_window=window)
    assert got.window_covered == want.window_covered
    assert got.metrics.n_cells_total == want.metrics.n_cells_total
    _assert_close_to_reference(tmp_path / "port", tmp_path / "ref")


def test_windowed_resume_replays_only_its_batches(study, plan_kwargs, tmp_path):
    """A windowed session on a full-grid checkpoint recomputes nothing and
    replays only the window's own batches: the windowed offline bytes."""
    ck = str(tmp_path / "ck")
    kw = dict(plan_kwargs, checkpoint_dir=ck)
    _offline(study, kw, tmp_path / "full")
    session = study.plan(**kw).run(resume=True, marker_window=(200, 500))
    session.stream_to(TsvWriter(str(tmp_path / "resumed")))
    m = session.metrics.summary()
    assert m["live_cells"] == 0
    assert m["replayed_cells"] == 3 * 3         # batches 1..3 x 3 trait blocks
    _offline(study, plan_kwargs, tmp_path / "fresh", marker_window=(200, 500))
    _same_tables(tmp_path / "fresh", tmp_path / "resumed")


# --------------------------------------------------------- the service


@pytest.fixture()
def host(study, plan_kwargs, tmp_path):
    from repro_torch.serve import ServeHost

    h = ServeHost(devices=1, max_resident_slots=4,
                  out_root=str(tmp_path / "serve"), device="cpu")
    h.admit_study("toy", study, **plan_kwargs)
    yield h
    h.shutdown()
    assert h.registry.n_pinned == 0


def test_interleaved_clients_byte_identical(host, study, plan_kwargs, tmp_path):
    """Concurrent clients on one study — an uploaded panel and window
    queries interleaving on the shared pool — each byte-identical to its
    sequential offline scan."""
    rng = np.random.default_rng(3)
    panel = rng.standard_normal((study.n_samples, 8)).astype(np.float32)
    panel[:, :2] += np.asarray(study.phenotypes)[:, :2]   # planted hits
    names = [f"p{i}" for i in range(8)]
    rids: dict = {}

    def upload():
        rids["panel"] = host.submit_panel("toy", panel, names)
        host.wait(rids["panel"], timeout=300)

    def windows():
        for lo, hi in ((0, 128), (200, 500)):
            rids[(lo, hi)] = host.submit_window("toy", lo, hi)
            host.wait(rids[(lo, hi)], timeout=300)

    threads = [threading.Thread(target=upload), threading.Thread(target=windows)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()

    info = host.request_info(rids["panel"])
    assert info["status"] == "done", info["error"]
    ref = tmp_path / "offline_panel"
    _offline(
        dataclasses.replace(study, phenotypes=panel, trait_names=names),
        plan_kwargs, ref,
    )
    _same_tables(ref, _served_dir(host, rids["panel"]))

    for lo, hi in ((0, 128), (200, 500)):
        info = host.request_info(rids[(lo, hi)])
        assert info["status"] == "done", info["error"]
        ref = tmp_path / f"offline_w{lo}"
        sess = _offline(study, plan_kwargs, ref, marker_window=(lo, hi))
        assert tuple(info["covered"]) == sess.window_covered
        _same_tables(ref, _served_dir(host, rids[(lo, hi)]))

    served = host.metrics_summary()["serve"]
    assert served["requests"] == 3
    assert served["latency"]["p95_s"] >= served["latency"]["p50_s"]
    assert served["caches"]["device_state"]["hits"] >= 1


def test_eviction_and_readmission(study, plan_kwargs, tmp_path):
    """A second state forcing ``DeviceLRU`` eviction of the resident
    study's slot, then re-admission on the next query — still
    byte-identical, with the churn visible in the cache counters, and the
    evicted slot's staged batch memo gone with it."""
    from repro_torch.serve import ServeHost

    host = ServeHost(devices=1, max_resident_slots=1,
                     out_root=str(tmp_path / "serve"), device="cpu")
    try:
        host.admit_study("toy", study, **plan_kwargs)
        rid1 = host.submit_window("toy", 0, 128)
        host.wait(rid1, timeout=300)
        first = host.registry._live[("study:toy", 0)]
        assert first._serve_staged is not None
        # An uploaded panel's ephemeral req:<rid> state takes the single
        # slot, evicting the resident study's warm slot.
        rng = np.random.default_rng(4)
        panel = rng.standard_normal((study.n_samples, 4)).astype(np.float32)
        pid = host.submit_panel("toy", panel)
        host.wait(pid, timeout=300)
        st = host.registry.slot_cache_stats()
        assert st["evictions"] >= 1
        assert first._serve_staged is None
        assert host.registry._live == {}         # the panel's slot dropped too
        # Re-admission: the study's slot is rebuilt (a miss, not an
        # error), and the served bytes are unchanged.
        rid2 = host.submit_window("toy", 0, 128)
        host.wait(rid2, timeout=300)
        _same_tables(_served_dir(host, rid1), _served_dir(host, rid2))
        ref = tmp_path / "offline_w0"
        _offline(study, plan_kwargs, ref, marker_window=(0, 128))
        _same_tables(ref, _served_dir(host, rid2))
        assert host.registry.slot_cache_stats()["misses"] >= 3
    finally:
        host.shutdown()
    assert host.registry.n_pinned == 0 and host.registry._live == {}


def test_fair_share_no_starvation(host, study):
    """A large panel drain must not starve a small interactive query: the
    window query completes while the big request is still running."""
    rng = np.random.default_rng(6)
    # 64 traits: 80 big cells, at ~0.16 s each on one CPU thread (the host
    # refine), against the small query's 3 cells.
    big = rng.standard_normal((study.n_samples, 64)).astype(np.float32)
    big_rid = host.submit_panel("toy", big)
    # Wait until the big request is actually draining on the pool.
    deadline = time.time() + 120.0
    while time.time() < deadline:
        if (host.request_info(big_rid)["status"] == "running"
                and host.executor.queue.remaining() > 0):
            break
        time.sleep(0.02)
    else:
        pytest.fail("big panel request never started draining")

    t0 = time.perf_counter()
    small_rid = host.submit_window("toy", 0, 128)
    small = host.wait(small_rid, timeout=300)
    small_wall = time.perf_counter() - t0
    big_status = host.request_info(big_rid)["status"]
    assert small["status"] == "done", small["error"]
    # FIFO would park the 3-cell query behind the 80 big cells.  Under DRR it
    # completes while the big panel is still draining.
    assert big_status == "running", (
        f"big request already {big_status}; small wall {small_wall:.3f}s — "
        "queue too fast to exercise fairness, enlarge the big panel"
    )
    big_info = host.wait(big_rid, timeout=600)
    assert big_info["status"] == "done", big_info["error"]
    lat = host.metrics_summary()["serve"]["latency_by_kind"]
    assert lat["window"]["p95_s"] < lat["panel"]["max_s"]


def test_clean_shutdown_mid_request_releases_everything(study, plan_kwargs,
                                                        tmp_path):
    """Shutdown with a request in flight: the request fails (not hangs),
    no serve worker threads survive, and no slot stays pinned."""
    from repro_torch.serve import ServeHost

    host = ServeHost(devices=1, out_root=str(tmp_path / "serve"), device="cpu")
    host.admit_study("toy", study, **plan_kwargs)
    rng = np.random.default_rng(8)
    panel = rng.standard_normal((study.n_samples, 256)).astype(np.float32)
    rid = host.submit_panel("toy", panel)
    deadline = time.time() + 120.0
    while (host.request_info(rid)["status"] == "queued"
           and time.time() < deadline):
        time.sleep(0.02)
    host.shutdown()
    info = host.wait(rid, timeout=60)
    assert info["status"] in ("failed", "done")
    assert not host.executor.alive
    leftovers = [
        t.name for t in threading.enumerate()
        if t.name.startswith(("serve-worker", "serve-request"))
    ]
    assert leftovers == []
    assert host.registry.n_pinned == 0
    # idempotent
    host.shutdown()


def test_admit_validation(study, host):
    with pytest.raises(ValueError, match="already admitted"):
        host.admit_study("toy", study)
    with pytest.raises(ValueError, match="not servable"):
        host.admit_study("toy2", study, checkpoint_dir="/tmp/x")
    with pytest.raises(ValueError, match="disagrees"):
        host.admit_study("toy3", study, device="cuda")
    with pytest.raises(KeyError, match="unknown study"):
        host.submit_window("nope", 0, 10)
    with pytest.raises(ValueError, match="panel must be"):
        host.submit_panel("toy", np.zeros((3, 2), np.float32))
    with pytest.raises(KeyError, match="unknown request"):
        host.request_info("r0000-nope")
    with pytest.raises(KeyError, match="unknown result file"):
        host.result_path("any", "etc/passwd")


def test_slot_devices_on_the_cpu():
    """One slot is the serial slot (``device=None``); N slots on the CPU
    share it; ``devices=0`` is one slot there; a card asked for without
    one raises."""
    from repro_torch.serve import StudyRegistry

    one = StudyRegistry(devices=1, device="cpu")
    assert one.n_slots == 1 and one.slot_device(0) is None
    three = StudyRegistry(devices=3, device="cpu")
    assert three.n_slots == 3
    assert [three.slot_device(i) for i in range(3)] == [torch.device("cpu")] * 3
    assert StudyRegistry(devices=0, device="cpu").n_slots == 1
    with pytest.raises(ValueError, match="devices"):
        StudyRegistry(devices=-1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StudyRegistry(devices=1)


def test_served_window_matches_reference(host, cohort_files, tmp_path):
    """A window served by the port against ``repro``'s offline windowed
    scan on the same files: the same ``covered`` extent, hits and winners,
    values at the oracle tolerances."""
    rid = host.submit_window("toy", 200, 500)
    info = host.wait(rid, timeout=300)
    assert info["status"] == "done", info["error"]
    want = _ref_offline(cohort_files, tmp_path / "ref", marker_window=(200, 500))
    assert tuple(info["covered"]) == want.window_covered
    _assert_close_to_reference(_served_dir(host, rid), tmp_path / "ref")


def test_http_round_trip(study, plan_kwargs, cohort_files, tmp_path):
    """Admit over HTTP from server-side paths, upload a panel and run a
    window query through ``ServeClient``; the fetched bytes are the offline
    scans' and the server shuts down cleanly on ``POST /shutdown``."""
    from repro_torch.serve import ServeClient, ServeError, ServeHost, ServeServer

    host = ServeHost(devices=1, out_root=str(tmp_path / "serve"), device="cpu")
    server = ServeServer(host).start()
    client = ServeClient(*server.address, timeout=60.0)
    try:
        assert client.healthy()
        info = client.admit_study(
            "toy", genotypes=cohort_files["bed"], phenotypes=cohort_files["pheno"],
            covariates=cohort_files["cov"],
            plan={"grid": dict(GRID), "hit_threshold_nlp": THRESHOLD},
        )
        assert info["prepared"] is False and info["warm"]["prepare_s"] > 0
        assert [s["study_id"] for s in client.studies()] == ["toy"]
        with pytest.raises(ServeError, match="unknown scan kind"):
            client._json("POST", "/scan?study=toy&kind=nope")
        names = [f"trait{i}" for i in range(study.n_traits)]
        panel = np.asarray(study.phenotypes)
        pid = client.scan_panel("toy", panel, names)
        wid = client.scan_window("toy", 130, 300)
        assert client.wait(pid, timeout=300)["status"] == "done"
        winfo = client.wait(wid, timeout=300)
        ref_full, ref_win = tmp_path / "full", tmp_path / "win"
        _offline(study, plan_kwargs, ref_full)
        sess = _offline(study, plan_kwargs, ref_win, marker_window=(130, 300))
        assert tuple(winfo["covered"]) == sess.window_covered == (128, 384)
        for name in TABLES:
            with open(ref_full / name, "rb") as f:
                assert client.fetch(pid, name) == f.read(), name
            with open(ref_win / name, "rb") as f:
                assert client.fetch(wid, name) == f.read(), name
        with pytest.raises(ServeError, match="404"):
            client.fetch(wid, "summary.json")
        metrics = client.metrics()
        assert metrics["requests"] == {"done": 2}
        assert metrics["serve"]["latency_by_kind"]["window"]["n"] == 1
        assert client.shutdown() == {"ok": True}
        server.wait()
        # wait() returns once shutdown is complete, not when it begins
        assert [t.name for t in threading.enumerate() if t.name.startswith("serve-")] == []
        assert not host.executor.alive
    finally:
        server.shutdown()
    assert not client.healthy()
    assert host.registry.n_pinned == 0


# ----------------------------------------------------------- CLI surface


def test_exec_backend_help_lists_registry():
    from repro_torch.launch.gwas import build_scan_parser, build_serve_parser
    from repro_torch.runtime.workqueue import available_backends

    help_text = build_scan_parser().format_help()
    for backend in available_backends():
        assert backend in help_text
    with pytest.raises(SystemExit):
        build_scan_parser().parse_args([
            "--genotypes", "x.bed", "--pheno", "p.tsv", "--out", "o",
            "--exec-backend", "smoke-signals",
        ])
    serve = build_serve_parser().parse_args(["--genotypes", "x.bed", "--pheno", "p.tsv"])
    assert serve.device == "cuda" and serve.devices == 1 and serve.engine == "dense"


def test_serve_spec_validation():
    from repro_torch.api import ServeSpec

    ServeSpec().validate()
    with pytest.raises(ValueError, match="port"):
        ServeSpec(port=70000).validate()
    with pytest.raises(ValueError, match="max_resident_slots"):
        ServeSpec(max_resident_slots=0).validate()
    with pytest.raises(ValueError, match="drr_quantum"):
        ServeSpec(drr_quantum=0.0).validate()
