"""The shared-fs scheduler backend of the port (``repro_torch.runtime``).

The contract under test is the reference's (``tests/test_multihost.py``): N
independent processes pointed at one checkpoint directory drain one scan
grid through the filesystem lease table, and every one of them emits outputs
byte-identical to a serial single-process scan — under any kill/join
sequence.  Units cover the lease/steal/expiry protocol and the manifest's
read-merge-write; subprocesses run ``python -m repro_torch.launch.gwas scan
--device cpu --exec-backend shared-fs``: two live hosts, and a SIGKILLed
host whose tail a survivor reclaims.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.runtime.checkpoint import ScanCheckpoint, config_fingerprint
from repro_torch.runtime.workqueue import (
    FsWorkQueue,
    WorkQueue,
    available_backends,
    get_backend,
)

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)

FILES = ("hits.tsv", "per_trait_best.tsv", "qc.tsv")


def _read_out(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in FILES}


# ---------------------------------------------------------------- registry


def test_backend_registry():
    assert available_backends() == ("shared-fs", "threads")
    assert get_backend("threads") is WorkQueue
    assert get_backend("shared-fs") is FsWorkQueue
    with pytest.raises(ValueError, match="shared-fs"):
        get_backend("carrier-pigeon")


# ------------------------------------------------------- lease-table units


def _drain(q, worker="w"):
    got = []
    while (i := q.claim(worker, block=False)) is not None:
        got.append(i)
        q.complete(worker, i)
    return got


def test_fs_queue_single_host_lifecycle(tmp_path):
    q = FsWorkQueue(5, keys=[f"k{i}" for i in range(5)], lease_size=2,
                    root=str(tmp_path), host_id="A", lease_ttl=60.0)
    assert sorted(_drain(q)) == list(range(5))
    assert q.remaining() == 0
    # every lease file ended in the done state
    for i in range(5):
        rec = json.load(open(tmp_path / f"lease_k{i}.json"))
        assert rec["state"] == "done" and rec["host"] == "A"
    # a fresh joiner sees a finished grid, not work
    late = FsWorkQueue(5, keys=[f"k{i}" for i in range(5)], lease_size=2,
                       root=str(tmp_path), host_id="B", lease_ttl=60.0)
    assert late.claim("w", block=False) is None
    assert late.remaining() == 0
    q.stop(); late.stop()


def test_fs_queue_two_hosts_partition_items(tmp_path):
    keys = [f"b{i:06d}" for i in range(12)]
    a = FsWorkQueue(12, keys=keys, lease_size=3, root=str(tmp_path),
                    host_id="A", lease_ttl=60.0)
    b = FsWorkQueue(12, keys=keys, lease_size=3, root=str(tmp_path),
                    host_id="B", lease_ttl=60.0)
    got_a, got_b = [], []
    while True:
        ia = a.claim("w", block=False)
        ib = b.claim("w", block=False)
        if ia is None and ib is None:
            break
        if ia is not None:
            got_a.append(ia); a.complete("w", ia)
        if ib is not None:
            got_b.append(ib); b.complete("w", ib)
    # exclusive-create claims: a strict partition, nothing lost or doubled
    assert not set(got_a) & set(got_b)
    assert sorted(got_a + got_b) == list(range(12))
    assert a.remaining() == 0 and b.remaining() == 0
    a.stop(); b.stop()


def test_fs_queue_expired_lease_is_reclaimed(tmp_path):
    keys = [f"k{i}" for i in range(4)]
    dead = FsWorkQueue(4, keys=keys, lease_size=2, root=str(tmp_path),
                       host_id="dead", lease_ttl=0.25)
    first = dead.claim("w")
    assert first is not None
    dead.stop()               # kills the heartbeat thread — a portable SIGKILL
    time.sleep(0.6)           # > ttl: the held leases are now stale
    surv = FsWorkQueue(4, keys=keys, lease_size=4, root=str(tmp_path),
                       host_id="surv", lease_ttl=0.25)
    got = _drain(surv)
    assert sorted(got) == [0, 1, 2, 3]   # incl. the dead host's lease tail
    st = surv.stats()["w"]
    assert st.reclaimed >= 1 and st.stolen_by >= st.reclaimed
    rec = json.load(open(tmp_path / f"lease_k{first}.json"))
    assert rec["host"] == "surv" and rec["steals"] >= 1
    surv.stop()


def test_fs_queue_live_lease_is_not_stolen(tmp_path):
    keys = ["x", "y"]
    a = FsWorkQueue(2, keys=keys, lease_size=1, root=str(tmp_path),
                    host_id="A", lease_ttl=0.4)
    held = a.claim("w")
    b = FsWorkQueue(2, keys=keys, lease_size=2, root=str(tmp_path),
                    host_id="B", lease_ttl=0.4)
    other = b.claim("w", block=False)
    assert other is not None and other != held
    # b has the rest; a's lease is heartbeat-fresh across several ttls
    deadline = time.monotonic() + 1.2
    while time.monotonic() < deadline:
        assert b.claim("w", block=False) is None or pytest.fail("stole a live lease")
        time.sleep(0.1)
    a.complete("w", held)
    b.complete("w", other)
    assert b.remaining() == 0
    a.stop(); b.stop()


def test_fs_queue_done_is_never_stolen(tmp_path):
    keys = ["only"]
    a = FsWorkQueue(1, keys=keys, lease_size=1, root=str(tmp_path),
                    host_id="A", lease_ttl=0.2)
    idx = a.claim("w")
    a.complete("w", idx)
    a.stop()
    time.sleep(0.5)           # well past ttl: done markers do not expire
    b = FsWorkQueue(1, keys=keys, lease_size=1, root=str(tmp_path),
                    host_id="B", lease_ttl=0.2)
    assert b.claim("w", block=False) is None
    assert b.remaining() == 0
    b.stop()


def test_fs_queue_corrupt_lease_expires_by_mtime(tmp_path):
    (tmp_path / "lease_k0.json").write_text("{torn write")
    q = FsWorkQueue(1, keys=["k0"], lease_size=1, root=str(tmp_path),
                    host_id="A", lease_ttl=0.2)
    assert q.claim("w", block=False) is None    # fresh mtime: not expired yet
    old = time.time() - 5.0
    os.utime(tmp_path / "lease_k0.json", (old, old))
    idx = q.claim("w", block=False)
    assert idx == 0                             # reclaimed via mtime fallback
    q.stop()


def test_fs_queue_stop_unblocks_blocking_claim(tmp_path):
    import threading

    keys = ["x", "y"]
    a = FsWorkQueue(2, keys=keys, lease_size=2, root=str(tmp_path),
                    host_id="A", lease_ttl=60.0)
    assert a.claim("w") is not None
    b = FsWorkQueue(2, keys=keys, lease_size=2, root=str(tmp_path),
                    host_id="B", lease_ttl=60.0, poll_s=0.05)
    got = []
    t = threading.Thread(target=lambda: got.append(b.claim("w")), daemon=True)
    t.start()                 # parks: A holds both keys, neither done
    time.sleep(0.2)
    assert t.is_alive()
    b.stop()
    t.join(timeout=2.0)
    assert not t.is_alive() and got == [None]
    a.stop()


def test_fs_queue_unverified_done_lease_is_reclaimed(tmp_path):
    """A done marker whose commit never reached the manifest (lost merge
    on a flock-less mount) must be recomputed, not trusted: nobody
    heartbeats a done lease and resumes skip it, so trusting it would
    silently leave the grid incomplete."""
    committed: set = set()
    _forge_done_lease(tmp_path, "a")
    q = FsWorkQueue(2, keys=["a", "b"], lease_size=2, root=str(tmp_path),
                    host_id="A", lease_ttl=60.0,
                    done_check=lambda k: k in committed)
    got = _drain(q)
    assert sorted(got) == [0, 1]          # "a" recomputed despite its marker
    st = q.stats()["w"]
    assert st.reclaimed >= 1
    rec = json.load(open(tmp_path / "lease_a.json"))
    assert rec["host"] == "A" and rec["state"] == "done" and rec["steals"] >= 1
    assert q.remaining() == 0
    q.stop()


def test_fs_queue_verified_done_lease_is_trusted(tmp_path):
    """The same done marker IS skipped once the check confirms its cells
    are in the manifest — done_check gates recompute, it never forces it."""
    _forge_done_lease(tmp_path, "a")
    q = FsWorkQueue(2, keys=["a", "b"], lease_size=2, root=str(tmp_path),
                    host_id="A", lease_ttl=60.0, done_check=lambda k: True)
    assert _drain(q) == [1]
    assert q.remaining() == 0
    q.stop()


def _forge_done_lease(root, key):
    (root / f"lease_{key}.json").write_text(json.dumps({
        "key": key, "host": "ghost", "worker": "w", "claimed": 0.0,
        "heartbeat": 0.0, "state": "done", "steals": 0,
    }))


def test_fs_queue_complete_survives_marker_write_failure(tmp_path, monkeypatch):
    """A transiently unwritable shared FS during the done-marker write
    must not abort the scan: the cell is already committed to the
    manifest, the marker is just a skip hint.  The lease is left to
    expire, so a peer recomputes (idempotent)."""
    import repro_torch.runtime.workqueue as wq

    q = wq.FsWorkQueue(1, keys=["k"], lease_size=1, root=str(tmp_path),
                       host_id="A", lease_ttl=0.2)
    idx = q.claim("w")
    assert idx == 0
    monkeypatch.setattr(
        wq, "_overwrite_json",
        lambda path, payload: (_ for _ in ()).throw(OSError("fs hiccup")),
    )
    q.complete("w", idx)                  # must not raise
    monkeypatch.undo()
    q.stop()
    assert q.remaining() == 0             # locally retired regardless
    rec = json.load(open(tmp_path / "lease_k.json"))
    assert rec["state"] == "leased"       # marker never landed
    time.sleep(0.5)                       # > ttl: the stale lease expires
    peer = wq.FsWorkQueue(1, keys=["k"], lease_size=1, root=str(tmp_path),
                          host_id="B", lease_ttl=0.2)
    assert peer.claim("w", block=False) == 0   # ... and a peer reclaims it
    peer.stop()


def test_fs_queue_heartbeat_survives_slow_claim_scan(tmp_path, monkeypatch):
    """A slow shared FS making claim's refill listdir take several ttls
    must not starve the heartbeat thread: held leases stay fresh through
    the stall, so peers never see them expire and never thrash-recompute
    live work.  (The old code held the queue lock across the O(grid) FS
    scan; the heartbeat shares that lock for its bookkeeping.)"""
    import threading

    import repro_torch.runtime.workqueue as wq

    keys = ["x", "y"]
    a = FsWorkQueue(2, keys=keys, lease_size=1, root=str(tmp_path),
                    host_id="A", lease_ttl=0.4)
    held = a.claim("w")                   # heartbeat thread now live
    assert held is not None
    b = FsWorkQueue(2, keys=keys, lease_size=1, root=str(tmp_path),
                    host_id="B", lease_ttl=0.4)
    other = b.claim("w", block=False)
    assert other is not None
    b.complete("w", other)                # only A's live lease is left

    real_listdir = os.listdir
    calls = {"n": 0}

    def slow_listdir(path):
        calls["n"] += 1
        if calls["n"] == 1:               # stall only A's scan below
            time.sleep(1.2)
        return real_listdir(path)

    monkeypatch.setattr(wq.os, "listdir", slow_listdir)
    t = threading.Thread(
        target=lambda: a.claim("w2", block=False), daemon=True
    )
    t.start()                             # parks ~3 ttl inside the refill scan
    time.sleep(0.6)                       # mid-stall, > ttl since it began
    c = FsWorkQueue(2, keys=keys, lease_size=2, root=str(tmp_path),
                    host_id="C", lease_ttl=0.4)
    assert c.claim("w", block=False) is None   # A's lease stayed fresh
    t.join(timeout=10.0)
    assert not t.is_alive()
    a.complete("w", held)
    a.stop(); b.stop(); c.stop()


def test_fs_queue_requires_root_and_unique_keys(tmp_path):
    with pytest.raises(ValueError, match="root"):
        FsWorkQueue(2)
    with pytest.raises(ValueError, match="unique"):
        FsWorkQueue(2, keys=["a", "a"], root=str(tmp_path))
    with pytest.raises(ValueError, match="2 keys for 3"):
        FsWorkQueue(3, keys=["a", "b"], root=str(tmp_path))


# --------------------------------------------- manifest read-merge-write


def test_checkpoint_concurrent_committers_union(tmp_path):
    """Two processes share one checkpoint dir; each holds a process-local
    manifest dict.  Interleaved commits must UNION on disk — the old
    write-from-local-state dropped whichever entries the other process
    committed in between (lost update)."""
    fp = config_fingerprint({"scan": 1})
    a = ScanCheckpoint(str(tmp_path), fingerprint=fp, n_batches=2, n_blocks=2)
    b = ScanCheckpoint(str(tmp_path), fingerprint=fp, n_batches=2, n_blocks=2)
    a.commit_cell(0, 0, {"x": np.arange(2)})
    b.commit_cell(1, 1, {"x": np.arange(3)})     # b never saw a's commit
    a.commit_cell(0, 1, {"x": np.arange(4)})     # a never saw b's commit
    disk = json.load(open(tmp_path / "manifest.json"))
    assert set(disk["completed"]) == {"0.0", "1.1", "0.1"}
    # refresh folds peers' commits into memory without writing
    b.refresh()
    assert b.completed_cells() == {(0, 0), (1, 1), (0, 1)}
    assert (1, 0) in b.pending_cells()


def test_checkpoint_commit_clears_merged_failure(tmp_path):
    fp = config_fingerprint({"scan": 2})
    a = ScanCheckpoint(str(tmp_path), fingerprint=fp, n_batches=2)
    b = ScanCheckpoint(str(tmp_path), fingerprint=fp, n_batches=2)
    a.record_failure(0, "transient decode error")
    b.commit_batch(0, {"x": np.arange(2)})       # peer retried and succeeded
    disk = json.load(open(tmp_path / "manifest.json"))
    assert "0" in disk["completed"] and "0" not in disk["failed"]
    # the stale failure does not resurrect through a's next write either
    a.commit_batch(1, {"x": np.arange(2)})
    disk = json.load(open(tmp_path / "manifest.json"))
    assert set(disk["completed"]) == {"0", "1"} and disk["failed"] == {}


def test_checkpoint_same_cell_commit_race_no_tmp_collision(tmp_path):
    """Cross-process double completion of ONE cell is a supported race
    (lease steal, TTL expiry): concurrent committers must not share a tmp
    path.  The old fixed ``shard + '.tmp.npz'`` let one writer truncate
    the bytes the other was about to publish — a torn shard recorded
    completed — and the loser's os.replace raised FileNotFoundError,
    aborting its scan."""
    import threading

    fp = config_fingerprint({"scan": 3})
    cks = [
        ScanCheckpoint(str(tmp_path), fingerprint=fp, n_batches=1, n_blocks=1)
        for _ in range(2)
    ]
    payload = {"x": np.arange(4096)}
    barrier = threading.Barrier(2)
    errs = []

    def commit(ck):
        try:
            for _ in range(25):
                barrier.wait(timeout=30)
                ck.commit_cell(0, 0, payload)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    threads = [threading.Thread(target=commit, args=(ck,)) for ck in cks]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    np.testing.assert_array_equal(cks[0].load_cell(0, 0)["x"], payload["x"])
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_scheduler_verifies_done_leases_against_manifest(tmp_path):
    """End-to-end plumbing of the manifest arbiter: the session passes a
    (batch, block) probe as ``cell_committed`` and the scheduler keys it
    by work item — a forged done lease whose cells are absent from the
    manifest is recomputed; one whose cells are present is skipped."""
    from repro_torch.runtime.scheduler import CellScheduler

    class _Ax:
        def __init__(self, index):
            self.index = index

    def run(root, committed):
        _forge_done_lease(root, "b000001")
        sched = CellScheduler(
            [_Ax(0), _Ax(1)], [_Ax(0)], placement="marker-major",
            lease_size=1, backend="shared-fs",
            backend_opts={
                "root": str(root), "host_id": "A", "lease_ttl": 60.0,
                "cell_committed": lambda b, k: (b, k) in committed,
            },
        )
        got = []
        while (c := sched.claim("w")) is not None:
            idx, item = c
            got.append(item.batch.index)
            sched.complete("w", idx)
        sched.stop()
        return got

    lying, truthful = tmp_path / "lying", tmp_path / "truthful"
    lying.mkdir(); truthful.mkdir()
    assert sorted(run(lying, committed=set())) == [0, 1]   # recomputed
    assert run(truthful, committed={(1, 0)}) == [0]        # trusted


# ------------------------------------------------------------- validation


def test_shared_fs_requires_checkpoint_dir():
    from repro_torch.api.specs import ExecSpec, ScanConfig

    with pytest.raises(ValueError, match="checkpoint_dir"):
        ScanConfig.from_specs(executor=ExecSpec(backend="shared-fs"))
    with pytest.raises(ValueError, match="backend"):
        ExecSpec(backend="smoke-signals").validate()
    with pytest.raises(ValueError, match="lease_ttl"):
        ExecSpec(backend="shared-fs", lease_ttl=0.0).validate()


def test_cli_shared_fs_requires_checkpoint_dir():
    from repro_torch.launch.gwas import cmd_scan

    with pytest.raises(SystemExit, match="checkpoint-dir"):
        cmd_scan([
            "--genotypes", "x.bed", "--pheno", "p.tsv", "--out", "o",
            "--exec-backend", "shared-fs",
        ])


def test_session_shared_fs_requires_checkpoint_dir(cohort_files):
    """The session refuses a distributed backend without a checkpoint, even
    for a config that slipped past the spec check."""
    import dataclasses

    from repro_torch.api import Study
    from repro_torch.api.session import ScanSession

    study = Study.from_files(cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"])
    prep = study.plan(device="cpu").prepare()
    bad = dataclasses.replace(
        prep, config=dataclasses.replace(prep.config, exec_backend="shared-fs"))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        ScanSession(bad)


def test_shared_fs_scan_ends_without_a_poll_stall(cohort_files, tmp_path, monkeypatch):
    """A host's last blocking claim must not wait on its own leases: the
    slot's tail retires them first.  With a 30 s poll interval, a claim
    that found its own last lease still undone would hold the scan for 30
    s."""
    import repro_torch.runtime.workqueue as wq
    from repro_torch.api import ExecSpec, GridSpec, Study

    real_init = wq.FsWorkQueue.__init__

    def slow_poll(self, *a, **k):
        real_init(self, *a, **k)
        self.poll_s = 30.0

    monkeypatch.setattr(wq.FsWorkQueue, "__init__", slow_poll)
    study = Study.from_files(cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"])
    session = study.plan(device="cpu", checkpoint_dir=str(tmp_path / "ck"),
                         grid=GridSpec(batch_markers=128, block_p=4, trait_block=4),
                         executor=ExecSpec(backend="shared-fs", host_id="h")).run()
    t0 = time.monotonic()
    cells = list(session.events())
    assert time.monotonic() - t0 < 20.0
    assert len(cells) == session.n_batches * session.n_trait_blocks
    assert session.executor_info["workers"]["h/dev0"]["wait_s"] < 10.0


# ------------------------------- multi-process semantics (subprocesses)
#
# Children are independent interpreters running the port's CLI module
# (``python -m repro_torch.launch.gwas scan``) against one checkpoint dir on
# the local filesystem — the coordination surface N hosts would share over
# NFS.  The launcher paces each host's consumer (one "CELL" line and an
# optional sleep per recorded cell), as the reference's child does through
# its progress hook: the parent's kill trigger, and what keeps a host busy
# long enough for its peer to join.

_HOST = textwrap.dedent(
    """
    import runpy, sys, time
    from repro_torch.api import metrics

    cell_sleep = float(sys.argv[1])
    record = metrics.ScanMetrics.record

    def paced(self, timing):
        record(self, timing)
        print("CELL", flush=True)
        if cell_sleep:
            time.sleep(cell_sleep)

    metrics.ScanMetrics.record = paced
    sys.argv = ["repro_torch.launch.gwas"] + sys.argv[2:]
    runpy.run_module("repro_torch.launch.gwas", run_name="__main__", alter_sys=True)
    """
)

# 6 trait blocks per batch: one marker-major item (6 cells) overflows the
# executor's bounded results queue (4 slots), so a slow consumer parks the
# worker mid-item — which is what lets the SIGKILL test kill a host with a
# partially committed lease.
GRID_FLAGS = ("--batch-markers", "64", "--block-p", "2", "--trait-block", "2",
              "--hit-threshold", "2.0")
TOTAL_CELLS = 60   # 10 batches (600 markers / 64) x 6 trait blocks (12 / 2)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module")
def serial_ref(cohort_files, tmp_path_factory):
    """The port's serial single-process outputs for the subprocess cohort."""
    from repro_torch.api import GridSpec, Study, TsvWriter

    study = Study.from_files(cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"])
    out = str(tmp_path_factory.mktemp("serial_ref"))
    study.plan(
        grid=GridSpec(batch_markers=64, block_p=2, trait_block=2),
        hit_threshold_nlp=2.0, device="cpu",
    ).run().stream_to(TsvWriter(out))
    return _read_out(out)


def _spawn_host(cohort_files, ck, out, host_id, *, ttl=60.0, cell_sleep=0.0):
    env = dict(os.environ, PYTHONPATH=_SRC)
    # Host-labelled scratch cwd under the test's tmp tree: any relative
    # path a child writes lands here, never in the repo checkout.
    scratch = os.path.join(os.path.dirname(out), f"scratch-{host_id}")
    os.makedirs(scratch, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-c", _HOST, str(cell_sleep), "scan",
         "--genotypes", cohort_files["bed"], "--pheno", cohort_files["pheno"],
         "--covar", cohort_files["cov"], "--out", out, "--device", "cpu", *GRID_FLAGS,
         "--devices", "1", "--lease-batches", "2", "--exec-backend", "shared-fs",
         "--host-id", host_id, "--lease-ttl", str(ttl), "--checkpoint-dir", ck],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=scratch,
    )


def _host_info(out):
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    return {"executor": summary["executor"], "live": summary["metrics"]["live_cells"],
            "replayed": summary["metrics"]["replayed_cells"]}


def test_two_concurrent_hosts_byte_identical(cohort_files, serial_ref, tmp_path):
    ck = str(tmp_path / "ck")
    outs = [str(tmp_path / "host_a"), str(tmp_path / "host_b")]
    procs = [
        _spawn_host(cohort_files, ck, outs[0], "hostA", cell_sleep=0.05),
        _spawn_host(cohort_files, ck, outs[1], "hostB", cell_sleep=0.05),
    ]
    results = [p.communicate(timeout=600) for p in procs]
    for p, (_, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr[-3000:]
    infos = [_host_info(out) for out in outs]
    # both hosts emit the complete grid, byte-identical to the serial scan
    for out in outs:
        assert _read_out(out) == serial_ref
    # the grid was split: each host computed some cells live and replayed
    # its peer's committed cells; together they covered everything
    for info in infos:
        assert info["executor"]["backend"] == "shared-fs"
        assert info["live"] + info["replayed"] == TOTAL_CELLS
    assert infos[0]["live"] + infos[1]["live"] >= TOTAL_CELLS  # >=: steal overlap
    assert all(info["live"] > 0 for info in infos)
    assert all(
        w.startswith(("hostA/", "hostB/"))
        for info in infos for w in info["executor"]["workers"]
    )


def test_sigkilled_host_tail_reclaimed_by_survivor(cohort_files, serial_ref, tmp_path):
    ck = str(tmp_path / "ck")
    victim_out = str(tmp_path / "victim")
    victim = _spawn_host(cohort_files, ck, victim_out, "victim", ttl=1.5, cell_sleep=0.3)
    # Let it claim leases and commit a couple of cells, then SIGKILL — no
    # teardown runs, its lease files simply stop heartbeating.
    cells_seen = 0
    for line in victim.stdout:
        if line.startswith("CELL"):
            cells_seen += 1
            if cells_seen >= 2:
                break
    os.kill(victim.pid, signal.SIGKILL)
    victim.wait(timeout=60)
    victim.stdout.close()
    victim.stderr.close()
    assert victim.returncode != 0
    assert not os.path.exists(os.path.join(victim_out, "summary.json"))

    surv_out = str(tmp_path / "survivor")
    surv = _spawn_host(cohort_files, ck, surv_out, "survivor", ttl=1.5)
    _, stderr = surv.communicate(timeout=600)
    assert surv.returncode == 0, stderr[-3000:]
    info = _host_info(surv_out)
    # the survivor reclaimed the dead host's expired lease tail ...
    stats = info["executor"]["workers"]
    assert sum(w["reclaimed"] for w in stats.values()) >= 1
    # ... finished the grid, and its outputs are byte-identical to serial
    assert info["live"] + info["replayed"] == TOTAL_CELLS
    assert info["replayed"] > 0
    assert _read_out(surv_out) == serial_ref

# --------------------------------------------------- property: partition


def test_fs_queue_claims_partition_property(tmp_path):
    """Any interleaving of two hosts' claims yields a partition of the item
    set: no item claimed twice, none lost (huge ttl: no expiry stealing, so
    the partition is strict)."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(
        order=st.lists(st.sampled_from(["A", "B"]), min_size=1, max_size=40),
        lease_a=st.integers(min_value=1, max_value=5),
        lease_b=st.integers(min_value=1, max_value=5),
        n_items=st.integers(min_value=1, max_value=12),
    )
    def check(order, lease_a, lease_b, n_items):
        import tempfile

        root = tempfile.mkdtemp(dir=str(tmp_path))
        keys = [f"k{i}" for i in range(n_items)]
        hosts = {
            "A": FsWorkQueue(n_items, keys=keys, lease_size=lease_a,
                             root=root, host_id="A", lease_ttl=1e6),
            "B": FsWorkQueue(n_items, keys=keys, lease_size=lease_b,
                             root=root, host_id="B", lease_ttl=1e6),
        }
        claims = {"A": [], "B": []}
        for who in order + ["A"] * n_items + ["B"] * n_items:
            idx = hosts[who].claim("w", block=False)
            if idx is not None:
                claims[who].append(idx)
                hosts[who].complete("w", idx)
        assert not set(claims["A"]) & set(claims["B"])
        assert sorted(claims["A"] + claims["B"]) == list(range(n_items))
        for q in hosts.values():
            assert q.remaining() == 0
            q.stop()

    check()
