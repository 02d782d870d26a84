"""Straggler-aware distributed work assignment for the scan's batch stream.

At cluster scale the scan is a bag of independent batch indices.  Hosts are
assigned contiguous *leases*; a host that falls behind (straggler) has the
un-started tail of its lease re-assigned to finished hosts (work stealing).
Batches are idempotent — the checkpoint manifest deduplicates double
completion, so stealing is always safe.

Two backends implement the same lease/steal discipline (the scheduler
backend is a registry, like engines and writers):

    "threads"    ``WorkQueue`` — the in-process queue that drives one
                 host's device worker threads (DESIGN.md §12).
    "shared-fs"  ``FsWorkQueue`` — the lease table moved to the shared
                 filesystem next to the checkpoint manifest (DESIGN.md
                 §14): one JSON lease file per work item, claimed with
                 the same write-tmp/fsync/atomic-publish discipline the
                 manifest uses, heartbeat timestamps refreshed by a
                 daemon thread, and expiry-based stealing so a
                 SIGKILL'd host's un-started lease tail is reclaimed by
                 the survivors.  N independent processes (on as many
                 hosts as share the filesystem) drain one grid.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable

__all__ = [
    "WorkQueue",
    "FsWorkQueue",
    "LeasePolicy",
    "WorkerStats",
    "register_backend",
    "get_backend",
    "available_backends",
]


# ------------------------------------------------------------------ registry


_BACKENDS: dict[str, type] = {}


def register_backend(name: str):
    """Register a scheduler backend class under ``name`` (decorator) — the
    same plug-in idiom as ``core.engines.register_engine`` and
    ``api.writers.register_writer``.  Backends share the ``WorkQueue``
    surface: ``claim`` / ``complete`` / ``remaining`` / ``stats`` /
    ``stop``, constructed as ``cls(n_items, keys=..., lease_size=...,
    **backend_opts)``."""

    def deco(cls: type) -> type:
        _BACKENDS[name] = cls
        cls.backend_name = name
        return cls

    return deco


def get_backend(name: str) -> type:
    if name not in _BACKENDS:
        raise ValueError(
            f"unknown scheduler backend {name!r}; available: {available_backends()}"
        )
    return _BACKENDS[name]


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


@dataclass
class WorkerStats:
    claimed: int = 0
    completed: int = 0
    stolen_from: int = 0
    stolen_by: int = 0
    reclaimed: int = 0     # expired foreign leases taken over (shared-fs only)
    busy_s: float = 0.0
    # Idle between completing everything and the next item.  Under the
    # pipelined executor's look-ahead (``slot_prefetch`` >= 1) a worker
    # always holds a claimed item, so this reads ~0 however long its device
    # idles (0.0 on four H100s 79.6% idle): the executor's ``claim``,
    # ``batch_wait``, ``tail_wait`` and ``result_wait`` spans
    # (``runtime.spans``) time its waits instead.
    wait_s: float = 0.0


class _WorkerClock:
    """Busy/wait accounting shared by both queue backends.

    A worker is *busy* while it holds at least one claimed-but-uncompleted
    item and *waiting* otherwise — the pipelined executor claims its next
    item before completing the current one (look-ahead), so intervals are
    attributed by the outstanding count at the time they elapsed, not by
    which call happened to end them.  Every fold advances the worker's
    mark, so no interval is ever counted twice (idle polling folds each
    gap exactly once, into ``wait_s``).  All methods assume the owning
    queue's lock is held.
    """

    def __init__(self) -> None:
        self._mark: dict[str, float] = {}
        self._outstanding: dict[str, int] = {}

    def fold(self, worker: str, st: WorkerStats, now: float) -> None:
        mark = self._mark.get(worker)
        if mark is not None:
            if self._outstanding.get(worker, 0) > 0:
                st.busy_s += now - mark
            else:
                st.wait_s += now - mark
        self._mark[worker] = now

    def claimed(self, worker: str) -> None:
        self._outstanding[worker] = self._outstanding.get(worker, 0) + 1

    def completed(self, worker: str) -> None:
        n = self._outstanding.get(worker, 0)
        self._outstanding[worker] = max(0, n - 1)

    def snapshot_into(self, worker: str, snap: WorkerStats, now: float) -> None:
        """Fold the in-flight interval into a stats *copy* (never the live
        state), so busy/wait stay monotone across snapshots."""
        mark = self._mark.get(worker)
        if mark is not None:
            if self._outstanding.get(worker, 0) > 0:
                snap.busy_s += now - mark
            else:
                snap.wait_s += now - mark


class LeasePolicy:
    """Protocol for pluggable lease-refill order (duck-typed, never
    instantiated): a policy OWNS the pending set and decides which items a
    refilling worker leases next — the fair-share claim path the serve
    layer builds its deficit-round-robin on (``repro.serve.fair``).

    Both methods are invoked with the owning queue's lock held, so
    implementations must be non-blocking and must never call back into the
    queue.  Feeding a policy happens out-of-band (its own ``enroll``-style
    API); after feeding, call ``WorkQueue.kick()`` to wake blocked
    claimers.
    """

    def select(self, k: int) -> list[int]:  # pragma: no cover - protocol
        """Up to ``k`` item indices to lease next, removed from pending."""
        raise NotImplementedError

    def pending_count(self) -> int:  # pragma: no cover - protocol
        raise NotImplementedError


@register_backend("threads")
class WorkQueue:
    """Lease-based batch distribution with work stealing.

    ``lease_size`` batches are claimed at a time (amortizes coordination);
    when a worker exhausts its lease it steals the largest remaining tail
    from the slowest worker.  Thread-safe; deterministic completion set.

    Two optional extensions carry the serve subsystem (both default off,
    leaving the batch executor's behavior byte-identical):

    * ``policy`` — a ``LeasePolicy`` that owns the pending set and decides
      refill order (priority / fair share) instead of the FIFO list.
    * ``persistent`` — a long-lived queue: ``claim(block=True)`` WAITS
      when nothing is available (new items arrive via ``extend``/a policy
      feed + ``kick``) instead of returning ``None``; only ``stop()``
      releases claimers with ``None``.
    """

    def __init__(
        self,
        n_items: int,
        *,
        lease_size: int = 8,
        skip: set[int] | None = None,
        keys: list[str] | None = None,
        done_check: Callable[[str], bool] | None = None,
        policy: "LeasePolicy | None" = None,
        persistent: bool = False,
    ):
        # ``keys`` and ``done_check`` are the cross-host item identity and
        # completion arbiter used by distributed backends; the in-process
        # queue moves plain indices and ignores them (accepted so the
        # scheduler constructs every backend uniformly).
        del keys, done_check
        pending = [i for i in range(n_items) if not skip or i not in skip]
        self._pending: list[int] = pending
        self._leases: dict[str, list[int]] = {}
        self._stats: dict[str, WorkerStats] = {}
        self._lease_size = max(1, lease_size)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._clock = _WorkerClock()
        self._policy = policy
        self._persistent = persistent
        self._stopped = False

    @property
    def lease_size(self) -> int:
        return self._lease_size

    def set_lease_size(self, n: int) -> None:
        """Retune the per-refill lease (runtime autotuning hook).  Only
        future refills are affected — already-leased runs keep their
        extent, so correctness never depends on when this lands."""
        with self._lock:
            self._lease_size = max(1, int(n))

    def stats(self) -> dict[str, WorkerStats]:
        """Point-in-time *snapshot* of per-worker accounting.

        Returns copies, not the live ``WorkerStats`` objects: callers hold
        the result across further claims (progress lines, summary.json),
        and handing out the mutable internals would let them corrupt — or
        observe mid-update — the queue's own accounting.  The in-flight
        interval of a worker is folded into its *copy* (never the live
        state), so ``busy_s``/``wait_s`` are monotone across snapshots and
        a long cell shows up in ``--progress`` utilization while it runs."""
        with self._lock:
            now = time.monotonic()
            out: dict[str, WorkerStats] = {}
            for w, st in self._stats.items():
                snap = dataclasses.replace(st)
                self._clock.snapshot_into(w, snap, now)
                out[w] = snap
            return out

    def remaining(self) -> int:
        with self._lock:
            pend = (
                self._policy.pending_count()
                if self._policy is not None
                else len(self._pending)
            )
            return pend + sum(len(v) for v in self._leases.values())

    def extend(self, items) -> None:
        """Append work items to a live queue (the serve feed path: request
        admission turns grid cells into new indices on the SAME queue the
        workers drain) and wake blocked claimers.  With a ``policy``
        installed, feed the policy instead and call ``kick()``."""
        with self._cv:
            self._pending.extend(int(i) for i in items)
            self._cv.notify_all()

    def kick(self) -> None:
        """Wake blocked claimers after an out-of-band feed (a
        ``LeasePolicy`` enrollment happens outside the queue's lock)."""
        with self._cv:
            self._cv.notify_all()

    def claim(self, worker: str, *, block: bool = True) -> int | None:
        """Next batch index for ``worker``, refilling or stealing as needed.

        On a batch (non-persistent) queue claims never block and ``None``
        means drained.  On a persistent queue ``block=True`` waits for new
        items; ``None`` means ``stop()`` was called.
        """
        with self._cv:
            st = self._stats.setdefault(worker, WorkerStats())
            # Attribute the interval since the worker's last event by its
            # outstanding count THEN: a pipelined worker polling for its
            # look-ahead while a cell is still in flight stays busy; a
            # worker with nothing in hand accrues wait.  Each fold advances
            # the mark, so no interval is ever double-counted.
            self._clock.fold(worker, st, time.monotonic())
            while True:
                idx = self._next_locked(worker, st)
                if idx is not None:
                    st.claimed += 1
                    self._clock.claimed(worker)
                    return idx
                if self._stopped or not (self._persistent and block):
                    return None
                self._cv.wait(timeout=0.25)
                self._clock.fold(worker, st, time.monotonic())

    def _next_locked(self, worker: str, st: WorkerStats) -> int | None:
        """Refill-or-steal under the lock: one attempt, no waiting."""
        lease = self._leases.setdefault(worker, [])
        if not lease:
            if self._policy is not None:
                lease.extend(self._policy.select(self._lease_size))
            elif self._pending:
                take = min(self._lease_size, len(self._pending))
                lease.extend(self._pending[:take])
                del self._pending[:take]
            if not lease:
                victim = self._pick_victim(worker)
                if victim is not None:
                    vlease = self._leases[victim]
                    steal = len(vlease) // 2
                    if steal:
                        lease.extend(vlease[-steal:])
                        del vlease[-steal:]
                        self._stats[victim].stolen_from += steal
                        st.stolen_by += steal
        if not lease:
            return None
        return lease.pop(0)

    def _pick_victim(self, thief: str) -> str | None:
        """Largest remaining lease loses half its tail; equal-length leases
        tie-break on the lexicographically greatest worker id, so victim
        choice is deterministic for a given queue state (tested)."""
        candidates = [(len(l), w) for w, l in self._leases.items() if w != thief and len(l) > 1]
        if not candidates:
            return None
        return max(candidates)[1]

    def complete(self, worker: str, idx: int) -> None:
        with self._lock:
            st = self._stats.setdefault(worker, WorkerStats())
            st.completed += 1
            self._clock.fold(worker, st, time.monotonic())
            self._clock.completed(worker)

    def stop(self) -> None:
        """Teardown: release blocked claimers with ``None``.  (A no-op on
        batch queues, whose claims never block.)"""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()


# -------------------------------------------------------- shared-fs backend


def _publish_exclusive(path: str, payload: dict) -> bool:
    """Atomically publish ``payload`` at ``path`` iff nothing is there.

    write-tmp + fsync (the manifest's discipline), then ``os.link`` —
    which, unlike ``os.replace``, FAILS when the target exists: the
    exclusive-create that makes a fresh lease claim race-free across
    hosts (hard links are atomic on POSIX shared filesystems, NFS
    included)."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
    finally:
        os.unlink(tmp)


def _overwrite_json(path: str, payload: dict) -> None:
    """Atomic clobbering write (heartbeat refresh, steal, done marker) —
    write-tmp/fsync/``os.replace``, byte-for-byte the manifest's idiom."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@register_backend("shared-fs")
class FsWorkQueue:
    """Shared-filesystem lease table: elastic multi-host work distribution.

    One JSON lease file per work item under ``root/`` (DESIGN.md §14):

        lease_<key>.json   {key, host, worker, claimed, heartbeat,
                            state: "leased" | "done", steals}

    Claim protocol:

    * **fresh claim** — exclusive atomic publish of the lease file
      (``os.link``); losing the race means another host owns the item.
    * **heartbeat** — a daemon thread refreshes the ``heartbeat`` wall
      timestamp of every lease this host holds (every ``lease_ttl / 4``),
      so liveness is observable through the filesystem alone.
    * **expiry steal** — a lease whose heartbeat is older than
      ``lease_ttl`` belongs to a dead (or stalled) host: any survivor
      atomically overwrites it with its own lease and recomputes the item.
      A SIGKILL kills the heartbeat thread with the process, so the
      victim's whole un-started lease tail expires and is reclaimed.
    * **done** — completion overwrites the lease with ``state: "done"``;
      done leases are never stolen and tell late joiners to skip.  When a
      ``done_check`` is installed (the scheduler wires it to the
      checkpoint manifest), a done marker is only trusted if the check
      confirms it: a marker whose commit lost the manifest merge (a
      flock-less mount dropping a concurrent write) names a cell that
      was never durably recorded — nobody heartbeats it and resumes
      would skip it, so it is reclaimed and recomputed instead of
      silently leaving the grid incomplete.

    Safety does NOT depend on mutual exclusion: two hosts that race a
    steal (or a too-small ``lease_ttl`` under a long cell) both compute
    the item, and the checkpoint manifest deduplicates the idempotent,
    bit-identical commits.  ``lease_ttl`` is a liveness/efficiency knob,
    never a correctness one.

    Items are identified by ``keys`` — canonical strings that mean the
    same grid cells on every host regardless of each host's local pending
    filter — and ``claim`` returns the *local* index of the claimed key.
    ``claim`` blocks (polling) while other hosts still hold undone items,
    so a surviving host drains a dead host's tail instead of exiting
    early; pass ``block=False`` to poll once.  Hosts' wall clocks are
    assumed loosely synchronized (well within ``lease_ttl``), the usual
    shared-filesystem-cluster contract.
    """

    def __init__(
        self,
        n_items: int,
        *,
        keys: list[str] | None = None,
        lease_size: int = 8,
        skip: set[int] | None = None,
        root: str | None = None,
        host_id: str | None = None,
        lease_ttl: float = 60.0,
        poll_s: float | None = None,
        done_check: Callable[[str], bool] | None = None,
    ):
        if root is None:
            raise ValueError("FsWorkQueue needs root= (the shared lease directory)")
        if lease_ttl <= 0:
            raise ValueError(f"lease_ttl must be positive, got {lease_ttl}")
        self.root = root
        os.makedirs(root, exist_ok=True)
        all_keys = (
            list(keys) if keys is not None else [f"{i:06d}" for i in range(n_items)]
        )
        if len(all_keys) != n_items:
            raise ValueError(f"{len(all_keys)} keys for {n_items} items")
        if len(set(all_keys)) != len(all_keys):
            raise ValueError("work item keys must be unique")
        self._key_of: dict[int, str] = dict(enumerate(all_keys))
        self._index_of: dict[str, int] = {k: i for i, k in enumerate(all_keys)}
        self._keys: list[str] = [
            k for i, k in enumerate(all_keys) if not skip or i not in skip
        ]
        self.host_id = host_id or f"{socket.gethostname()}-{os.getpid()}"
        self.lease_ttl = float(lease_ttl)
        self.poll_s = (
            float(poll_s)
            if poll_s is not None
            else max(0.05, min(1.0, self.lease_ttl / 10.0))
        )
        self._lease_size = max(1, lease_size)
        self._done_check = done_check
        self._lock = threading.Lock()
        # Serializes per-key lease-file writes between the heartbeat loop
        # and ``complete`` — never held across FS scans, so it cannot
        # starve anything; see ``_heartbeat_loop`` for the ordering it
        # guarantees.
        self._write_lock = threading.Lock()
        self._stop = threading.Event()
        self._stats: dict[str, WorkerStats] = {}
        self._clock = _WorkerClock()
        self._leases: dict[str, list[str]] = {}   # worker -> claimed, unserved
        self._held: set[str] = set()              # our live FS leases
        self._records: dict[str, dict] = {}       # held key -> last lease JSON
        self._not_done: set[str] = set(self._keys)
        # Hosts start their fresh-claim scan at a host-hash offset so a
        # simultaneously-starting fleet mostly claims disjoint regions
        # first (fewer lost races; results are identical regardless).
        n = max(1, len(self._keys))
        self._scan0 = int(hashlib.sha256(self.host_id.encode()).hexdigest(), 16) % n
        self._hb_thread: threading.Thread | None = None

    # ------------------------------------------------------------ lease files

    def _lease_path(self, key: str) -> str:
        return os.path.join(self.root, f"lease_{key}.json")

    def _record(self, key: str, worker: str, state: str, *, steals: int = 0) -> dict:
        now = time.time()
        return {
            "key": key,
            "host": self.host_id,
            "worker": worker,
            "claimed": now,
            "heartbeat": now,
            "state": state,
            "steals": steals,
        }

    def _read_lease(self, key: str) -> dict | None:
        """None: no lease file (unclaimed).  A torn/corrupt file reads as an
        empty record — its heartbeat then falls back to the file mtime, so
        a crashed writer's leftovers still expire and get reclaimed."""
        try:
            with open(self._lease_path(key)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError):
            return {}

    # -------------------------------------------------------------- heartbeat

    def _ensure_heartbeat_locked(self) -> None:
        if self._hb_thread is None and not self._stop.is_set():
            t = threading.Thread(
                target=self._heartbeat_loop,
                daemon=True,
                name=f"fs-lease-heartbeat-{self.host_id}",
            )
            self._hb_thread = t
            t.start()

    def _heartbeat_loop(self) -> None:
        """Refresh held leases' heartbeats.  The FS writes run OUTSIDE
        ``self._lock`` (a slow shared FS must not block claims, and claims
        must not block heartbeats): the held set is snapshotted under the
        lock, then each write re-checks the key under the lock while
        holding ``_write_lock`` — ``complete`` writes its done marker
        under the same ``_write_lock`` *after* releasing the key, so a
        stale "leased" record can never clobber a done marker (either the
        re-check sees the key released and skips, or the done write lands
        after ours)."""
        interval = max(0.05, self.lease_ttl / 4.0)
        while not self._stop.wait(interval):
            with self._lock:
                held = sorted(self._held)
            now = time.time()
            for key in held:
                with self._write_lock:
                    with self._lock:
                        rec = self._records.get(key)
                        if (
                            key not in self._held
                            or rec is None
                            or rec.get("state") == "done"
                        ):
                            continue
                        rec["heartbeat"] = now
                        payload = dict(rec)
                    try:
                        _overwrite_json(self._lease_path(key), payload)
                    except OSError:
                        # A transiently unwritable shared FS must not kill
                        # the heartbeat; worst case the lease expires and a
                        # peer recomputes (idempotent).
                        pass

    # ------------------------------------------------------------------ claim

    def claim(self, worker: str, *, block: bool = True) -> int | None:
        """Local index of the next work item, or None when every item is
        done (all hosts) or ``stop()`` was called.  While peers still hold
        undone leases this polls — waiting out either their completion or
        their expiry — unless ``block=False``.

        All lease-file traffic (the refill ``listdir``, per-key exclusive
        publishes, expiry reads and steals) runs with ``self._lock``
        RELEASED: on a slow shared FS an O(grid) scan held under the lock
        would starve the heartbeat thread past ``lease_ttl``, getting this
        host's own *live* leases stolen and recomputed by peers."""
        while True:
            with self._lock:
                st = self._stats.setdefault(worker, WorkerStats())
                self._clock.fold(worker, st, time.monotonic())
                idx = None if self._stop.is_set() else self._serve_locked(worker, st)
                if idx is not None:
                    st.claimed += 1
                    self._clock.claimed(worker)
                    return idx
                drained = not self._not_done
            if drained or self._stop.is_set():
                return None
            if self._acquire_fs(worker):
                continue                      # fresh keys registered: serve them
            if not block:
                return None
            self._stop.wait(self.poll_s)

    def _serve_locked(self, worker: str, st: WorkerStats) -> int | None:
        """Pop from the worker's lease, rebalancing locally first — no FS
        traffic on this path."""
        lease = self._leases.setdefault(worker, [])
        if not lease:
            self._steal_local_locked(worker, st, lease)
        if not lease:
            return None
        return self._index_of[lease.pop(0)]

    def _rotated_keys(self):
        return self._keys[self._scan0:] + self._keys[: self._scan0]

    def _acquire_fs(self, worker: str) -> bool:
        """Acquire new FS leases for ``worker`` — fresh exclusive publishes
        first, expired-lease steals only when nothing is left to publish —
        and register what was won.  The lease I/O runs on snapshots taken
        under the lock; registration re-checks under the lock, so a key
        two local workers raced lands in exactly one lease (the lease file
        itself carries the same host either way)."""
        with self._lock:
            not_done = set(self._not_done)
            held = set(self._held)
        got = self._publish_fresh(worker, not_done, held)
        reclaimed = False
        retired: list[str] = []
        if not got:
            got = self._steal_expired(worker, not_done, held, retired)
            reclaimed = True
        with self._lock:
            self._not_done.difference_update(retired)
            st = self._stats.setdefault(worker, WorkerStats())
            lease = self._leases.setdefault(worker, [])
            served = False
            for key, rec in got:
                if key in self._held or key not in self._not_done:
                    continue
                self._records[key] = rec
                self._held.add(key)
                lease.append(key)
                served = True
                if reclaimed:
                    st.stolen_by += 1
                    st.reclaimed += 1
            if served:
                self._ensure_heartbeat_locked()
            return served

    def _publish_fresh(
        self, worker: str, not_done: set[str], held: set[str]
    ) -> list[tuple[str, dict]]:
        """Claim up to ``lease_size`` unclaimed items via exclusive publish."""
        try:
            existing = set(os.listdir(self.root))
        except OSError:
            return []
        got: list[tuple[str, dict]] = []
        for key in self._rotated_keys():
            if len(got) >= self._lease_size:
                break
            if key not in not_done or key in held:
                continue
            if os.path.basename(self._lease_path(key)) in existing:
                continue
            rec = self._record(key, worker, "leased")
            try:
                if _publish_exclusive(self._lease_path(key), rec):
                    got.append((key, rec))
            except OSError:
                continue
        return got

    def _steal_local_locked(self, worker: str, st: WorkerStats, lease: list[str]) -> None:
        """Rebalance within this host first (no FS traffic): same
        largest-victim/half-tail/deterministic-tie-break rule as the
        threads backend.  The moved keys stay in ``_held`` — the FS lease
        is per-host, only the serving worker changes."""
        candidates = [
            (len(l), w) for w, l in self._leases.items() if w != worker and len(l) > 1
        ]
        if not candidates:
            return
        victim = max(candidates)[1]
        vlease = self._leases[victim]
        steal = len(vlease) // 2
        if steal:
            lease.extend(vlease[-steal:])
            del vlease[-steal:]
            self._stats[victim].stolen_from += steal
            st.stolen_by += steal

    def _done_confirmed(self, key: str) -> bool | None:
        """Can a done lease for ``key`` be trusted?  True: yes — no checker
        installed, or the cells are in the manifest.  False: a done marker
        whose commit never reached the manifest (lost merge) — recompute.
        None: the check itself failed transiently; recheck next scan."""
        if self._done_check is None:
            return True
        try:
            return bool(self._done_check(key))
        except OSError:
            return None

    def _steal_expired(
        self, worker: str, not_done: set[str], held: set[str], retired: list[str]
    ) -> list[tuple[str, dict]]:
        """Overwrite leases whose heartbeat expired (dead host's tail).
        The scan doubles as done-marker discovery: peers' completed items
        — confirmed against the manifest when a ``done_check`` is
        installed — are appended to ``retired``."""
        now = time.time()
        got: list[tuple[str, dict]] = []
        for key in self._rotated_keys():
            if len(got) >= self._lease_size:
                break
            if key not in not_done or key in held:
                continue
            rec = self._read_lease(key)
            if rec is None:
                continue  # unclaimed: the next refill's exclusive publish wins it
            if rec.get("state") == "done":
                ok = self._done_confirmed(key)
                if ok is None:
                    continue
                if ok:
                    retired.append(key)
                    continue
                # Done marker with no manifest entry: nobody heartbeats a
                # done lease and resumes skip its cell, so without
                # reclaiming it HERE the cell would never be computed —
                # fall through to the overwrite regardless of ttl.
            else:
                hb = rec.get("heartbeat")
                if hb is None:
                    try:
                        hb = os.path.getmtime(self._lease_path(key))
                    except OSError:
                        continue
                if now - float(hb) <= self.lease_ttl:
                    continue
            new = self._record(key, worker, "leased", steals=int(rec.get("steals", 0) or 0) + 1)
            try:
                _overwrite_json(self._lease_path(key), new)
            except OSError:
                continue
            got.append((key, new))
        return got

    # --------------------------------------------------------------- complete

    def complete(self, worker: str, idx: int) -> None:
        key = self._key_of[idx]
        with self._lock:
            st = self._stats.setdefault(worker, WorkerStats())
            st.completed += 1
            self._clock.fold(worker, st, time.monotonic())
            self._clock.completed(worker)
            rec = self._records.pop(key, None) or self._record(key, worker, "done")
            rec["state"] = "done"
            rec["heartbeat"] = time.time()
            self._held.discard(key)
            self._not_done.discard(key)
        # The marker write runs outside self._lock (slow FS must not block
        # claims) but under _write_lock, after the discard above — see
        # _heartbeat_loop for why that ordering keeps the done marker from
        # being clobbered by a stale heartbeat.
        with self._write_lock:
            try:
                _overwrite_json(self._lease_path(key), rec)
            except OSError:
                # The cell is already committed to the manifest (commit-
                # before-done), so the marker is a skip hint, not a
                # correctness requirement: leave the lease to expire —
                # a peer's recompute dedups through the manifest — rather
                # than aborting a scan whose work actually succeeded.
                pass

    # ------------------------------------------------------------- inspection

    def remaining(self) -> int:
        """Undone items across ALL hosts (reads peers' done markers, each
        verified against the manifest when a ``done_check`` is installed —
        an unverifiable done marker still counts as remaining).  Lease
        reads run outside the lock: same heartbeat-liveness reasoning as
        ``claim``."""
        with self._lock:
            candidates = [k for k in sorted(self._not_done) if k not in self._held]
        retired = [
            key
            for key in candidates
            if (rec := self._read_lease(key)) is not None
            and rec.get("state") == "done"
            and self._done_confirmed(key)
        ]
        with self._lock:
            self._not_done.difference_update(retired)
            return len(self._not_done)

    def stats(self) -> dict[str, WorkerStats]:
        """Snapshot copies with the in-flight interval folded in — the same
        contract as the threads backend (this host's workers only; peers
        account for themselves)."""
        with self._lock:
            now = time.monotonic()
            out: dict[str, WorkerStats] = {}
            for w, st in self._stats.items():
                snap = dataclasses.replace(st)
                self._clock.snapshot_into(w, snap, now)
                out[w] = snap
            return out

    @property
    def lease_size(self) -> int:
        return self._lease_size

    def set_lease_size(self, n: int) -> None:
        """Retune future lease refills (host-local; peers tune themselves).
        Already-claimed keys are unaffected, so cross-host correctness
        cannot depend on when — or whether — a retune lands."""
        with self._lock:
            self._lease_size = max(1, int(n))

    def stop(self) -> None:
        """Unblock polling claims and stop the heartbeat thread.  Held
        leases are left to expire — exactly what a crash would do, and how
        survivors are meant to pick the items up."""
        self._stop.set()
