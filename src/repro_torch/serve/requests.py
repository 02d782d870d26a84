"""Request admission and the shared serve executor (DESIGN.md §16).

Request → work-item mapping: an admitted request (an uploaded phenotype
panel, or a marker-window query against a resident study) opens a real
``ScanSession`` over its prepared state — so planning, sinks, writers,
and the byte-identity contract are the offline scan's, unchanged — but
the session's executor is a request-scoped view (``_RequestRun``) of ONE
long-lived ``ServeExecutor``: the session's grid cells are enrolled as
work items on the single persistent ``WorkQueue`` every serve worker
drains, ordered across requests by the deficit-round-robin lease policy
(``serve.fair``).  Each request gets its own sinks and writers (its
session owns them), so concurrent clients never share fold state.

Workers compute cells exactly as the offline executors do — decode via
``engine.prepare_batch``, H2D staging through the warm ``_Slot`` from the
``StudyRegistry`` (pinned for the duration of the cell), the slot's
step, ``_live_cell`` materialization — which is what makes every served
table byte-identical to a fresh offline scan of the same panel/window.  A
worker issues a cell's CUDA work (staging, step, kernels, device-to-host
pulls) on its slot's stream; request threads prepare uploaded
panels on their own default stream and never touch a slot's.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import threading
import time
import uuid
from collections import Counter
from typing import Any

import numpy as np

import torch

from repro_torch.api.metrics import CellTiming, ScanMetrics
from repro_torch.api.session import ScanSession, _live_cell
from repro_torch.api.writers import TsvWriter
from repro_torch.runtime.device import on_stream
from repro_torch.runtime.workqueue import WorkQueue
from repro_torch.serve.fair import DeficitRoundRobin
from repro_torch.serve.state import StudyRegistry

__all__ = ["ServeExecutor", "ServeHost"]


_STOPPED = object()


class _Failure:
    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class _Once:
    """A set-once cell (per-(request, batch) decode dedup): the first
    worker to need a batch decodes it; peers block on the event."""

    __slots__ = ("_evt", "_value", "_error")

    def __init__(self) -> None:
        self._evt = threading.Event()
        self._value = None
        self._error: BaseException | None = None

    def set(self, value) -> None:
        self._value = value
        self._evt.set()

    def fail(self, error: BaseException) -> None:
        self._error = error
        self._evt.set()

    def get(self, timeout: float | None = None):
        if not self._evt.wait(timeout):
            raise TimeoutError("decode wait timed out")
        if self._error is not None:
            raise self._error
        return self._value


class _ActiveRequest:
    """Executor-side record of one enrolled session."""

    def __init__(self, request_id: str, prepared, state_key: str,
                 cells: list, weight: float):
        self.request_id = request_id
        self.prepared = prepared
        self.state_key = state_key
        self.cells = cells                      # [(MarkerBatch, TraitBlock)]
        self.weight = weight
        self.out: queue.Queue = queue.Queue(maxsize=16)
        self.cancelled = threading.Event()   # stop computing cells
        self.closed = threading.Event()      # consumer detached (retire)
        self.lock = threading.Lock()
        self.decoded: dict[int, _Once] = {}     # batch index -> host batch
        self.cells_left = Counter(b.index for b, _ in cells)


class _RequestRun:
    """The executor handle a serve ``ScanSession`` runs on: duck-types the
    session executor surface (``cells(todo, pending)`` + ``info()``) while
    the shared pool does the computing.  One per request — its generator
    is where request-scoped delivery order lives; closing it (consumer
    abort) retires the request's unleased items from the fair-share
    policy."""

    kind = "serve"
    backend = "threads"

    def __init__(self, executor: "ServeExecutor", prepared, *,
                 request_id: str, state_key: str, weight: float):
        self._ex = executor
        self._prepared = prepared
        self.request_id = request_id
        self.state_key = state_key
        self.weight = weight
        self._req: _ActiveRequest | None = None

    def info(self) -> dict:
        return {
            "kind": self.kind,
            "devices": self._ex.n_slots,
            "request": self.request_id,
            "shared_queue_remaining": self._ex.queue.remaining(),
        }

    def cells(self, todo, pending):
        prep = self._prepared
        wanted = [
            (b, blk)
            for b in todo
            for blk in prep.trait_blocks
            if pending is None or (b.index, blk.index) in pending
        ]
        req = self._req = self._ex._register(
            self.request_id, prep, self.state_key, wanted, self.weight
        )
        try:
            done = 0
            while done < len(wanted):
                try:
                    item = req.out.get(timeout=0.5)
                except queue.Empty:
                    if self._ex._stop_evt.is_set():
                        item = _STOPPED
                    else:
                        continue
                if item is _STOPPED:
                    raise RuntimeError(
                        "serve executor stopped while request "
                        f"{self.request_id} had cells in flight"
                    )
                if isinstance(item, _Failure):
                    raise item.error
                yield item
                done += 1
        finally:
            self._ex._retire(req)


class ServeExecutor:
    """The long-lived shared worker pool: one thread per device slot, all
    draining ONE persistent ``WorkQueue`` whose refill order is the
    deficit-round-robin policy.  Sessions attach via ``open()`` and detach
    when their generator closes; the pool outlives them all."""

    def __init__(self, registry: StudyRegistry, *, policy=None,
                 lease_size: int = 1):
        self.registry = registry
        self.n_slots = registry.n_slots
        self.policy = policy if policy is not None else DeficitRoundRobin()
        self.queue = WorkQueue(
            0, lease_size=lease_size, policy=self.policy, persistent=True
        )
        self._items: dict[int, tuple[str, Any, Any]] = {}  # idx -> (rid, b, blk)
        self._requests: dict[str, _ActiveRequest] = {}
        self._next_idx = 0
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._threads = [
            threading.Thread(
                target=self._worker, args=(i,), daemon=True,
                name=f"serve-worker-{i}",
            )
            for i in range(self.n_slots)
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ sessions

    def open(self, prepared, *, request_id: str, state_key: str,
             weight: float = 1.0) -> _RequestRun:
        """A request-scoped executor view for one session.  The caller
        must have ``register_state``d ``state_key`` with the registry."""
        if self._stop_evt.is_set():
            raise RuntimeError("serve executor is stopped")
        return _RequestRun(
            self, prepared, request_id=request_id, state_key=state_key,
            weight=weight,
        )

    def _register(self, rid: str, prepared, state_key: str, cells: list,
                  weight: float) -> _ActiveRequest:
        req = _ActiveRequest(rid, prepared, state_key, cells, weight)
        with self._lock:
            if self._stop_evt.is_set():
                raise RuntimeError("serve executor is stopped")
            if rid in self._requests:
                raise ValueError(f"request {rid!r} already enrolled")
            idxs = []
            for cell in cells:
                idx = self._next_idx
                self._next_idx += 1
                self._items[idx] = (rid, *cell)
                idxs.append(idx)
            self._requests[rid] = req
        self.policy.enroll(rid, idxs, weight=weight)
        self.queue.kick()
        return req

    def _retire(self, req: _ActiveRequest) -> None:
        req.cancelled.set()
        req.closed.set()
        unserved = self.policy.retire(req.request_id)
        with self._lock:
            for idx in unserved:
                self._items.pop(idx, None)
            self._requests.pop(req.request_id, None)

    # ------------------------------------------------------------- workers

    def _worker(self, slot_idx: int) -> None:
        label = f"serve/dev{slot_idx}"
        while True:
            idx = self.queue.claim(label, block=True)
            if idx is None:
                return                      # stop(): queue released us
            try:
                with self._lock:
                    entry = self._items.pop(idx, None)
                if entry is None:
                    continue                # retired while leased
                rid, batch, blk = entry
                with self._lock:
                    req = self._requests.get(rid)
                if req is None or req.cancelled.is_set():
                    continue
                try:
                    result = self._compute(req, slot_idx, label, batch, blk)
                except BaseException as e:  # noqa: BLE001 — to the consumer
                    req.cancelled.set()
                    self._deliver(req, _Failure(e))
                else:
                    self._deliver(req, result)
            finally:
                self.queue.complete(label, idx)

    def _deliver(self, req: _ActiveRequest, item) -> bool:
        """Bounded put that never wedges a shared worker: gives up only
        once the consumer has detached (request retired) — failures set
        ``cancelled`` but must still reach a live consumer."""
        while not req.closed.is_set():
            try:
                req.out.put(item, timeout=0.1)
                return True
            except queue.Full:
                if self._stop_evt.is_set():
                    return False
        return False

    def _host_batch(self, req: _ActiveRequest, batch):
        """Decode one genotype batch exactly once per request (concurrent
        workers on sibling cells share the result)."""
        with req.lock:
            once = req.decoded.get(batch.index)
            owner = once is None
            if owner:
                once = req.decoded[batch.index] = _Once()
        if owner:
            t0 = time.perf_counter()
            try:
                prep = req.prepared
                hb = prep.engine.prepare_batch(
                    prep.study.source, batch, prep.ctx
                )
            except BaseException as e:  # noqa: BLE001 — waiters must wake
                once.fail(e)
                raise
            once.set((hb, time.perf_counter() - t0))
            return once.get()
        hb, _ = once.get(timeout=600.0)
        return hb, 0.0                 # decode cost attributed to the owner

    def _compute(self, req: _ActiveRequest, slot_idx: int, label: str,
                 batch, blk):
        prep = req.prepared
        hb, decode_s = self._host_batch(req, batch)
        slot = self.registry.acquire_slot(req.state_key, slot_idx)
        try:
            with on_stream(slot.stream):
                t0 = time.perf_counter()
                # Per-slot staged memo: consecutive cells of one request's
                # batch reuse the H2D copy (the slot belongs to this worker
                # alone, so the attribute is single-threaded; the registry
                # drops it with the slot).
                memo = getattr(slot, "_serve_staged", None)
                if memo is not None and memo[0] == (req.request_id, batch.index):
                    dev_args, stage_s = memo[1], 0.0
                else:
                    ts = time.perf_counter()
                    dev_args = slot.stage(hb)
                    stage_s = time.perf_counter() - ts
                    slot._serve_staged = ((req.request_id, batch.index), dev_args)
                out = slot.step(*dev_args, slot.panel_block(batch, blk))
                slot.fence()
                t1 = time.perf_counter()
                cell = _live_cell(hb, out, blk, prep.config, prep.dof)
                t2 = time.perf_counter()
        finally:
            self.registry.release_slot(req.state_key, slot_idx)
        with req.lock:
            req.cells_left[batch.index] -= 1
            if req.cells_left[batch.index] <= 0:
                req.decoded.pop(batch.index, None)   # free host batch early
        timing = CellTiming(
            batch_index=batch.index,
            block_index=blk.index,
            n_markers=cell.n_markers,
            n_traits=cell.n_traits,
            wall_s=t2 - t0,
            step_s=t1 - t0,
            extract_s=t2 - t1,
            decode_s=decode_s,
            stage_s=stage_s,
            device=label,
        )
        return cell, timing

    # ------------------------------------------------------------ teardown

    def stop(self, *, join_timeout: float = 30.0) -> None:
        """Clean shutdown: release workers, fail in-flight sessions, join.
        Safe to call twice."""
        self._stop_evt.set()
        self.queue.stop()
        for t in self._threads:
            t.join(timeout=join_timeout)
        with self._lock:
            live = list(self._requests.values())
        for req in live:
            # Wake any consumer still blocked on its out queue; its
            # session raises and its request thread marks the request failed.
            try:
                req.out.put_nowait(_STOPPED)
            except queue.Full:
                pass

    @property
    def alive(self) -> bool:
        return any(t.is_alive() for t in self._threads)


# ----------------------------------------------------------------- the host


class _Request:
    """Service-side record of one client request's lifecycle."""

    def __init__(self, rid: str, kind: str, study_id: str, out_dir: str):
        self.rid = rid
        self.kind = kind                    # "panel" | "window"
        self.study_id = study_id
        self.out_dir = out_dir
        self.status = "queued"              # running | done | failed
        self.submitted = time.time()
        self.wall_s: float | None = None
        self.covered: tuple[int, int] | None = None
        self.summary: dict | None = None
        self.metrics: dict | None = None
        self.error: str | None = None
        self.thread: threading.Thread | None = None

    def describe(self) -> dict:
        return {
            "request": self.rid,
            "kind": self.kind,
            "study": self.study_id,
            "status": self.status,
            "wall_s": self.wall_s,
            "covered": list(self.covered) if self.covered else None,
            "summary": self.summary,
            "metrics": self.metrics,
            "error": self.error,
        }


class ServeHost:
    """The in-process serve service: registry + shared executor + request
    lifecycle.  ``server.ServeServer`` wraps this with HTTP; tests and
    ``chip_smoke.py`` drive it directly.

    Every request writes a full ``TsvWriter`` bundle (hits.tsv,
    per_trait_best.tsv, qc.tsv) into its own directory under
    ``out_root`` — request-scoped writers, byte-identical to an offline
    ``scan`` of the same panel/window.

    ``device`` is where every admitted study runs (``"cuda"``, the default,
    ``"cuda:i"`` or ``"cpu"``): it is passed into each study's plan.
    """

    RESULT_FILES = ("hits.tsv", "per_trait_best.tsv", "qc.tsv")

    def __init__(self, *, devices: int = 1, max_resident_slots: int = 8,
                 lease_size: int = 1, drr_quantum: float = 2.0,
                 default_weight: float = 1.0, out_root: str | None = None,
                 device: str | torch.device = "cuda"):
        self.registry = StudyRegistry(
            devices=devices, max_resident_slots=max_resident_slots,
            device=device,
        )
        self.device = self.registry.device
        self.policy = DeficitRoundRobin(quantum=drr_quantum)
        self.executor = ServeExecutor(
            self.registry, policy=self.policy, lease_size=lease_size
        )
        self.default_weight = default_weight
        self.metrics = ScanMetrics()
        self.out_root = out_root or tempfile.mkdtemp(prefix="repro-torch-serve-")
        self._requests: dict[str, _Request] = {}
        self._lock = threading.Lock()
        self._shutting = False
        self._counter = 0

    # ------------------------------------------------------------- studies

    def admit_study(self, study_id: str, study, *, weight: float | None = None,
                    **plan_kwargs) -> dict:
        """Make a cohort resident.  ``plan_kwargs`` are ``Study.plan``
        keywords fixed for the study's lifetime (grid geometry, engine,
        threshold); serve sessions own their executors and never
        checkpoint, so those knobs are rejected here.  The plan's device
        is the host's: a ``device`` kwarg naming another is refused."""
        for bad in ("executor", "checkpoint_dir"):
            if bad in plan_kwargs:
                raise ValueError(
                    f"plan kwarg {bad!r} is not servable: serve requests "
                    "run on the shared serve executor without checkpoints"
                )
        want = torch.device(plan_kwargs.get("device", self.device))
        if want.type != self.device.type or want.index not in (None, self.device.index):
            raise ValueError(
                f"plan kwarg device={str(want)!r} disagrees with the serve "
                f"host's device {str(self.device)!r}"
            )
        plan_kwargs["device"] = str(self.device)
        res = self.registry.admit(
            study_id, study,
            weight=self.default_weight if weight is None else weight,
            **plan_kwargs,
        )
        return res.describe()

    def warm_study(self, study_id: str) -> dict:
        """Eagerly build the resident prepared state (source scan setup,
        GRM/REML for lmm, step) so the first window query is warm — the
        serve boot path calls this."""
        res = self.registry.resident(study_id)
        t0 = time.perf_counter()
        prepared = res.prepared()
        self.registry.register_state(res.state_key, prepared)
        return {"study": study_id, "prepare_s": time.perf_counter() - t0}

    def studies(self) -> list[dict]:
        return self.registry.studies()

    # ------------------------------------------------------------ requests

    def _new_request(self, kind: str, study_id: str) -> _Request:
        with self._lock:
            if self._shutting:
                raise RuntimeError("serve host is shutting down")
            self._counter += 1
            rid = f"{kind[0]}{self._counter:04d}-{uuid.uuid4().hex[:6]}"
            req = _Request(rid, kind, study_id, os.path.join(self.out_root, rid))
            self._requests[rid] = req
            return req

    def submit_panel(self, study_id: str, phenotypes, trait_names=None, *,
                     hit_threshold_nlp: float | None = None,
                     weight: float | None = None) -> str:
        """Admit an uploaded phenotype panel against a resident study's
        cohort: same source, keep mask, and covariates; new traits.
        Returns the request id immediately; the scan runs on the shared
        pool."""
        res = self.registry.resident(study_id)
        panel = np.asarray(phenotypes)
        if panel.ndim != 2 or panel.shape[0] != res.study.n_samples:
            raise ValueError(
                f"panel must be (n_samples={res.study.n_samples}, P), "
                f"got {panel.shape}"
            )
        req = self._new_request("panel", study_id)
        w = res.weight if weight is None else float(weight)

        def drive() -> None:
            state_key = f"req:{req.rid}"
            try:
                req.status = "running"
                t0 = time.perf_counter()
                study = dataclasses.replace(
                    res.study,
                    phenotypes=panel,
                    trait_names=(
                        list(trait_names) if trait_names is not None else None
                    ),
                )
                kwargs = dict(res.plan_kwargs)
                if hit_threshold_nlp is not None:
                    kwargs["hit_threshold_nlp"] = hit_threshold_nlp
                plan = study.plan(**kwargs)
                prepared = plan.prepare()
                self.registry.register_state(state_key, prepared)
                run = self.executor.open(
                    prepared, request_id=req.rid, state_key=state_key,
                    weight=w,
                )
                session = ScanSession(prepared, resume=False, executor=run)
                summary = session.stream_to(TsvWriter(req.out_dir))
                req.wall_s = time.perf_counter() - t0
                req.summary = {
                    k: v for k, v in summary.items() if not k.endswith("_tsv")
                }
                req.metrics = session.metrics.summary()
                req.status = "done"
                self.metrics.record_request(req.wall_s, kind="panel")
            except BaseException as e:  # noqa: BLE001 — reported to client
                req.error = f"{type(e).__name__}: {e}"
                req.status = "failed"
            finally:
                self.registry.drop_state(state_key)

        self._start(req, drive)
        return req.rid

    def submit_window(self, study_id: str, lo: int, hi: int, *,
                      weight: float | None = None) -> str:
        """A marker-window query against the resident panel: reuses the
        study's prepared state (residualized panel, GRM spectrum,
        step, warm slots) — the fast path a persistent service exists
        for.  The window widens to batch boundaries; the response's
        ``covered`` range is the exact extent."""
        res = self.registry.resident(study_id)
        req = self._new_request("window", study_id)
        w = res.weight if weight is None else float(weight)

        def drive() -> None:
            try:
                req.status = "running"
                t0 = time.perf_counter()
                prepared = res.prepared()
                self.registry.register_state(res.state_key, prepared)
                run = self.executor.open(
                    prepared, request_id=req.rid, state_key=res.state_key,
                    weight=w,
                )
                session = ScanSession(
                    prepared, resume=False, executor=run,
                    marker_window=(int(lo), int(hi)),
                )
                req.covered = session.window_covered
                summary = session.stream_to(TsvWriter(req.out_dir))
                req.wall_s = time.perf_counter() - t0
                req.summary = {
                    k: v for k, v in summary.items() if not k.endswith("_tsv")
                }
                req.metrics = session.metrics.summary()
                req.status = "done"
                self.metrics.record_request(req.wall_s, kind="window")
            except BaseException as e:  # noqa: BLE001 — reported to client
                req.error = f"{type(e).__name__}: {e}"
                req.status = "failed"

        self._start(req, drive)
        return req.rid

    def _start(self, req: _Request, drive) -> None:
        req.thread = threading.Thread(
            target=drive, daemon=True, name=f"serve-request-{req.rid}"
        )
        req.thread.start()

    # -------------------------------------------------------------- status

    def request_info(self, rid: str) -> dict:
        with self._lock:
            if rid not in self._requests:
                raise KeyError(f"unknown request {rid!r}")
            return self._requests[rid].describe()

    def wait(self, rid: str, timeout: float | None = None) -> dict:
        with self._lock:
            req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request {rid!r}")
        if req.thread is not None:
            req.thread.join(timeout)
            if req.thread.is_alive():
                raise TimeoutError(f"request {rid} still running")
        return req.describe()

    def result_path(self, rid: str, name: str) -> str:
        if name not in self.RESULT_FILES:
            raise KeyError(
                f"unknown result file {name!r}; available: {self.RESULT_FILES}"
            )
        with self._lock:
            req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request {rid!r}")
        if req.status != "done":
            raise RuntimeError(f"request {rid} is {req.status}, not done")
        return os.path.join(req.out_dir, name)

    def metrics_summary(self) -> dict:
        self.metrics.set_queue_depth(self.executor.queue.remaining())
        self.metrics.set_cache_stats(
            "device_state", self.registry.slot_cache_stats()
        )
        self.metrics.set_cache_stats("panel", self.registry.panel_cache_stats())
        with self._lock:
            counts = Counter(r.status for r in self._requests.values())
        return {
            "serve": self.metrics.serve_summary(),
            "requests": dict(counts),
            "queue": {rid: n for rid, n in self.policy.queue_sizes().items()},
            "studies": self.studies(),
        }

    # ------------------------------------------------------------ teardown

    def shutdown(self, *, join_timeout: float = 30.0) -> None:
        """Stop the pool, fail in-flight requests, release every slot.
        Idempotent; leaves no serve threads behind (asserted in tests)."""
        with self._lock:
            self._shutting = True
            live = [r for r in self._requests.values() if r.thread is not None]
        self.executor.stop(join_timeout=join_timeout)
        for req in live:
            req.thread.join(timeout=join_timeout)
        self.registry.shutdown()
