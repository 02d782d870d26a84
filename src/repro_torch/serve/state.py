"""Resident cohort state for the serve subsystem (DESIGN.md §16).

``StudyRegistry`` is the warm half of scan-as-a-service: everything that
does not change across requests stays resident —

    open genotype sources       a ``ResidentStudy`` holds the bound
                                ``Study`` (source stays open, keep mask
                                and covariates stay parsed);
    prepared scan state         the resident panel's ``PreparedScan``
                                (residualized covariate basis, GRM
                                spectrum + REML for the lmm engine, step)
                                built once, lazily, and reused by every
                                marker-window query;
    warm per-slot device state  ``_Slot``s (engine device state + panel
                                view, and on a multi-slot CUDA registry one
                                stream each) cached in a ``DeviceLRU`` keyed
                                by (state, slot), ref-count-pinned while a
                                worker computes a cell, and LRU-evicted
                                (``slot.reset()``) when capacity is exceeded
                                by other studies' traffic.

Eviction rules: a slot is evictable iff no in-flight cell pins it; the
registry allows transient capacity overshoot rather than block a worker
on a fully-pinned cache.  Evicting a slot frees its device tensors (the
serve worker's staged batch memo included) but no host state — the next
request on that study pays one re-staging, not a re-prepare (cache
hit/miss/eviction counters are surfaced through serve metrics so this is
observable).
"""
from __future__ import annotations

import threading
import time
from typing import Any

import torch

from repro_torch.core.engines import DeviceLRU
from repro_torch.runtime.device import resolve_device, synchronize

__all__ = ["ResidentStudy", "StudyRegistry"]


class ResidentStudy:
    """One admitted cohort: the bound study, its plan kwargs, and the
    lazily-built resident ``PreparedScan`` (the cold cost every later
    window query on this study skips)."""

    def __init__(self, study_id: str, study, *, weight: float = 1.0,
                 plan_kwargs: dict | None = None):
        if weight <= 0:
            raise ValueError(f"study weight must be positive, got {weight}")
        self.study_id = study_id
        self.study = study
        self.weight = float(weight)
        self.plan_kwargs = dict(plan_kwargs or {})
        self.admitted_at = time.time()
        self.state_key = f"study:{study_id}"
        self._plan = None
        self._lock = threading.Lock()

    def plan(self):
        with self._lock:
            if self._plan is None:
                self._plan = self.study.plan(**self.plan_kwargs)
            return self._plan

    def prepared(self):
        """The resident panel's prepared scan (``ScanPlan.prepare`` is
        memoized; concurrent first callers serialize on the plan lock so
        setup cost is paid exactly once)."""
        plan = self.plan()
        with self._lock:
            return plan.prepare()

    def describe(self) -> dict:
        return {
            "study_id": self.study_id,
            "n_samples": self.study.n_samples,
            "n_markers": self.study.n_markers,
            "n_traits": self.study.n_traits,
            "weight": self.weight,
            "admitted_at": self.admitted_at,
            "prepared": self._plan is not None and self._plan._prepared is not None,
        }


def _release(slot) -> None:
    """Free one cached slot's device state, the serve worker's staged batch
    memo on it included."""
    slot._serve_staged = None
    slot.reset()


class StudyRegistry:
    """Multi-tenant resident state: admitted studies plus the warm
    executor-slot cache shared by every serve worker.

    Slot cache keys are ``(state_key, slot_index)`` where ``state_key``
    names one prepared scan state — ``study:<id>`` for a resident study
    (shared by all its window queries: the warm path) or ``req:<id>`` for
    an uploaded panel (ephemeral; dropped when the request finishes).
    ``acquire_slot``/``release_slot`` bracket one cell's compute with a
    pin, so concurrent requests can never evict a slot mid-step.

    ``device`` is where every admitted study runs.  One slot (``devices=1``)
    is the serial executor's slot (``device=None``): the prepared scan's own
    device on the thread's default stream.  With ``devices > 1`` on CUDA the
    slots take ``cuda:0 .. cuda:N-1`` (``device`` first), each with its own
    stream; on the CPU the N slots share the CPU.  ``devices=0`` is every
    visible card (one slot on the CPU).
    """

    def __init__(self, *, devices: int = 1, max_resident_slots: int = 8,
                 device: str | torch.device = "cuda"):
        if devices < 0:
            raise ValueError(f"devices must be >= 0, got {devices}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            n = devices if devices > 0 else torch.cuda.device_count()
            order = [self.device.index] + [i for i in range(n) if i != self.device.index]
            # resolve_device raises for a card the machine does not have
            cards = [resolve_device(f"cuda:{i}") for i in order[:n]]
        else:
            n = devices if devices > 0 else 1
            cards = [self.device] * n
        self.n_slots = n
        self._devices = [None] if n == 1 else cards
        self._studies: dict[str, ResidentStudy] = {}
        self._states: dict[str, Any] = {}       # state_key -> PreparedScan
        self._live: dict[Any, Any] = {}          # (state_key, slot) -> _Slot
        self._lock = threading.RLock()
        self._slots = DeviceLRU(
            max_resident_slots, self._load_slot, on_evict=self._evict_slot
        )

    # ------------------------------------------------------------- studies

    def admit(self, study_id: str, study, *, weight: float = 1.0,
              **plan_kwargs) -> ResidentStudy:
        with self._lock:
            if study_id in self._studies:
                raise ValueError(f"study {study_id!r} already admitted")
            res = ResidentStudy(
                study_id, study, weight=weight, plan_kwargs=plan_kwargs
            )
            self._studies[study_id] = res
            return res

    def resident(self, study_id: str) -> ResidentStudy:
        with self._lock:
            if study_id not in self._studies:
                raise KeyError(
                    f"unknown study {study_id!r}; admitted: "
                    f"{sorted(self._studies)}"
                )
            return self._studies[study_id]

    def studies(self) -> list[dict]:
        with self._lock:
            return [s.describe() for s in self._studies.values()]

    # ---------------------------------------------------------- slot cache

    def register_state(self, state_key: str, prepared) -> None:
        """Bind a prepared scan under ``state_key`` so slot loads can find
        it.  Resident studies stay registered for their lifetime; uploaded
        panels register for the request and ``drop_state`` after.

        The prepare ran on the calling thread's default stream; slots with
        streams of their own read its tensors without waiting on that
        stream, so the device is fenced first (once per prepared scan)."""
        with self._lock:
            known = self._states.get(state_key) is prepared
        if self._devices[0] is not None and not known:
            synchronize(prepared.device)
        with self._lock:
            self._states[state_key] = prepared

    def drop_state(self, state_key: str) -> None:
        """Unbind a state and reset its cached slots (ephemeral panel
        teardown — its device tensors must not outlive the request)."""
        self._slots.drop_if(lambda k: k[0] == state_key)
        with self._lock:
            self._states.pop(state_key, None)
            for key in [k for k in self._live if k[0] == state_key]:
                _release(self._live.pop(key))

    def _load_slot(self, key):
        from repro_torch.api.session import _Slot

        state_key, slot_idx = key
        with self._lock:
            prepared = self._states.get(state_key)
            if prepared is None:
                raise KeyError(f"state {state_key!r} not registered")
        slot = _Slot(
            prepared,
            device=self._devices[slot_idx],
            label=f"serve/dev{slot_idx}",
        )
        with self._lock:
            self._live[key] = slot
        return slot

    def _evict_slot(self, key) -> None:
        with self._lock:
            slot = self._live.pop(key, None)
        if slot is not None:
            _release(slot)

    def acquire_slot(self, state_key: str, slot_idx: int):
        """The warm slot for (state, slot), pinned: the caller MUST pair
        with ``release_slot`` (cell compute bracket)."""
        key = (state_key, slot_idx)
        self._slots.pin(key)
        try:
            return self._slots.get(key)
        except BaseException:
            self._slots.unpin(key)
            raise

    def release_slot(self, state_key: str, slot_idx: int) -> None:
        self._slots.unpin((state_key, slot_idx))

    def slot_device(self, slot_idx: int) -> torch.device | None:
        return self._devices[slot_idx]

    # ------------------------------------------------------------- metrics

    def slot_cache_stats(self) -> dict:
        return self._slots.stats()

    def panel_cache_stats(self) -> dict:
        """Aggregate hit/miss/eviction counters over every live slot's
        panel view plus each registered state's shared default view."""
        agg = {"hits": 0, "misses": 0, "evictions": 0}
        with self._lock:
            views = [
                s.panels for s in self._live.values() if s.panels is not None
            ]
            stores = {
                id(p.panels): p.panels
                for p in self._states.values()
                if getattr(p, "panels", None) is not None
            }
        for view in views:
            st = view.cache_stats()
            for k in agg:
                agg[k] += st[k]
        for store in stores.values():
            st = store.cache_stats()
            for k in agg:
                agg[k] += st[k]
        total = agg["hits"] + agg["misses"]
        agg["hit_rate"] = round(agg["hits"] / total, 4) if total else None
        return agg

    # ------------------------------------------------------------ teardown

    def shutdown(self) -> None:
        """Reset every cached slot and drop all resident state.  Pins are
        ignored (teardown outranks residency — workers are already joined
        when the serve host calls this)."""
        self._slots.clear()
        with self._lock:
            for slot in self._live.values():
                _release(slot)
            self._live.clear()
            self._states.clear()
            self._studies.clear()

    @property
    def n_pinned(self) -> int:
        return self._slots.n_pinned
