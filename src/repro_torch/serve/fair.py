"""Fair-share lease policy for the serve queue (DESIGN.md §16).

One ``WorkQueue`` feeds every serve worker, but its refill order is
delegated to this module's ``DeficitRoundRobin`` — a ``LeasePolicy``
(``runtime.workqueue``) implementing the classic deficit-round-robin
scheduler across per-request item queues:

* every admitted request enrolls its grid-cell indices as one FIFO queue
  with the owning study's *weight*;
* each scheduling round visits active queues in rotation, credits a
  queue ``quantum * weight`` cells of deficit, and leases items while
  deficit lasts;
* a queue's unspent deficit carries to its next turn, so long-run
  throughput shares converge to the weight ratio regardless of when
  requests arrive.

The consequence the serve layer cares about: a 2048-trait panel drain
cannot starve a 3-cell interactive window query — the small request's
queue gets its quantum every round and finishes within a bounded number
of big-request cells (tested in ``tests/test_torch_serve.py``).

``select``/``pending_count`` are called under the owning ``WorkQueue``'s
lock; the policy's own lock only guards its queue table against
concurrent ``enroll``/``retire`` from request threads, and no
policy method ever calls back into the work queue (lock order: queue →
policy, never the reverse).
"""
from __future__ import annotations

import threading
from collections import deque

__all__ = ["DeficitRoundRobin"]


class _RequestQueue:
    __slots__ = ("items", "weight", "deficit")

    def __init__(self, weight: float):
        self.items: deque[int] = deque()
        self.weight = weight
        self.deficit = 0.0


class DeficitRoundRobin:
    """Deficit-round-robin over per-request FIFO queues (a ``LeasePolicy``).

    Cost is one unit per grid cell: serve cells of one study share a
    geometry (same batch/block planning), so cell count is an honest
    proxy for work, and weights express *policy* (study priority), not
    size correction.
    """

    def __init__(self, *, quantum: float = 2.0):
        if quantum <= 0:
            raise ValueError(f"quantum must be positive, got {quantum}")
        self.quantum = float(quantum)
        self._queues: dict[str, _RequestQueue] = {}
        self._rotation: deque[str] = deque()
        # True while the head queue is mid-turn: a ``select`` truncated by
        # ``k`` resumes the same queue WITHOUT re-crediting its quantum —
        # otherwise small ``k`` (lease_size=1) would cap every queue at
        # one lease per visit and weights would stop mattering.
        self._head_served = False
        self._lock = threading.Lock()

    # ------------------------------------------------------------- feeding

    def enroll(self, request_id: str, items, *, weight: float = 1.0) -> None:
        """Add ``items`` (work-queue indices) under ``request_id``.  A new
        request joins the BACK of the rotation with zero deficit — it
        cannot pre-empt credit already earned by running requests."""
        if weight <= 0:
            raise ValueError(f"weight must be positive, got {weight}")
        with self._lock:
            q = self._queues.get(request_id)
            if q is None:
                q = self._queues[request_id] = _RequestQueue(float(weight))
                self._rotation.append(request_id)
            q.weight = float(weight)
            q.items.extend(int(i) for i in items)

    def retire(self, request_id: str) -> list[int]:
        """Drop a request's queue (client abort, shutdown); returns the
        item indices that were never leased so the caller can mark them
        cancelled."""
        with self._lock:
            q = self._queues.pop(request_id, None)
            if q is None:
                return []
            if self._rotation and self._rotation[0] == request_id:
                self._head_served = False
            try:
                self._rotation.remove(request_id)
            except ValueError:
                pass
            return list(q.items)

    # ----------------------------------------------------- LeasePolicy API

    def select(self, k: int) -> list[int]:
        """Up to ``k`` items in deficit-round-robin order.  Called under
        the work queue's lock (see module docstring)."""
        out: list[int] = []
        with self._lock:
            if k <= 0 or not self._rotation:
                return out
            # Bounded sweeps: each full rotation with no empty queues
            # grows every deficit by quantum*weight >= quantum*min_weight,
            # so progress is guaranteed; empty queues leave the rotation.
            while len(out) < k and self._rotation:
                rid = self._rotation[0]
                q = self._queues[rid]
                if not q.items:
                    # Drained between enrolls: fall out of the rotation
                    # (and forfeit deficit) until the next enroll.
                    q.deficit = 0.0
                    self._rotation.popleft()
                    self._queues.pop(rid, None)
                    self._head_served = False
                    continue
                if not self._head_served:
                    q.deficit += self.quantum * q.weight
                    self._head_served = True
                while q.items and q.deficit >= 1.0 and len(out) < k:
                    out.append(q.items.popleft())
                    q.deficit -= 1.0
                if not q.items:
                    q.deficit = 0.0
                    self._rotation.popleft()
                    self._queues.pop(rid, None)
                    self._head_served = False
                elif q.deficit < 1.0:
                    # Turn spent: next queue gets the head.
                    self._rotation.rotate(-1)
                    self._head_served = False
                else:
                    # Truncated by k mid-turn: resume this queue on the
                    # next select, no fresh quantum.
                    break
            return out

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(q.items) for q in self._queues.values())

    # ------------------------------------------------------------- reading

    def queue_sizes(self) -> dict[str, int]:
        """Live per-request backlog (serve metrics/debug)."""
        with self._lock:
            return {rid: len(q.items) for rid, q in self._queues.items()}
