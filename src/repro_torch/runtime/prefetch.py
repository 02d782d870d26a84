"""Host-side pipeline: plan marker batches, decode/repack on worker threads,
overlap with device compute through a bounded queue, and double-buffer the
host->device transfer.

Four cooperating pieces (DESIGN.md §3, §10):

``BatchPlanner``      maps the global marker range onto ``MarkerBatch`` work
                      items.  Batches never cross a shard boundary of a
                      multi-file source, so every item is one contiguous read
                      from one file — items from different files then stream
                      and prefetch concurrently on the worker pool.
``TraitBlockPlanner`` maps the trait (phenotype) axis onto ``TraitBlock``
                      tiles, making the scan a 2-D (marker-batch x
                      trait-block) grid.  The marker stream is the outer
                      loop, so each staged genotype batch is reused across
                      every resident trait block before the next H2D copy.
``Prefetcher``        runs the engine's host-side batch preparation on worker
                      threads, yielding in submission order with a bounded
                      in-flight window.
``double_buffer``     issues the (async) host->device transfer for batch k+1
                      while the device computes on batch k.

The GWAS scan is IO-bound on the genotype stream when the fused kernel path
is active (2-bit slabs are only N/4 bytes per marker), so a shallow queue and
one or two decode workers keep the device saturated; both knobs are config.

Under packed genotype staging (DESIGN.md §17) the currency these workers
carry is the raw 2-bit slab itself: ``prepare_batch`` reads through the
shared ``repro_torch.io.packed_cache`` LRU (one disk read per (source, batch)
across scan, GRM, and serve consumers) and the float decode happens on
device, so a "decode" worker's cost drops to a memcpy plus per-marker stat
LUTs.  The pipeline shape here is unchanged — only the payload shrinks ~16x.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, TypeVar

from repro_torch.runtime import spans

T = TypeVar("T")
U = TypeVar("U")
V = TypeVar("V")

__all__ = [
    "MarkerBatch",
    "BatchPlanner",
    "TraitBlock",
    "TraitBlockPlanner",
    "Prefetcher",
    "DecodePool",
    "double_buffer",
]

_SENTINEL = object()


@dataclass(frozen=True)
class MarkerBatch:
    """One schedulable unit of scan work: a contiguous global marker range
    that maps onto a single genotype shard (file)."""

    index: int       # position in the plan == checkpoint batch id
    lo: int          # global marker start (inclusive)
    hi: int          # global marker end (exclusive)
    source_id: int   # shard ordinal (0 for single-file sources)
    local_lo: int    # the same range in the shard's own marker indexing
    local_hi: int

    @property
    def n_markers(self) -> int:
        return self.hi - self.lo


class BatchPlanner:
    """Deterministically decompose a genotype source into ``MarkerBatch``es.

    Sources exposing ``shard_boundaries`` (e.g. ``io.MultiFileSource``) get a
    boundary-respecting plan; plain sources get the classic fixed-stride
    decomposition.  The plan depends only on (source layout, batch_markers),
    never on mesh/host topology, so checkpoints stay elastic across restarts.
    """

    def __init__(self, batch_markers: int):
        if batch_markers <= 0:
            raise ValueError(f"batch_markers must be positive, got {batch_markers}")
        self.batch_markers = batch_markers

    def plan(self, source: Any) -> list[MarkerBatch]:
        boundaries = tuple(
            getattr(source, "shard_boundaries", None) or (0, source.n_markers)
        )
        b = self.batch_markers
        out: list[MarkerBatch] = []
        for sid, (base, end) in enumerate(zip(boundaries[:-1], boundaries[1:])):
            for lo in range(base, end, b):
                hi = min(lo + b, end)
                out.append(
                    MarkerBatch(
                        index=len(out),
                        lo=lo,
                        hi=hi,
                        source_id=sid,
                        local_lo=lo - base,
                        local_hi=hi - base,
                    )
                )
        return out


@dataclass(frozen=True)
class TraitBlock:
    """One tile of the trait (phenotype) axis — the second dimension of the
    2-D scan grid.  ``index`` is the block ordinal; ``lo:hi`` the global
    trait range the block covers."""

    index: int
    lo: int          # global trait start (inclusive)
    hi: int          # global trait end (exclusive)

    @property
    def n_traits(self) -> int:
        return self.hi - self.lo


class TraitBlockPlanner:
    """Deterministically tile the trait axis into ``TraitBlock``s.

    ``trait_block=0`` (the default) means unblocked: one block spanning the
    whole panel, which reproduces the classic 1-D scan exactly.  Like the
    marker plan, the decomposition depends only on (n_traits, trait_block,
    quantum), never on topology, so checkpoint grid cells stay valid across
    restarts.

    ``quantum`` is the panel-axis *compute tile* of the device steps
    (``ScanConfig.block_p``; the fused kernel's p-tile and the dense/lmm
    GEMM's ``trait_tile``).  A non-zero ``trait_block`` is rounded UP to a
    multiple of it, so every block is a union of whole, globally-aligned
    compute tiles: each tile's GEMM is then the *same shape over the same
    columns* no matter how the trait axis is blocked — the mechanism behind
    the blocked == unblocked bitwise contract (DESIGN.md §10).  GEMM
    micro-kernels group accumulators by output width, so unaligned blocks
    would compute last bits differently.
    """

    def __init__(self, trait_block: int = 0, *, quantum: int = 1):
        if trait_block < 0:
            raise ValueError(f"trait_block must be >= 0, got {trait_block}")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if trait_block:
            trait_block = ((trait_block + quantum - 1) // quantum) * quantum
        self.trait_block = trait_block
        self.quantum = quantum

    def plan(self, n_traits: int) -> list[TraitBlock]:
        if n_traits <= 0:
            raise ValueError(f"n_traits must be positive, got {n_traits}")
        b = self.trait_block or n_traits
        return [
            TraitBlock(index=i, lo=lo, hi=min(lo + b, n_traits))
            for i, lo in enumerate(range(0, n_traits, b))
        ]


def double_buffer(items: Iterable[T], stage: Callable[[T], V]) -> Iterator[V]:
    """Stage item k+1 (issue its async host->device transfer) before the
    consumer finishes computing on item k — classic two-deep pipelining.

    ``stage`` must only *launch* the transfer (a ``non_blocking`` copy from
    a pinned host buffer is asynchronous on a CUDA device); the device
    runtime overlaps the copy with whatever the consumer enqueued for item k.
    """
    staged: V | object = _SENTINEL
    for item in items:
        nxt = stage(item)
        if staged is not _SENTINEL:
            yield staged  # type: ignore[misc]
        staged = nxt
    if staged is not _SENTINEL:
        yield staged  # type: ignore[misc]


class DecodePool:
    """Dynamic-submission sibling of ``Prefetcher`` for the pipelined
    multi-device executor (DESIGN.md §15).

    ``Prefetcher`` walks a *static* item list in order — the serial
    executor's shape.  Device workers instead discover their items one
    lease at a time from the scheduler, so they need submit/collect:
    ``submit(key, item)`` enqueues ``fn(item)`` on the shared worker pool
    and ``result(key)`` blocks until that result (re-raising the worker's
    exception, so a decode failure surfaces on the submitting worker's
    claim loop, not in a log).  The pool is shared across every device
    slot: total host decode parallelism is ``num_workers`` —
    ``ScanConfig.io_workers`` means the same thing it means for the serial
    executor's ``Prefetcher``, however many devices drain the grid.

    Keys are caller-chosen and must be unique among in-flight submissions
    (the executor uses ``(slot, batch_index)``).  ``shutdown`` drops
    pending tasks, lets in-flight ones finish, and joins the threads —
    the error-path teardown contract, same as ``Prefetcher``.
    """

    def __init__(self, fn: Callable[[Any], Any], *, num_workers: int = 2,
                 name: str = "slot-decode"):
        self._fn = fn
        self._tasks: list[tuple[Any, Any]] = []       # (key, item) FIFO
        self._results: dict[Any, object] = {}
        self._errors: dict[Any, BaseException] = {}
        self._pending: set[Any] = set()               # submitted, unserved
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._stop = False
        self._workers = [
            threading.Thread(target=self._worker, daemon=True, name=f"{name}-{i}")
            for i in range(max(1, num_workers))
        ]
        for w in self._workers:
            w.start()

    def submit(self, key: Any, item: Any) -> None:
        with self._lock:
            if self._stop:
                return
            if key in self._pending:
                raise ValueError(f"duplicate in-flight decode key {key!r}")
            self._pending.add(key)
            self._tasks.append((key, item))
            self._ready.notify_all()

    def result(self, key: Any) -> Any:
        """Block until ``key``'s decode lands, pop it, re-raise its error."""
        with self._lock:
            if key in self._results or key in self._errors:
                return self._take(key)
            with spans.span("batch_wait"):
                while not (key in self._results or key in self._errors):
                    if self._stop:
                        raise RuntimeError(f"DecodePool stopped before {key!r} resolved")
                    if key not in self._pending:
                        raise KeyError(f"decode key {key!r} was never submitted")
                    self._ready.wait()
            return self._take(key)

    def _take(self, key: Any) -> Any:
        """Pop a landed result (caller holds the lock)."""
        self._pending.discard(key)
        if key in self._errors:
            raise self._errors.pop(key)
        return self._results.pop(key)

    def ready(self, key: Any) -> bool:
        """Non-blocking probe: has ``key``'s decode landed (result or
        error)?  Lets a pipelined worker stage early without risking a
        block on an unfinished decode."""
        with self._lock:
            return key in self._results or key in self._errors

    def discard(self, key: Any) -> None:
        """Forget a submission whose result is no longer wanted (teardown
        of a worker's look-ahead).  In-flight work completes and is dropped;
        queued work is cancelled."""
        with self._lock:
            self._tasks = [(k, it) for k, it in self._tasks if k != key]
            self._results.pop(key, None)
            self._errors.pop(key, None)
            self._pending.discard(key)
            self._ready.notify_all()

    def _worker(self) -> None:
        while True:
            with self._lock:
                while not self._stop and not self._tasks:
                    self._ready.wait()
                if self._stop:
                    return
                key, item = self._tasks.pop(0)
            try:
                out = self._fn(item)
                with self._lock:
                    if key in self._pending:
                        self._results[key] = out
                    self._ready.notify_all()
            except BaseException as e:  # noqa: BLE001 — reported to submitter
                with self._lock:
                    if key in self._pending:
                        self._errors[key] = e
                    self._ready.notify_all()

    def shutdown(self, *, join_timeout: float = 5.0) -> None:
        """Stop the pool and join worker threads (idempotent)."""
        with self._lock:
            self._stop = True
            self._tasks.clear()
            self._ready.notify_all()
        for w in self._workers:
            if w.is_alive() and w is not threading.current_thread():
                w.join(timeout=join_timeout)


class Prefetcher:
    """Run ``fn`` over ``items`` on ``num_workers`` threads, yielding results
    in submission order with at most ``depth`` items in flight.

    Ordered delivery matters: scan batches commit in order per shard file,
    and the device stream consumes deterministically.  Workers pull from a
    shared index so a slow item (straggler) never idles the other workers —
    they keep filling the window behind it.
    """

    def __init__(
        self,
        items: Iterable[T],
        fn: Callable[[T], U],
        *,
        depth: int = 3,
        num_workers: int = 2,
    ):
        self._items = list(items)
        self._fn = fn
        self._depth = max(1, depth)
        self._results: dict[int, object] = {}
        self._errors: dict[int, BaseException] = {}
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._next_submit = 0
        self._next_yield = 0
        self._stop = False
        self._workers = [
            threading.Thread(target=self._worker, daemon=True, name=f"prefetch-worker-{i}")
            for i in range(max(1, num_workers))
        ]

    def _claim(self) -> int | None:
        with self._lock:
            while not self._stop:
                if self._next_submit >= len(self._items):
                    return None
                # Window control: stay at most `depth` ahead of the consumer.
                if self._next_submit - self._next_yield < self._depth:
                    idx = self._next_submit
                    self._next_submit += 1
                    return idx
                self._ready.wait(timeout=0.1)
            return None

    def _worker(self) -> None:
        while True:
            idx = self._claim()
            if idx is None:
                return
            try:
                out = self._fn(self._items[idx])
                with self._lock:
                    self._results[idx] = out
                    self._ready.notify_all()
            except BaseException as e:  # noqa: BLE001 — reported to consumer
                with self._lock:
                    self._errors[idx] = e
                    self._ready.notify_all()

    def _landed(self) -> bool:
        """Has the next item in order landed (caller holds the lock)?"""
        return self._next_yield in self._results or self._next_yield in self._errors

    def shutdown(self, *, join_timeout: float = 5.0) -> None:
        """Stop the worker pool and join the threads (idempotent).

        Called by the consumer's error path as well as normal exhaustion:
        a sink or engine step raising mid-scan must not leave decode workers
        alive, still pulling from the genotype source.
        """
        with self._lock:
            self._stop = True
            self._ready.notify_all()
        for w in self._workers:
            if w.is_alive() and w is not threading.current_thread():
                w.join(timeout=join_timeout)

    def __iter__(self) -> Iterator[U]:
        for w in self._workers:
            w.start()
        try:
            while self._next_yield < len(self._items):
                with self._lock:
                    if not self._landed():
                        with spans.span("batch_wait"):
                            while not self._landed():
                                self._ready.wait()
                    idx = self._next_yield
                    err = self._errors.pop(idx, None)
                    out = self._results.pop(idx, None)
                    self._next_yield += 1
                    self._ready.notify_all()
                if err is not None:
                    raise err
                yield out  # type: ignore[misc]
        finally:
            self.shutdown()
