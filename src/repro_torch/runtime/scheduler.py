"""Grid-cell scheduling for the multi-device executor (DESIGN.md §12).

The 2-D (marker-batch x trait-block) scan grid is an embarrassingly
schedulable work surface; what distinguishes good from bad placement is
*which staged array a device gets to reuse* (Beyer & Bientinesi: sustained
throughput is bounded by stream locality and IO/compute overlap):

    marker-major   a work item is one marker batch carrying a run of trait
                   blocks: the claiming device stages the genotype batch
                   ONCE and sweeps its blocks before touching the queue
                   again.  Genotype traffic is paid once per batch across
                   the whole fleet; panel blocks re-ship per device.
    trait-major    items are single cells enumerated block-major (all
                   batches of trait block 0, then block 1, ...): contiguous
                   leases keep one panel block resident per device while
                   the genotype stream is re-read per column.  The right
                   trade when the panel block dwarfs the genotype batch.

Distribution itself is the lease/steal discipline of
``runtime.workqueue.WorkQueue`` — contiguous runs of items are leased per
claim (amortizing queue traffic), and a device that drains its lease steals
the largest remaining tail.  Items are never split: stealing therefore
happens at *marker-batch granularity* (a marker-major item is one batch's
whole sweep; a trait-major item is one batch's single cell), so a stolen
cell never tears a staged genotype batch away from the device using it.

Cells are idempotent — the checkpoint manifest deduplicates double
completion — so stealing is always safe; completion order is free, and the
sinks/writers normalize their folds (DESIGN.md §10, §12).

This module is jax-free by design: it schedules *indices*, the executor
owns devices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

from repro_torch.runtime.workqueue import WorkerStats, get_backend

__all__ = ["CellRun", "CellScheduler", "PLACEMENTS"]

PLACEMENTS = ("marker-major", "trait-major")


@dataclass(frozen=True)
class CellRun:
    """One schedulable unit: a marker batch crossed with a run of trait
    blocks — the cells a device computes off a single staged genotype
    batch.  ``blocks`` is every pending block of the batch under
    marker-major placement, exactly one under trait-major."""

    batch: Any                 # runtime.prefetch.MarkerBatch
    blocks: tuple              # runtime.prefetch.TraitBlock, ascending

    @property
    def n_cells(self) -> int:
        return len(self.blocks)


class CellScheduler:
    """Map pending grid cells onto executor slots with work stealing.

    ``batches``/``blocks`` are the planned grid axes; ``pending`` (when
    resuming) restricts the schedule to not-yet-committed cells — a batch
    with some cells committed is swept only over its pending blocks, the
    same mid-panel semantics as the serial executor.  Thread-safe:
    ``claim``/``complete`` are called concurrently from device workers.
    """

    def __init__(
        self,
        batches: Sequence[Any],
        blocks: Sequence[Any],
        pending: set[tuple[int, int]] | None = None,
        *,
        placement: str = "marker-major",
        lease_size: int = 2,
        n_workers: int | None = None,
        backend: str = "threads",
        backend_opts: dict | None = None,
    ):
        if placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {placement!r}; available: {PLACEMENTS}"
            )
        self.placement = placement

        def keep(b, k) -> bool:
            return pending is None or (b.index, k.index) in pending

        items: list[CellRun] = []
        if placement == "marker-major":
            for b in batches:
                blks = tuple(k for k in blocks if keep(b, k))
                if blks:
                    items.append(CellRun(b, blks))
        else:
            for k in blocks:
                items.extend(CellRun(b, (k,)) for b in batches if keep(b, k))
        self.items = items
        # Cap the lease so the initial hand-out spans every slot: with few
        # items and an uncapped lease the first workers would take it all,
        # and a claimed item's immediate pop leaves leases of <= 1 item —
        # unstealable, so late slots would idle for the whole scan.
        if n_workers is not None:
            lease_size = min(lease_size, max(1, len(items) // max(1, n_workers)))
        self.lease_size = max(1, lease_size)
        self.backend = backend
        # ``cell_committed`` in backend_opts is a (batch, block) -> bool
        # manifest probe supplied by the session; distributed backends need
        # it keyed by *item*, and the key->cells mapping is this class's —
        # so the translation happens here: an item's done marker is trusted
        # iff every cell this host would compute for it is in the manifest.
        opts = dict(backend_opts or {})
        cell_committed = opts.pop("cell_committed", None)
        if cell_committed is not None:
            by_key = {self._item_key(run): run for run in items}

            def done_check(key: str) -> bool:
                run = by_key.get(key)
                if run is None:
                    return True   # not an item this host schedules: nothing to verify
                return all(
                    cell_committed(run.batch.index, blk.index) for blk in run.blocks
                )

            opts["done_check"] = done_check
        self._queue = get_backend(backend)(
            len(items),
            keys=[self._item_key(run) for run in items],
            lease_size=self.lease_size,
            **opts,
        )

    def _item_key(self, run: CellRun) -> str:
        """Canonical cross-host identity of a work item.  Distributed
        backends coordinate by key, and hosts resuming with different
        local pending filters must agree on what each key means: under
        marker-major an item is the batch (whatever subset of its blocks
        is pending locally — the checkpoint dedups the overlap); under
        trait-major it is the single (batch, block) cell."""
        if self.placement == "marker-major":
            return f"b{run.batch.index:06d}"
        return f"b{run.batch.index:06d}k{run.blocks[0].index:04d}"

    @property
    def n_items(self) -> int:
        return len(self.items)

    @property
    def n_cells(self) -> int:
        return sum(run.n_cells for run in self.items)

    def claim(self, worker: str, *, block: bool = True) -> tuple[int, CellRun] | None:
        """Next work item for ``worker`` (lease refill / steal inside), or
        None when the grid is drained.  ``block=False`` is the pipelined
        executor's look-ahead probe: distributed backends return
        immediately instead of polling out peers' undone leases, so a
        worker with a cell in flight never parks on the queue."""
        idx = self._queue.claim(worker, block=block)
        if idx is None:
            return None
        return idx, self.items[idx]

    def complete(self, worker: str, idx: int) -> None:
        self._queue.complete(worker, idx)

    def set_lease_size(self, n: int) -> None:
        """Runtime retune of the per-refill lease extent (autotuning hook;
        future refills only)."""
        self.lease_size = max(1, int(n))
        self._queue.set_lease_size(n)

    def remaining(self) -> int:
        return self._queue.remaining()

    def stats(self) -> dict[str, WorkerStats]:
        return self._queue.stats()

    def stop(self) -> None:
        """Unblock any worker parked in a blocking ``claim`` (distributed
        backends poll while peers hold undone leases) — executor teardown
        must call this before joining its worker threads."""
        self._queue.stop()
