"""Streaming result writers — the *emit* layer of the public API.

Writers consume ``ScanSession.events()`` cell by cell and persist results
incrementally, so a paper-scale scan's outputs never exist as dense
(markers x traits) host arrays (the ROADMAP "streaming summary-stat
writers" item).  Host residency is bounded per output class:

    hits      unbounded over a scan  ->  streamed: cells buffer per marker
              batch (sorted runs), flush batch-by-batch in marker order,
              spill to npz parts past ``spill_rows``
    best      (P,)  per-trait accumulators  ->  folded, written at close
    QC        (M,)  per-marker tracks       ->  folded, written at close
    lambda    O(64 x batches) probe samples ->  folded, written at close

The registry makes formats pluggable:

    @register_writer("parquet")
    class ParquetWriter(ResultWriter): ...

    session.stream_to(get_writer("tsv")(out_dir))

Built-ins: ``"tsv"`` (sorted hits.tsv + per_trait_best.tsv + qc.tsv,
matching the CLI's historical column layout) and ``"npz"`` (per-cell hit
shards plus best/qc npz bundles — the machine-readable mirror).
``"parquet"`` registers only when ``pyarrow`` imports (the container has
no hard dependency): a sorted columnar hit table with one row group per
flushed marker batch, so query engines can prune row groups by marker
range.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core.sinks import BestTraitSink, LambdaGCSink, QCSink
from repro_torch.runtime import spans

__all__ = [
    "ResultWriter",
    "TsvWriter",
    "NpzShardWriter",
    "register_writer",
    "get_writer",
    "available_writers",
    "stream_session",
]


class ResultWriter:
    """One output format; consumes cells, never accumulates (M x P) state.

    Lifecycle: ``open(session)`` once, ``write(cell)`` per event,
    ``close()`` exactly once on success (returns a summary dict merged into
    the run summary), ``abort()`` on any failure (must not raise).
    """

    name: str = "?"

    def open(self, session: Any) -> None:
        raise NotImplementedError

    def write(self, cell: Any) -> None:
        raise NotImplementedError

    def close(self) -> dict:
        return {}

    def abort(self) -> None:
        """Best-effort cleanup after a failed stream (never raises)."""


_WRITERS: dict[str, type[ResultWriter]] = {}


def register_writer(name: str) -> Callable[[type[ResultWriter]], type[ResultWriter]]:
    def deco(cls: type[ResultWriter]) -> type[ResultWriter]:
        cls.name = name
        _WRITERS[name] = cls
        return cls

    return deco


def get_writer(name: str) -> type[ResultWriter]:
    try:
        return _WRITERS[name]
    except KeyError:
        raise ValueError(
            f"unknown result writer {name!r}; available: {available_writers()}"
        ) from None


def available_writers() -> list[str]:
    return sorted(_WRITERS)


def stream_session(session: Any, writers: Sequence[ResultWriter]) -> dict:
    """Drive a session's events through writers with clean teardown: the
    generator is closed (tearing down prefetch workers) and every writer
    opened so far is aborted if anything raises — a failing ``open`` of a
    later writer included."""
    opened: list[ResultWriter] = []
    gen = None
    try:
        for w in writers:
            w.open(session)
            opened.append(w)
        gen = session.events()
        for cell in gen:
            with spans.span("deliver", batch=cell.batch_index, block=cell.block_index):
                for w in writers:
                    w.write(cell)
    except BaseException:
        for w in opened:
            w.abort()
        raise
    finally:
        if gen is not None:
            gen.close()
    summary: dict = {}
    for w in writers:
        summary.update(w.close() or {})
    return summary


# ----------------------------------------------------------- hit streaming


class _AsyncFlusher:
    """One background thread running the format-specific hit emission
    (DESIGN.md §15), so writer I/O (TSV ``writelines``, parquet row
    groups, npz shards) overlaps the consumer's next cells instead of
    blocking them.

    Strictly FIFO — submission order IS emission order, so the output
    bytes are identical to the synchronous path.  A failing emission is
    captured and re-raised on the consumer thread at the next
    ``submit``/``finish`` (never swallowed); later queued emissions are
    skipped.  The queue is bounded, so a slow disk backpressures the scan
    instead of buffering unbounded sorted runs.
    """

    def __init__(self, emit: Callable[[np.ndarray, np.ndarray], None],
                 *, name: str = "hit-flush"):
        self._emit = emit
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._error: BaseException | None = None
        self._aborted = False
        self._thread = threading.Thread(target=self._run, daemon=True, name=name)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._error is not None or self._aborted:
                continue
            try:
                self._emit(*item)
            except BaseException as e:  # noqa: BLE001 — re-raised on consumer
                self._error = e

    def check(self) -> None:
        if self._error is not None:
            err = self._error
            self._aborted = True      # no further emissions after a failure
            raise err

    def submit(self, hits: np.ndarray, stats: np.ndarray) -> None:
        self.check()
        self._q.put((hits, stats))

    def finish(self) -> None:
        """Drain every queued emission, join, re-raise any failure."""
        self._q.put(None)
        self._thread.join()
        self.check()

    def abort(self) -> None:
        """Stop emitting and join (best-effort, never raises: a wedged
        emission leaves a daemon thread behind rather than hanging the
        abort path)."""
        self._aborted = True
        try:
            self._q.put(None, timeout=1.0)
        except queue.Full:
            pass
        self._thread.join(timeout=5.0)


class _BatchedHitStream:
    """Order-restoring, RAM-bounded hit stream.

    Cells arrive marker-batch-major in a fresh scan but may arrive out of
    order when a resumed session replays committed cells after the live
    ones.  Each batch's cell runs are held (or spilled) until all of the
    batch's trait blocks have reported, then complete batches are emitted
    strictly in batch-index order — and batch index order IS global marker
    order (the planner never reorders the marker axis), so concatenated
    emissions are globally sorted by (marker, trait).

    Resident rows are capped: past ``spill_rows`` every pending run is
    flushed to per-batch npz parts and re-read only at emission.  Peak
    *buffered* residency is therefore one cell's rows plus the cap
    (``peak_rows_in_ram``); emission additionally materializes one marker
    batch's rows transiently for the within-batch sort
    (``peak_flush_rows``).  Both bounds are independent of the scan length
    and the panel width — the streaming-writer contract the api tests
    assert.
    """

    def __init__(
        self,
        n_blocks: int,
        emit: Callable[[np.ndarray, np.ndarray], None],
        *,
        spill_dir: str,
        spill_rows: int = 2_000_000,
        async_flush: bool = True,
    ):
        self._expected = max(1, n_blocks)
        self._emit = emit
        # Async flush (DESIGN.md §15): the order-restoring bookkeeping
        # (_pending, spill parts, the within-batch sort) stays on the
        # consumer thread; only the format-specific emission of the
        # already-sorted arrays moves to the flusher, which preserves
        # submission order — so the output bytes are identical, the
        # consumer just stops waiting on the disk.
        self._flusher = _AsyncFlusher(emit) if async_flush else None
        self._spill_dir = spill_dir
        self._spill_rows = max(1, spill_rows)
        # batch -> {"runs": [(hits, stats)], "parts": [paths], "seen": int}
        self._pending: dict[int, dict] = {}
        self._next_emit = 0
        self._max_seen = -1
        self.rows_in_ram = 0
        self.peak_rows_in_ram = 0
        self.peak_flush_rows = 0
        self.total_rows = 0

    def _entry(self, b: int) -> dict:
        return self._pending.setdefault(b, {"runs": [], "parts": [], "seen": 0})

    def add(self, cell: Any) -> None:
        if self._flusher is not None:
            self._flusher.check()     # surface an emission failure promptly
        e = self._entry(cell.batch_index)
        e["runs"].append((cell.hits, cell.hit_stats))
        e["seen"] += 1
        self.rows_in_ram += len(cell.hits)
        self.total_rows += len(cell.hits)
        self.peak_rows_in_ram = max(self.peak_rows_in_ram, self.rows_in_ram)
        self._max_seen = max(self._max_seen, cell.batch_index)
        while self._next_emit in self._pending and (
            self._pending[self._next_emit]["seen"] >= self._expected
        ):
            self._flush(self._next_emit)
            self._next_emit += 1
        if self.rows_in_ram > self._spill_rows:
            self._spill_all()

    def _spill_all(self) -> None:
        os.makedirs(self._spill_dir, exist_ok=True)
        for b, e in self._pending.items():
            if not e["runs"]:
                continue
            hits = np.concatenate([h for h, _ in e["runs"]])
            stats = np.concatenate([s for _, s in e["runs"]])
            part = os.path.join(
                self._spill_dir, f"hits_batch_{b:06d}_{len(e['parts']):04d}.npz"
            )
            tmp = part + ".tmp.npz"
            np.savez(tmp, hits=hits, hit_stats=stats)
            os.replace(tmp, part)
            e["parts"].append(part)
            e["runs"].clear()
        self.rows_in_ram = 0

    def _flush(self, b: int) -> None:
        # The entry stays in _pending until the emit succeeds: a raising
        # emit (disk full mid-write) leaves its spill parts reachable for
        # abort() cleanup instead of orphaning them.
        e = self._pending[b]
        hits_runs = [np.zeros((0, 2), np.int32)]
        stats_runs = [np.zeros((0, 3), np.float32)]
        for part in e["parts"]:
            with np.load(part) as z:
                hits_runs.append(z["hits"])
                stats_runs.append(z["hit_stats"])
        hits_runs.extend(h for h, _ in e["runs"])
        stats_runs.extend(s for _, s in e["runs"])
        hits = np.concatenate(hits_runs)
        stats = np.concatenate(stats_runs)
        self.peak_flush_rows = max(self.peak_flush_rows, len(hits))
        # One batch's rows, sorted (marker, trait) — the within-batch merge.
        order = np.lexsort((hits[:, 1], hits[:, 0]))
        if self._flusher is not None:
            self._flusher.submit(hits[order], stats[order])
        else:
            self._emit(hits[order], stats[order])
        self._pending.pop(b)
        self.rows_in_ram -= sum(len(h) for h, _ in e["runs"])
        for part in e["parts"]:
            if os.path.exists(part):
                os.unlink(part)

    def finish(self) -> None:
        """Emit whatever is pending (partial batches of an interrupted grid
        included) in batch order, then drain the flusher — every emission
        has hit the format layer (and any failure has surfaced) before the
        writer's own close runs."""
        for b in sorted(self._pending):
            self._flush(b)
        if self._flusher is not None:
            self._flusher.finish()

    def abort(self) -> None:
        if self._flusher is not None:
            self._flusher.abort()
        for e in self._pending.values():
            for part in e["parts"]:
                if os.path.exists(part):
                    os.unlink(part)
        self._pending.clear()
        self.rows_in_ram = 0


# ------------------------------------------------------------ base bundler


class _AccumulatingWriter(ResultWriter):
    """Shared skeleton: fold best/QC/lambda through the (P)- and (M)-bounded
    sinks, stream hits through ``_BatchedHitStream``.  Subclasses implement
    the actual emission format."""

    def __init__(self, out_dir: str, *, spill_rows: int = 2_000_000,
                 marker_ids: Sequence[str] | None = None,
                 trait_names: Sequence[str] | None = None,
                 async_flush: bool = True):
        self.out_dir = out_dir
        self.spill_rows = spill_rows
        self.async_flush = async_flush
        self.marker_ids = marker_ids
        self.trait_names = trait_names
        self._session: Any = None
        self._hits: _BatchedHitStream | None = None
        self._best: BestTraitSink | None = None
        self._qc: QCSink | None = None
        self._lam: LambdaGCSink | None = None

    # subclass hooks -------------------------------------------------------

    def _start(self) -> None: ...
    def _emit_hits(self, hits: np.ndarray, stats: np.ndarray) -> None: ...
    def _finish(self, fields: dict) -> dict: ...

    # lifecycle ------------------------------------------------------------

    def open(self, session: Any) -> None:
        self._session = session
        os.makedirs(self.out_dir, exist_ok=True)
        if self.marker_ids is None:
            self.marker_ids = getattr(session, "marker_ids", None)
        if self.trait_names is None:
            self.trait_names = getattr(session, "trait_names", None)
        self._best = BestTraitSink(session.n_traits)
        self._qc = QCSink(
            session.n_markers,
            multivariate=bool(getattr(session, "multivariate", False)),
        )
        self._lam = LambdaGCSink()
        self._hits = _BatchedHitStream(
            session.n_trait_blocks,
            self._emit_hits,
            spill_dir=os.path.join(self.out_dir, ".hit_runs"),
            spill_rows=self.spill_rows,
            async_flush=self.async_flush,
        )
        self._start()

    def write(self, cell: Any) -> None:
        self._best.on_cell(cell)
        self._qc.on_cell(cell)
        self._lam.on_cell(cell)
        self._hits.add(cell)

    def close(self) -> dict:
        self._hits.finish()
        fields: dict = {}
        for sink in (self._best, self._qc, self._lam):
            fields.update(sink.result())
        summary = self._finish(fields)
        runs_dir = os.path.join(self.out_dir, ".hit_runs")
        if os.path.isdir(runs_dir) and not os.listdir(runs_dir):
            os.rmdir(runs_dir)
        return summary

    def abort(self) -> None:
        if self._hits is not None:
            self._hits.abort()

    # naming ---------------------------------------------------------------

    def _marker_name(self, m: int) -> str:
        return str(self.marker_ids[m]) if self.marker_ids is not None else str(m)

    def _trait_name(self, t: int) -> str:
        return str(self.trait_names[t]) if self.trait_names is not None else f"trait{t}"

    @property
    def peak_hit_rows_in_ram(self) -> int:
        return self._hits.peak_rows_in_ram if self._hits else 0


# ---------------------------------------------------------------- builtins


@register_writer("tsv")
class TsvWriter(_AccumulatingWriter):
    """Sorted streaming TSV bundle, column-compatible with the historical
    CLI outputs:

        hits.tsv            marker  trait  r  t  neglog10p   (sorted by
                            (marker, trait); written batch-by-batch)
        per_trait_best.tsv  trait  best_marker  neglog10p
        qc.tsv              marker  maf  valid [omnibus_neglog10p]
    """

    def _start(self) -> None:
        self._hits_path = os.path.join(self.out_dir, "hits.tsv")
        self._f = open(self._hits_path, "w")
        self._f.write("marker\ttrait\tr\tt\tneglog10p\n")

    def _emit_hits(self, hits: np.ndarray, stats: np.ndarray) -> None:
        self._f.writelines(
            f"{self._marker_name(m)}\t{self._trait_name(t)}\t"
            f"{r:.5f}\t{tt:.4f}\t{nlp:.3f}\n"
            for (m, t), (r, tt, nlp) in zip(hits, stats)
        )

    def _finish(self, fields: dict) -> dict:
        self._f.close()
        best_path = os.path.join(self.out_dir, "per_trait_best.tsv")
        with open(best_path, "w") as f:
            f.write("trait\tbest_marker\tneglog10p\n")
            for t in range(self._session.n_traits):
                m = int(fields["best_marker"][t])
                mid = self._marker_name(m) if m >= 0 else "NA"
                f.write(f"{self._trait_name(t)}\t{mid}\t{fields['best_nlp'][t]:.3f}\n")
        qc_path = os.path.join(self.out_dir, "qc.tsv")
        omni = fields.get("omnibus_nlp")
        with open(qc_path, "w") as f:
            cols = "marker\tmaf\tvalid"
            f.write(cols + ("\tomnibus_neglog10p\n" if omni is not None else "\n"))
            for m in range(self._session.n_markers):
                row = (f"{self._marker_name(m)}\t{fields['maf'][m]:.5f}"
                       f"\t{int(fields['valid'][m])}")
                if omni is not None:
                    row += f"\t{omni[m]:.3f}"
                f.write(row + "\n")
        return {
            "hits": self._hits.total_rows,
            "lambda_gc": fields["lambda_gc"],
            "hits_tsv": self._hits_path,
            "per_trait_best_tsv": best_path,
            "qc_tsv": qc_path,
        }

    def abort(self) -> None:
        super().abort()
        f = getattr(self, "_f", None)
        if f is not None and not f.closed:
            f.close()


class ParquetHitWriter(_AccumulatingWriter):
    """Columnar Arrow/Parquet bundle (the ROADMAP "parquet writer" item).

    ``hits.parquet`` streams exactly like the TSV's hit table — the
    order-restoring ``_BatchedHitStream`` emits one sorted run per marker
    batch, and each run becomes ONE ROW GROUP, so the file is globally
    sorted by (marker, trait) and engines prune row groups by marker
    range.  ``per_trait_best.parquet`` and ``qc.parquet`` follow at close.

    The schema is byte-stable by construction: fixed field names/types
    (below), explicit uncompressed pages, no embedded timestamps — two
    scans of the same study produce byte-identical files, which is how the
    executor tests compare columnar output across device counts.  The
    writer registers under ``"parquet"`` only when ``pyarrow`` imports;
    without it the name simply isn't in ``available_writers()`` (tests
    skip, not fail).
    """

    SCHEMA = [            # (name, pyarrow type factory name)
        ("marker", "string"),
        ("trait", "string"),
        ("marker_index", "int32"),
        ("trait_index", "int32"),
        ("r", "float32"),
        ("t", "float32"),
        ("neglog10p", "float32"),
    ]

    def _schema(self):
        import pyarrow as pa

        return pa.schema([(n, getattr(pa, t)()) for n, t in self.SCHEMA])

    def _start(self) -> None:
        import pyarrow.parquet as pq

        self._hits_path = os.path.join(self.out_dir, "hits.parquet")
        self._pq = pq.ParquetWriter(
            self._hits_path, self._schema(), compression="NONE"
        )
        self._row_groups = 0

    def _emit_hits(self, hits: np.ndarray, stats: np.ndarray) -> None:
        if not len(hits):
            return
        import pyarrow as pa

        table = pa.table(
            {
                "marker": [self._marker_name(m) for m in hits[:, 0]],
                "trait": [self._trait_name(t) for t in hits[:, 1]],
                "marker_index": pa.array(hits[:, 0], pa.int32()),
                "trait_index": pa.array(hits[:, 1], pa.int32()),
                "r": pa.array(stats[:, 0], pa.float32()),
                "t": pa.array(stats[:, 1], pa.float32()),
                "neglog10p": pa.array(stats[:, 2], pa.float32()),
            },
            schema=self._schema(),
        )
        self._pq.write_table(table)   # one row group per flushed marker batch
        self._row_groups += 1

    def _finish(self, fields: dict) -> dict:
        import pyarrow as pa
        import pyarrow.parquet as pq

        self._pq.close()
        best_path = os.path.join(self.out_dir, "per_trait_best.parquet")
        n_traits = self._session.n_traits
        best_marker = fields["best_marker"]
        pq.write_table(
            pa.table({
                "trait": [self._trait_name(t) for t in range(n_traits)],
                "best_marker": [
                    self._marker_name(int(m)) if m >= 0 else None
                    for m in best_marker
                ],
                "neglog10p": pa.array(fields["best_nlp"], pa.float32()),
            }),
            best_path, compression="NONE",
        )
        qc_path = os.path.join(self.out_dir, "qc.parquet")
        n_markers = self._session.n_markers
        qc = {
            "marker": [self._marker_name(m) for m in range(n_markers)],
            "maf": pa.array(fields["maf"], pa.float32()),
            "valid": pa.array(fields["valid"].astype(bool)),
        }
        if fields.get("omnibus_nlp") is not None:
            qc["omnibus_neglog10p"] = pa.array(fields["omnibus_nlp"], pa.float32())
        pq.write_table(pa.table(qc), qc_path, compression="NONE")
        return {
            "hits": self._hits.total_rows,
            "lambda_gc": fields["lambda_gc"],
            "hits_parquet": self._hits_path,
            "hit_row_groups": self._row_groups,
            "per_trait_best_parquet": best_path,
            "qc_parquet": qc_path,
        }

    def abort(self) -> None:
        super().abort()
        w = getattr(self, "_pq", None)
        if w is not None:
            try:
                w.close()
            except Exception:  # noqa: BLE001 — abort must not raise
                pass


def _register_parquet() -> bool:
    """Register the parquet writer iff pyarrow is importable.  Optional by
    design: the CI container bakes no Arrow stack, so absence must mean
    "writer not offered", never an import-time crash."""
    try:
        import pyarrow          # noqa: F401
        import pyarrow.parquet  # noqa: F401
    except Exception:
        return False
    register_writer("parquet")(ParquetHitWriter)
    return True


HAVE_PARQUET = _register_parquet()


@register_writer("npz")
class NpzShardWriter(_AccumulatingWriter):
    """Machine-readable npz bundle: sorted hit shards (one per flushed
    marker batch: ``hits_00000.npz`` with ``hits``/``hit_stats``), plus
    ``best.npz`` (best_nlp, best_marker) and ``qc.npz`` (maf, valid
    [, omnibus_nlp]) at close.  Concatenating the hit shards in filename
    order reproduces the sorted hit table exactly."""

    def _start(self) -> None:
        self._shard_paths: list[str] = []

    def _emit_hits(self, hits: np.ndarray, stats: np.ndarray) -> None:
        if not len(hits):
            return
        path = os.path.join(self.out_dir, f"hits_{len(self._shard_paths):05d}.npz")
        tmp = path + ".tmp.npz"
        np.savez(tmp, hits=hits, hit_stats=stats)
        os.replace(tmp, path)
        self._shard_paths.append(path)

    def _finish(self, fields: dict) -> dict:
        best_path = os.path.join(self.out_dir, "best.npz")
        np.savez(best_path, best_nlp=fields["best_nlp"], best_marker=fields["best_marker"])
        qc_path = os.path.join(self.out_dir, "qc.npz")
        qc = {"maf": fields["maf"], "valid": fields["valid"]}
        if fields.get("omnibus_nlp") is not None:
            qc["omnibus_nlp"] = fields["omnibus_nlp"]
        np.savez(qc_path, **qc)
        return {
            "hits": self._hits.total_rows,
            "lambda_gc": fields["lambda_gc"],
            "hit_shards": list(self._shard_paths),
            "best_npz": best_path,
            "qc_npz": qc_path,
        }
