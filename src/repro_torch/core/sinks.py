"""Composable result sinks for the genome scan (DESIGN.md §4).

``GenomeScan.run`` used to interleave five accumulation concerns (per-trait
best, hit collection, QC arrays, lambda-GC probe, checkpoint commits) in one
loop body.  Each is now a ``ResultSink``:

    on_batch(view, payload)   consume one computed batch; add the arrays this
                              sink wants persisted to the checkpoint shard
                              ``payload``
    merge_shard(shard, lo, hi) replay a previously committed shard (resume)
    result()                  contribute fields to the final ``ScanResult``

Sinks read device outputs through a shared ``BatchView`` that pulls each
tile across PCIe at most once, lazily — the "hit-driven host pull" invariant
(the full (M, P) nlp/r/t tiles only cross when a batch actually contains
hits, no matter how many sinks are attached).  The checkpoint committer is
itself just the last sink in the chain, so crash-resume is one line of
composition instead of special cases in the scan loop.

Since the scan became a 2-D (marker-batch x trait-block) grid (DESIGN.md
§10), one ``BatchView`` covers one grid *cell*: a marker range crossed with
a trait range ``[t_lo, t_lo + n_traits)``.  Sinks fold cells — trait-indexed
accumulators offset by the cell's block origin, marker-indexed accumulators
written once per marker batch (the ``t_lo == 0`` cell carries them).  An
unblocked scan is the degenerate single-block grid, so nothing changes for
it.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.core import stats as _stats
from repro_torch.core.engines import HostBatch
from repro_torch.runtime import spans as _spans
from repro_torch.runtime.checkpoint import ScanCheckpoint
from repro_torch.runtime.prefetch import MarkerBatch


def _host(x) -> np.ndarray:
    """One device output as a host array (a device->host copy for tensors;
    the ``pull`` span, and ``d2h_bytes`` for a tensor off the CPU)."""
    if isinstance(x, torch.Tensor):
        with _spans.span("pull") as sp:
            if sp is not None and not x.is_cpu:
                _spans.count("d2h_bytes", x.nbytes)
            return x.detach().cpu().numpy()
    return np.asarray(x)


def _refined(t, dof: float, *, on=None) -> np.ndarray:
    """The canonical refine of ``t`` as host float32 (DESIGN.md §13): a
    tensor off the CPU is refined on its card and the values pulled; host
    values are first copied to the card ``on`` lies on (the step output
    they were read from), so every emitted value of a CUDA scan goes
    through the card's kernel, and a CPU scan's through the host refine."""
    if isinstance(on, torch.Tensor) and not on.is_cpu:
        t = torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(on.device)
    return _host(_stats.refine_neglog10p(t, float(dof))).astype(np.float32, copy=False)


def _screen_any(t_tile, t2_screen: float) -> bool:
    """Scalar device probe: does any lane pass the t^2 screen?  max is an
    exact selection, so ``max(t^2) >= thr`` iff some lane passes — only one
    float crosses PCIe, preserving the hit-driven-pull invariant for
    dense-mode cells under a sparse-capable config."""
    t = torch.as_tensor(t_tile)
    if t.numel() == 0:
        return False
    return bool(np.float32(_host(torch.max(t * t))) >= np.float32(t2_screen))


__all__ = [
    "BatchView",
    "ResultSink",
    "BestTraitSink",
    "HitSink",
    "QCSink",
    "LambdaGCSink",
    "CheckpointSink",
    "extract_hits",
]


def extract_hits(view: "BatchView", threshold: float) -> tuple[np.ndarray, np.ndarray]:
    """Collect one cell's (marker, trait) entries at or above ``threshold``.

    Returns globalized ``(H, 2)`` int32 indices and ``(H, 3)`` float32
    (r, t, -log10 p) stats.  The hit-driven-pull invariant lives here: the
    full per-cell tiles only cross PCIe when the device-side hit counter is
    non-zero.  Shared by ``HitSink`` (the ScanResult path) and
    ``api.session.CellResult`` (the streaming path) so both extract
    bit-identical rows.
    """
    hits = np.zeros((0, 2), np.int32)
    stats = np.zeros((0, 3), np.float32)
    if view.is_sparse and not view.overflowed:
        # Sparse epilogue (DESIGN.md §13): the device already compacted the
        # screened lanes; only the tiny fixed-capacity buffers cross PCIe,
        # and the exact CF runs through the canonical refine where the
        # buffers lie.  The screen admits a sub-threshold
        # margin — the exact nlp filter here rejects it, leaving precisely
        # the dense path's hit set in the dense path's row-major order
        # (first-K compaction preserves it).
        if view.screen_count == 0:
            return hits, stats
        idx = view.hit_idx
        hit_nlp = view.hit_nlp
        keep = (idx >= 0) & (hit_nlp >= threshold)
        if keep.any():
            flat = idx[keep].astype(np.int64)
            rows = flat // view.n_traits
            cols = flat % view.n_traits
            hits = np.stack(
                [
                    rows.astype(np.int32) + view.batch.lo,
                    cols.astype(np.int32) + view.t_lo,
                ],
                1,
            )
            stats = np.stack(
                [view.hit_r[keep], view.hit_t[keep], hit_nlp[keep]], 1
            ).astype(np.float32)
        return hits, stats
    if view.t2_screen is not None and view.dof is not None:
        # Dense-mode extraction under a sparse-capable config — also the
        # sparse overflow fallback.  Screen the pulled t tile on the host
        # with the identical f32 square-and-compare the device screen uses
        # (same t bits -> same survivor set), gather survivors in flat
        # row-major order (the compaction order), and refine them through
        # the canonical refine on the device the t tile came from, as the
        # compact path does — the same t through the same function, so every
        # emitted bit matches.
        if "t" not in view._cache and not _screen_any(
            view._out["t"], view.t2_screen
        ):
            return hits, stats
        t_np = view.t
        flat_t = np.ascontiguousarray(t_np, np.float32).ravel()
        survivors = np.nonzero(np.square(flat_t) >= np.float32(view.t2_screen))[0]
        if survivors.size == 0:
            return hits, stats
        nlp_vals = _refined(flat_t[survivors], view.dof, on=view._out["t"])
        keep = nlp_vals >= threshold
        if keep.any():
            flat = survivors[keep].astype(np.int64)
            rows = flat // view.n_traits
            cols = flat % view.n_traits
            r_np = view.r
            hits = np.stack(
                [
                    rows.astype(np.int32) + view.batch.lo,
                    cols.astype(np.int32) + view.t_lo,
                ],
                1,
            )
            stats = np.stack(
                [r_np[rows, cols], t_np[rows, cols], nlp_vals[keep]], 1
            ).astype(np.float32)
        return hits, stats
    # Historical dense tile path (no screen plan — e.g. the GenomeScan shim
    # fed a raw step dict): gate the full-tile pull on the device-side hit
    # counter.
    if view.hit_count > 0:
        nlp = view.nlp
        rows, cols = np.nonzero(nlp >= threshold)
        r_np, t_np = view.r, view.t
        hits = np.stack(
            [
                rows.astype(np.int32) + view.batch.lo,
                cols.astype(np.int32) + view.t_lo,
            ],
            1,
        )
        stats = np.stack(
            [r_np[rows, cols], t_np[rows, cols], nlp[rows, cols]], 1
        ).astype(np.float32)
    return hits, stats


class BatchView:
    """Lazy, cached host view over one device step output — one grid cell.

    Every ``np.asarray`` on a device output is a host pull; multiple sinks
    share one view so each tile crosses at most once.  ``t_probe`` slices on
    the device *before* pulling, so the calibration probe never forces the
    full t tile across.

    ``n_traits`` is the cell's trait-block width (the full panel width for
    an unblocked scan); ``t_lo``/``block_index`` locate the block on the
    global trait axis so sinks can offset their folds.

    A *sparse* cell (DESIGN.md §13) carries compacted
    ``hit_idx``/``hit_r``/``hit_t`` buffers instead of the dense nlp
    tile.  All *emitted* -log10 p values — ``hit_nlp``, ``best_nlp``, and
    the reconstructed ``nlp`` tile — go through the canonical refine
    (``stats.refine_neglog10p``) where the step's outputs lie: on the card
    for a CUDA step (the refine kernel, then a pull of the values), on the
    host in fixed ``stats.REFINE_WIDTH`` chunks for a CPU one.  So sparse
    and dense cells agree bitwise, and the emitted bits cannot depend on a
    buffer's length, the configured capacity, the slot or the card that
    computed t; a CUDA scan's values differ from a CPU scan's by float32
    ulps.  ``t2_screen`` carries the scan's screen threshold so dense-mode
    extraction can mirror the sparse screen exactly.
    """

    def __init__(
        self,
        host: HostBatch,
        out: dict,
        n_traits: int,
        *,
        t_lo: int = 0,
        block_index: int = 0,
        dof: float | None = None,
        t2_screen: float | None = None,
    ):
        self.batch: MarkerBatch = host.batch
        self.host = host
        self._out = out
        self.n_traits = n_traits
        self.t_lo = t_lo
        self.t_hi = t_lo + n_traits
        self.block_index = block_index
        self.dof = dof
        self.t2_screen = t2_screen
        self.m_batch = host.batch.n_markers
        self._cache: dict[str, np.ndarray] = {}

    def _pull(self, key: str) -> np.ndarray:
        if key not in self._cache:
            self._cache[key] = _host(self._out[key])
        return self._cache[key]

    @property
    def is_sparse(self) -> bool:
        return "hit_idx" in self._out

    @property
    def hit_capacity(self) -> int:
        return int(self._out["hit_idx"].shape[0])

    @property
    def screen_count(self) -> int:
        """Exact count of lanes past the t^2 screen (sparse cells only)."""
        return int(self._pull("screen_count"))

    @property
    def overflowed(self) -> bool:
        """True when the screen found more lanes than the compacted buffer
        holds — the compacted arrays are then truncated and the host must
        fall back to the reconstructed dense tile."""
        return self.is_sparse and self.screen_count > self.hit_capacity

    @property
    def hit_idx(self) -> np.ndarray:
        """Compacted flat (row-major over the cell tile) screened-lane
        indices, ``-1``-padded to capacity."""
        return self._pull("hit_idx")

    @property
    def hit_r(self) -> np.ndarray:
        return self._pull("hit_r")

    @property
    def hit_t(self) -> np.ndarray:
        return self._pull("hit_t")

    @property
    def hit_nlp(self) -> np.ndarray:
        """Exact -log10 p on the compacted lanes, through the canonical
        refine where ``hit_t`` lies.  Padding slots hold refine(0) — callers
        mask on ``hit_idx >= 0``."""
        if "hit_nlp" not in self._cache:
            if "hit_nlp" in self._out:  # synthetic/raw step dicts
                self._cache["hit_nlp"] = _host(self._out["hit_nlp"])
            else:
                self._cache["hit_nlp"] = _refined(self._out["hit_t"], self.dof)
        return self._cache["hit_nlp"]

    @property
    def hit_count(self) -> int:
        return int(self._pull("hit_count"))

    @property
    def best_nlp(self) -> np.ndarray:
        """Per-trait winner -log10 p.  When the step emitted the winner t
        (``batch_best_t``), the value goes through the canonical refine
        where it lies — identical bits whether the cell ran the sparse or
        the dense epilogue.  Raw step dicts without it fall back to the
        in-step tile value."""
        if "batch_best_t" in self._out and self.dof is not None:
            if "best_nlp" not in self._cache:
                self._cache["best_nlp"] = _refined(
                    self._out["batch_best_t"][: self.n_traits], self.dof)
            return self._cache["best_nlp"]
        return self._pull("batch_best_nlp")[: self.n_traits]

    @property
    def best_row(self) -> np.ndarray:
        return self._pull("batch_best_row")[: self.n_traits]

    @property
    def nlp(self) -> np.ndarray:
        if "nlp" not in self._out:
            # Sparse cell: the dense tile never existed on device.
            # Reconstruct it from t through the canonical refine where t
            # lies (full-tile QC / report paths only — extraction never
            # reads this).
            if "nlp" not in self._cache:
                if self.dof is None:
                    raise RuntimeError(
                        "sparse cell without dof: BatchView cannot "
                        "reconstruct the nlp tile"
                    )
                t = self._out["t"][: self.m_batch]
                self._cache["nlp"] = _refined(t, self.dof).reshape(tuple(t.shape))
            return self._cache["nlp"]
        return self._pull("nlp")[: self.m_batch]

    @property
    def r(self) -> np.ndarray:
        return self._pull("r")[: self.m_batch]

    @property
    def t(self) -> np.ndarray:
        return self._pull("t")[: self.m_batch]

    @property
    def maf(self) -> np.ndarray:
        if self.host.host_maf is not None:
            return self.host.host_maf[: self.m_batch]
        return self._pull("maf")[: self.m_batch]

    @property
    def valid(self) -> np.ndarray:
        if self.host.host_valid is not None:
            return self.host.host_valid[: self.m_batch]
        return self._pull("valid")[: self.m_batch]

    @property
    def omnibus_nlp(self) -> np.ndarray | None:
        if "omnibus_nlp" not in self._out:
            return None
        return self._pull("omnibus_nlp")[: self.m_batch]

    def t_probe(self, rows: int) -> np.ndarray:
        if "t" in self._cache:  # tile already on host (a hit pulled it)
            return self._cache["t"][: min(self.m_batch, rows), 0]
        return _host(self._out["t"][: min(self.m_batch, rows), 0])


class ResultSink:
    """One accumulation concern of the scan; see module docstring."""

    def on_batch(self, view: BatchView, payload: dict[str, np.ndarray]) -> None:
        raise NotImplementedError

    def on_cell(self, cell: Any) -> None:
        """Fold one streamed ``api.session.CellResult`` (the event path the
        result writers drive; the ``GenomeScan`` shim uses the historical
        ``on_batch``/``merge_shard`` chain directly).  The default routes
        live cells through the legacy ``on_batch`` hook — so sink
        subclasses written against that interface keep working — and
        replayed cells through ``merge_shard``.  Built-in sinks override
        this to fold from the cell's cached payload directly (same arrays,
        extracted once)."""
        if cell.view is not None:
            self.on_batch(cell.view, {})
        else:
            self.merge_shard(cell.payload(), cell.lo, cell.hi)

    def merge_shard(self, shard: dict[str, np.ndarray], lo: int, hi: int) -> None:
        """Fold a previously committed checkpoint shard in (resume path)."""

    def result(self) -> dict[str, Any]:
        return {}


class BestTraitSink(ResultSink):
    """Per-trait running best -log10 p and the global marker achieving it.

    Accumulators span the full panel; each grid cell folds into the trait
    slice its block covers.  The fold is *order-normalized*: the winner is
    the max by (nlp, then LOWER global marker), which is associative and
    commutative — so any cell completion order (the serial grid walk, a
    multi-device executor's work-stealing order, a resume's replayed-last
    order) lands on the identical (best_nlp, best_marker) pair.  In-order
    folding with a strict ``>`` picked the earlier batch on exact nlp ties,
    i.e. the lower marker — the normalized rule reproduces that serial
    result exactly, it just no longer depends on arrival order.
    """

    def __init__(self, n_traits: int):
        self.best_nlp = np.zeros(n_traits, np.float32)
        self.best_marker = np.full(n_traits, -1, np.int64)

    def _fold(self, b_best: np.ndarray, b_row: np.ndarray, lo: int, t_lo: int) -> None:
        sl = slice(t_lo, t_lo + b_best.shape[0])
        cur_nlp = self.best_nlp[sl]
        cur_marker = self.best_marker[sl]
        cand_marker = lo + b_row.astype(np.int64)
        # Ties on nlp go to the lower global marker; the virgin accumulator
        # (0.0, -1) only loses to a strictly positive nlp, so all-masked
        # cells leave traits at marker -1 no matter when they arrive.
        improved = (b_best > cur_nlp) | (
            (b_best == cur_nlp) & (cur_marker >= 0) & (cand_marker < cur_marker)
        )
        self.best_nlp[sl] = np.where(improved, b_best, cur_nlp)
        self.best_marker[sl] = np.where(improved, cand_marker, cur_marker)

    def on_batch(self, view: BatchView, payload: dict[str, np.ndarray]) -> None:
        payload["best_nlp"] = view.best_nlp
        payload["best_row"] = view.best_row
        self._fold(view.best_nlp, view.best_row, view.batch.lo, view.t_lo)

    def on_cell(self, cell: Any) -> None:
        self._fold(cell.best_nlp, cell.best_row, cell.lo, cell.t_lo)

    def merge_shard(self, shard: dict[str, np.ndarray], lo: int, hi: int) -> None:
        self._fold(shard["best_nlp"], shard["best_row"], lo, int(shard.get("t_lo", 0)))

    def result(self) -> dict[str, Any]:
        return {"best_nlp": self.best_nlp, "best_marker": self.best_marker}


class HitSink(ResultSink):
    """Collect (marker, trait) cells above the genome-wide line, pulling the
    full tiles only for cells whose device-side hit counter is non-zero.

    Trait columns are globalized with the cell's block origin at collection
    time, so committed shards and the final result always carry global trait
    indices.

    Scan-time host RAM is bounded: once more than ``spill_rows`` hit rows
    accumulate (dense hit regions on a wide panel are unbounded over a
    whole scan), the in-RAM buffers are flushed to appendable ``.npz`` part
    files under ``spill_dir`` and the RAM is released.  ``result()``
    re-reads the parts in order (then unlinks them), so spilling never
    changes the returned arrays — append order is preserved exactly.  Note
    the bound covers the *scan*: ``result()`` still materializes the full
    hit set once, for the final ``ScanResult`` — replacing that with
    streaming summary-stat writers is a ROADMAP item.  ``spill_dir=None``
    (the default) disables spilling and keeps the historical
    everything-in-RAM behavior.
    """

    def __init__(
        self,
        threshold_nlp: float,
        *,
        spill_dir: str | None = None,
        spill_rows: int = 2_000_000,
    ):
        self.threshold = threshold_nlp
        self.spill_dir = spill_dir
        self.spill_rows = max(1, spill_rows)
        self._hits: list[np.ndarray] = []
        self._stats: list[np.ndarray] = []
        self._rows_in_ram = 0
        self._spill_paths: list[str] = []
        self.spilled_rows = 0
        if spill_dir is not None and os.path.isdir(spill_dir):
            # The spill dir is per-run scratch (the CLI points it at --out):
            # parts a crashed previous run left behind would collide by
            # index with ours and masquerade as results — clear them.
            for stale in os.listdir(spill_dir):
                if stale.startswith("hits_spill_") and stale.endswith(".npz"):
                    os.unlink(os.path.join(spill_dir, stale))

    def _append(self, hits: np.ndarray, stats: np.ndarray) -> None:
        self._hits.append(hits)
        self._stats.append(stats)
        self._rows_in_ram += len(hits)
        if self.spill_dir is not None and self._rows_in_ram >= self.spill_rows:
            self._flush()

    def _flush(self) -> None:
        os.makedirs(self.spill_dir, exist_ok=True)
        part = os.path.join(
            self.spill_dir, f"hits_spill_{len(self._spill_paths):05d}.npz"
        )
        tmp = part + ".tmp.npz"
        np.savez(tmp, hits=np.concatenate(self._hits), hit_stats=np.concatenate(self._stats))
        os.replace(tmp, part)
        self._spill_paths.append(part)
        self.spilled_rows += self._rows_in_ram
        self._hits.clear()
        self._stats.clear()
        self._rows_in_ram = 0

    def on_batch(self, view: BatchView, payload: dict[str, np.ndarray]) -> None:
        batch_hits, batch_stats = extract_hits(view, self.threshold)
        payload["hits"] = batch_hits
        payload["hit_stats"] = batch_stats
        self._append(batch_hits, batch_stats)

    def on_cell(self, cell: Any) -> None:
        self._append(cell.hits, cell.hit_stats)

    def merge_shard(self, shard: dict[str, np.ndarray], lo: int, hi: int) -> None:
        self._append(shard["hits"], shard["hit_stats"])

    def result(self) -> dict[str, Any]:
        hits = [np.zeros((0, 2), np.int32)]
        stats = [np.zeros((0, 3), np.float32)]
        for part in self._spill_paths:
            with np.load(part) as z:
                hits.append(z["hits"])
                stats.append(z["hit_stats"])
        hits.extend(self._hits)
        stats.extend(self._stats)
        out = {"hits": np.concatenate(hits), "hit_stats": np.concatenate(stats)}
        # Fold everything back into the RAM buffers BEFORE unlinking the
        # consumed parts: result() stays repeatable (a second call returns
        # the same arrays), and parts — intermediate state, not run
        # artifacts — don't pile up next to hits.tsv across reruns.
        self._hits = [out["hits"]]
        self._stats = [out["hit_stats"]]
        self._rows_in_ram = len(out["hits"])
        for part in self._spill_paths:
            if os.path.exists(part):
                os.unlink(part)
        self._spill_paths.clear()
        return out


class QCSink(ResultSink):
    """Dense per-marker QC arrays: observed MAF, validity mask, and (when
    the multivariate screen is on) the omnibus -log10 p track."""

    def __init__(self, n_markers: int, *, multivariate: bool = False):
        self.maf = np.zeros(n_markers, np.float32)
        self.valid = np.zeros(n_markers, bool)
        self.omnibus_nlp = np.zeros(n_markers, np.float32) if multivariate else None

    def on_batch(self, view: BatchView, payload: dict[str, np.ndarray]) -> None:
        # Marker-level tracks are identical across trait blocks; the t_lo==0
        # cell carries them (one device pull and one persisted copy per
        # marker batch, not one per grid cell).
        if view.t_lo != 0:
            return
        lo, hi = view.batch.lo, view.batch.hi
        self.maf[lo:hi] = view.maf
        self.valid[lo:hi] = view.valid
        payload["maf"] = self.maf[lo:hi]
        payload["valid"] = self.valid[lo:hi]
        if self.omnibus_nlp is not None and view.omnibus_nlp is not None:
            self.omnibus_nlp[lo:hi] = view.omnibus_nlp
            payload["omnibus_nlp"] = self.omnibus_nlp[lo:hi]

    def on_cell(self, cell: Any) -> None:
        if cell.maf is None:  # a t_lo > 0 cell: no marker-level tracks
            return
        lo, hi = cell.lo, cell.hi
        self.maf[lo:hi] = cell.maf
        self.valid[lo:hi] = cell.valid
        if self.omnibus_nlp is not None and cell.omnibus_nlp is not None:
            self.omnibus_nlp[lo:hi] = cell.omnibus_nlp

    def merge_shard(self, shard: dict[str, np.ndarray], lo: int, hi: int) -> None:
        if "maf" not in shard:  # a t_lo > 0 cell: no marker-level tracks
            return
        self.maf[lo:hi] = shard["maf"]
        self.valid[lo:hi] = shard["valid"]
        if self.omnibus_nlp is not None and "omnibus_nlp" in shard:
            self.omnibus_nlp[lo:hi] = shard["omnibus_nlp"]

    def result(self) -> dict[str, Any]:
        return {"maf": self.maf, "valid": self.valid, "omnibus_nlp": self.omnibus_nlp}


class LambdaGCSink(ResultSink):
    """Genomic-control calibration probe: a small t-statistic sample of the
    first trait per batch.  The probe is persisted in every checkpoint shard
    so a resumed scan merges the probes of already-committed batches instead
    of estimating lambda from whatever little it recomputed."""

    def __init__(self, rows: int = 64):
        self.rows = rows
        self._samples: list[np.ndarray] = []

    def on_batch(self, view: BatchView, payload: dict[str, np.ndarray]) -> None:
        # The probe samples the *global* first trait, which lives in the
        # t_lo==0 block; other cells contribute nothing, so a blocked scan
        # estimates lambda from exactly the same sample as an unblocked one.
        if view.t_lo != 0:
            return
        probe = np.asarray(view.t_probe(self.rows), np.float32)
        payload["t_probe"] = probe
        self._samples.append(probe)

    def on_cell(self, cell: Any) -> None:
        if cell.t_probe is not None:
            self._samples.append(np.asarray(cell.t_probe, np.float32))

    def merge_shard(self, shard: dict[str, np.ndarray], lo: int, hi: int) -> None:
        # Shards written before the probe was persisted simply contribute
        # nothing (lambda then rests on the recomputed batches, as before).
        if "t_probe" in shard:
            self._samples.append(np.asarray(shard["t_probe"], np.float32))

    def result(self) -> dict[str, Any]:
        probe = np.concatenate(self._samples) if self._samples else np.zeros(1, np.float32)
        lam = float(_stats.genomic_control_lambda(torch.from_numpy(probe))) if probe.size else 1.0
        return {"lambda_gc": lam}


class CheckpointSink(ResultSink):
    """Commit each grid cell's accumulated payload as an atomic shard.  Must
    be the LAST sink in the chain: it persists whatever the sinks before it
    put into ``payload``.  Shards carry the cell's trait extent so resume
    folds land at the right block origin.

    Since the api redesign the ``ScanSession`` executor commits every live
    cell natively (from ``CellResult.payload()`` — the built-in sinks'
    exact payload), so this sink is no longer composed by default.  Append
    it explicitly after custom sinks whose ``payload`` contributions must
    be persisted; re-committing a cell is an idempotent overwrite."""

    def __init__(self, ckpt: ScanCheckpoint):
        self.ckpt = ckpt

    def on_cell(self, cell: Any) -> None:
        # The api's ScanSession commits cells natively; when this sink is
        # nevertheless composed into an event-driven chain, re-committing
        # the same payload is an idempotent overwrite, never a truncation.
        if cell.view is not None:
            self.ckpt.commit_cell(cell.batch_index, cell.block_index, cell.payload())

    def on_batch(self, view: BatchView, payload: dict[str, np.ndarray]) -> None:
        shard = {
            "lo": np.asarray(view.batch.lo),
            "hi": np.asarray(view.batch.hi),
            "t_lo": np.asarray(view.t_lo),
            "t_hi": np.asarray(view.t_hi),
            **payload,
        }
        self.ckpt.commit_cell(view.batch.index, view.block_index, shard)
