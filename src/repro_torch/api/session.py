"""Plan -> execute: ``ScanPlan`` compiles a Study + specs into a prepared
scan; ``ScanSession.events()`` streams per-grid-cell ``CellResult``s.

The session yields each completed (marker-batch x trait-block) cell as a
``CellResult`` the moment it is computed (or replayed from a checkpoint
shard), and *consumers* decide what to keep:

    for cell in session.events():      # streams; never holds (M, P) arrays
        writer.write(cell)

The executor behind ``events()`` is the serial grid walk on one device
(``SerialExecutor``): marker batches outer, trait blocks inner.  The
multi-device executor arrives with a later slice of the port; a config with
``devices != 1`` or a distributed scheduler backend is refused.

Checkpointing rides the session: each live cell's payload is committed to
the cell-keyed manifest before the cell is yielded, and on resume the
committed cells of previous runs are replayed as ``CellResult``s after the
live stream.  The checkpoint format and fingerprint are the ``repro``
package's, so a scan checkpointed by either package resumes in the other.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.api.metrics import CellTiming, ScanMetrics
from repro_torch.api.specs import ScanConfig
from repro_torch.api.study import Study
from repro_torch.core import stats as _stats
from repro_torch.core.engines import (
    EngineContext,
    ScanEngine,
    get_engine,
    resolve_genotype_staging,
)
from repro_torch.core.panels import PanelPrefetcher, PanelStore
from repro_torch.core.residualize import covariate_basis
from repro_torch.core.sinks import BatchView, extract_hits
from repro_torch.runtime.checkpoint import ScanCheckpoint, config_fingerprint
from repro_torch.runtime.device import resolve_device, synchronize
from repro_torch.runtime.prefetch import (
    BatchPlanner,
    MarkerBatch,
    Prefetcher,
    TraitBlock,
    TraitBlockPlanner,
    double_buffer,
)

__all__ = [
    "CellResult",
    "PreparedScan",
    "ScanPlan",
    "ScanSession",
    "SerialExecutor",
    "CheckpointReplay",
]


LAMBDA_PROBE_ROWS = 64  # rows of the first-trait t probe persisted per batch

_NOT_PORTED_EXECUTOR = (
    "the multi-device executor (devices != 1, distributed scheduler backends) "
    "arrives with the port's multi-device slice"
)


class CellResult:
    """One completed grid cell: a marker range crossed with a trait range.

    Live cells wrap the device step's ``BatchView`` and extract their
    summary arrays (the full per-cell tiles only cross to the host when the
    cell has hits).  Replayed cells carry a committed checkpoint shard's
    arrays.  Either way ``arrays`` is the cell's *payload* — the exact dict
    the checkpoint persists — and the accessors read from it.
    """

    def __init__(
        self,
        *,
        batch_index: int,
        block_index: int,
        lo: int,
        hi: int,
        t_lo: int,
        t_hi: int,
        view: BatchView | None = None,
        shard: dict[str, np.ndarray] | None = None,
        hit_threshold: float = 7.301,
    ):
        self.batch_index = batch_index
        self.block_index = block_index
        self.lo = lo
        self.hi = hi
        self.t_lo = t_lo
        self.t_hi = t_hi
        self.view = view
        self._shard = shard
        self._threshold = hit_threshold
        self._arrays: dict[str, np.ndarray] | None = None

    @classmethod
    def from_shard(
        cls, batch_index: int, block_index: int, shard: dict[str, np.ndarray]
    ) -> "CellResult":
        return cls(
            batch_index=batch_index,
            block_index=block_index,
            lo=int(shard["lo"]),
            hi=int(shard["hi"]),
            t_lo=int(shard.get("t_lo", 0)),
            t_hi=int(shard.get("t_hi", shard["best_nlp"].shape[0])),
            shard=shard,
        )

    @property
    def n_markers(self) -> int:
        return self.hi - self.lo

    @property
    def n_traits(self) -> int:
        return self.t_hi - self.t_lo

    @property
    def replayed(self) -> bool:
        return self.view is None

    @property
    def carries_marker_tracks(self) -> bool:
        """Marker-level tracks (maf/valid/probe) ride the t_lo==0 cell of
        each marker batch — once per batch, not once per cell."""
        return self.t_lo == 0

    @property
    def arrays(self) -> dict[str, np.ndarray]:
        """The cell's checkpoint payload (computed once, cached).

        Keys: ``best_nlp``/``best_row`` always; ``hits``/``hit_stats``
        always (possibly empty); ``maf``/``valid``/``t_probe`` on t_lo==0
        cells.
        """
        if self._arrays is None:
            if self._shard is not None:
                self._arrays = {
                    k: v for k, v in self._shard.items()
                    if k not in ("lo", "hi", "t_lo", "t_hi")
                }
            else:
                v = self.view
                payload: dict[str, np.ndarray] = {
                    "best_nlp": v.best_nlp,
                    "best_row": v.best_row,
                }
                hits, stats = extract_hits(v, self._threshold)
                payload["hits"] = hits
                payload["hit_stats"] = stats
                if self.carries_marker_tracks:
                    payload["maf"] = v.maf
                    payload["valid"] = v.valid
                    if v.omnibus_nlp is not None:
                        payload["omnibus_nlp"] = v.omnibus_nlp
                    payload["t_probe"] = np.asarray(
                        v.t_probe(LAMBDA_PROBE_ROWS), np.float32
                    )
                self._arrays = payload
        return self._arrays

    def payload(self) -> dict[str, np.ndarray]:
        """The shard the checkpoint commits: payload plus cell extent."""
        return {
            "lo": np.asarray(self.lo),
            "hi": np.asarray(self.hi),
            "t_lo": np.asarray(self.t_lo),
            "t_hi": np.asarray(self.t_hi),
            **self.arrays,
        }

    @property
    def best_nlp(self) -> np.ndarray:
        """(n_traits,) per-trait best -log10 p within this cell's markers."""
        return self.arrays["best_nlp"]

    @property
    def best_row(self) -> np.ndarray:
        """(n_traits,) *batch-local* marker row of the best."""
        return self.arrays["best_row"]

    @property
    def hits(self) -> np.ndarray:
        """(H, 2) int32 (global marker, global trait) above the threshold."""
        return self.arrays["hits"]

    @property
    def hit_stats(self) -> np.ndarray:
        """(H, 3) float32 (r, t, -log10 p) aligned with ``hits``."""
        return self.arrays["hit_stats"]

    @property
    def maf(self) -> np.ndarray | None:
        return self.arrays.get("maf")

    @property
    def valid(self) -> np.ndarray | None:
        return self.arrays.get("valid")

    @property
    def omnibus_nlp(self) -> np.ndarray | None:
        return self.arrays.get("omnibus_nlp")

    @property
    def t_probe(self) -> np.ndarray | None:
        return self.arrays.get("t_probe")


@dataclass
class PreparedScan:
    """Everything ``ScanPlan.prepare`` amortizes once per scan: the resolved
    engine (setup run — GRM/REML for lmm), the device step, the residualized
    panel store (global-panel engines only), and the 2-D grid
    decomposition."""

    study: Study
    config: ScanConfig
    device: torch.device
    engine: ScanEngine
    ctx: EngineContext
    step: Callable[..., dict]
    trait_blocks: list[TraitBlock]
    panels: PanelStore | None
    batches: list[MarkerBatch]
    dof: int
    lmm_info: dict | None
    n_covariates: int

    @property
    def n_batches(self) -> int:
        return len(self.batches)

    @property
    def n_trait_blocks(self) -> int:
        return len(self.trait_blocks)

    def fingerprint(self) -> str:
        """The checkpoint identity of this scan (device and topology free);
        the same payload the ``repro`` package hashes."""
        cfg, study = self.config, self.study
        engine_state = self.engine.state_fingerprint()
        m_total = study.source.n_markers
        return config_fingerprint(
            {
                **cfg.fingerprint_payload(),
                "n_markers": m_total,
                "n_samples": study.n_samples,
                "n_traits": study.n_traits,
                # The plan's index->(lo,hi) mapping depends on the shard
                # layout; resuming against a re-sharded fileset would
                # silently mix two incompatible batch decompositions.
                "shard_boundaries": list(
                    getattr(study.source, "shard_boundaries", (0, m_total))
                ),
                **({"engine_state": engine_state} if engine_state else {}),
            }
        )


class ScanPlan:
    """A validated, normalized scan specification bound to a Study.

    ``prepare()`` runs the amortized setup (residualization, engine setup —
    the lmm engine's streamed GRM, eigendecomposition and REML live here —
    and step construction); ``run()`` prepares and returns the executable
    ``ScanSession``.  A plan may be prepared once and run many times.
    """

    def __init__(self, study: Study, config: ScanConfig, *, mesh: Any = None):
        if mesh is not None:
            raise NotImplementedError(
                "sharding meshes arrive with the port's torch.distributed mesh slice"
            )
        if config.exec_backend != "threads":
            raise NotImplementedError(_NOT_PORTED_EXECUTOR)
        if config.multivariate:
            raise NotImplementedError(
                "the multivariate omnibus screen arrives with the port's "
                "multivariate slice"
            )
        self.study = study
        self.config = config
        self._prepared: PreparedScan | None = None

    def prepare(self) -> PreparedScan:
        if self._prepared is not None:
            return self._prepared
        study, config = self.study, self.config
        device = resolve_device(config.device)
        engine = get_engine(config.engine)
        n_samples = study.n_samples
        phenotypes = np.asarray(study.phenotypes)
        covariates = study.covariates

        # The trait axis of the 2-D scan grid.  block_p is the panel-axis
        # compute tile of every engine's step; aligning the scheduling
        # blocks to it keeps the blocked scan bitwise-identical to the
        # unblocked one.
        trait_blocks = TraitBlockPlanner(
            config.trait_block, quantum=config.block_p
        ).plan(study.n_traits)

        panels: PanelStore | None = None
        q = None
        if engine.uses_global_panel:
            # OLS panel prep (Eq. 1), amortized once into a host-side store.
            # Engines that build their own panel (lmm: rotated per LOCO scope
            # in setup_scan) skip it.
            q = covariate_basis(covariates, n_samples, device=device)
            panels = PanelStore.residualized(
                phenotypes, q, trait_blocks,
                quantum=config.block_p,
                max_resident=config.panel_resident_blocks,
            )
            n_covariates = int(q.shape[1]) - 1
        else:
            cov = None if covariates is None else np.asarray(covariates)
            n_covariates = 0 if cov is None else (1 if cov.ndim == 1 else cov.shape[1])
        dof = config.options.dof(n_samples, n_covariates)
        # Negotiate the H2D staging currency per source and size the shared
        # packed-slab cache the prepare workers read through.
        from repro_torch.io.packed_cache import configure_default as _configure_packed_cache

        genotype_staging = resolve_genotype_staging(
            config.genotype_staging,
            study.source,
            excluded_samples=study.excluded_samples,
        )
        if genotype_staging == "packed":
            _configure_packed_cache(config.packed_cache_mb)
        ctx = EngineContext(
            n_samples=n_samples,
            n_covariates=n_covariates,
            options=config.options,
            device=device,
            mode=config.mode,
            hit_threshold=config.hit_threshold_nlp,
            maf_min=config.maf_min,
            block_m=config.block_m,
            block_n=config.block_n,
            block_p=config.block_p,
            q_basis=q,
            keep=study.keep,
            excluded_samples=study.excluded_samples,
            trait_blocks=tuple(trait_blocks),
            panel_resident_blocks=config.panel_resident_blocks,
            input_dtype=config.input_dtype,
            loco=config.loco,
            grm_method=config.grm_method,
            grm_batch_markers=config.grm_batch_markers,
            lmm_delta=config.lmm_delta,
            lmm_epilogue=config.lmm_epilogue,
            io_workers=config.io_workers,
            sparse_epilogue=config.sparse_epilogue,
            hit_capacity=config.hit_capacity,
            genotype_staging=genotype_staging,
        )
        engine.validate(ctx)
        # Amortized engine setup (lmm: streamed GRM + eigendecomposition +
        # REML + panel rotation).  Engines may override the scan dof and
        # contribute diagnostics to the result.
        lmm_info: dict | None = None
        setup = engine.setup_scan(study.source, phenotypes, covariates, ctx)
        if setup:
            dof = int(setup.get("dof", dof))
            lmm_info = setup.get("info")
        step = engine.build_step(ctx)
        batches = BatchPlanner(config.batch_markers).plan(study.source)
        self._prepared = PreparedScan(
            study=study,
            config=config,
            device=device,
            engine=engine,
            ctx=ctx,
            step=step,
            trait_blocks=trait_blocks,
            panels=panels,
            batches=batches,
            dof=dof,
            lmm_info=lmm_info,
            n_covariates=n_covariates,
        )
        return self._prepared

    def run(self, *, resume: bool = True) -> "ScanSession":
        """Prepare (if not already) and open an executable session."""
        return ScanSession(self.prepare(), resume=resume)


# ------------------------------------------------------------------ executor


class _Slot:
    """One executor slot: the engine's per-device state plus — for
    global-panel engines — the session's panel store on the same device."""

    def __init__(self, prepared: "PreparedScan", *,
                 step: Callable[..., dict] | None = None, label: str = "serial"):
        self.device = prepared.device
        self.label = label
        self.state = prepared.engine.make_device_state(prepared.ctx, step=step)
        self.panels = prepared.panels

    def stage(self, host_batch) -> tuple:
        return self.state.stage(host_batch)

    def step(self, *args) -> dict:
        return self.state.step(*args)

    def panel_block(self, batch: MarkerBatch, block: TraitBlock):
        """The trailing step argument for one grid cell: the session's
        residualized store for OLS engines, the engine device state's
        per-scope rotated panel for the rest."""
        if self.panels is not None:
            return self.panels.device_block(block)
        return self.state.panel_block(batch, block)

    def reset(self) -> None:
        # The panel store's staged blocks stay resident (a warm cache
        # across runs of a plan); the step memo's last batch does not.
        self.state.reset()


def _live_cell(
    host_batch, out: dict, blk: TraitBlock, cfg: ScanConfig, dof: float
) -> "CellResult":
    """Wrap one device step output as a materialized live ``CellResult``.

    ``arrays`` is forced here so the per-cell wall time is honest and the
    commit/writer path downstream reads the cache.  ``dof`` plus the scan's
    screen threshold let the view route every emitted -log10 p through the
    canonical refine — in both sparse and dense epilogue modes, so the two
    stay bitwise equal.
    """
    batch = host_batch.batch
    t2_screen = (
        _stats.t2_screen_threshold(float(cfg.hit_threshold_nlp), float(dof))
        if cfg.options.compute_neglog10p
        else None
    )
    view = BatchView(
        host_batch, out, blk.n_traits, t_lo=blk.lo, block_index=blk.index, dof=dof,
        t2_screen=t2_screen,
    )
    cell = CellResult(
        batch_index=batch.index,
        block_index=blk.index,
        lo=batch.lo,
        hi=batch.hi,
        t_lo=blk.lo,
        t_hi=blk.hi,
        view=view,
        hit_threshold=cfg.hit_threshold_nlp,
    )
    cell.arrays
    return cell


class SerialExecutor:
    """The single-device grid walk: marker batches outer (decode prefetch +
    H2D double buffer), trait blocks inner (each staged genotype batch
    sweeps every pending block before the next copy), with the trait-axis
    panel look-ahead staging block b+1 during block b."""

    kind = "serial"

    def __init__(self, prepared: "PreparedScan"):
        self.prepared = prepared

    def info(self) -> dict:
        return {"kind": self.kind, "devices": 1, "device": str(self.prepared.device)}

    def cells(self, todo, pending) -> Iterator[tuple["CellResult", CellTiming]]:
        prep = self.prepared
        cfg = prep.config
        engine = prep.engine
        blocks = prep.trait_blocks
        slot = _Slot(prep, step=prep.step, label="serial")

        def decode(b):
            t = time.perf_counter()
            hb = engine.prepare_batch(prep.study.source, b, prep.ctx)
            return hb, time.perf_counter() - t

        prefetched = Prefetcher(
            todo,
            decode,
            depth=cfg.prefetch_depth,
            num_workers=cfg.io_workers,
        )
        panel_la = PanelPrefetcher(slot.panel_block)

        def stage(item):
            # Staging launches the copy; on a CUDA device it completes while
            # the device works on the previous batch (double buffer).
            host_batch, decode_s = item
            t = time.perf_counter()
            dev_args = slot.stage(host_batch)
            h2d = sum(int(getattr(a, "nbytes", 0)) for a in host_batch.device_args)
            return host_batch, dev_args, decode_s, time.perf_counter() - t, h2d

        stream = double_buffer(prefetched, stage)
        try:
            todo_pos = {b.index: i for i, b in enumerate(todo)}
            for host_batch, dev_args, decode_s, stage_s, h2d_bytes in stream:
                batch = host_batch.batch
                bidx = batch.index
                cells = [
                    blk for blk in blocks
                    if pending is None or (bidx, blk.index) in pending
                ]
                nxt = todo_pos.get(bidx, len(todo)) + 1
                next_batch = todo[nxt] if nxt < len(todo) else None
                for pos, blk in enumerate(cells):
                    t0 = time.perf_counter()
                    out = slot.step(*dev_args, slot.panel_block(batch, blk))
                    # Look ahead one cell on the trait axis (then wrap to the
                    # next batch's first block), requested before the device
                    # fence so staging overlaps the step.
                    if pos + 1 < len(cells):
                        panel_la.request(batch, cells[pos + 1])
                    elif next_batch is not None and blocks:
                        panel_la.request(next_batch, blocks[0])
                    # Split the cell's wall time at the device fence: kernels
                    # run asynchronously, so t1 - t0 is device time and
                    # t2 - t1 the host payload extraction.
                    synchronize(slot.device)
                    t1 = time.perf_counter()
                    cell = _live_cell(host_batch, out, blk, cfg, prep.dof)
                    t2 = time.perf_counter()
                    yield cell, CellTiming(
                        batch_index=bidx,
                        block_index=blk.index,
                        n_markers=cell.n_markers,
                        n_traits=cell.n_traits,
                        wall_s=t2 - t0,
                        step_s=t1 - t0,
                        extract_s=t2 - t1,
                        # Attributed to the batch's first cell; later cells
                        # of the sweep reuse the staged copy.
                        decode_s=decode_s if pos == 0 else 0.0,
                        stage_s=stage_s if pos == 0 else 0.0,
                        h2d_bytes=h2d_bytes if pos == 0 else 0,
                        device=slot.label,
                    )
        finally:
            # Error path included: a raising consumer or engine step must not
            # leave decode workers alive or the in-flight staged copy pinned.
            stream.close()
            prefetched.shutdown()
            panel_la.shutdown()
            slot.reset()


class ScanSession:
    """One executable pass over the scan grid, streaming ``CellResult``s.

    ``events()`` is a one-shot generator: live cells in grid order (marker
    batches outer, trait blocks inner), then — when resuming — the replayed
    cells committed by previous runs.  All pipeline teardown happens in its
    ``finally``, so consumers that raise mid-stream must ``close()`` the
    generator (or just iterate with a ``for`` loop, which does).
    """

    def __init__(
        self,
        prepared: PreparedScan,
        *,
        resume: bool = True,
    ):
        self.prepared = prepared
        self.study = prepared.study
        self.config = prepared.config
        self.resume = resume
        self._consumed = False
        self._batches = list(prepared.batches)

        # devices=0 means every visible device; only the serial walk on one
        # device is ported.
        n_visible = torch.cuda.device_count() if prepared.device.type == "cuda" else 1
        self.n_devices = self.config.devices if self.config.devices > 0 else n_visible
        if self.n_devices != 1:
            raise NotImplementedError(_NOT_PORTED_EXECUTOR)
        self.metrics = ScanMetrics(
            n_cells_total=len(self._batches) * prepared.n_trait_blocks
        )
        # Optional observer called after every recorded cell (the CLI's
        # progress line); must be cheap, runs on the consumer thread.
        self.progress: Callable[[ScanMetrics], None] | None = None
        self.executor_info: dict | None = None

        self.checkpoint: ScanCheckpoint | None = None
        if self.config.checkpoint_dir:
            self.checkpoint = ScanCheckpoint(
                self.config.checkpoint_dir,
                fingerprint=prepared.fingerprint(),
                n_batches=prepared.n_batches,
                n_blocks=prepared.n_trait_blocks,
            )

    @property
    def n_batches(self) -> int:
        return self.prepared.n_batches

    @property
    def n_trait_blocks(self) -> int:
        return self.prepared.n_trait_blocks

    @property
    def n_markers(self) -> int:
        return self.study.n_markers

    @property
    def n_samples(self) -> int:
        return self.study.n_samples

    @property
    def n_traits(self) -> int:
        return self.study.n_traits

    @property
    def dof(self) -> int:
        return self.prepared.dof

    @property
    def lmm_info(self) -> dict | None:
        return self.prepared.lmm_info

    @property
    def hit_threshold(self) -> float:
        return self.config.hit_threshold_nlp

    @property
    def multivariate(self) -> bool:
        return self.config.multivariate

    @property
    def marker_ids(self):
        return self.study.marker_ids

    @property
    def trait_names(self):
        return self.study.trait_names

    def events(self) -> Iterator[CellResult]:
        """Stream the grid: compute pending cells on the serial executor,
        commit + yield each as a ``CellResult``, then replay previously
        committed cells (resume)."""
        if self._consumed:
            raise RuntimeError("ScanSession.events() is one-shot; open a new session")
        self._consumed = True
        ckpt = self.checkpoint

        todo = self._batches
        pending: set[tuple[int, int]] | None = None   # (batch, block) cells
        if ckpt is not None and self.resume:
            ckpt.refresh()
            pending = set(ckpt.pending_cells())
            # A marker batch is re-staged iff ANY of its cells is pending;
            # completed cells of a re-staged batch are skipped by the
            # executor and replayed from their shards below.
            batches_pending = {b for b, _ in pending}
            todo = [b for b in self._batches if b.index in batches_pending]

        executor = SerialExecutor(self.prepared)
        computed: set[tuple[int, int]] = set()
        self.metrics.start()
        stream = executor.cells(todo, pending)
        try:
            for cell, timing in stream:
                if ckpt is not None:
                    # Commit the shard, then the manifest — a crash between
                    # the two just re-does one grid cell.
                    ckpt.commit_cell(cell.batch_index, cell.block_index, cell.payload())
                computed.add((cell.batch_index, cell.block_index))
                self.metrics.record(timing)
                if self.progress is not None:
                    self.progress(self.metrics)
                yield cell
        finally:
            stream.close()
            self.executor_info = executor.info()
            self.metrics.finish()

        # Resume path: replay committed-but-not-recomputed cells' shards.
        if ckpt is not None:
            ckpt.refresh()
            for bidx, kidx in sorted(ckpt.completed_cells() - computed):
                t0 = time.perf_counter()
                cell = CellResult.from_shard(bidx, kidx, ckpt.load_cell(bidx, kidx))
                self.metrics.record(CellTiming(
                    batch_index=bidx,
                    block_index=kidx,
                    n_markers=cell.n_markers,
                    n_traits=cell.n_traits,
                    wall_s=time.perf_counter() - t0,
                    device="checkpoint",
                    replayed=True,
                ))
                if self.progress is not None:
                    self.progress(self.metrics)
                yield cell
            self.metrics.finish()

    def stream_to(self, *writers) -> dict:
        """Drive ``events()`` through result writers: open each, feed every
        cell, close in order; abort them all if anything raises.  Returns
        the merged summary dict of the writers' ``close()`` results."""
        from repro_torch.api.writers import stream_session

        return stream_session(self, writers)


class CheckpointReplay:
    """An offline session over a committed checkpoint directory: replays
    every committed cell as a ``CellResult`` without touching genotypes.
    Grid extents are inferred from the shards."""

    def __init__(self, root: str, *, marker_ids=None, trait_names=None):
        self.checkpoint = ScanCheckpoint.open_existing(root)
        self.marker_ids = marker_ids
        self.trait_names = trait_names
        cells = sorted(self.checkpoint.completed_cells())
        if not cells:
            raise ValueError(f"checkpoint at {root} has no committed cells")
        self._cells = cells
        last_batch = max(b for b, _ in cells)
        last_block = max(k for _, k in cells)
        probe_b = self.checkpoint.load_cell(
            last_batch, max(k for b, k in cells if b == last_batch)
        )
        probe_k = self.checkpoint.load_cell(
            max(b for b, k in cells if k == last_block), last_block
        )
        self.n_markers = int(probe_b["hi"])
        self.n_traits = int(probe_k.get("t_hi", probe_k["best_nlp"].shape[0]))
        self.n_trait_blocks = self.checkpoint.n_blocks
        self.n_batches = self.checkpoint.n_batches
        blk0 = next(((b, k) for b, k in cells if k == 0), None)
        self.multivariate = (
            blk0 is not None and "omnibus_nlp" in self.checkpoint.load_cell(*blk0)
        )
        self.dof = None
        self.lmm_info = None
        self.hit_threshold = None

    @property
    def complete(self) -> bool:
        return self.checkpoint.is_complete()

    def events(self) -> Iterator[CellResult]:
        for bidx, kidx in self._cells:
            yield CellResult.from_shard(
                bidx, kidx, self.checkpoint.load_cell(bidx, kidx)
            )

    def stream_to(self, *writers) -> dict:
        from repro_torch.api.writers import stream_session

        return stream_session(self, writers)
