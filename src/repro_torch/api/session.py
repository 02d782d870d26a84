"""Plan -> execute: ``ScanPlan`` compiles a Study + specs into a prepared
scan; ``ScanSession.events()`` streams per-grid-cell ``CellResult``s.

The session yields each completed (marker-batch x trait-block) cell as a
``CellResult`` the moment it is computed (or replayed from a checkpoint
shard), and *consumers* decide what to keep:

    for cell in session.events():      # streams; never holds (M, P) arrays
        writer.write(cell)

The executor behind ``events()`` is pluggable: ``SerialExecutor`` is the
single-device grid walk (marker batches outer, trait blocks inner);
``MultiDeviceExecutor`` drains the same grid across N devices through the
work-stealing ``runtime.scheduler.CellScheduler``, one ``_Slot`` of explicit
per-device state (engine device caches, panel view, step, and on CUDA one
stream) per device, and with the ``shared-fs`` scheduler backend across
independent host processes that share the checkpoint directory.  Results are
bitwise-identical, completion order is free, and the cell-keyed checkpoint
is the coordination substrate either way.

Under a sharding mesh (``ScanPlan(mesh=)``: a ``torch.distributed``
``DeviceMesh``, one process per card) every rank runs the same session on
the serial walk: rank 0 decides the resume set and broadcasts it, each step
computes on the rank's blocks and gathers the full tiles, and only rank 0
commits checkpoint cells and feeds the result writers.

Checkpointing rides the session: each live cell's payload is committed to
the cell-keyed manifest before the cell is yielded, and on resume the
committed cells of previous runs are replayed as ``CellResult``s after the
live stream.  The checkpoint format and fingerprint are the ``repro``
package's, so a scan checkpointed by either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import socket
import threading
import time
import warnings
from collections import deque
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
from repro_torch.runtime import spans
from repro_torch.runtime.checkpoint import ScanCheckpoint, config_fingerprint
from repro_torch.runtime.device import on_stream, resolve_device, synchronize
from repro_torch.runtime.prefetch import (
    BatchPlanner,
    DecodePool,
    MarkerBatch,
    Prefetcher,
    TraitBlock,
    TraitBlockPlanner,
    double_buffer,
)
from repro_torch.runtime.scheduler import CellScheduler
from repro_torch.runtime.sharding import (
    broadcast_array,
    broadcast_object,
    check_mesh,
    gather_objects,
    is_lead,
    mesh_axes,
    mesh_device,
)

__all__ = [
    "CellResult",
    "PreparedScan",
    "ScanPlan",
    "ScanSession",
    "SerialExecutor",
    "MultiDeviceExecutor",
    "CheckpointReplay",
]


LAMBDA_PROBE_ROWS = 64  # rows of the first-trait t probe persisted per batch


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
    # the sharding mesh (None: one device); not part of the fingerprint, so
    # a checkpoint cut under one mesh resumes under another or none
    mesh: Any = None

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

    ``mesh`` (a ``DeviceMesh`` with axes ``("data", "model")`` or ``("pod",
    "data", "model")``) shards every step over its ranks; each rank builds
    the same plan and runs it.  The device comes from the mesh: a CUDA mesh
    computes on the rank's current card over NCCL, a CPU mesh on the CPU,
    and ``config.device`` must name the same kind.  Rank 0 computes what a
    card's arithmetic could make differ between ranks — the residualized
    panel and covariate basis, the multivariate whitening, the mixed model's
    GRM, spectrum, REML and rotation — and every rank receives its bits.
    """

    def __init__(self, study: Study, config: ScanConfig, *, mesh: Any = None):
        if mesh is not None:
            check_mesh(mesh)
        self.study = study
        self.config = config
        self.mesh = mesh
        self._prepared: PreparedScan | None = None

    def prepare(self) -> PreparedScan:
        if self._prepared is not None:
            return self._prepared
        study, config, mesh = self.study, self.config, self.mesh
        device = (
            resolve_device(config.device) if mesh is None
            else mesh_device(mesh, config.device)
        )
        lead = is_lead(mesh)
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
        if config.multivariate and len(trait_blocks) > 1:
            raise ValueError(
                "the multivariate omnibus screen needs the whole panel per "
                "marker (it combines evidence across every trait); run it "
                "unblocked (trait_block=0)"
            )

        n_traits_eff = float(study.n_traits)
        whitening = None
        panels: PanelStore | None = None
        q = None
        if engine.uses_global_panel:
            # OLS panel prep (Eq. 1), amortized once into a host-side store.
            # Engines that build their own panel (lmm: rotated per LOCO scope
            # in setup_scan) skip it.
            if lead:
                q = covariate_basis(covariates, n_samples, device=device)
                panels = PanelStore.residualized(
                    phenotypes, q, trait_blocks,
                    quantum=config.block_p,
                    max_resident=config.panel_resident_blocks,
                )
            if mesh is not None:
                q = torch.from_numpy(broadcast_array(
                    q.cpu().numpy() if lead else None, device
                )).to(device)
                panel = broadcast_array(panels.host_panel if lead else None, device)
                if not lead:
                    panels = PanelStore(trait_blocks, panel, device=device,
                                        max_resident=config.panel_resident_blocks)
            n_covariates = int(q.shape[1]) - 1
            if config.multivariate:
                from repro_torch.core import multivariate as mv

                # Unblocked by the check above: block 0 is the full panel,
                # staged on the scan's device, where the P x P Gram product
                # and its eigendecomposition run.
                if lead:
                    y_full = panels.device_block(trait_blocks[0])
                    whitening, eig = mv.whiten_panel(y_full)
                    n_traits_eff = float(mv.effective_tests(eig))
                if mesh is not None:
                    whitening = torch.from_numpy(broadcast_array(
                        whitening.cpu().numpy() if lead else None, device
                    )).to(device)
                    n_traits_eff = broadcast_object(n_traits_eff)
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
            mesh=mesh,
        )
        if genotype_staging == "packed":
            _configure_packed_cache(config.packed_cache_mb)
        ctx = EngineContext(
            n_samples=n_samples,
            n_covariates=n_covariates,
            options=config.options,
            device=device,
            mesh=mesh,
            mode=config.mode,
            hit_threshold=config.hit_threshold_nlp,
            maf_min=config.maf_min,
            block_m=config.block_m,
            block_n=config.block_n,
            block_p=config.block_p,
            q_basis=q,
            multivariate=config.multivariate,
            n_traits_eff=n_traits_eff,
            whitening=whitening,
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
            mesh=mesh,
        )
        return self._prepared

    def run(
        self,
        *,
        resume: bool = True,
        executor=None,
        marker_window: tuple[int, int] | None = None,
    ) -> "ScanSession":
        """Prepare (if not already) and open an executable session.

        ``executor`` injects a pre-built executor handle (the serve layer's
        shared worker pool) instead of the session constructing its own;
        ``marker_window`` restricts the run to the batch-aligned sub-grid
        covering ``[lo, hi)`` markers.
        """
        return ScanSession(
            self.prepare(), resume=resume, executor=executor,
            marker_window=marker_window,
        )


# ------------------------------------------------------------------ executor


class _Slot:
    """One executor slot: the engine's per-device state plus — for
    global-panel engines — a view of the session's panel store on the same
    device.

    This object is the explicit home of everything that rides on one
    device (staged panel blocks, the lmm scope caches, the step's prolog
    memo): one slot per device, no sharing.  On CUDA a multi-device slot
    also owns one stream, and every thread working for the slot (its worker,
    its panel look-ahead, its tail) issues its CUDA work there, so staging,
    steps, kernels and device-to-host pulls are ordered on one queue and the
    caching allocator only reuses a block after the slot's own earlier work
    with it.  ``device=None`` is the serial slot: the scan's device on the
    thread's default stream.
    """

    def __init__(self, prepared: "PreparedScan", *, device: torch.device | None = None,
                 step: Callable[..., dict] | None = None, label: str = "serial"):
        self.device = device
        self.label = label
        self._fence_device = prepared.device if device is None else device
        self.stream = (
            torch.cuda.Stream(device=device)
            if device is not None and device.type == "cuda" else None
        )
        with on_stream(self.stream):
            self.state = prepared.engine.make_device_state(
                prepared.ctx, device=device, step=step
            )
        # Under a mesh the panel blocks stay on the host; each rank's step
        # moves its own columns (and rows, in sample mode) to the card.
        self._view_device = torch.device("cpu") if prepared.mesh is not None else device
        self.panels = (
            prepared.panels.device_view(self._view_device)
            if prepared.panels is not None else None
        )

    def fence(self) -> None:
        """Wait for the slot's queued device work: its own stream, or the
        whole device for the serial slot."""
        if self.stream is not None:
            self.stream.synchronize()
        else:
            synchronize(self._fence_device)

    def stage(self, host_batch) -> tuple:
        with spans.span("stage", batch=host_batch.batch.index):
            return self.state.stage(host_batch)

    def step(self, *args) -> dict:
        return self.state.step(*args)

    def panel_block(self, batch: MarkerBatch, block: TraitBlock):
        """The trailing step argument for one grid cell: the slot's view of
        the session's residualized store for OLS engines, the engine device
        state's per-scope rotated panel for the rest."""
        if self.panels is not None:
            return self.panels.device_block(block)
        return self.state.panel_block(batch, block)

    def reset(self) -> None:
        self.state.reset()
        # Per-device panel views die with their slot (their blocks must not
        # stay on the device after the scan).  The serial slot's view is the
        # store's shared default LRU, deliberately left resident: a warm
        # cache across runs of a plan.
        if self.panels is not None and self._view_device is not None:
            self.panels.release()


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


def _put_or_drop(q: queue.Queue, item, stop: threading.Event, wait_span: str) -> None:
    """Put ``item`` on the bounded ``q``; while it is full, wait inside span
    ``wait_span``.  Never blocks forever: once ``stop`` is set the item is
    dropped (teardown, nobody is listening)."""
    try:
        q.put_nowait(item)
        return
    except queue.Full:
        pass
    with spans.span(wait_span):
        while True:
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                if stop.is_set():
                    return


class _SlotTail:
    """Per-slot downstream tail: one FIFO thread that runs payload
    materialization (the device-to-host pulls), checkpoint commit and result
    delivery off the compute thread's critical path, so the pulls and
    manifest writes of cell k overlap the device step of cell k+1.  It
    issues its CUDA work on the slot's ``stream``.

    Strict FIFO is the correctness story: the compute thread enqueues each
    cell's emit task followed by its run's ``complete`` task, so a cell is
    always committed before its lease is marked done (the shared-fs ordering
    contract) and per-slot delivery order matches the unpipelined path.  A
    failing task is reported through ``on_error`` and all later tasks are
    drained unexecuted — in particular the run's ``complete`` never fires,
    so the lease is left to expire exactly as a worker crash would.
    """

    def __init__(self, *, stop: threading.Event, on_error: Callable, name: str,
                 stream: "torch.cuda.Stream | None" = None):
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._stop = stop
        self._on_error = on_error
        self._stream = stream
        self._failed = False
        self._thread = threading.Thread(target=self._run, daemon=True, name=name)
        self._thread.start()

    def submit(self, task: Callable[[], None]) -> None:
        """Enqueue (bounded: blocks the compute thread when the tail is >4
        cells behind — host-RAM backpressure) unless teardown started."""
        _put_or_drop(self._q, task, self._stop, "tail_wait")

    def _run(self) -> None:
        with on_stream(self._stream):
            while True:
                task = self._q.get()
                if task is None:
                    return
                if self._failed:
                    continue
                try:
                    task()
                except BaseException as e:  # noqa: BLE001 — reported to consumer
                    self._failed = True
                    self._on_error(e)

    def flush(self) -> None:
        """Wait until every task queued so far has run (or teardown
        started; a failed tail runs nothing more, and its error ends the
        scan)."""
        ran = threading.Event()
        self.submit(ran.set)
        while not ran.wait(0.05):
            if self._stop.is_set():
                return

    def close(self, *, join_timeout: float = 10.0) -> None:
        """Drain queued tasks, then stop and join the thread.  The put may
        block briefly but always lands: the tail consumes unconditionally
        (even after a failure it drains)."""
        self._q.put(None)
        self._thread.join(timeout=join_timeout)


class SerialExecutor:
    """The single-device grid walk: marker batches outer (decode prefetch +
    H2D double buffer), trait blocks inner (each staged genotype batch
    sweeps every pending block before the next copy), with the trait-axis
    panel look-ahead staging block b+1 during block b."""

    kind = "serial"

    def __init__(self, prepared: "PreparedScan", *, step: Callable[..., dict] | None = None):
        self.prepared = prepared
        self._step = step

    def info(self) -> dict:
        out = {"kind": self.kind, "devices": 1, "device": str(self.prepared.device)}
        mesh = self.prepared.mesh
        if mesh is not None:
            out["mesh"] = {"axes": list(mesh_axes(mesh)),
                           "shape": [int(n) for n in mesh.shape]}
        return out

    def cells(self, todo, pending) -> Iterator[tuple["CellResult", CellTiming]]:
        prep = self.prepared
        cfg = prep.config
        engine = prep.engine
        blocks = prep.trait_blocks
        slot = _Slot(prep, step=self._step, label="serial")

        def decode(b):
            with spans.span("decode", batch=b.index):
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
                    # The spans open and close at the clock reads that time
                    # step_s and extract_s.
                    with spans.span("step", batch=bidx, block=blk.index):
                        t0 = time.perf_counter()
                        out = slot.step(*dev_args, slot.panel_block(batch, blk))
                        # Look ahead one cell on the trait axis (then wrap to
                        # the next batch's first block), requested before the
                        # device fence so staging overlaps the step.
                        if pos + 1 < len(cells):
                            panel_la.request(batch, cells[pos + 1])
                        elif next_batch is not None and blocks:
                            panel_la.request(next_batch, blocks[0])
                        # Split the cell's wall time at the device fence:
                        # kernels run asynchronously, so t1 - t0 is device
                        # time and t2 - t1 the host payload extraction.
                        slot.fence()
                        t1 = time.perf_counter()
                    with spans.span("extract", batch=bidx, block=blk.index):
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


class MultiDeviceExecutor:
    """Drain the scan grid across N devices with work stealing and per-slot
    streaming pipelines.

    One worker thread per device slot; each claims ``CellRun``s from the
    ``CellScheduler`` (lease = runs of cells sharing a marker batch, so a
    claimed genotype batch is staged once per device and swept) and computes
    cells on its own ``_Slot``: explicit placement on the slot's device, a
    per-slot step and prolog memo, per-slot panel and lmm caches, and on
    CUDA one stream per slot.  On CUDA the slots take ``cuda:0 ..
    cuda:N-1`` (the scan's own device first); on the CPU the N slots share
    the CPU device — the port's counterpart of the reference tests' fake
    host devices, which exercises every thread, queue and lease of the
    executor.

    With ``slot_prefetch > 0`` each worker runs a three-stage pipeline:

        look-ahead   the worker claims up to ``slot_prefetch`` items beyond
                     the one it is computing (non-blocking claims) and
                     submits their genotype decode to a shared
                     ``DecodePool`` of ``io_workers`` threads, then stages
                     the next batch's host-to-device copy while the device
                     works on the current one; a per-slot
                     ``PanelPrefetcher`` stages the next cell's panel block.
        compute      the device step, fenced on the slot's stream on the
                     compute thread (``step_s`` stays honest).
        tail         payload materialization (device-to-host), checkpoint
                     commit and result delivery on a per-slot ``_SlotTail``
                     FIFO thread, overlapping the next cell's step.  FIFO
                     order keeps commit-before-lease-done (the run's
                     ``complete`` is enqueued after its cells).

    ``slot_prefetch=0`` is the unpipelined claim loop.  Either way the math
    is untouched: compute order per slot, staged tensors and the globally
    aligned ``block_p`` tiles are identical — pipelining only moves when host
    work happens — so outputs stay bitwise-identical to the serial
    executor.  Completion order is whatever the fleet produces; the session
    commits each cell before yielding and the sinks/writers normalize fold
    order.

    ``autotune_lease`` shrinks the lease extent toward the tail of the scan
    from the scheduler's live ``busy_s``/``wait_s`` accounting (guided
    self-scheduling), so late slots never idle behind one straggler's large
    lease.  Retunes affect future refills only.

    Spans (``runtime.spans``, off by default): ``claim`` around each
    worker's ``sched.claim``, ``result_wait`` around a put onto the full
    results queue (the single consumer holding the fleet back), beside the
    pool's ``batch_wait`` and the tails' ``tail_wait``.
    """

    kind = "multi-device"

    def __init__(self, prepared: "PreparedScan", *, n_devices: int,
                 placement: str = "marker-major", lease_batches: int = 2,
                 backend: str = "threads", backend_opts: dict | None = None,
                 slot_prefetch: int = 1, autotune_lease: bool = True):
        base = prepared.device
        if base.type == "cuda":
            visible = torch.cuda.device_count()
            if n_devices > visible:
                raise ValueError(
                    f"devices={n_devices} but only {visible} visible (cuda); "
                    "reduce --devices or expose more devices"
                )
            others = [torch.device("cuda", i) for i in range(visible) if i != base.index]
            self.devices = ([base] + others)[:n_devices]
        else:
            self.devices = [base] * n_devices
        self.prepared = prepared
        self.placement = placement
        self.lease_batches = lease_batches
        self.backend = backend
        self.backend_opts = dict(backend_opts or {})
        self.slot_prefetch = max(0, int(slot_prefetch))
        self.autotune_lease = bool(autotune_lease)
        # Under a distributed backend the worker labels are host-qualified
        # (CellTiming.device, summary.json worker stats): N processes share
        # one grid, and "dev0" alone no longer names a unique slot.
        host = self.backend_opts.get("host_id")
        self._label_prefix = f"{host}/" if (backend != "threads" and host) else ""
        self._worker_stats: dict = {}
        self._autotune: dict = {
            "enabled": self.autotune_lease,
            "initial_lease": lease_batches,
            "final_lease": lease_batches,
            "adjustments": 0,
            "wait_share": None,
            "placement_warning": None,
        }
        # Distributed-backend commit hook (set by the session): a cell must
        # be committed to the checkpoint before its lease is marked done —
        # peers treat a done lease as "in the manifest", so the reverse order
        # would let a crash between the two lose the cell for good.
        # Committing on the slot's own pipeline (not the consumer) is what
        # makes the ordering enforceable.
        self.commit: Callable[["CellResult"], object] | None = None

    def info(self) -> dict:
        out = {
            "kind": self.kind,
            "devices": len(self.devices),
            "placement": self.placement,
            "lease_batches": self.lease_batches,
            "slot_prefetch": self.slot_prefetch,
            "backend": self.backend,
            "autotune": dict(self._autotune),
            "workers": {
                w: dataclasses.asdict(st) for w, st in sorted(self._worker_stats.items())
            },
        }
        if self.backend != "threads":
            out["host_id"] = self.backend_opts.get("host_id")
        return out

    def cells(self, todo, pending) -> Iterator[tuple["CellResult", CellTiming]]:
        prep = self.prepared
        cfg = prep.config
        engine = prep.engine
        sched = CellScheduler(
            todo, prep.trait_blocks, pending,
            placement=self.placement, lease_size=self.lease_batches,
            n_workers=len(self.devices),
            backend=self.backend, backend_opts=self.backend_opts,
        )
        self._autotune["initial_lease"] = sched.lease_size
        self._autotune["final_lease"] = sched.lease_size
        # Bounded: in-flight materialized cells are capped per slot, so the
        # fleet cannot outrun a slow consumer into unbounded host RAM.
        results: queue.Queue = queue.Queue(maxsize=4 * len(self.devices))
        stop = threading.Event()
        done = object()
        depth = self.slot_prefetch

        def put(item) -> None:
            # A full queue is the consumer holding the fleet back.
            _put_or_drop(results, item, stop, "result_wait")

        def decode(batch):
            with spans.span("decode", batch=batch.index):
                t = time.perf_counter()
                hb = engine.prepare_batch(prep.study.source, batch, prep.ctx)
                return hb, time.perf_counter() - t

        # One pool across every slot: total host decode parallelism is
        # io_workers — the meaning the knob has under the serial executor —
        # however many devices drain the grid.
        pool = DecodePool(decode, num_workers=cfg.io_workers) if depth > 0 else None

        def worker(wid: int, device: torch.device) -> None:
            label = f"{self._label_prefix}dev{wid}"
            try:
                slot = _Slot(prep, device=device, label=label)
            except BaseException as e:  # noqa: BLE001 — reported to consumer
                put(e)
                put(done)
                return
            panel_la = (
                PanelPrefetcher(slot.panel_block, name=f"panel-prefetch-dev{wid}",
                                stream=slot.stream)
                if depth > 0 else None
            )
            tail = (
                _SlotTail(stop=stop, on_error=put, name=f"slot-tail-{wid}",
                          stream=slot.stream)
                if depth > 0 else None
            )
            # Staged memo, capacity depth+1: the batch being computed plus
            # the look-ahead batches whose copies landed early.  With depth=0
            # this degenerates to a one-slot memo.
            staged: dict[int, tuple] = {}   # idx -> (hb, dev, dec_s, stg_s, h2d)
            inflight: set[int] = set()      # batch idxs pending in the pool
            ahead: deque = deque()          # claimed (idx, run), decode submitted

            def ensure_decode(batch) -> None:
                if batch.index not in staged and batch.index not in inflight:
                    pool.submit((wid, batch.index), batch)
                    inflight.add(batch.index)

            def staged_args(batch) -> tuple:
                if batch.index not in staged:
                    if batch.index in inflight:
                        hb, decode_s = pool.result((wid, batch.index))
                        inflight.discard(batch.index)
                    else:
                        hb, decode_s = decode(batch)
                    t = time.perf_counter()
                    dev_args = slot.stage(hb)
                    h2d = sum(int(getattr(a, "nbytes", 0)) for a in hb.device_args)
                    staged[batch.index] = (
                        hb, dev_args, decode_s, time.perf_counter() - t, h2d
                    )
                    while len(staged) > depth + 1:
                        oldest = next(iter(staged))
                        if oldest == batch.index:
                            break
                        del staged[oldest]
                return staged[batch.index]

            def make_emit(hb, out, blk, batch, step_s, decode_s, stage_s, h2d_bytes):
                def emit() -> None:
                    with spans.span("extract", batch=batch.index, block=blk.index):
                        t = time.perf_counter()
                        cell = _live_cell(hb, out, blk, cfg, prep.dof)
                        if self.commit is not None:
                            self.commit(cell)
                        extract_s = time.perf_counter() - t
                    put((cell, CellTiming(
                        batch_index=batch.index,
                        block_index=blk.index,
                        n_markers=cell.n_markers,
                        n_traits=cell.n_traits,
                        # Not contiguous wall clock under the pipeline: the
                        # extract ran later, overlapped with another cell's
                        # step.  step + extract is the cell's true cost.
                        wall_s=step_s + extract_s,
                        step_s=step_s,
                        extract_s=extract_s,
                        decode_s=decode_s,
                        stage_s=stage_s,
                        h2d_bytes=h2d_bytes,
                        device=label,
                    )))
                return emit

            try:
                with on_stream(slot.stream):
                    while not stop.is_set():
                        # Refill the look-ahead window: the item in hand plus
                        # up to `depth` beyond it, decodes submitted at claim
                        # time so the pool works while this slot computes.
                        # Only the first claim may block (distributed
                        # backends poll out peers' undone leases): a worker
                        # with work in hand must never park on the queue.
                        # Before it blocks, its own tail retires what it
                        # computed: a lease still waiting there for its
                        # ``complete`` counts as undone, and the claim
                        # would sleep a whole poll interval on it.
                        while len(ahead) < depth + 1:
                            if not ahead and tail is not None and self.backend != "threads":
                                tail.flush()
                            with spans.span("claim"):
                                got = sched.claim(label, block=not ahead)
                            if got is None:
                                break
                            if depth > 0:
                                ensure_decode(got[1].batch)
                            ahead.append(got)
                        if not ahead:
                            break
                        idx, run = ahead.popleft()
                        batch = run.batch
                        hb, dev_args, decode_s, stage_s, h2d_bytes = staged_args(batch)
                        # decode/stage are attributed to the first cell
                        # computed off a fresh staging, once.
                        staged[batch.index] = (hb, dev_args, 0.0, 0.0, 0)
                        for pos, blk in enumerate(run.blocks):
                            if stop.is_set():
                                return
                            with spans.span("step", batch=batch.index, block=blk.index):
                                t0 = time.perf_counter()
                                out = slot.step(*dev_args, slot.panel_block(batch, blk))
                                # Overlap windows open between launch and
                                # fence: the next cell's panel block and
                                # (first cell of the run only) the look-ahead
                                # batch's staging.
                                if panel_la is not None:
                                    if pos + 1 < len(run.blocks):
                                        panel_la.request(batch, run.blocks[pos + 1])
                                    elif ahead:
                                        nrun = ahead[0][1]
                                        panel_la.request(nrun.batch, nrun.blocks[0])
                                if depth > 0 and ahead:
                                    # Stage the look-ahead batch's copy as
                                    # soon as its decode lands (double
                                    # buffer) — probed, never waited on.
                                    nxt = ahead[0][1].batch
                                    if nxt.index not in staged and pool.ready((wid, nxt.index)):
                                        staged_args(nxt)
                                slot.fence()
                                step_s = time.perf_counter() - t0
                            emit = make_emit(
                                hb, out, blk, batch, step_s, decode_s, stage_s, h2d_bytes,
                            )
                            if tail is not None:
                                tail.submit(emit)
                            else:
                                emit()
                            decode_s = stage_s = 0.0
                            h2d_bytes = 0
                        if tail is not None:
                            tail.submit(lambda label=label, idx=idx: sched.complete(label, idx))
                        else:
                            sched.complete(label, idx)
            except BaseException as e:  # noqa: BLE001 — reported to consumer
                put(e)
            finally:
                # Error/teardown path: cancel look-ahead decodes, drain the
                # tail (delivering its finished cells), drop staged copies
                # and release the slot's device memory.  Unserved claimed
                # items are never completed — their leases expire (shared-fs)
                # exactly as a crash would, or die with the scan (threads).
                if pool is not None:
                    for b in inflight:
                        pool.discard((wid, b))
                if tail is not None:
                    tail.close()
                if panel_la is not None:
                    panel_la.shutdown()
                staged.clear()
                slot.reset()
                put(done)

        threads = [
            threading.Thread(
                target=worker, args=(i, d), daemon=True, name=f"scan-device-{i}"
            )
            for i, d in enumerate(self.devices)
        ]
        for t in threads:
            t.start()
        finished = 0
        decode_total = step_total = 0.0
        last_tune = time.monotonic()
        try:
            while finished < len(threads):
                item = results.get()
                if item is done:
                    finished += 1
                elif isinstance(item, BaseException):
                    raise item
                else:
                    decode_total += item[1].decode_s
                    step_total += item[1].step_s
                    if self.autotune_lease:
                        now = time.monotonic()
                        if now - last_tune >= 0.5:
                            last_tune = now
                            self._tune_lease(sched)
                    yield item
        finally:
            stop.set()
            # Unblock workers parked in a blocking claim (the shared-fs
            # backend polls while peers hold undone leases) and in decode
            # waits ...
            sched.stop()
            if pool is not None:
                pool.shutdown()
            # ... and producers stuck on the bounded queue, then join.
            for t in threads:
                while t.is_alive():
                    try:
                        while True:
                            results.get_nowait()
                    except queue.Empty:
                        pass
                    t.join(timeout=0.1)
            self._worker_stats = sched.stats()
            self._finish_accounting(decode_total, step_total)

    def _tune_lease(self, sched: CellScheduler) -> None:
        """Guided self-scheduling on live accounting: target half the
        remaining items spread over the fleet (never above the configured
        initial — large early leases amortize queue traffic, small late ones
        balance the tail), and halve once when the fleet's wait share says
        slots are starving behind peers' leases.  The share is the workers'
        ``wait_s`` over ``busy_s + wait_s``: ~0 under look-ahead, where no
        worker is ever without a claimed item (the ``claim`` and
        ``result_wait`` spans time the fleet's waits there)."""
        stats = sched.stats()
        busy = sum(s.busy_s for s in stats.values())
        wait = sum(s.wait_s for s in stats.values())
        share = wait / (busy + wait) if busy + wait > 0 else 0.0
        initial = self._autotune["initial_lease"]
        target = max(1, min(initial, sched.remaining() // (2 * len(self.devices))))
        if share > 0.3:
            target = min(target, max(1, sched.lease_size // 2))
        self._autotune["wait_share"] = round(share, 3)
        if target != sched.lease_size:
            sched.set_lease_size(target)
            self._autotune["adjustments"] += 1
            self._autotune["final_lease"] = target

    def _finish_accounting(self, decode_total: float, step_total: float) -> None:
        stats = self._worker_stats
        busy = sum(s.busy_s for s in stats.values())
        wait = sum(s.wait_s for s in stats.values())
        if busy + wait > 0:
            self._autotune["wait_share"] = round(wait / (busy + wait), 3)
        if (
            self.placement == "trait-major"
            and self.prepared.n_trait_blocks > 1
            and step_total > 0
            and decode_total > step_total
        ):
            msg = (
                "trait-major placement re-decodes each genotype batch once "
                f"per trait block, and this scan spent {decode_total:.1f}s "
                f"decoding vs {step_total:.1f}s computing — marker-major "
                "placement (one decode per batch, swept over every block) "
                "would likely be faster"
            )
            self._autotune["placement_warning"] = msg
            warnings.warn(msg, RuntimeWarning, stacklevel=2)


def _adapt_swapped_step(step, prepared: PreparedScan):
    """A swapped step speaks the decoded staging currency; under packed
    staging the staged first argument is raw PLINK bytes.  Interpose the
    same device-side front the engine prologs use — its output is bitwise
    the host decode — so the caller's step sees exactly the inputs it
    always has."""
    ctx = prepared.ctx
    if getattr(ctx, "genotype_staging", "dense") != "packed":
        return step
    import functools

    from repro_torch.kernels.gwas_dot import ops as kops

    if prepared.config.engine == "fused":
        front = functools.partial(
            kops.repack_plink_tiled_device, n_samples=ctx.n_samples,
            block_n=ctx.block_n, block_m=ctx.block_m,
        )
    else:
        front = functools.partial(kops.decode_packed_device, n_samples=ctx.n_samples)

    def adapted(g_raw, *rest):
        return step(front(g_raw), *rest)

    if hasattr(step, "reset"):
        adapted.reset = step.reset
    return adapted


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
        step: Callable[..., dict] | None = None,
        executor=None,
        marker_window: tuple[int, int] | None = None,
    ):
        self.prepared = prepared
        self.study = prepared.study
        self.config = prepared.config
        self.resume = resume
        if step is not None and step is not prepared.step:
            step = _adapt_swapped_step(step, prepared)
        self._step = step if step is not None else prepared.step
        self._consumed = False
        # An injected executor handle (duck-typed: ``cells(todo, pending)``
        # generator + ``info()``) replaces the session-owned executor.
        self._executor = executor
        # A batch-aligned sub-grid: only marker batches overlapping [lo, hi)
        # are computed (the serve layer's marker-window queries).  The window
        # is widened to batch boundaries (``window_covered`` is the exact
        # extent), so every computed cell is bit-identical to the same cell
        # of a full scan.
        self.marker_window = marker_window
        if marker_window is not None:
            lo, hi = int(marker_window[0]), int(marker_window[1])
            if not (0 <= lo < hi <= self.study.n_markers):
                raise ValueError(
                    f"marker_window [{lo}, {hi}) outside [0, {self.study.n_markers})"
                )
            self._batches = [b for b in prepared.batches if b.hi > lo and b.lo < hi]
            self.window_covered = (self._batches[0].lo, self._batches[-1].hi)
        else:
            self._batches = list(prepared.batches)
            self.window_covered = None

        # Executor selection.  devices=0 means every visible device (every
        # CUDA card; the CPU counts as one); 1 is the serial walk.  Resolved
        # here, not in the fingerprint: a checkpoint cut under one device
        # count resumes under any other.
        n_visible = torch.cuda.device_count() if prepared.device.type == "cuda" else 1
        self.n_devices = self.config.devices if self.config.devices > 0 else n_visible
        self.mesh = prepared.mesh
        if self.mesh is not None:
            if self.n_devices > 1:
                raise ValueError(
                    "the multi-device grid executor and a sharding mesh are "
                    "exclusive parallelism axes; pass devices=1 with a mesh (or "
                    "drop the mesh to scale by grid cells)"
                )
            if self.config.exec_backend != "threads":
                # Leases claimed per process would hand the mesh's ranks
                # different cells, and their collectives would never meet.
                raise ValueError(
                    f"exec_backend={self.config.exec_backend!r} claims cells per "
                    "process; a sharding mesh walks one grid on every rank "
                    "(use the threads backend)"
                )
        self.metrics = ScanMetrics(
            n_cells_total=len(self._batches) * prepared.n_trait_blocks
        )
        # Optional observer called after every recorded cell (the CLI's
        # progress line); must be cheap, runs on the consumer thread.
        self.progress: Callable[[ScanMetrics], None] | None = None
        self.executor_info: dict | None = None

        if self.config.exec_backend != "threads" and not self.config.checkpoint_dir:
            raise ValueError(
                f"exec_backend={self.config.exec_backend!r} coordinates "
                "through the checkpoint directory (lease table + manifest); "
                "pass checkpoint_dir="
            )
        self.checkpoint: ScanCheckpoint | None = None
        # Under a mesh only rank 0 holds the checkpoint (and writes it).
        if self.config.checkpoint_dir and is_lead(self.mesh):
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

    def _backend_opts(self) -> dict:
        """Construction kwargs for a distributed scheduler backend: the
        lease table lives next to the checkpoint it coordinates."""
        if self.config.exec_backend == "threads":
            return {}
        return {
            "root": os.path.join(self.checkpoint.root, "leases"),
            "host_id": self.config.host_id or f"{socket.gethostname()}-{os.getpid()}",
            "lease_ttl": self.config.lease_ttl,
            # A peer's done lease is trusted only if its cells reached the
            # manifest: commit-before-done makes that the invariant, but a
            # lost manifest merge (flock-less mount) would otherwise turn a
            # done marker into a cell nobody computes or replays.
            "cell_committed": self.checkpoint.has_cell,
        }

    def _make_executor(self):
        if self._executor is not None:
            return self._executor
        # A distributed backend routes through the scheduler even on one
        # device: the lease table is what coordinates this process with its
        # peers, and the serial walk never touches it.
        if self.n_devices > 1 or self.config.exec_backend != "threads":
            if self._step is not self.prepared.step:
                # A swapped step is one callable with one prolog memo — it
                # cannot be shared across worker threads, and silently
                # ignoring it would drop the caller's math.
                raise ValueError(
                    "a custom step was supplied but the scan runs on the "
                    "multi-device executor (devices > 1 or a distributed "
                    "exec backend), which builds one step per device slot; "
                    "run with devices=1 on the threads backend to use a "
                    "swapped step"
                )
            return MultiDeviceExecutor(
                self.prepared,
                n_devices=self.n_devices,
                placement=self.config.placement,
                lease_batches=self.config.lease_batches,
                backend=self.config.exec_backend,
                backend_opts=self._backend_opts(),
                slot_prefetch=self.config.slot_prefetch,
                autotune_lease=self.config.autotune_lease,
            )
        return SerialExecutor(self.prepared, step=self._step)

    def events(self) -> Iterator[CellResult]:
        """Stream the grid: compute pending cells on the configured executor
        (serial or multi-device), commit + yield each as a ``CellResult``,
        then replay previously committed cells (resume).  Live cells arrive
        in the executor's completion order — grid order for the serial walk,
        whatever the fleet produces for multi-device; the sinks and writers
        normalize fold order, so consumers see identical results."""
        if self._consumed:
            raise RuntimeError("ScanSession.events() is one-shot; open a new session")
        self._consumed = True
        ckpt = self.checkpoint

        todo = self._batches
        pending: set[tuple[int, int]] | None = None   # (batch, block) cells
        if ckpt is not None and self.resume:
            # Fold in cells peer processes committed since the manifest was
            # opened (shared-fs hosts join an in-flight grid).
            ckpt.refresh()
            pending = set(ckpt.pending_cells())
            # A marker batch is re-staged iff ANY of its cells is pending;
            # completed cells of a re-staged batch are skipped by the
            # executor and replayed from their shards below.
            batches_pending = {b for b, _ in pending}
            todo = [b for b in self._batches if b.index in batches_pending]
        if self.mesh is not None:
            todo, pending = self._agree_on_grid(todo, pending)

        executor = self._make_executor()
        distributed = getattr(executor, "backend", "threads") != "threads"
        if ckpt is not None and distributed:
            # Shared-fs ordering contract: commit before the lease-done
            # marker (on the slot's tail), so peers that see "done" can
            # trust the manifest.  The consumer loop then must not commit
            # again.
            executor.commit = lambda cell: ckpt.commit_cell(
                cell.batch_index, cell.block_index, cell.payload()
            )
        computed: set[tuple[int, int]] = set()
        self.metrics.start()
        spans.follow_profiler()
        stream = executor.cells(todo, pending)
        try:
            for cell, timing in stream:
                if ckpt is not None and not distributed:
                    # Commit the shard, then the manifest — a crash between
                    # the two just re-does one grid cell.  Commit-before-
                    # yield makes the manifest the multi-device coordination
                    # substrate: double completion (work stealing) is an
                    # idempotent overwrite, and a resume under any device
                    # count skips exactly the committed cells.
                    with spans.span("deliver", batch=cell.batch_index, block=cell.block_index):
                        ckpt.commit_cell(cell.batch_index, cell.block_index, cell.payload())
                computed.add((cell.batch_index, cell.block_index))
                self.metrics.record(timing)
                if self.progress is not None:
                    self.progress(self.metrics)
                yield cell
                # A profiler started by a consumer of this cell turns the
                # program's spans on from the next cell to the scan's end.
                spans.follow_profiler()
        finally:
            stream.close()
            spans.follow_profiler(end=True)
            self.executor_info = executor.info()
            self.metrics.finish()

        # Resume path: replay committed-but-not-recomputed cells' shards.
        # Refresh first: under shared-fs the cells this process lost to its
        # peers were committed by them, and every host must still emit the
        # complete grid (that is what makes N hosts' outputs identical).
        if ckpt is not None:
            ckpt.refresh()
            # A windowed session replays only its own batches: cells other
            # sessions committed outside the window are not its grid.
            window_b = (
                {b.index for b in self._batches}
                if self.marker_window is not None else None
            )
            for bidx, kidx in sorted(ckpt.completed_cells() - computed):
                if window_b is not None and bidx not in window_b:
                    continue
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

    def _agree_on_grid(self, todo, pending):
        """Rank 0's cells to compute, on every rank of the mesh, before the
        walk: each rank must step through the same cells, in the same order,
        or their collectives would pair different cells.  If any rank's plan
        differs from the others' (its fingerprint), every rank refuses."""
        ranks = gather_objects(
            (self.prepared.fingerprint(), [b.index for b in todo], pending)
        )
        prints = [fp for fp, _, _ in ranks]
        if len(set(prints)) > 1:
            raise ValueError(
                f"the ranks' scan plans differ (fingerprints by rank: {prints}); "
                "every rank of a mesh runs the same plan"
            )
        _, todo_idx, pending = ranks[0]
        by_index = {b.index: b for b in self._batches}
        return [by_index[i] for i in todo_idx], pending

    def stream_to(self, *writers) -> dict:
        """Drive ``events()`` through result writers: open each, feed every
        cell, close in order; abort them all if anything raises.  Returns
        the merged summary dict of the writers' ``close()`` results.  Under
        a mesh every rank walks the grid but only rank 0 feeds its writers
        (the others return ``{}``)."""
        from repro_torch.api.writers import stream_session

        if not is_lead(self.mesh):
            writers = ()
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
