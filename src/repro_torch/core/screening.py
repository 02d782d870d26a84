"""Deprecated blocking facade over the layered public API
(``repro_torch.api``), kept for callers of the historical ``GenomeScan``.

The scan itself lives behind the bind -> plan -> execute -> emit layers:

    bind     ``repro_torch.api.Study``        source opening, alignment, sample QC
    plan     ``Study.plan``                   typed specs -> normalized ScanConfig
    execute  ``repro_torch.api.ScanSession``  the streaming grid executor
    emit     ``repro_torch.api.writers``      streaming sorted-TSV / npz shards

``GenomeScan``/``ScanResult`` are *shims*: a ``GenomeScan`` binds a Study,
prepares a plan, and ``run()`` folds the session's ``CellResult`` event
stream through the sinks into a dense ``ScanResult``.  The sinks, steps,
planners and checkpoint format are the very objects the session uses; only
the loop lives here.  New code should prefer the API: it streams instead of
materializing, and its writers keep host memory bounded per grid cell.

The scan runs where ``config.device`` says: ``"cuda"`` by default, ``"cpu"``
when asked.  ``GenomeScan(mesh=)`` passes a sharding mesh to the plan
(``ScanPlan(mesh=)``): every rank constructs and runs the shim; rank 0's
``ScanResult`` is the scan's (the other ranks replay no checkpoint).
``PanelStore`` lives in ``core.panels`` and ``ScanConfig`` in
``api.specs``; both are re-exported here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.api.session import ScanSession
from repro_torch.api.specs import ScanConfig
from repro_torch.api.study import Study
from repro_torch.core.engines import (
    build_dense_step,
    build_fused_step,
    build_lmm_step,
)
from repro_torch.core.panels import PanelStore
from repro_torch.core.sinks import (
    BestTraitSink,
    HitSink,
    LambdaGCSink,
    QCSink,
    ResultSink,
)
from repro_torch.runtime.checkpoint import ScanCheckpoint

__all__ = [
    "ScanConfig",
    "ScanResult",
    "GenomeScan",
    "PanelStore",
    "build_dense_step",
    "build_fused_step",
    "build_lmm_step",
]


@dataclass
class ScanResult:
    """Dense end-of-scan summary (deprecated collection shape).

    Materializes the full hit table plus per-trait/per-marker tracks on the
    host at scan end.  Prefer streaming ``ScanSession.events()`` through
    result writers for paper-scale panels.
    """

    n_markers: int
    n_samples: int
    n_traits: int
    dof: int
    best_nlp: np.ndarray       # (P,) per-trait best -log10 p
    best_marker: np.ndarray    # (P,) global marker index of the best hit
    hits: np.ndarray           # (H, 2) int32 (marker, trait) above threshold
    hit_stats: np.ndarray      # (H, 3) float32 (r, t, nlp)
    maf: np.ndarray            # (M,)
    valid: np.ndarray          # (M,) bool
    lambda_gc: float           # genomic control on a null-trait subsample
    omnibus_nlp: np.ndarray | None = None   # (M,) multivariate screen
    excluded_samples: int = 0
    lmm_info: dict | None = None  # mixed-model diagnostics (delta, h2, ...)


class GenomeScan:
    """Deprecated: orchestrates one full scan and collects a ``ScanResult``.

    Equivalent API session:

        study = Study.from_arrays(source, phenotypes, covariates,
                                  exclude_related=cfg.exclude_related)
        session = study.plan_config(cfg, mesh=mesh).run()
        for cell in session.events(): ...

    The shim keeps the historical surface (constructor-time validation and
    engine setup, ``run(resume=...)``, the ``_make_sinks`` extension hook, a
    swappable ``_step``) on top of the session executor.
    """

    def __init__(
        self,
        source: Any,                     # GenotypeSource protocol (repro_torch.io)
        phenotypes: np.ndarray,          # (N, P) aligned to source samples
        covariates: np.ndarray | None = None,
        *,
        config: ScanConfig = ScanConfig(),
        mesh: Any = None,
    ):
        self.source = source
        self.config = config
        self.mesh = mesh
        self.study = Study.from_arrays(
            source, phenotypes, covariates,
            exclude_related=config.exclude_related,
            device=config.device,
        )
        # Prepare eagerly: the constructor validates the (engine, config)
        # combination and runs the amortized engine setup (GRM/REML for
        # lmm), and callers rely on both.
        self._plan = self.study.plan_config(config, mesh=mesh)
        prep = self._plan.prepare()
        self._prepared = prep
        self._step = prep.step           # swappable (tests do)

    # ------------------------------------------------------ mirrored state

    @property
    def excluded_samples(self) -> int:
        return self.study.excluded_samples

    @property
    def n_samples(self) -> int:
        return self.study.n_samples

    @property
    def n_traits(self) -> int:
        return self.study.n_traits

    @property
    def n_covariates(self) -> int:
        return self._prepared.n_covariates

    @property
    def engine(self):
        return self._prepared.engine

    @property
    def trait_blocks(self):
        return self._prepared.trait_blocks

    @property
    def panels(self) -> PanelStore | None:
        return self._prepared.panels

    @property
    def dof(self) -> int:
        return self._prepared.dof

    @property
    def lmm_info(self) -> dict | None:
        return self._prepared.lmm_info

    @property
    def plan(self):
        """The marker-batch decomposition (historical name)."""
        return self._prepared.batches

    @property
    def n_batches(self) -> int:
        return self._prepared.n_batches

    @property
    def n_trait_blocks(self) -> int:
        return self._prepared.n_trait_blocks

    # ------------------------------------------------------------------- run

    def _make_sinks(self, ckpt: ScanCheckpoint | None) -> list[ResultSink]:
        """The ScanResult accumulation chain.  The session commits
        checkpoint cells itself, so no CheckpointSink rides here; the
        ``ckpt`` argument stays for subclasses."""
        return [
            BestTraitSink(self.n_traits),
            HitSink(
                self.config.hit_threshold_nlp,
                spill_dir=self.config.spill_dir,
                spill_rows=self.config.hit_spill_rows,
            ),
            QCSink(self.source.n_markers, multivariate=self.config.multivariate),
            LambdaGCSink(),
        ]

    def run(self, *, resume: bool = True) -> ScanResult:
        session = ScanSession(self._prepared, resume=resume, step=self._step)
        sinks = self._make_sinks(session.checkpoint)
        events = session.events()
        try:
            # Live cells flow through ``on_batch`` with ONE payload dict
            # shared across the chain (so subclass sinks composing through
            # ``_make_sinks`` can share a payload), replayed cells through
            # ``merge_shard``.  The session commits checkpoint cells from
            # ``CellResult.payload()``: custom payload keys persist only if a
            # ``CheckpointSink`` is appended after the contributing sinks.
            for cell in events:
                if cell.view is not None:
                    payload: dict[str, np.ndarray] = {}
                    for sink in sinks:
                        sink.on_batch(cell.view, payload)
                else:
                    shard = cell.payload()
                    for sink in sinks:
                        sink.merge_shard(shard, cell.lo, cell.hi)
        finally:
            # Error path included: a raising sink must not leave decode
            # workers alive or the in-flight staged copy pinned — closing
            # the generator runs the session's teardown.
            events.close()

        fields: dict[str, Any] = {}
        for sink in sinks:
            fields.update(sink.result())
        return ScanResult(
            n_markers=self.source.n_markers,
            n_samples=self.n_samples,
            n_traits=self.n_traits,
            dof=self.dof,
            excluded_samples=self.excluded_samples,
            lmm_info=self.lmm_info,
            **fields,
        )
