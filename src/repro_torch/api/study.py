"""``Study`` — the *bind* layer of the public API.

A Study owns everything that must be settled before any scan can be
planned: the genotype source, the phenotype/covariate tables aligned to
its samples, missing-phenotype imputation, and sample-level QC
(relatedness exclusion).  Binding is engine- and plan-agnostic: the same
Study can be planned many times with different engines, grids, or
thresholds without re-opening files or re-running QC.

    study = Study.from_files("cohort_chr*.bed", "panel.tsv", covar="covars.tsv")
    plan = study.plan(engine="fused", grid=GridSpec(trait_block=2048))
    session = plan.run()
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

__all__ = ["Study"]


@dataclass
class Study:
    """A bound (genotypes, phenotypes, covariates) triple, QC applied.

    ``phenotypes``/``covariates`` are already row-subset to the kept
    samples; ``keep`` maps kept rows back to the genotype source's sample
    axis (engines subset dosage batches with it).  ``trait_names`` ride
    along for the result writers.
    """

    source: Any                          # GenotypeSource protocol (repro_torch.io)
    phenotypes: np.ndarray               # (N_kept, P) float
    covariates: np.ndarray | None        # (N_kept, C) or None
    keep: np.ndarray                     # (N_source,) bool sample mask
    excluded_samples: int = 0
    exclude_related: bool = False        # QC flag (enters the fingerprint)
    trait_names: Sequence[str] = field(default_factory=tuple)

    # ------------------------------------------------------------------ bind

    @classmethod
    def from_arrays(
        cls,
        source: Any,
        phenotypes: np.ndarray,
        covariates: np.ndarray | None = None,
        *,
        exclude_related: bool = False,
        trait_names: Sequence[str] | None = None,
        device: str = "cuda",
    ) -> "Study":
        """Bind an already-aligned phenotype panel to a genotype source.

        ``phenotypes`` rows must match the source's sample order (use
        ``Study.from_files`` / ``repro_torch.io.align_tables`` otherwise).
        ``exclude_related=True`` runs the relatedness probe (KING kinship
        products on ``device``: the CUDA card unless ``"cpu"`` is asked for)
        and drops one sample of each related pair before anything
        downstream sees the panel.
        """
        n = source.n_samples
        phenotypes = np.asarray(phenotypes)
        if phenotypes.shape[0] != n:
            raise ValueError(
                f"phenotypes rows ({phenotypes.shape[0]}) != genotype samples ({n}); "
                "align tables first (repro_torch.io.align_tables)"
            )
        if covariates is not None:
            covariates = np.asarray(covariates)
            if covariates.shape[0] != n:
                raise ValueError(
                    f"covariates rows ({covariates.shape[0]}) != genotype samples ({n})"
                )

        keep = np.ones(n, bool)
        excluded = 0
        if exclude_related:
            from repro_torch.core.kinship import exclude_related as _exclude

            probe = source.read_dosages(0, min(source.n_markers, 4096)).T
            keep, _, _ = _exclude(probe, device=device)
            excluded = int((~keep).sum())
            phenotypes = phenotypes[keep]
            covariates = covariates[keep] if covariates is not None else None

        if trait_names is None:
            trait_names = tuple(f"trait{j}" for j in range(phenotypes.shape[1]))
        return cls(
            source=source,
            phenotypes=phenotypes,
            covariates=covariates,
            keep=keep,
            excluded_samples=excluded,
            exclude_related=exclude_related,
            trait_names=tuple(trait_names),
        )

    @classmethod
    def from_files(
        cls,
        genotypes: str,
        pheno: str,
        covar: str | None = None,
        *,
        exclude_related: bool = False,
        impute_missing: bool = True,
        device: str = "cuda",
    ) -> "Study":
        """Open a genotype container/fileset and align tables by sample id.

        Alignment is strict: genotype samples missing from the tables raise
        (subset the container first).  NaN phenotype cells are mean-imputed
        per trait when ``impute_missing`` (matching the CLI's historical
        behavior); pass False to keep NaNs and handle them upstream.
        ``device`` runs the relatedness probe (``exclude_related``).
        """
        from repro_torch.io import align_tables, open_genotypes, read_table

        source = open_genotypes(genotypes)
        ptable = read_table(pheno)
        ctable = read_table(covar) if covar else None
        y, c, keep = align_tables(source.sample_ids, ptable, ctable)
        if not keep.all():
            raise ValueError(
                f"{(~keep).sum()} genotype samples missing from the tables; "
                "subset the genotype container first (alignment is strict by design)"
            )
        if impute_missing:
            y = np.where(np.isnan(y), np.nanmean(y, axis=0, keepdims=True), y)
        return cls.from_arrays(
            source, y, c,
            exclude_related=exclude_related,
            trait_names=tuple(ptable.names),
            device=device,
        )

    # ---------------------------------------------------------------- shape

    @property
    def n_samples(self) -> int:
        return int(self.keep.sum())

    @property
    def n_traits(self) -> int:
        return int(self.phenotypes.shape[1])

    @property
    def n_markers(self) -> int:
        return int(self.source.n_markers)

    @property
    def marker_ids(self):
        return self.source.marker_ids

    # ----------------------------------------------------------------- plan

    def plan(
        self,
        *,
        engine: str = "dense",
        grid: "GridSpec | None" = None,
        lmm: "LmmSpec | None" = None,
        io: "IOSpec | None" = None,
        executor: "ExecSpec | None" = None,
        options: "AssocOptions | None" = None,
        mode: str = "mp",
        hit_threshold_nlp: float = 7.301,
        maf_min: float = 0.0,
        multivariate: bool = False,
        checkpoint_dir: str | None = None,
        input_dtype: str = "fp32",
        sparse_epilogue: bool = True,
        hit_capacity: int = 4096,
        mesh: Any = None,
        device: str = "cuda",
    ) -> "ScanPlan":
        """Validate + normalize a spec combination into a ``ScanPlan``.

        This is cheap (no engine setup, no file IO): the expensive amortized
        work — panel residualization and step construction — happens in
        ``plan.run()``.  ``device`` is where the scan runs: ``"cuda"`` (the
        default; an error when no card is present), ``"cuda:i"`` or
        ``"cpu"``.
        """
        from repro_torch.api.session import ScanPlan
        from repro_torch.api.specs import ScanConfig

        config = ScanConfig.from_specs(
            engine=engine,
            grid=grid,
            lmm=lmm,
            io=io,
            executor=executor,
            options=options,
            mode=mode,
            hit_threshold_nlp=hit_threshold_nlp,
            maf_min=maf_min,
            exclude_related=self.exclude_related,
            multivariate=multivariate,
            checkpoint_dir=checkpoint_dir,
            input_dtype=input_dtype,
            sparse_epilogue=sparse_epilogue,
            hit_capacity=hit_capacity,
            device=device,
        )
        return ScanPlan(self, config, mesh=mesh)

    def plan_config(self, config: "ScanConfig", *, mesh: Any = None) -> "ScanPlan":
        """Plan from an already-normalized ``ScanConfig`` (spec users
        should call ``plan``)."""
        from repro_torch.api.session import ScanPlan

        if bool(config.exclude_related) != bool(self.exclude_related):
            raise ValueError(
                "config.exclude_related disagrees with the Study's QC binding; "
                "relatedness exclusion is decided at Study construction"
            )
        return ScanPlan(self, config, mesh=mesh)
