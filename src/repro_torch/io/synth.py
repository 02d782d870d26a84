"""Synthetic cohort generation: the test/benchmark substrate.

Everything the paper's benchmark needs, scaled down or up:
  * genotypes with a realistic MAF spectrum (beta-shaped), missingness,
    optional related pairs (for the kinship/exclusion tests),
  * a covariate matrix (age/sex/PC-like columns),
  * a quantitative phenotype panel with *planted* marker effects so power
    and calibration are checkable, plus pure-null columns for lambda_GC.

Returned effects are ground truth for tests: every planted (marker, trait,
beta) triple should surface in the scan's top hits.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "SyntheticCohort",
    "make_cohort",
    "make_structured_cohort",
    "write_cohort_files",
    "write_split_plink",
]


@dataclass
class SyntheticCohort:
    dosages: np.ndarray             # (M, N) int8, -9 missing
    covariates: np.ndarray          # (N, q) float32
    phenotypes: np.ndarray          # (N, P) float32
    sample_ids: list[str]
    marker_ids: list[str]
    maf: np.ndarray                 # (M,)
    effects: list[tuple[int, int, float]]  # (marker, trait, beta)
    related_pairs: list[tuple[int, int]] = field(default_factory=list)
    populations: np.ndarray | None = None  # (N,) int subpopulation labels
    h2: float | None = None                # planted polygenic heritability

    @property
    def shape(self) -> tuple[int, int, int]:
        m, n = self.dosages.shape
        return m, n, self.phenotypes.shape[1]


def make_cohort(
    *,
    n_samples: int = 512,
    n_markers: int = 256,
    n_traits: int = 8,
    n_covariates: int = 3,
    n_causal: int = 6,
    effect_size: float = 0.5,
    missing_rate: float = 0.01,
    n_related_pairs: int = 0,
    maf_range: tuple[float, float] = (0.05, 0.5),
    seed: int = 0,
) -> SyntheticCohort:
    rng = np.random.default_rng(seed)
    maf = rng.uniform(*maf_range, size=n_markers).astype(np.float32)
    dosages = rng.binomial(2, maf[:, None], size=(n_markers, n_samples)).astype(np.int8)

    # Related pairs: copy a sample's genome with per-marker "mendelian" noise,
    # overwriting the tail of the cohort (kinship ~ 0.35-0.45, i.e. 1st degree).
    related_pairs: list[tuple[int, int]] = []
    for k in range(n_related_pairs):
        src = k
        dst = n_samples - 1 - k
        if dst <= src:
            break
        copy = dosages[:, src].copy()
        flip = rng.random(n_markers) < 0.12
        copy[flip] = rng.binomial(2, maf[flip]).astype(np.int8)
        dosages[:, dst] = copy
        related_pairs.append((src, dst))

    covariates = rng.normal(size=(n_samples, n_covariates)).astype(np.float32)

    g_float = dosages.astype(np.float32)
    g_std = (g_float - g_float.mean(axis=1, keepdims=True))
    g_std /= np.maximum(g_std.std(axis=1, keepdims=True), 1e-6)

    phenotypes = rng.normal(size=(n_samples, n_traits)).astype(np.float32)
    cov_load = rng.normal(scale=0.5, size=(n_covariates, n_traits)).astype(np.float32)
    phenotypes += covariates @ cov_load

    effects: list[tuple[int, int, float]] = []
    causal_markers = rng.choice(n_markers, size=min(n_causal, n_markers), replace=False)
    for i, m in enumerate(causal_markers):
        trait = int(i % n_traits)
        beta = float(effect_size * (1.0 if i % 2 == 0 else -1.0))
        phenotypes[:, trait] += beta * g_std[m]
        effects.append((int(m), trait, beta))

    if missing_rate > 0:
        miss = rng.random(dosages.shape) < missing_rate
        dosages[miss] = -9

    return SyntheticCohort(
        dosages=dosages,
        covariates=covariates,
        phenotypes=phenotypes,
        sample_ids=[f"S{i:06d}" for i in range(n_samples)],
        marker_ids=[f"rs{i:08d}" for i in range(n_markers)],
        maf=maf,
        effects=effects,
        related_pairs=related_pairs,
    )


def make_structured_cohort(
    *,
    n_samples: int = 160,
    n_markers: int = 120,
    n_traits: int = 4,
    n_covariates: int = 2,
    n_pops: int = 2,
    fst: float = 0.1,
    h2: float = 0.4,
    n_causal: int = 3,
    effect_size: float = 0.5,
    maf_range: tuple[float, float] = (0.1, 0.5),
    seed: int = 0,
) -> SyntheticCohort:
    """A cohort with *population structure* and a *polygenic background* —
    the confounded workload the mixed model exists for.

    Genotypes follow the Balding-Nichols model: each marker has an
    ancestral frequency, and each of ``n_pops`` subpopulations draws its
    own frequency from ``Beta`` with divergence ``fst``.  Phenotypes carry
    a polygenic term ``Z a`` built from ALL markers (variance ``h2``) plus
    ``N(0, 1 - h2)`` noise, so the genotype-derived GRM is the true trait
    covariance — an OLS scan inflates (lambda_GC >> 1) while the LMM scan
    calibrates.  Planted fixed effects ride on top for power checks.

    No missingness by design: the oracle tests compare against exact GLS,
    and imputation semantics would blur the comparison.
    """
    rng = np.random.default_rng(seed)
    p_anc = rng.uniform(*maf_range, size=n_markers)
    a = p_anc * (1.0 - fst) / fst
    b = (1.0 - p_anc) * (1.0 - fst) / fst
    p_pop = rng.beta(a[None, :], b[None, :], size=(n_pops, n_markers))
    p_pop = np.clip(p_pop, 0.01, 0.99)
    pops = rng.integers(0, n_pops, size=n_samples)
    dosages = rng.binomial(2, p_pop[pops].T).astype(np.int8)  # (M, N)

    g_float = dosages.astype(np.float64)
    g_std = g_float - g_float.mean(axis=1, keepdims=True)
    g_std /= np.maximum(g_float.std(axis=1), 1e-9)[:, None]

    covariates = rng.normal(size=(n_samples, n_covariates)).astype(np.float32)
    # Polygenic background: u = Z^T a with Var(u_i) ~ h2 across samples.
    poly = g_std.T @ rng.normal(scale=np.sqrt(h2 / n_markers), size=(n_markers, n_traits))
    noise = rng.normal(scale=np.sqrt(max(1.0 - h2, 1e-6)), size=(n_samples, n_traits))
    cov_load = rng.normal(scale=0.3, size=(n_covariates, n_traits))
    phenotypes = (poly + noise + covariates.astype(np.float64) @ cov_load).astype(np.float32)

    effects: list[tuple[int, int, float]] = []
    causal = rng.choice(n_markers, size=min(n_causal, n_markers), replace=False)
    for i, m in enumerate(causal):
        trait = int(i % n_traits)
        beta = float(effect_size * (1.0 if i % 2 == 0 else -1.0))
        phenotypes[:, trait] += (beta * g_std[m]).astype(np.float32)
        effects.append((int(m), trait, beta))

    af = g_float.mean(axis=1) / 2.0
    return SyntheticCohort(
        dosages=dosages,
        covariates=covariates,
        phenotypes=phenotypes,
        sample_ids=[f"S{i:06d}" for i in range(n_samples)],
        marker_ids=[f"rs{i:08d}" for i in range(n_markers)],
        maf=np.minimum(af, 1.0 - af).astype(np.float32),
        effects=effects,
        populations=pops,
        h2=h2,
    )


def write_cohort_files(cohort: SyntheticCohort, stem: str) -> dict[str, str]:
    """Materialize a cohort as on-disk PLINK + BGEN + tables (for IO tests
    and the quickstart example).  Returns the path map."""
    from repro_torch.io.bgen import write_bgen
    from repro_torch.io.plink import write_plink

    paths: dict[str, str] = {}
    paths["bed"] = write_plink(stem, cohort.dosages, sample_ids=cohort.sample_ids)
    paths["bgen"] = write_bgen(
        stem + ".bgen",
        cohort.dosages,
        sample_ids=cohort.sample_ids,
        rsids=cohort.marker_ids,
    )
    pheno_path = stem + ".pheno.tsv"
    with open(pheno_path, "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"trait{j}" for j in range(cohort.phenotypes.shape[1])) + "\n")
        for i, sid in enumerate(cohort.sample_ids):
            vals = "\t".join(f"{v:.6g}" for v in cohort.phenotypes[i])
            f.write(f"{sid}\t{sid}\t{vals}\n")
    paths["pheno"] = pheno_path
    cov_path = stem + ".cov.tsv"
    with open(cov_path, "w") as f:
        f.write("FID\tIID\t" + "\t".join(f"cov{j}" for j in range(cohort.covariates.shape[1])) + "\n")
        for i, sid in enumerate(cohort.sample_ids):
            vals = "\t".join(f"{v:.6g}" for v in cohort.covariates[i])
            f.write(f"{sid}\t{sid}\t{vals}\n")
    paths["cov"] = cov_path
    return paths


def write_split_plink(
    cohort: SyntheticCohort, stem: str, n_shards: int = 3
) -> list[str]:
    """Write the cohort as a per-chromosome PLINK fileset
    (``<stem>_chr1.bed`` .. ``<stem>_chr<n>.bed``) — the multi-file layout
    real cohorts ship in.  Shard sizes are deliberately uneven so tests
    exercise batch planning against ragged boundaries; returns bed paths
    in chromosome order."""
    from repro_torch.io.plink import Marker, write_plink

    m = cohort.dosages.shape[0]
    if not 1 <= n_shards <= m:
        raise ValueError(f"cannot split {m} markers into {n_shards} shards")
    # Ragged but deterministic: proportions 1x, 2x, 1x, 2x, ... with every
    # shard guaranteed >= 1 marker (an empty .bed is unreadable).
    weights = np.array([1 + (i % 2) for i in range(n_shards)], np.float64)
    extra = m - n_shards
    alloc = np.floor(extra * weights / weights.sum()).astype(int)
    alloc[: extra - alloc.sum()] += 1
    bounds = np.concatenate([[0], np.cumsum(1 + alloc)])
    paths: list[str] = []
    for sid, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        markers = [
            Marker(str(sid + 1), cohort.marker_ids[i], 0.0, i - a + 1, "A", "G")
            for i in range(a, b)
        ]
        paths.append(
            write_plink(
                f"{stem}_chr{sid + 1}",
                cohort.dosages[a:b],
                sample_ids=cohort.sample_ids,
                markers=markers,
            )
        )
    return paths
