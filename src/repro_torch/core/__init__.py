"""The association engine in PyTorch.

Public surface:
    AssocOptions, assoc_batch, assoc_from_standardized  — the kernel (Eq. 2-3)
    covariate_basis, residualize_and_standardize        — Eq. 1
    stats                                               — t/p epilogue, chi^2 tail,
                                                          BH, lambda_GC
    multivariate                                        — panel-level screens
    engines                                             — the dense, fused and lmm steps
    grm, lmm                                            — mixed-model wing (streamed GRM,
                                                          REML + one-time rotation)
    kinship                                             — relatedness exclusion
    screening                                           — the GenomeScan shim
"""
from repro_torch.core import multivariate, stats
from repro_torch.core.association import (
    AssocOptions,
    AssocResult,
    MarkerStats,
    assoc_batch,
    assoc_from_standardized,
    correlation,
    standardize_genotype_batch,
)
from repro_torch.core.residualize import (
    StandardizedPanel,
    covariate_basis,
    residualize_and_standardize,
    residualize_genotypes,
)

__all__ = [
    "AssocOptions",
    "AssocResult",
    "MarkerStats",
    "assoc_batch",
    "assoc_from_standardized",
    "correlation",
    "standardize_genotype_batch",
    "StandardizedPanel",
    "covariate_basis",
    "residualize_and_standardize",
    "residualize_genotypes",
    "multivariate",
    "stats",
]
