"""The association engine in PyTorch.

Public surface:
    AssocOptions, assoc_from_standardized, correlation  — the kernel (Eq. 2-3)
    covariate_basis, residualize_and_standardize        — Eq. 1
    stats                                               — t/p epilogue, lambda_GC
    engines                                             — the dense, fused and lmm steps
    grm, lmm                                            — mixed-model wing (streamed GRM,
                                                          REML + one-time rotation)
    kinship                                             — relatedness exclusion
"""
from repro_torch.core.association import (
    AssocOptions,
    AssocResult,
    MarkerStats,
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
    "assoc_from_standardized",
    "correlation",
    "standardize_genotype_batch",
    "StandardizedPanel",
    "covariate_basis",
    "residualize_and_standardize",
    "residualize_genotypes",
]
