"""The TorchGWAS association kernel (paper §2.2) in PyTorch.

The hot path is one GEMM per genotype batch:

    R = G_std @ Y_std / N          (Eq. 2)   G_std: (M, N), Y_std: (N, P)
    T = R * sqrt(dof / (1 - R^2))  (Eq. 3)
    p = two-sided t tail           (core.stats, log-space)

Precision ladder:
    "fp32"  — float32 inputs, full-fp32 products (TF32 off; see
              ``runtime.device.resolve_device``).  On the dense engine's
              kernel route (a card, packed staging, the paper's dof:
              ``engines.dense_product_route``) the product is ``gwas_dot``'s
              3xTF32 (three TF32 passes, hi and lo parts, with the
              accumulators restarted every 32 samples), held to r 2e-6 of
              the exact sum; never one TF32 pass
    "bf16"  — inputs rounded to bfloat16, products accumulated in float32
              (on the kernel route one bf16 pass, restarted every 256
              samples)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import stats as _stats
from repro_torch.kernels import tstat as _tstat

__all__ = [
    "AssocOptions",
    "MarkerStats",
    "AssocResult",
    "SparseEpilogue",
    "standardize_genotype_batch",
    "correlation",
    "assoc_from_standardized",
    "assoc_from_correlation",
    "assoc_batch",
    "plan_sparse_epilogue",
    "sparse_epilogue_outputs",
]


@dataclasses.dataclass(frozen=True)
class AssocOptions:
    """Options for the association engine.

    dof_mode: "paper" uses N-2 (Eq. 3 as published); "exact" uses N-2-q and
        implies genotype residualization (Frisch-Waugh-Lovell) so the result
        equals full covariate-adjusted OLS.
    precision: "fp32" | "bf16" (see module docstring: on the dense
        engine's kernel route fp32 is 3xTF32 held to r 2e-6, never one
        TF32 pass).
    eps: clamp for 1 - r^2.
    compute_neglog10p: skip the p-value epilogue when only |T| ranking is
        needed.
    sparse_epilogue: sparse p-value mode: skip the full (M, P) -log10 p
        tile — the caller screens on t^2 and refines only past-threshold
        lanes through ``sparse_epilogue_outputs``.
    """

    dof_mode: str = "paper"
    precision: str = "fp32"
    eps: float = 1e-12
    compute_neglog10p: bool = True
    sparse_epilogue: bool = False

    def __post_init__(self) -> None:
        if self.dof_mode not in ("paper", "exact"):
            raise ValueError(f"unknown dof_mode: {self.dof_mode!r}")
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"unknown precision: {self.precision!r}")

    def dof(self, n_samples: int, n_covariates: int) -> int:
        if self.dof_mode == "paper":
            return n_samples - 2
        return n_samples - 2 - n_covariates


class MarkerStats(NamedTuple):
    """Per-marker summary statistics from standardization."""

    mean: torch.Tensor       # (M,) dosage mean over non-missing samples
    inv_std: torch.Tensor    # (M,) 1/population-std of the imputed dosage; 0 if monomorphic
    maf: torch.Tensor        # (M,) minor-allele frequency
    n_missing: torch.Tensor  # (M,) int32
    valid: torch.Tensor      # (M,) bool — polymorphic and not all-missing


class AssocResult(NamedTuple):
    r: torch.Tensor            # (M, P) correlation
    t: torch.Tensor            # (M, P) t statistic
    neglog10p: torch.Tensor    # (M, P) two-sided -log10 p (zeros if disabled)


def standardize_genotype_batch(
    g_raw: torch.Tensor,
    *,
    missing_value: float = -9.0,
    var_tol: float = 1e-10,
    sample_sum: Callable[[torch.Tensor], torch.Tensor] | None = None,
    n_samples: int | None = None,
) -> tuple[torch.Tensor, MarkerStats]:
    """Standardize a dosage batch ``(M, N)``; missing entries are mean-imputed.

    ``missing_value`` marks missing dosages (NaN also works).  The imputed
    value is the per-marker mean, which becomes exactly 0 after
    standardization.  The variance is the population variance.

    ``sample_sum`` is for a batch whose samples are split across ranks (a
    mesh's ``sample`` mode): it turns each rank's per-marker partial sum over
    its samples into the total, and ``n_samples`` is the total sample count.
    Padding samples are missing entries, which add nothing to any sum.
    """
    g = g_raw.to(torch.float32)
    missing = torch.isnan(g) | (g == missing_value)
    present = ~missing
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    if sample_sum is None:
        n_present_raw = torch.sum(present, dim=1)
        n_present = torch.clamp(n_present_raw, min=1)
        mean = torch.sum(torch.where(present, g, zero), dim=1) / n_present
    else:
        n_present_raw = sample_sum(torch.sum(present, dim=1))
        n_present = torch.clamp(n_present_raw, min=1)
        mean = sample_sum(torch.sum(torch.where(present, g, zero), dim=1)) / n_present
    g_imp = torch.where(present, g, mean[:, None])
    dev = g_imp - mean[:, None]
    if sample_sum is None:
        var = torch.mean(dev * dev, dim=1)
    else:
        var = sample_sum(torch.sum(dev * dev, dim=1)) / float(n_samples)
    valid = (var > var_tol) & (n_present_raw > 0)
    inv_std = torch.where(valid, torch.rsqrt(torch.clamp(var, min=var_tol)), zero)
    g_std = dev * inv_std[:, None]
    af = mean / 2.0
    maf = torch.minimum(af, 1.0 - af)
    return g_std, MarkerStats(
        mean=mean,
        inv_std=inv_std,
        maf=maf,
        n_missing=torch.sum(missing, dim=1).to(torch.int32),
        valid=valid,
    )


def correlation(
    g_std: torch.Tensor,
    y_std: torch.Tensor,
    n_samples: int,
    *,
    precision: str = "fp32",
    trait_tile: int | None = None,
    sample_sum: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Paper Eq. (2): ``R = G Y / N`` with an explicit precision contract.

    ``trait_tile`` fixes the panel-axis compute tile: the GEMM is evaluated
    in ``trait_tile``-wide column chunks (last chunk ragged) instead of one
    panel-wide product.  GEMM libraries group accumulators differently per
    output width, so the only way two decompositions of the trait axis agree
    bitwise is to run the *same* fixed-width tiles in both.  Each chunk is
    made contiguous, so a chunk cut from a wide panel and the same columns
    staged as their own block reach the GEMM with one layout.
    """
    if precision == "bf16":
        # bf16 inputs, fp32 accumulation: products of bf16 values are exact
        # in fp32, so an fp32 product of the rounded inputs is that contract.
        g_std = g_std.to(torch.bfloat16).to(torch.float32)
        y_std = y_std.to(torch.bfloat16).to(torch.float32)
    p = y_std.shape[1]
    if trait_tile is not None and 0 < trait_tile < p:
        r = torch.cat(
            [g_std @ y_std[:, i : i + trait_tile].contiguous() for i in range(0, p, trait_tile)],
            dim=1,
        )
    else:
        r = g_std @ y_std
    if sample_sum is not None:
        # samples split across ranks: each product is a partial over this
        # rank's samples (``standardize_genotype_batch``)
        r = sample_sum(r)
    return r / float(n_samples)


def assoc_from_standardized(
    g_std: torch.Tensor,
    y_std: torch.Tensor,
    *,
    n_samples: int,
    n_covariates: int,
    options: AssocOptions = AssocOptions(),
    trait_tile: int | None = None,
    sample_sum: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> AssocResult:
    """Association statistics from pre-standardized inputs (both zero-mean,
    unit population variance); ``(M, N) x (N, P) -> (M, P)``.  ``sample_sum``
    adds the products over samples split across ranks (``correlation``)."""
    r = correlation(
        g_std, y_std, n_samples, precision=options.precision, trait_tile=trait_tile,
        sample_sum=sample_sum,
    )
    return assoc_from_correlation(r, n_samples=n_samples, n_covariates=n_covariates,
                                  options=options)


def assoc_from_correlation(
    r: torch.Tensor,
    *,
    n_samples: int,
    n_covariates: int,
    options: AssocOptions = AssocOptions(),
) -> AssocResult:
    """The epilogue of ``assoc_from_standardized``: t and -log10 p from the
    product ``r``."""
    # Standardization guarantees |r| <= 1 up to rounding; clamp so the
    # epilogue stays finite even for degenerate columns.
    r = torch.clamp(r, -1.0, 1.0)
    dof = options.dof(n_samples, n_covariates)
    t = _stats.t_from_r(r, dof, eps=options.eps)
    if options.compute_neglog10p and not options.sparse_epilogue:
        nlp = _stats.neglog10_p_from_t(t, dof)
    else:
        nlp = torch.zeros_like(t)
    return AssocResult(r=r, t=t, neglog10p=nlp)


def assoc_batch(
    g_raw: torch.Tensor,
    y_std: torch.Tensor,
    *,
    n_samples: int,
    n_covariates: int,
    options: AssocOptions = AssocOptions(),
    q_basis: torch.Tensor | None = None,
    missing_value: float = -9.0,
) -> tuple[AssocResult, MarkerStats]:
    """End-to-end batch path from raw dosages: standardize -> (optionally
    FWL-residualize) -> correlate -> epilogue, on the inputs' device.

    ``q_basis`` is required when ``options.dof_mode == "exact"``.
    """
    g_std, marker_stats = standardize_genotype_batch(g_raw, missing_value=missing_value)
    if options.dof_mode == "exact":
        if q_basis is None:
            raise ValueError("exact mode requires the covariate basis q_basis")
        from repro_torch.core.residualize import residualize_genotypes

        g_std = residualize_genotypes(g_std, q_basis)
    res = assoc_from_standardized(
        g_std,
        y_std,
        n_samples=n_samples,
        n_covariates=n_covariates,
        options=options,
    )
    # Invalid (monomorphic / all-missing) markers: r=t=0, p=1.
    mask = marker_stats.valid[:, None]
    zero = torch.zeros((), dtype=res.r.dtype, device=res.r.device)
    res = AssocResult(
        r=torch.where(mask, res.r, zero),
        t=torch.where(mask, res.t, zero),
        neglog10p=torch.where(mask, res.neglog10p, zero),
    )
    return res, marker_stats


# ----------------------------------------------------- sparse p-value epilogue
#
# For fixed dof, -log10 p is strictly monotone in t^2, so the epilogue only
# needs the exact tail on (a) the per-trait t^2 winner and (b) the lanes past
# a conservative t^2 screen — O(P + hits) evaluations instead of O(M*P).


@dataclasses.dataclass(frozen=True)
class SparseEpilogue:
    """Per-scan constants of the sparse p-value epilogue.

    ``t2_screen`` is the conservative inverse of the hit threshold
    (``stats.t2_screen_threshold``); ``capacity`` the fixed size of the
    compacted device buffer (past-capacity cells overflow to the host
    fallback in ``core.sinks.extract_hits``).
    """

    threshold_nlp: float
    t2_screen: float
    capacity: int


def plan_sparse_epilogue(
    threshold_nlp: float,
    dof: float,
    *,
    capacity: int = 4096,
    cell_area: int | None = None,
) -> SparseEpilogue | None:
    """Resolve the sparse-epilogue constants for one scan, or ``None`` when
    screening cannot help (threshold at/below the inversion margin, or a
    non-positive dof)."""
    t2 = _stats.t2_screen_threshold(float(threshold_nlp), float(dof))
    if t2 is None or not (t2 > 0.0):
        return None
    cap = int(capacity)
    if cell_area is not None:
        cap = min(cap, int(cell_area))
    # Round up to a multiple of the canonical refine chunk width so the
    # compacted buffer's slot layout chunks evenly.
    w = _stats.REFINE_WIDTH
    cap = max(w, -(-cap // w) * w)
    return SparseEpilogue(float(threshold_nlp), float(t2), cap)


def sparse_epilogue_outputs(
    r: torch.Tensor,
    t: torch.Tensor,
    dof: float,
    plan: SparseEpilogue,
    *,
    screen: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> dict[str, torch.Tensor]:
    """Screen one masked (M, P) statistic tile on t^2 and compact survivors.

    Inputs must be the *masked* r/t tiles (invalid lanes zeroed) so masked
    lanes never pass the screen.  No -log10 p is computed here: the exact
    refine happens host-side (``stats.refine_neglog10p``).  Returns:

        batch_best_row   (P,) int32 — argmax over t^2 (first index on ties)
        batch_best_t     (P,) f32 — winner t
        hit_idx          (capacity,) int32 — row-major flat indices of
                         screened lanes in ascending (first-K) order, -1 padded
        hit_r/hit_t      (capacity,) f32 — gathered stats; 0 in padding
        screen_count     () int32 — total screened lanes; > capacity means
                         the buffer overflowed (host fallback)

    ``screen`` optionally supplies ``(hit_idx, screen_count)`` from the fused
    screen kernel (``kernels.tstat.screen_compact``) in place of the
    compaction here (``kernels.tstat.compact_survivors``); the layout of the
    result is the same either way.
    """
    del dof  # the refine is host-side; kept for call-site symmetry
    t2 = t * t
    best_row = torch.argmax(t2, dim=0).to(torch.int32)
    best_t = torch.gather(t, 0, best_row[None, :].to(torch.int64))[0]
    if screen is None:
        # On a card the compaction is the screen kernel's t mode, one launch
        # with no wait for the host; torch.nonzero would wait for the count.
        if t.device.type == "cuda":
            idx, screen_count = _tstat.compact_survivors(t, plan.t2_screen, plan.capacity)
        else:
            idx, screen_count = _tstat.compact_survivors_plain(t, plan.t2_screen, plan.capacity)
    else:
        idx, screen_count = screen
    slot = idx >= 0
    safe = torch.clamp(idx, min=0).to(torch.int64)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return {
        "batch_best_row": best_row,
        "batch_best_t": best_t,
        "hit_idx": idx,
        "hit_r": torch.where(slot, r.reshape(-1)[safe], zero),
        "hit_t": torch.where(slot, t.reshape(-1)[safe], zero),
        "screen_count": screen_count,
    }
