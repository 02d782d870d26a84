"""Covariate handling: orthonormal basis construction and panel residualization.

Implements paper Eq. (1):  ``Y_res = (I - Q Q^T)(Y - Ybar)`` with ``Q`` an
orthonormal basis spanning the covariate space, followed by column-wise
standardization to unit (population) variance.

* ``Q`` always includes the intercept column, so mean-centering and
  residualization are a single projection.  ``Q`` comes from a reduced QR of
  the ``[1 | C]`` matrix with rank detection (collinear covariates are
  dropped).
* Standardization uses the population variance (``ddof=0``, not
  ``torch.var``'s default) so that the downstream ``R = G Y / N`` is
  *exactly* the Pearson correlation of the residualized data.
* ``exact`` mode residualizes the genotype batch with the same ``Q``
  (Frisch-Waugh-Lovell), making the t statistic identical to the full
  per-trait OLS with covariates.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = [
    "covariate_basis",
    "residualize_and_standardize",
    "residualize_genotypes",
    "StandardizedPanel",
]


class StandardizedPanel(NamedTuple):
    """Residualized + standardized phenotype panel ready for the scan."""

    y: torch.Tensor       # (N, P) float32, zero mean, unit population variance
    valid: torch.Tensor   # (P,) bool — False where the residual variance was ~0
    n_samples: int
    n_covariates: int     # columns of Q *excluding* the intercept


def covariate_basis(
    covariates,
    n_samples: int,
    *,
    rank_tol: float = 1e-5,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Orthonormal basis ``Q (N, q+1)`` of ``span([1 | C])`` on ``device``.

    Covariates are centered and scaled to unit variance first (the span is
    unchanged once the intercept is present, and the QR diagonal becomes a
    meaningful relative rank signal in float32).  Rank-deficient (collinear)
    columns are zeroed out of the basis: zero columns in Q are harmless in
    the projection ``Q Q^T``.
    """
    ones = torch.ones((n_samples, 1), dtype=torch.float32, device=device)
    if covariates is None:
        mat = ones
    else:
        cov = torch.as_tensor(np.asarray(covariates) if not isinstance(covariates, torch.Tensor)
                              else covariates, dtype=torch.float32).to(device)
        if cov.dim() == 1:
            cov = cov[:, None]
        cov = cov - torch.mean(cov, dim=0, keepdim=True)
        std = torch.sqrt(torch.mean(cov * cov, dim=0, keepdim=True))
        cov = cov / torch.clamp(std, min=1e-12)
        mat = torch.cat([ones, cov], dim=1)
    q, r = torch.linalg.qr(mat, mode="reduced")
    diag = torch.abs(torch.diagonal(r))
    keep = diag > rank_tol * torch.max(diag)
    return q * keep[None, :].to(q.dtype)


def _project_out(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``(I - Q Q^T) x`` without materializing the N x N projector."""
    return x - q @ (q.T @ x)


def residualize_and_standardize(
    y: torch.Tensor,
    q: torch.Tensor,
    *,
    var_tol: float = 1e-10,
) -> StandardizedPanel:
    """Paper Eq. (1) + column standardization.

    Returns the standardized panel and a validity mask for phenotypes whose
    residual variance collapsed (constant columns, or columns exactly in the
    covariate span).  Invalid columns are zeroed so they contribute r = 0.
    """
    y = y.to(torch.float32)
    n = y.shape[0]
    y_res = _project_out(y, q)
    # Population variance of the residuals (mean-zero by construction
    # because Q contains the intercept).
    var = torch.mean(y_res * y_res, dim=0)
    valid = var > var_tol
    inv_std = torch.where(valid, torch.rsqrt(torch.clamp(var, min=var_tol)),
                          torch.zeros_like(var))
    return StandardizedPanel(
        y=y_res * inv_std[None, :],
        valid=valid,
        n_samples=n,
        n_covariates=int(q.shape[1]) - 1,
    )


def residualize_genotypes(g_std: torch.Tensor, q: torch.Tensor, *,
                          var_tol: float = 1e-10,
                          sample_sum: Callable[[torch.Tensor], torch.Tensor] | None = None,
                          n_samples: int | None = None) -> torch.Tensor:
    """FWL 'exact' mode: project covariates out of a standardized genotype
    batch ``(M, N)`` and re-standardize rows.  With ``sample_sum`` (samples
    split across ranks; ``q`` holds this rank's rows) the products ``g q``
    and the row variances are sums across ranks over ``n_samples``."""
    g = g_std.to(torch.float32)
    if sample_sum is None:
        g_res = g - (g @ q) @ q.T
        var = torch.mean(g_res * g_res, dim=1)
    else:
        g_res = g - sample_sum(g @ q) @ q.T
        var = sample_sum(torch.sum(g_res * g_res, dim=1)) / float(n_samples)
    valid = var > var_tol
    inv_std = torch.where(valid, torch.rsqrt(torch.clamp(var, min=var_tol)),
                          torch.zeros_like(var))
    return g_res * inv_std[:, None]
