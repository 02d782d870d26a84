"""Linear mixed model reduction to the panel-correlation epilogue.

Model (per trait):  ``y = X b + g beta + u + e``,  ``u ~ N(0, sg^2 K)``,
``e ~ N(0, se^2 I)``.  With the GRM spectrum ``K = U diag(s) U^T`` and
``delta = se^2 / sg^2``, rotating everything by ``U^T`` diagonalizes the
covariance:  ``Cov(U^T y) = sg^2 diag(s + delta)``.  Scaling rows by
``w^(1/2)``, ``w_i = 1/(s_i + delta)``, then whitens it — after which the
GLS score test for ``beta`` is *exactly* the partial-correlation epilogue
the OLS scan already runs (Eq. 2-3 with ``dof = N - 2 - q``):

    A    = U diag(sqrt(w))                    one-time (N, N) rotation
    Yhat = A^T Y,   Xhat = A^T [1 | C]        amortized once per panel
    Qhat = orth(Xhat)                         whitened covariate basis
    ghat = g_std A  ->  project out Qhat  ->  unit-RMS rows
    r    = ghat Yres / N,  t = r sqrt(dof / (1 - r^2))

This is the same amortize-once trick as residualization/whitening
(Fabregat-Traver & Aulchenko; Peise et al.): the per-marker cost is one
extra (M, N) x (N, N) GEMM, and every downstream stage — epilogue, sinks,
checkpointing — is untouched.

This module is numpy and scipy only, a copy of ``repro.core.lmm`` kept
numerically identical: on the same ``(s, u)`` both packages give the same
bits.  It runs on the host, between the port's device GRM pass and
eigendecomposition (``core.grm``) and the device scan.

Variance components come from a FaST-LMM-style REML profile over ``delta``
on the rotated null model: for fixed ``delta`` the GLS fit is closed-form
(diagonal weights), so the 1-D profile is a vectorized grid over all traits
at once plus an optional per-trait Brent refine.  One *pooled* ``delta``
(geometric mean over traits) drives the scan rotation so the genotype GEMM
stays shared across the panel; per-trait ``h2`` estimates are reported as
diagnostics.  Exactness therefore holds per trait when traits share their
variance ratio; heterogeneous panels get a calibrated approximation (the
standard panel-LMM trade, see DESIGN.md §9).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "REMLResult",
    "RotatedPanel",
    "reml_grid",
    "fit_variance_components",
    "rotate_panel",
    "whiten_project_standardize",
    "default_delta_grid",
]

_RANK_TOL = 1e-8


def _reduced_design(covariates: np.ndarray | None, n: int) -> np.ndarray:
    """Full-rank design ``[1 | C]`` (float64): collinear covariate columns
    are dropped via pivoted QR so every scope sees the same column set.

    Rank detection runs on *centered, unit-scaled* columns (mirroring
    ``covariate_basis``): otherwise a legitimately independent covariate on
    a tiny absolute scale would fall under a relative threshold set by the
    intercept's norm and be dropped silently.  The returned design keeps
    the original (unscaled) columns — scaling is for detection only.
    """
    from scipy.linalg import qr as _qr

    ones = np.ones((n, 1))
    if covariates is None:
        return ones
    c = np.asarray(covariates, np.float64)
    if c.ndim == 1:
        c = c[:, None]
    x = np.concatenate([ones, c], axis=1)
    c_scaled = c - c.mean(axis=0, keepdims=True)
    c_scaled /= np.maximum(c_scaled.std(axis=0, keepdims=True), 1e-12)
    probe = np.concatenate([ones, c_scaled], axis=1)
    _, r, piv = _qr(probe, mode="economic", pivoting=True)
    diag = np.abs(np.diagonal(r))
    rank = int(np.sum(diag > diag[0] * 1e-6))
    keep = np.sort(piv[:rank])
    return x[:, keep]


def default_delta_grid(n_points: int = 64) -> np.ndarray:
    """Log-spaced ``delta`` grid covering h2 from ~0.999 to ~0.001."""
    return np.logspace(-3.0, 3.0, n_points)


def reml_grid(
    y_rot: np.ndarray,
    x_rot: np.ndarray,
    s: np.ndarray,
    deltas: np.ndarray,
) -> np.ndarray:
    """Restricted log-likelihood profile ``(len(deltas), P)``.

    All traits are evaluated together per grid point: the weighted normal
    matrix ``X^T W X`` and its Cholesky are shared across the panel, so one
    grid point costs O(N k^2 + N k P) regardless of P.
    """
    y = np.asarray(y_rot, np.float64)
    x = np.asarray(x_rot, np.float64)
    s = np.asarray(s, np.float64)
    n, p = y.shape
    k = x.shape[1]
    nk = n - k
    ll = np.empty((len(deltas), p))
    for i, d in enumerate(np.asarray(deltas, np.float64)):
        w = 1.0 / (s + d)
        xw = x * w[:, None]
        xtx = x.T @ xw
        _, logdet_xtx = np.linalg.slogdet(xtx)
        beta = np.linalg.solve(xtx, xw.T @ y)
        resid = y - x @ beta
        rss = np.einsum("np,n,np->p", resid, w, resid)
        rss = np.maximum(rss, 1e-300)
        ll[i] = -0.5 * (
            nk * (np.log(2.0 * np.pi * rss / nk) + 1.0)
            + np.sum(np.log(s + d))
            + logdet_xtx
        )
    return ll


@dataclass
class REMLResult:
    delta: np.ndarray          # (P,) per-trait REML variance ratio se^2/sg^2
    h2: np.ndarray             # (P,) narrow-sense heritability 1/(1+delta)
    sigma_g2: np.ndarray       # (P,) genetic variance at the optimum
    loglik: np.ndarray         # (P,) restricted log-likelihood at the optimum
    delta_pooled: float        # geometric mean of per-trait deltas


def fit_variance_components(
    y_rot: np.ndarray,
    x_rot: np.ndarray,
    s: np.ndarray,
    *,
    deltas: np.ndarray | None = None,
    refine: bool = True,
) -> REMLResult:
    """Per-trait REML over ``delta`` (grid + optional bounded Brent refine),
    all on the rotated null model.  ``s`` is the GRM spectrum."""
    from scipy.optimize import minimize_scalar

    grid = default_delta_grid() if deltas is None else np.asarray(deltas, np.float64)
    y = np.asarray(y_rot, np.float64)
    x = np.asarray(x_rot, np.float64)
    ll = reml_grid(y, x, s, grid)
    best = np.argmax(ll, axis=0)
    p = y.shape[1]
    delta = grid[best].astype(np.float64)
    loglik = ll[best, np.arange(p)]
    if refine:
        log_grid = np.log(grid)
        for t in range(p):
            b = int(best[t])
            lo = log_grid[max(b - 1, 0)]
            hi = log_grid[min(b + 1, len(grid) - 1)]
            if hi - lo < 1e-12:
                continue
            yt = y[:, t : t + 1]
            res = minimize_scalar(
                lambda ld, yt=yt: -reml_grid(yt, x, s, np.exp([ld]))[0, 0],
                bounds=(lo, hi),
                method="bounded",
                options={"xatol": 1e-4},
            )
            if -res.fun > loglik[t]:
                delta[t] = float(np.exp(res.x))
                loglik[t] = -res.fun
    # sigma_g^2 at the optimum (per trait, GLS closed form)
    n, k = x.shape
    sigma_g2 = np.empty(p)
    for t in range(p):
        w = 1.0 / (s + delta[t])
        xw = x * w[:, None]
        beta = np.linalg.solve(x.T @ xw, xw.T @ y[:, t])
        resid = y[:, t] - x @ beta
        sigma_g2[t] = float(np.sum(w * resid * resid) / (n - k))
    return REMLResult(
        delta=delta,
        h2=1.0 / (1.0 + delta),
        sigma_g2=sigma_g2,
        loglik=loglik,
        delta_pooled=float(np.exp(np.mean(np.log(np.clip(delta, 1e-6, 1e6))))),
    )


@dataclass
class RotatedPanel:
    """Everything the scan needs for one LMM scope (global or one LOCO
    chromosome), amortized once.

    The whitened panel ``y`` lives host-side in float32; the blocked scan
    (DESIGN.md §10) ships ``y_block`` slices to the device on demand, so
    device residency is bounded by the trait-block width, not the panel.
    The float64 whitening itself runs panel-wide at setup: the global REML
    fit materializes the rotated panel anyway, and BLAS float64 GEMMs are
    not column-partition-invariant, so re-deriving blocks independently
    would break the blocked == unblocked bitwise contract.
    """

    rotation: np.ndarray       # (N, N) float32  A = U diag(sqrt(w))
    qhat: np.ndarray           # (N, k) float32 orthonormal whitened design basis
    y: np.ndarray              # (N, P) float32 projected, unit-RMS panel
    trait_valid: np.ndarray    # (P,) bool — residual variance survived
    n_covariates: int          # k - 1 (intercept excluded, matching ScanConfig)
    dof: int                   # N - 2 - n_covariates
    delta: float               # pooled variance ratio driving the rotation
    reml: REMLResult | None    # per-trait fits (None when delta was pinned)

    def y_block(self, lo: int, hi: int) -> np.ndarray:
        """The whitened panel restricted to one trait block ``[lo, hi)`` —
        what a grid cell's device step consumes."""
        return self.y[:, lo:hi]


def whiten_project_standardize(
    y_rot: np.ndarray,
    w_sqrt: np.ndarray,
    qhat: np.ndarray,
    *,
    var_tol: float = 1e-10,
) -> tuple[np.ndarray, np.ndarray]:
    """The whitening stage of the rotation, on an already-rotated panel (or
    a trait block of one): scale rows by ``w^(1/2)``, project the whitened
    design basis out, rescale columns to unit RMS.  Returns ``(y_std,
    trait_valid)``.  The scaling and standardization are column-wise; the
    projection is one small GEMM against ``qhat``."""
    y_hat = y_rot * w_sqrt[:, None]
    y_res = y_hat - qhat @ (qhat.T @ y_hat)
    var = np.mean(np.square(y_res), axis=0)
    trait_valid = var > var_tol
    inv = np.where(trait_valid, 1.0 / np.sqrt(np.maximum(var, var_tol)), 0.0)
    return y_res * inv[None, :], trait_valid


def _orthonormal_basis(mat: np.ndarray, *, rank_tol: float = 1e-7) -> np.ndarray:
    """Orthonormal basis of span(mat) with rank detection; zero columns for
    dropped directions (harmless in the projector, mirrors covariate_basis)."""
    m = np.asarray(mat, np.float64)
    norms = np.maximum(np.linalg.norm(m, axis=0), 1e-30)
    q, r = np.linalg.qr(m / norms)
    diag = np.abs(np.diagonal(r))
    keep = diag > rank_tol * max(float(diag.max()), 1e-30)
    return q * keep[None, :]


def rotate_panel(
    phenotypes: np.ndarray,
    covariates: np.ndarray | None,
    s: np.ndarray,
    u: np.ndarray,
    *,
    delta: float | None = None,
    reml_deltas: np.ndarray | None = None,
    refine: bool = True,
    var_tol: float = 1e-10,
) -> RotatedPanel:
    """One-time panel preparation for an LMM scope.

    Rotates phenotypes and the ``[1 | C]`` design into the GRM eigenbasis,
    fits (or accepts) the variance ratio, whitens by ``diag(sqrt(w))``,
    projects the whitened design out of the panel, and rescales columns to
    unit RMS — leaving ``Y`` in exactly the shape the correlation epilogue
    expects.  ``delta`` pins the variance ratio (skips REML).
    """
    y = np.asarray(phenotypes, np.float64)
    n, p = y.shape
    if u.shape != (n, n):
        raise ValueError(f"eigenvector matrix {u.shape} != ({n}, {n})")
    x = _reduced_design(covariates, n)
    k = x.shape[1]

    y_rot = u.T @ y
    x_rot = u.T @ x

    reml: REMLResult | None = None
    if delta is None:
        reml = fit_variance_components(
            y_rot, x_rot, s, deltas=reml_deltas, refine=refine
        )
        delta_used = reml.delta_pooled
    else:
        delta_used = float(delta)

    w_sqrt = 1.0 / np.sqrt(np.asarray(s, np.float64) + delta_used)
    rotation = u * w_sqrt[None, :]            # A = U diag(sqrt(w)); ghat = g_std @ A
    x_hat = x_rot * w_sqrt[:, None]
    qhat = _orthonormal_basis(x_hat)
    y_std, trait_valid = whiten_project_standardize(
        y_rot, w_sqrt, qhat, var_tol=var_tol
    )

    return RotatedPanel(
        rotation=rotation.astype(np.float32),
        qhat=qhat.astype(np.float32),
        y=y_std.astype(np.float32),
        trait_valid=trait_valid,
        n_covariates=k - 1,
        dof=n - 1 - k,
        delta=delta_used,
        reml=reml,
    )
