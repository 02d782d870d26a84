"""Multivariate phenotype screening (paper abstract: "linear GWAS and
multivariate phenotype screening"), in PyTorch.

Given the per-batch correlation tile ``R (M, P)`` the engine already
produces, three panel-level screens are provided, all elementwise/reduction
ops over the tile (no extra GEMMs in the scan beyond ``r @ W``):

* ``omnibus_chi2``   — ``S_m = N * sum_p r_mp^2``.  If the phenotype panel has
  been *whitened* (decorrelated once, amortized across the scan — the same
  trick the paper uses for residualization), ``S_m ~ chi^2_P`` under the null.
* ``max_abs_t``      — strongest single-trait signal per marker, with a
  Sidak/effective-tests adjusted p-value.
* ``effective_tests``— Li & Ji (2005) eigenvalue-based effective number of
  independent traits, used to calibrate ``max_abs_t``.

The whitening ``W`` is not unique: an eigenvector's sign, and the basis of a
near-degenerate eigenspace, depend on the eigensolver.  ``W W^T`` over the
kept directions is unique, and so is every statistic computed here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import stats as _stats
from repro_torch.runtime.device import resolve_device

__all__ = [
    "whiten_panel",
    "omnibus_chi2",
    "max_abs_t",
    "effective_tests",
    "screen",
    "MultivariateScreen",
]


class MultivariateScreen(NamedTuple):
    omnibus: torch.Tensor        # (M,) chi^2_P statistic
    omnibus_nlp: torch.Tensor    # (M,) -log10 p
    max_t: torch.Tensor          # (M,) max_p |t|
    max_t_nlp: torch.Tensor      # (M,) effective-tests-adjusted -log10 p


def whiten_panel(
    y_std, *, eig_floor: float = 1e-6, device: str | torch.device | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whitening matrix for a standardized panel: ``W = V diag(lam^-1/2)``
    so that ``Y W`` has identity trait correlation.

    One ``P x P`` float32 eigendecomposition on ``device`` (default: the
    panel's own device), amortized across the whole genome scan.
    Eigenvalues below ``eig_floor * max`` are dropped (their directions carry
    no independent signal).  Returns ``(W, eigenvalues)``, eigenvalues in
    descending order; the scan keeps per-trait statistics on the *original*
    panel and applies ``W`` to the correlation tile only (``r @ W``), which
    is algebraically identical to correlating against the whitened panel.
    """
    y = torch.as_tensor(y_std, dtype=torch.float32)
    if device is not None:
        y = y.to(resolve_device(device))
    n = y.shape[0]
    corr = (y.T @ y) / float(n)
    lam, vec = torch.linalg.eigh(corr)
    lam = torch.flip(lam, (0,))
    vec = torch.flip(vec, (1,))
    keep = lam > eig_floor * lam[0]
    scale = torch.where(keep, torch.rsqrt(torch.clamp(lam, min=eig_floor)),
                        torch.zeros((), dtype=lam.dtype, device=lam.device))
    return vec * scale[None, :], lam


def omnibus_chi2(
    r_tile: torch.Tensor,
    n_samples: int,
    n_traits_eff: float,
    whitening: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Panel omnibus: ``S = N * sum_p r_w^2 ~ chi^2_{P_eff}`` where
    ``r_w = r @ W`` decorrelates the traits (pass ``whitening=None`` only if
    the panel was already whitened).  ``r @ W`` is a float32 product; the
    caller keeps TF32 off, as PyTorch does by default."""
    if whitening is not None:
        r_tile = r_tile @ whitening
    n = torch.tensor(float(n_samples), dtype=torch.float32, device=r_tile.device)
    s = n * torch.sum(r_tile * r_tile, dim=-1)
    return s, _stats.neglog10_sf_chi2(s, n_traits_eff)


def max_abs_t(
    t_tile: torch.Tensor, dof: float, n_traits_eff: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Strongest per-marker hit with Sidak correction by the effective test
    count: ``p_adj = 1 - (1 - p_min)^Meff``; in -log10 space use the stable
    ``p_adj ~ Meff * p_min`` for small p (the only regime anyone screens)."""
    tmax = torch.amax(torch.abs(t_tile), dim=-1)
    nlp = _stats.neglog10_p_from_t(tmax, dof)
    log_meff = torch.log10(torch.tensor(float(n_traits_eff), dtype=torch.float32,
                                        device=nlp.device))
    return tmax, torch.clamp(nlp - log_meff, min=0.0)


def effective_tests(eigenvalues) -> torch.Tensor:
    """Li & Ji (2005): ``Meff = sum_i I(lam_i >= 1) + (lam_i - floor(lam_i))``
    over eigenvalues of the trait correlation matrix.

    The sum jumps by 1 wherever an eigenvalue crosses an integer >= 2, so two
    eigensolvers whose eigenvalues differ in the last float32 bits can give
    counts that differ by 1 there."""
    lam = torch.clamp(torch.as_tensor(eigenvalues, dtype=torch.float32), min=0.0)
    return torch.sum((lam >= 1.0).to(torch.float32) + (lam - torch.floor(lam)))


def screen(
    r_tile: torch.Tensor,
    t_tile: torch.Tensor,
    *,
    n_samples: int,
    dof: float,
    n_traits_eff: float,
) -> MultivariateScreen:
    omni, omni_nlp = omnibus_chi2(r_tile, n_samples, n_traits_eff)
    tmax, tmax_nlp = max_abs_t(t_tile, dof, n_traits_eff)
    return MultivariateScreen(omnibus=omni, omnibus_nlp=omni_nlp, max_t=tmax, max_t_nlp=tmax_nlp)
