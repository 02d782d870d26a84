"""Float64 OLS association of every marker with every trait (paper Eqs. 1-3).

    Y_res = (I - Q Q^T) Y,  Q an orthonormal basis of [1 | C]
    y     = Y_res / sd(Y_res)                      (population sd)
    g     = (G - mean) / sd(G)                     missing at the mean
    r     = g y / N,  t = r sqrt(dof / (1 - r^2)),  dof = N - 2
    nlp   = -log10(2 F_t(-|t|; dof))

Runs on any torch device in float64, a block of markers at a time.
"""
from __future__ import annotations

import numpy as np
import scipy.special
import torch

_DOSAGE_OF_CODE = (2.0, float("nan"), 1.0, 0.0)  # PLINK 1: hom A1, missing, het, hom A2


def decode_bed(bed_path: str, lo: int, hi: int, n_samples: int,
               device: torch.device) -> torch.Tensor:
    """File markers ``[lo, hi)`` of a SNP-major ``.bed`` as ``(hi-lo, N)``
    float64 dosages, NaN where missing."""
    bpm = (n_samples + 3) // 4
    raw = np.fromfile(bed_path, dtype=np.uint8, count=(hi - lo) * bpm, offset=3 + lo * bpm)
    b = torch.from_numpy(raw.reshape(hi - lo, bpm)).to(device).to(torch.int64)
    codes = torch.stack([(b >> (2 * k)) & 3 for k in range(4)], 2).reshape(hi - lo, -1)
    lut = torch.tensor(_DOSAGE_OF_CODE, dtype=torch.float64, device=device)
    return lut[codes[:, :n_samples]]


def neglog10p(t: np.ndarray, dof: float) -> np.ndarray:
    """Two-sided -log10 p of Student's t with ``dof`` degrees of freedom."""
    t = np.abs(np.asarray(t, np.float64))
    return -np.log10(2.0 * scipy.special.stdtr(dof, -t))


def t2_for_nlp(nlp: float, dof: float) -> float:
    """The t^2 at which ``neglog10p`` reaches ``nlp`` (bisection)."""
    lo, hi = 0.0, 1.0
    while neglog10p(np.array([hi]), dof)[0] < nlp:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if neglog10p(np.array([mid]), dof)[0] < nlp:
            lo = mid
        else:
            hi = mid
    return lo * lo


class PanelReference:
    """The residualized, standardized panel in float64, and per marker block
    the statistics of every (marker, trait) lane."""

    def __init__(self, phenotypes: np.ndarray, covariates: np.ndarray | None, *,
                 device: torch.device, dof_mode: str = "paper", var_tol: float = 1e-10):
        if dof_mode != "paper":
            raise ValueError(f"the reference computes dof_mode 'paper', not {dof_mode!r}")
        self.device = device
        self.var_tol = var_tol
        y = torch.from_numpy(np.asarray(phenotypes)).to(device).to(torch.float64)
        n = y.shape[0]
        basis = [torch.ones((n, 1), dtype=torch.float64, device=device)]
        if covariates is not None:
            basis.append(torch.from_numpy(np.asarray(covariates)).to(device).to(torch.float64))
        q, _ = torch.linalg.qr(torch.cat(basis, 1))
        y -= q @ (q.T @ y)
        sd = y.pow(2).mean(0).sqrt()
        self.trait_valid = sd.pow(2) > var_tol
        y *= torch.where(self.trait_valid, 1.0 / sd, torch.zeros_like(sd))[None, :]
        self.y = y
        self.n = n
        self.dof = float(n - 2)
        self._omnibus = None

    def omnibus_nlp(self, r: torch.Tensor, eig_floor: float = 1e-6) -> np.ndarray:
        """The panel omnibus of a block's r rows: ``S = N r C^-1 r^T`` over
        the trait correlation ``C = y^T y / N`` (eigenvalues below
        ``eig_floor`` of the largest dropped), against chi^2 with Li and Ji's
        effective number of traits, as -log10 p."""
        if self._omnibus is None:
            lam, vec = torch.linalg.eigh(self.y.T @ self.y / self.n)
            keep = lam > eig_floor * lam.max()
            lam_c = lam.clamp(min=0)
            m_eff = float(((lam_c >= 1).to(lam.dtype) + lam_c - lam_c.floor()).sum())
            self._omnibus = (vec[:, keep], lam[keep], m_eff)
        vec, lam, m_eff = self._omnibus
        s = self.n * ((r @ vec) ** 2 / lam).sum(1)
        return -np.log10(scipy.special.chdtrc(m_eff, s.cpu().numpy()))

    def block(self, bed_path: str, lo: int, hi: int) -> dict:
        """Statistics of file markers ``[lo, hi)``: ``maf`` and ``valid``
        (host arrays), ``r`` and ``t`` (``(hi-lo, P)`` device tensors, zero on
        invalid markers)."""
        g = decode_bed(bed_path, lo, hi, self.n, self.device)
        present = ~torch.isnan(g)
        n_present = present.sum(1)
        mean = torch.where(present, g, 0.0).sum(1) / n_present.clamp(min=1)
        g = torch.where(present, g, mean[:, None]) - mean[:, None]
        var = g.pow(2).mean(1)
        valid = (var > self.var_tol) & (n_present > 0)
        g *= torch.where(valid, 1.0 / var.clamp(min=self.var_tol).sqrt(), 0.0)[:, None]
        r = (g @ self.y) / self.n
        t = r * torch.sqrt(self.dof / (1.0 - r * r))
        af = (mean / 2).cpu().numpy()
        return {
            "maf": np.minimum(af, 1.0 - af),
            "valid": valid.cpu().numpy(),
            "r": r,
            "t": t,
        }
