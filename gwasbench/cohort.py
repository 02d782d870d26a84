"""The seeded cohort, made on the device from ``--seed`` alone.

Genotypes: per marker a MAF uniform on ``maf_range``, dosages Binomial(2,
MAF) by inverse CDF on one uniform per entry, ``missing_rate`` of the entries
missing; written as PLINK 2-bit codes to one ``.bed`` fileset.  Phenotypes:
standard normal noise, covariate effects ``C L`` (``L`` normal with scale
``covariate_effect``) and ``n_planted`` (marker, trait) effects of size
uniform on ``planted_effect`` with a random sign, on the standardized
dosage of the marker as observed (missing entries at the marker mean).
Covariates: standard normal.  This is the idea of the port's
``io/synth.make_cohort`` rewritten in torch, in a few large calls on the
card.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

BED_MAGIC = b"\x6c\x1b\x01"
# PLINK 1 codes: hom A1 (dosage 2), missing, het (1), hom A2 (0)
CODE_HOM_A1, CODE_MISSING, CODE_HET, CODE_HOM_A2 = 0, 1, 2, 3
_CHUNK = 8192  # markers drawn per call


@dataclass
class Cohort:
    bed_path: str
    phenotypes: np.ndarray   # (N, P) float32
    covariates: np.ndarray   # (N, C) float32


def make_cohort(traffic: dict, *, n_samples: int, n_covariates: int, n_markers: int,
                seed: int, device: torch.device, out_dir: str) -> Cohort:
    """Draw the cohort on ``device`` and write ``<out_dir>/cohort.bed``."""
    n, p, m = int(n_samples), int(traffic["n_traits"]), int(n_markers)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    lo, hi = traffic["maf_range"]
    miss = float(traffic["missing_rate"])
    k = int(traffic["n_planted"])
    maf = torch.empty(m, device=device).uniform_(float(lo), float(hi), generator=gen)
    causal = torch.randperm(m, device=device, generator=gen)[:k]
    traits = torch.randint(0, p, (k,), device=device, generator=gen)
    elo, ehi = traffic["planted_effect"]
    sign = torch.randint(0, 2, (k,), device=device, generator=gen).to(torch.float32) * 2 - 1
    beta = torch.empty(k, device=device).uniform_(float(elo), float(ehi), generator=gen) * sign

    packed = torch.empty((m, (n + 3) // 4), dtype=torch.uint8, device=device)
    g_causal = torch.empty((k, n), dtype=torch.float32, device=device)
    for c0 in range(0, m, _CHUNK):
        c1 = min(c0 + _CHUNK, m)
        u = torch.rand((c1 - c0, n), device=device, generator=gen)
        f = maf[c0:c1, None]
        missing = u < miss
        v = (u - miss) / (1.0 - miss)
        dosage = (v < f * f).to(torch.uint8) + (v < 1.0 - (1.0 - f) * (1.0 - f)).to(torch.uint8)
        code = torch.full_like(dosage, CODE_HOM_A2)
        code[dosage == 2] = CODE_HOM_A1
        code[dosage == 1] = CODE_HET
        code[missing] = CODE_MISSING
        packed[c0:c1] = pack_codes(code)
        sel = ((causal >= c0) & (causal < c1)).nonzero()[:, 0]
        if sel.numel():
            g = dosage[causal[sel] - c0].to(torch.float32)
            present = ~missing[causal[sel] - c0]
            mean = (g * present).sum(1, keepdim=True) / present.sum(1, keepdim=True).clamp(min=1)
            g = torch.where(present, g, mean) - mean
            g_causal[sel] = g / g.pow(2).mean(1, keepdim=True).sqrt().clamp(min=1e-6)

    cov = torch.randn((n, n_covariates), device=device, generator=gen)
    load = torch.randn((n_covariates, p), device=device, generator=gen) * float(
        traffic["covariate_effect"])
    y = torch.randn((n, p), device=device, generator=gen)
    y.addmm_(cov, load)
    y.index_add_(1, traits, g_causal.T * beta[None, :])

    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.join(out_dir, "cohort")
    with open(stem + ".bed", "wb") as fh:
        fh.write(BED_MAGIC)
        fh.write(packed.cpu().numpy().tobytes())
    with open(stem + ".bim", "w") as fh:
        fh.writelines(f"1\trs{i:08d}\t0\t{i + 1}\tA\tG\n" for i in range(m))
    with open(stem + ".fam", "w") as fh:
        fh.writelines(f"S{i:06d} S{i:06d} 0 0 0 -9\n" for i in range(n))
    return Cohort(stem + ".bed", y.cpu().numpy(), cov.cpu().numpy())


def pack_codes(code: torch.Tensor) -> torch.Tensor:
    """``(M, N)`` 2-bit codes -> ``(M, ceil(N/4))`` PLINK bytes, sample ``i``
    at bits ``2 (i % 4)`` of byte ``i // 4``; padding samples are hom A2."""
    m, n = code.shape
    pad = (-n) % 4
    if pad:
        code = torch.cat([code, torch.full((m, pad), CODE_HOM_A2, dtype=code.dtype,
                                           device=code.device)], 1)
    c = code.view(m, -1, 4)
    return c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
