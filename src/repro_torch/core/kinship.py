"""Relatedness-aware sample exclusion (paper §4: "the current implementation
already includes relatedness-aware sample exclusion during preprocessing").

KING-robust kinship (Manichaikul et al. 2010):

    phi_ij = (N_AaAa(i,j) - 2 * N_opp(i,j)) / (N_Aa(i) + N_Aa(j))

where ``N_AaAa`` counts markers at which both samples are heterozygous,
``N_opp`` counts opposite homozygotes, and ``N_Aa(i)`` is sample i's
heterozygote count.  All three reduce to indicator GEMMs:

    H = [g == 1],  A = [g == 2],  B = [g == 0]          (indicators, N x M)
    N_AaAa = H H^T,   N_opp = A B^T + B A^T             (two GEMMs)

The products are float32 ``torch.matmul`` on the caller's device; they are
integer counts below 2^24, so they are exact.  Pruning is the greedy
maximum-independent-set heuristic on the relatedness graph (drop the
highest-degree sample until no edge remains) — a small host-side graph
problem.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime.device import resolve_device

__all__ = ["king_kinship", "greedy_unrelated", "exclude_related"]

# KING kinship thresholds: 2^(-d/2 - 1.5) for degree d boundaries.
DEGREE2_THRESHOLD = 0.0884  # exclude pairs closer than 3rd degree


def _king_accumulate(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over a genotype block ``(N, M)`` with codes {0,1,2, missing<0}.

    Returns (N_AaAa, N_opp, het_counts).  Missing markers contribute to no
    indicator.
    """
    het = (g == 1).to(torch.float32)
    hom_alt = (g == 2).to(torch.float32)
    hom_ref = (g == 0).to(torch.float32)
    n_hh = het @ het.T
    n_opp = hom_alt @ hom_ref.T
    n_opp = n_opp + n_opp.T
    return n_hh, n_opp, torch.sum(het, dim=1)


def king_kinship(
    genotypes: np.ndarray, *, block_markers: int = 8192, device: str | torch.device = "cuda"
) -> np.ndarray:
    """KING-robust kinship matrix ``(N, N)`` from integer dosages ``(N, M)``.

    Streams marker blocks through ``device`` so the full genotype matrix
    never needs to be resident there.  Missing dosage is any value outside
    {0, 1, 2}.
    """
    device = resolve_device(device)
    g = np.asarray(genotypes)
    n, m = g.shape
    n_hh = np.zeros((n, n), np.float64)
    n_opp = np.zeros((n, n), np.float64)
    het_counts = np.zeros((n,), np.float64)
    for lo in range(0, m, block_markers):
        block = torch.as_tensor(np.asarray(g[:, lo : lo + block_markers], np.int32)).to(device)
        hh, opp, het = _king_accumulate(block)
        n_hh += hh.cpu().numpy().astype(np.float64)
        n_opp += opp.cpu().numpy().astype(np.float64)
        het_counts += het.cpu().numpy().astype(np.float64)
    denom = het_counts[:, None] + het_counts[None, :]
    denom = np.maximum(denom, 1.0)
    phi = (n_hh - 2.0 * n_opp) / denom
    np.fill_diagonal(phi, 0.5)
    return phi


def greedy_unrelated(phi: np.ndarray, *, threshold: float = DEGREE2_THRESHOLD) -> np.ndarray:
    """Greedy max-independent-set on the relatedness graph.

    Returns a boolean keep-mask over samples.  Deterministic: ties broken by
    lower index.
    """
    phi = np.asarray(phi)
    n = phi.shape[0]
    adj = (phi > threshold).astype(np.int64)
    np.fill_diagonal(adj, 0)
    keep = np.ones(n, dtype=bool)
    degree = adj.sum(axis=1)
    while True:
        active_deg = np.where(keep, degree, -1)
        worst = int(np.argmax(active_deg))
        if active_deg[worst] <= 0:
            break
        keep[worst] = False
        degree -= adj[worst]
        degree[worst] = 0
    return keep


def exclude_related(
    genotypes: np.ndarray,
    sample_ids: list[str] | None = None,
    *,
    threshold: float = DEGREE2_THRESHOLD,
    block_markers: int = 8192,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, list[str] | None, np.ndarray]:
    """Preprocessing entry point: estimate kinship, prune related samples.

    Returns ``(keep_mask, kept_ids, phi)``.
    """
    phi = king_kinship(genotypes, block_markers=block_markers, device=device)
    keep = greedy_unrelated(phi, threshold=threshold)
    kept_ids = [s for s, k in zip(sample_ids, keep) if k] if sample_ids is not None else None
    return keep, kept_ids, phi
