"""Streamed genetic relationship matrix (GRM) accumulation, and its spectrum.

The mixed-model wing needs ``K = (1/M) sum_m z_m z_m^T`` over all (valid)
markers, where ``z_m`` is the standardized dosage vector of marker ``m``.
This reduces to one GEMM per marker batch, so the estimator rides the same
streaming discipline as the scan itself: batches come from
``runtime.prefetch.BatchPlanner`` (boundary-respecting for multi-file
sources), reads run on ``Prefetcher`` worker threads, each batch's block
product runs on the scan's device, and the (N, N) accumulator is the only
resident state — the genotype matrix never is.

Per-shard partial sums are kept separately (float64, on the host) so
leave-one-chromosome-out (LOCO) GRMs are a subtraction, not a second pass:

    K_full    = (sum_s S_s) / (sum_s c_s)
    K_loco(s) = (sum_{s' != s} S_s') / (sum_{s' != s} c_s')

Two estimators ship (``method``):

    "std"       GCTA-style: z standardized to unit variance; the
                normalizer is the valid-marker count (diag(K) ~ 1).
    "centered"  centered-only dosages normalized by ``sum_m 2 p_m (1-p_m)``
                (the EPACTS/EMMAX convention).

The block products are float32 ``torch.matmul`` with TF32 off (the
reference computes them at ``Precision.HIGHEST``).  ``grm_spectrum`` runs
the float64 eigendecomposition on the scan's device: at biobank N a host
``eigh`` is the slowest step of the whole scan.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.association import standardize_genotype_batch
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.prefetch import BatchPlanner, Prefetcher

__all__ = ["StreamedGRM", "stream_grm", "grm_spectrum", "spectrum_fingerprint"]

GRM_METHODS = ("std", "centered")


def _grm_block_std(g_raw: torch.Tensor, maf_min: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One marker block ``(M, N)`` -> ``(S, c)``: ``S = Z^T Z`` over rows
    that are valid and pass the MAF gate, ``c`` the rows folded in."""
    g_std, ms = standardize_genotype_batch(g_raw)
    keep = ms.valid & (ms.maf >= maf_min)
    g_std = g_std * keep[:, None].to(torch.float32)
    s = torch.matmul(g_std.T, g_std)
    return s, torch.sum(keep.to(torch.float32))


def _grm_block_centered(g_raw: torch.Tensor, maf_min: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Centered-only estimator: ``S = Gc^T Gc``, normalizer ``sum 2p(1-p)``."""
    _, ms = standardize_genotype_batch(g_raw)  # the imputation/mean path
    g = g_raw.to(torch.float32)
    missing = torch.isnan(g) | (g == -9.0)
    g_imp = torch.where(missing, ms.mean[:, None], g)
    keep = ms.valid & (ms.maf >= maf_min)
    gc = (g_imp - ms.mean[:, None]) * keep[:, None].to(torch.float32)
    s = torch.matmul(gc.T, gc)
    af = ms.mean / 2.0
    norm = torch.sum(torch.where(keep, 2.0 * af * (1.0 - af), torch.zeros_like(af)))
    return s, norm


@dataclass
class StreamedGRM:
    """Per-shard GRM partial sums + normalizers (see module docstring)."""

    shard_sums: np.ndarray     # (S, N, N) float64 unnormalized sums
    shard_norms: np.ndarray    # (S,) float64 per-shard normalizer
    n_samples: int
    method: str

    @property
    def n_shards(self) -> int:
        return self.shard_sums.shape[0]

    @staticmethod
    def _checked_norm(norm: float, what: str) -> float:
        if norm <= 1e-9:
            raise ValueError(
                f"{what} normalizer is ~0 — no markers survived the "
                "validity/MAF filters; loosen maf_min or check the input"
            )
        return norm

    def full(self) -> np.ndarray:
        """The all-markers GRM."""
        norm = self._checked_norm(float(self.shard_norms.sum()), "GRM")
        return self.shard_sums.sum(axis=0) / norm

    def loco(self, shard_id: int) -> np.ndarray:
        """Leave-one-chromosome-out GRM: everything but ``shard_id``."""
        if not 0 <= shard_id < self.n_shards:
            raise IndexError(f"shard {shard_id} outside [0, {self.n_shards})")
        if self.n_shards < 2:
            raise ValueError("LOCO needs >= 2 shards (per-chromosome fileset)")
        mask = np.ones(self.n_shards, bool)
        mask[shard_id] = False
        norm = self._checked_norm(
            float(self.shard_norms[mask].sum()), f"LOCO({shard_id}) GRM"
        )
        return self.shard_sums[mask].sum(axis=0) / norm


def stream_grm(
    source,
    *,
    keep: np.ndarray | None = None,
    batch_markers: int = 4096,
    method: str = "std",
    maf_min: float = 0.0,
    io_workers: int = 2,
    prefetch_depth: int = 3,
    staging: str = "auto",
    device: str | torch.device = "cuda",
) -> StreamedGRM:
    """Accumulate the GRM in one streamed pass over ``source``.

    ``keep`` subselects the sample axis (relatedness exclusion mask).
    Batches follow the plan the scan itself uses, so the partial sums land
    in per-shard slots for LOCO.  ``device`` runs each block product (the
    default is the CUDA card; ``"cpu"`` runs it on the host).

    ``staging`` selects the H2D currency like the scan's
    ``--genotype-staging``: under "packed" the worker threads fetch raw
    2-bit slabs through the shared packed-slab cache and the device decode
    expands them in front of the unchanged block product — bit-identical
    partial sums.  "auto" falls back to decoded dosages when the source has
    no native packed layout or ``keep`` drops samples.
    """
    if method not in GRM_METHODS:
        raise ValueError(f"unknown grm method {method!r}; expected one of {GRM_METHODS}")
    from repro_torch.core.engines import resolve_genotype_staging, to_device

    device = resolve_device(device)
    # keep=None or an all-true mask never subsets, so packed staging stays
    # eligible; an excluding mask forces the host-side decoded path.
    excluding = int(keep is not None and not bool(np.asarray(keep).all()))
    staging = resolve_genotype_staging(staging, source, excluded_samples=excluding)
    plan = BatchPlanner(batch_markers).plan(source)
    n_shards = max((b.source_id for b in plan), default=0) + 1
    n = int(keep.sum()) if keep is not None else source.n_samples

    sums = np.zeros((n_shards, n, n), np.float64)
    norms = np.zeros(n_shards, np.float64)

    if staging == "packed":
        from repro_torch.io.packed_cache import read_packed_cached
        from repro_torch.kernels.gwas_dot import ops as kops

        def read(batch):
            return batch, read_packed_cached(source, batch.lo, batch.hi)

        def on_device(slab):
            return kops.decode_packed_device(to_device(slab, device), n_samples=n)
    else:
        def read(batch):
            d = source.read_dosages(batch.lo, batch.hi)
            if keep is not None and not keep.all():
                d = d[:, keep]
            return batch, np.asarray(d, np.float32)

        def on_device(dosages):
            return to_device(dosages, device)

    block = _grm_block_centered if method == "centered" else _grm_block_std
    prefetched = Prefetcher(plan, read, depth=prefetch_depth, num_workers=io_workers)
    try:
        for batch, payload in prefetched:
            s, c = block(on_device(payload), float(maf_min))
            sums[batch.source_id] += s.cpu().numpy().astype(np.float64)
            norms[batch.source_id] += float(c)
    finally:
        prefetched.shutdown()
    return StreamedGRM(shard_sums=sums, shard_norms=norms, n_samples=n, method=method)


def grm_spectrum(
    k: np.ndarray, *, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition ``K = U diag(s) U^T`` in float64 on ``device``
    (``torch.linalg.eigh``), with tiny negative eigenvalues (float roundoff
    on a PSD-by-construction matrix) clipped to zero.  Returned as numpy
    arrays in ascending eigenvalue order (numpy's convention).

    Eigenvector signs (and the basis of a repeated eigenvalue) may differ
    from numpy's; the scan is unaffected, since its rotation multiplies both
    the genotypes and the panel by ``U``."""
    device = resolve_device(device)
    kt = torch.as_tensor(np.asarray(k, np.float64)).to(device)
    s, u = torch.linalg.eigh(kt)
    s = torch.clamp(s, min=0.0)
    return s.cpu().numpy(), u.cpu().numpy()


def spectrum_fingerprint(spectra: dict[int, np.ndarray]) -> str:
    """Stable short hash of the GRM eigenvalue spectra (one per LOCO scope).

    Goes into the scan checkpoint fingerprint: resuming a mixed-model scan
    against a *different* GRM (new markers, new exclusion mask) would
    silently mix incompatible statistics.  Eigenvalues are rounded to 6
    significant decimals so the hash is stable across solver jitter.
    """
    h = hashlib.sha256()
    for scope in sorted(spectra):
        h.update(str(scope).encode())
        vals = np.asarray(spectra[scope], np.float64)
        scale = np.power(10.0, 5 - np.floor(np.log10(np.maximum(vals, 1e-30))))
        rounded = np.where(vals > 1e-12, np.rint(vals * scale) / scale, 0.0)
        h.update(rounded.astype(np.float64).tobytes())
    return h.hexdigest()[:16]
