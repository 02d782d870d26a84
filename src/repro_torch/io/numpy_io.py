"""NumPy genotype backend: ``.npy``/``.npz`` dosage matrices.

This is the entry point the paper highlights for representation-learning
workflows where dosages were already extracted upstream.  Accepts

    .npy  — (M, N) int8/float dosage matrix (markers x samples), -9/NaN missing
    .npz  — keys: ``dosages`` (required), ``sample_ids``, ``marker_ids``

Memory-mapped where possible so genome-scale matrices stream.
"""
from __future__ import annotations

import numpy as np

__all__ = ["NumpyGenotypes"]


class NumpyGenotypes:
    # ``read_packed`` re-packs decoded hardcalls on host (and raises on true
    # dosages), so packed *staging* would cost more than it saves — staging
    # negotiation (DESIGN.md §17) keeps numpy sources on the decoded path.
    supports_packed = False

    def __init__(self, path: str):
        self.path = path
        if path.endswith(".npz"):
            archive = np.load(path, allow_pickle=False)
            self._data = archive["dosages"]
            sample_ids = archive.get("sample_ids")
            marker_ids = archive.get("marker_ids")
        else:
            self._data = np.load(path, mmap_mode="r", allow_pickle=False)
            sample_ids = marker_ids = None
        if self._data.ndim != 2:
            raise ValueError(f"{path}: expected (markers, samples) matrix")
        self.n_markers, self.n_samples = self._data.shape
        self.sample_ids = (
            [str(s) for s in sample_ids]
            if sample_ids is not None
            else [f"S{i:06d}" for i in range(self.n_samples)]
        )
        self.marker_ids = (
            [str(s) for s in marker_ids]
            if marker_ids is not None
            else [f"rs{i:08d}" for i in range(self.n_markers)]
        )

    def read_dosages(self, lo: int, hi: int) -> np.ndarray:
        return np.asarray(self._data[lo:hi])

    def read_packed(self, lo: int, hi: int):
        from repro_torch.io.plink import pack_dosages

        block = np.asarray(self._data[lo:hi])
        if not np.issubdtype(block.dtype, np.integer):
            rounded = np.where(np.isnan(block), -9, np.rint(block)).astype(np.int8)
            if not np.isin(rounded, (-9, 0, 1, 2)).all():
                raise ValueError("non-hardcall dosages have no 2-bit packing")
            block = rounded
        return pack_dosages(block)
