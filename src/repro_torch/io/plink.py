"""PLINK 1 binary (.bed/.bim/.fam) reader and writer.

Format (SNP-major .bed, the only variant PLINK 1.9 writes):

    bytes 0-2: magic 0x6C 0x1B 0x01
    per marker: ceil(N/4) bytes; sample i lives in byte i//4 at bit
    offset 2*(i%4) (LSB first).  2-bit codes:

        0b00  hom A1      -> dosage 2   (A1 allele count)
        0b01  missing     -> -9
        0b10  het         -> dosage 1
        0b11  hom A2      -> dosage 0

The reader is a zero-copy ``np.memmap`` over the marker-major slab so a
genome-scale file (8.9M x 23k ~ 51 GB packed) is streamed, never resident.
``read_packed`` hands slabs straight to the fused Pallas kernel without
decoding; ``read_dosages`` decodes on the host via a 256x4 lookup table
(vectorized ``np.take``) for the reference path.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

__all__ = ["PlinkBed", "write_plink", "decode_packed", "pack_dosages", "BED_MAGIC"]

BED_MAGIC = b"\x6c\x1b\x01"
MISSING = -9

# 256 x 4 lookup: byte value -> 4 dosages (sample order LSB-first).
_CODE_TO_DOSAGE = np.array([2, MISSING, 1, 0], dtype=np.int8)
_BYTE_LUT = np.zeros((256, 4), dtype=np.int8)
for _b in range(256):
    for _k in range(4):
        _BYTE_LUT[_b, _k] = _CODE_TO_DOSAGE[(_b >> (2 * _k)) & 0b11]

# Inverse: dosage -> 2-bit code.
_DOSAGE_TO_CODE = {2: 0b00, MISSING: 0b01, 1: 0b10, 0: 0b11}


def decode_packed(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """``(M, ceil(N/4)) uint8 -> (M, N) int8`` dosages with -9 missing."""
    out = _BYTE_LUT[packed]  # (M, bytes, 4)
    return out.reshape(packed.shape[0], -1)[:, :n_samples]


def pack_dosages(dosages: np.ndarray) -> np.ndarray:
    """``(M, N) int dosages (-9 missing) -> (M, ceil(N/4)) uint8`` packed."""
    d = np.asarray(dosages)
    m, n = d.shape
    n_pad = (-n) % 4
    if n_pad:
        # Pad with hom A2 (code 0b11 -> dosage 0) like PLINK does.
        d = np.concatenate([d, np.zeros((m, n_pad), d.dtype)], axis=1)
    code = np.empty(d.shape, np.uint8)
    code[d == 2] = 0b00
    code[d == MISSING] = 0b01
    code[d == 1] = 0b10
    code[d == 0] = 0b11
    code = code.reshape(m, -1, 4)
    packed = (
        code[:, :, 0]
        | (code[:, :, 1] << 2)
        | (code[:, :, 2] << 4)
        | (code[:, :, 3] << 6)
    )
    return packed.astype(np.uint8)


@dataclass
class Marker:
    chrom: str
    snp_id: str
    cm: float
    pos: int
    a1: str
    a2: str


@dataclass
class PlinkBed:
    """Streaming reader over a .bed/.bim/.fam fileset."""

    # PLINK bytes are the native layout: ``read_packed`` is a memmap view,
    # so packed staging (DESIGN.md §17) can make 2-bit bytes the H2D currency.
    supports_packed = True

    bed_path: str
    n_samples: int = field(init=False)
    n_markers: int = field(init=False)
    sample_ids: list[str] = field(init=False)
    markers: list[Marker] = field(init=False)

    def __post_init__(self) -> None:
        stem = self.bed_path[: -len(".bed")]
        self.sample_ids = []
        with open(stem + ".fam") as f:
            for line in f:
                parts = line.split()
                if parts:
                    self.sample_ids.append(parts[1])
        self.markers = []
        with open(stem + ".bim") as f:
            for line in f:
                parts = line.split()
                if parts:
                    self.markers.append(
                        Marker(parts[0], parts[1], float(parts[2]), int(parts[3]), parts[4], parts[5])
                    )
        self.n_samples = len(self.sample_ids)
        self.n_markers = len(self.markers)
        self._bytes_per_marker = (self.n_samples + 3) // 4
        with open(self.bed_path, "rb") as f:
            magic = f.read(3)
        if magic != BED_MAGIC:
            raise ValueError(
                f"{self.bed_path}: bad magic {magic!r} (need SNP-major PLINK 1 bed)"
            )
        expected = 3 + self._bytes_per_marker * self.n_markers
        actual = os.path.getsize(self.bed_path)
        if actual != expected:
            raise ValueError(
                f"{self.bed_path}: size {actual} != expected {expected} "
                f"for {self.n_markers} markers x {self.n_samples} samples"
            )
        self._mmap = np.memmap(self.bed_path, dtype=np.uint8, mode="r", offset=3)

    @property
    def marker_ids(self) -> list[str]:
        return [m.snp_id for m in self.markers]

    def read_packed(self, lo: int, hi: int) -> np.ndarray:
        """Raw 2-bit slab ``(hi-lo, ceil(N/4)) uint8`` — the fused-kernel path."""
        bpm = self._bytes_per_marker
        slab = self._mmap[lo * bpm : hi * bpm]
        return np.asarray(slab).reshape(hi - lo, bpm)

    def packed_cache_key(self) -> tuple:
        """Stable identity for the shared packed-slab cache: same fileset on
        disk (by realpath/size/mtime) -> same cached slabs across source
        instances, which is what lets serve warm windows and resumed scans
        reuse reads."""
        st = os.stat(self.bed_path)
        return ("plink", os.path.realpath(self.bed_path), st.st_size, st.st_mtime_ns)

    def read_dosages(self, lo: int, hi: int) -> np.ndarray:
        """Decoded ``(hi-lo, N) int8`` dosages, -9 missing — the reference path."""
        return decode_packed(self.read_packed(lo, hi), self.n_samples)


def write_plink(
    stem: str,
    dosages: np.ndarray,
    *,
    sample_ids: list[str] | None = None,
    markers: list[Marker] | None = None,
) -> str:
    """Write ``(M, N)`` dosages as a .bed/.bim/.fam fileset; returns bed path.

    Used by tests (round-trip oracle) and by the synthetic-cohort generator;
    also handy for exporting filtered cohorts.
    """
    d = np.asarray(dosages)
    m, n = d.shape
    sample_ids = sample_ids or [f"S{i:06d}" for i in range(n)]
    markers = markers or [
        Marker("1", f"rs{i:08d}", 0.0, i + 1, "A", "G") for i in range(m)
    ]
    if len(sample_ids) != n or len(markers) != m:
        raise ValueError("sample/marker metadata does not match dosage shape")
    with open(stem + ".fam", "w") as f:
        for s in sample_ids:
            f.write(f"{s} {s} 0 0 0 -9\n")
    with open(stem + ".bim", "w") as f:
        for mk in markers:
            f.write(f"{mk.chrom}\t{mk.snp_id}\t{mk.cm}\t{mk.pos}\t{mk.a1}\t{mk.a2}\n")
    packed = pack_dosages(d)
    with open(stem + ".bed", "wb") as f:
        f.write(BED_MAGIC)
        f.write(packed.tobytes())
    return stem + ".bed"
