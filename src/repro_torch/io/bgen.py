"""Minimal BGEN v1.2 reader/writer (layout 2, biallelic diploid unphased).

This is the subset that imputation pipelines (IMPUTE4/qctool/bgenix) emit for
UK-Biobank-style data: layout-2 blocks, zlib (or uncompressed) probability
payloads, B = 8 or 16 probability bits, diploid unphased samples.  The
reader converts genotype probabilities to expected alt-allele (allele 2)
dosage; hard-called inputs round-trip exactly through the writer.

Reference: www.well.ox.ac.uk/~gav/bgen_format/spec/v1.2.html
"""
from __future__ import annotations

import struct
import threading
import zlib
from dataclasses import dataclass, field

import numpy as np

__all__ = ["BgenFile", "write_bgen"]

_MAGIC = b"bgen"
MISSING = -9.0


@dataclass
class _Variant:
    ident: str
    rsid: str
    chrom: str
    pos: int
    alleles: list[str]
    data_offset: int      # file offset of the genotype data block
    compressed_len: int
    uncompressed_len: int


class BgenFile:
    """Index-on-open streaming reader.

    The variant directory is scanned once at open (cheap: header fields only,
    probability payloads are skipped via their length fields), after which
    ``read_dosages(lo, hi)`` decompresses just the requested marker range.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        # seek+read on the shared handle must be atomic: prefetch workers
        # decode different marker ranges of this file concurrently.
        self._lock = threading.Lock()
        header = self._f.read(4)
        (first_variant_offset,) = struct.unpack("<I", header)
        (h_len, n_variants, n_samples) = struct.unpack("<III", self._f.read(12))
        magic = self._f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"{path}: bad magic {magic!r}")
        free_len = h_len - 20
        self._f.seek(free_len, 1)
        (flags,) = struct.unpack("<I", self._f.read(4))
        self.compression = flags & 0x3
        self.layout = (flags >> 2) & 0xF
        has_sample_ids = bool(flags >> 31)
        if self.layout != 2:
            raise NotImplementedError(f"layout {self.layout}; only layout 2 supported")
        if self.compression not in (0, 1):
            raise NotImplementedError("only zlib / uncompressed payloads supported")
        self.n_samples = n_samples
        self.n_markers = n_variants
        self.sample_ids: list[str] = []
        if has_sample_ids:
            (_blk_len, n_ids) = struct.unpack("<II", self._f.read(8))
            for _ in range(n_ids):
                (slen,) = struct.unpack("<H", self._f.read(2))
                self.sample_ids.append(self._f.read(slen).decode())
        else:
            self.sample_ids = [f"S{i:06d}" for i in range(n_samples)]
        # Scan the variant directory.
        self._f.seek(first_variant_offset + 4)
        self.variants: list[_Variant] = []
        for _ in range(n_variants):
            self.variants.append(self._read_variant_header())
        self._f.seek(0)

    def _read_str16(self) -> str:
        (n,) = struct.unpack("<H", self._f.read(2))
        return self._f.read(n).decode()

    def _read_variant_header(self) -> _Variant:
        ident = self._read_str16()
        rsid = self._read_str16()
        chrom = self._read_str16()
        (pos, n_alleles) = struct.unpack("<IH", self._f.read(6))
        alleles = []
        for _ in range(n_alleles):
            (alen,) = struct.unpack("<I", self._f.read(4))
            alleles.append(self._f.read(alen).decode())
        (c_len,) = struct.unpack("<I", self._f.read(4))
        if self.compression:
            (d_len,) = struct.unpack("<I", self._f.read(4))
            payload_len = c_len - 4
        else:
            d_len = c_len
            payload_len = c_len
        data_offset = self._f.tell()
        self._f.seek(payload_len, 1)
        return _Variant(ident, rsid, chrom, pos, alleles, data_offset, payload_len, d_len)

    @property
    def marker_ids(self) -> list[str]:
        return [v.rsid for v in self.variants]

    def read_dosages(self, lo: int, hi: int) -> np.ndarray:
        """Expected allele-2 dosage ``(hi-lo, N) float32``; missing -> -9."""
        out = np.empty((hi - lo, self.n_samples), np.float32)
        for row, idx in enumerate(range(lo, hi)):
            out[row] = self._decode_one(self.variants[idx])
        return out

    def read_packed(self, lo: int, hi: int):
        raise NotImplementedError("BGEN stores probabilities; no 2-bit fast path")

    def _decode_one(self, v: _Variant) -> np.ndarray:
        with self._lock:
            self._f.seek(v.data_offset)
            raw = self._f.read(v.compressed_len)
        if self.compression == 1:
            raw = zlib.decompress(raw, bufsize=v.uncompressed_len)
        (n_samples, n_alleles, min_pl, max_pl) = struct.unpack("<IHBB", raw[:8])
        if n_alleles != 2 or min_pl != 2 or max_pl != 2:
            raise NotImplementedError("only biallelic diploid blocks supported")
        ploidy_missing = np.frombuffer(raw, np.uint8, n_samples, 8)
        off = 8 + n_samples
        phased, bits = raw[off], raw[off + 1]
        if phased != 0:
            raise NotImplementedError("only unphased blocks supported")
        off += 2
        if bits == 8:
            probs = np.frombuffer(raw, np.uint8, 2 * n_samples, off).astype(np.float32)
            scale = 255.0
        elif bits == 16:
            probs = np.frombuffer(raw, np.uint16, 2 * n_samples, off).astype(np.float32)
            scale = 65535.0
        else:
            raise NotImplementedError(f"B={bits} probability bits unsupported")
        p = probs.reshape(n_samples, 2) / scale  # columns: P(11), P(12)
        p11, p12 = p[:, 0], p[:, 1]
        p22 = np.clip(1.0 - p11 - p12, 0.0, 1.0)
        dosage = (p12 + 2.0 * p22).astype(np.float32)
        missing = (ploidy_missing & 0x80) != 0
        dosage[missing] = MISSING
        return dosage

    def close(self) -> None:
        self._f.close()


def write_bgen(
    path: str,
    dosages: np.ndarray,
    *,
    sample_ids: list[str] | None = None,
    rsids: list[str] | None = None,
    bits: int = 8,
    compress: bool = True,
) -> str:
    """Write hard-called ``(M, N)`` dosages (ints in {0,1,2}, -9 missing) as a
    BGEN v1.2 layout-2 file.  Probabilities are one-hot so the reader's
    expected dosage reproduces the input exactly (up to the stated bit depth).
    """
    d = np.asarray(dosages)
    m, n = d.shape
    sample_ids = sample_ids or [f"S{i:06d}" for i in range(n)]
    rsids = rsids or [f"rs{i:08d}" for i in range(m)]

    buf = bytearray()
    sample_block = bytearray()
    for s in sample_ids:
        enc = s.encode()
        sample_block += struct.pack("<H", len(enc)) + enc
    sample_block = struct.pack("<II", len(sample_block) + 8, n) + bytes(sample_block)

    h_len = 20
    flags = (1 if compress else 0) | (2 << 2) | (1 << 31)
    header = struct.pack("<III", h_len, m, n) + _MAGIC + struct.pack("<I", flags)
    # Spec: offset of the first variant block relative to byte 4 of the file.
    first_variant_offset = h_len + len(sample_block)
    buf += struct.pack("<I", first_variant_offset)
    buf += header
    buf += sample_block

    scale = 255 if bits == 8 else 65535
    pack_fmt = np.uint8 if bits == 8 else np.uint16
    for i in range(m):
        for s, text in (("var%d" % i, None), (rsids[i], None), ("1", None)):
            enc = s.encode()
            buf += struct.pack("<H", len(enc)) + enc
        buf += struct.pack("<IH", i + 1, 2)
        for allele in ("A", "G"):
            enc = allele.encode()
            buf += struct.pack("<I", len(enc)) + enc
        row = d[i]
        missing = row == -9
        p11 = np.where(row == 0, scale, 0).astype(pack_fmt)
        p12 = np.where(row == 1, scale, 0).astype(pack_fmt)
        p11[missing] = 0
        p12[missing] = 0
        ploidy = np.full(n, 2, np.uint8)
        ploidy[missing] |= 0x80
        payload = (
            struct.pack("<IHBB", n, 2, 2, 2)
            + ploidy.tobytes()
            + struct.pack("<BB", 0, bits)
            + np.stack([p11, p12], axis=1).tobytes()
        )
        if compress:
            comp = zlib.compress(payload, 6)
            buf += struct.pack("<II", len(comp) + 4, len(payload)) + comp
        else:
            buf += struct.pack("<I", len(payload)) + payload

    with open(path, "wb") as f:
        f.write(bytes(buf))
    return path
