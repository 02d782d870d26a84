"""Genotype / phenotype IO substrate.

Three genotype backends (paper §2.1: "supports NumPy, PLINK, and BGEN
genotype inputs") behind one streaming interface, plus phenotype/covariate
table alignment and synthetic-cohort generation for tests and examples.

All backends expose the same protocol (``GenotypeSource``):

    n_samples, n_markers, sample_ids, marker_ids
    read_dosages(lo, hi)  -> int8 (markers, samples), -9 missing
    read_packed(lo, hi)   -> uint8 2-bit packed slab (PLINK native; numpy
                             re-packs hardcalls; BGEN raises)
    supports_packed       -> True when 2-bit bytes are the *native* layout,
                             enabling packed H2D staging (DESIGN.md §17)

Packed slabs flow through the shared ``PackedSlabCache`` so scan, GRM, and
serve warm windows share one read per (source, batch).
"""
from repro_torch.io.plink import PlinkBed, write_plink
from repro_torch.io.bgen import BgenFile, write_bgen
from repro_torch.io.numpy_io import NumpyGenotypes
from repro_torch.io.multifile import MultiFileSource, expand_genotype_paths
from repro_torch.io.packed_cache import PackedSlabCache, default_cache, read_packed_cached
from repro_torch.io.pheno import PhenotypeTable, align_tables, read_table
from repro_torch.io.synth import SyntheticCohort, make_cohort

__all__ = [
    "PackedSlabCache",
    "default_cache",
    "read_packed_cached",
    "PlinkBed",
    "write_plink",
    "BgenFile",
    "write_bgen",
    "NumpyGenotypes",
    "MultiFileSource",
    "PhenotypeTable",
    "align_tables",
    "read_table",
    "SyntheticCohort",
    "make_cohort",
    "open_genotypes",
]


def _open_one(path: str):
    if path.endswith(".bed"):
        return PlinkBed(path)
    if path.endswith(".bgen"):
        return BgenFile(path)
    if path.endswith((".npy", ".npz")):
        return NumpyGenotypes(path)
    raise ValueError(f"unrecognized genotype container: {path}")


def open_genotypes(path: str):
    """Open one container or a per-chromosome fileset.

    Dispatch on file suffix: ``.bed`` -> PLINK, ``.bgen`` -> BGEN,
    ``.npy``/``.npz`` -> NumPy.  A glob pattern (``cohort_chr*.bed``,
    numeric-aware ordering so chr2 < chr10) or a comma-separated list
    (``chr1.bed,chr2.bed``) opens every match as one ``MultiFileSource``
    with contiguous global marker indexing.
    """
    paths = expand_genotype_paths(str(path))
    if len(paths) == 1:
        return _open_one(paths[0])
    return MultiFileSource([_open_one(p) for p in paths])
