"""Phenotype / covariate tables and sample alignment.

Paper §2.1: "aligns phenotype and covariate tables by sample identifier, and
performs covariate adjustment internally".  Tables are whitespace- or
comma-delimited text with a header row; the sample-id column is ``IID``
(PLINK convention), ``id``, or the first column.  Missing values: ``NA``,
``nan``, ``-9``, empty.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["PhenotypeTable", "align_tables", "read_table"]

_MISSING_TOKENS = {"na", "nan", "-9", "", "."}
_ID_COLUMNS = ("iid", "id", "sample", "sample_id", "eid")


@dataclass
class PhenotypeTable:
    sample_ids: list[str]
    names: list[str]          # column (trait / covariate) names
    values: np.ndarray        # (n_samples, n_columns) float32, NaN missing

    @property
    def n_samples(self) -> int:
        return len(self.sample_ids)

    @property
    def n_columns(self) -> int:
        return len(self.names)

    def column(self, name: str) -> np.ndarray:
        return self.values[:, self.names.index(name)]


def _sniff_delimiter(header: str) -> str | None:
    return "," if ("," in header and "\t" not in header) else None


def read_table(path: str) -> PhenotypeTable:
    """Parse a phenotype/covariate table; drops the FID column if present."""
    with open(path) as f:
        header_line = f.readline().rstrip("\n")
        delim = _sniff_delimiter(header_line)
        header = [h.strip() for h in (header_line.split(delim) if delim else header_line.split())]
        lower = [h.lower() for h in header]
        id_col = next((lower.index(c) for c in _ID_COLUMNS if c in lower), 0)
        skip_cols = {id_col}
        if "fid" in lower:
            skip_cols.add(lower.index("fid"))
        value_cols = [i for i in range(len(header)) if i not in skip_cols]
        names = [header[i] for i in value_cols]
        sample_ids: list[str] = []
        rows: list[list[float]] = []
        for line in f:
            parts = line.split(delim) if delim else line.split()
            if not parts or not "".join(parts).strip():
                continue
            sample_ids.append(parts[id_col].strip())
            row = []
            for i in value_cols:
                tok = parts[i].strip().lower() if i < len(parts) else ""
                row.append(np.nan if tok in _MISSING_TOKENS else float(parts[i]))
            rows.append(row)
    values = np.asarray(rows, np.float32).reshape(len(rows), len(names))
    return PhenotypeTable(sample_ids=sample_ids, names=names, values=values)


def align_tables(
    genotype_sample_ids: list[str],
    phenotypes: PhenotypeTable,
    covariates: PhenotypeTable | None = None,
    *,
    require_complete: bool = False,
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray]:
    """Intersect sample sets and order table rows to match the genotype file.

    Returns ``(Y, C, keep_mask)``:
      Y (n_kept, P) phenotypes, C (n_kept, q) covariates or None, and a
      boolean mask over genotype samples marking the kept rows.  Samples
      missing from either table are dropped.  With ``require_complete`` any
      sample with a missing covariate is dropped too (phenotype NaNs are
      allowed and handled by per-trait masking downstream).
    """
    pheno_index = {s: i for i, s in enumerate(phenotypes.sample_ids)}
    cov_index = {s: i for i, s in enumerate(covariates.sample_ids)} if covariates else None

    keep = np.zeros(len(genotype_sample_ids), bool)
    p_rows: list[int] = []
    c_rows: list[int] = []
    for g_idx, sid in enumerate(genotype_sample_ids):
        p_i = pheno_index.get(sid)
        if p_i is None:
            continue
        if cov_index is not None:
            c_i = cov_index.get(sid)
            if c_i is None:
                continue
            if require_complete and np.isnan(covariates.values[c_i]).any():
                continue
            c_rows.append(c_i)
        keep[g_idx] = True
        p_rows.append(p_i)
    y = phenotypes.values[p_rows]
    c = covariates.values[c_rows] if cov_index is not None else None
    if c is not None and np.isnan(c).any():
        # Mean-impute remaining covariate gaps (standard screening practice).
        col_mean = np.nanmean(c, axis=0)
        c = np.where(np.isnan(c), col_mean[None, :], c)
    return y, c, keep
