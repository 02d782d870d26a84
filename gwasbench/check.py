"""The comparison that decides ``correct``: what the timed path produced,
held against the float64 reference (``gwasbench.reference``) on the same
inputs.

Every number is a worst case, lower is better, and each is held to the
limit that the configuration's file states (``limits``):

    hit_r_err       max |r - r_ref| over the port's hits
    hit_nlp_err     how far the port's hit list departs from the reference's
                    in -log10 p: max |nlp - nlp_ref| / max(1, nlp_ref) over
                    the port's hits, and |nlp_ref - threshold| / threshold
                    over the lanes that one side counts as a hit and the
                    other not
    best_err        per trait, the larger of |best - best_ref| and how far
                    the reference's -log10 p at the port's best marker lies
                    below best_ref, over max(1, best_ref); max over traits
    maf_err         max |maf - maf_ref| over the cells' markers
    valid_mismatch  markers whose validity flag differs
    omnibus_nlp_err max |omnibus - omnibus_ref| / max(1, omnibus_ref) over the
                    markers, -log10 p of the multivariate omnibus (only in a
                    configuration that runs it)
    duplicate_cells cells delivered more than once

The hit numbers, ``maf_err``, ``valid_mismatch`` and ``omnibus_nlp_err`` are
read per cell; a cell whose own numbers fail a limit counts as ``failed``.
The best of each trait is the port's fold over every delivered cell, against
the reference's best over the same markers.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from gwasbench.reference import PanelReference, neglog10p, t2_for_nlp

PER_CELL = ("hit_r_err", "hit_nlp_err", "maf_err", "valid_mismatch", "omnibus_nlp_err")
GLOBAL = ("best_err", "duplicate_cells")


@dataclass
class CellOutput:
    """What the port delivered for one grid cell (host arrays only: the cell's
    device tiles are not kept)."""

    batch_index: int
    lo: int                  # first virtual marker
    hi: int
    hits: np.ndarray         # (H, 2) int: virtual marker, trait
    hit_stats: np.ndarray    # (H, 3) float32: r, t, -log10 p
    maf: np.ndarray          # (hi - lo,)
    valid: np.ndarray        # (hi - lo,) bool
    omnibus_nlp: np.ndarray | None = None  # (hi - lo,) when the scan runs the omnibus


@dataclass
class Verdict:
    numbers: dict[str, float]
    limits: dict[str, float]
    cells: int
    failed_cells: int

    @property
    def correct(self) -> bool:
        return (
            self.cells > 0
            and self.failed_cells == 0
            and all(_passes(v, self.limits[k]) for k, v in self.numbers.items())
        )


def _passes(value: float, limit: float) -> bool:
    return bool(np.isfinite(value)) and value <= limit


def _max(x) -> float:
    x = np.asarray(x, np.float64)
    return float(x.max()) if x.size else 0.0


def compare(cells: list[CellOutput], best_nlp: np.ndarray, best_marker: np.ndarray, *,
            ref: PanelReference, bed_path: str, period: int, threshold: float,
            limits: dict[str, float]) -> Verdict:
    """Hold ``cells`` and the per-trait fold (``best_nlp``, ``best_marker``)
    against the reference.  Virtual marker ``i`` is file marker ``i mod
    period``; a cell must not straddle the period."""
    # the configuration's limits say whether it runs the omnibus
    omnibus = "omnibus_nlp_err" in limits
    names = [k for k in PER_CELL + GLOBAL if omnibus or k != "omnibus_nlp_err"]
    if set(names) != set(limits):
        raise ValueError(f"limits {sorted(limits)} do not name the numbers {sorted(names)}")
    per_cell_names = [k for k in PER_CELL if k in names]
    dof = ref.dof
    t2_thr = t2_for_nlp(threshold, dof)
    p = best_nlp.shape[0]
    seen = [c.batch_index for c in cells]
    by_file: dict[tuple[int, int], list[CellOutput]] = defaultdict(list)
    for c in cells:
        flo = c.lo % period
        if flo + (c.hi - c.lo) > period:
            raise ValueError(f"cell [{c.lo}, {c.hi}) straddles the file period {period}")
        by_file[(flo, flo + c.hi - c.lo)].append(c)
    covered = np.zeros(0, np.int64)
    if cells:
        covered = np.concatenate([np.arange(c.lo, c.hi) for c in cells])
    best_marker = np.asarray(best_marker, np.int64)
    owned = np.isin(best_marker, covered)
    best_t2_ref = np.zeros(p)
    t_at_best = np.full(p, np.nan)
    per_cell = []
    dev = ref.device
    for (flo, fhi), group in sorted(by_file.items()):
        blk = ref.block(bed_path, flo, fhi)
        r, t = blk["r"], blk["t"]
        t2 = t * t
        best_t2_ref = np.maximum(best_t2_ref, t2.max(0).values.cpu().numpy())
        f_of_best = best_marker % period
        here = owned & (f_of_best >= flo) & (f_of_best < fhi)
        if here.any():
            rows = torch.from_numpy(f_of_best[here] - flo).to(dev)
            cols = torch.from_numpy(np.nonzero(here)[0]).to(dev)
            t_at_best[here] = t[rows, cols].cpu().numpy()
        cand = (t2 >= t2_thr * (1 - 1e-9)).nonzero()
        cand_nlp = neglog10p(t[cand[:, 0], cand[:, 1]].cpu().numpy(), dof)
        cand = cand.cpu().numpy()
        ref_hits = {(int(a), int(b)): v for (a, b), v in zip(cand, cand_nlp) if v >= threshold}
        o_ref = ref.omnibus_nlp(r) if omnibus else None
        for c in group:
            m = c.hi - c.lo
            rows = np.asarray(c.hits[:, 0], np.int64) - c.lo
            cols = np.asarray(c.hits[:, 1], np.int64)
            inside = (rows >= 0) & (rows < m) & (cols >= 0) & (cols < p)
            gaps = [np.inf] * int((~inside).sum())
            rows, cols, stats = rows[inside], cols[inside], c.hit_stats[inside]
            ri, ci = torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)
            r_ref = r[ri, ci].cpu().numpy()
            nlp_ref = neglog10p(t[ri, ci].cpu().numpy(), dof)
            mine = set(zip(rows.tolist(), cols.tolist()))
            gaps += [(threshold - v) / threshold for v in nlp_ref if v < threshold]
            gaps += [(v - threshold) / threshold for k, v in ref_hits.items() if k not in mine]
            if len(mine) != len(rows):
                gaps.append(np.inf)  # a lane reported twice
            maf = np.asarray(c.maf, np.float64)
            nums = {
                "hit_r_err": _max(np.abs(stats[:, 0] - r_ref)),
                "hit_nlp_err": max(_max(gaps), _max(np.abs(stats[:, 2] - nlp_ref)
                                                    / np.maximum(1.0, nlp_ref))),
                "maf_err": _max(np.abs(maf - blk["maf"])) if maf.shape == blk["maf"].shape
                else np.inf,
                "valid_mismatch": float(np.sum(np.asarray(c.valid, bool) != blk["valid"]))
                if maf.shape == blk["maf"].shape else np.inf,
            }
            if omnibus:
                if c.omnibus_nlp is None:
                    nums["omnibus_nlp_err"] = np.inf
                else:
                    nums["omnibus_nlp_err"] = _max(
                        np.abs(np.asarray(c.omnibus_nlp, np.float64) - o_ref)
                        / np.maximum(1.0, o_ref))
            per_cell.append({"batch": c.batch_index, **nums})
        del blk, r, t, t2
    best_ref = neglog10p(np.sqrt(best_t2_ref), dof)
    at_best = np.where(np.isnan(t_at_best), -np.inf, neglog10p(np.nan_to_num(t_at_best), dof))
    numbers = {k: max([pc[k] for pc in per_cell], default=0.0) for k in per_cell_names}
    numbers["best_err"] = _max(
        np.maximum(np.abs(np.asarray(best_nlp, np.float64) - best_ref), best_ref - at_best)
        / np.maximum(1.0, best_ref))
    numbers["duplicate_cells"] = float(len(seen) - len(set(seen)))
    failed = sum(1 for pc in per_cell
                 if not all(_passes(pc[k], limits[k]) for k in per_cell_names))
    return Verdict(numbers, {k: float(limits[k]) for k in names}, len(cells), failed)
