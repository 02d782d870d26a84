#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one NVIDIA
card and hold its hand-written kernel against the plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device      card name and count, ``nvidia-smi`` name and power limit
  build       nvcc build of every kernel source, from this checkout
  kernel      gwas_dot kernel vs its plain version on the card, at one scan
              cell (M=4096, N=23000, P=1024) and a ragged shape, fp32 and
              bf16; kernel/plain/library times (CUDA events) and the bound
  scan        the main path: ``gwas scan --engine fused`` through
              Study.from_arrays(PlinkBed) -> plan -> ScanSession -> TsvWriter
              on a synthetic cohort at the paper workload's width (N=23,000
              samples, P=2,048 traits, 12 covariates), depth cut to 8,192
              markers (2 batches x 2 trait blocks); launches counted
  cross       the same cohort on the dense engine (a torch.matmul GEMM):
              same hits outside a +/-0.05 band, values within the fused
              oracle tolerances, lambda_gc within 1e-3
  identities  1,024 markers at full N and P: sparse == dense epilogue,
              blocked == unblocked trait grid, packed == dense staging, bitwise
  cli         ``python -m repro_torch.launch.gwas scan --engine fused`` on a
              small cohort in a temporary directory

then a ``kernels`` JSON line, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth.
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
HIT_BAND = 0.05
DEVICE = "cuda:0"
KERNEL_SHAPES = (("cell", (4096, 23000, 1024)), ("ragged", (1000, 1003, 300)))
# the scan cohort: the paper workload's width (configs/gwas_ukb.py: 23,000
# samples, 12 covariates; 20,480 traits cut to 2,048), depth cut to 8,192
# markers in two batches, traits in two blocks
SCAN = dict(n_samples=23000, n_markers=8192, n_traits=2048, n_covariates=12,
            n_causal=32, effect_size=0.06, batch_markers=4096, trait_block=1024)
IDENTITY_MARKERS = 1024
# fused-engine oracle tolerances (tests/test_oracle.py)
TOL_R, TOL_T, TOL_NLP = 5e-5, (5e-4, 5e-4), (5e-3, 1e-2)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gwas_dot_bound(m: int, n: int, p: int, packed_bytes: int) -> tuple[float, str]:
    """Least time for one gwas_dot call: each input read once (packed codes,
    mean, inv_std, y), each output written once (r, t), against 2*M*N*P fp32
    FLOP on the non-tensor lanes."""
    flops = 2.0 * m * n * p
    nbytes = packed_bytes + 8 * m + 4 * n * p + 8 * m * p
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------- phases


def phase_device() -> tuple[dict, str]:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    info = {"kind": name, "count": torch.cuda.device_count()}
    emit({"phase": "device", **info, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return info, smi


def phase_build() -> None:
    from repro_torch.kernels import build

    sources = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR) if f.endswith(".cu"))
    t0 = time.perf_counter()
    # One nvcc per source, all started together.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build.build, sources)))
    wall = time.perf_counter() - t0
    ptxas = {
        s: [ln.strip() for ln in build.build_info[s]["log"].splitlines()
            if "registers" in ln or "spill" in ln]
        for s in sources
    }
    emit({"phase": "build", "sources": sources, "wall_s": wall,
          "nvcc_s": {s: build.build_info[s]["seconds"] for s in sources},
          "libs": {s: os.path.relpath(p, HERE) for s, p in libs.items()}, "ptxas": ptxas})


def _kernel_inputs(m, n, p, block_n, seed):
    import numpy as np
    import torch

    from repro_torch.kernels.gwas_dot import ops

    rng = np.random.default_rng(seed)
    codes = rng.choice([0, 1, 2, 3], p=[0.3, 0.02, 0.38, 0.3], size=(m, n)).astype(np.uint8)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    y = rng.normal(size=(n, p)).astype(np.float32)
    # plant signal so r spans the epilogue's range, not just ~1/sqrt(N)
    k = min(16, m, p)
    c32 = codes[:k].astype(np.int32)
    dose = np.where(c32 == 1, mean[:k, None], 2 - c32 + (c32 >> 1)).astype(np.float32)
    y[:, :k] += 0.8 * ((dose - mean[:k, None]) * inv_std[:k, None]).T
    dev = torch.device(DEVICE)
    return (
        torch.from_numpy(ops.pack_tiled(codes, block_n)).to(dev),
        torch.from_numpy(mean).to(dev),
        torch.from_numpy(inv_std).to(dev),
        torch.from_numpy(y).to(dev),
    )


def phase_kernel() -> dict:
    import torch

    from repro_torch.kernels.gwas_dot import gwas_dot as gd
    from repro_torch.kernels.gwas_dot import ref

    block_n = 512
    rows = []
    main = None
    for label, (m, n, p) in KERNEL_SHAPES:
        packed, mean, inv_std, y = _kernel_inputs(m, n, p, block_n, seed=m + n + p)
        dof = n - 2
        n_pad = packed.shape[1] * 4
        y_pad = torch.cat([y, y.new_zeros((n_pad - n, p))])
        codes = ref.unpack_tiled(packed, block_n)
        g = ref.decode_standardize_ref(codes, mean, inv_std)
        bound_ms, bound_by = gwas_dot_bound(m, n, p, packed.numel())
        for dtype in ("fp32", "bf16"):
            def kernel():
                return gd.gwas_dot_fused(packed, mean, inv_std, y, n_samples=n, dof=dof,
                                         block_n=block_n, input_dtype=dtype)

            def plain():
                return ref.gwas_dot_ref(ref.unpack_tiled(packed, block_n), mean, inv_std,
                                        y_pad, n_samples=n, dof=dof, input_dtype=dtype)

            r, t = kernel()
            r0, t0 = plain()
            check(bool(torch.isfinite(r).all() and torch.isfinite(t).all()),
                  f"gwas_dot {label} {dtype}: non-finite output")
            r_err = float((r - r0).abs().max())
            t_err = float((t - t0).abs().max())
            r_tol = 2e-6 if dtype == "fp32" else 5e-3
            check(r_err <= r_tol, f"gwas_dot {label} {dtype}: |dr|={r_err} > {r_tol}")
            t_tol = None
            if dtype == "fp32":
                # The r tolerance carried through t = r sqrt(dof / (1 - r^2)):
                # dt/dr = sqrt(dof) / (1 - r^2)^1.5, i.e. 2e-6 sqrt(dof) at
                # r ~ 0 (~3e-4 at N = 23,000), plus 2e-6 |t| for the
                # epilogue's own rounding.
                slope = math.sqrt(dof) / torch.clamp(1 - r0 * r0, min=1e-6) ** 1.5
                excess = (t - t0).abs() - (r_tol * slope + r_tol * t0.abs())
                t_tol = 2e-6 * math.sqrt(dof)
                check(float(excess.max()) <= 0.0,
                      f"gwas_dot {label} {dtype}: |dt|={t_err} past the propagated r tolerance")
            row = {
                "shape": label, "m": m, "n": n, "p": p, "dtype": dtype,
                "r_max_abs_err": r_err, "t_max_abs_err": t_err,
                "r_tol": r_tol, "t_tol": t_tol,
                "kernel_ms": cuda_ms(kernel),
                "plain_ms": cuda_ms(plain),
                "library_ms": cuda_ms(lambda: torch.matmul(g, y_pad)) if dtype == "fp32" else None,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            rows.append(row)
            emit({"phase": "kernel", **row})
            if label == "cell" and dtype == "fp32":
                main = row
        del packed, mean, inv_std, y, y_pad, codes, g
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return main


class Collect:
    """A result writer that keeps each cell's payload in memory, for the
    comparisons below (the TSVs hold rounded text)."""

    name = "collect"

    def open(self, session) -> None:
        from repro_torch.core.sinks import BestTraitSink, LambdaGCSink

        self.best = BestTraitSink(session.n_traits)
        self.lam = LambdaGCSink()
        self.cells: dict = {}

    def write(self, cell) -> None:
        self.best.on_cell(cell)
        self.lam.on_cell(cell)
        self.cells[(cell.batch_index, cell.block_index)] = cell.arrays

    def close(self) -> dict:
        return {}

    def abort(self) -> None:
        pass

    def hits(self):
        import numpy as np

        hits = np.concatenate([np.zeros((0, 2), np.int32)] + [a["hits"] for a in self.cells.values()])
        stats = np.concatenate([np.zeros((0, 3), np.float32)] + [a["hit_stats"] for a in self.cells.values()])
        order = np.lexsort((hits[:, 1], hits[:, 0]))
        return hits[order], stats[order]

    def canonical(self) -> dict:
        """Everything a run emits, independent of its trait blocking."""
        import numpy as np

        hits, stats = self.hits()
        tracks = {}
        for (b, k), a in sorted(self.cells.items()):
            if "maf" in a:
                for key in ("maf", "valid", "t_probe"):
                    tracks.setdefault(key, []).append(a[key])
        return {
            "hits": hits, "hit_stats": stats,
            "best_nlp": self.best.best_nlp, "best_marker": self.best.best_marker,
            **{k: np.concatenate(v) for k, v in tracks.items()},
            "lambda_gc": np.float64(self.lam.result()["lambda_gc"]),
        }


def _run(study, out_dir: str | None, **plan_kwargs):
    """Plan, prepare and stream one scan; returns (collector, summary, timing)."""
    from repro_torch.api import TsvWriter
    from repro_torch.kernels.gwas_dot import gwas_dot as gd

    plan = study.plan(device=DEVICE, **plan_kwargs)
    t0 = time.perf_counter()
    plan.prepare()
    prepare_s = time.perf_counter() - t0
    session = plan.run()
    cells = []
    prev = {"step": 0.0, "busy": 0.0}

    def progress(m):
        s = m.summary()
        busy = s["per_device"]["serial"]["busy_s"]
        cells.append({"cell": m.cells_done, "step_s": s["step_s"] - prev["step"],
                      "wall_s": busy - prev["busy"]})
        prev.update(step=s["step_s"], busy=busy)

    session.progress = progress
    col = Collect()
    writers = [col] + ([TsvWriter(out_dir)] if out_dir else [])
    gd.launches = 0
    t0 = time.perf_counter()
    summary = session.stream_to(*writers)
    wall = time.perf_counter() - t0
    launches = gd.launches
    metrics = session.metrics.summary()
    return col, summary, {
        "prepare_s": prepare_s, "wall_s": wall, "launches": launches,
        "step_s": metrics["step_s"], "extract_s": metrics["extract_s"],
        "decode_s": metrics["decode_s"], "cells": cells,
        "grid": [session.n_batches, session.n_trait_blocks],
        "genotype_staging": session.prepared.ctx.genotype_staging,
    }


def _compare(a: Collect, b: Collect, threshold: float) -> dict:
    """Same hit set outside the +/-band around the threshold, values within
    the fused oracle tolerances, lambda_gc within 1e-3."""
    import numpy as np

    ha, sa = a.hits()
    hb, sb = b.hits()
    ta = {tuple(h): s for h, s in zip(ha.tolist(), sa)}
    tb = {tuple(h): s for h, s in zip(hb.tolist(), sb)}
    for x, y, nx, ny in ((ta, tb, "a", "b"), (tb, ta, "b", "a")):
        missing = [k for k, s in x.items() if s[2] >= threshold + HIT_BAND and k not in y]
        check(not missing, f"hits in {nx} but not in {ny}: {missing[:5]}")
    common = sorted(set(ta) & set(tb))
    dr = dt = dn = 0.0
    for k in common:
        ra, tva, na = (float(v) for v in ta[k])
        rb, tvb, nb = (float(v) for v in tb[k])
        dr, dt, dn = max(dr, abs(ra - rb)), max(dt, abs(tva - tvb)), max(dn, abs(na - nb))
        check(abs(ra - rb) <= TOL_R, f"hit {k}: r {ra} vs {rb}")
        check(abs(tva - tvb) <= TOL_T[1] + TOL_T[0] * abs(tvb), f"hit {k}: t {tva} vs {tvb}")
        check(abs(na - nb) <= TOL_NLP[1] + TOL_NLP[0] * abs(nb), f"hit {k}: nlp {na} vs {nb}")
    bn_a, bn_b = a.best.best_nlp, b.best.best_nlp
    best_dn = float(np.max(np.abs(bn_a - bn_b)))
    check(bool(np.all(np.abs(bn_a - bn_b) <= TOL_NLP[1] + TOL_NLP[0] * np.abs(bn_b))),
          f"per-trait best nlp differs by up to {best_dn}")
    la, lb = a.lam.result()["lambda_gc"], b.lam.result()["lambda_gc"]
    check(abs(la - lb) <= 1e-3, f"lambda_gc {la} vs {lb}")
    return {"hits_a": len(ta), "hits_b": len(tb), "common": len(common),
            "max_dr": dr, "max_dt": dt, "max_dnlp": dn, "best_max_dnlp": best_dn,
            "lambda_gc": [la, lb]}


def phase_scan(tmp: str):
    import numpy as np

    from repro_torch.api import GridSpec, Study
    from repro_torch.io import PlinkBed, synth
    from repro_torch.io.plink import write_plink

    t0 = time.perf_counter()
    cohort = synth.make_cohort(
        n_samples=SCAN["n_samples"], n_markers=SCAN["n_markers"],
        n_traits=SCAN["n_traits"], n_covariates=SCAN["n_covariates"],
        n_causal=SCAN["n_causal"], effect_size=SCAN["effect_size"], seed=2026,
    )
    bed = write_plink(os.path.join(tmp, "cohort"), cohort.dosages, sample_ids=cohort.sample_ids)
    setup_s = time.perf_counter() - t0
    study = Study.from_arrays(PlinkBed(bed), cohort.phenotypes, cohort.covariates)
    grid = GridSpec(batch_markers=SCAN["batch_markers"], trait_block=SCAN["trait_block"])
    col, summary, timing = _run(study, os.path.join(tmp, "fused"), engine="fused", grid=grid)
    check(timing["launches"] > 0, "the scan never launched the gwas_dot kernel")
    hits, stats = col.hits()
    check(bool(np.isfinite(stats).all()), "non-finite hit statistics")
    found = {tuple(h) for h in hits.tolist()}
    planted = {(m, t) for m, t, _ in cohort.effects}
    missed = sorted(planted - found)
    check(not missed, f"planted effects missing from hits.tsv: {missed}")
    with open(os.path.join(tmp, "fused", "hits.tsv")) as f:
        tsv_rows = sum(1 for _ in f) - 1
    check(tsv_rows == len(hits), f"hits.tsv has {tsv_rows} rows, the stream {len(hits)}")
    emit({"phase": "scan", **SCAN, "cohort_setup_s": setup_s, **timing, "hits": len(hits),
          "planted": len(planted), "lambda_gc": summary["lambda_gc"]})
    return study, cohort, col, timing


def phase_cross(study, fused: Collect) -> None:
    from repro_torch.api import GridSpec

    grid = GridSpec(batch_markers=SCAN["batch_markers"], trait_block=SCAN["trait_block"])
    dense, _, timing = _run(study, None, engine="dense", grid=grid)
    cmp = _compare(fused, dense, threshold=7.301)
    emit({"phase": "cross", "engines": ["fused", "dense"], **cmp,
          "dense_wall_s": timing["wall_s"], "dense_step_s": timing["step_s"]})


def phase_identities(tmp: str, cohort) -> None:
    import numpy as np

    from repro_torch.api import GridSpec, IOSpec, Study
    from repro_torch.io import PlinkBed
    from repro_torch.io.plink import write_plink

    m = IDENTITY_MARKERS
    bed = write_plink(os.path.join(tmp, "head"), cohort.dosages[:m], sample_ids=cohort.sample_ids)
    study = Study.from_arrays(PlinkBed(bed), cohort.phenotypes, cohort.covariates)
    runs = {
        "sparse": dict(grid=GridSpec(batch_markers=m)),
        "dense_epilogue": dict(grid=GridSpec(batch_markers=m), sparse_epilogue=False),
        "blocked": dict(grid=GridSpec(batch_markers=m, trait_block=SCAN["trait_block"])),
        "dense_staging": dict(grid=GridSpec(batch_markers=m), io=IOSpec(genotype_staging="dense")),
    }
    canon = {}
    for name, kw in runs.items():
        col, _, timing = _run(study, None, engine="fused", **kw)
        check(timing["launches"] > 0, f"identities/{name}: kernel not launched")
        canon[name] = col.canonical()
    base = canon["sparse"]
    result = {}
    for name in ("dense_epilogue", "blocked", "dense_staging"):
        other = canon[name]
        check(base.keys() == other.keys(), f"{name}: emitted fields differ")
        bad = [k for k in base if not (base[k].dtype == other[k].dtype
                                       and np.array_equal(base[k], other[k]))]
        check(not bad, f"sparse vs {name}: not bitwise equal in {bad}")
        result[name] = "bitwise equal"
    emit({"phase": "identities", "markers": m, "hits": int(len(base["hits"])), **result})


def phase_cli(tmp: str) -> None:
    from repro_torch.io import synth
    from repro_torch.runtime.device import resolve_device

    work = os.path.join(tmp, "cli")
    os.makedirs(work)
    cohort = synth.make_cohort(n_samples=500, n_markers=1200, n_traits=10,
                               n_causal=6, effect_size=0.6, seed=11)
    files = synth.write_cohort_files(cohort, os.path.join(work, "cohort"))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gwas", "scan",
         "--genotypes", files["bed"], "--pheno", files["pheno"], "--covar", files["cov"],
         "--out", os.path.join(work, "results"), "--engine", "fused", "--batch-markers", "256",
         "--device", DEVICE],
        cwd=work, env=env, capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI scan failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    with open(os.path.join(work, "results", "summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(work, "results", "hits.tsv")) as f:
        next(f)
        found = {tuple(line.split("\t")[:2]) for line in f}
    planted = {(cohort.marker_ids[m], f"trait{t}") for m, t, _ in cohort.effects}
    check(planted <= found, f"CLI missed planted effects {sorted(planted - found)}")
    check(summary["device"] == str(resolve_device(DEVICE)), f"CLI ran on {summary['device']}")
    emit({"phase": "cli", "wall_s": wall, "hits": summary["hits"],
          "lambda_gc": summary["lambda_gc"], "device": summary["device"],
          "genotype_staging": summary["genotype_staging"]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.runtime.device import resolve_device

    resolve_device(DEVICE)
    info, smi = phase_device()
    phase_build()
    main_row = phase_kernel()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        study, cohort, fused, timing = phase_scan(tmp)
        phase_cross(study, fused)
        phase_identities(tmp, cohort)
        phase_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"kernels": [{
        "name": "gwas_dot",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gwas_dot.cu",
        "replaces": "src/repro/kernels/gwas_dot/gwas_dot.py:35",
        "launches": timing["launches"],
        "max_abs_err": main_row["r_max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
