#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one NVIDIA
card and hold its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device          card name and count, ``nvidia-smi`` name and power limit
  build           nvcc build of every kernel source, from this checkout;
                  ptxas registers/spills, and the count of tensor-core (HMMA)
                  instructions in the gwas_dot library's SASS (must be > 0)
  kernel          gwas_dot kernel vs its plain version on the card, at one
                  scan cell (M=4096, N=23000, P=1024) and a ragged shape, fp32
                  and bf16; kernel/plain/library times (CUDA events), bound;
                  at the cell, column and row splits of the call bitwise
                  equal to the whole call; the loop's edge shapes (unaligned
                  y rows, per-code decode, partial steps and chunks, tiles
                  larger than the problem, all-missing rows)
  kernel_tstat    the tstat kernel and both entries of the screen kernel (r
                  mode: screen_compact; t mode: compact_survivors) vs their
                  plain versions at the mixed-model cell (4096, 1024) and a
                  ragged (1000, 300): t bitwise between tstat and the screen,
                  idx and count exactly, then no-survivor, all-survivor, NaN,
                  capacity-above-size and empty tiles; times of the whole
                  calls and the bound; both entries and the sparse epilogue
                  under torch.cuda.set_sync_debug_mode("error"), and the
                  synchronizing ops left in one fused step and one lmm step
  scan            the fused path: ``gwas scan --engine fused`` through
                  Study.from_arrays(PlinkBed) -> plan -> ScanSession ->
                  TsvWriter on a synthetic cohort at the paper workload's
                  width (N=23,000 samples, P=2,048 traits, 12 covariates),
                  depth cut to 8,192 markers (2 batches x 2 trait blocks);
                  one gwas_dot and one t-mode compaction launch per cell
  cross           the same cohort on the dense engine (a torch.matmul GEMM):
                  same hits outside a +/-0.05 band, values within the fused
                  oracle tolerances, lambda_gc within 1e-3
  identities      1,024 markers at full N and P: sparse == dense epilogue,
                  blocked == unblocked trait grid, packed == dense staging
  lmm_scan        the mixed-model path: ``gwas scan --engine lmm
                  --lmm-epilogue fused`` on a structured cohort at the same
                  width (N=23,000, P=2,048, 12 covariates, M=8,192), delta
                  pinned at (1-h2)/h2; streamed GRM, eigendecomposition and
                  rotation times; one screen launch per cell; every planted
                  effect must be a hit
  lmm_identities  N=4,096, M=2,048 in 2 PLINK shards, P=512, REML and LOCO:
                  fused sparse == fused dense-audit (the tstat kernel),
                  blocked == unblocked, packed == dense staging, bitwise; the
                  fused epilogue vs the dense one at the oracle tolerances
  cli             ``python -m repro_torch.launch.gwas scan`` with
                  ``--engine fused``, and ``--engine lmm --lmm-epilogue fused
                  --loco`` on a split fileset, on a small cohort; KING kinship
                  on the card vs the CPU

Each path's launch counts are set to 0 just before it runs and read just
after.  Then come a ``kernels`` JSON line, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without a CUDA device it exits 1 and prints no result.

    python3 chip_smoke.py --only build,kernel

runs the device phase and the named phases among ``build``, ``kernel`` and
``kernel_tstat`` only (a quick check of the kernels); it prints neither the
``kernels`` line nor the ``ok`` line.
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

# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, TF32 and bf16 on them, and HBM3 bandwidth.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
HIT_BAND = 0.05
DEVICE = "cuda:0"
KERNEL_SHAPES = (("cell", (4096, 23000, 1024)), ("ragged", (1000, 1003, 300)))
# The gwas_dot loop's edges: (label, M, N, P, block_n).  P=301: rows of y not
# 16-byte aligned (4-byte copies, scalar stores); block_n 64 and 36: the
# per-code decode (block_n/4 is not a multiple of the 32-sample step), and
# with 36, N_pad=468 is 14.6 steps: the last step is partial and the 15
# steps end inside a 64-sample chunk; the last: M and P under one 128 x 128
# tile.  Each also has an all-missing row.
KERNEL_EDGES = (("p301", 300, 1003, 301, 512), ("bn64", 200, 700, 64, 64),
                ("bn36", 130, 460, 40, 36), ("small", 5, 77, 3, 512))
# the bitwise split checks at the cell: column and row prefixes
SPLIT_P, SPLIT_M = 512, 2048
# the scan cohort: the paper workload's width (configs/gwas_ukb.py: 23,000
# samples, 12 covariates; 20,480 traits cut to 2,048), depth cut to 8,192
# markers in two batches, traits in two blocks
SCAN = dict(n_samples=23000, n_markers=8192, n_traits=2048, n_covariates=12,
            n_causal=32, effect_size=0.06, batch_markers=4096, trait_block=1024)
IDENTITY_MARKERS = 1024
# fused-engine oracle tolerances (tests/test_oracle.py): r, t (rel, abs),
# nlp (rel, abs)
FUSED_TOL = (5e-5, (5e-4, 5e-4), (5e-3, 1e-2))
# the mixed-model scan: a structured cohort at the same width; delta pinned
# at (1 - h2) / h2 (REML is host numpy and would dominate the phase).  With
# N > M every marker lies in the GRM's range, where the background's
# variance is h2 * N / M + 1 - h2 = 1.72, so a planted effect b has a GLS t
# near b * sqrt(N / 1.72) = 116 b: 0.06 gives t ~ 6.9, and ~8% of the 32
# effects fall under the 7.301 threshold (t ~ 5.5); 0.09 gives t ~ 10.4.
LMM_SCAN = dict(n_samples=23000, n_markers=8192, n_traits=2048, n_covariates=12,
                h2=0.4, n_causal=32, effect_size=0.09, batch_markers=4096,
                trait_block=1024, delta=1.5)
LMM_IDENT = dict(n_samples=4096, n_markers=2048, n_shards=2, n_traits=512,
                 n_covariates=12, batch_markers=1024, trait_block=256)
# fused vs dense lmm epilogue (tests/test_oracle.py): the same r, t within
# 1e-4 and nlp within 1e-3, absolute
LMM_EPILOGUE_TOL = (0.0, (0.0, 1e-4), (0.0, 1e-3))
TSTAT_SHAPES = (("cell", (4096, 1024)), ("ragged", (1000, 300)))
TSTAT_CAPACITY = 4096
# elements per tile of the compaction kernel (csrc/tstat.cu); one 8-byte
# status word per tile
COMPACT_TILE = 4096
# the synchronizing-op census: the lmm step's sample count (its rotation is
# N x N; the epilogue's ops do not depend on N)
SYNC_LMM_SAMPLES = 4096
T_RTOL = 2e-6


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 3, inner: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``inner`` back-to-back calls
    of ``fn``, per call, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_ms(fn, inner: int = 20, reps: int = 3):
    """The card's time per call of ``fn``: ``inner`` calls captured in one
    CUDA graph on a side stream (after a warm-up there: the compaction keeps
    its workspace per stream), the graph replayed (``cuda_ms``).  A replay
    skips the host's work per call, which sets the rate of back-to-back
    calls for these small kernels.  Returns (ms, the last captured call's
    output after the timed replays)."""
    import torch

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(inner):
            out = fn()
    ms = cuda_ms(graph.replay, reps=reps) / inner
    torch.cuda.synchronize()
    return ms, out


def bytes_bound(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def reset_launches() -> None:
    from repro_torch.kernels import tstat as ts
    from repro_torch.kernels.gwas_dot import gwas_dot as gd

    gd.launches = 0
    ts.tstat_launches = 0
    ts.screen_launches = 0
    ts.compact_launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import tstat as ts
    from repro_torch.kernels.gwas_dot import gwas_dot as gd

    return {"gwas_dot": gd.launches, "tstat": ts.tstat_launches,
            "screen_compact": ts.screen_launches, "compact_survivors": ts.compact_launches}


def gwas_dot_bound(m: int, n: int, p: int, packed_bytes: int, dtype: str) -> tuple[float, str]:
    """Least time for one gwas_dot call: each input read once (packed codes,
    mean, inv_std, y), each output written once (r, t), against the product's
    2*M*N*P FLOP on the tensor cores: three TF32 passes in fp32 mode (one
    TF32 product cannot hold r to 2e-6), one bf16 pass in bf16 mode."""
    nbytes = packed_bytes + 8 * m + 4 * n * p + 8 * m * p
    flops = 2.0 * m * n * p
    if dtype == "fp32":
        return bytes_bound(nbytes, 3 * flops, TF32_FLOPS)
    return bytes_bound(nbytes, flops, BF16_FLOPS)


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
            if "registers" in ln or "spill" in ln or "entry function" in ln]
        for s in sources
    }
    # gwas_dot runs on the tensor cores: its SASS must hold HMMA instructions
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", libs["gwas_dot"]], capture_output=True,
                          text=True, check=True).stdout
    hmma = sum(1 for ln in sass.splitlines() if "HMMA" in ln)
    emit({"phase": "build", "sources": sources, "wall_s": wall,
          "nvcc_s": {s: build.build_info[s]["seconds"] for s in sources},
          "libs": {s: os.path.relpath(p, HERE) for s, p in libs.items()}, "ptxas": ptxas,
          "gwas_dot_hmma": hmma})
    check(hmma > 0, "the gwas_dot library holds no HMMA (tensor-core) instruction")


def _kernel_inputs(m, n, p, block_n, seed, missing_row=False):
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
    if missing_row:
        codes[-1] = 1
        mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    dev = torch.device(DEVICE)
    return (
        torch.from_numpy(ops.pack_tiled(codes, block_n)).to(dev),
        torch.from_numpy(mean).to(dev),
        torch.from_numpy(inv_std).to(dev),
        torch.from_numpy(y).to(dev),
    )


def _hold_gwas_dot(label, packed, mean, inv_std, y, n, block_n, dtype):
    """One kernel call against the plain version on the same inputs: r within
    2e-6 (fp32) or 5e-3 (bf16), and in fp32 t within the r tolerance carried
    through t = r sqrt(dof / (1 - r^2)).  Returns the outputs and errors."""
    import torch

    from repro_torch.kernels.gwas_dot import gwas_dot as gd
    from repro_torch.kernels.gwas_dot import ref

    p = y.shape[1]
    dof = n - 2
    y_pad = torch.cat([y, y.new_zeros((packed.shape[1] * 4 - n, p))])
    r, t = gd.gwas_dot_fused(packed, mean, inv_std, y, n_samples=n, dof=dof,
                             block_n=block_n, input_dtype=dtype)
    r0, t0 = ref.gwas_dot_ref(ref.unpack_tiled(packed, block_n), mean, inv_std, y_pad,
                              n_samples=n, dof=dof, input_dtype=dtype)
    check(bool(torch.isfinite(r).all() and torch.isfinite(t).all()),
          f"gwas_dot {label} {dtype}: non-finite output")
    r_err = float((r - r0).abs().max())
    t_err = float((t - t0).abs().max())
    r_tol = 2e-6 if dtype == "fp32" else 5e-3
    check(r_err <= r_tol, f"gwas_dot {label} {dtype}: |dr|={r_err} > {r_tol}")
    t_tol = None
    if dtype == "fp32":
        # The r tolerance carried through t = r sqrt(dof / (1 - r^2)):
        # dt/dr = sqrt(dof) / (1 - r^2)^1.5, i.e. 2e-6 sqrt(dof) at r ~ 0
        # (~3e-4 at N = 23,000), plus 2e-6 |t| for the epilogue's own rounding.
        slope = math.sqrt(dof) / torch.clamp(1 - r0 * r0, min=1e-6) ** 1.5
        excess = (t - t0).abs() - (r_tol * slope + r_tol * t0.abs())
        t_tol = 2e-6 * math.sqrt(dof)
        check(float(excess.max()) <= 0.0,
              f"gwas_dot {label} {dtype}: |dt|={t_err} past the propagated r tolerance")
    return (r, t), {"r_max_abs_err": r_err, "t_max_abs_err": t_err, "r_tol": r_tol,
                    "t_tol": t_tol}


def _split_bitwise(packed, mean, inv_std, y, n, block_n, dtype, whole) -> None:
    """Columns 0..SPLIT_P-1 of the whole call equal a call on those columns,
    rows 0..SPLIT_M-1 a call on those rows, byte for byte: each output's sum
    runs in one order whatever the shape."""
    import torch

    from repro_torch.kernels.gwas_dot import gwas_dot as gd

    kw = dict(n_samples=n, dof=n - 2, block_n=block_n, input_dtype=dtype)
    r, t = whole
    rc, tc = gd.gwas_dot_fused(packed, mean, inv_std, y[:, :SPLIT_P].contiguous(), **kw)
    rm, tm = gd.gwas_dot_fused(packed[:SPLIT_M], mean[:SPLIT_M], inv_std[:SPLIT_M], y, **kw)
    check(torch.equal(rc, r[:, :SPLIT_P]) and torch.equal(tc, t[:, :SPLIT_P]),
          f"gwas_dot {dtype}: the first {SPLIT_P} columns differ from the whole call")
    check(torch.equal(rm, r[:SPLIT_M]) and torch.equal(tm, t[:SPLIT_M]),
          f"gwas_dot {dtype}: the first {SPLIT_M} rows differ from the whole call")


def phase_kernel() -> dict:
    import torch

    from repro_torch.kernels.gwas_dot import gwas_dot as gd
    from repro_torch.kernels.gwas_dot import ref

    block_n = 512
    main = None
    for label, (m, n, p) in KERNEL_SHAPES:
        packed, mean, inv_std, y = _kernel_inputs(m, n, p, block_n, seed=m + n + p)
        dof = n - 2
        n_pad = packed.shape[1] * 4
        y_pad = torch.cat([y, y.new_zeros((n_pad - n, p))])
        g = ref.decode_standardize_ref(ref.unpack_tiled(packed, block_n), mean, inv_std)
        for dtype in ("fp32", "bf16"):
            def kernel():
                return gd.gwas_dot_fused(packed, mean, inv_std, y, n_samples=n, dof=dof,
                                         block_n=block_n, input_dtype=dtype)

            def plain():
                return ref.gwas_dot_ref(ref.unpack_tiled(packed, block_n), mean, inv_std,
                                        y_pad, n_samples=n, dof=dof, input_dtype=dtype)

            whole, errs = _hold_gwas_dot(label, packed, mean, inv_std, y, n, block_n, dtype)
            if label == "cell":
                _split_bitwise(packed, mean, inv_std, y, n, block_n, dtype, whole)
            del whole
            # the yardstick: one PyTorch GEMM of the same (decoded) operands
            lib_a, lib_b = ((g, y_pad) if dtype == "fp32"
                            else (g.to(torch.bfloat16), y_pad.to(torch.bfloat16)))
            bound_ms, bound_by = gwas_dot_bound(m, n, p, packed.numel(), dtype)
            row = {
                "shape": label, "m": m, "n": n, "p": p, "dtype": dtype, **errs,
                "kernel_ms": cuda_ms(kernel),
                "plain_ms": cuda_ms(plain),
                "library_ms": cuda_ms(lambda: torch.matmul(lib_a, lib_b)),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            if label == "cell":
                row["split_bitwise"] = {f"p{SPLIT_P}": True, f"m{SPLIT_M}": True}
            if dtype == "fp32":
                # why the plain version sums in float64: the fp32 GEMM's own
                # r error against that sum, beside the kernel's r_max_abs_err
                r_lib = torch.clamp(torch.matmul(lib_a, lib_b) / float(n), -1.0, 1.0)
                row["library_r_max_abs_err"] = float((r_lib - plain()[0]).abs().max())
                del r_lib
            del lib_a, lib_b
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            emit({"phase": "kernel", **row})
            if label == "cell" and dtype == "fp32":
                main = row
        del packed, mean, inv_std, y, y_pad, g
        torch.cuda.empty_cache()
    for label, m, n, p, block_n in KERNEL_EDGES:
        inputs = _kernel_inputs(m, n, p, block_n, seed=m + n + p, missing_row=True)
        for dtype in ("fp32", "bf16"):
            (r, t), errs = _hold_gwas_dot(label, *inputs, n, block_n, dtype)
            check(bool((r[-1] == 0).all() and (t[-1] == 0).all()),
                  f"gwas_dot {label} {dtype}: the all-missing row is not 0")
            emit({"phase": "kernel", "shape": label, "m": m, "n": n, "p": p,
                  "block_n": block_n, "dtype": dtype, **errs})
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
    """Plan, prepare and stream one scan; returns (collector, summary, timing).
    The launch counts are the scan's own: set to 0 after the prepare (the
    lmm setup runs no kernel of this repo) and read when the stream ends."""
    from repro_torch.api import TsvWriter

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
    reset_launches()
    t0 = time.perf_counter()
    summary = session.stream_to(*writers)
    wall = time.perf_counter() - t0
    launches = read_launches()
    metrics = session.metrics.summary()
    info = session.lmm_info
    lmm = None if info is None else {
        **{f"{k}_s": v for k, v in info["setup_s"].items()},
        "scopes": info["scopes"], "loco": info["loco"],
        "delta": ({str(k): float(v) for k, v in info["delta"].items()}
                  if isinstance(info["delta"], dict) else float(info["delta"])),
        "dof": session.dof,
    }
    return col, summary, {
        "prepare_s": prepare_s, "wall_s": wall, "launches": launches,
        "step_s": metrics["step_s"], "extract_s": metrics["extract_s"],
        "decode_s": metrics["decode_s"], "cells": cells,
        "grid": [session.n_batches, session.n_trait_blocks],
        "genotype_staging": session.prepared.ctx.genotype_staging,
        **({"lmm": lmm} if lmm else {}),
    }


def _compare(a: Collect, b: Collect, threshold: float, tol=FUSED_TOL) -> dict:
    """Same hit set outside the +/-band around the threshold, values within
    ``tol`` = (r, t (rel, abs), nlp (rel, abs)), lambda_gc within 1e-3."""
    import numpy as np

    tol_r, tol_t, tol_nlp = tol

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
        check(abs(ra - rb) <= tol_r, f"hit {k}: r {ra} vs {rb}")
        check(abs(tva - tvb) <= tol_t[1] + tol_t[0] * abs(tvb), f"hit {k}: t {tva} vs {tvb}")
        check(abs(na - nb) <= tol_nlp[1] + tol_nlp[0] * abs(nb), f"hit {k}: nlp {na} vs {nb}")
    bn_a, bn_b = a.best.best_nlp, b.best.best_nlp
    best_dn = float(np.max(np.abs(bn_a - bn_b)))
    check(bool(np.all(np.abs(bn_a - bn_b) <= tol_nlp[1] + tol_nlp[0] * np.abs(bn_b))),
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
    cells = timing["grid"][0] * timing["grid"][1]
    for name in ("gwas_dot", "compact_survivors"):
        check(timing["launches"][name] == cells,
              f"the fused scan launched {name} {timing['launches'][name]} times, "
              f"not once per cell ({cells})")
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
        check(timing["launches"]["gwas_dot"] > 0, f"identities/{name}: kernel not launched")
        check((timing["launches"]["compact_survivors"] > 0) == (name != "dense_epilogue"),
              f"identities/{name}: compact_survivors launched "
              f"{timing['launches']['compact_survivors']} times")
        canon[name] = col.canonical()
    result = _bitwise(canon, "sparse", ("dense_epilogue", "blocked", "dense_staging"))
    emit({"phase": "identities", "markers": m, "hits": int(len(canon["sparse"]["hits"])),
          **result})


def _bitwise(canon: dict, base_name: str, others) -> dict:
    """Every emitted array of each run in ``others`` equals ``base_name``'s,
    bit for bit."""
    import numpy as np

    base = canon[base_name]
    result = {}
    for name in others:
        other = canon[name]
        check(base.keys() == other.keys(), f"{name}: emitted fields differ")
        bad = [k for k in base if not (base[k].dtype == other[k].dtype
                                       and np.array_equal(base[k], other[k]))]
        check(not bad, f"{base_name} vs {name}: not bitwise equal in {bad}")
        result[name] = "bitwise equal"
    return result


def _tstat_inputs(m: int, p: int, dof: float, seed: int):
    """Correlations as a mixed-model cell gives them (r ~ N(0, 1/dof) under
    the null), a band of strong rows so the screen has survivors past the
    buffer's capacity, and the clip edges."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    r = rng.normal(scale=1.0 / math.sqrt(dof), size=(m, p)).astype(np.float32)
    k = min(32, m)
    r[:k] = rng.normal(scale=8.0 / math.sqrt(dof), size=(k, p)).astype(np.float32)
    r[0, :4] = [1.0, -1.0, 0.0, 0.99999]
    return torch.from_numpy(r).to(DEVICE)


def _hold_compaction(label: str, r, dof: float, t2: float, capacity: int) -> dict:
    """Both entries of the screen kernel against their plain versions on the
    same inputs: t bitwise equal to the tstat kernel's, idx and count
    exactly equal, in r mode against the whole plain version and in t mode
    against the plain compaction of the same t."""
    import torch

    from repro_torch.kernels import tstat as ts

    t, idx, cnt = ts.screen_compact(r, dof, t2, capacity)
    _, idx0, cnt0 = ts.screen_compact_plain(r, dof, t2, capacity)
    idx_t, cnt_t = ts.compact_survivors(t, t2, capacity)
    idx_t0, cnt_t0 = ts.compact_survivors_plain(t, t2, capacity)
    torch.cuda.synchronize()
    check(torch.equal(t.view(torch.int32), ts.tstat(r, dof).view(torch.int32)),
          f"screen {label}: t differs from the tstat kernel's bit for bit")
    check(torch.equal(idx, idx0) and int(cnt) == int(cnt0),
          f"screen {label}: idx/count differ from the plain version ({int(cnt)} vs {int(cnt0)})")
    check(torch.equal(idx_t, idx_t0) and int(cnt_t) == int(cnt_t0),
          f"compact_survivors {label}: idx/count differ from the plain version "
          f"({int(cnt_t)} vs {int(cnt_t0)})")
    check(torch.equal(idx_t, idx) and int(cnt_t) == int(cnt),
          f"{label}: the two entries disagree on the same t")
    idx_err = max([0] + [int((a - b).abs().max()) for a, b in ((idx, idx0), (idx_t, idx_t0))
                         if a.numel()])
    return {"survivors": int(cnt), "capacity": capacity, "idx_max_abs_err": idx_err}


def _syncs_in(fn) -> dict:
    """Run ``fn`` once under torch.cuda.set_sync_debug_mode("warn"): each
    synchronizing op's innermost line in this repo's ``src/``, with its
    count."""
    import traceback
    import warnings
    from collections import Counter

    import torch

    src = os.path.join(HERE, "src") + os.sep
    found: Counter = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack() if f.filename.startswith(src)]
        where = ours[-1] if ours else None
        found[f"{os.path.relpath(where.filename, HERE)}:{where.lineno}" if where
              else f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(sorted(found.items()))


def _sync_census(dof: float, t2: float) -> dict:
    """The compaction's entries and the sparse epilogue under sync-debug
    "error" (none may wait for the host), then the synchronizing ops left
    in one fused step at the scan cell and one lmm step (prolog + cell,
    then the cell alone), both with the sparse epilogue."""
    import torch

    from repro_torch.core.association import AssocOptions, SparseEpilogue, sparse_epilogue_outputs
    from repro_torch.core.engines import build_fused_step, build_lmm_step
    from repro_torch.kernels import tstat as ts

    r = _tstat_inputs(4096, 1024, dof, seed=99)
    t = ts.tstat(r, dof)
    plan = SparseEpilogue(7.301, t2, TSTAT_CAPACITY)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts.screen_compact(r, dof, t2, TSTAT_CAPACITY)
        ts.compact_survivors(t, t2, TSTAT_CAPACITY)
        sparse_epilogue_outputs(r, t, dof, plan)
        # the control: the plain compaction's torch.nonzero must raise here
        try:
            ts.compact_survivors_plain(t, t2, TSTAT_CAPACITY)
            control_raised = False
        except RuntimeError:
            control_raised = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(control_raised, "sync-debug 'error' mode let torch.nonzero through")
    control = _syncs_in(lambda: ts.compact_survivors_plain(t, t2, TSTAT_CAPACITY))
    check(bool(control), "the census found no synchronizing op in torch.nonzero")
    del r, t

    m, n, p = KERNEL_SHAPES[0][1]
    packed, mean, inv_std, y = _kernel_inputs(m, n, p, 512, seed=7)
    valid = torch.ones(m, dtype=torch.bool, device=DEVICE)
    fused = build_fused_step(n_samples=n, n_covariates=SCAN["n_covariates"],
                             options=AssocOptions(), sparse_epilogue=True)
    args = (packed, mean.reshape(-1, 1), inv_std.reshape(-1, 1), valid, y)
    fused(*args)                       # builds and warms up outside the census
    steps = {"fused_step": _syncs_in(lambda: fused(*args))}
    del packed, mean, inv_std, y, args

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    nl = SYNC_LMM_SAMPLES
    g_raw = torch.randint(0, 3, (m, nl), generator=gen, device=DEVICE).to(torch.float32)
    rotation = torch.eye(nl, device=DEVICE)
    qhat = torch.linalg.qr(torch.randn(nl, SCAN["n_covariates"] + 1, generator=gen,
                                       device=DEVICE))[0]
    y_std = torch.randn(nl, p, generator=gen, device=DEVICE)
    lmm = build_lmm_step(n_samples=nl, n_covariates=SCAN["n_covariates"],
                         options=AssocOptions(), epilogue="fused", sparse_epilogue=True)
    lmm(g_raw.clone(), rotation, qhat, y_std)   # warm-up on another staged tensor
    steps["lmm_step"] = _syncs_in(lambda: lmm(g_raw, rotation, qhat, y_std))
    steps["lmm_cell"] = _syncs_in(lambda: lmm(g_raw, rotation, qhat, y_std))
    return {"error_mode": ["screen_compact", "compact_survivors", "sparse_epilogue_outputs"],
            "synchronizing_ops": {"control_compact_survivors_plain": control, **steps}}


def phase_kernel_tstat() -> dict:
    """Kernel 2 and both entries of kernel 3 against their plain versions:
    t at rtol 2e-6 (and bitwise between tstat and the screen), the
    compacted indices and the count exactly.  ``ms`` is per call of the
    whole wrapper, 20 calls back to back (r stays in L2, as it does after
    the correlation GEMM that produces it); ``device_ms`` the same 20 calls
    replayed from a CUDA graph, without the host's work per call."""
    import torch

    from repro_torch.core.stats import t2_screen_threshold
    from repro_torch.kernels import tstat as ts

    dof = float(LMM_SCAN["n_samples"] - 2 - LMM_SCAN["n_covariates"])
    t2 = t2_screen_threshold(7.301, dof)
    rows = {}
    for label, (m, p) in TSTAT_SHAPES:
        r = _tstat_inputs(m, p, dof, seed=m + p)
        n = m * p
        t = ts.tstat(r, dof)
        t0 = ts.tstat_plain(r, dof)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(t).all()), f"tstat {label}: non-finite t")
        excess = (t - t0).abs() - T_RTOL * t0.abs()
        check(float(excess.max()) <= 0.0, f"tstat {label}: t past rtol {T_RTOL}")
        held = _hold_compaction(label, r, dof, t2, TSTAT_CAPACITY)
        check(held["survivors"] > TSTAT_CAPACITY or label != "cell",
              f"screen {label}: {held['survivors']} survivors do not overflow the buffer")
        tiles = -(-n // COMPACT_TILE)
        slots = 4 * TSTAT_CAPACITY + 8 * tiles
        # flops per element: t ~6 (mul, sub, max, div, rsqrt, mul), the
        # screen 2 more (square, compare)
        for name, kernel, plain, nbytes, flops in (
            ("tstat", lambda: ts.tstat(r, dof), lambda: ts.tstat_plain(r, dof), 8 * n, 6 * n),
            ("screen_compact", lambda: ts.screen_compact(r, dof, t2, TSTAT_CAPACITY),
             lambda: ts.screen_compact_plain(r, dof, t2, TSTAT_CAPACITY), 8 * n + slots, 8 * n),
            ("compact_survivors", lambda: ts.compact_survivors(t, t2, TSTAT_CAPACITY),
             lambda: ts.compact_survivors_plain(t, t2, TSTAT_CAPACITY), 4 * n + slots, 2 * n),
        ):
            bound_ms, bound_by = bytes_bound(nbytes, float(flops))
            device_ms, replayed = graph_ms(kernel)
            # the graph's replays wrote the same results as the calls above
            if name == "tstat":
                check(torch.equal(replayed, t), f"tstat {label}: the replayed t differs")
            else:
                want = plain()[-2:]
                check(torch.equal(replayed[-2], want[0]) and int(replayed[-1]) == int(want[1]),
                      f"{name} {label}: the replayed idx/count differ from the plain version")
            row = {
                "kernel": name, "shape": label, "m": m, "p": p,
                "max_abs_err": (float((t - t0).abs().max()) if name != "compact_survivors"
                                else float(held["idx_max_abs_err"])),
                "ms": cuda_ms(kernel, inner=20), "plain_ms": cuda_ms(plain, inner=20),
                "device_ms": device_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                "library_ms": None,
            }
            if name != "tstat":
                row.update(held)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
            emit({"phase": "kernel_tstat", **row})
            if label == "cell":
                rows[name] = row
        del r, t, t0
    # the compaction's edges: no survivors, all survivors (overflow), NaN r
    # with a capacity above the tile's size, and an empty tile
    m, p = TSTAT_SHAPES[1][1]
    nan_r = _tstat_inputs(37, 53, dof, seed=5)
    nan_r.view(-1)[::7] = float("nan")
    edges = {
        "none": torch.zeros((m, p), device=DEVICE),
        "all": torch.full((m, p), 0.5, device=DEVICE),
        "nan_above_capacity": nan_r,
        "empty": torch.zeros((0, p), device=DEVICE),
    }
    held = {k: _hold_compaction(k, r, dof, t2, TSTAT_CAPACITY) for k, r in edges.items()}
    check(held["none"]["survivors"] == 0 and held["all"]["survivors"] == m * p
          and held["empty"]["survivors"] == 0, f"edge survivor counts {held}")
    emit({"phase": "kernel_tstat", "edges": held, **_sync_census(dof, t2)})
    return rows


def phase_lmm_scan(tmp: str) -> dict:
    """The mixed-model path at the paper workload's width, through the
    entry points a user calls; every planted effect must be a hit."""
    import numpy as np

    from repro_torch.api import GridSpec, LmmSpec, Study
    from repro_torch.io import PlinkBed, synth
    from repro_torch.io.plink import write_plink

    cfg = LMM_SCAN
    t0 = time.perf_counter()
    cohort = synth.make_structured_cohort(
        n_samples=cfg["n_samples"], n_markers=cfg["n_markers"], n_traits=cfg["n_traits"],
        n_covariates=cfg["n_covariates"], h2=cfg["h2"], n_causal=cfg["n_causal"],
        effect_size=cfg["effect_size"], seed=2026,
    )
    bed = write_plink(os.path.join(tmp, "lmm"), cohort.dosages, sample_ids=cohort.sample_ids)
    setup_s = time.perf_counter() - t0
    study = Study.from_arrays(PlinkBed(bed), cohort.phenotypes, cohort.covariates)
    out = os.path.join(tmp, "lmm_out")
    col, summary, timing = _run(
        study, out, engine="lmm", lmm=LmmSpec(epilogue="fused", delta=cfg["delta"]),
        grid=GridSpec(batch_markers=cfg["batch_markers"], trait_block=cfg["trait_block"]),
    )
    cells = timing["grid"][0] * timing["grid"][1]
    check(timing["launches"]["screen_compact"] == cells,
          f"the lmm scan launched the screen kernel {timing['launches']['screen_compact']} "
          f"times, not once per cell ({cells})")
    check(timing["launches"]["compact_survivors"] == 0,
          "the lmm scan compacted outside the screen kernel")
    hits, stats = col.hits()
    check(bool(np.isfinite(stats).all()), "non-finite hit statistics")
    planted = {(m, t) for m, t, _ in cohort.effects}
    missed = sorted(planted - {tuple(h) for h in hits.tolist()})
    check(not missed, f"planted effects missing from the lmm hits: {missed}")
    planted_t = [abs(float(st[1])) for h, st in zip(hits.tolist(), stats)
                 if tuple(h) in planted]
    with open(os.path.join(out, "hits.tsv")) as f:
        tsv_rows = sum(1 for _ in f) - 1
    check(tsv_rows == len(hits), f"hits.tsv has {tsv_rows} rows, the stream {len(hits)}")
    emit({"phase": "lmm_scan", **cfg, "cohort_setup_s": setup_s, **timing,
          "hits": len(hits), "planted": len(planted), "planted_abs_t": {
              "min": min(planted_t), "median": statistics.median(planted_t)},
          "lambda_gc": summary["lambda_gc"]})
    return timing


def phase_lmm_identities(tmp: str) -> dict:
    """The port's bitwise identities on the mixed-model path (REML, LOCO over
    two shards), and the fused epilogue against the dense one."""
    from repro_torch.api import GridSpec, IOSpec, LmmSpec, Study
    from repro_torch.io import open_genotypes, synth

    cfg = LMM_IDENT
    cohort = synth.make_structured_cohort(
        n_samples=cfg["n_samples"], n_markers=cfg["n_markers"], n_traits=cfg["n_traits"],
        n_covariates=cfg["n_covariates"], h2=0.4, n_causal=16, effect_size=0.1, seed=7,
    )
    beds = synth.write_split_plink(cohort, os.path.join(tmp, "ident"), n_shards=cfg["n_shards"])
    study = Study.from_arrays(open_genotypes(",".join(beds)), cohort.phenotypes,
                              cohort.covariates)
    fused = LmmSpec(epilogue="fused", loco=True)
    grid = GridSpec(batch_markers=cfg["batch_markers"], trait_block=cfg["trait_block"])
    runs = {
        "sparse": dict(lmm=fused, grid=grid),
        "dense_audit": dict(lmm=fused, grid=grid, sparse_epilogue=False),
        "unblocked": dict(lmm=fused, grid=GridSpec(batch_markers=cfg["batch_markers"])),
        "dense_staging": dict(lmm=fused, grid=grid, io=IOSpec(genotype_staging="dense")),
        "dense_epilogue": dict(lmm=LmmSpec(epilogue="dense", loco=True), grid=grid),
    }
    cols, canon, launches, info = {}, {}, {}, {}
    for name, kw in runs.items():
        col, _, timing = _run(study, None, engine="lmm", **kw)
        cols[name], canon[name], launches[name] = col, col.canonical(), timing["launches"]
        info[name] = {"wall_s": timing["wall_s"], "prepare_s": timing["prepare_s"],
                      **timing["lmm"]}
    check(launches["sparse"]["screen_compact"] > 0, "the sparse run never launched the screen")
    check(launches["dense_audit"]["tstat"] > 0, "the dense-audit run never launched tstat")
    check(launches["dense_epilogue"]["tstat"] + launches["dense_epilogue"]["screen_compact"]
          == 0, "the dense epilogue launched a t-statistic kernel")
    result = _bitwise(canon, "sparse", ("dense_audit", "unblocked", "dense_staging"))
    cmp = _compare(cols["sparse"], cols["dense_epilogue"], threshold=7.301,
                   tol=LMM_EPILOGUE_TOL)
    emit({"phase": "lmm_identities", **cfg, "hits": int(len(canon["sparse"]["hits"])),
          **result, "fused_vs_dense_epilogue": cmp, "launches": launches, "runs": info})
    return launches["dense_audit"]


def _cli(work: str, out: str, genotypes: str, files: dict, *flags) -> tuple[dict, set, float]:
    """One ``repro_torch.launch.gwas scan`` subprocess; (summary, hit keys, s)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gwas", "scan",
         "--genotypes", genotypes, "--pheno", files["pheno"], "--covar", files["cov"],
         "--out", os.path.join(work, out), "--batch-markers", "256", "--device", DEVICE,
         *flags],
        cwd=work, env=env, capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI scan {flags} failed ({proc.returncode}):\n"
          f"{proc.stderr[-3000:]}")
    with open(os.path.join(work, out, "summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(work, out, "hits.tsv")) as f:
        next(f)
        found = {tuple(line.split("\t")[:2]) for line in f}
    return summary, found, wall


def phase_cli(tmp: str) -> None:
    import numpy as np

    from repro_torch.core import kinship
    from repro_torch.io import synth
    from repro_torch.runtime.device import resolve_device

    work = os.path.join(tmp, "cli")
    os.makedirs(work)
    cohort = synth.make_cohort(n_samples=500, n_markers=1200, n_traits=10,
                               n_causal=6, effect_size=0.6, seed=11)
    files = synth.write_cohort_files(cohort, os.path.join(work, "cohort"))
    split = synth.write_split_plink(cohort, os.path.join(work, "cohort"), n_shards=3)
    planted = {(cohort.marker_ids[m], f"trait{t}") for m, t, _ in cohort.effects}
    row = {"phase": "cli"}
    for name, genotypes, flags in (
        ("fused", files["bed"], ("--engine", "fused")),
        ("lmm", ",".join(split), ("--engine", "lmm", "--lmm-epilogue", "fused", "--loco")),
    ):
        summary, found, wall = _cli(work, name, genotypes, files, *flags)
        check(planted <= found, f"CLI {name} missed planted effects {sorted(planted - found)}")
        check(summary["device"] == str(resolve_device(DEVICE)),
              f"CLI {name} ran on {summary['device']}")
        row[name] = {"wall_s": wall, "hits": summary["hits"], "lambda_gc": summary["lambda_gc"],
                     "device": summary["device"],
                     "genotype_staging": summary["genotype_staging"]}
        if name == "lmm":
            check(summary["lmm"]["scopes"] == 3 and summary["lmm"]["loco"],
                  f"CLI lmm summary {summary['lmm']}")
            row[name]["lmm"] = summary["lmm"]
    # KING kinship products on the card against the CPU (integer counts in
    # float32: exact on both)
    rel = synth.make_cohort(n_samples=400, n_markers=2000, n_traits=2, n_related_pairs=5,
                            seed=5)
    phi = kinship.king_kinship(rel.dosages.T, device=DEVICE)
    phi_cpu = kinship.king_kinship(rel.dosages.T, device="cpu")
    check(np.array_equal(phi, phi_cpu), "KING kinship differs between the card and the CPU")
    keep = kinship.greedy_unrelated(phi)
    row["kinship"] = {"samples": 400, "excluded": int((~keep).sum()), "bitwise_vs_cpu": True}
    emit(row)


QUICK_PHASES = {"build": phase_build, "kernel": phase_kernel, "kernel_tstat": phase_kernel_tstat}


def main(argv: list[str]) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", help="comma-separated phases among "
                        f"{', '.join(QUICK_PHASES)}; skips the rest")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.runtime.device import resolve_device

    t_start = time.perf_counter()
    resolve_device(DEVICE)
    info, smi = phase_device()
    if args.only:
        names = args.only.split(",")
        unknown = sorted(set(names) - set(QUICK_PHASES))
        check(not unknown, f"--only takes {sorted(QUICK_PHASES)}, not {unknown}")
        for name in names:
            QUICK_PHASES[name]()
        emit({"phase": "done", "only": names, "total_s": time.perf_counter() - t_start})
        return 0
    phase_build()
    main_row = phase_kernel()
    tstat_rows = phase_kernel_tstat()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        study, cohort, fused, timing = phase_scan(tmp)
        phase_cross(study, fused)
        phase_identities(tmp, cohort)
        del study, cohort, fused
        lmm_timing = phase_lmm_scan(tmp)
        torch.cuda.empty_cache()
        audit_launches = phase_lmm_identities(tmp)
        phase_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = [{
        "name": "gwas_dot",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gwas_dot.cu",
        "replaces": "src/repro/kernels/gwas_dot/gwas_dot.py:35",
        "launches": timing["launches"]["gwas_dot"],
        "max_abs_err": main_row["r_max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    # tstat runs on the fused epilogue's dense-audit path, the screen on the
    # mixed-model scan's default (sparse) path, its t mode on the fused OLS
    # scan's sparse epilogue
    for name, replaces, launches in (
        ("screen_compact", "src/repro/kernels/tstat.py:65",
         lmm_timing["launches"]["screen_compact"]),
        ("compact_survivors", "src/repro/kernels/tstat.py:65",
         timing["launches"]["compact_survivors"]),
        ("tstat", "src/repro/kernels/tstat.py:19", audit_launches["tstat"]),
    ):
        row = tstat_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/tstat.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
