"""Time variants of the gwas_dot kernel against each other on one card.

    python3 experiments/gwas_dot_ab/ab.py VARIANTS.json [--source FILE] [--parent]

VARIANTS.json maps a name to a list of ``[old, new]`` text substitutions
applied to the source (``src/repro_torch/kernels/csrc/gwas_dot.cu``, or
``--source``), or to the path of a whole source file.  An entry named
``base`` is the comparison point.  Each variant is built by nvcc for
``sm_90a`` (all at once), run once at the scan cell (M=4096, N=23,000,
P=1,024, block_n 512) in both modes and compared with ``base`` (bitwise and
max |dr|), then timed in turns (every variant, then again in reverse
order), each timing the median of 5 CUDA-event timings of 5 back-to-back
calls.  Prints one JSON line per variant's build and per mode, then the
card's name and power limit.

``--parent`` calls the entry point of the earlier mma.sync kernel (no
scratch argument; its source is
``git show f0a2e5c:src/repro_torch/kernels/csrc/gwas_dot.cu``), for the
attribution of its time.  Variants are written to and built in
``build/gwas_dot_ab/`` (git-ignored).
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "src"))
OUT = os.path.join(ROOT, "build", "gwas_dot_ab")
CELL = (4096, 23000, 1024, 512)   # M, N, P, block_n


def build(name: str, spec, source: str) -> tuple[str, str | None, list]:
    text = open(source).read()
    if isinstance(spec, str):
        text = open(os.path.join(ROOT, spec)).read()
    else:
        for old, new in spec:
            if old not in text:
                raise ValueError(f"variant {name}: {old[:60]!r} is not in the source")
            text = text.replace(old, new)
    src = os.path.join(OUT, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"lib{name}.so")
    t0 = time.perf_counter()
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                           "-o", lib, src], capture_output=True, text=True)
    if proc.returncode:
        return name, None, [proc.stderr[-3000:]]
    notes = [ln.strip() for ln in proc.stderr.splitlines()
             if "spill" in ln or "wgmma" in ln or "setmaxnreg" in ln]
    return name, lib, [f"{time.perf_counter() - t0:.1f} s"] + notes


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.kernels.gwas_dot import ops, ref

    ap = argparse.ArgumentParser()
    ap.add_argument("variants")
    ap.add_argument("--source", default=os.path.join(ROOT, "src/repro_torch/kernels/csrc/gwas_dot.cu"))
    ap.add_argument("--parent", action="store_true")
    args = ap.parse_args()
    variants = json.load(open(args.variants))
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda kv: build(kv[0], kv[1], args.source), variants.items()))
    fns = {}
    for name, lib, notes in built:
        print(json.dumps({"variant": name, "built": lib is not None, "nvcc": notes}), flush=True)
        if lib is None:
            return 1
        fn = ctypes.CDLL(lib).gwas_dot_launch
        n_ptr = 6 if args.parent else 7
        n_int = 6 if args.parent else 5
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    m, n, p, bn = CELL
    rng = np.random.default_rng(1)
    codes = rng.choice([0, 1, 2, 3], p=[0.3, 0.02, 0.38, 0.3], size=(m, n)).astype(np.uint8)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    dev = torch.device("cuda")
    packed = torch.from_numpy(ops.pack_tiled(codes, bn)).to(dev)
    mean, inv_std = torch.from_numpy(mean).to(dev), torch.from_numpy(inv_std).to(dev)
    y = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32)).to(dev)
    r = torch.empty((m, p), device=dev)
    t = torch.empty((m, p), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    width = packed.shape[1]
    scratch = {}
    for mode in ("fp32", "bf16"):
        shape, dtype = ref.trait_operand_shape(p, width * 4, mode)
        scratch[mode] = torch.empty(shape, dtype=dtype, device=dev)

    def call(fn, mode):
        head = [packed.data_ptr(), mean.data_ptr(), inv_std.data_ptr(), y.data_ptr()]
        if args.parent:
            ints = [m, width * 4, p, n, width, bn]
        else:
            head.append(scratch[mode].data_ptr())
            ints = [m, p, n, width, bn]
        err = fn(*head, r.data_ptr(), t.data_ptr(), *ints, float(n), float(n - 2), 1e-12,
                 int(mode == "bf16"), stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")

    def ms(fn, mode, reps=5, inner=5):
        call(fn, mode)
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                call(fn, mode)
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / inner)
        return statistics.median(out)

    for mode in ("bf16", "fp32"):
        outs = {}
        for k, fn in fns.items():
            call(fn, mode)
            torch.cuda.synchronize()
            outs[k] = r.clone()
        base = outs.get("base", next(iter(outs.values())))
        times = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            times[k].append(ms(fns[k], mode))
        print(json.dumps({"mode": mode, "ms": times,
                          "bitwise_vs_base": {k: bool(torch.equal(v, base)) for k, v in outs.items()},
                          "max_dr_vs_base": {k: float((v - base).abs().max())
                                             for k, v in outs.items()}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
