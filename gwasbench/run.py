"""Run one cell of the port's benchmark once and print its result line.

    python3 gwasbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (``BENCHMARK.json``), each read by
``gwasbench/metrics/<name>.py``.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` when traced, and ``checks`` last: each number compared with its
limit); the last lines of standard error repeat the checks.  Exits non-zero,
printing no result, without enough CUDA cards, or when ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` was imported.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# Every build and kernel cache inside the checkout, at fixed paths.  The
# port's nvcc builds go to src/repro_torch/kernels/_build/ by itself.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, os.path.join(ROOT, "build", "gwasbench-cache", sub))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port must not bring in
    (``repro_torch`` is a name of its own, not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def read_metric(name: str, run):
    """``gwasbench/metrics/<name>.py``'s ``read(run)``: a number, or None
    when the run has nothing to read it from."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gwasbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def metrics_for(bench: dict, workload: str, traced: bool, run) -> dict:
    out = {}
    for m in bench["per_layer" if traced else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = read_metric(m["name"], run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gwasbench import harness, trace

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gwasbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)

    def on_host(readings: dict) -> None:
        print(json.dumps({"host": readings}), flush=True)

    run, verdict = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                                    trace_on=bool(args.trace), t_process=T_PROCESS,
                                    on_host=on_host)
    found = forbidden_modules()
    if found:
        print(f"gwasbench: the run imported {found}", file=sys.stderr)
        return 3
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": int(run.peak_bytes),
    }
    result = {
        "correct": verdict.correct,
        "attempted": verdict.cells,
        "failed": verdict.failed_cells,
        "metrics": metrics_for(bench, args.workload, bool(args.trace), run),
        "device": device,
    }
    if run.trace is not None:
        device["busy_s"] = trace.busy_s(run.trace)
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(run.trace),
                               "idle_gaps": trace.idle_gaps(run.trace)}
    # a number that cannot be read (a cell without a reference lane) is inf;
    # strict JSON has no inf, so it is printed as the string "inf"
    checks = {k: {"value": v if math.isfinite(v) else str(v), "limit": verdict.limits[k]}
              for k, v in verdict.numbers.items()}
    result["checks"] = checks
    for k, v in verdict.numbers.items():
        ok = "ok" if v <= verdict.limits[k] else "FAIL"
        print(f"check {k} {v!r} limit {verdict.limits[k]!r} {ok}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
