"""Readings for the limits of ``correct``: one cell on many seeds in one
process, as the port runs it and as the control runs it (float32 products
in TF32, the nearest precision below the fp32 contract).  Not part of a
benchmark run.

    python3 gwasbench/readings.py --workload <cell> --seconds <s> \
        --seeds 11,12,... [--control-seeds 21,22,23] [--out FILE]

Prints one JSON line a run: the seed, the control (or null), every number
compared, ``correct`` under the configured limits, and the window's rate.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from gwasbench import harness

    cell = harness.load_cell(args.workload)
    plan = [(int(s), None) for s in args.seeds.split(",") if s]
    plan += [(int(s), "tf32") for s in args.control_seeds.split(",") if s]
    sink = open(args.out, "a") if args.out else None
    torch.cuda.init()
    try:
        for seed, control in plan:
            for i in range(cell.chips):
                torch.cuda.reset_peak_memory_stats(i)
            t = time.perf_counter()
            run, verdict = harness.run_cell(cell, seed=seed, seconds=args.seconds,
                                            trace_on=False, t_process=t, control=control)
            line = json.dumps({
                "seed": seed, "control": control, "correct": verdict.correct,
                "cells": verdict.cells, "failed": verdict.failed_cells,
                "numbers": verdict.numbers,
                "rate": run.window_tests / run.seconds if run.seconds else None,
                "setup_s": run.setup_s, "prepare_s": run.prepare_s,
                "peak_bytes": run.peak_bytes, "run_s": time.perf_counter() - t,
            })
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
