"""TorchGWAS-equivalent command line for the PyTorch/CUDA port: a thin
subcommand shell over ``repro_torch.api``, with the reference CLI's flags
and output schema plus ``--device``.

    python -m repro_torch.launch.gwas scan \
        --genotypes cohort.bed --pheno panel.tsv --covar covars.tsv \
        --out results/ [--engine fused] [--multivariate] [--device cpu] \
        [--writer tsv,npz]

    python -m repro_torch.launch.gwas grm \
        --genotypes 'cohort_chr*.bed' --out results/grm.npz [--loco] \
        [--spectrum] [--device cpu]

    python -m repro_torch.launch.gwas merge \
        --checkpoint-dir ck/ --out results/ [--genotypes ... --pheno ...]

    python -m repro_torch.launch.gwas report --out results/ [--top 20]

    python -m repro_torch.launch.gwas serve \
        --genotypes cohort.bed --pheno panel.tsv --covar covars.tsv \
        [--engine fused] [--port 8080] [--ready-file ready.txt] [--device cpu]

``scan`` binds a Study, plans the grid, and streams the session's events
through result writers — hits land in sorted ``hits.tsv`` batch by batch,
per-trait best and per-marker QC follow at close, and ``summary.json``
records the run.  ``grm`` runs the streamed GRM pass standalone; ``merge``
turns a committed checkpoint directory into final outputs without
recomputing anything; ``report`` pretty-prints a results directory;
``serve`` keeps a cohort resident and answers phenotype-panel uploads and
marker-window queries over HTTP, each served table byte-identical to an
offline ``scan``.  ``scan``, ``grm`` and ``serve`` run on the CUDA card
unless ``--device cpu`` is given; ``merge`` and ``report`` only read files
on the host.  The flags-only invocation (no subcommand) means ``scan``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from repro_torch.core.association import AssocOptions
from repro_torch.core.engines import available_engines
from repro_torch.runtime import spans
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.workqueue import available_backends

SUBCOMMANDS = ("scan", "grm", "merge", "report", "serve")


# ------------------------------------------------------------------- scan


def build_scan_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.gwas scan", description=__doc__)
    ap.add_argument("--genotypes", required=True,
                    help=".bed / .bgen / .npy / .npz — one file, a glob "
                         "('cohort_chr*.bed'), or a comma-separated list")
    ap.add_argument("--pheno", required=True, help="phenotype table (FID IID trait...)")
    ap.add_argument("--covar", default=None, help="covariate table")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--writer", default="tsv",
                    help="comma list of result writers (see "
                         "repro_torch.api.available_writers()); default tsv")
    ap.add_argument("--engine", default="dense", choices=available_engines())
    ap.add_argument("--mode", default="mp", choices=["mp", "sample"])
    ap.add_argument("--dof-mode", default="paper", choices=["paper", "exact"])
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--input-dtype", default="fp32", choices=["fp32", "bf16"],
                    help="fused kernel GEMM input dtype (the epilogue stays "
                         "fp32 either way)")
    ap.add_argument("--batch-markers", type=int, default=8192)
    ap.add_argument("--trait-block", type=int, default=0,
                    help="tile the trait axis into blocks of this width "
                         "(2-D scan grid; 0 = unblocked; rounded up to a "
                         "multiple of the block-p compute tile).  Peak "
                         "device memory then scales with the block, not "
                         "the panel; results are bitwise-identical either "
                         "way")
    ap.add_argument("--block-p", type=int, default=256,
                    help="panel-axis compute tile: the fused kernel's p-tile "
                         "and the dense/lmm GEMM chunk; trait blocks align "
                         "to it")
    ap.add_argument("--panel-resident-blocks", type=int, default=4,
                    help="how many panel blocks the device LRU keeps staged")
    ap.add_argument("--hit-spill-rows", type=int, default=2_000_000,
                    help="spill buffered hit rows to npz parts under --out "
                         "once this many are resident in RAM")
    ex = ap.add_argument_group("multi-device executor")
    ex.add_argument("--devices", type=int, default=1,
                    help="executor slots draining the scan grid (0 = every "
                         "visible device; 1 = the serial walk).  Results "
                         "are bitwise-identical to a single-device scan")
    ex.add_argument("--placement", default="marker-major",
                    choices=["marker-major", "trait-major"],
                    help="cell placement: marker-major reuses each staged "
                         "genotype batch across its trait blocks, "
                         "trait-major keeps one panel block resident per "
                         "device while re-reading the genotype stream")
    ex.add_argument("--lease-batches", type=int, default=2,
                    help="work items leased per scheduler claim (work "
                         "stealing splits at marker-batch granularity)")
    ex.add_argument("--exec-backend", default="threads",
                    choices=sorted(available_backends()),
                    help="scheduler backend, one of: "
                         f"{', '.join(sorted(available_backends()))}.  "
                         "threads keeps the lease table in-process; "
                         "shared-fs puts it on the filesystem next to "
                         "--checkpoint-dir so N independent processes "
                         "(across hosts) drain one grid — run the same "
                         "command on each host")
    ex.add_argument("--host-id", default=None,
                    help="this process's identity in the shared-fs lease "
                         "table (default hostname-pid); must be unique per "
                         "live process")
    ex.add_argument("--slot-prefetch", type=int, default=1,
                    help="per-device look-ahead depth: claim and decode the "
                         "next marker batch while the current one computes "
                         "(0 = unpipelined worker; output is bitwise-"
                         "identical either way)")
    ex.add_argument("--autotune-lease", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink --lease-batches at runtime as the grid "
                         "drains (guided self-scheduling) and when workers "
                         "report high wait share; chosen values land in "
                         "summary.json under executor.autotune")
    ex.add_argument("--lease-ttl", type=float, default=60.0,
                    help="shared-fs heartbeat expiry in seconds: a lease "
                         "not refreshed for this long counts as a dead "
                         "host's and is stolen (safe either way — cells "
                         "are idempotent; this only tunes reclaim latency)")
    ap.add_argument("--progress", action="store_true",
                    help="live per-cell progress line on stderr (auto when "
                         "stderr is a tty)")
    ap.add_argument("--trace-spans", action="store_true",
                    help="record the scan's spans and counters (decode, step, "
                         "product, extract, refine, pulls, waits: see PERF.md) "
                         "into summary.json's metrics.spans")
    lmm = ap.add_argument_group("mixed model (--engine lmm)")
    lmm.add_argument("--loco", action="store_true",
                     help="leave-one-chromosome-out GRM (needs a multi-file fileset)")
    lmm.add_argument("--grm-method", default="std", choices=["std", "centered"])
    lmm.add_argument("--grm-batch-markers", type=int, default=4096)
    lmm.add_argument("--lmm-delta", type=float, default=None,
                     help="pin the variance ratio se^2/sg^2 (skip the REML fit)")
    lmm.add_argument("--lmm-epilogue", default="dense", choices=["dense", "fused"])
    ap.add_argument("--maf-min", type=float, default=0.0)
    ap.add_argument("--hit-threshold", type=float, default=7.301,
                    help="-log10 p threshold (default genome-wide 5e-8)")
    ap.add_argument("--no-sparse-epilogue", action="store_true",
                    help="compute the full dense -log10 p tile per cell "
                         "instead of the threshold-compacted sparse epilogue "
                         "(identical output, slower; for audits)")
    ap.add_argument("--hit-capacity", type=int, default=4096,
                    help="per-cell compacted hit-buffer slots; overflow "
                         "falls back to the dense pull for that cell")
    ap.add_argument("--exclude-related", action="store_true")
    ap.add_argument("--multivariate", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--io-workers", type=int, default=2)
    ap.add_argument("--genotype-staging", default="auto",
                    choices=["auto", "packed", "dense"],
                    help="H2D staging currency: 'packed' "
                         "stages raw 2-bit PLINK bytes with device-side "
                         "decode (~16x less transfer, bitwise-identical "
                         "output), 'dense' stages decoded float32; 'auto' "
                         "picks packed whenever the source supports it")
    ap.add_argument("--packed-cache-mb", type=int, default=256,
                    help="shared packed-slab host cache budget (scan, GRM, "
                         "and serve warm windows share one read per batch)")
    ap.add_argument("--device", default="cuda",
                    help="where the scan runs: cuda (default; an error when "
                         "no card is present), cuda:<i>, or cpu")
    return ap


# Historical entry point compatibility: the flags-only invocation parses
# with the scan parser.
build_parser = build_scan_parser


def cmd_scan(argv) -> None:
    from repro_torch.api import ExecSpec, GridSpec, IOSpec, LmmSpec, Study, get_writer

    args = build_scan_parser().parse_args(argv)
    if args.exec_backend != "threads" and not args.checkpoint_dir:
        raise SystemExit(
            f"--exec-backend {args.exec_backend} coordinates processes "
            "through the checkpoint directory (lease table + manifest); "
            "pass --checkpoint-dir (the SAME path on every host)"
        )
    os.makedirs(args.out, exist_ok=True)

    try:
        study = Study.from_files(
            args.genotypes, args.pheno, args.covar,
            exclude_related=args.exclude_related,
            device=args.device,
        )
    except ValueError as e:
        if "missing from the tables" in str(e):
            raise SystemExit(str(e)) from None
        raise
    plan = study.plan(
        engine=args.engine,
        grid=GridSpec(
            batch_markers=args.batch_markers,
            trait_block=args.trait_block,
            block_p=args.block_p,
            panel_resident_blocks=args.panel_resident_blocks,
        ),
        lmm=(
            LmmSpec(
                loco=args.loco,
                grm_method=args.grm_method,
                grm_batch_markers=args.grm_batch_markers,
                delta=args.lmm_delta,
                epilogue=args.lmm_epilogue,
            )
            if args.engine == "lmm" else None
        ),
        io=IOSpec(io_workers=args.io_workers, spill_dir=args.out,
                  hit_spill_rows=args.hit_spill_rows,
                  genotype_staging=args.genotype_staging,
                  packed_cache_mb=args.packed_cache_mb),
        executor=ExecSpec(devices=args.devices, placement=args.placement,
                          lease_batches=args.lease_batches,
                          slot_prefetch=args.slot_prefetch,
                          autotune_lease=args.autotune_lease,
                          backend=args.exec_backend, host_id=args.host_id,
                          lease_ttl=args.lease_ttl),
        options=AssocOptions(dof_mode=args.dof_mode, precision=args.precision),
        mode=args.mode,
        hit_threshold_nlp=args.hit_threshold,
        maf_min=args.maf_min,
        multivariate=args.multivariate,
        checkpoint_dir=args.checkpoint_dir,
        input_dtype=args.input_dtype,
        sparse_epilogue=not args.no_sparse_epilogue,
        hit_capacity=args.hit_capacity,
        device=args.device,
    )
    # Writers resolve BEFORE the expensive amortized prepare (GRM/REML for
    # lmm can take hours at scale; a typo'd --writer must fail in
    # milliseconds, not after it).
    writers = [
        get_writer(name)(args.out, spill_rows=args.hit_spill_rows)
        for name in args.writer.split(",") if name
    ]
    session = plan.run(resume=not args.no_resume)
    if args.progress or sys.stderr.isatty():
        # Live progress off the session metrics hook: cells done, markers/s,
        # device count — one line, rewritten in place.
        session.progress = lambda m: print(
            f"\r{m.progress_line()}", end="", file=sys.stderr, flush=True
        )
    # wall_s covers the scan itself, not the amortized setup — the same
    # accounting the historical CLI reported.
    if args.trace_spans:
        spans.start()
    t0 = time.time()
    try:
        wsum = session.stream_to(*writers)
    finally:
        if args.trace_spans:
            spans.stop()
            spans.take()   # the summary keeps the totals; the records go
    wall = time.time() - t0
    if session.progress is not None:
        print(file=sys.stderr)  # finish the \r progress line

    summary = {
        "markers": session.n_markers,
        "samples": session.n_samples,
        "traits": session.n_traits,
        "excluded_related": study.excluded_samples,
        "dof": session.dof,
        "hits": int(wsum.get("hits", 0)),
        "lambda_gc": wsum.get("lambda_gc"),
        "wall_s": wall,
        "markers_per_s": session.n_markers / wall,
        "engine": args.engine,
        "device": str(session.prepared.device),
        "sparse_epilogue": not args.no_sparse_epilogue,
        # The *resolved* staging currency ("auto" negotiates per source)
        "genotype_staging": session.prepared.ctx.genotype_staging,
        "writers": [w.name for w in writers],
        "genotype_shards": getattr(study.source, "n_shards", 1),
        "trait_block": args.trait_block,
        "trait_blocks": session.n_trait_blocks,
        "grid_cells": session.n_batches * session.n_trait_blocks,
        "executor": session.executor_info,
        "metrics": session.metrics.summary(),
    }
    if session.lmm_info:
        info = session.lmm_info
        summary["lmm"] = {
            "grm_method": info["grm_method"],
            "loco": info["loco"],
            "scopes": info["scopes"],
            "spectrum_hash": info["spectrum_hash"],
            "delta": (
                {str(k): float(v) for k, v in info["delta"].items()}
                if isinstance(info["delta"], dict) else float(info["delta"])
            ),
            **(
                {"h2_per_trait": np.asarray(info["h2"]).round(4).tolist()}
                if "h2" in info else {}
            ),
        }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    if "lmm" in summary:
        print(f"lmm: scopes={summary['lmm']['scopes']} loco={summary['lmm']['loco']}")
    if "hits_tsv" in wsum:
        print(f"hits: {wsum['hits_tsv']}")


# -------------------------------------------------------------------- grm


def cmd_grm(argv) -> None:
    from repro_torch.core.grm import grm_spectrum, spectrum_fingerprint, stream_grm
    from repro_torch.io import open_genotypes

    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.gwas grm",
        description="Streamed GRM pass, standalone: one pass over the "
                    "genotype stream, never materializing dosages.",
    )
    ap.add_argument("--genotypes", required=True)
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--method", default="std", choices=["std", "centered"])
    ap.add_argument("--batch-markers", type=int, default=4096)
    ap.add_argument("--maf-min", type=float, default=0.0)
    ap.add_argument("--io-workers", type=int, default=2)
    ap.add_argument("--loco", action="store_true",
                    help="also store each leave-one-chromosome-out GRM "
                         "(needs a multi-file fileset)")
    ap.add_argument("--spectrum", action="store_true",
                    help="also eigendecompose and store (s, u)")
    ap.add_argument("--genotype-staging", default="auto",
                    choices=["auto", "packed", "dense"],
                    help="H2D currency of the GRM pass (see scan --help)")
    ap.add_argument("--device", default="cuda",
                    help="where the block products and the eigendecomposition "
                         "run: cuda (default; an error when no card is "
                         "present), cuda:<i>, or cpu")
    args = ap.parse_args(argv)

    source = open_genotypes(args.genotypes)
    t0 = time.time()
    grm = stream_grm(
        source, batch_markers=args.batch_markers, method=args.method,
        maf_min=args.maf_min, io_workers=args.io_workers,
        staging=args.genotype_staging, device=args.device,
    )
    k = grm.full()
    arrays: dict[str, np.ndarray] = {
        "k": k,
        "shard_boundaries": np.asarray(
            getattr(source, "shard_boundaries", (0, source.n_markers))
        ),
    }
    if args.loco:
        if grm.n_shards < 2:
            raise SystemExit("--loco needs a per-chromosome fileset (>= 2 shards)")
        for sid in range(grm.n_shards):
            arrays[f"loco_{sid}"] = grm.loco(sid)
    spec_hash = None
    if args.spectrum:
        s, u = grm_spectrum(k, device=args.device)
        arrays["s"], arrays["u"] = s, u
        spec_hash = spectrum_fingerprint({-1: s})
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    tmp = args.out + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, args.out)
    summary = {
        "samples": int(k.shape[0]),
        "markers": source.n_markers,
        "method": args.method,
        "loco_scopes": grm.n_shards if args.loco else 0,
        **({"spectrum_hash": spec_hash} if spec_hash else {}),
        "wall_s": time.time() - t0,
        "device": str(resolve_device(args.device)),
        "out": args.out,
    }
    print(json.dumps(summary, indent=1))


# ------------------------------------------------------------------ merge


def cmd_merge(argv) -> None:
    from repro_torch.api import get_writer
    from repro_torch.api.session import CheckpointReplay

    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.gwas merge",
        description="Fold a committed checkpoint directory into final "
                    "outputs without recomputing any grid cell (host only).",
    )
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--writer", default="tsv")
    ap.add_argument("--genotypes", default=None,
                    help="optional: resolve marker names for the TSVs")
    ap.add_argument("--pheno", default=None,
                    help="optional: resolve trait names for the TSVs")
    args = ap.parse_args(argv)

    marker_ids = trait_names = None
    if args.genotypes:
        from repro_torch.io import open_genotypes

        marker_ids = open_genotypes(args.genotypes).marker_ids
    if args.pheno:
        from repro_torch.io import read_table

        trait_names = tuple(read_table(args.pheno).names)
    replay = CheckpointReplay(
        args.checkpoint_dir, marker_ids=marker_ids, trait_names=trait_names
    )
    if not replay.complete:
        done = len(list(replay.checkpoint.completed_cells()))
        total = replay.n_batches * replay.n_trait_blocks
        print(f"warning: checkpoint is partial ({done}/{total} cells); "
              "merging what is committed", file=sys.stderr)
    os.makedirs(args.out, exist_ok=True)
    writers = [get_writer(n)(args.out) for n in args.writer.split(",") if n]
    wsum = replay.stream_to(*writers)
    summary = {
        "markers": replay.n_markers,
        "traits": replay.n_traits,
        "grid_cells": replay.n_batches * replay.n_trait_blocks,
        "merged_cells": len(list(replay.checkpoint.completed_cells())),
        "complete": replay.complete,
        "hits": int(wsum.get("hits", 0)),
        "lambda_gc": wsum.get("lambda_gc"),
        "writers": [w.name for w in writers],
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))


# ----------------------------------------------------------------- report


def cmd_report(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.gwas report",
        description="Pretty-print a results directory (summary + top hits).",
    )
    ap.add_argument("--out", required=True, help="results directory to read")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    spath = os.path.join(args.out, "summary.json")
    if os.path.exists(spath):
        with open(spath) as f:
            summary = json.load(f)
        print("== scan summary ==")
        for k in ("markers", "samples", "traits", "hits", "lambda_gc",
                  "engine", "dof", "wall_s"):
            if k in summary and summary[k] is not None:
                v = summary[k]
                print(f"  {k:<12} {v:.4g}" if isinstance(v, float) else f"  {k:<12} {v}")
        if "lmm" in summary:
            print(f"  lmm          scopes={summary['lmm'].get('scopes')} "
                  f"loco={summary['lmm'].get('loco')}")
    hits_path = os.path.join(args.out, "hits.tsv")
    if not os.path.exists(hits_path):
        raise SystemExit(f"no hits.tsv under {args.out}")
    rows = []
    with open(hits_path) as f:
        f.readline()  # header
        for line in f:
            rows.append(line.rstrip("\n").split("\t"))
    rows.sort(key=lambda r: -float(r[4]))
    print(f"\n== top {min(args.top, len(rows))} of {len(rows)} hits ==")
    print(f"  {'marker':<14} {'trait':<12} {'r':>8} {'t':>9} {'-log10p':>9}")
    for r in rows[: args.top]:
        print(f"  {r[0]:<14} {r[1]:<12} {r[2]:>8} {r[3]:>9} {r[4]:>9}")


# ------------------------------------------------------------------ serve


def build_serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.gwas serve",
        description="Persistent multi-tenant scan service (DESIGN.md §16): "
                    "keep a cohort resident — open source, residualized "
                    "panel, GRM spectrum, warm device slots — and serve "
                    "phenotype-panel scans and marker-window queries over "
                    "HTTP, byte-identical to the offline `scan` subcommand.",
    )
    ap.add_argument("--genotypes", required=True,
                    help="resident study genotypes (.bed/.bgen/.npy/.npz, "
                         "glob, or comma list)")
    ap.add_argument("--pheno", required=True, help="resident phenotype table")
    ap.add_argument("--covar", default=None, help="covariate table")
    ap.add_argument("--study-id", default="default",
                    help="name the resident study registers under")
    ap.add_argument("--engine", default="dense", choices=available_engines())
    ap.add_argument("--batch-markers", type=int, default=8192)
    ap.add_argument("--trait-block", type=int, default=0)
    ap.add_argument("--block-p", type=int, default=256)
    ap.add_argument("--hit-threshold", type=float, default=7.301)
    ap.add_argument("--maf-min", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where the resident study runs: cuda (default; an "
                         "error without a card), cuda:i, or cpu")
    sv = ap.add_argument_group("service")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral; the bound port is "
                         "printed and written to --ready-file)")
    sv.add_argument("--devices", type=int, default=1,
                    help="serve worker slots (0 = every visible device)")
    sv.add_argument("--max-resident-slots", type=int, default=8,
                    help="warm device-state cache capacity (LRU-evicted "
                         "beyond this; pinned slots never evict)")
    sv.add_argument("--lease-size", type=int, default=1,
                    help="cells leased per worker claim from the fair-share "
                         "queue (1 = finest-grained interleaving)")
    sv.add_argument("--drr-quantum", type=float, default=2.0,
                    help="deficit-round-robin quantum: cells credited per "
                         "request queue per scheduling round, scaled by "
                         "study weight")
    sv.add_argument("--weight", type=float, default=1.0,
                    help="fair-share weight of the resident study")
    sv.add_argument("--out-root", default=None,
                    help="directory for per-request result bundles "
                         "(default: a fresh temp dir)")
    sv.add_argument("--ready-file", default=None,
                    help="write '<host> <port>' here once listening "
                         "(atomic; lets scripts wait for boot)")
    sv.add_argument("--no-warm", action="store_true",
                    help="skip the eager resident-panel prepare at boot "
                         "(first window query pays it instead)")
    sv.add_argument("--verbose", action="store_true",
                    help="log HTTP requests to stderr")
    return ap


def cmd_serve(argv) -> None:
    import signal

    from repro_torch.api import GridSpec, ServeSpec, Study
    from repro_torch.serve import ServeHost, ServeServer

    args = build_serve_parser().parse_args(argv)
    spec = ServeSpec(
        host=args.host, port=args.port, devices=args.devices,
        max_resident_slots=args.max_resident_slots,
        lease_size=args.lease_size, drr_quantum=args.drr_quantum,
        default_weight=args.weight,
    )
    spec.validate()
    study = Study.from_files(args.genotypes, args.pheno, args.covar, device=args.device)
    host = ServeHost(
        devices=spec.devices,
        max_resident_slots=spec.max_resident_slots,
        lease_size=spec.lease_size,
        drr_quantum=spec.drr_quantum,
        default_weight=spec.default_weight,
        out_root=args.out_root,
        device=args.device,
    )
    host.admit_study(
        args.study_id, study,
        engine=args.engine,
        grid=GridSpec(batch_markers=args.batch_markers,
                      trait_block=args.trait_block, block_p=args.block_p),
        hit_threshold_nlp=args.hit_threshold,
        maf_min=args.maf_min,
    )
    boot: dict = {"study": args.study_id, "warm": not args.no_warm,
                  "device": str(host.device)}
    if not args.no_warm:
        boot["prepare_s"] = host.warm_study(args.study_id)["prepare_s"]
    server = ServeServer(
        host, bind=spec.host, port=spec.port, verbose=args.verbose
    ).start()
    bound_host, bound_port = server.address
    boot.update({"host": bound_host, "port": bound_port,
                 "out_root": host.out_root})
    print(json.dumps({"serving": boot}), flush=True)
    if args.ready_file:
        tmp = args.ready_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{bound_host} {bound_port}\n")
        os.replace(tmp, args.ready_file)

    def _stop(signum, frame):  # noqa: ARG001 — signal signature
        server.shutdown_async()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    server.wait()
    print(json.dumps({"stopped": {"requests": host.metrics_summary()["requests"]}}),
          flush=True)


# ------------------------------------------------------------------- main


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        if argv and argv[0] in SUBCOMMANDS:
            cmd, rest = argv[0], argv[1:]
            return {
                "scan": cmd_scan,
                "grm": cmd_grm,
                "merge": cmd_merge,
                "report": cmd_report,
                "serve": cmd_serve,
            }[cmd](rest)
        return cmd_scan(argv)
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return


if __name__ == "__main__":
    main()
