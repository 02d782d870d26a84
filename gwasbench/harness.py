"""One run of one cell: set-up, the measured window, the comparison.

Set-up: the seeded cohort on the card, written as one ``.bed`` under
``TMPDIR`` and presented as a long scan (``source.CycledSource``); then the
port's own entry, as ``gwas scan`` drives it::

    Study.from_arrays(...) -> Study.plan(...) -> ScanPlan.prepare() -> ScanPlan.run()

streamed through the result writers (``ScanSession.stream_to``) with the
port's ``tsv`` writer beside the benchmark's ``Window``.  The session's first
cell on every card is the warm-up of the cell's shapes.  The window opens
when each card has delivered one, and closes ``seconds`` later: the first
cell delivered after that ends the scan (the writers are aborted, as for an
interrupted scan) and is not counted.  Every delivered cell is then held
against the float64 reference, on the first card, once the port's state is
freed.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from gwasbench import check, trace
from gwasbench.cohort import make_cohort
from gwasbench.source import CycledSource

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# A traced run profiles the window's first seconds only: each host operation
# the profiler records costs microseconds to stop and read, and a whole 51 s
# window of the host refine's eager ops took ~2 minutes.
TRACE_SECONDS = 10.0


@dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s workloads, with its files read."""

    name: str
    config: dict
    traffic: dict
    chips: int


@dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: Cell
    seconds: float = 0.0           # the window's length
    setup_s: float = 0.0
    cohort_s: float = 0.0          # the seeded cohort, drawn and written
    prepare_s: float = 0.0
    window_cells: int = 0
    window_batches: int = 0
    window_tests: float = 0.0      # marker x trait tests completed in the window
    window_flops: float = 0.0      # product FLOPs of those cells
    traced_cells: int = 0          # cells delivered while the profiler ran
    traced_flops: float = 0.0      # product FLOPs of the traced cells
    metrics_start: dict = field(default_factory=dict)
    metrics_end: dict = field(default_factory=dict)
    executor_info: dict | None = None  # the multi-device executor's worker accounting
    peak_bytes: int = 0
    trace: trace.Trace | None = None

    def delta(self, key: str) -> float:
        """A ``ScanMetrics.summary()`` total over the window."""
        return float(self.metrics_end.get(key, 0.0)) - float(self.metrics_start.get(key, 0.0))

    def cell_shape(self) -> tuple[int, int, int]:
        """(markers, samples, traits) of one grid cell."""
        cfg, tr = self.cell.config, self.cell.traffic
        width = cfg["trait_block"] or tr["n_traits"]
        return int(cfg["batch_markers"]), int(cfg["n_samples"]), int(width)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` and its config and traffic files."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, cfg_entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "traffic", f"{wl['traffic']}.json")) as fh:
        traffic = json.load(fh)
    if int(config["devices"]) != int(wl["chips"]):
        raise SystemExit(f"{name}: config {wl['config']} runs {config['devices']} card(s), "
                         f"the cell asks for {wl['chips']}")
    return Cell(name, config, traffic, int(wl["chips"]))


def kernel_patterns(group: str) -> list[str]:
    """The kernel-name patterns of ``kernels/<group>/*.txt``: one regular
    expression a line, ``#`` starts a comment."""
    d = os.path.join(HERE, "kernels", group)
    out = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".txt"):
            with open(os.path.join(d, fn)) as fh:
                out += [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]
    return out


class WindowClosed(Exception):
    """Raised from ``Window.write`` by the first cell after the window."""


class Window:
    """A result writer that opens and closes the measured window and keeps
    what every delivered cell says (host arrays only)."""

    name = "gwasbench-window"

    def __init__(self, run: Run, *, seconds: float, n_devices: int, profile: bool):
        self.run, self.seconds, self.n_devices, self.profile = run, seconds, n_devices, profile
        self.cells: list[check.CellOutput] = []
        self.best = None
        self.session = None
        self.t_first_cell = time.perf_counter()
        self.t_start: float | None = None
        self.t_stop: float | None = None
        self.prof = None                   # the profiler while it runs
        self.traced = None                 # ... and once it has stopped
        self.t_trace_stop: float | None = None
        self._batches: set[int] = set()

    def open(self, session) -> None:
        from repro_torch.core.sinks import BestTraitSink

        self.session = session
        self.best = BestTraitSink(session.n_traits)

    def _summary(self) -> dict:
        return self.session.metrics.summary()

    def write(self, cell) -> None:
        now = time.perf_counter()
        self.cells.append(check.CellOutput(
            cell.batch_index, cell.lo, cell.hi, np.array(cell.hits), np.array(cell.hit_stats),
            np.array(cell.maf), np.array(cell.valid),
            None if cell.omnibus_nlp is None else np.array(cell.omnibus_nlp),
        ))
        self.best.on_cell(cell)
        if self.t_start is None:
            snap = self._summary()
            if len(snap["per_device"]) >= self.n_devices:
                self._open(snap)
            return
        if self.prof is not None:
            # a cell delivered while tracing ran its kernels in the trace
            self.run.traced_cells += 1
            self.run.traced_flops += self._flops(cell)
            if now > self.t_start + TRACE_SECONDS:
                self._stop_trace()
        if now <= self.t_start + self.seconds:
            self._count(cell)
            return
        self.t_stop = now
        self._stop_trace()
        raise WindowClosed

    def _flops(self, cell) -> float:
        return 2.0 * cell.n_markers * self.run.cell_shape()[1] * cell.n_traits

    def _open(self, snap: dict) -> None:
        self.run.metrics_start = snap
        self.run.metrics_end = snap
        if self.profile:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t_start = time.perf_counter()

    def _count(self, cell) -> None:
        run = self.run
        run.window_cells += 1
        self._batches.add(cell.batch_index)
        run.window_tests += float(cell.n_markers) * cell.n_traits
        run.window_flops += self._flops(cell)
        run.metrics_end = self._summary()

    def _stop_trace(self) -> None:
        if self.prof is not None:
            self.t_trace_stop = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self.traced, self.prof = self.prof, None

    def finish(self) -> None:
        """After the stream: the window's length, and its end where the scan
        ran out before it (only ever at sizes far below a cell's)."""
        if self.t_start is None:
            raise RuntimeError("the scan ended before every card delivered a cell")
        if self.t_stop is None:
            self.t_stop = time.perf_counter()
            self._stop_trace()
        self.run.seconds = min(self.seconds, self.t_stop - self.t_start)
        self.run.window_batches = len(self._batches)

    def close(self) -> dict:
        return {}

    def abort(self) -> None:
        pass


def host_readings() -> dict:
    """The host's CPU model and the cards' clocks, power and power limit."""
    out: dict = {"cpu_model": None}
    try:
        with open("/proc/cpuinfo") as fh:
            out["cpu_model"] = next((ln.split(":", 1)[1].strip() for ln in fh
                                     if ln.startswith("model name")), None)
    except OSError as e:
        out["cpu_model"] = f"unread: {e}"
    if out["cpu_model"] in (None, "", "unknown"):
        try:
            q = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=20)
            out["cpu_model"] = {k.strip(): v.strip() for k, v in
                                (ln.split(":", 1) for ln in q.stdout.splitlines() if ":" in ln)
                                if k.strip() in ("Model name", "Vendor ID", "CPU(s)")}
        except (OSError, subprocess.SubprocessError) as e:
            out["cpu_model"] = f"unread: {e}"
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,clocks.sm,clocks.mem,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        out["nvidia_smi"] = [ln.strip() for ln in q.stdout.splitlines() if ln.strip()] \
            or q.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unread: {e}"
    return out


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_cell(cell: Cell, *, seed: int, seconds: float, trace_on: bool, t_process: float,
             device_type: str = "cuda", control: str | None = None,
             on_host=None) -> tuple[Run, check.Verdict]:
    """Set up, measure and check one run of ``cell``.  ``control="tf32"``
    lets float32 products run in TF32 (the control run; never in a
    benchmark run).  ``on_host`` receives the host readings."""
    from repro_torch.api import ExecSpec, GridSpec, IOSpec, Study, get_writer
    from repro_torch.core.association import AssocOptions
    from repro_torch.io.plink import PlinkBed

    cfg, tr = cell.config, cell.traffic
    if int(cfg["distinct_markers"]) % int(cfg["batch_markers"]):
        raise ValueError("distinct_markers must be a multiple of batch_markers")
    devices = ([torch.device("cuda", i) for i in range(cell.chips)]
               if device_type == "cuda" else [torch.device("cpu")] * cell.chips)
    run = Run(cell)
    tmp = tempfile.mkdtemp(prefix="gwasbench-")
    try:
        t = time.perf_counter()
        cohort = make_cohort(tr, n_samples=cfg["n_samples"], n_covariates=cfg["n_covariates"],
                             n_markers=cfg["distinct_markers"], seed=seed, device=devices[0],
                             out_dir=tmp)
        run.cohort_s = time.perf_counter() - t
        source = CycledSource(PlinkBed(cohort.bed_path), int(cfg["n_markers"]))
        study = Study.from_arrays(source, cohort.phenotypes, cohort.covariates,
                                  device=str(devices[0]))
        plan = study.plan(
            engine=cfg["engine"],
            grid=GridSpec(batch_markers=cfg["batch_markers"], trait_block=cfg["trait_block"],
                          block_p=cfg["block_p"]),
            io=IOSpec(io_workers=cfg["io_workers"], spill_dir=os.path.join(tmp, "out"),
                      genotype_staging=cfg["genotype_staging"],
                      packed_cache_mb=cfg["packed_cache_mb"]),
            executor=ExecSpec(devices=cell.chips),
            options=AssocOptions(dof_mode=cfg["dof_mode"], precision=cfg["precision"]),
            hit_threshold_nlp=cfg["hit_threshold_nlp"],
            sparse_epilogue=cfg["sparse_epilogue"],
            hit_capacity=cfg["hit_capacity"],
            multivariate=cfg["multivariate"],
            device=str(devices[0]),
        )
        t = time.perf_counter()
        plan.prepare()
        _sync(devices)
        run.prepare_s = time.perf_counter() - t
        if control == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        elif control is not None:
            raise ValueError(f"unknown control {control!r}")
        if on_host is not None:
            on_host({"before_window": host_readings()})
        session = plan.run(resume=False)
        window = Window(run, seconds=seconds, n_devices=cell.chips, profile=trace_on)
        tsv = get_writer("tsv")(os.path.join(tmp, "out"))
        try:
            session.stream_to(window, tsv)
        except WindowClosed:
            pass
        window.finish()
        run.setup_s = window.t_start - t_process
        _sync(devices)
        if device_type == "cuda":
            run.peak_bytes = max(torch.cuda.max_memory_allocated(d) for d in devices)
        if window.traced is not None:
            run.trace = trace.from_profiler(window.traced, window.t_trace_stop - window.t_start,
                                            tuple(range(cell.chips)))
        run.executor_info = session.executor_info
        if on_host is not None:
            on_host({"after_window": host_readings(),
                     "setup": {"cohort_s": run.cohort_s, "prepare_s": run.prepare_s,
                               "first_cells_s": window.t_start - window.t_first_cell}})
        cells, best = window.cells, window.best.result()
        torch.backends.cuda.matmul.allow_tf32 = False
        del session, plan, study, source, tsv, window
        gc.collect()
        if device_type == "cuda":
            torch.cuda.empty_cache()
        from gwasbench.reference import PanelReference

        ref = PanelReference(cohort.phenotypes, cohort.covariates, device=devices[0],
                             dof_mode=cfg["dof_mode"])
        verdict = check.compare(
            cells, best["best_nlp"], best["best_marker"], ref=ref, bed_path=cohort.bed_path,
            period=int(cfg["distinct_markers"]), threshold=float(cfg["hit_threshold_nlp"]),
            limits=cfg["limits"])
        return run, verdict
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
