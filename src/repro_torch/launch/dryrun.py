"""Dry run: trace every (architecture x input shape x mesh) cell as one rank
of a fake ``torch.distributed`` world, and derive its memory, collectives
and roofline terms, the counterpart of ``repro.launch.dryrun``.  No card is
needed.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all [--mesh both] [--out-dir experiments/dryrun]

The reference lowers and compiles each cell on 512 fake XLA devices and
reads XLA's cost and memory analysis.  The port runs eagerly and compiles
nothing: it runs its own step (``build_train_step`` / ``build_prefill_step``
/ ``build_decode_step`` / ``build_fused_step`` / ``build_dense_step``) on a
mesh of the world's shape, as rank 0, under ``FakeTensorMode``: every op and
every collective of that rank runs on tensors with shapes and no storage
(``launch.mesh.fake_world``; the kernels' custom ops by their registered
fakes).  ``launch.roofline.trace_step`` records the rank's FLOPs, bytes,
collectives, argument and peak bytes; nothing launches.  Parameters are
drawn as the rank's blocks (``models.convert.init_blocks``): no rank ever
holds the whole model.

Records carry the reference's keys.  The whole depth is traced (eager runs
every layer), so ``flops_per_device_exact`` is the traced count plus the
recurrences' elementwise work (``recurrence_flops / n``), which
``FlopCounterMode`` does not count, as XLA did not; the fused GWAS kernel
counts by its registered formula (``2 M N P``).  ``lower_s`` is the trace's
time and ``compile_s`` 0.0.  Memory is against the H100's 80 GB.

Orchestrator mode (``--all``) runs each cell in a subprocess (one cell's
failure or hang cannot take down the sweep) and skips cells whose JSON record
exists; failures and timeouts are recorded as the reference records them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

from repro_torch.configs import LM_ARCHS, SHAPES, get_config, supported_shapes
from repro_torch.configs.base import GwasWorkloadConfig, ShapeConfig
from repro_torch.launch import roofline as RL
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainStepConfig

__all__ = ["TRAIN_OVERRIDES", "VARIANT_FLAGS", "cell_inventory", "trace_lm_cell",
           "trace_gwas_cell", "run_cell", "main"]

HBM_PER_CARD = RL.HW().hbm_bytes

# Per-arch training memory knobs (microbatching + remat + optimizer dtype),
# the reference's (chosen there against 16 GB a chip).
TRAIN_OVERRIDES: dict[str, dict] = {
    "arctic-480b": dict(n_microbatches=16, remat="full", state_dtype="bfloat16",
                        accum_dtype="bfloat16", loss_chunk=512),
    "deepseek-coder-33b": dict(n_microbatches=8, remat="full"),
    "qwen1.5-32b": dict(n_microbatches=8, remat="full", loss_chunk=512),
    "gemma-7b": dict(n_microbatches=4, remat="full", loss_chunk=512),
    "gemma2-9b": dict(n_microbatches=4, remat="full", loss_chunk=512),
    "qwen2-vl-7b": dict(n_microbatches=4, remat="full", loss_chunk=512),
    "rwkv6-3b": dict(n_microbatches=4, remat="full", loss_chunk=512),
    "recurrentgemma-2b": dict(n_microbatches=4, remat="full", loss_chunk=512),
    "granite-moe-1b-a400m": dict(loss_chunk=512),
    "whisper-small": dict(n_microbatches=4, loss_chunk=512),
}


def _tcfg_for(arch: str, *, accounting: bool = False) -> TrainStepConfig:
    ov = TRAIN_OVERRIDES.get(arch, {})
    return TrainStepConfig(
        n_microbatches=1 if accounting else ov.get("n_microbatches", 1),
        loss_chunk=0 if accounting else ov.get("loss_chunk", 0),
        remat=ov.get("remat", "dots"),
        accum_dtype=ov.get("accum_dtype", "float32"),
        optimizer=AdamWConfig(state_dtype=ov.get("state_dtype", "float32")),
    )


# Variants: "--arch <base>+<flag>" applies a config patch on top of the
# registered architecture.
VARIANT_FLAGS = {
    "kvint8": dict(kv_cache_dtype="int8"),
    "attnchunk": dict(attn_chunk=1024),
    "moea2a": dict(moe_impl="manual"),
}


def _resolve_arch(arch: str):
    base, *flags = arch.split("+")
    cfg = get_config(base)
    for f in flags:
        cfg = dataclasses.replace(cfg, **VARIANT_FLAGS[f])
    return base, cfg, flags


def _index_parts(x, index):
    """``x`` cut by the basic parts of a ``__getitem__`` index (None, ints,
    slices, Ellipsis; through the dispatcher's view ops) and the list of its
    tensor parts by the dim they index (None elsewhere), as PyTorch's own
    indexing applies them."""
    import torch

    index = index if isinstance(index, tuple) else (index,)
    index = tuple(torch.as_tensor(i) if isinstance(i, list) else i for i in index)
    used = sum(0 if i is None or i is Ellipsis else
               (i.dim() if isinstance(i, torch.Tensor) and i.dtype == torch.bool else 1)
               for i in index)
    out, dim, tensors = x, 0, {}
    for i in index:
        if i is Ellipsis:
            dim += x.dim() - used
        elif i is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif isinstance(i, slice):
            out = torch.ops.aten.slice.Tensor(out, dim, i.start, i.stop, i.step or 1)
            dim += 1
        elif isinstance(i, torch.Tensor) and i.dtype == torch.bool:
            for j, part in enumerate(torch.nonzero(i).unbind(1)):
                tensors[dim + j] = part
            dim += i.dim()
        elif isinstance(i, torch.Tensor):
            tensors[dim] = i
            dim += 1
        else:
            out = out.select(dim, int(i))
    return out, [tensors.get(d) for d in range(max(tensors) + 1)] if tensors else []


def _guardless_indexing():
    """A torch-function mode that does ``Tensor.__getitem__``,
    ``__setitem__``, ``__invert__``, ``contiguous``, ``copy_`` and ``to``
    through the dispatcher.  Their Python bindings take a device guard of
    the tensor's device, and a CPU-only build has none for CUDA, even for a
    fake card: on such a build the dry run of the card's path goes through
    this mode."""
    import torch
    from torch.overrides import TorchFunctionMode

    class GuardlessIndexing(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.Tensor.__getitem__:
                out, tensors = _index_parts(*args)
                return torch.ops.aten.index.Tensor(out, tensors) if tensors else out
            if func is torch.Tensor.__setitem__:
                x, index, value = args
                out, tensors = _index_parts(x, index)
                value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
                if tensors:
                    torch.ops.aten.index_put_.default(out, tensors, value)
                else:
                    out.copy_(value)
                return None
            if func is torch.Tensor.__invert__:
                return torch.bitwise_not(args[0])
            if func is torch.Tensor.contiguous:
                x = args[0]
                fmt = kwargs.get("memory_format", args[1] if len(args) > 1 else
                                 torch.contiguous_format)
                return x if x.is_contiguous(memory_format=fmt) else torch.ops.aten.clone.default(
                    x, memory_format=fmt)
            if func is torch.Tensor.copy_:
                return torch.ops.aten.copy_.default(*args, **kwargs)
            if func is torch.Tensor.to:
                x = args[0]
                device, dtype, non_blocking, _ = torch._C._nn._parse_to(*args[1:], **kwargs)
                if (device is None or device == x.device) and (dtype is None or dtype == x.dtype):
                    return x
                return torch.ops.aten._to_copy.default(x, dtype=dtype or x.dtype,
                                                       device=device or x.device,
                                                       non_blocking=non_blocking)
            return func(*args, **kwargs)

    return GuardlessIndexing()


@contextlib.contextmanager
def _fake_mode():
    """``FakeTensorMode``, with the indexing mode on a CPU-only build."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    with contextlib.ExitStack() as stack:
        stack.enter_context(FakeTensorMode())
        if not torch.cuda.is_available():
            stack.enter_context(_guardless_indexing())
        yield


def _host_batch(specs: dict) -> dict:
    """Numpy zeros for every ``(shape, dtype)`` of ``specs``, as a caller
    hands a batch to a step (``train.make_batch``: int32 ids, float32
    embeddings)."""
    import numpy as np

    return {k: np.zeros(shape, np.float32 if dtype.is_floating_point else np.int32)
            for k, (shape, dtype) in specs.items()}


def trace_device(arch: str) -> str:
    """The device a cell traces on: the card's path ("cuda") wherever the
    build has CUDA, and always for the GWAS cells (their kernels' custom
    ops).  A build without CUDA traces the LM cells on the CPU: autograd
    cannot run on a fake card without CUDA's device guard, and the LM path
    has no device-dependent branch (no kernel of the repo runs there)."""
    import torch

    return "cuda" if arch == "gwas_ukb" or torch.cuda.is_available() else "cpu"


def trace_lm_cell(arch: str, shape: ShapeConfig | str, mesh, *, cfg=None, tcfg=None,
                  prompt: int | None = None, fake: bool = True):
    """One rank's step of an LM cell on ``mesh`` -> ``(StepTrace, cfg)``.

    ``shape`` is any ``ShapeConfig`` (or a name of ``SHAPES``); ``cfg``
    replaces the arch's config (``arch`` may name a variant, "base+flag"),
    ``tcfg`` the training overrides (``TRAIN_OVERRIDES``).  A prefill feeds
    ``prompt`` tokens (default ``shape.seq_len``) into caches of
    ``shape.seq_len`` slots; a decode step feeds one token into such caches.
    The step gets what a caller gives it: the rank's parameter blocks (and
    AdamW state, donated) on the rank's device, the whole batch on the host.
    ``fake=False`` runs the same step on real tensors (a real world)."""
    from repro_torch.models import api as M
    from repro_torch.models import convert
    from repro_torch.runtime import sharding as sh
    from repro_torch.train import serve_step as SS
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import adamw_init

    base, resolved, _ = _resolve_arch(arch)
    cfg = resolved if cfg is None else cfg
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    specs = TS.param_specs(cfg, mesh)
    max_pos = shape.seq_len if cfg.family == "encdec" else 4096
    with _fake_mode() if fake else contextlib.nullcontext():
        dev = sh.local_device(mesh)
        model = convert.init_blocks(cfg, 0, mesh=mesh, specs=specs, max_positions=max_pos)
        if shape.kind == "train":
            tcfg = _tcfg_for(base) if tcfg is None else tcfg
            model.requires_grad_(True)
            opt = adamw_init(tcfg.optimizer, model)
            step = TS.build_train_step(cfg, tcfg=tcfg, mesh=mesh, donate=True)
            _, trace = RL.trace_step(step, model, opt, _host_batch(M.input_specs(cfg, shape)),
                                     device=dev)
        elif shape.kind == "prefill":
            fed = dataclasses.replace(shape, seq_len=prompt or shape.seq_len)
            step = SS.build_prefill_step(cfg, shape, mesh=mesh)
            _, trace = RL.trace_step(step, model, _host_batch(M.input_specs(cfg, fed)),
                                     device=dev)
        else:
            import torch

            step = SS.build_decode_step(cfg, shape, mesh=mesh)
            whole = convert.map_caches(lambda t, _: torch.zeros(t.shape, dtype=t.dtype, device=dev),
                                       M.abstract_caches(cfg, shape),
                                       SS.cache_specs(cfg, shape, mesh))
            caches = convert.caches_to_blocks(whole, SS.cache_specs(cfg, shape, mesh), mesh)
            del whole
            token = _host_batch(M.input_specs(cfg, shape))
            _, trace = RL.trace_step(step, model, token["token"], token["pos"], caches,
                                     device=dev)
    return trace, cfg


def _gwas_workload(engine: str, g: GwasWorkloadConfig | None):
    """(workload, engine) with the reference's ``_p2k`` suffix resolved: the
    paper's second benchmark point, 2,048 phenotypes."""
    g = get_config("gwas_ukb") if g is None else g
    if engine.endswith("_p2k"):
        g = dataclasses.replace(g, n_traits=2_048)
        engine = engine[: -len("_p2k")]
    return g, engine


def trace_gwas_cell(engine: str, mesh, *, g: GwasWorkloadConfig | None = None):
    """One rank's marker-batch step of a GWAS engine on ``mesh`` ->
    ``StepTrace``: ``engine`` is "fused", "fused_bf16" or "dense" (``_p2k``:
    2,048 traits), on the workload ``g`` (default ``configs/gwas_ukb.py``).

    A world of one runs the serial step (``mesh=None``) on inputs resident
    on the card, as a serial scan stages them; a larger world runs the mesh
    step on inputs staged on the host, each rank moving its blocks to its
    card inside the step, as a mesh scan stages them.  The fused engine's
    panel is float32 in both precisions (the port's kernel reads float32 y
    and rounds to bf16 itself; the reference stores a bf16 replica)."""
    import torch

    from repro_torch.core.association import AssocOptions
    from repro_torch.core.engines import build_dense_step, build_fused_step
    from repro_torch.runtime import sharding as sh

    g, engine = _gwas_workload(engine, g)
    n_pad = -(-g.n_samples // g.block_n) * g.block_n
    serial = mesh.size() == 1
    with _fake_mode():
        dev = sh.local_device(mesh)
        at = dev if serial else torch.device("cpu")
        if engine.startswith("fused"):
            precision = "bf16" if engine == "fused_bf16" else "fp32"
            step = build_fused_step(
                n_samples=g.n_samples, n_covariates=g.n_covariates,
                options=AssocOptions(precision=precision), mesh=None if serial else mesh,
                block_m=g.block_m, block_n=g.block_n,
                block_p=min(g.block_p, g.n_traits // 16))
            m = g.batch_markers
            args = (torch.full((m, n_pad // 4), 0x55, dtype=torch.uint8, device=at),
                    torch.zeros((m, 1), device=at), torch.zeros((m, 1), device=at),
                    torch.zeros((m,), dtype=torch.bool, device=at),
                    torch.zeros((g.n_samples, g.n_traits), device=at))
        else:
            step = build_dense_step(n_samples=g.n_samples, n_covariates=g.n_covariates,
                                    options=AssocOptions(), mesh=None if serial else mesh,
                                    mode=g.mode)
            args = (torch.zeros((g.batch_markers, g.n_samples), device=at),
                    torch.zeros((g.n_samples, g.n_traits), device=at))
        _, trace = RL.trace_step(step, *args, device=dev)
    return trace


def _gwas_floor(g: GwasWorkloadConfig, engine: str, dp: int, mp: int) -> float:
    """The reference's HBM floor of a GWAS step: genotypes (2-bit or fp32)
    over the data ranks, the panel over the model ranks, r and t out."""
    return (g.batch_markers * g.n_samples * (0.25 if engine.startswith("fused") else 4.0) / dp
            + g.n_samples * g.n_traits * 4 / mp
            + 2 * g.batch_markers * g.n_traits * 4 / (dp * mp))


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             world_shape: tuple[int, ...] | None = None, reduced: bool = False) -> dict:
    """The record of one cell: rank 0 of a fake world of the mesh kind's
    production shape (``launch.mesh.production_shape``: 256 ranks for
    "pod", 512 for "multipod"), or of ``world_shape``; ``reduced`` traces the
    configs' and shapes' ``reduced()`` sizes, with a batch of at least
    the data ranks (the serve steps' rows divide them, as production
    batches do) and one microbatch."""
    from repro_torch.launch.mesh import describe, fake_world, make_mesh, production_shape
    from repro_torch.runtime import sharding as sh

    multi_pod = mesh_kind == "multipod"
    if world_shape is None:
        world_shape, axes = production_shape(512 if multi_pod else 256, multi_pod=multi_pod)
    else:
        axes = ("pod", "data", "model") if len(world_shape) == 3 else ("data", "model")
    n = math.prod(int(s) for s in world_shape)
    hw = RL.HW()
    record: dict = {"arch": arch, "shape": shape_name, "mesh_kind": mesh_kind, "n_devices": n}
    record["traced_on"] = trace_device(arch)
    with fake_world(n, device=record["traced_on"]):
        mesh = make_mesh(world_shape, axes)
        record["mesh"] = describe(mesh)
        dp, mp = sh.axis_size(mesh, sh.batch_axes(mesh)), sh.axis_size(mesh, "model")
        t0 = time.time()
        if arch == "gwas_ukb":
            g, engine = _gwas_workload(shape_name, get_config("gwas_ukb").reduced()
                                       if reduced else None)
            trace = trace_gwas_cell(engine, mesh, g=g)
            total = active = 0
            mf = RL.gwas_flops(g)
            correction = 0.0
        else:
            base, cfg, _ = _resolve_arch(arch)
            shape, tcfg = SHAPES[shape_name], None
            if reduced:
                cfg = cfg.reduced()
                shape = dataclasses.replace(shape.reduced(),
                                            global_batch=max(shape.reduced().global_batch, dp))
                tcfg = dataclasses.replace(_tcfg_for(base), n_microbatches=1)
            trace, cfg = trace_lm_cell(arch, shape, mesh, cfg=cfg, tcfg=tcfg)
            total, active = RL.param_count(cfg)
            mf = RL.model_flops(cfg, shape)
            correction = RL.recurrence_flops(cfg, shape)
    record["lower_s"] = round(time.time() - t0, 1)
    record["compile_s"] = 0.0
    roof = RL.roofline_from_trace(trace, n_devices=n, hw=hw)
    record.update(roof)
    record["kernel_calls"] = trace.kernel_calls
    flops_exact = roof["flops_per_device"] + correction / n
    bytes_exact = roof["bytes_per_device"]
    if arch != "gwas_ukb":
        record["accounting"] = {
            "method": "eager trace of the whole depth",
            "flops_traced": roof["flops_per_device"],
            "recurrence_flops_correction": correction / n,
            "equiv_repeats": cfg.n_layers / len(cfg.block_pattern),
        }
    # bf16 on the tensor cores for the LM and fused_bf16; the fp32 fused
    # kernel runs three TF32 passes; the dense engine's product is fp32
    # outside the tensor cores.
    peak = hw.peak_flops
    if arch == "gwas_ukb" and engine == "fused":
        peak = hw.peak_flops_tf32 / 3
    elif arch == "gwas_ukb" and engine == "dense":
        peak = hw.peak_flops_f32
    record["peak_flops_used"] = peak
    record["flops_per_device_exact"] = flops_exact
    record["bytes_per_device_exact"] = bytes_exact
    record["compute_s"] = flops_exact / peak
    record["memory_s"] = bytes_exact / hw.hbm_bw
    if arch == "gwas_ukb":
        floor = _gwas_floor(g, engine, dp, mp)
    else:
        ov = TRAIN_OVERRIDES.get(base, {})
        floor = RL.memory_floor_bytes(
            cfg, shape, n, state_dtype_bytes=2 if ov.get("state_dtype") == "bfloat16" else 4,
            kv_bytes=1 if cfg.kv_cache_dtype == "int8" else 2)
    record["memory_floor_bytes"] = floor
    record["memory_floor_s"] = floor / hw.hbm_bw
    record["dominant"] = max(("compute_s", "memory_floor_s", "collective_s"),
                             key=lambda kk: record[kk])
    record["model_flops_global"] = mf
    record["model_flops_per_device"] = mf / n
    record["useful_flops_ratio"] = (mf / n) / flops_exact if flops_exact else None
    useful_s = (mf / n) / peak
    record["roofline_fraction"] = useful_s / max(
        record["compute_s"], record["memory_floor_s"], record["collective_s"], 1e-30)
    record["params_total"] = total
    record["params_active"] = active
    record["hbm_bytes"] = HBM_PER_CARD
    peak_bytes = roof["memory"]["peak_bytes"]
    record["fits_hbm"] = bool(peak_bytes <= HBM_PER_CARD)
    record["hbm_util"] = round(peak_bytes / HBM_PER_CARD, 3)
    record["status"] = "ok"
    print(f"[{arch} x {shape_name} x {record['mesh']}]")
    print(roof["memory"])
    print({"flops": roof["flops_per_device"], "bytes accessed": roof["bytes_per_device"]})
    return record


def cell_inventory() -> list[tuple[str, str, str | None]]:
    """All (arch, shape, skip_reason) cells, GWAS engines included."""
    cells: list[tuple[str, str, str | None]] = []
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        for name, shape in supported_shapes(cfg).items():
            if shape is None:
                reason = (
                    "long_500k needs sub-quadratic attention; "
                    f"{arch} has unbounded-context layers (DESIGN.md §Arch-applicability)"
                )
                cells.append((arch, name, reason))
            else:
                cells.append((arch, name, None))
    cells.append(("gwas_ukb", "dense", None))       # paper-faithful fp32 baseline
    cells.append(("gwas_ukb", "fused", None))       # 2-bit fused kernel, fp32 GEMM
    cells.append(("gwas_ukb", "fused_bf16", None))  # + bf16 tensor-core inputs (fp32 accum)
    # the paper's second benchmark point (2,048 phenotypes)
    cells.append(("gwas_ukb", "dense_p2k", None))
    cells.append(("gwas_ukb", "fused_p2k", None))
    cells.append(("gwas_ukb", "fused_bf16_p2k", None))
    return cells


def _write(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape name one cell (or pass --all)")
        for mesh_kind in meshes:
            record = run_cell(args.arch, args.shape, mesh_kind)
            path = os.path.join(args.out_dir, f"{args.arch}__{args.shape}__{mesh_kind}.json")
            _write(path, record)
            print("->", path)
        return

    # Orchestrator: subprocess per cell, resumable, failures recorded.
    todo = []
    for arch, shape, skip in cell_inventory():
        for mesh_kind in meshes:
            path = os.path.join(args.out_dir, f"{arch}__{shape}__{mesh_kind}.json")
            if os.path.exists(path):
                continue
            if skip is not None:
                _write(path, {"arch": arch, "shape": shape, "mesh_kind": mesh_kind,
                              "status": "skip", "skip_reason": skip})
                continue
            todo.append((arch, shape, mesh_kind, path))

    # the children import this package from where this process found it
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    print(f"{len(todo)} cells to run")
    for i, (arch, shape, mesh_kind, path) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--mesh", mesh_kind, "--out-dir", args.out_dir]
        print(f"[{i + 1}/{len(todo)}] {arch} x {shape} x {mesh_kind}", flush=True)
        try:
            proc = subprocess.run(cmd, timeout=args.timeout, capture_output=True, text=True,
                                  env=env)
            if proc.returncode != 0:
                _write(path, {"arch": arch, "shape": shape, "mesh_kind": mesh_kind,
                              "status": "error", "error": (proc.stderr or "")[-3000:]})
                print("   ERROR (recorded)")
        except subprocess.TimeoutExpired:
            _write(path, {"arch": arch, "shape": shape, "mesh_kind": mesh_kind,
                          "status": "timeout", "timeout_s": args.timeout})
            print("   TIMEOUT (recorded)")


if __name__ == "__main__":
    main()
