"""LM-wing training driver, the counterpart of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch gemma-7b --shape train_4k \\
        [--steps 200] [--reduced] [--checkpoint-dir ckpt/] [--device cpu]

The reference's flags and defaults, plus ``--device`` (default ``cuda``;
with no card that is an error).  With ``--reduced`` the family-preserving
small config runs at S=64, B=4.  Checkpoints (``TrainCheckpoint``) hold the
parameters and the AdamW state under the reference's flat keys
(``p/pattern/[0]/attn/wq``, ``o/m/...``, ``o/count``), bfloat16 as the
2-byte words the reference's files hold, so one package's checkpoint
restores in the other.  Data is a deterministic function of the step, so a
resumed run is the same run.

``--mesh pod|multipod`` trains on ``launch.mesh.make_production_mesh`` over
a ``torch.distributed`` world, one process per card:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch gemma2-9b --mesh pod --microbatches 4 --remat full

The world comes from torchrun's environment (NCCL on the cards, gloo with
``--device cpu``) unless the caller initialized one; with neither it
raises.  Each rank holds its blocks of the parameters and AdamW state; only
rank 0 prints, and rank 0 streams each checkpoint to disk from the leaves
gathered one key at a time.  A restore reads the file one key at a time and
each rank keeps its block of it, so no process holds the whole state, and a
checkpoint written on a mesh resumes without one, and the other way round.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.convert import load_reference_flat, reference_items
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.checkpoint import TrainCheckpoint
from repro_torch.runtime.device import resolve_device
from repro_torch.train.data import make_batch
from repro_torch.train.optimizer import AdamWConfig, OptState
from repro_torch.train.train_step import (TrainStepConfig, build_train_step, init_train_state,
                                          param_specs)

__all__ = ["state_items", "flatten_state", "restore_state", "init_world", "main"]


def state_items(cfg: ModelConfig, model, opt: OptState, *, mesh=None):
    """Yields the parameters and AdamW state as (flat checkpoint key, numpy
    array) under the reference's keys (``p/...``, ``o/m/...``, ``o/v/...``,
    ``o/count``), one key at a time.  With ``mesh`` the tensors are this
    rank's blocks and every rank must run the generator to its end: each
    leaf is gathered from all ranks, one at a time, and only rank 0 gets the
    arrays (the others get None for each key)."""
    parts = {"p": dict(model.named_parameters()), "o/m": opt.m, "o/v": opt.v}
    specs = param_specs(cfg, mesh) if mesh is not None else None
    lead = sh.is_lead(mesh)
    for part, tensors in parts.items():
        def leaf(name, tensors=tensors):
            if mesh is None:
                return tensors[name]
            whole = sh.gather_full(tensors[name].detach(), mesh, specs[name])
            return whole if lead else None
        for key, array in reference_items(cfg, model, leaf, bits=True):
            yield f"{part}/{key}", array
    yield "o/count", opt.count.detach().cpu().numpy() if lead else None


def flatten_state(cfg: ModelConfig, model, opt: OptState, *, mesh=None) -> dict | None:
    """``state_items`` as one dict (on a mesh rank 0's; the others get
    None)."""
    flat = dict(state_items(cfg, model, opt, mesh=mesh))
    return flat if sh.is_lead(mesh) else None


def restore_state(cfg: ModelConfig, model, opt: OptState, flat, *, mesh=None) -> OptState:
    """Copy a flat checkpoint (a dict, or ``TrainCheckpoint.open``'s file,
    read one key at a time) into ``model`` and ``opt`` in place, each array
    cast to its target's dtype (with ``mesh``, this rank's block of it, cut
    as each key is read, so no rank holds the whole state); returns the
    state with the saved count."""
    cut = None
    if mesh is not None:
        specs = param_specs(cfg, mesh)
        cut = lambda name, t: sh.shard_local(t, mesh, specs[name])  # noqa: E731
    for prefix, targets in (("p/", dict(model.named_parameters())), ("o/m/", opt.m),
                            ("o/v/", opt.v)):
        load_reference_flat(cfg, model, flat, targets, cut=cut, prefix=prefix)
    count = torch.as_tensor(np.asarray(flat["o/count"]), dtype=torch.int32,
                            device=opt.count.device)
    return opt._replace(count=count)


def init_world(device: str) -> None:
    """The ``torch.distributed`` world of a mesh run: the caller's if one
    is initialized, else torchrun's (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and the rendezvous address in the environment): NCCL
    with each process on card ``LOCAL_RANK``, or gloo for ``--device cpu``.
    Without either it raises ``RuntimeError``."""
    if dist.is_available() and dist.is_initialized():
        return
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("--mesh needs a torch.distributed world: run under torchrun "
                           "(e.g. torchrun --nproc-per-node 4 -m repro_torch.launch.train ...)")
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "pod", "multipod"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig(shape.name, seq_len=64, global_batch=4, kind="train")
    mesh = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import describe, make_production_mesh

        init_world(args.device)
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod")
        device = sh.mesh_device(mesh, args.device)
    else:
        device = resolve_device(args.device)
    lead = sh.is_lead(mesh)
    if mesh is not None and lead:
        print(f"mesh {describe(mesh)}", flush=True)

    tcfg = TrainStepConfig(
        n_microbatches=args.microbatches,
        remat=args.remat,
        optimizer=AdamWConfig(lr=args.lr, total_steps=max(args.steps, 100)),
    )
    model, opt = init_train_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0),
                                  device=device, max_positions=shape.seq_len, mesh=mesh)
    step_fn = build_train_step(cfg, tcfg=tcfg, mesh=mesh, donate=True)

    start = 0
    ckpt = TrainCheckpoint(args.checkpoint_dir) if args.checkpoint_dir else None
    if ckpt and ckpt.latest_step() is not None:
        with ckpt.open() as (start, flat):
            opt = restore_state(cfg, model, opt, flat, mesh=mesh)
        if lead:
            print(f"resumed from step {start}")

    t_last, tok_count = time.time(), 0
    for step in range(start, args.steps):
        model, opt, metrics = step_fn(model, opt, make_batch(cfg, shape, step))
        tok_count += shape.global_batch * shape.seq_len
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t_last
            if lead:
                print(
                    f"step {step + 1:5d}  loss {float(metrics['loss']):.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.2f}  "
                    f"lr {float(metrics['lr']):.2e}  tok/s {tok_count / dt:,.0f}",
                    flush=True,
                )
            t_last, tok_count = time.time(), 0
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            items = state_items(cfg, model, opt, mesh=mesh)
            if lead:
                ckpt.save(step + 1, items)
            else:
                for _ in items:   # take part in each leaf's gather
                    pass
    if lead:
        print("done.")


if __name__ == "__main__":
    main()
