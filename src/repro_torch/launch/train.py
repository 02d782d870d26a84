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
resumed run is the same run.  The LM mesh is not ported: ``--mesh
pod|multipod`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.convert import load_reference_flat, reference_flat
from repro_torch.models.sharding_ctx import refuse_mesh
from repro_torch.runtime.checkpoint import TrainCheckpoint
from repro_torch.runtime.device import resolve_device
from repro_torch.train.data import make_batch
from repro_torch.train.optimizer import AdamWConfig, OptState
from repro_torch.train.train_step import TrainStepConfig, build_train_step, init_train_state

__all__ = ["flatten_state", "restore_state", "main"]


def flatten_state(cfg: ModelConfig, model, opt: OptState) -> dict[str, np.ndarray]:
    """Parameters and AdamW state -> numpy arrays under the reference's flat
    checkpoint keys (``p/...``, ``o/m/...``, ``o/v/...``, ``o/count``)."""
    flat = {f"p/{k}": v for k, v in
            reference_flat(cfg, model, dict(model.named_parameters()), bits=True).items()}
    for part in ("m", "v"):
        flat.update({f"o/{part}/{k}": v for k, v in
                     reference_flat(cfg, model, getattr(opt, part), bits=True).items()})
    flat["o/count"] = opt.count.detach().cpu().numpy()
    return flat


def restore_state(cfg: ModelConfig, model, opt: OptState, flat: dict) -> OptState:
    """Copy a flat checkpoint into ``model`` and ``opt`` in place, each array
    cast to its target's dtype; returns the state with the saved count."""
    sub = lambda prefix: {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}  # noqa: E731
    load_reference_flat(cfg, model, sub("p/"), dict(model.named_parameters()))
    load_reference_flat(cfg, model, sub("o/m/"), opt.m)
    load_reference_flat(cfg, model, sub("o/v/"), opt.v)
    count = torch.as_tensor(np.asarray(flat["o/count"]), dtype=torch.int32,
                            device=opt.count.device)
    return opt._replace(count=count)


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
    refuse_mesh(None if args.mesh == "none" else args.mesh)

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig(shape.name, seq_len=64, global_batch=4, kind="train")
    device = resolve_device(args.device)

    tcfg = TrainStepConfig(
        n_microbatches=args.microbatches,
        remat=args.remat,
        optimizer=AdamWConfig(lr=args.lr, total_steps=max(args.steps, 100)),
    )
    model, opt = init_train_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0),
                                  device=device, max_positions=shape.seq_len)
    step_fn = build_train_step(cfg, tcfg=tcfg, donate=True)

    start = 0
    ckpt = TrainCheckpoint(args.checkpoint_dir) if args.checkpoint_dir else None
    if ckpt and ckpt.latest_step() is not None:
        start, flat = ckpt.restore()
        opt = restore_state(cfg, model, opt, flat)
        print(f"resumed from step {start}")

    t_last, tok_count = time.time(), 0
    for step in range(start, args.steps):
        model, opt, metrics = step_fn(model, opt, make_batch(cfg, shape, step))
        tok_count += shape.global_batch * shape.seq_len
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t_last
            print(
                f"step {step + 1:5d}  loss {float(metrics['loss']):.4f}  "
                f"gnorm {float(metrics['grad_norm']):.2f}  "
                f"lr {float(metrics['lr']):.2e}  tok/s {tok_count / dt:,.0f}",
                flush=True,
            )
            t_last, tok_count = time.time(), 0
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, flatten_state(cfg, model, opt))
    print("done.")


if __name__ == "__main__":
    main()
