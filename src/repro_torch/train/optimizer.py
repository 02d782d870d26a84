"""AdamW from scratch, the counterpart of ``repro.train.optimizer``.

State mirrors the parameters: ``{m, v}`` per parameter (dicts keyed by the
model's parameter names) plus a scalar count.  ``state_dtype`` sets the
precision of m and v (bfloat16 halves optimizer memory); the update itself
runs in float32 and is cast back to each parameter's dtype.

``adamw_update`` writes the new values into the parameters, m and v it is
given (the counterpart of the reference's ``donate_argnums=(0, 1)``).  The
schedule and the bias corrections are float32 tensors, as in the
reference, and every division is by a tensor on the parameters' device: a
CUDA division by a Python number multiplies by its reciprocal instead.

Weight decay follows the reference's rule, ``p.ndim >= 2``, on the rank a
parameter has in the reference's layout (``decay_mask``): the reference
stacks each pattern position over its repeats, so its stacked norm gains
and rg-lru ``lam`` are decayed while the same leaves of the tail and
``final_norm`` are not (ROADMAP.md §3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import reference_ndims

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update", "global_norm",
           "global_norm_on_mesh", "cosine_schedule", "decay_mask"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"     # "float32" | "bfloat16"
    warmup_steps: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    m: dict      # parameter name -> tensor in state_dtype
    v: dict
    count: torch.Tensor   # 0-d int32


def _state_dt(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def _named(params) -> dict:
    """A model's parameters by name, or a dict of tensors as it is."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def adamw_init(cfg: AdamWConfig, params) -> OptState:
    """Zero m and v for ``params`` (a model or a dict of tensors)."""
    params = _named(params)
    dt = _state_dt(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    device = next(iter(params.values())).device
    return OptState(m={k: zeros(p) for k, p in params.items()},
                    v={k: zeros(p) for k, p in params.items()},
                    count=torch.zeros((), dtype=torch.int32, device=device))


def decay_mask(cfg: ModelConfig, model: nn.Module) -> dict[str, bool]:
    """Which parameters AdamW decays: those of rank >= 2 in the reference's
    layout."""
    return {name: nd >= 2 for name, nd in reference_ndims(cfg, model).items()}


# Float32 work on a parameter runs in slabs of this many elements, so that a
# large bfloat16 tensor is never widened whole (arctic-480b's one layer of
# expert gradients is 4.5e9 elements; qwen1.5-32b's embedding 7.8e8).
_SLAB = 1 << 26


def _sum_sq(t: torch.Tensor) -> torch.Tensor:
    """float32 sum of squares of ``t``, slab by slab."""
    return sum(torch.sum(torch.square(c.float())) for c in t.reshape(-1).split(_SLAB))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of each one's float32 sum of squares."""
    return torch.sqrt(sum(_sum_sq(t) for t in tensors))


def global_norm_on_mesh(blocks: dict, mesh, specs: dict) -> torch.Tensor:
    """``global_norm`` of the whole tensors whose blocks under ``specs`` the
    ranks of ``mesh`` hold, equal on every rank: each element counted once
    (a block replicated over an axis only on that axis's coordinate 0),
    the ranks' sums added in rank order."""
    from repro_torch.runtime.sharding import mesh_axes, sum_over

    axes = mesh_axes(mesh)
    coord = dict(zip(axes, mesh.get_coordinate()))

    def counted(spec) -> bool:
        named = {n for e in spec if e is not None for n in ((e,) if isinstance(e, str) else e)}
        return all(coord[a] == 0 for a in axes if a not in named)

    parts = [_sum_sq(t) for name, t in blocks.items() if counted(specs[name])]
    device = next(iter(blocks.values())).device
    local = sum(parts) if parts else torch.zeros((), dtype=torch.float32, device=device)
    return torch.sqrt(sum_over(local, mesh, axes))


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to 0 at ``total_steps``; float32."""
    dev = step.device
    step = step.float()
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), dev), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(_f32(math.pi, dev) * frac))


def adamw_update(cfg: AdamWConfig, grads: dict, state: OptState, params, *,
                 decay: dict[str, bool] | None = None, gnorm: torch.Tensor | None = None):
    """One AdamW step with global-norm clipping and decoupled weight decay,
    written into ``params``, ``state.m`` and ``state.v``.  ``decay`` maps a
    parameter name to whether it decays (default: its own rank >= 2).
    ``gnorm`` is the gradients' global norm when they are blocks of a mesh
    (default: ``global_norm`` of ``grads``); the update is elementwise, so
    it runs on blocks as on whole tensors.  Returns (params, new state,
    metrics {"grad_norm", "lr"})."""
    params = _named(params)
    dt = _state_dt(cfg)
    with torch.no_grad():
        if gnorm is None:
            gnorm = global_norm(grads[k] for k in params)
        dev = gnorm.device
        scale = torch.clamp(_f32(cfg.clip_norm, dev) / torch.clamp_min(gnorm, 1e-9), max=1.0)
        count = state.count + 1
        lr = cosine_schedule(cfg, count)
        b1, b2 = cfg.beta1, cfg.beta2
        c32 = count.float()
        bc1 = 1.0 - torch.pow(_f32(b1, dev), c32)
        bc2 = 1.0 - torch.pow(_f32(b2, dev), c32)
        for name, p in params.items():
            decays = p.dim() >= 2 if decay is None else decay[name]
            # elementwise, so slab by slab gives the same bits
            for pv, gv, mv, vv in zip(*(t.reshape(-1).split(_SLAB) for t in
                                        (p, grads[name], state.m[name], state.v[name]))):
                g = gv.float() * scale
                m32 = b1 * mv.float() + (1 - b1) * g
                v32 = b2 * vv.float() + (1 - b2) * torch.square(g)
                step_dir = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
                if decays:
                    step_dir = step_dir + cfg.weight_decay * pv.float()
                pv.copy_(pv.float() - lr * step_dir)
                mv.copy_(m32.to(dt))
                vv.copy_(v32.to(dt))
    return params, OptState(state.m, state.v, count), {"grad_norm": gnorm, "lr": lr}
