"""Carry-over of weights and caches between the reference's pytrees and the
port's modules.

The reference stacks each pattern position's parameters (and caches) over
the layer repeats: ``params["pattern"][pos]`` has a leading ``repeats``
axis, ``params["tail"]`` is unstacked, and whisper's ``encoder``/``decoder``
are stacked over all their layers.  The port keeps one module (and one
cache) per layer in layer order.  These functions take and give numpy
arrays (bfloat16 arrays as numpy's ``bfloat16`` extension dtype, which the
reference's arrays convert to), so the tests can carry a reference model
across and compare caches; the port itself never needs them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as M
from repro_torch.models import layers as L
from repro_torch.models.transformer import stack_geometry

__all__ = ["params_from_jax", "caches_from_jax", "caches_to_numpy", "load_params", "to_torch"]


def to_torch(arr, device) -> torch.Tensor:
    """A numpy array (bfloat16 included, bit for bit) -> tensor on ``device``."""
    arr = np.array(arr)   # a writable copy: the reference's arrays are read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy; bfloat16 widens exactly to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def load_params(module: nn.Module, tree: dict, index=None) -> int:
    """Copy ``tree``'s leaves (``[index]`` of each when given) into the
    parameters of the same names; returns the count copied."""
    n = 0
    for name, value in tree.items():
        if isinstance(value, dict):
            n += load_params(getattr(module, name), value, index)
            continue
        param = getattr(module, name)
        if param is None:
            raise KeyError(f"the port's {type(module).__name__} has no parameter {name!r}")
        src = np.asarray(value)
        src = src[index] if index is not None else src
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {src.shape} != port shape {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(to_torch(src, param.device))
        n += 1
    return n


def params_from_jax(cfg: ModelConfig, tree: dict, *, device="cuda") -> nn.Module:
    """The reference's parameter pytree (numpy leaves) -> the port's model
    on ``device``, every parameter copied."""
    if cfg.family == "encdec":
        model = M.init_model(cfg, generator=None, device=device,
                             max_positions=np.asarray(tree["dec_pos"]).shape[0])
        n = 0
        for part in ("encoder", "decoder"):
            for i, block in enumerate(getattr(model, part)):
                n += load_params(block, tree[part], i)
        n += load_params(model, {k: v for k, v in tree.items() if k not in ("encoder", "decoder")})
    else:
        model = M.init_model(cfg, generator=None, device=device)
        reps, tail = stack_geometry(cfg)
        k = len(cfg.block_pattern)
        n = 0
        for r in range(reps):
            for pos in range(k):
                n += load_params(model.layers[r * k + pos], tree["pattern"][pos], r)
        for i in range(len(tail)):
            n += load_params(model.layers[reps * k + i], tree["tail"][i])
        n += load_params(model, {k_: v for k_, v in tree.items() if k_ not in ("pattern", "tail")})
    total = sum(1 for _ in model.parameters())
    if n != total:
        raise ValueError(f"copied {n} of the port's {total} parameters")
    return model


def _cache_from(c, device, index=None):
    pick = (lambda a: to_torch(np.asarray(a)[index], device)) if index is not None \
        else (lambda a: to_torch(a, device))
    if isinstance(c, dict):
        return {k: pick(v) for k, v in c.items()}
    return L.LayerCache(*(None if f is None else pick(f)
                          for f in (c.k, c.v, c.positions, c.k_scale, c.v_scale)))


def caches_from_jax(cfg: ModelConfig, tree, *, device="cuda") -> list:
    """The reference's caches (numpy leaves) -> the port's list of per-layer
    caches on ``device``."""
    if cfg.family == "encdec":
        return [{"self": _cache_from(tree["self"], device, i),
                 "cross_k": to_torch(np.asarray(tree["cross_k"])[i], device),
                 "cross_v": to_torch(np.asarray(tree["cross_v"])[i], device)}
                for i in range(cfg.n_layers)]
    pattern, tail = tree
    reps, _ = stack_geometry(cfg)
    k = len(cfg.block_pattern)
    out = [_cache_from(pattern[i % k], device, i // k) for i in range(reps * k)]
    return out + [_cache_from(c, device) for c in tail]


def _stack(caches: list):
    first = caches[0]
    if isinstance(first, dict):
        return {key: np.stack([_to_numpy(c[key]) for c in caches]) for key in first}
    return L.LayerCache(*(None if f is None else np.stack([_to_numpy(getattr(c, name)) for c in caches])
                          for name, f in zip(L.LayerCache._fields, first)))


def _unstacked(c):
    if isinstance(c, dict):
        return {key: _to_numpy(v) for key, v in c.items()}
    return L.LayerCache(*(None if f is None else _to_numpy(f) for f in c))


def caches_to_numpy(cfg: ModelConfig, caches: list):
    """The port's per-layer caches -> the reference's layout with numpy
    leaves (bfloat16 widened to float32): ``[pattern, tail]`` stacked over
    repeats, or whisper's stacked dict."""
    if cfg.family == "encdec":
        selfs = _stack([c["self"] for c in caches])
        return {"self": selfs,
                "cross_k": np.stack([_to_numpy(c["cross_k"]) for c in caches]),
                "cross_v": np.stack([_to_numpy(c["cross_v"]) for c in caches])}
    reps, tail = stack_geometry(cfg)
    k = len(cfg.block_pattern)
    pattern = [_stack([caches[r * k + pos] for r in range(reps)]) for pos in range(k)] if reps else []
    return [pattern, [_unstacked(c) for c in caches[reps * k:]]]
