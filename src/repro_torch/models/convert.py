"""Carry-over of weights, optimizer state and caches between the
reference's pytrees and the port's modules.

The reference stacks each pattern position's parameters (and caches) over
the layer repeats: ``params["pattern"][pos]`` has a leading ``repeats``
axis, ``params["tail"]`` is unstacked, and whisper's ``encoder``/``decoder``
are stacked over all their layers.  The port keeps one module (and one
cache) per layer in layer order.  These functions take and give numpy
arrays (bfloat16 arrays as numpy's ``bfloat16`` extension dtype, which the
reference's arrays convert to, or as the raw 2-byte ``|V2`` words that
``np.load`` gives back for them), so the tests can carry a reference model
across and compare gradients and caches.  The port itself needs the
reference's layout twice: its checkpoints use the reference's flat keys
(``reference_flat``, ``load_reference_flat``), and AdamW decays a
parameter by its rank there (``reference_ndims``).

On a mesh, ``caches_to_blocks`` / ``caches_from_blocks`` cut global caches
into a rank's blocks and gather them back (bit for bit), and
``init_blocks`` draws one rank's parameter blocks a parameter at a time, so
no rank ever holds the whole model.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as M
from repro_torch.models import layers as L
from repro_torch.models.transformer import stack_geometry

__all__ = ["params_from_jax", "params_to_numpy", "opt_state_to_numpy", "caches_from_jax",
           "caches_to_numpy", "load_params", "to_torch", "reference_keys", "reference_ndims",
           "reference_items", "reference_flat", "load_reference_flat", "map_caches", "caches_to_blocks",
           "caches_from_blocks", "init_blocks"]


def to_torch(arr, device) -> torch.Tensor:
    """A numpy array (bfloat16 included, bit for bit, whether as the
    extension dtype or as ``|V2`` words) -> tensor on ``device``."""
    arr = np.array(arr)   # a writable copy: the reference's arrays are read-only
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy; bfloat16 widens exactly to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _to_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy with bfloat16 kept bit for bit as ``|V2`` words,
    the bytes ``np.savez`` writes for the reference's bfloat16 arrays."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


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


# ------------------------------------------------- the reference's flat layout

def reference_keys(cfg: ModelConfig, model: nn.Module) -> dict[str, tuple[str, int | None]]:
    """Each parameter of the port by name -> (its key in the reference's
    pytree, as ``repro.launch.train.flatten_state`` writes it, and its index
    on the reference's stacked axis, None where the reference keeps it
    unstacked).  ``layers.3.attn.wq`` of a 2-position pattern repeated
    twice is (``pattern/[1]/attn/wq``, 1); whisper's ``encoder.0.ln1`` is
    (``encoder/ln1``, 0)."""
    reps, _ = stack_geometry(cfg)
    k = len(cfg.block_pattern)
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        rest = "/".join(parts[2:])
        if parts[0] == "layers":
            i = int(parts[1])
            out[name] = ((f"pattern/[{i % k}]/{rest}", i // k) if i < reps * k
                         else (f"tail/[{i - reps * k}]/{rest}", None))
        elif parts[0] in ("encoder", "decoder"):
            out[name] = (f"{parts[0]}/{rest}", int(parts[1]))
        else:
            out[name] = ("/".join(parts), None)
    return out


def reference_ndims(cfg: ModelConfig, model: nn.Module) -> dict[str, int]:
    """Each parameter's rank in the reference's layout: one more than the
    port's where the reference stacks it."""
    keys = reference_keys(cfg, model)
    return {name: p.dim() + (keys[name][1] is not None) for name, p in model.named_parameters()}


def _key_groups(cfg: ModelConfig, model: nn.Module) -> dict[str, list]:
    """Each reference key -> [(stacked index or None, port name)], the
    stacked ones in index order."""
    groups: dict[str, list] = {}
    for name, (key, idx) in reference_keys(cfg, model).items():
        groups.setdefault(key, []).append((idx, name))
    for items in groups.values():
        if items[0][0] is not None:
            items.sort(key=lambda item: item[0])
    return groups


def reference_items(cfg: ModelConfig, model: nn.Module, leaf, *, bits: bool = False):
    """Yields (reference key, numpy array) one key at a time, calling
    ``leaf(name)`` for each port parameter name of a key just before its
    array is built, so at most one key's tensors are held at a time.  A
    ``leaf`` that returns None (a rank that only takes part in gathering)
    yields None for the key.  ``bits`` as in ``reference_flat``."""
    conv = _to_bits if bits else _to_numpy
    for key, items in _key_groups(cfg, model).items():
        arrays = [None if t is None else conv(t) for t in (leaf(name) for _, name in items)]
        if arrays[0] is None:
            yield key, None
        else:
            yield key, arrays[0] if items[0][0] is None else np.stack(arrays)


def reference_flat(cfg: ModelConfig, model: nn.Module, tensors: dict, *,
                   bits: bool = False) -> dict[str, np.ndarray]:
    """Tensors keyed by the port's parameter names (the parameters, their
    gradients, AdamW's m or v) -> numpy arrays under the reference's flat
    keys, stacked where the reference stacks.  ``bits`` keeps bfloat16 as
    ``|V2`` words (checkpoints); else it widens to float32 (comparisons)."""
    return dict(reference_items(cfg, model, tensors.__getitem__, bits=bits))


def load_reference_flat(cfg: ModelConfig, model: nn.Module, flat, targets: dict, *,
                        cut=None, prefix: str = "") -> None:
    """Copy the reference's flat arrays (``flat[prefix + key]``; a dict or
    an open ``np.load`` file, read one key at a time, each once) into
    ``targets`` (tensors keyed by the port's parameter names), each cast to
    its target's dtype, as the reference's ``unflatten_like`` casts to its
    leaves'.  ``cut(name, tensor)``, when given, takes each whole tensor (on
    the CPU) to the part its target holds (a rank's block on a mesh)."""
    with torch.no_grad():
        for key, items in _key_groups(cfg, model).items():
            whole = np.asarray(flat[prefix + key])
            for idx, name in items:
                dst = targets[name]
                src = whole[idx] if idx is not None else whole
                t = to_torch(src, "cpu" if cut is not None else dst.device)
                if cut is not None:
                    t = cut(name, t)
                if tuple(t.shape) != tuple(dst.shape):
                    raise ValueError(f"{key}: shape {tuple(t.shape)} != the port's "
                                     f"{tuple(dst.shape)}")
                dst.copy_(t.to(dst.device))
            del whole


def _nest(flat: dict) -> dict:
    """Flat ``a/[0]/b`` keys -> nested dicts and lists (the reference's
    pytree)."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("[") for k in node):
            return [lists(node[f"[{i}]"]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def params_to_numpy(cfg: ModelConfig, model: nn.Module, tensors: dict | None = None) -> dict:
    """The port's parameters (or ``tensors`` keyed by parameter name, such
    as gradients) -> the reference's parameter pytree, numpy leaves,
    bfloat16 widened to float32: the inverse of ``params_from_jax``."""
    tensors = dict(model.named_parameters()) if tensors is None else tensors
    tree = _nest(reference_flat(cfg, model, tensors))
    if cfg.family != "encdec":   # the reference keeps both lists, empty or not
        tree.setdefault("pattern", [])
        tree.setdefault("tail", [])
    return tree


def opt_state_to_numpy(cfg: ModelConfig, model: nn.Module, state):
    """An ``OptState`` of the port -> the same ``OptState`` with m and v as
    the reference's pytrees and ``count`` as a numpy int32."""
    return state._replace(m=params_to_numpy(cfg, model, state.m),
                          v=params_to_numpy(cfg, model, state.v),
                          count=_to_numpy(state.count))


# ------------------------------------------------------------------- caches

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


def map_caches(fn, caches, specs):
    """``fn(tensor, spec)`` over every cache tensor, in the caches' own
    structure; ``specs`` has that structure with one value a tensor
    (``train.serve_step.cache_specs``, ``partition.cache_logical_axes``)."""
    if caches is None:
        return None
    if isinstance(caches, L.LayerCache):
        return L.LayerCache(*(map_caches(fn, c, sp) for c, sp in zip(caches, specs)))
    if isinstance(caches, dict):
        return {k: map_caches(fn, v, specs[k]) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return type(caches)(map_caches(fn, c, sp) for c, sp in zip(caches, specs))
    return fn(caches, specs)


def caches_to_blocks(caches, specs, mesh) -> list:
    """Global caches (tensors) -> this rank's blocks under ``specs``, on the
    rank's device."""
    from repro_torch.runtime import sharding as sh

    return map_caches(lambda t, sp: sh.shard_local(t, mesh, sp), caches, specs)


def caches_from_blocks(caches, specs, mesh) -> list:
    """This rank's cache blocks -> the global caches, on every rank."""
    from repro_torch.runtime import sharding as sh

    return map_caches(lambda t, sp: sh.gather_full(t, mesh, sp), caches, specs)


def _param_seed(seed: int, name: str) -> int:
    """The seed of one parameter's generator: a function of the model's
    seed and the parameter's name alone."""
    return int(np.random.SeedSequence([seed, zlib.crc32(name.encode())]).generate_state(1)[0])


def init_blocks(cfg: ModelConfig, seed: int, *, mesh=None, specs: dict | None = None,
                device="cuda", max_positions: int = 4096) -> nn.Module:
    """A model whose parameters are drawn one at a time, each from its own
    generator (``_param_seed``) by its init law (``layers.draw``), on
    ``device`` (with ``mesh``: the rank's device, and the rank keeps only
    its block of each under ``specs``, each parameter's ``PartitionSpec``
    on ``mesh`` as ``train_step.param_specs`` gives them).  The whole
    parameter exists only while its block is cut, so a rank's peak is its
    blocks plus the largest parameter; every mesh gets the blocks of the
    same whole model."""
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.device import fake_mode_active, resolve_device

    if (mesh is None) != (specs is None):
        raise ValueError("init_blocks takes a mesh and the parameters' specs on it together")
    model = M.abstract_params(cfg, max_positions=max_positions)
    dev = resolve_device(device) if mesh is None else sh.local_device(mesh)
    # a fake card (a dry run) draws no values, and a CPU-only build has no
    # CUDA generator: its generators lie on the host
    gen_dev = "cpu" if fake_mode_active() else dev
    with torch.no_grad():
        for name, meta in list(model.named_parameters()):
            gen = torch.Generator(device=gen_dev).manual_seed(_param_seed(seed, name))
            full = L.draw(torch.empty(meta.shape, dtype=meta.dtype, device=dev), meta.init_law, gen)
            block = full if specs is None else sh.shard_local(full, mesh, specs[name])
            if block.untyped_storage().nbytes() > block.numel() * block.element_size():
                block = block.clone()     # a view of the whole: keep its block only
            path, _, leaf = name.rpartition(".")
            owner = model.get_submodule(path) if path else model
            param = nn.Parameter(block, requires_grad=False)
            param.init_law = meta.init_law
            owner._parameters[leaf] = param
            del full, block
    return model
