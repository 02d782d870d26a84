"""Logical axes of the LM wing's parameters and caches, and their layout on
a mesh: the counterpart of ``repro.train.partition``.

Leaf names carry the semantics (``wq``, ``w_in``, ``router``, ...); this
module maps each parameter to its logical axes, which ``LogicalAxisRules``
then resolves to mesh axes: "embed" -> the data axis (FSDP),
"heads"/"mlp"/"vocab"/"experts"/"state" -> the model axis.

The reference keys its tables on (leaf name, rank) and allows one more,
leading "layers" axis for the leaves it stacks over the repeats of the
block pattern.  The port keeps one module per layer, so it keys each
parameter by its own name (the last part of ``layers.3.attn.wq``) and its
own rank; no parameter of the port carries a stacking axis.  A parameter
under a ``moe`` module, but not under its ``dense`` MLP, reads the MoE
table (arctic's parallel dense MLP is ``moe.dense``).
"""
from __future__ import annotations

from repro_torch.runtime.sharding import (DEFAULT_RULES, LogicalAxisRules, NamedSharding,
                                          PartitionSpec as P, axis_size, mesh_axes)

__all__ = ["param_logical_axes", "tree_shardings", "cache_logical_axes", "cache_specs",
           "divisible_sharding"]

# leaf-name -> logical axes, keyed by (name, rank).
_PARAM_TABLE: dict[tuple[str, int], tuple] = {
    ("embed", 2): ("vocab", "embed"),
    ("lm_head", 2): ("embed", "vocab"),
    ("enc_pos", 2): (None, "embed"),
    ("dec_pos", 2): (None, "embed"),
    ("wq", 3): ("embed", "heads", None),
    ("wk", 3): ("embed", "kv_heads", None),
    ("wv", 3): ("embed", "kv_heads", None),
    ("wo", 3): ("heads", None, "embed"),
    ("bq", 2): ("heads", None),
    ("bk", 2): ("kv_heads", None),
    ("bv", 2): ("kv_heads", None),
    ("w_in", 2): ("embed", "mlp"),
    ("w_gate", 2): ("embed", "mlp"),
    ("w_out", 2): ("mlp", "embed"),
    # rwkv
    ("w_r", 3): ("embed", "heads", None),
    ("w_k", 3): ("embed", "heads", None),
    ("w_v", 3): ("embed", "heads", None),
    ("w_g", 3): ("embed", "heads", None),
    ("w_o", 3): ("heads", None, "embed"),
    ("mix_a", 2): ("embed", None),
    ("mix_b", 3): (None, None, "embed"),
    ("decay_a", 2): ("embed", None),
    ("decay_b", 3): (None, "heads", None),
    ("cm_k", 2): ("embed", "mlp"),
    ("cm_v", 2): ("mlp", "embed"),
    ("cm_r", 2): ("embed", None),
    # rg-lru
    ("w_branch", 2): ("embed", "state"),
    ("w_a", 2): ("state", None),
    ("w_i", 2): ("state", None),
    ("conv", 2): (None, "state"),
    ("conv_bias", 1): ("state",),
    ("lam", 1): ("state",),
    ("b_a", 1): ("state",),
    ("b_i", 1): ("state",),
    # rg-lru's (w, d) output projection shares the "w_out" name at rank 2:
    # "state" and "mlp" both map to the model axis, so the layout is the same.
}

# Expert-parallel leaves live under a "moe" module (its "dense" MLP keeps
# the dense table): the same leaf names, other ranks and axes.
_MOE_TABLE: dict[tuple[str, int], tuple] = {
    ("router", 2): ("embed", "experts"),
    ("w_in", 3): ("experts", "embed", None),
    ("w_gate", 3): ("experts", "embed", None),
    ("w_out", 3): ("experts", None, "embed"),
}

_CACHE_TABLE: dict[str, tuple] = {
    # KV caches prefer head sharding; when the head count does not divide
    # the model axis, the priority resolver shards the sequence dim instead.
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "k_scale": ("batch", "kv_seq", "kv_heads"),
    "v_scale": ("batch", "kv_seq", "kv_heads"),
    "positions": ("batch", "kv_seq"),
    "cross_k": ("batch", "kv_seq", "kv_heads", None),
    "cross_v": ("batch", "kv_seq", "kv_heads", None),
    "wkv": ("batch", "heads", None, None),
    "shift_tm": ("batch", None),
    "shift_cm": ("batch", None),
    "h": ("batch", "state"),
    "conv": ("batch", None, "state"),
}

# Dim-assignment priority for shape-aware resolution: contracting/model dims
# claim their axes first; fallbacks (kv_seq) only take what remains.
_PRIORITY = {
    "vocab": 0, "heads": 0, "kv_heads": 0, "mlp": 0, "experts": 0, "state": 0,
    "embed": 1, "batch": 1, "seq": 2, "kv_seq": 3,
}


def param_logical_axes(model) -> dict[str, tuple]:
    """Each parameter of ``model`` by name -> its logical axes (replicated,
    all None, for norms, scalars and the small LoRA bits)."""
    out = {}
    for name, p in model.named_parameters():
        keys = name.split(".")
        in_moe = "moe" in keys and "dense" not in keys
        table = _MOE_TABLE if in_moe else _PARAM_TABLE
        out[name] = table.get((keys[-1], p.dim()), (None,) * p.dim())
    return out


def cache_logical_axes(caches):
    """The logical axes of every cache tensor, in the caches' own structure
    (per-layer ``LayerCache`` tuples, dicts, lists); None stays None.  A
    tensor of higher rank than its table entry gets leading None axes."""
    from repro_torch.models.layers import LayerCache

    def infer(name, leaf):
        if leaf is None:
            return None
        base = _CACHE_TABLE.get(name)
        if base is None:
            return (None,) * leaf.dim()
        return (None,) * max(leaf.dim() - len(base), 0) + base

    def walk(node, name=""):
        if isinstance(node, LayerCache):
            return LayerCache(*(infer(f, v) for f, v in zip(LayerCache._fields, node)))
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return infer(name, node)

    return walk(caches)


def cache_specs(caches, mesh, rules: LogicalAxisRules = DEFAULT_RULES):
    """The ``PartitionSpec`` of every cache tensor of ``caches`` (whole, or
    abstract) on ``mesh``, in the caches' own structure: each tensor's
    ``cache_logical_axes`` resolved against its shape (the reference's
    ``tree_shardings(cache_logical_axes(caches), ..., abstract_tree=)``)."""
    from repro_torch.models.convert import map_caches

    return map_caches(lambda t, axes: _resolve(axes, tuple(t.shape), mesh, rules), caches,
                      cache_logical_axes(caches))


def divisible_sharding(mesh, spec, shape: tuple[int, ...]) -> NamedSharding:
    """``NamedSharding`` with any dim that does not divide by its axes
    degraded to replicated."""
    fixed = []
    for dim, axes in enumerate(spec):
        if axes is None or dim >= len(shape):
            fixed.append(None)
            continue
        ways = axis_size(mesh, axes)
        fixed.append(axes if ways and shape[dim] % ways == 0 else None)
    return NamedSharding(mesh, P(*fixed))


def _resolve(logical: tuple, shape, mesh, rules: LogicalAxisRules) -> P:
    """Shape-aware resolution: dims claim axes in priority order, and an
    axis skipped for divisibility stays available for later dims (e.g.
    kv_heads=8 cannot take model=16, so kv_seq gets it)."""
    table = dict(rules.rules)
    available = set(mesh_axes(mesh))
    assign: list = [None] * len(logical)
    order = sorted((i for i in range(len(logical)) if logical[i] is not None),
                   key=lambda i: _PRIORITY.get(logical[i], 4))
    for i in order:
        mapped = table.get(logical[i])
        if mapped is None:
            continue
        cands = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        picked: list[str] = []
        ways = 1
        for c in cands:
            if c in available and shape[i] % (ways * axis_size(mesh, c)) == 0:
                picked.append(c)
                ways *= axis_size(mesh, c)
        if picked:
            available.difference_update(picked)
            assign[i] = picked[0] if len(picked) == 1 else tuple(picked)
    return P(*assign)


def tree_shardings(logical: dict, mesh, rules: LogicalAxisRules = DEFAULT_RULES, *,
                   shapes: dict | None = None) -> dict[str, NamedSharding]:
    """Logical axes by name -> ``NamedSharding`` by name.

    With ``shapes`` (each name's shape), a dim whose size does not divide
    by its mesh axes degrades to replicated, and the axis stays free for a
    later dim; without them the rules' first fit applies."""
    if shapes is None:
        return {k: NamedSharding(mesh, rules.physical(v, mesh)) for k, v in logical.items()}
    return {k: NamedSharding(mesh, _resolve(v, tuple(shapes[k]), mesh, rules))
            for k, v in logical.items()}
