"""Sharding vocabulary on a ``torch.distributed`` device mesh.

Physical meshes:
    single pod:  (data, model)          -> axes ("data", "model")
    multi-pod:   (pod, data, model)     -> axes ("pod", "data", "model")

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those axis
names: one process per card (NCCL), or one CPU process per rank (gloo).
The scan never names physical axes directly; it goes through the helpers
here, so the same step runs on either mesh.

A ``PartitionSpec`` has one entry per tensor dim: ``None`` (replicated), an
axis name, or a tuple of names (sharded over their product, the first name
major).  ``shard_local`` cuts this rank's block out of a full tensor by the
rank's mesh coordinate and ``gather_full`` puts the full tensor back
together on every rank; they play the part of ``jit``'s in- and
out-shardings.  ``sum_over`` adds a partial over mesh axes in rank order, so
the sum does not depend on the collective library's reduction order.

The LM wing trains through differentiable counterparts: ``gather_param``
(a parameter's value over the data axes from the ranks' blocks; its
backward is the gradient reduce of FSDP) and ``psum`` (a sum over data
axes whose backward is the same sum).

Both LM steps split every layer's weights over "model": each rank computes
on its "model" blocks, through ``gather_block`` (a parameter's value over
the axes it is not kept local on; no autograd), ``tp_sum`` (the sum of
row-parallel partials), ``tp_scatter_sum`` (the rank's block of such a
sum), ``tp_all_to_all`` (blocks of an activation exchanged between ranks),
``tp_gather`` (the whole of a tensor split over an axis), ``tp_block`` (the
rank's block of a tensor held whole), ``tp_enter`` (a tensor held whole
entering work split over an axis), ``tp_max`` (the max of a partial
softmax, never differentiated) and ``vocab_lookup`` (an embedding lookup on
vocab blocks).  Each skips an axis of size 1.  Serving runs them under
``torch.inference_mode()`` as plain collectives.  Where autograd records
(grad mode on, an input that requires grad) each is a
``torch.autograd.Function`` whose backward follows one rule for
cotangents: *a tensor that every rank of the axis holds whole carries the
same cotangent on every rank of it* (the loss, held whole, has cotangent 1
on each).  So

- ``tp_sum`` (all-reduce of partials) -> the cotangent to each part as it is;
- ``tp_enter`` (the identity) -> the sum of the ranks' partial cotangents
  (an all-reduce), where a whole tensor meets a rank's block of a weight;
- ``tp_scatter_sum`` (reduce-scatter) -> an all-gather along the same dim;
- ``tp_all_to_all`` -> the reverse all-to-all, split sizes swapped;
- ``tp_gather`` (all-gather) -> the rank's block of the cotangent;
- ``tp_block`` (a narrow) -> an all-gather of the blocks' cotangents.

Every rank of the axis issues the same collectives in the same order, in
the forward, the backward and a checkpointed group's recompute alike: none
depends on the data (a rank whose experts received no token still sums).

LM parameters use MaxText-style *logical* axes mapped to physical axes by
``LogicalAxisRules``.

Every collective a step issues through these helpers (``gather_full``,
``axis_rows``, ``sum_over``, the gathers and reduces of the LM's parameters
and activations) is recorded as a ``launch.roofline.Collective`` in each
open ``record_collectives()`` list; an axis of size 1 issues none.  The
set-up exchanges (``broadcast_object``, ``gather_objects``,
``broadcast_array``) are not steps' collectives and are not recorded.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "PartitionSpec",
    "P",
    "NamedSharding",
    "mesh_axes",
    "batch_axes",
    "gwas_shardings",
    "LogicalAxisRules",
    "logical_to_sharding",
    "DEFAULT_RULES",
    "check_mesh",
    "mesh_device",
    "axis_size",
    "local_device",
    "shard_local",
    "gather_full",
    "sum_over",
    "axis_rows",
    "axis_index",
    "spec_dim",
    "gather_param",
    "gather_block",
    "tp_sum",
    "tp_scatter_sum",
    "tp_max",
    "tp_all_to_all",
    "tp_gather",
    "tp_block",
    "tp_enter",
    "vocab_lookup",
    "psum",
    "is_lead",
    "broadcast_object",
    "gather_objects",
    "broadcast_array",
    "record_collectives",
]

# The open record_collectives() lists (process-wide: the autograd engine runs
# a card's backward on its own thread).
_recorders: list[list] = []
_recorders_lock = threading.Lock()


@contextlib.contextmanager
def record_collectives():
    """Yields a list that receives, in issue order, a
    ``launch.roofline.Collective`` for every collective this process issues
    inside the ``with`` block, from any thread.  Blocks may nest; each gets
    every record."""
    log: list = []
    with _recorders_lock:
        _recorders.append(log)
    try:
        yield log
    finally:
        with _recorders_lock:
            del _recorders[next(i for i, r in enumerate(_recorders) if r is log)]


def _record(kind: str, numel: int, dtype, mesh, name: str, wire_bytes: float | None = None
            ) -> None:
    """Note one collective over mesh axis ``name`` whose ring-formula buffer
    holds ``numel`` elements of ``dtype``; ``wire_bytes`` replaces the ring
    formula's where the rank sends another amount (an uneven all-to-all)."""
    if not _recorders:
        return
    import dataclasses

    from repro_torch.launch.roofline import Collective

    rec = Collective.of(kind, numel, dtype, dist.get_process_group_ranks(mesh.get_group(name)))
    if wire_bytes is not None:
        rec = dataclasses.replace(rec, wire_bytes=float(wire_bytes))
    with _recorders_lock:
        for log in _recorders:
            log.append(rec)


class PartitionSpec(tuple):
    """Immutable per-dim sharding entries: ``None``, an axis name, or a
    tuple of axis names.  Trailing dims not named are replicated.  As in
    jax, a one-name tuple is stored as the name and an empty one as
    ``None``."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e

        return super().__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on a mesh: the mesh and its ``PartitionSpec``."""

    mesh: Any
    spec: PartitionSpec


def check_mesh(mesh: Any) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh, not "
            f"{type(mesh).__name__}"
        )


def mesh_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def batch_axes(mesh) -> tuple[str, ...]:
    """All axes that act data-parallel: ('pod', 'data') on multi-pod."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def gwas_shardings(mesh, *, mode: str = "mp") -> dict[str, NamedSharding]:
    """Sharding contract for the association GEMM ``(M,N)x(N,P)->(M,P)``.

    mode="mp" (default): markers over the data axes, phenotypes over model;
        no collective in the GEMM, only the gather of the output tiles.
    mode="sample": samples over the data axes (for biobank-scale N); every
        sum over samples becomes a sum over the data axes (``sum_over``).
    """
    dp = batch_axes(mesh)
    ns = lambda spec: NamedSharding(mesh, spec)
    if mode == "mp":
        return {
            "packed": ns(P(dp, None)),     # (M, N/4) markers sharded
            "marker_vec": ns(P(dp)),       # per-marker stats
            "g": ns(P(dp, None)),          # dense (M, N)
            "y": ns(P(None, "model")),     # panel: phenotypes sharded
            "out": ns(P(dp, "model")),     # (M, P) fully tiled
        }
    if mode == "sample":
        return {
            "packed": ns(P(None, dp)),
            "marker_vec": ns(P()),
            "g": ns(P(None, dp)),
            "y": ns(P(dp, "model")),
            "out": ns(P(None, "model")),
        }
    raise ValueError(f"unknown GWAS sharding mode: {mode}")


@dataclass(frozen=True)
class LogicalAxisRules:
    """Ordered (logical_axis -> physical axes) mapping, first-fit like
    MaxText: a physical axis is consumed at most once per spec."""

    rules: tuple[tuple[str, tuple[str, ...] | str | None], ...] = ()

    def physical(self, logical: tuple[str | None, ...], mesh) -> PartitionSpec:
        available = set(mesh_axes(mesh))
        used: set[str] = set()
        out: list = []
        table = dict(self.rules)
        for ax in logical:
            if ax is None:
                out.append(None)
                continue
            mapped = table.get(ax)
            if mapped is None:
                out.append(None)
                continue
            cands = (mapped,) if isinstance(mapped, str) else tuple(mapped)
            picked = tuple(c for c in cands if c in available and c not in used)
            used.update(picked)
            if not picked:
                out.append(None)
            elif len(picked) == 1:
                out.append(picked[0])
            else:
                out.append(picked)
        return P(*out)


# Default LM rules: FSDP over the data axes + tensor parallel over "model".
DEFAULT_RULES = LogicalAxisRules(
    rules=(
        ("batch", ("pod", "data")),
        ("seq", None),                  # sequence stays unsharded by default
        ("embed", ("data",)),           # FSDP shard of the embedding dim
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("mlp", ("model",)),
        ("vocab", ("model",)),
        ("experts", ("model",)),
        ("expert_mlp", None),
        ("layers", None),
        # KV-cache sequence dim: fallback target when kv_heads cannot divide
        # the model axis (flash-decoding-style partial softmax).
        ("kv_seq", ("model",)),
        ("state", ("model",)),          # recurrent state width (RWKV/RG-LRU)
    )
)


def logical_to_sharding(
    logical: tuple[str | None, ...], mesh, rules: LogicalAxisRules = DEFAULT_RULES
) -> NamedSharding:
    return NamedSharding(mesh, rules.physical(logical, mesh))


# ------------------------------------------------------------ placement


def mesh_device(mesh, requested: str | torch.device = "cuda") -> torch.device:
    """The device this rank computes on under ``mesh``.

    A CUDA mesh uses the rank's current card and needs the NCCL backend (or,
    under a ``FakeTensorMode``, the fake one of ``launch.mesh.fake_world``);
    a CPU mesh uses the CPU.  A ``requested`` device of the other kind, or a
    CUDA index other than the current card, raises ``ValueError``: the mesh
    never moves a scan to another device or backend.
    """
    from repro_torch.runtime.device import fake_mode_active, resolve_device

    check_mesh(mesh)
    want = torch.device(requested)
    kind = mesh.device_type
    if want.type != kind:
        raise ValueError(
            f"device={str(requested)!r} but the mesh lies on {kind!r}; a mesh scan "
            "runs where its mesh was initialized"
        )
    if kind == "cpu":
        return resolve_device("cpu")
    dev = resolve_device(local_device(mesh))
    if want.index is not None and want.index != dev.index:
        raise ValueError(
            f"device={str(requested)!r} but this rank's current card is {dev}; "
            "call torch.cuda.set_device before building the mesh"
        )
    fake = fake_mode_active()
    for name in mesh_axes(mesh):
        backend = str(dist.get_backend(mesh.get_group(name)))
        if "nccl" not in backend and not (fake and backend == "fake"):
            raise ValueError(
                f"a CUDA mesh needs the nccl backend; axis {name!r} runs on {backend!r}"
            )
    return dev


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_dim(spec, axis: str) -> int | None:
    """The dim of ``spec`` split over mesh axis ``axis`` (None: no dim is)."""
    return next((d for d, entry in enumerate(spec) if axis in _names(entry)), None)


def axis_size(mesh, names) -> int:
    """Number of shards over one spec entry (the product of its axes)."""
    dims = mesh_axes(mesh)
    return math.prod(int(mesh.shape[dims.index(n)]) for n in _names(names))


def axis_index(mesh, names) -> int:
    """This rank's block index over one spec entry (its coordinates on the
    entry's axes, the first major)."""
    names = _names(names)
    dims = mesh_axes(mesh)
    coord = mesh.get_coordinate()
    idx = 0
    for n in names:
        d = dims.index(n)
        idx = idx * int(mesh.shape[d]) + int(coord[d])
    return idx


def local_device(mesh) -> torch.device:
    """This rank's device under ``mesh``: its current card on a CUDA mesh
    (a fake card under a ``FakeTensorMode``), the CPU on a CPU mesh."""
    from repro_torch.runtime.device import fake_mode_active

    if mesh.device_type == "cuda":
        return torch.device("cuda", 0 if fake_mode_active() else torch.cuda.current_device())
    return torch.device("cpu")


def shard_local(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``, contiguous,
    on the rank's device (``local_device``): a full tensor held on the host
    crosses to the card as this block only.  A sharded dim must divide
    evenly by its number of shards."""
    out = x
    for dim, entry in enumerate(spec):
        names = _names(entry)
        if not names:
            continue
        n = axis_size(mesh, names)
        size = int(x.shape[dim])
        if size % n:
            raise ValueError(
                f"dim {dim} of size {size} does not divide over {names} ({n} shards)"
            )
        step = size // n
        out = out.narrow(dim, axis_index(mesh, names) * step, step)
    return out.contiguous().to(local_device(mesh))


def _gather_cat(x: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    """``all_gather`` over one mesh axis, concatenated along ``dim`` in
    coordinate order."""
    n = axis_size(mesh, name)
    if n == 1:
        return x
    is_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.get_group(name))
    _record("all-gather", n * src.numel(), src.dtype, mesh, name)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if is_bool else out


def gather_full(x_local: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The full tensor on every rank from each rank's block under ``spec``:
    one ``all_gather`` per sharded axis (the innermost axis of an entry
    first), concatenated in coordinate order."""
    out = x_local
    for dim, entry in enumerate(spec):
        for name in reversed(_names(entry)):
            out = _gather_cat(out, mesh, name, dim)
    return out


def axis_rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every rank's ``x`` over the mesh ``axes``, stacked on a new first dim
    in coordinate order (the first axis major)."""
    stack = x.unsqueeze(0)
    for name in reversed(_names(axes)):
        stack = _gather_cat(stack, mesh, name, 0)
    return stack


def sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of every rank's partial ``x`` over the mesh ``axes``, identical
    on each rank: the partials are gathered and added in rank order (the
    first axis major), never by an ``all_reduce`` whose order is the
    library's choice."""
    names = _names(axes)
    if axis_size(mesh, names) == 1:
        return x
    stack = axis_rows(x, mesh, names)
    acc = stack[0]
    for part in stack[1:]:
        acc = acc + part
    return acc


# ------------------------------------------- differentiable collectives (LM)


def _reduce_scatter(x: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    """Sum of every rank's ``x`` over one mesh axis, this rank's block of
    it along ``dim`` (``reduce_scatter_tensor``; the order of the adds is
    the library's)."""
    n = axis_size(mesh, name)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype, device=src.device)
    reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    reduce_scatter(out, src, group=mesh.get_group(name))
    _record("reduce-scatter", src.numel(), src.dtype, mesh, name)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.get_group(name))
    _record("all-reduce", out.numel(), out.dtype, mesh, name)
    return out


class _GatherParam(torch.autograd.Function):
    """Forward: the parameter's value over the data axes of its spec, from
    the ranks' blocks (its "model" block stays the rank's).  Backward: the
    rank's gradient of that value -> the rank's block of the gradient of the
    mean of the data rows' losses: summed over the data axes and divided by
    their size.  A data axis in the spec is reduced by ``reduce_scatter``
    (the FSDP way: each rank receives its block only), one the leaf is
    replicated over by ``all_reduce``."""

    @staticmethod
    def forward(ctx, block, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return gather_block(block, mesh, spec, keep=("model",))

    @staticmethod
    def backward(ctx, grad):
        mesh, spec = ctx.mesh, ctx.spec
        data = batch_axes(mesh)
        n_data = axis_size(mesh, data)
        if n_data == 1:
            return grad.contiguous(), None, None
        g = grad
        for name in data:
            if axis_size(mesh, name) == 1:
                continue
            dims = [d for d, e in enumerate(spec) if name in _names(e)]
            g = _reduce_scatter(g, mesh, name, dims[0]) if dims else _all_reduce(g, mesh, name)
        return g / n_data, None, None


def gather_param(block: torch.Tensor, mesh, spec) -> torch.Tensor:
    """A parameter's value over the data axes of ``spec`` from this rank's
    ``block`` (a rank computes on its "model" block), differentiably
    (``_GatherParam``).  On a mesh whose axes are all of size 1 it is
    ``block`` itself."""
    if all(int(s) == 1 for s in mesh.shape):
        return block
    return _GatherParam.apply(block, mesh, PartitionSpec(*spec))


# ------------------------------------------ tensor-parallel collectives (LM)


def gather_block(block: torch.Tensor, mesh, spec, keep: tuple[str, ...] = ()) -> torch.Tensor:
    """A parameter's value over every axis of its ``spec`` but the ``keep``
    axes, from this rank's ``block``; no autograd."""
    out = block
    for dim, entry in enumerate(spec):
        for name in reversed(_names(entry)):
            if name not in keep:
                out = _gather_cat(out, mesh, name, dim)
    return out


def _reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    out = x if x.is_contiguous() else x.contiguous()
    dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    _record("all-reduce", out.numel(), out.dtype, mesh, axis)
    return out


def _recording(*xs) -> bool:
    """Whether autograd records an op on ``xs`` (grad mode on and one of
    them requires grad): the collectives then take their autograd pair."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _TpSum(torch.autograd.Function):
    """All-reduce sum of the partials (into a copy: the input may be saved
    for another backward); backward the identity."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _TpEnter(torch.autograd.Function):
    """The identity; backward the all-reduce sum of the partial cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axis), None, None


class _TpScatterSum(torch.autograd.Function):
    """Reduce-scatter along ``dim``; backward an all-gather along it."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather_cat(grad, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _TpGather(torch.autograd.Function):
    """All-gather along ``dim``; backward the rank's block of the
    cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis, ctx.n = mesh, dim, axis, x.shape[dim]
        return _gather_cat(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        first = axis_index(ctx.mesh, ctx.axis) * ctx.n
        return grad.narrow(ctx.dim, first, ctx.n).contiguous(), None, None, None


class _TpBlock(torch.autograd.Function):
    """The rank's block along ``dim``; backward an all-gather of the
    blocks' cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        n = x.shape[dim] // axis_size(mesh, axis)
        return x.narrow(dim, axis_index(mesh, axis) * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_cat(grad.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _TpAllToAll(torch.autograd.Function):
    """``_all_to_all`` of the parts; backward the reverse exchange: the
    cotangent cut by what each rank sent, sent back."""

    @staticmethod
    def forward(ctx, mesh, dim, axis, recv, *parts):
        ctx.mesh, ctx.dim, ctx.axis, ctx.recv = mesh, dim, axis, recv
        ctx.sent = tuple(int(p.shape[dim]) for p in parts)
        return _all_to_all(list(parts), recv, mesh, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        dim = ctx.dim
        back = list(torch.split(grad, list(ctx.recv), dim=dim))
        got = _all_to_all(back, ctx.sent, ctx.mesh, dim, ctx.axis)
        return (None, None, None, None, *torch.split(got, list(ctx.sent), dim=dim))


def tp_sum(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The sum of every rank's partial ``x`` over one mesh axis (an
    ``all_reduce``; the same bits on every rank).  Without autograd ``x``
    is consumed: a contiguous ``x`` is reduced in place."""
    if axis_size(mesh, axis) == 1:
        return x
    if _recording(x):
        return _TpSum.apply(x, mesh, axis)
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def tp_enter(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """``x``, held whole on every rank of one mesh axis, entering work split
    over it (a rank's block of a weight): the identity, whose backward sums
    the ranks' partial cotangents.  ``x`` itself where autograd does not
    record."""
    if axis_size(mesh, axis) == 1 or not _recording(x):
        return x
    return _TpEnter.apply(x, mesh, axis)


def tp_scatter_sum(x: torch.Tensor, mesh, dim: int, axis: str = "model") -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's partial
    ``x`` over one mesh axis (a ``reduce_scatter``)."""
    if axis_size(mesh, axis) == 1:
        return x
    if _recording(x):
        return _TpScatterSum.apply(x, mesh, dim, axis)
    return _reduce_scatter(x, mesh, axis, dim)


def tp_gather(x: torch.Tensor, mesh, dim: int, axis: str = "model") -> torch.Tensor:
    """The whole tensor on every rank of one mesh axis from each rank's
    block along ``dim`` (an ``all_gather``)."""
    if axis_size(mesh, axis) == 1:
        return x
    if _recording(x):
        return _TpGather.apply(x, mesh, dim, axis)
    return _gather_cat(x.contiguous(), mesh, axis, dim)


def tp_block(x: torch.Tensor, mesh, dim: int, axis: str = "model") -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, held whole on every rank
    of one mesh axis (contiguous)."""
    if _recording(x) and axis_size(mesh, axis) > 1:
        return _TpBlock.apply(x, mesh, dim, axis)
    n = x.shape[dim] // axis_size(mesh, axis)
    return x.narrow(dim, axis_index(mesh, axis) * n, n).contiguous()


def tp_max(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The elementwise max of every rank's ``x`` over one mesh axis
    (consumed as in ``tp_sum``, but for a copy where ``x`` requires grad);
    never differentiated."""
    return _reduce(x.detach().clone() if x.requires_grad else x, mesh, axis, dist.ReduceOp.MAX)


def _all_to_all(parts: list, recv, mesh, dim: int, axis: str) -> torch.Tensor:
    src = torch.cat([p.movedim(dim, 0) for p in parts], dim=0).contiguous()
    out = torch.empty((sum(recv), *src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_to_all_single(out, src, output_split_sizes=list(recv),
                           input_split_sizes=[int(p.shape[dim]) for p in parts],
                           group=mesh.get_group(axis))
    me = axis_index(mesh, axis)
    _record("all-to-all", src.numel(), src.dtype, mesh, axis,
            wire_bytes=(src.numel() - parts[me].numel()) * src.element_size())
    return out.movedim(0, dim)


def tp_all_to_all(parts: list, recv: list, mesh, dim: int, axis: str = "model") -> torch.Tensor:
    """``parts[j]`` sent to rank j of one mesh axis, for every j: the
    concatenation along ``dim`` of what each rank sent this one, in rank
    order, of ``recv[i]`` slices from rank i (an ``all_to_all``; a part
    may be empty).  Recorded with the bytes the rank sends to the others."""
    if axis_size(mesh, axis) == 1:
        return parts[0]
    if _recording(*parts):
        return _TpAllToAll.apply(mesh, dim, axis, tuple(int(r) for r in recv), *parts)
    return _all_to_all(parts, recv, mesh, dim, axis)


def vocab_lookup(block: torch.Tensor, ids: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Rows ``ids`` of an embedding table whose vocab rows are split over
    ``axis``, ``block`` being this rank's: each rank looks up the ids of its
    block (the others give zeros) and the ranks' rows are summed, so every
    row is exactly its table row."""
    n = axis_size(mesh, axis)
    if n == 1:
        return block[ids]
    rows = block.shape[0]
    local = ids - axis_index(mesh, axis) * rows
    mine = (local >= 0) & (local < rows)
    got = block[torch.clamp(local, 0, rows - 1)]
    return tp_sum(torch.where(mine[..., None], got, torch.zeros((), dtype=got.dtype,
                                                                 device=got.device)), mesh, axis)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return sum_over(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return sum_over(grad, ctx.mesh, ctx.axes), None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes`` (rank order), whose
    backward is the same sum of the cotangents: its transpose, for values
    that differ between data rows."""
    if axis_size(mesh, axes) == 1:
        return x
    return _PSum.apply(x, mesh, _names(axes))


# ------------------------------------------------------ rank-0 decisions


def is_lead(mesh) -> bool:
    """Whether this process is global rank 0, the rank that decides the
    scan's set-up and writes its files."""
    return mesh is None or dist.get_rank() == 0


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` (picklable; small) on every rank of the world."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_objects(obj: Any) -> list:
    """Every rank's ``obj`` (picklable; small), in rank order, on every
    rank of the world."""
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_array(arr: np.ndarray | None, device: torch.device) -> np.ndarray:
    """Rank 0's host array, bit for bit, on every rank of the world: its
    shape and dtype as an object, then the bytes through ``device`` (the
    card under NCCL)."""
    meta = broadcast_object(None if arr is None else (arr.shape, arr.dtype.str))
    shape, dtype = meta
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if arr is not None and dist.get_rank() == 0:
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        buf = torch.from_numpy(raw.copy()).to(device)
    else:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    if nbytes:
        dist.broadcast(buf, src=0)
    if arr is not None and dist.get_rank() == 0:
        return arr
    return buf.cpu().numpy().view(np.dtype(dtype)).reshape(shape)
