"""Ambient mesh context of the LM wing, the counterpart of
``repro.models.sharding_ctx``.

The train and serve steps install a mesh with ``activation_sharding_scope``;
layer code reads it back with ``current_mesh`` (``_block`` picks the manual
expert-parallel MoE from it, as the reference does).  Under a mesh each
rank holds every parameter as its block (``train.partition``), and layer
code calls ``gathered(module)`` where it reads a module's weights: inside,
the module's parameters are their values over every axis of their spec but
the axes the scope's ``ParamLayout`` keeps local.

The training step keeps nothing local on "model" (but the manual MoE's
experts): its weights are gathered whole, differentiably
(``runtime.sharding.gather_param``), and the ranks of a "model" row compute
the same rows.  Each repeat of the block pattern gathers inside the
function that remat checkpoints, so a recompute gathers again and the full
weights of one repeat exist at a time.

The serve steps keep every weight local on "model" (gathered over the data
axes only, with no autograd) and open the scope with the caches' capacity
and layout: ``model_split`` then gives the "model" axis to layer code,
``split_of(module, leaf)`` says which parameters are this rank's "model"
blocks (local heads, MLP and channel-mix columns and rows, rg-lru
channels, experts, vocab rows: layer code computes on them and sums the
row-parallel outputs over "model"; a weight whose "model" dim did not
divide is whole), and ``cache_dim`` says which dim of each cache tensor is
split (the caches, recurrent states included, are the rank's blocks of the
reference's layout, as the serve step resolved it).  On a "model" axis of
size 1 ``model_split`` is None and every layer runs as without a mesh.

``constrain`` stays the identity: a rank's activations are its batch block
by construction, and no layout is requested of a compiler.  The scope is
process-wide, not per thread: the autograd engine runs a card's backward,
and the recompute of checkpointed repeats, on its own device thread.  So a
train step and a serve step never run at once in one process.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.runtime import sharding as sh

__all__ = ["activation_sharding_scope", "constrain", "current_mesh", "current_scope",
           "gathered", "full_params", "swapped", "ParamLayout", "Split", "model_split",
           "split_of", "model_block", "model_whole", "cache_dim"]


class ParamLayout:
    """Each parameter of a model as this rank's block on ``mesh``: its
    ``PartitionSpec`` and the axes it is kept local on, by tensor identity.
    ``differentiable`` gathers through autograd (training); else the gather
    is a plain collective (serving, under ``torch.inference_mode``).  A
    parameter kept local on a "model" dim of its spec is computed on as its
    "model" block (``on_model``).  Nothing here refers to the model or its
    tensors once built."""

    def __init__(self, mesh, model, specs: dict, keep: dict | None = None, *,
                 differentiable: bool = True):
        self.mesh = mesh
        self.differentiable = differentiable
        keep = keep or {}
        self._by_id = {}
        self._on_model = set()          # (id(owner module), leaf name)
        for name, p in model.named_parameters():
            spec, kept = specs[name], keep.get(name, ())
            self._by_id[id(p)] = (spec, kept)
            if "model" in kept and sh.spec_dim(spec, "model") is not None:
                path, _, leaf = name.rpartition(".")
                self._on_model.add((id(model.get_submodule(path) if path else model), leaf))

    def on_model(self, module: torch.nn.Module, leaf: str) -> bool:
        """Whether ``module``'s parameter ``leaf`` is held and computed on
        as its block over "model"."""
        return (id(module), leaf) in self._on_model

    def full(self, p: torch.Tensor) -> torch.Tensor:
        spec, keep = self._by_id[id(p)]
        if self.differentiable:
            return sh.gather_param(p, self.mesh, spec, keep)
        return sh.gather_block(p, self.mesh, spec, keep)


class Split(NamedTuple):
    """A serve scope's "model" axis: its size, this rank's index on it, the
    number of slots of a global attention cache (``capacity``), and each
    cache tensor's dim split over it (``cache_dims``: (name, full shape
    past the batch dim) -> dim or None)."""

    mesh: object
    size: int
    index: int
    capacity: int
    cache_dims: dict


class Scope(NamedTuple):
    mesh: object
    layout: ParamLayout | None
    batch_axes: tuple[str, ...]     # the axes the batch is split over (none: replicated)
    split: Split | None = None      # serving: the "model" axis layer code splits over


_scope: Scope | None = None


@contextlib.contextmanager
def activation_sharding_scope(mesh=None, rules=None, *, layout: ParamLayout | None = None,
                              batch_axes: tuple[str, ...] = (), capacity: int | None = None,
                              cache_dims: dict | None = None):
    """Install ``mesh`` (a ``DeviceMesh``; None installs nothing) for layer
    code; with ``layout`` the modules' parameters are blocks to gather, and
    ``batch_axes`` names the axes the batch rows are split over.  A
    ``capacity`` (the slots of a global attention cache) opens a serve
    scope, with ``cache_dims`` (``Split``): layer code splits its compute
    and caches over "model".  ``rules`` is the reference's argument: no
    activation layout is resolved here (the step resolves the parameters'
    with it)."""
    global _scope
    if mesh is not None:
        sh.check_mesh(mesh)
        split = None
        if capacity is not None:
            split = Split(mesh, sh.axis_size(mesh, "model"), sh.axis_index(mesh, "model"),
                          int(capacity), dict(cache_dims or {}))
        new = Scope(mesh, layout, tuple(batch_axes), split)
    else:
        new = None
    prev, _scope = _scope, new
    try:
        yield
    finally:
        _scope = prev


def current_scope() -> Scope | None:
    return _scope


def current_mesh():
    """The ambient mesh (None outside a step's scope)."""
    return _scope.mesh if _scope is not None else None


def model_split() -> Split | None:
    """The serve scope's "model" axis when it has more than one rank, else
    None (no scope, a training scope, or "model" of size 1)."""
    if _scope is None or _scope.split is None or _scope.split.size == 1:
        return None
    return _scope.split


def split_of(module: torch.nn.Module, leaf: str) -> Split | None:
    """``model_split`` where ``module``'s parameter ``leaf`` is this rank's
    block over "model" (the serve step keeps it so: ``serve_kept``), else
    None."""
    split = model_split()
    if split is None or not _scope.layout.on_model(module, leaf):
        return None
    return split


def model_block(t: torch.Tensor, dim: int | None) -> torch.Tensor:
    """This rank's block of a tensor held whole, along ``dim`` over the
    serve scope's "model" axis (``t`` itself for ``dim`` None)."""
    if dim is None:
        return t
    split = model_split()
    n = t.shape[dim] // split.size
    return t.narrow(dim, split.index * n, n).contiguous()


def model_whole(t: torch.Tensor, dim: int | None) -> torch.Tensor:
    """The whole tensor from every rank's block along ``dim`` over the
    serve scope's "model" axis (``t`` itself for ``dim`` None)."""
    if dim is None:
        return t
    spec = sh.P(*[("model" if i == dim else None) for i in range(t.dim())])
    return sh.gather_full(t.contiguous(), model_split().mesh, spec)


def cache_dim(name: str, shape) -> int | None:
    """The dim of a cache tensor named ``name`` (a ``LayerCache`` field or a
    state key) of full ``shape`` that the serve scope splits over "model",
    as the serve step laid the caches out (``Split.cache_dims``); None where
    every "model" rank holds it whole (and outside a split)."""
    split = model_split()
    if split is None:
        return None
    return split.cache_dims[(name, tuple(int(n) for n in shape[1:]))]


def constrain(x: torch.Tensor, logical: tuple[str | None, ...]) -> torch.Tensor:
    """The identity (module docstring)."""
    return x


def full_params(module: torch.nn.Module, *, recurse: bool = True, names=None) -> dict:
    """Each parameter of ``module`` by name (those in ``names`` only, when
    given) -> its full value under the scope's layout; empty outside one."""
    if _scope is None or _scope.layout is None:
        return {}
    return {name: _scope.layout.full(p) for name, p in module.named_parameters(recurse=recurse)
            if names is None or name in names}


@contextlib.contextmanager
def swapped(module: torch.nn.Module, tensors: dict):
    """The parameters of ``module`` named in ``tensors`` replaced by those
    tensors for the duration (a tensor that is the parameter itself is left
    alone)."""
    saved = []
    try:
        for name, t in tensors.items():
            path, _, leaf = name.rpartition(".")
            owner = module.get_submodule(path) if path else module
            p = owner._parameters[leaf]
            if t is not p:
                saved.append((owner, leaf, p))
                owner._parameters[leaf] = t
        yield
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p


@contextlib.contextmanager
def gathered(*modules: torch.nn.Module, recurse: bool = True):
    """Inside, the parameters of ``modules`` are their full values (only
    those owned directly with ``recurse=False``); outside a scope with a
    layout, nothing changes."""
    if _scope is None or _scope.layout is None:
        yield
        return
    with contextlib.ExitStack() as stack:
        for m in modules:
            stack.enter_context(swapped(m, full_params(m, recurse=recurse)))
        yield
