"""Ambient mesh context of the LM wing, the counterpart of
``repro.models.sharding_ctx``.

The train and serve steps install a mesh with ``activation_sharding_scope``;
layer code reads it back with ``current_mesh`` (``_block`` picks the manual
expert-parallel MoE from it, as the reference does).  Under a mesh each
rank holds every parameter as its block (``train.partition``), and layer
code calls ``gathered(module)`` where it reads a module's weights: inside,
the module's parameters are their values over the data axes of their spec
(``ParamLayout``).

Both steps keep every weight local on "model": a parameter is gathered
over the data axes only (training through autograd, FSDP:
``runtime.sharding.gather_param``; serving as a plain collective), and
the scope gives the "model" axis to layer code (``model_split``, a
``Split``).  ``split_of(module, leaf)`` says which parameters are this
rank's "model" blocks (local heads, MLP and channel-mix columns and rows,
rg-lru channels, experts, vocab rows): layer code computes on them and
sums the row-parallel outputs over "model"; a weight whose "model" dim did
not divide is whole, and every rank computes it whole.  Each repeat of the
block pattern gathers inside the function that remat checkpoints, so a
recompute gathers again and the data-gathered weights of one repeat exist
at a time.

In training the collectives are autograd pairs (``runtime.sharding``'s
rule for cotangents): a whole activation enters a rank's block of a
weight through ``split_input`` (backward: the ranks' partial cotangents
summed), ``model_block`` narrows a tensor held whole (backward: the
blocks' cotangents gathered), ``model_whole`` gathers one (backward: the
rank's block).  A serve scope also carries the caches' capacity and
layout: ``cache_dim`` says which dim of each cache tensor is split (the
caches, recurrent states included, are the rank's blocks of the
reference's layout, as the serve step resolved it); a training scope's
``Split`` has no capacity and no cache dims.  On a "model" axis of size 1
``model_split`` is None and every layer runs as without a mesh.

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
           "split_of", "split_input", "model_block", "model_whole", "cache_dim"]


class ParamLayout:
    """Each parameter of a model as this rank's block on ``mesh``: its
    ``PartitionSpec``, by tensor identity.  A parameter is gathered over the
    data axes of its spec only: one with a "model" dim is computed on as
    its "model" block (``on_model``), one without is whole on every "model"
    rank (a dim that did not divide).  ``differentiable`` gathers through
    autograd (training); else the gather is a plain collective (serving,
    under ``torch.inference_mode``).  Nothing here refers to the model or
    its tensors once built."""

    def __init__(self, mesh, model, specs: dict, *, differentiable: bool = True):
        self.mesh = mesh
        self.differentiable = differentiable
        self._spec = {}
        self._on_model = set()          # (id(owner module), leaf name)
        for name, p in model.named_parameters():
            self._spec[id(p)] = specs[name]
            if sh.spec_dim(specs[name], "model") is not None:
                path, _, leaf = name.rpartition(".")
                self._on_model.add((id(model.get_submodule(path) if path else model), leaf))

    def on_model(self, module: torch.nn.Module, leaf: str) -> bool:
        """Whether ``module``'s parameter ``leaf`` is held and computed on
        as its block over "model"."""
        return (id(module), leaf) in self._on_model

    def full(self, p: torch.Tensor) -> torch.Tensor:
        spec = self._spec[id(p)]
        if self.differentiable:
            return sh.gather_param(p, self.mesh, spec)
        return sh.gather_block(p, self.mesh, spec, keep=("model",))


class Split(NamedTuple):
    """A scope's "model" axis: its size, this rank's index on it, and in a
    serve scope the number of slots of a global attention cache
    (``capacity``) and each cache tensor's dim split over it
    (``cache_dims``: (name, full shape past the batch dim) -> dim or None);
    a training scope has neither (None, {})."""

    mesh: object
    size: int
    index: int
    capacity: int | None
    cache_dims: dict


class Scope(NamedTuple):
    mesh: object
    layout: ParamLayout | None
    batch_axes: tuple[str, ...]     # the axes the batch is split over (none: replicated)
    split: Split | None = None      # the "model" axis layer code splits over


_scope: Scope | None = None


@contextlib.contextmanager
def activation_sharding_scope(mesh=None, rules=None, *, layout: ParamLayout | None = None,
                              batch_axes: tuple[str, ...] = (), capacity: int | None = None,
                              cache_dims: dict | None = None):
    """Install ``mesh`` (a ``DeviceMesh``; None installs nothing) for layer
    code; with ``layout`` the modules' parameters are blocks to gather,
    layer code splits its compute over "model" (``Split``), and
    ``batch_axes`` names the axes the batch rows are split over.  A
    ``capacity`` (the slots of a global attention cache) opens a serve
    scope, with ``cache_dims``: its caches are split over "model" too.
    ``rules`` is the reference's argument: no activation layout is resolved
    here (the step resolves the parameters' with it)."""
    global _scope
    if mesh is not None:
        sh.check_mesh(mesh)
        split = None
        if layout is not None:
            split = Split(mesh, sh.axis_size(mesh, "model"), sh.axis_index(mesh, "model"),
                          None if capacity is None else int(capacity), dict(cache_dims or {}))
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
    """The scope's "model" axis when it has more than one rank and the
    scope has a layout, else None (no scope, or "model" of size 1)."""
    if _scope is None or _scope.split is None or _scope.split.size == 1:
        return None
    return _scope.split


def split_of(module: torch.nn.Module, leaf: str) -> Split | None:
    """``model_split`` where ``module``'s parameter ``leaf`` is this rank's
    block over "model" (its spec has a "model" dim), else None."""
    split = model_split()
    if split is None or not _scope.layout.on_model(module, leaf):
        return None
    return split


def split_input(x: torch.Tensor, split: Split | None) -> torch.Tensor:
    """``x``, held whole on every "model" rank, entering a rank's block of
    a weight (``split``: ``split_of`` that weight; None: ``x`` itself).  In
    training its backward sums the ranks' partial cotangents
    (``runtime.sharding.tp_enter``); serving it is ``x``."""
    return x if split is None else sh.tp_enter(x, split.mesh)


def model_block(t: torch.Tensor, dim: int | None) -> torch.Tensor:
    """This rank's block of a tensor held whole, along ``dim`` over the
    scope's "model" axis (``t`` itself for ``dim`` None); in training the
    blocks' cotangents are gathered back (``runtime.sharding.tp_block``)."""
    if dim is None:
        return t
    return sh.tp_block(t, model_split().mesh, dim)


def model_whole(t: torch.Tensor, dim: int | None) -> torch.Tensor:
    """The whole tensor from every rank's block along ``dim`` over the
    scope's "model" axis (``t`` itself for ``dim`` None); in training the
    backward keeps the rank's block (``runtime.sharding.tp_gather``)."""
    if dim is None:
        return t
    return sh.tp_gather(t, model_split().mesh, dim)


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
