"""Ambient mesh context of the LM wing, the counterpart of
``repro.models.sharding_ctx``.

The training step installs a mesh with ``activation_sharding_scope``; layer
code reads it back with ``current_mesh`` (``_block`` picks the manual
expert-parallel MoE from it, as the reference does).  Under a mesh each
rank holds every parameter as its block (``train.partition``), and layer
code calls ``gathered(module)`` where it reads a module's weights: inside,
the module's parameters are their full values, gathered differentiably
(``runtime.sharding.gather_param``).  Each repeat of the block pattern
gathers inside the function that remat checkpoints, so a recompute
gathers again and the full weights of one repeat exist at a time.

``constrain`` stays the identity: a rank's activations are its batch block
by construction, and no layout is requested of a compiler.  The scope is
process-wide, not per thread: the autograd engine runs a card's backward,
and the recompute of checkpointed repeats, on its own device thread.  The
serve steps' mesh arms are not ported yet (ROADMAP.md, Open items §1), so
``refuse_mesh`` raises for them.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

__all__ = ["activation_sharding_scope", "constrain", "current_mesh", "current_scope",
           "gathered", "full_params", "swapped", "ParamLayout", "refuse_mesh"]


def refuse_mesh(mesh) -> None:
    """Raise ``NotImplementedError`` for any mesh but None (the serve steps)."""
    if mesh is not None:
        raise NotImplementedError(
            "the LM serve steps run without a mesh in the port: their mesh arms are not "
            "ported yet (ROADMAP.md, Open items §1, 'LM mesh'); pass mesh=None"
        )


class ParamLayout:
    """Each parameter of a model as this rank's block on ``mesh``: its
    ``PartitionSpec`` and the axes it is kept local on (the manual MoE's
    experts over "model"), by tensor identity."""

    def __init__(self, mesh, model, specs: dict, keep: dict | None = None):
        self.mesh = mesh
        keep = keep or {}
        self._by_id = {id(p): (specs[name], keep.get(name, ()))
                       for name, p in model.named_parameters()}

    def full(self, p: torch.Tensor) -> torch.Tensor:
        from repro_torch.runtime.sharding import gather_param

        spec, keep = self._by_id[id(p)]
        return gather_param(p, self.mesh, spec, keep)


class Scope(NamedTuple):
    mesh: object
    layout: ParamLayout | None
    batch_axes: tuple[str, ...]     # the axes the batch is split over (none: replicated)


_scope: Scope | None = None


@contextlib.contextmanager
def activation_sharding_scope(mesh=None, rules=None, *, layout: ParamLayout | None = None,
                              batch_axes: tuple[str, ...] = ()):
    """Install ``mesh`` (a ``DeviceMesh``; None installs nothing) for layer
    code; with ``layout`` the modules' parameters are blocks to gather, and
    ``batch_axes`` names the axes the batch rows are split over.  ``rules``
    is the reference's argument: no activation layout is resolved here (the
    step resolves the parameters' with it)."""
    global _scope
    if mesh is not None:
        from repro_torch.runtime.sharding import check_mesh

        check_mesh(mesh)
        new = Scope(mesh, layout, tuple(batch_axes))
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
    """The ambient mesh (None outside a training step's scope)."""
    return _scope.mesh if _scope is not None else None


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
