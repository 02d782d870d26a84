"""Ambient mesh context of the LM wing, the counterpart of
``repro.models.sharding_ctx``.

The reference's step builders install a mesh so that layer code can
constrain activations by logical axes.  The port serves without a mesh:
``constrain`` is the identity and ``current_mesh`` is None.  The LM wing's
mesh arms are not ported yet (ROADMAP.md, Open items §1, "LM mesh"), so a
mesh passed in raises ``NotImplementedError`` instead of being ignored.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["activation_sharding_scope", "constrain", "current_mesh", "refuse_mesh"]


def refuse_mesh(mesh) -> None:
    """Raise ``NotImplementedError`` for any mesh but None."""
    if mesh is not None:
        raise NotImplementedError(
            "the LM wing runs without a mesh in the port: its mesh arms are not "
            "ported yet (ROADMAP.md, Open items §1, 'LM mesh'); pass mesh=None"
        )


@contextlib.contextmanager
def activation_sharding_scope(mesh=None):
    """The reference's scope in which layer code constrains activations on
    ``mesh``; with none it changes nothing."""
    refuse_mesh(mesh)
    yield


def constrain(x: torch.Tensor, logical: tuple[str | None, ...]) -> torch.Tensor:
    """The identity: no mesh is ever active in the port."""
    return x


def current_mesh():
    return None
