"""Serving steps of the LM wing: prefill (build caches) and decode (one
token), the counterparts of ``repro.train.serve_step``.

Both steps run under ``torch.inference_mode()`` on the device the
parameters live on; numpy inputs are moved there.

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh`` named ``("data",
"model")`` or ``("pod", "data", "model")``, one process per card) each rank
takes and returns its own blocks of the reference's layouts:

- parameters as ``train_step.param_specs`` cuts them (``to_blocks``, or
  ``models.convert.init_blocks``): "embed" over the data axes,
  heads/kv_heads/mlp/vocab/experts/state over "model".  Every layer keeps
  its "model" blocks and computes on them (``sharding_ctx.model_split``):
  local q and kv heads, MLP columns and rows, vocab rows, with one sum over
  "model" after ``wo`` and after ``w_out`` and one in the vocab-parallel
  lookup; the rg-lru's "state" channels (an all-to-all re-pairs each
  channel's gate and signal, a reduce-scatter sums its gates, a sum
  follows ``w_out``); rwkv6's heads (a sum after ``w_o``) and channel-mix
  columns and rows (a sum before the gate); the MoE's router columns (the
  logits gathered over "model") and experts (each rank dispatches to its
  own, a sum of the combined outputs).  A weight whose "model" dim does not
  divide is replicated there and computed whole;
- caches as ``partition.cache_logical_axes`` lays them out: k/v on kv
  heads, or on slots where the kv heads do not divide "model" (decode then
  combines each rank's partial softmax over "model"), positions on slots,
  recurrent states on "state"/heads, stepped as the rank's blocks;
- logits as ``divisible_sharding(mesh, P(dp, "model"), (B, vocab))``.

The batch (prefill) and ``token``/``pos`` (decode) are given whole; each
rank takes its rows (``train_step.batch_rows``).  The decode step
writes the attention caches it is given in place, as without a mesh (the
counterpart of the reference's ``donate_argnums=(3,)``).  On a mesh of one
rank the arm computes exactly what ``mesh=None`` does.
"""
from __future__ import annotations

import weakref
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api as M
from repro_torch.models import sharding_ctx as S
from repro_torch.models.layers import LayerCache
from repro_torch.runtime import sharding as sh
from repro_torch.train import partition
from repro_torch.train import train_step as TS

__all__ = ["build_prefill_step", "build_decode_step", "cache_specs"]


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> list:
    """The ``PartitionSpec`` of every cache tensor of an (arch x shape) cell
    on ``mesh``, in the caches' own structure (None for absent fields): the
    reference's ``tree_shardings(cache_logical_axes(abstract_caches))``."""
    return partition.cache_specs(M.abstract_caches(cfg, shape), mesh)


def _named_leaves(caches, specs, name: str = ""):
    """(field or key name, tensor, spec) of every cache tensor."""
    if caches is None:
        return
    if isinstance(caches, LayerCache):
        for field, t, spec in zip(LayerCache._fields, caches, specs):
            yield from _named_leaves(t, spec, field)
    elif isinstance(caches, dict):
        for key, c in caches.items():
            yield from _named_leaves(c, specs[key], key)
    elif isinstance(caches, (list, tuple)):
        for c, spec in zip(caches, specs):
            yield from _named_leaves(c, spec, name)
    else:
        yield name, caches, specs


class _MeshArm:
    """What both mesh arms share: the parameters' specs, the batch rows',
    caches' and logits' layouts, and the scope the model runs in."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh):
        sh.check_mesh(mesh)
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.specs = TS.param_specs(cfg, mesh)
        dp = sh.batch_axes(mesh)
        b = shape.global_batch
        self.rows = partition.divisible_sharding(mesh, sh.P(dp), (b,)).spec
        self.logits = partition.divisible_sharding(mesh, sh.P(dp, "model"), (b, cfg.vocab)).spec
        batch_entry = self.rows[0] if self.rows else None
        caches = M.abstract_caches(cfg, shape)
        self.cache_dims = {}
        for name, t, spec in _named_leaves(caches, partition.cache_specs(caches, mesh)):
            if spec and spec[0] != batch_entry:
                raise ValueError(
                    f"a batch of {b} splits its rows over {batch_entry!r} but the caches' "
                    f"batch dim over {spec[0]!r}; pick a batch that divides the data axes")
            self.cache_dims[(name, tuple(t.shape[1:]))] = sh.spec_dim(spec, "model")
        self.tp = sh.axis_size(mesh, "model")
        head = "lm_head" if "lm_head" in self.specs else "embed"
        self.head_split = self.tp > 1 and sh.spec_dim(self.specs[head], "model") is not None
        self._layout = None

    def layout(self, model) -> S.ParamLayout:
        """``model``'s layout, kept for the model last served (by a weak
        reference: the step does not keep the weights alive)."""
        if self._layout is None or self._layout[0]() is not model:
            self._layout = (weakref.ref(model), S.ParamLayout(self.mesh, model, self.specs,
                                                              differentiable=False))
        return self._layout[1]

    def scope(self, model, axes: tuple[str, ...]):
        return S.activation_sharding_scope(self.mesh, layout=self.layout(model), batch_axes=axes,
                                           capacity=self.shape.seq_len,
                                           cache_dims=self.cache_dims)

    def out_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The model's logits (this rank's rows, its vocab block when the
        head is split) -> this rank's block of the logits' layout."""
        want = len(self.logits) > 1 and self.logits[1] is not None
        if self.head_split and not want:
            return sh.gather_full(logits, self.mesh, sh.P(None, "model"))
        if want and not self.head_split and self.tp > 1:
            n = logits.shape[1] // self.tp
            return logits.narrow(1, sh.axis_index(self.mesh, "model") * n, n).contiguous()
        return logits


def _check_rules(rules) -> None:
    if rules != sh.DEFAULT_RULES:
        raise ValueError("the port cuts parameter and cache blocks by DEFAULT_RULES only")


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None,
                       rules=sh.DEFAULT_RULES) -> Callable:
    """``step(params, batch) -> (last-token logits (B, V_pad) float32,
    caches)``; the caches hold ``shape.seq_len`` positions (local layers a
    ring of ``min(seq_len, local_window)``).  With ``mesh`` (module
    docstring) ``params`` are this rank's blocks, ``batch`` the whole batch,
    and the logits and caches come back as this rank's blocks.  ``rules``
    other than ``DEFAULT_RULES`` raise ``ValueError``, as in
    ``build_train_step``."""
    _check_rules(rules)
    if mesh is None:
        def step(params, batch: dict):
            dev = params.embed.device
            batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            with torch.inference_mode():
                return M.serve_prefill(cfg, params, batch, cache_capacity=shape.seq_len)

        return step

    arm = _MeshArm(cfg, shape, mesh)

    def mesh_step(params, batch: dict):
        with torch.inference_mode():
            rows, axes = TS.batch_rows(batch, mesh)
            with arm.scope(params, axes):
                logits, caches = M.serve_prefill(cfg, params, rows, cache_capacity=shape.seq_len)
            return arm.out_logits(logits), caches

    return mesh_step


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None,
                      rules=sh.DEFAULT_RULES) -> Callable:
    """``step(params, token (B,), pos (B,), caches) -> (logits (B, V_pad)
    float32, caches)``.

    The step writes the attention caches it is given in place (the
    counterpart of the reference's ``donate_argnums=(3,)``): the caches
    passed in are consumed, and only the returned ones may be used again.
    With ``mesh`` ``token`` and ``pos`` are whole, ``params`` and
    ``caches`` this rank's blocks (module docstring).
    """
    _check_rules(rules)
    if mesh is None:
        def step(params, token, pos, caches):
            dev = params.embed.device
            with torch.inference_mode():
                return M.serve_decode(cfg, params, torch.as_tensor(token, device=dev),
                                      torch.as_tensor(pos, device=dev), caches)

        return step

    arm = _MeshArm(cfg, shape, mesh)

    def mesh_step(params, token, pos, caches):
        with torch.inference_mode():
            rows, axes = TS.batch_rows({"token": token, "pos": pos}, mesh)
            with arm.scope(params, axes):
                logits, caches = M.serve_decode(cfg, params, rows["token"], rows["pos"], caches)
            return arm.out_logits(logits), caches

    return mesh_step
