"""Training step of the LM wing: loss -> (microbatched) gradients -> AdamW,
the counterpart of ``repro.train.train_step``.

The step runs eagerly on the device the model lives on, outside
``torch.inference_mode`` (the serve steps' mode, whose tensors cannot enter
autograd).  Gradients come from ``torch.autograd.grad``, never ``.grad``:
microbatches add them into accumulators of the reference's dtypes.  The
remat policies checkpoint each repeat of the block pattern
(``models.transformer._run_stacks``); the chunked loss checkpoints each
chunk's head, so the float32 logits exist one chunk at a time in the
backward as well.

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``, one process per
card) every rank holds the parameters, gradients and AdamW state as its
blocks of the reference's layout (``train.partition``: "embed" over the
data axes, FSDP; heads/mlp/vocab/experts/state over "model").  Each rank
computes its block of the batch rows, and every layer computes on its
"model" blocks, as the serve steps do (a weight is gathered over the data
axes only: ``sharding_ctx.ParamLayout``): local q and kv heads, MLP and
channel-mix columns and rows, rg-lru channels, rwkv6 heads, each rank's
experts, vocab rows of the embedding and the head, with the row-parallel
outputs summed over "model".  A weight whose "model" dim does not divide is whole there,
and computed whole.  The collectives over "model" are autograd pairs
(``runtime.sharding``: a tensor every "model" rank holds whole carries the
same cotangent on each), and the loss on a split head is vocab-parallel
(``softmax_xent``: a detached max over "model", the sum of each rank's
exponentials, the gold logit from the rank that holds it).  A weight's
gather over the data axes is differentiable
(``runtime.sharding.gather_param``): its backward sums the rows' gradients
over the data axes and keeps the rank's block, so no rank holds a full
gradient of the whole model.  The global norm counts each element once;
AdamW then runs on the blocks.
"""
from __future__ import annotations

import contextlib
import copy
import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as M
from repro_torch.models import layers as L
from repro_torch.models import sharding_ctx as S
from repro_torch.runtime import sharding as sh
from repro_torch.train import partition
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_init, adamw_update,
                                         decay_mask, global_norm_on_mesh)

__all__ = ["TrainStepConfig", "softmax_xent", "loss_and_grads", "build_train_step",
           "init_train_state", "batch_shardings", "batch_rows", "param_axes_for", "param_specs",
           "mesh_scope", "to_blocks"]

_POLICIES = {
    "none": None,
    "full": L.nothing_saveable,
    "dots": L.dots_with_no_batch_dims_saveable,
}


@dataclass(frozen=True)
class TrainStepConfig:
    n_microbatches: int = 1
    remat: str = "none"             # none | full | dots
    moe_aux_weight: float = 0.01
    z_loss_weight: float = 1e-4
    accum_dtype: str = "float32"    # accumulator dtype of bfloat16 gradients
    loss_chunk: int = 0             # >0: cross-entropy over sequence chunks of
                                    # this size; the (B, S, V) float32 logits
                                    # never exist at once
    optimizer: AdamWConfig = AdamWConfig()


def _logz_gold(logits: torch.Tensor, labels: torch.Tensor, split: S.Split | None):
    """(logZ, the label's logit) of every position.  With ``split`` the
    logits are this rank's block of the vocab columns: logZ from the
    detached max over "model", the sum over "model" of each rank's
    exponentials, and the gold logit from the rank that holds the label,
    summed over "model" (every rank gets both whole)."""
    if split is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return logz, gold
    m = sh.tp_max(torch.amax(logits.detach(), dim=-1), split.mesh)
    total = sh.tp_sum(torch.sum(torch.exp(logits - m[..., None]), dim=-1), split.mesh)
    n = logits.shape[-1]
    local = labels.long() - split.index * n
    mine = (local >= 0) & (local < n)
    got = torch.gather(logits, -1, torch.clamp(local, 0, n - 1)[..., None])[..., 0]
    gold = sh.tp_sum(torch.where(mine, got, torch.zeros((), dtype=got.dtype, device=got.device)),
                     split.mesh)
    return m + torch.log(total), gold


def _head_split(cfg: ModelConfig, model) -> S.Split | None:
    """``sharding_ctx.split_of`` the head's weight (the tied embedding's)."""
    tied = cfg.tie_embeddings or cfg.family == "encdec"
    return S.split_of(model, "embed" if tied else "lm_head")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, split: S.Split | None = None):
    """Mean next-token cross entropy and mean squared logZ; logits (B,S,V)
    float32 (this rank's vocab block with ``split``), labels (B,S)."""
    logz, gold = _logz_gold(logits, labels, split)
    return torch.mean(logz - gold), torch.mean(torch.square(logz))


def _chunk_sums(cfg, model, head: dict, h, y):
    with S.swapped(model, head):
        logits = M.apply_head(cfg, model, h)
        logz, gold = _logz_gold(logits, y, _head_split(cfg, model))
    return torch.sum(logz - gold), torch.sum(torch.square(logz))


def _chunked_xent(cfg, tcfg: TrainStepConfig, model, hidden, labels):
    """Cross entropy and z over sequence chunks of the largest divisor of S
    that is <= ``loss_chunk``, each chunk's head recomputed in its backward;
    float32 sums divided by B*S.  Under a mesh the head's weight is gathered
    over the data axes once and handed to every chunk; a head split over
    "model" gives each chunk's vocab-parallel sums (``_logz_gold``)."""
    b, s, _ = hidden.shape
    c = min(tcfg.loss_chunk, s)
    while s % c:
        c -= 1
    tied = cfg.tie_embeddings or cfg.family == "encdec"
    head = S.full_params(model, recurse=False, names=("embed",) if tied else ("lm_head",))
    xent_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // c):
        xe, z = checkpoint(_chunk_sums, cfg, model, head, hidden[:, i * c:(i + 1) * c],
                           labels[:, i * c:(i + 1) * c], use_reentrant=False,
                           preserve_rng_state=False)
        xent_sum, z_sum = xent_sum + xe, z_sum + z
    denom = torch.tensor(float(b * s), dtype=torch.float32, device=hidden.device)
    return xent_sum / denom, z_sum / denom


def _loss_fn(cfg: ModelConfig, tcfg: TrainStepConfig, model, batch: dict, remat_policy):
    if tcfg.loss_chunk:
        hidden, aux = M.train_hidden(cfg, model, batch, remat_policy=remat_policy)
        if "vision_embeds" in batch:
            hidden = hidden[:, batch["vision_embeds"].shape[1]:]
        xent, z = _chunked_xent(cfg, tcfg, model, hidden, batch["labels"])
    else:
        logits, aux = M.train_logits(cfg, model, batch, remat_policy=remat_policy)
        if "vision_embeds" in batch:
            # Loss on the text positions only; the stub patches carry no labels.
            logits = logits[:, batch["vision_embeds"].shape[1]:]
        xent, z = softmax_xent(logits, batch["labels"], _head_split(cfg, model))
    loss = xent + tcfg.moe_aux_weight * aux + tcfg.z_loss_weight * z
    return loss, {"xent": xent, "moe_aux": aux}


def _micro(name: str, x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """The i-th of n microbatches of one input: the batch axis is the first,
    but the second of vlm ``positions`` (3, B, S)."""
    if name == "positions" and x.dim() == 3:
        m = x.shape[1] // n
        return x[:, i * m:(i + 1) * m]
    m = x.shape[0] // n
    return x[i * m:(i + 1) * m]


def _accum_dtype(tcfg: TrainStepConfig, p: torch.Tensor) -> torch.dtype:
    if p.dtype == torch.bfloat16:
        return torch.bfloat16 if tcfg.accum_dtype == "bfloat16" else torch.float32
    return torch.promote_types(p.dtype, torch.float32)


# ------------------------------------------------------------------- layout

@functools.lru_cache(maxsize=32)
def param_axes_for(cfg: ModelConfig):
    """(abstract model on ``meta``, logical axes by parameter name), cached
    per config."""
    model = M.abstract_params(cfg)
    return model, partition.param_logical_axes(model)


def param_specs(cfg: ModelConfig, mesh) -> dict:
    """Each parameter's ``PartitionSpec`` on ``mesh`` (shape-aware: a dim
    that does not divide stays replicated)."""
    model, logical = param_axes_for(cfg)
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    return {name: ns.spec for name, ns in
            partition.tree_shardings(logical, mesh, sh.DEFAULT_RULES, shapes=shapes).items()}


def _shape(v) -> tuple:
    return tuple(v.shape) if hasattr(v, "shape") else tuple(v[0])


def batch_shardings(specs: dict, mesh) -> dict:
    """Batch dim over the data axes; vlm ``positions`` (3, B, S) has it
    second.  A batch dim that does not divide over them is replicated.
    ``specs`` maps each input to an array, a tensor or ``(shape, dtype)``."""
    dp = sh.batch_axes(mesh)

    def shard(name, shape):
        if name == "positions" and len(shape) == 3 and shape[0] == 3:
            want = sh.P(None, dp, None)
        else:
            want = sh.P(*([dp] + [None] * (len(shape) - 1)))
        return partition.divisible_sharding(mesh, want, shape)

    return {k: shard(k, _shape(v)) for k, v in specs.items()}


def batch_rows(batch: dict, mesh) -> tuple[dict, tuple[str, ...]]:
    """This rank's block of ``batch``'s rows on its device, and the axes
    the rows were split over (none when the batch dim does not divide)."""
    shardings = batch_shardings(batch, mesh)
    axes: tuple[str, ...] = ()
    for ns in shardings.values():
        for entry in ns.spec:
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return {k: sh.shard_local(torch.as_tensor(v), mesh, shardings[k].spec)
            for k, v in batch.items()}, axes


@contextlib.contextmanager
def mesh_scope(cfg: ModelConfig, model, batch: dict, mesh):
    """Installs ``mesh`` for layer code with ``model``'s parameters as this
    rank's blocks (each layer computes on its "model" blocks: logits come
    out as the rank's vocab block where the head splits), and yields this
    rank's block of ``batch``'s rows on its device (the batch scope names
    the axes the rows were split over)."""
    specs = param_specs(cfg, mesh)
    rows, axes = batch_rows(batch, mesh)
    layout = S.ParamLayout(mesh, model, specs)
    with S.activation_sharding_scope(mesh, layout=layout, batch_axes=axes):
        yield rows


# -------------------------------------------------------------------- steps

def loss_and_grads(cfg: ModelConfig, tcfg: TrainStepConfig, model, batch: dict, *, mesh=None):
    """-> (loss, {"xent", "moe_aux"}, gradients by parameter name) for a
    batch of tensors on the model's device.  With microbatches the gradients
    are summed in the accumulators' dtypes and divided by n, the loss is the
    mean over microbatches and the other metrics are the last one's.

    With ``mesh`` the model holds this rank's blocks and ``batch`` is the
    whole batch (host arrays or tensors): each microbatch takes its rows of
    the whole batch first, then this rank's block of those rows (the order
    in which the rows share an MoE capacity budget).  The gradients are the
    rank's blocks; the metrics, means over the data rows, are equal on
    every rank."""
    policy = _POLICIES[tcfg.remat]
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    if mesh is not None:
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}

    def row_mean(x):
        scope = S.current_scope()
        n = 1 if scope is None else sh.axis_size(mesh, scope.batch_axes)
        return x if n == 1 else sh.sum_over(x, mesh, scope.batch_axes) / float(n)

    def one(mb):
        scope = (contextlib.nullcontext(mb) if mesh is None
                 else mesh_scope(cfg, model, mb, mesh))
        with scope as mb, torch.enable_grad():
            loss, metrics = _loss_fn(cfg, tcfg, model, mb, policy)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            loss, metrics = row_mean(loss.detach()), {k: row_mean(v.detach())
                                                      for k, v in metrics.items()}
        grads = {name: torch.zeros_like(p) if g is None else g
                 for (name, p), g in zip(params.items(), grads)}
        return loss, metrics, grads

    n = tcfg.n_microbatches
    if n == 1:
        return one(batch)
    sums = {name: torch.zeros(p.shape, dtype=_accum_dtype(tcfg, p), device=p.device)
            for name, p in params.items()}
    loss_sum = None
    for i in range(n):
        loss, metrics, grads = one({k: _micro(k, v, n, i) for k, v in batch.items()})
        for name, g in grads.items():
            sums[name] += g.to(sums[name].dtype)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        del grads
    n_t = torch.tensor(float(n), dtype=torch.float32, device=loss_sum.device)
    return loss_sum / n_t, metrics, {name: s / n_t.to(s.dtype) for name, s in sums.items()}


def build_train_step(cfg: ModelConfig, *, tcfg: TrainStepConfig = TrainStepConfig(),
                     mesh=None, rules=sh.DEFAULT_RULES, donate: bool = True) -> Callable:
    """Returns ``step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``batch`` holds numpy arrays or tensors (moved to the model's
    device).  ``donate=True`` updates the given model and state in place and
    returns them; ``donate=False`` leaves them untouched and returns new
    ones.  ``metrics`` are float32 0-d tensors: loss, xent, moe_aux,
    grad_norm and lr.

    With ``mesh`` (a ``DeviceMesh``; anything else raises ``TypeError``)
    the model and state are this rank's blocks (``init_train_state(mesh=)``)
    and ``batch`` is the whole batch; every rank gets the same metrics.
    ``rules`` is the reference's argument: the blocks are cut by
    ``DEFAULT_RULES`` everywhere (initialization, the step, checkpoints), so
    any other value raises ``ValueError``."""
    if rules != sh.DEFAULT_RULES:
        raise ValueError("the port cuts parameter blocks by DEFAULT_RULES only")
    decay = decay_mask(cfg, M.abstract_params(cfg))
    specs = None
    if mesh is not None:
        sh.check_mesh(mesh)
        specs = param_specs(cfg, mesh)

    def step(model, opt_state: OptState, batch: dict):
        if mesh is None:
            dev = model.embed.device
            batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if not donate:
            model = copy.deepcopy(model)
            opt_state = OptState({k: t.clone() for k, t in opt_state.m.items()},
                                 {k: t.clone() for k, t in opt_state.v.items()},
                                 opt_state.count.clone())
        loss, metrics, grads = loss_and_grads(cfg, tcfg, model, batch, mesh=mesh)
        gnorm = None if mesh is None else global_norm_on_mesh(grads, mesh, specs)
        _, new_opt, opt_metrics = adamw_update(tcfg.optimizer, grads, opt_state, model,
                                               decay=decay, gnorm=gnorm)
        return model, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return step


def to_blocks(model, mesh, specs: dict):
    """Replace each parameter of ``model`` by this rank's block of it under
    ``specs`` (on the rank's device), one at a time, freeing the whole one.
    A block cut along a tensor's first dim is a contiguous view of it, which
    would keep the whole storage alive: each block is its own copy."""
    for name in [n for n, _ in model.named_parameters()]:
        path, _, leaf = name.rpartition(".")
        owner = model.get_submodule(path) if path else model
        full = owner._parameters[leaf]
        block = sh.shard_local(full.detach(), mesh, specs[name])
        if block.untyped_storage().nbytes() > block.numel() * block.element_size():
            block = block.clone()
        owner._parameters[leaf] = torch.nn.Parameter(block, requires_grad=full.requires_grad)
        del full, block
    return model


def init_train_state(cfg: ModelConfig, tcfg: TrainStepConfig, generator: torch.Generator | None,
                     *, device="cuda", max_positions: int = 4096, mesh=None):
    """(model with gradients on, zero AdamW state) on ``device``, weights
    drawn from ``generator`` (a generator on that device).  With ``mesh``
    each rank draws the whole model, as the one-card path does, and keeps
    its blocks."""
    model = M.init_model(cfg, generator=generator, device=device, max_positions=max_positions)
    if mesh is not None:
        sh.check_mesh(mesh)
        to_blocks(model, mesh, param_specs(cfg, mesh))
    model.requires_grad_(True)
    return model, adamw_init(tcfg.optimizer, model)
