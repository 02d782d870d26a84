"""Training step of the LM wing: loss -> (microbatched) gradients -> AdamW,
the counterpart of ``repro.train.train_step`` with ``mesh=None``.

The step runs eagerly on the device the model lives on, outside
``torch.inference_mode`` (the serve steps' mode, whose tensors cannot enter
autograd).  Gradients come from ``torch.autograd.grad``, never ``.grad``:
microbatches add them into accumulators of the reference's dtypes.  The
remat policies checkpoint each repeat of the block pattern
(``models.transformer._run_stacks``); the chunked loss checkpoints each
chunk's head, so the float32 logits exist one chunk at a time in the
backward as well.  The LM wing's mesh arms are not ported yet, so ``mesh=``
other than None raises ``NotImplementedError`` (ROADMAP.md, Open items §1,
"LM mesh").
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as M
from repro_torch.models import layers as L
from repro_torch.models.sharding_ctx import refuse_mesh
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_init, adamw_update,
                                         decay_mask)

__all__ = ["TrainStepConfig", "softmax_xent", "loss_and_grads", "build_train_step",
           "init_train_state"]

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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor):
    """Mean next-token cross entropy and mean squared logZ; logits (B,S,V)
    float32, labels (B,S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold), torch.mean(torch.square(logz))


def _chunk_sums(cfg, model, h, y):
    logits = M.apply_head(cfg, model, h)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum(logz - gold), torch.sum(torch.square(logz))


def _chunked_xent(cfg, tcfg: TrainStepConfig, model, hidden, labels):
    """Cross entropy and z over sequence chunks of the largest divisor of S
    that is <= ``loss_chunk``, each chunk's head recomputed in its backward;
    float32 sums divided by B*S."""
    b, s, _ = hidden.shape
    c = min(tcfg.loss_chunk, s)
    while s % c:
        c -= 1
    xent_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // c):
        xe, z = checkpoint(_chunk_sums, cfg, model, hidden[:, i * c:(i + 1) * c],
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
        xent, z = softmax_xent(logits, batch["labels"])
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


def loss_and_grads(cfg: ModelConfig, tcfg: TrainStepConfig, model, batch: dict):
    """-> (loss, {"xent", "moe_aux"}, gradients by parameter name) for a
    batch of tensors on the model's device.  With microbatches the gradients
    are summed in the accumulators' dtypes and divided by n, the loss is the
    mean over microbatches and the other metrics are the last one's."""
    policy = _POLICIES[tcfg.remat]
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)

    def one(mb):
        with torch.enable_grad():
            loss, metrics = _loss_fn(cfg, tcfg, model, mb, policy)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {name: torch.zeros_like(p) if g is None else g
                 for (name, p), g in zip(params.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

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
                     mesh=None, donate: bool = True) -> Callable:
    """Returns ``step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``batch`` holds numpy arrays or tensors (moved to the model's
    device).  ``donate=True`` updates the given model and state in place and
    returns them; ``donate=False`` leaves them untouched and returns new
    ones.  ``metrics`` are float32 0-d tensors: loss, xent, moe_aux,
    grad_norm and lr."""
    refuse_mesh(mesh)
    decay = decay_mask(cfg, M.abstract_params(cfg))

    def step(model, opt_state: OptState, batch: dict):
        dev = model.embed.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if not donate:
            model = copy.deepcopy(model)
            opt_state = OptState({k: t.clone() for k, t in opt_state.m.items()},
                                 {k: t.clone() for k, t in opt_state.v.items()},
                                 opt_state.count.clone())
        loss, metrics, grads = loss_and_grads(cfg, tcfg, model, batch)
        _, new_opt, opt_metrics = adamw_update(tcfg.optimizer, grads, opt_state, model,
                                               decay=decay)
        return model, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return step


def init_train_state(cfg: ModelConfig, tcfg: TrainStepConfig, generator: torch.Generator | None,
                     *, device="cuda", max_positions: int = 4096):
    """(model with gradients on, zero AdamW state) on ``device``, weights
    drawn from ``generator`` (a generator on that device)."""
    model = M.init_model(cfg, generator=generator, device=device, max_positions=max_positions)
    model.requires_grad_(True)
    return model, adamw_init(tcfg.optimizer, model)
