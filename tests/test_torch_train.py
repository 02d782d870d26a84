"""The port's training substrate (``repro_torch.train``) on the CPU: the LM
cases of ``tests/test_train.py`` and ``tests/test_models.py::
test_smoke_train_step`` rerun on the port at the reference's own bounds,
``adamw_update`` against the reference's on identical gradients, and the
reference's weight-decay rule, which decides by a parameter's rank in the
reference's stacked layout (ROADMAP.md §3)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch.train import flatten_state  # noqa: E402
from repro.models import api as RM  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro_torch.configs import LM_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import api as M  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.train import optimizer as PO  # noqa: E402
from repro_torch.train.data import make_batch  # noqa: E402
from repro_torch.train.train_step import (TrainStepConfig, build_train_step,  # noqa: E402
                                          init_train_state)

torch.set_num_threads(1)

SHAPE = ShapeConfig("t", 32, 4, "train")
SMOKE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _state(cfg, tcfg, seed=0):
    return init_train_state(cfg, tcfg, _gen(seed), device="cpu", max_positions=64)


def _max_diff(a: dict, b: dict) -> float:
    return max(float((x.detach().float() - b[k].detach().float()).abs().max()) for k, x in a.items())


# ------------------------------------------------ tests/test_train.py's cases

def test_overfit_fixed_batch():
    cfg = get_config("deepseek-coder-33b").reduced()
    tcfg = TrainStepConfig(optimizer=PO.AdamWConfig(lr=1e-2, warmup_steps=1))
    model, opt = _state(cfg, tcfg)
    step = build_train_step(cfg, tcfg=tcfg)
    batch = make_batch(cfg, SHAPE, 0)
    first = None
    for _ in range(15):
        model, opt, m = step(model, opt, batch)
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first - 1.0


def test_microbatch_equivalence():
    """The same batch through 1 and 4 microbatches gives the same update (up
    to accumulation rounding)."""
    cfg = get_config("gemma-7b").reduced()
    batch = make_batch(cfg, SHAPE, 0)
    outs = {}
    for n_micro in (1, 4):
        tcfg = TrainStepConfig(n_microbatches=n_micro,
                               optimizer=PO.AdamWConfig(lr=1e-3, warmup_steps=1))
        model, opt = _state(cfg, tcfg)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        step = build_train_step(cfg, tcfg=tcfg, donate=False)
        new, _, m = step(model, opt, batch)
        assert _max_diff(dict(model.named_parameters()), before) == 0.0   # untouched
        outs[n_micro] = (dict(new.named_parameters()), float(m["loss"]))
    assert _max_diff(outs[1][0], outs[4][0]) < 2e-2
    assert abs(outs[1][1] - outs[4][1]) < 5e-2


def test_remat_policies_same_loss():
    cfg = get_config("gemma2-9b").reduced()
    batch = make_batch(cfg, SHAPE, 0)
    losses = {}
    for remat in ("none", "dots", "full"):
        tcfg = TrainStepConfig(remat=remat)
        model, opt = _state(cfg, tcfg)
        _, _, m = build_train_step(cfg, tcfg=tcfg, donate=False)(model, opt, batch)
        losses[remat] = float(m["loss"])
    assert abs(losses["none"] - losses["full"]) < 1e-4
    assert abs(losses["none"] - losses["dots"]) < 1e-4


def test_adamw_against_closed_form():
    cfg = PO.AdamWConfig(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                         weight_decay=0.0, clip_norm=1e9, warmup_steps=1, total_steps=10**9)
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads = {"w": torch.tensor([0.1, 0.2, -0.3])}
    state = PO.adamw_init(cfg, params)
    new, state, metrics = PO.adamw_update(cfg, grads, state, params)
    g = np.asarray([0.1, 0.2, -0.3])
    mhat = 0.1 * g / (1 - 0.9)
    vhat = 0.001 * g**2 / (1 - 0.999)
    expected = np.asarray([1.0, -2.0, 3.0]) - 1e-2 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(new["w"].numpy(), expected, rtol=1e-4)
    assert float(metrics["grad_norm"]) == pytest.approx(np.linalg.norm(g), rel=1e-5)


def test_cosine_schedule_shape():
    cfg = PO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110)
    lr = lambda s: float(PO.cosine_schedule(cfg, torch.tensor(s)))  # noqa: E731
    assert lr(5) == pytest.approx(0.5, abs=1e-6)
    assert lr(10) == pytest.approx(1.0, abs=1e-6)
    assert lr(110) < 1e-6


def test_bf16_optimizer_state_dtype():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    tcfg = TrainStepConfig(optimizer=PO.AdamWConfig(state_dtype="bfloat16"))
    model, opt = _state(cfg, tcfg)
    assert all(t.dtype == torch.bfloat16 for t in opt.m.values())
    _, _, m = build_train_step(cfg, tcfg=tcfg, donate=False)(model, opt, make_batch(cfg, SHAPE, 0))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("arch", ["gemma-7b", "whisper-small"])
def test_chunked_loss_matches_full(arch):
    """The chunked cross-entropy (never the full logits) gives the dense loss
    up to float32 reduction order."""
    cfg = get_config(arch).reduced()
    batch = make_batch(cfg, SHAPE, 0)
    model, opt = _state(cfg, TrainStepConfig())
    losses = {}
    for chunk in (0, 8):
        step = build_train_step(cfg, tcfg=TrainStepConfig(loss_chunk=chunk), donate=False)
        losses[chunk] = float(step(model, opt, batch)[2]["loss"])
    assert abs(losses[0] - losses[8]) < 1e-3, losses


def test_vocab_padding_masked_in_logits():
    """Padded vocab slots never win an argmax or alter the loss."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), vocab=500)
    model = M.init_model(cfg, generator=_gen(), device="cpu", max_positions=64)
    batch = {k: torch.as_tensor(v) for k, v in make_batch(cfg, SHAPE, 0).items()}
    logits, _ = M.train_logits(cfg, model, batch)
    assert logits.shape[-1] == cfg.padded_vocab
    assert bool((logits[..., cfg.vocab:] < -1e30).all())
    assert int(torch.argmax(logits, -1).max()) < cfg.vocab


# ------------------------------------- tests/test_models.py's smoke train step

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_train_step(arch):
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:   # permissive capacity, as the reference's smoke tests
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    tcfg = TrainStepConfig()
    model, opt = _state(cfg, tcfg)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    new, _, metrics = build_train_step(cfg, tcfg=tcfg, donate=False)(model, opt,
                                                                     make_batch(cfg, SMOKE, 0))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0
    assert _max_diff(dict(new.named_parameters()), before) > 0


def test_donate_updates_in_place():
    cfg = get_config("qwen1.5-32b").reduced()
    tcfg = TrainStepConfig()
    model, opt = _state(cfg, tcfg)
    before = model.embed.detach().clone()
    new, new_opt, _ = build_train_step(cfg, tcfg=tcfg)(model, opt, make_batch(cfg, SMOKE, 0))
    assert new is model and new_opt.m is opt.m and int(new_opt.count) == 1
    assert not torch.equal(model.embed.detach(), before)


def test_mesh_raises():
    """A mesh is a ``torch.distributed`` ``DeviceMesh`` (the mesh step runs
    in ``tests/test_torch_lm_mesh.py``); any other object is refused."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_train_step(get_config("gemma-7b").reduced(), mesh=object())


# ------------------------------------------------ AdamW against the reference

def _reference_model(arch):
    rcfg = dataclasses.replace(ref_config(arch).reduced(), dtype="float32")
    pcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = jax.tree.map(np.asarray, RM.init_model(rcfg, jax.random.PRNGKey(0), max_positions=64))
    return rcfg, pcfg, params, convert.params_from_jax(pcfg, params, device="cpu")


def _port_tensors(pcfg, model, flat: dict) -> dict:
    out = {k: torch.empty_like(p) for k, p in model.named_parameters()}
    convert.load_reference_flat(pcfg, model, flat, out)
    return out


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-2b", "whisper-small"])
def test_adamw_update_matches_reference(arch):
    """Three steps on identical gradients (clipped: their norm is ~4x the
    limit; the third past warm-up, on the cosine): params, m and v within
    1e-6 relative of the reference's, count and lr exact."""
    cfg = PO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    rcfg, pcfg, params, model = _reference_model(arch)
    decay = PO.decay_mask(pcfg, model)
    r_params, r_state = params, RO.adamw_init(RO.AdamWConfig(**dataclasses.asdict(cfg)), params)
    state = PO.adamw_init(cfg, model)
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.1).astype(np.float32), params)
        r_params, r_state, r_metrics = RO.adamw_update(RO.AdamWConfig(**dataclasses.asdict(cfg)),
                                                       grads, r_state, r_params)
        _, state, metrics = PO.adamw_update(cfg, _port_tensors(pcfg, model, flatten_state(grads)),
                                            state, model, decay=decay)
        assert int(state.count) == int(r_state.count)
        assert np.float32(metrics["lr"].item()) == np.asarray(r_metrics["lr"])
        assert float(metrics["grad_norm"]) == pytest.approx(float(r_metrics["grad_norm"]), rel=1e-6)
    got_state = convert.opt_state_to_numpy(pcfg, model, state)
    assert got_state.count == np.asarray(r_state.count)
    got_params = convert.params_to_numpy(pcfg, model)
    for got, want in ((got_params, r_params), (got_state.m, r_state.m), (got_state.v, r_state.v)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        got, want = flatten_state(got), flatten_state(want)
        for key, w in want.items():
            err = float(np.abs(got[key] - w).max()) / max(float(np.abs(w).max()), 1e-30)
            assert err <= 1e-6, (key, err)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decay_mask_is_the_reference_rule(arch):
    """The port decays exactly the leaves the reference decays: rank >= 2 in
    the reference's stacked layout, stacked pattern norms included."""
    rcfg = ref_config(arch).reduced()
    cfg = get_config(arch).reduced()
    shapes = jax.tree.map(lambda s: np.zeros(s.shape, np.int8),
                          RM.abstract_params(rcfg, max_positions=64))
    want = {k: v.ndim >= 2 for k, v in flatten_state(shapes).items()}
    model = M.abstract_params(cfg, max_positions=64)
    got = {}
    for name, decays in PO.decay_mask(cfg, model).items():
        key, _ = convert.reference_keys(cfg, model)[name]
        assert got.setdefault(key, decays) == decays
    assert got == want


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-small"])
def test_decay_probe_moves_like_the_reference(arch):
    """Every leaf 0.5, zero gradients, lr 1e-2, decay 0.1: a decayed leaf
    moves by 5.0e-4 (to float32 rounding of 0.5 - 5e-4), the rest not at
    all, leaf for leaf as the reference's (stacked norms move, the tail's
    norms and final_norm do not)."""
    cfg = PO.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.1)
    rcfg, pcfg, params, model = _reference_model(arch)
    half = jax.tree.map(lambda a: np.full(a.shape, 0.5, np.float32), params)
    zeros = jax.tree.map(np.zeros_like, half)
    r_new, _, _ = RO.adamw_update(RO.AdamWConfig(**dataclasses.asdict(cfg)), zeros,
                                  RO.adamw_init(RO.AdamWConfig(**dataclasses.asdict(cfg)), half), half)
    want = {k: float(np.abs(np.asarray(v) - 0.5).max()) for k, v in flatten_state(r_new).items()}
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(0.5)
    grads = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    PO.adamw_update(cfg, grads, PO.adamw_init(cfg, model), model, decay=PO.decay_mask(pcfg, model))
    got = {k: float(np.abs(v - 0.5).max())
           for k, v in convert.reference_flat(pcfg, model, dict(model.named_parameters())).items()}
    assert got.keys() == want.keys()
    for key, moved in want.items():
        assert got[key] == pytest.approx(moved, rel=1e-6, abs=1e-12), key
        assert moved in (0.0, pytest.approx(5.0e-4, rel=1e-4)), key
    assert want["final_norm"] == 0.0
    stacked = "pattern/[0]/ln1" if arch == "recurrentgemma-2b" else "decoder/ln1"
    assert want[stacked] == pytest.approx(5.0e-4, rel=1e-4)
    if arch == "recurrentgemma-2b":
        assert want["tail/[0]/ln1"] == 0.0 and want["tail/[0]/rec/lam"] == 0.0
        assert want["pattern/[0]/rec/lam"] == pytest.approx(5.0e-4, rel=1e-4)
