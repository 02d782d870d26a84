"""LM training on a mesh on the CPU: a gloo world of 4 processes runs the
port's mesh train step (``build_train_step(mesh=)``, ``loss_and_grads``)
on ``("data", "model")`` meshes (2, 2), (1, 4) and (4, 1), held against the
port's ``mesh=None`` step and against the reference's own mesh step.  On
(2, 2) and (1, 4) every layer computes on its "model" blocks (rwkv6 with
heads of 16, so its 4 ``reduced()`` heads split over "model").

One module fixture draws each case's weights (the port's ``init_model``
from a seeded generator, float32 ``reduced()`` configs, B=8, S=32) and
starts two things at once: the world (file-store rendezvous under
``tmp_path``, one thread per rank, a timeout), and a child with 4 fake XLA
host devices that runs the reference's ``build_train_step(mesh=)`` on a
``jax.sharding.Mesh`` of the same shape (Auto axes; ``jax.make_mesh`` gives
Explicit ones under jax 0.9.0, on which the reference's step raises), with
``adamw_update`` patched to hand back the gradients.  The tests read every
rank's results.

Bounds: gradients within 1e-4 * max |g| of the port's ``mesh=None`` step
(the GSPMD MoE keeps the global semantics, so it equals ``mesh=None`` with
dropped tokens too); loss, xent, moe_aux and grad_norm within 1e-5
(relative) of the reference's mesh step.  rwkv6-3b's gradients and
grad_norm are held at its bound of ``tests/torch_train_ref.py``, 1e-3: its
gradient is ill-conditioned (``tests/test_torch_train_parity.py``), and a
rank's split of the heads rounds differently (on the (1, 4) case's weights
one float32 ulp on every weight moves the ``mesh=None`` gradients by
6.5e-4 * max |g|).  The manual expert-parallel MoE
computes a different function (a local capacity; its aux is each data
row's statistic averaged over the data axes), so it is held to the
reference's manual mesh step alone: logits, aux and every gradient.
"""
import contextlib
import io
import os
import pickle
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro_torch.launch.train as port_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import api as M  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import sharding_ctx as S  # noqa: E402
from repro_torch.train import build_decode_step, build_prefill_step, make_batch  # noqa: E402
from repro_torch.train.train_step import (TrainStepConfig, build_train_step,  # noqa: E402
                                          init_train_state, loss_and_grads)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 300
SHAPE = ShapeConfig("t", 32, 8, "train")
GRAD_REL = 1e-4
METRIC_REL = 1e-5
ILL_CONDITIONED = {"rwkv6-3b": 1e-3}    # gradients and grad_norm (tests/torch_train_ref.py)
MANUAL_VS_GSPMD = 1e-3          # the reference's own bound (tests/test_distributed.py)
ADAMW_REL = 1e-6
TRAIN_ARCH = "granite-moe-1b-a400m"
REMAT_FULL = dict(remat="full", loss_chunk=16, n_microbatches=2)
HEADS_16 = dict(rwkv_head_dim=16)
CASES = {
    "gemma2": dict(arch="gemma2-9b", mesh=(2, 2)),
    "gemma2_remat_full": dict(arch="gemma2-9b", mesh=(2, 2), tcfg=REMAT_FULL),
    "gemma2_remat_dots": dict(arch="gemma2-9b", mesh=(2, 2), tcfg=dict(remat="dots")),
    # capacity factor 1: tokens drop, in each of 2 microbatches
    "granite_drop": dict(arch=TRAIN_ARCH, mesh=(2, 2), cf=1.0, tcfg=dict(n_microbatches=2)),
    "granite_drop_4x1": dict(arch=TRAIN_ARCH, mesh=(4, 1), cf=1.0, tcfg=dict(n_microbatches=2)),
    "recurrentgemma": dict(arch="recurrentgemma-2b", mesh=(2, 2)),
    "rwkv6_4h": dict(arch="rwkv6-3b", mesh=(2, 2), change=HEADS_16),
    "qwen2vl": dict(arch="qwen2-vl-7b", mesh=(2, 2)),
    "whisper": dict(arch="whisper-small", mesh=(2, 2)),
    "granite_manual": dict(arch=TRAIN_ARCH, mesh=(2, 2), impl="manual"),
    # (1, 4): every "model" dim of 4 splits 4 ways; 2 kv heads stay whole
    "gemma2_1x4": dict(arch="gemma2-9b", mesh=(1, 4)),
    "gemma2_remat_full_1x4": dict(arch="gemma2-9b", mesh=(1, 4), tcfg=REMAT_FULL),
    "granite_drop_1x4": dict(arch=TRAIN_ARCH, mesh=(1, 4), cf=1.0, tcfg=dict(n_microbatches=2)),
    "recurrentgemma_1x4": dict(arch="recurrentgemma-2b", mesh=(1, 4)),
    "rwkv6_4h_1x4": dict(arch="rwkv6-3b", mesh=(1, 4), change=HEADS_16),
    "qwen2vl_1x4": dict(arch="qwen2-vl-7b", mesh=(1, 4)),
    "whisper_1x4": dict(arch="whisper-small", mesh=(1, 4)),
}
GSPMD = [k for k, c in CASES.items() if c.get("impl") != "manual"]
LOG = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})  gnorm (\d+\.\d{2})  lr \S+  tok/s [\d,]+$")


def case_config(case: dict, *, get=get_config, impl=None, cf=None):
    """The float32 ``reduced()`` config of a case (with the case's
    ``change``; MoE implementation and capacity factor as the case or the
    caller sets them)."""
    import dataclasses

    cfg = dataclasses.replace(get(case["arch"]).reduced(), dtype="float32",
                              **case.get("change", {}))
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, capacity_factor=cf or case.get("cf", cfg.moe.capacity_factor))
        cfg = dataclasses.replace(cfg, moe=moe, moe_impl=impl or case.get("impl", "gspmd"))
    return cfg


_RANK = textwrap.dedent(
    r"""
    import contextlib, datetime, io, os, pickle, shutil, sys, traceback
    rank, world, store, work, src = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
    sys.path.insert(0, src)
    sys.path.insert(0, os.path.join(os.path.dirname(src), "tests"))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=240))
    from test_torch_lm_mesh import CASES, TRAIN_ARCH, case_config
    import repro_torch.launch.train as port_train
    import repro_torch.models.moe as moe_mod
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import describe, make_mesh, make_production_mesh
    from repro_torch.models import api as M
    from repro_torch.models.convert import load_reference_flat
    from repro_torch.runtime import sharding as sh
    from repro_torch.train import build_decode_step, build_prefill_step
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                             global_norm_on_mesh)
    from repro_torch.train.train_step import (TrainStepConfig, build_train_step, loss_and_grads,
                                              mesh_scope, param_specs, to_blocks)

    res = {}
    meshes = {}

    def record(name, fn):
        try:
            res[name] = fn()
        except Exception:
            res[name] = {"error": traceback.format_exc()}

    def model_of(cfg, name, mesh):
        model = M.init_model(cfg, generator=None, device="cpu", max_positions=64)
        flat = dict(np.load(os.path.join(work, f"w_{name}.npz")))
        load_reference_flat(cfg, model, flat, dict(model.named_parameters()))
        return to_blocks(model, mesh, param_specs(cfg, mesh))

    dropped = []
    route = moe_mod.moe_route
    def counting_route(*a, **k):
        routes, frac = route(*a, **k)
        dropped.append(sum(int((~r.keep).sum()) for r in routes))
        return routes, frac
    moe_mod.moe_route = counting_route

    for name, case in CASES.items():
        def one(name=name, case=case):
            shape = tuple(case["mesh"])
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, ("data", "model"))
            mesh = meshes[shape]
            cfg = case_config(case)
            batch = dict(np.load(os.path.join(work, f"b_{name}.npz")))
            model = model_of(cfg, name, mesh)
            specs = param_specs(cfg, mesh)
            tcfg = TrainStepConfig(**case.get("tcfg", {}))
            dropped.clear()
            loss, metrics, grads = loss_and_grads(cfg, tcfg, model, batch, mesh=mesh)
            out = {"metrics": {"loss": float(loss), **{k: float(v) for k, v in metrics.items()},
                               "grad_norm": float(global_norm_on_mesh(grads, mesh, specs))},
                   "dropped": sum(dropped)}
            full = {k: sh.gather_full(g, mesh, specs[k]).numpy() for k, g in grads.items()}
            if rank == 0:
                out["grads"] = full
            if name in ("gemma2", "gemma2_1x4", "granite_manual"):
                # the whole step: its metrics, and AdamW on the blocks vs whole
                step = build_train_step(cfg, tcfg=tcfg, mesh=mesh, donate=False)
                opt = adamw_init(tcfg.optimizer, model)
                new, new_opt, m = step(model, opt, batch)
                out["step_metrics"] = {k: float(v) for k, v in m.items()}
                out["donated_untouched"] = bool(int(opt.count) == 0 and int(new_opt.count) == 1)
                ocfg = AdamWConfig(lr=1e-2, warmup_steps=1)
                whole = M.init_model(cfg, generator=None, device="cpu", max_positions=64)
                flat = dict(np.load(os.path.join(work, f"w_{name}.npz")))
                load_reference_flat(cfg, whole, flat, dict(whole.named_parameters()))
                g_full = {k: torch.from_numpy(v) for k, v in full.items()}
                blocks = {k: t.detach().clone() for k, t in model.named_parameters()}
                g_blocks = {k: sh.shard_local(g, mesh, specs[k]) for k, g in g_full.items()}
                params = {k: t.detach().clone() for k, t in whole.named_parameters()}
                ob, ow = adamw_init(ocfg, blocks), adamw_init(ocfg, params)
                for _ in range(2):
                    _, ob, mb = adamw_update(ocfg, g_blocks, ob, blocks,
                                             gnorm=global_norm_on_mesh(g_blocks, mesh, specs))
                    _, ow, mw = adamw_update(ocfg, g_full, ow, params)
                errs = [abs(float(mb["grad_norm"]) - float(mw["grad_norm"])) / float(mw["grad_norm"])]
                for a, b in ((blocks, params), (ob.m, ow.m), (ob.v, ow.v)):
                    for k in a:
                        want = sh.shard_local(b[k], mesh, specs[k])
                        errs.append(float((a[k] - want).abs().max()) /
                                    max(float(b[k].abs().max()), 1e-30))
                out["adamw_max_rel_err"] = max(errs)
            if name == "granite_manual":
                def whole(lg):
                    # this rank's rows, and its vocab block where the head splits
                    cols = "model" if lg.shape[-1] < cfg.padded_vocab else None
                    return sh.gather_full(lg, mesh, sh.P(sh.batch_axes(mesh), None, cols)).numpy()
                with torch.no_grad(), mesh_scope(cfg, model, batch, mesh) as rows:
                    logits, aux = M.train_logits(cfg, model, rows)
                    out["logits"] = whole(logits)
                    out["aux"] = float(aux)
                # manual vs gspmd at capacity factor E (no token dropped)
                for impl in ("manual", "gspmd"):
                    c = case_config(case, impl=impl, cf=float(cfg.moe.n_experts))
                    with torch.no_grad(), mesh_scope(c, model, batch, mesh) as rows:
                        lg, _ = M.train_logits(c, model, rows)
                    out[f"logits_cfE_{impl}"] = whole(lg)
            return out
        record(name, one)

    def production():
        a, b = make_production_mesh(), make_production_mesh(multi_pod=True)
        return {"pod": (tuple(a.shape), describe(a)), "multipod": (tuple(b.shape), describe(b))}
    record("production", production)

    def refusals():
        # both serve steps build on the training mesh: each step's name ->
        # whether it built (tests/test_torch_lm_serve_mesh.py runs the arms)
        mesh = meshes[(2, 2)]
        cfg = case_config(CASES["gemma2"])
        shape = ShapeConfig("serve", 16, 4, "prefill")
        return {nm: callable(build(cfg, shape, mesh=mesh))
                for nm, build in (("prefill", build_prefill_step), ("decode", build_decode_step))}
    record("refusals", refusals)

    def train_cli():
        ck = os.path.join(work, "ck_mesh")
        base = ["--arch", TRAIN_ARCH, "--reduced", "--device", "cpu", "--mesh", "pod",
                "--log-every", "1", "--checkpoint-every", "2"]
        logs = {}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            port_train.main(base + ["--steps", "2", "--checkpoint-dir", ck])
        logs["mesh"] = buf.getvalue().splitlines()
        # a checkpoint written without a mesh, resumed on the mesh
        ck_none = os.path.join(work, f"ck_none_rank{rank}")
        shutil.copytree(os.path.join(work, "ck_none"), ck_none)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            port_train.main(base + ["--steps", "4", "--checkpoint-dir", ck_none])
        logs["resumed_on_mesh"] = buf.getvalue().splitlines()
        return logs
    record("train_cli", train_cli)

    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    """
)

_REF = textwrap.dedent(
    r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    work, src = sys.argv[1], sys.argv[2]
    sys.path.insert(0, os.path.join(os.path.dirname(src), "tests"))
    from unittest import mock
    import jax
    import jax.numpy as jnp
    import numpy as np
    from test_torch_lm_mesh import CASES, case_config
    from repro.configs import get_config
    from repro.launch.train import flatten_state, unflatten_like
    from repro.models import api as RM
    from repro.models.sharding_ctx import activation_sharding_scope
    from repro.train import optimizer as RO
    from repro.train import train_step as RS

    def hand_back(cfg, grads, state, params):
        return grads, state, {"grad_norm": RO.global_norm(grads), "lr": jnp.zeros((), jnp.float32)}

    out = {}
    for name, case in CASES.items():
        cfg = case_config(case, get=get_config)
        mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(case["mesh"]), ("data", "model"))
        flat = dict(np.load(os.path.join(work, f"w_{name}.npz")))
        params = unflatten_like(RM.abstract_params(cfg, max_positions=64), flat)
        batch = {k: jnp.asarray(v) for k, v in np.load(os.path.join(work, f"b_{name}.npz")).items()}
        tcfg = RS.TrainStepConfig(**case.get("tcfg", {}))
        with mock.patch.object(RS, "adamw_update", hand_back):
            step = RS.build_train_step(cfg, tcfg=tcfg, mesh=mesh, donate=False)
            grads, _, m = step(params, RO.adamw_init(RO.AdamWConfig(), params), batch)
        row = {"metrics": {k: float(v) for k, v in m.items()},
               "grads": flatten_state(jax.tree.map(np.asarray, grads))}
        if case.get("impl") == "manual":
            def fwd(p, b):
                with activation_sharding_scope(mesh, None):
                    return RM.train_logits(cfg, p, b)
            logits, aux = jax.jit(fwd)(params, batch)
            row["logits"], row["aux"] = np.asarray(logits), float(aux)
        out[name] = row
    with open(os.path.join(work, "reference.pkl"), "wb") as f:
        pickle.dump(out, f)
    """
)


def _cli_lines(argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_train.main(argv)
    return buf.getvalue().splitlines()


def _train_argv(ck, steps):
    return ["--arch", TRAIN_ARCH, "--reduced", "--device", "cpu", "--log-every", "1",
            "--checkpoint-every", "2", "--steps", str(steps), "--checkpoint-dir", ck]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("lm_mesh"))
    inputs = {}
    for i, (name, case) in enumerate(CASES.items()):
        cfg = case_config(case)
        model = M.init_model(cfg, generator=torch.Generator().manual_seed(100 + i), device="cpu",
                             max_positions=64)
        np.savez(os.path.join(work, f"w_{name}.npz"),
                 **convert.reference_flat(cfg, model, dict(model.named_parameters())))
        batch = make_batch(cfg, SHAPE, i)
        np.savez(os.path.join(work, f"b_{name}.npz"), **batch)
        inputs[name] = (cfg, model, batch)
    # a checkpoint at step 2 written without a mesh, for the world to resume
    none_lines = _cli_lines(["--mesh", "none"] + _train_argv(os.path.join(work, "ck_none"), 2))

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    src = os.path.join(REPO, "src")
    rank_py, ref_py = os.path.join(work, "rank.py"), os.path.join(work, "ref.py")
    with open(rank_py, "w") as f:
        f.write(_RANK)
    with open(ref_py, "w") as f:
        f.write(_REF)
    store = os.path.join(work, "store")
    procs = [subprocess.Popen([sys.executable, rank_py, str(r), str(WORLD), store, work, src],
                              cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    ref = subprocess.Popen([sys.executable, ref_py, work, src], cwd=work, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    errs = []
    for p in procs + [ref]:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode != 0:
            errs.append(err[-4000:])
    assert not errs, errs
    ranks = [pickle.load(open(os.path.join(work, f"rank{r}.pkl"), "rb")) for r in range(WORLD)]
    reference = pickle.load(open(os.path.join(work, "reference.pkl"), "rb"))
    unsharded = {}
    for name in GSPMD:
        cfg, model, batch = inputs[name]
        tcfg = TrainStepConfig(**CASES[name].get("tcfg", {}))
        unsharded[name] = loss_and_grads(cfg, tcfg, model,
                                         {k: torch.as_tensor(v) for k, v in batch.items()})
    return dict(work=work, inputs=inputs, ranks=ranks, reference=reference, unsharded=unsharded,
                none_lines=none_lines)


def _result(world, name, rank=0):
    res = world["ranks"][rank][name]
    assert "error" not in res, res.get("error")
    return res


def _rel(got, want):
    return abs(got - want) / abs(want) if want else abs(got)


def _max_rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree(world, name):
    """Every rank's loss, xent, moe_aux and grad_norm are the same bits."""
    metrics = [_result(world, name, r)["metrics"] for r in range(WORLD)]
    assert all(m == metrics[0] for m in metrics), metrics


@pytest.mark.parametrize("name", GSPMD)
def test_mesh_step_matches_unsharded(world, name):
    """The gathered gradients equal the port's ``mesh=None`` step's, and so
    do the metrics; the tight-capacity MoE cases do drop tokens."""
    res = _result(world, name)
    loss, metrics, grads = world["unsharded"][name]
    want = {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}}
    for k, v in want.items():
        assert _rel(res["metrics"][k], v) <= METRIC_REL, (k, res["metrics"], want)
    worst = {k: _max_rel(res["grads"][k], g.numpy()) for k, g in grads.items()}
    bound = ILL_CONDITIONED.get(CASES[name]["arch"], GRAD_REL)
    assert max(worst.values()) <= bound, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    if "cf" in CASES[name]:
        assert all(_result(world, name, r)["dropped"] > 0 for r in range(WORLD))


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_reference_mesh_step(world, name):
    """Loss, xent, moe_aux and grad_norm within 1e-5 of the reference's own
    mesh step on the same weights and batch."""
    res, ref = _result(world, name), world["reference"][name]["metrics"]
    for k in ("loss", "xent", "moe_aux", "grad_norm"):
        bound = (ILL_CONDITIONED.get(CASES[name]["arch"], METRIC_REL) if k == "grad_norm"
                 else METRIC_REL)
        assert _rel(res["metrics"][k], ref[k]) <= bound, (k, res["metrics"], ref)


def test_manual_moe_matches_reference_manual_step(world):
    """The manual MoE's logits, aux and every gradient against the
    reference's manual mesh step; its aux is the data rows' local statistic
    averaged, not the global one of the GSPMD layer."""
    name = "granite_manual"
    res, ref = _result(world, name), world["reference"][name]
    cfg, model, _ = world["inputs"][name]
    assert _max_rel(res["logits"], ref["logits"]) <= METRIC_REL
    assert _rel(res["aux"], ref["aux"]) <= METRIC_REL
    got = convert.reference_flat(cfg, model, {k: torch.from_numpy(v) for k, v in res["grads"].items()})
    assert set(got) == set(ref["grads"])
    worst = {k: _max_rel(got[k], ref["grads"][k]) for k in got}
    assert max(worst.values()) <= GRAD_REL, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    # the same weights on the GSPMD layer give the global statistic instead
    import dataclasses

    gspmd = dataclasses.replace(cfg, moe_impl="gspmd")
    _, metrics, _ = loss_and_grads(gspmd, TrainStepConfig(), model,
                                   {k: torch.as_tensor(v) for k, v in world["inputs"][name][2].items()})
    assert _rel(res["metrics"]["moe_aux"], float(metrics["moe_aux"])) > 1e-4


def test_manual_matches_gspmd_at_capacity_e(world):
    """The reference's own check: with capacity factor E no token drops, and
    the manual layer's logits equal the GSPMD layer's within 1e-3."""
    res = _result(world, "granite_manual")
    err = float(np.abs(res["logits_cfE_manual"] - res["logits_cfE_gspmd"]).max())
    assert err < MANUAL_VS_GSPMD, err


@pytest.mark.parametrize("name", ["gemma2", "gemma2_1x4", "granite_manual"])
def test_whole_step_and_adamw_on_blocks(world, name):
    """``build_train_step(mesh=)``'s metrics are ``loss_and_grads``' and the
    mesh global norm's; ``donate=False`` leaves the state alone; AdamW on
    the blocks equals the blocks of the whole update on the same gradients
    (two steps) within 1e-6."""
    for r in range(WORLD):
        res = _result(world, name, r)
        for k in ("loss", "xent", "moe_aux", "grad_norm"):
            assert res["step_metrics"][k] == res["metrics"][k], (k, res)
        assert res["donated_untouched"]
        assert res["adamw_max_rel_err"] <= ADAMW_REL, res["adamw_max_rel_err"]


def _losses(lines):
    return {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
            for m in map(LOG.match, lines) if m}


def test_launch_train_on_a_mesh(world, tmp_path):
    """``launch/train.py --mesh pod`` on the gloo world: rank 0 alone prints
    the reference's log lines, which match ``--mesh none`` at the printed
    precision; its checkpoint resumes with ``--mesh none``, and a checkpoint
    written without a mesh resumes on the mesh."""
    logs = [_result(world, "train_cli", r) for r in range(WORLD)]
    assert all(not lg["mesh"] and not lg["resumed_on_mesh"] for lg in logs[1:])
    mesh, resumed_on_mesh = logs[0]["mesh"], logs[0]["resumed_on_mesh"]
    assert mesh[0] == "mesh data=4xmodel=1" and mesh[-1] == "done.", mesh
    assert resumed_on_mesh[1] == "resumed from step 2", resumed_on_mesh
    whole = _losses(_cli_lines(["--mesh", "none"] + _train_argv(str(tmp_path / "whole"), 4)))
    ck = str(tmp_path / "ck")
    shutil.copytree(os.path.join(world["work"], "ck_mesh"), ck)
    resumed = _cli_lines(["--mesh", "none"] + _train_argv(ck, 4))
    assert resumed[0] == "resumed from step 2"
    runs = {"mesh": _losses(mesh), "none": _losses(world["none_lines"]),
            "resumed_without_mesh": _losses(resumed), "resumed_on_mesh": _losses(resumed_on_mesh)}
    assert set(runs["mesh"]) == {1, 2} and set(runs["resumed_on_mesh"]) == {3, 4}
    for label, run in runs.items():
        for step, (loss, gnorm) in run.items():
            assert abs(loss - whole[step][0]) <= 2e-4 and abs(gnorm - whole[step][1]) <= 0.011, \
                (label, step, run, whole)


def test_blocks_hold_their_own_storage():
    """``to_blocks`` keeps no whole tensor alive: a block cut along the
    first dim (a contiguous view) is copied; each block equals its cut."""
    from types import SimpleNamespace

    from repro_torch.runtime import sharding as sh
    from repro_torch.train.train_step import param_specs, to_blocks

    cfg = case_config(CASES["gemma2"])
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 1), device_type="cpu",
                           get_coordinate=lambda: [1, 0])
    model = M.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    whole = {k: t.detach().clone() for k, t in model.named_parameters()}
    specs = param_specs(cfg, mesh)
    to_blocks(model, mesh, specs)
    cut_first = 0
    for name, p in model.named_parameters():
        assert p.untyped_storage().nbytes() == p.numel() * p.element_size(), name
        assert torch.equal(p.detach(), sh.shard_local(whole[name], mesh, specs[name])), name
        cut_first += specs[name][0] is not None
    assert cut_first > 0


def test_production_mesh_and_refusals(world):
    """``make_production_mesh`` on a world of 4: FSDP over "data"; the serve
    steps accept a ``DeviceMesh``; anything but a ``DeviceMesh`` is a
    ``TypeError``."""
    prod = _result(world, "production")
    assert prod["pod"] == ((4, 1), "data=4xmodel=1")
    assert prod["multipod"] == ((2, 2, 1), "pod=2xdata=2xmodel=1")
    refusals = _result(world, "refusals")
    assert refusals == {"prefill": True, "decode": True}, refusals
    for build in (build_prefill_step, build_decode_step):
        with pytest.raises(TypeError, match="DeviceMesh"):
            build(case_config(CASES["gemma2"]), ShapeConfig("serve", 16, 4, "prefill"),
                  mesh=object())
    cfg = case_config(CASES["gemma2"])
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_train_step(cfg, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        init_train_state(cfg, TrainStepConfig(), None, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        with S.activation_sharding_scope(object()):
            pass


def test_other_rules_are_refused():
    """Blocks are cut by ``DEFAULT_RULES`` at initialization, in the step
    and in checkpoints alike, so ``build_train_step`` refuses other rules
    rather than cut blocks that disagree."""
    from repro_torch.runtime import sharding as sh

    other = sh.LogicalAxisRules(rules=sh.DEFAULT_RULES.rules[1:])
    with pytest.raises(ValueError, match="DEFAULT_RULES"):
        build_train_step(case_config(CASES["gemma2"]), rules=other)


def test_checkpoint_restores_one_key_at_a_time(tmp_path):
    """A checkpoint streamed to disk key by key (``state_items``) restores
    on a mesh from the open file: each key is read from disk once, and the
    rank ((1, 0) of a (4, 1) mesh) keeps its blocks, equal to the cuts of
    the saved parameters, m and v."""
    from types import SimpleNamespace

    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.checkpoint import TrainCheckpoint
    from repro_torch.train.optimizer import OptState, adamw_init
    from repro_torch.train.train_step import param_specs, to_blocks

    cfg = case_config(CASES["granite_drop"])
    tcfg = TrainStepConfig()
    model, opt = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    opt = OptState({k: torch.randn(t.shape, generator=gen) for k, t in opt.m.items()},
                   {k: torch.rand(t.shape, generator=gen) for k, t in opt.v.items()},
                   torch.tensor(3, dtype=torch.int32))
    ck = TrainCheckpoint(str(tmp_path))
    ck.save(3, port_train.state_items(cfg, model, opt))

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 1), device_type="cpu",
                           get_coordinate=lambda: [1, 0])
    specs = param_specs(cfg, mesh)
    fresh, _ = init_train_state(cfg, tcfg, torch.Generator().manual_seed(2), device="cpu")
    to_blocks(fresh, mesh, specs)
    fresh_opt = adamw_init(tcfg.optimizer, fresh)

    class Reads:
        def __init__(self, z):
            self.z, self.n = z, {}

        def __getitem__(self, key):
            self.n[key] = self.n.get(key, 0) + 1
            return self.z[key]

    with ck.open() as (step, z):
        reads = Reads(z)
        fresh_opt = port_train.restore_state(cfg, fresh, fresh_opt, reads, mesh=mesh)
        files = set(z.files)
    assert step == 3 and set(reads.n) == files and set(reads.n.values()) == {1}, reads.n
    assert int(fresh_opt.count) == 3
    saved = {"p": dict(model.named_parameters()), "m": opt.m, "v": opt.v}
    restored = {"p": dict(fresh.named_parameters()), "m": fresh_opt.m, "v": fresh_opt.v}
    cut_first = 0
    for part, tensors in saved.items():
        for name, whole in tensors.items():
            want = sh.shard_local(whole.detach(), mesh, specs[name])
            assert torch.equal(restored[part][name].detach(), want), (part, name)
            cut_first += part == "p" and specs[name][0] is not None
    assert cut_first > 0
