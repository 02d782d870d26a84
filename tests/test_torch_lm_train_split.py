"""The "model" collectives' autograd pairs and the split LM train step, on
the CPU in gloo worlds of 2 and 4 processes (``("data", "model")`` meshes
(1, 2) and (1, 4)).

Each pair of ``runtime.sharding`` is held, in float64, against the
gradient of the same function computed whole on one process: the rank's
gradient of each input it holds equals the whole gradient (its block, for
a block) within 1e-12 * max |g|.  The functions end in a tensor every rank
holds whole, as a train step's loss is (the rule of ``runtime.sharding``):

- ``tp_enter`` -> a rank's columns and rows of an MLP -> ``tp_sum``;
- ``tp_scatter_sum`` of partials, each rank's block of the loss summed;
- ``tp_gather`` of blocks; ``tp_block`` of a whole tensor;
- ``tp_all_to_all`` re-pairing an rg-lru ``w_branch``'s gate and signal
  columns (``rglru._pairing``); its backward's split sizes are also
  replayed for 2, 3, 4 and 8 ranks without a world;
- ``vocab_lookup`` and the vocab-parallel cross entropy of
  ``train_step.softmax_xent`` on a tied table.

In the world of 4, one train step (``loss_and_grads`` on a (1, 4) mesh)
of gemma2, granite (GSPMD), recurrentgemma and rwkv6 with 4 heads of 16
logs every parameter gather and every all-gather over "model": no
parameter is gathered over "model", and the only "model" all-gathers are
the activations the split needs (the MoE router's logit columns, the
rg-lru gates' cotangents, the cotangents of rwkv6's narrowed whole
parameters), so no weight and no recurrent state crosses "model".  Every
rank's metrics, and its gradients of the parameters every "model" rank
holds whole, are the same bits.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
WORLDS = (2, 4)
REL = 1e-12
PAIRS = ("enter_sum", "scatter_sum", "gather", "block", "all_to_all", "vocab_xent")
# (1, 4) train-step cells: arch, config changes, and the shapes of the
# all-gathers over "model" the step may issue (B=8, S=32 of reduced())
STEP_ARCHS = {
    "gemma2-9b": ({}, set()),
    "granite-moe-1b-a400m": ({}, {(256, 1)}),               # router logits, E/4 columns
    "recurrentgemma-2b": ({}, {(8, 32, 2, 16)}),            # gates' cotangent, w/4 channels
    "rwkv6-3b": (dict(rwkv_head_dim=16), {(1, 16)}),        # decay_base/bonus/ln_x cotangents
}

_RANK = textwrap.dedent(
    r"""
    import dataclasses, datetime, os, pickle, sys, traceback
    rank, world, store, work, src = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=240))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api as M
    from repro_torch.models import sharding_ctx as S
    from repro_torch.models.rglru import _pairing
    from repro_torch.runtime import sharding as sh
    from repro_torch.train import make_batch
    from repro_torch.train.train_step import (TrainStepConfig, loss_and_grads, param_specs,
                                              softmax_xent, to_blocks)

    with open(os.path.join(work, "plan.pkl"), "rb") as f:
        plan = pickle.load(f)
    mesh = make_mesh((1, world), ("data", "model"))
    n, r = world, rank
    res = {}

    def record(name, fn):
        try:
            res[name] = fn()
        except Exception:
            traceback.print_exc()
            res[name] = {"error": traceback.format_exc()}

    def leaf(a):
        return torch.tensor(a, dtype=torch.float64, requires_grad=True)

    def grads(loss, *xs):
        return [g.numpy() for g in torch.autograd.grad(loss, xs)]

    def cols(a, k):
        # rank r's block of the last dim of a (of n blocks)
        w = a.shape[-1] // n
        return a[..., r * w:(r + 1) * w]

    rng = np.random.default_rng(11)
    d, f, m = 6, 4 * n, 5
    x0, w0, v0, c0 = (rng.normal(size=s) for s in ((m, d), (d, f), (f, d), (m, d)))

    def enter_sum():
        x, w, v = leaf(x0), leaf(cols(w0, n)), leaf(cols(v0.T, n).T.copy())
        out = sh.tp_sum(torch.tanh(sh.tp_enter(x, mesh) @ w) @ v, mesh)
        return grads(torch.sum(torch.tensor(c0) * out ** 2), x, w, v)
    record("enter_sum", enter_sum)

    p0 = rng.normal(size=(n, m, 2 * n))        # each rank's partial, rank-indexed
    c1 = rng.normal(size=(m, 2 * n))

    def scatter_sum():
        p = leaf(p0[r])
        out = sh.tp_scatter_sum(p, mesh, dim=1)
        loss = sh.tp_sum(torch.sum(torch.tensor(cols(c1, n)) * out ** 2), mesh)
        return grads(loss, p)
    record("scatter_sum", scatter_sum)

    def gather():
        x = leaf(cols(c1, n).copy())
        out = sh.tp_gather(x, mesh, dim=1)
        return grads(torch.sum(torch.tensor(c1) * out ** 3), x)
    record("gather", gather)

    def block():
        x = leaf(c1)
        out = sh.tp_block(x, mesh, dim=1)
        loss = sh.tp_sum(torch.sum(torch.tensor(cols(p0[0], n)) * out ** 3), mesh)
        return grads(loss, x)
    record("block", block)

    width = 6 * n
    a0 = rng.normal(size=(m, 2 * width))
    c2 = rng.normal(size=(m, 2 * width))       # a coefficient per received column

    def all_to_all():
        a = leaf(cols(a0, n).copy())
        send, recv = _pairing(width, n, r)
        got = sh.tp_all_to_all([a[:, lo:hi] for lo, hi in send], recv, mesh, dim=1)
        coef = np.concatenate([c2[:, r * (width // n):(r + 1) * (width // n)],
                               c2[:, width + r * (width // n):width + (r + 1) * (width // n)]], 1)
        loss = sh.tp_sum(torch.sum(torch.tensor(coef) * got ** 2), mesh)
        return grads(loss, a)
    record("all_to_all", all_to_all)

    vocab, b, s = 8 * n, 2, 5
    table0 = rng.normal(size=(vocab, d))
    ids0 = rng.integers(0, vocab, (b, s))
    labels0 = rng.integers(0, vocab, (b, s))

    def vocab_xent():
        t = leaf(cols(table0.T, n).T.copy())
        split = S.Split(mesh, n, r, None, {})
        h = torch.tanh(sh.vocab_lookup(t, torch.tensor(ids0), mesh))
        logits = sh.tp_enter(h, mesh) @ t.T
        xent, z = softmax_xent(logits, torch.tensor(labels0), split)
        g, = grads(xent + 0.1 * z, t)
        return [g, np.array([float(xent.detach()), float(z.detach())])]
    record("vocab_xent", vocab_xent)

    if world == 4:
        for arch, change in plan["steps"].items():
            def step(arch=arch, change=change):
                cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32", **change)
                model = M.init_model(cfg, generator=torch.Generator().manual_seed(7), device="cpu",
                                     max_positions=64)
                specs = param_specs(cfg, mesh)
                to_blocks(model, mesh, specs)
                names = {id(p): k for k, p in model.named_parameters()}
                batch = make_batch(cfg, ShapeConfig("t", 32, 8, "train"), 0)
                gathers, model_gathers = [], []
                plain_block, plain_cat = sh.gather_block, sh._gather_cat
                def logged_block(blk, m, spec, keep=()):
                    gathers.append((names.get(id(blk), "?"),
                                    tuple(a for e in spec for a in sh._names(e)
                                          if a not in keep and sh.axis_size(m, a) > 1)))
                    return plain_block(blk, m, spec, keep)
                def logged_cat(x, m, name, dim):
                    if name == "model" and sh.axis_size(m, name) > 1:
                        model_gathers.append(tuple(x.shape))
                    return plain_cat(x, m, name, dim)
                sh.gather_block, sh._gather_cat = logged_block, logged_cat
                try:
                    loss, metrics, g = loss_and_grads(cfg, TrainStepConfig(), model, batch,
                                                      mesh=mesh)
                finally:
                    sh.gather_block, sh._gather_cat = plain_block, plain_cat
                whole = {k: v.numpy() for k, v in g.items() if sh.spec_dim(specs[k], "model") is None}
                return {"metrics": {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}},
                        "gathers": gathers, "model_gathers": sorted(set(model_gathers)),
                        "whole_grads": whole, "n_params": len(specs)}
            record(arch, step)

    with open(os.path.join(work, f"rank{rank}_of{world}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("lm_train_split"))
    with open(os.path.join(work, "plan.pkl"), "wb") as f:
        pickle.dump({"steps": {a: c for a, (c, _) in STEP_ARCHS.items()}}, f)
    rank_py = os.path.join(work, "rank.py")
    with open(rank_py, "w") as f:
        f.write(_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, rank_py, str(r), str(n),
                               os.path.join(work, f"store{n}"), work, os.path.join(REPO, "src")],
                              cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for n in WORLDS for r in range(n)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode != 0:
            errs.append(err[-4000:])
    assert not errs, errs
    out = {}
    for n in WORLDS:
        for r in range(n):
            with open(os.path.join(work, f"rank{r}_of{n}.pkl"), "rb") as f:
                out[(n, r)] = pickle.load(f)
    return out


def _whole(name: str, n: int) -> list:
    """The pair's function computed whole in float64 on this process, the
    same draws as the ranks': the gradients (whole) of what the ranks hold."""
    rng = np.random.default_rng(11)
    d, f, m = 6, 4 * n, 5
    x0, w0, v0, c0 = (rng.normal(size=s) for s in ((m, d), (d, f), (f, d), (m, d)))
    p0 = rng.normal(size=(n, m, 2 * n))
    c1 = rng.normal(size=(m, 2 * n))
    width = 6 * n
    a0 = rng.normal(size=(m, 2 * width))
    c2 = rng.normal(size=(m, 2 * width))
    vocab, b, s = 8 * n, 2, 5
    table0 = rng.normal(size=(vocab, d))
    ids0 = rng.integers(0, vocab, (b, s))
    labels0 = rng.integers(0, vocab, (b, s))
    t = lambda a: torch.tensor(a, dtype=torch.float64, requires_grad=True)  # noqa: E731
    if name == "enter_sum":
        x, w, v = t(x0), t(w0), t(v0)
        loss = torch.sum(torch.tensor(c0) * (torch.tanh(x @ w) @ v) ** 2)
        return [g.numpy() for g in torch.autograd.grad(loss, (x, w, v))]
    if name == "scatter_sum":
        p = t(p0)
        loss = torch.sum(torch.tensor(c1) * torch.sum(p, 0) ** 2)
        return [torch.autograd.grad(loss, p)[0].numpy()]
    if name == "gather":
        x = t(c1)
        return [torch.autograd.grad(torch.sum(torch.tensor(c1) * x ** 3), x)[0].numpy()]
    if name == "block":
        x = t(c1)
        return [torch.autograd.grad(torch.sum(torch.tensor(p0[0]) * x ** 3), x)[0].numpy()]
    if name == "all_to_all":
        a = t(a0)
        loss = torch.sum(torch.tensor(c2) * a ** 2)   # every column is some rank's channel
        return [torch.autograd.grad(loss, a)[0].numpy()]
    if name == "vocab_xent":
        from repro_torch.train.train_step import softmax_xent

        table = t(table0)
        h = torch.tanh(table[torch.tensor(ids0)])
        xent, z = softmax_xent(h @ table.T, torch.tensor(labels0))
        g, = torch.autograd.grad(xent + 0.1 * z, table)
        return [g.numpy(), np.array([float(xent.detach()), float(z.detach())])]
    raise ValueError(name)


def _rank_part(name: str, i: int, whole: np.ndarray, n: int, r: int) -> np.ndarray:
    """What rank r of n holds of the whole gradient ``whole`` (input i)."""
    def cols(a):
        w = a.shape[-1] // n
        return a[..., r * w:(r + 1) * w]
    if name == "enter_sum":
        return [whole, cols(whole), cols(whole.T).T][i]
    if name == "scatter_sum":
        return whole[r]
    if name in ("gather", "all_to_all"):
        return cols(whole)
    if name == "vocab_xent":
        return cols(whole.T).T if i == 0 else whole
    return whole                                   # "block": x whole on every rank


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", PAIRS)
def test_pair_gradient_equals_whole(worlds, name, n):
    """On every rank of a world of ``n``, the gradient of each input the
    rank holds equals the whole function's gradient (the rank's block of
    it) within 1e-12 * max |g|, in float64; so do vocab_xent's values."""
    want = _whole(name, n)
    for r in range(n):
        got = worlds[(n, r)][name]
        assert not isinstance(got, dict), got.get("error")
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            w = _rank_part(name, i, w, n, r)
            assert g.shape == w.shape, (name, r, i, g.shape, w.shape)
            err = float(np.abs(g - w).max())
            assert err <= REL * float(np.abs(w).max()), (name, r, i, err)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_all_to_all_backward_sends_each_cotangent_home(monkeypatch, n):
    """``_TpAllToAll.backward`` on ``n`` ranks, its exchange replayed
    without a world: the cotangent of each column a rank received goes back
    to the rank and part it came from (``rglru._pairing``'s spans)."""
    from repro_torch.models.rglru import _pairing
    from repro_torch.runtime import sharding as sh

    width = 6 * n
    block = 2 * width // n
    plans = [_pairing(width, n, r) for r in range(n)]
    # forward: each rank's received column ids, in rank order of senders
    cols = np.arange(2 * width)
    recv_cols = [np.concatenate([cols[s * block:(s + 1) * block][slice(*plans[s][0][dst])]
                                 for s in range(n)]) for dst in range(n)]
    sent_back: dict = {}
    phase = {"collect": True}

    def exchange(parts, recv, mesh, dim, axis):
        me = mesh.me
        if phase["collect"]:
            sent_back[me] = [p.clone() for p in parts]
            return torch.zeros((sum(recv),), dtype=parts[0].dtype)
        return torch.cat([sent_back[src][me] for src in range(n)])

    monkeypatch.setattr(sh, "_all_to_all", exchange)
    results = {}
    for collect in (True, False):
        phase["collect"] = collect
        for r in range(n):
            send, recv = plans[r]
            ctx = SimpleNamespace(mesh=SimpleNamespace(me=r), dim=0, axis="model",
                                  recv=tuple(recv), sent=tuple(hi - lo for lo, hi in send))
            grad = torch.tensor(recv_cols[r], dtype=torch.float64)   # cotangent = column id
            results[r] = sh._TpAllToAll.backward(ctx, grad)[4:]
    for r in range(n):
        send, _ = plans[r]
        for j, (lo, hi) in enumerate(send):
            np.testing.assert_array_equal(results[r][j].numpy(), r * block + np.arange(lo, hi))


@pytest.mark.parametrize("arch", list(STEP_ARCHS))
def test_train_step_gathers_no_weight_over_model(worlds, arch):
    """A (1, 4) train step: every parameter is gathered over no axis of
    size > 1 (the data axis is 1, and "model" is kept), and the step's only
    all-gathers over "model" have the shapes the split needs."""
    allowed = STEP_ARCHS[arch][1]
    for r in range(4):
        res = worlds[(4, r)][arch]
        assert "error" not in res, res.get("error")
        assert res["gathers"] and len({n for n, _ in res["gathers"]}) == res["n_params"]
        assert not [g for g in res["gathers"] if g[1]], res["gathers"][:4]
        assert set(res["model_gathers"]) <= allowed, res["model_gathers"]


@pytest.mark.parametrize("arch", list(STEP_ARCHS))
def test_train_step_ranks_agree_bitwise(worlds, arch):
    """Every rank's loss, xent and moe_aux are the same bits, and so is its
    gradient of every parameter every "model" rank holds whole (norms,
    whole k/v projections, the LoRA weights): AdamW keeps them equal."""
    first = worlds[(4, 0)][arch]
    assert "error" not in first, first.get("error")
    assert first["whole_grads"]
    for r in range(1, 4):
        res = worlds[(4, r)][arch]
        assert res["metrics"] == first["metrics"], (r, res["metrics"], first["metrics"])
        for k, g in first["whole_grads"].items():
            assert np.array_equal(res["whole_grads"][k], g), (r, k)
