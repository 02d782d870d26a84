"""The LM serve steps on a mesh on the CPU: a gloo world of 4 processes runs
the port's ``build_prefill_step(mesh=)`` / ``build_decode_step(mesh=)`` for
every arch of ``LM_ARCHS`` (and whisper with 2 heads, whose self and
cross caches split on slots; rwkv6 with 4 heads of 16, which split over
"model" where its one ``reduced()`` head does not; granite with the manual
expert-parallel MoE; gemma2 with int8 k/v caches, split on kv heads on (2,
2) and on slots on (1, 4)) on ``("data", "model")`` meshes (2, 2) and (1, 4),
held against the port's ``mesh=None`` steps and against the reference's
own mesh steps.

One module fixture draws each arch's weights (the port's ``init_model``
from a seeded generator, float32 ``reduced()`` configs), a B=4 prompt of 24
positions (``make_batch``; past the local window of 16, so local rings
wrap) and 8 continuation tokens, and starts three things at once
(``start_worlds``, which ``tests/test_torch_lm_serve_split.py`` shares):
the world of 4 (file-store rendezvous under ``tmp_path``, one thread per
rank), a world of one, and for each mesh shape a child with 4 fake XLA
host devices that runs the reference's mesh steps on a
``jax.sharding.Mesh`` of that shape
(Auto axes; ``jax.make_mesh`` gives Explicit ones under jax 0.9.0).  Each
run is a prefill into 32-slot caches, then 8 teacher-forced decode steps.
The tests read every rank's results.

Bounds: logits of every step and the gathered caches after prefill and
after the last step within 1e-4 * max |ref| (cache positions exactly, int8
payloads within one unit), as ``tests/test_torch_lm_serve.py`` and
``tests/test_torch_lm_models.py``; each rank's blocks of the caches and the
logits have the shapes of the reference's shards on the same device
(``partition.tree_shardings``) and their values within the same bound; on
a world of one, bitwise equal to ``mesh=None``, and a step that lives on
keeps no reference to the model it served.  During the first decode step
no rank gathers a weight or a recurrent state over "model".
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro_torch.configs import LM_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import api as M  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.train import build_decode_step, build_prefill_step, make_batch  # noqa: E402
from repro_torch.train.train_step import param_specs  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
B, S, CAP, STEPS = 4, 24, 32, 8
REL = 1e-4
MESHES = ((2, 2), (1, 4))


def _manual(cfg):
    """The manual expert-parallel MoE at capacity factor E: no token is
    dropped, so it serves what the GSPMD layer of ``mesh=None`` does."""
    return dataclasses.replace(cfg, moe_impl="manual",
                               moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts))


# whisper with 2 heads: on (1, 4) neither its q nor its kv heads divide
# "model", so its self and cross caches are split on slots.  rwkv6's
# reduced() has one head of 64 (replicated over "model"); with heads of 16
# its 4 heads split.
VARIANTS = {"whisper-small-2h": ("whisper-small", dict(n_heads=2, n_kv_heads=2)),
            "rwkv6-3b-4h": ("rwkv6-3b", dict(rwkv_head_dim=16)),
            "granite-moe-manual": ("granite-moe-1b-a400m", _manual),
            # 2 kv heads: split on heads on (2, 2), on slots on (1, 4)
            "gemma2-9b-int8": ("gemma2-9b", dict(kv_cache_dtype="int8"))}
SERVED = tuple(LM_ARCHS) + tuple(VARIANTS)
ONE = ("gemma2-9b", "qwen1.5-32b", "recurrentgemma-2b", "whisper-small", "arctic-480b",
       "rwkv6-3b", "rwkv6-3b-4h", "granite-moe-1b-a400m", "granite-moe-manual")
CELLS = [(a, m) for a in SERVED for m in MESHES]
# the recurrent states' cache keys
STATES = ("h", "conv", "wkv")


def arch_config(name: str, *, get=get_config):
    """The float32 ``reduced()`` config of an arch or of a variant."""
    arch, change = VARIANTS.get(name, (name, {}))
    cfg = dataclasses.replace(get(arch).reduced(), dtype="float32")
    return change(cfg) if callable(change) else dataclasses.replace(cfg, **change)


_RANK = textwrap.dedent(
    r"""
    import datetime, gc, hashlib, math, os, pickle, sys, traceback, weakref
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
    from test_torch_lm_serve_mesh import B, CAP, S, STATES, STEPS, arch_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api as M
    from repro_torch.models import convert
    from repro_torch.runtime import sharding as sh
    from repro_torch.train import build_decode_step, build_prefill_step
    from repro_torch.train.serve_step import cache_specs
    from repro_torch.train.train_step import param_specs, to_blocks

    res = {}
    shape = ShapeConfig("serve", CAP, B, "prefill")
    with open(os.path.join(work, "plan.pkl"), "rb") as f:
        plan = pickle.load(f)

    def model_of(cfg, arch, mesh):
        model = M.init_model(cfg, generator=None, device="cpu", max_positions=64)
        flat = dict(np.load(os.path.join(work, f"w_{arch}.npz")))
        convert.load_reference_flat(cfg, model, flat, dict(model.named_parameters()))
        return model if mesh is None else to_blocks(model, mesh, param_specs(cfg, mesh))

    def inputs(arch):
        z = dict(np.load(os.path.join(work, f"b_{arch}.npz")))
        return {k: v for k, v in z.items() if k != "cont"}, z["cont"]

    def serve(cfg, model, mesh, batch, cont, on_decode=None):
        pre, dec = build_prefill_step(cfg, shape, mesh=mesh), build_decode_step(cfg, shape, mesh=mesh)
        logits, caches = pre(model, batch)
        out = {"logits": [logits], "prefill_caches": convert.caches_to_numpy(cfg, caches)}
        for t in range(STEPS):
            if on_decode is not None and t == 0:
                with on_decode(caches):
                    logits, caches = dec(model, cont[:, t], np.full((B,), S + t, np.int32), caches)
            else:
                logits, caches = dec(model, cont[:, t], np.full((B,), S + t, np.int32), caches)
            out["logits"].append(logits)
        return out, caches

    def gather_log(model, mesh, log, states):
        # records the mesh axes each parameter's gather runs over, and the
        # shape of each recurrent state (a tensor of the caches passed in)
        # that any gather over "model" reads
        import contextlib
        names = {id(p): n for n, p in model.named_parameters()}
        plain_block, plain_cat = sh.gather_block, sh._gather_cat
        def logged(block, m, spec, keep=()):
            axes = [a for e in spec for a in sh._names(e)
                    if a not in keep and sh.axis_size(m, a) > 1]
            log.append((names[id(block)], tuple(axes)))
            return plain_block(block, m, spec, keep)
        def logged_cat(x, m, name, dim):
            if name == "model" and sh.axis_size(m, name) > 1 and x.data_ptr() in state_ptrs:
                states.append(tuple(x.shape))
            return plain_cat(x, m, name, dim)
        state_ptrs = set()
        @contextlib.contextmanager
        def ctx(caches):
            state_ptrs.clear()
            state_ptrs.update(t.data_ptr() for c in caches if isinstance(c, dict)
                              for k, t in c.items() if k in STATES)
            sh.gather_block, sh._gather_cat = logged, logged_cat
            try:
                yield
            finally:
                sh.gather_block, sh._gather_cat = plain_block, plain_cat
        return ctx

    def digest(arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    if world == 1:
        mesh = make_mesh((1, 1), ("data", "model"))
        for arch in plan["one"]:
            def one(arch=arch):
                cfg = arch_config(arch)
                batch, cont = inputs(arch)
                (a, ca), (b, cb) = [serve(cfg, model_of(cfg, arch, m), m, batch, cont)
                                    for m in (None, mesh)]
                differ = [f"logits {i}" for i, (x, y) in enumerate(zip(a["logits"], b["logits"]))
                          if not torch.equal(x, y)]
                for label, x, y in (("prefill", a["prefill_caches"], b["prefill_caches"]),
                                    ("final", convert.caches_to_numpy(cfg, ca),
                                     convert.caches_to_numpy(cfg, cb))):
                    x, y = jax_leaves(x), jax_leaves(y)
                    differ += [f"{label} cache leaves {len(x)} != {len(y)}"] if len(x) != len(y) else []
                    differ += [f"{label} cache leaf {i}" for i, (u, v) in enumerate(zip(x, y))
                               if not np.array_equal(u, v)]
                # a step that lives on keeps no reference to the model it served
                model = model_of(cfg, arch, mesh)
                step = build_prefill_step(cfg, shape, mesh=mesh)
                step(model, batch)
                alive = weakref.ref(model)
                del model
                gc.collect()
                return {"differ": differ, "model_kept": alive() is not None}
            try:
                res[arch] = one()
            except Exception:
                res[arch] = {"error": traceback.format_exc()}
    else:
        cells = [(a, ms) for a, ms in plan["cells"] if math.prod(ms) == world]
        meshes = {ms: make_mesh(ms, ("data", "model"))
                  for ms in dict.fromkeys(ms for _, ms in cells)}
        for arch, ms in cells:
            mesh = meshes[ms]
            def one(arch=arch, mesh=mesh):
                cfg = arch_config(arch)
                batch, cont = inputs(arch)
                model = model_of(cfg, arch, mesh)
                log, states = [], []
                out, caches = serve(cfg, model, mesh, batch, cont,
                                    gather_log(model, mesh, log, states))
                dp = sh.batch_axes(mesh)
                specs = cache_specs(cfg, shape, mesh)
                whole = convert.caches_from_blocks(caches, specs, mesh)
                again = convert.caches_to_blocks(whole, specs, mesh)
                local = convert.caches_to_numpy(cfg, caches)
                row = {
                    "local_logits": [l.numpy() for l in out["logits"]],
                    "local_prefill_caches": out["prefill_caches"],
                    "local_caches": local,
                    "round_trip": all(np.array_equal(u, v) for u, v in zip(
                        jax_leaves(local), jax_leaves(convert.caches_to_numpy(cfg, again)))),
                    "gathers": log,
                    "state_gathers": states,
                }
                logits = [sh.gather_full(l, mesh, sh.P(dp, "model")).numpy()
                          for l in out["logits"]]
                final = convert.caches_to_numpy(cfg, whole)
                row["digest"] = digest(logits + jax_leaves(final))
                if rank == 0:
                    row["logits"], row["caches"] = logits, final
                return row
            try:
                res[(arch, ms)] = one()
            except Exception:
                res[(arch, ms)] = {"error": traceback.format_exc()}

    with open(os.path.join(work, f"rank{rank}_of{world}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    """
)

# the caches' leaves in the reference's order, without importing jax in
# the ranks: LayerCache fields in order, dict keys sorted (as jax does)
_LEAVES = textwrap.dedent(
    r"""
    def jax_leaves(tree):
        if tree is None:
            return []
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in jax_leaves(v)]
        return [tree]
    """
)

_REF = textwrap.dedent(
    r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    work, src, part = sys.argv[1], sys.argv[2], sys.argv[3]
    sys.path.insert(0, os.path.join(os.path.dirname(src), "tests"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    from test_torch_lm_serve_mesh import B, CAP, S, STEPS, arch_config
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch.train import unflatten_like
    from repro.models import api as RM
    from repro.runtime.sharding import DEFAULT_RULES
    from repro.train import partition
    from repro.train import serve_step as RS

    def shards(x):
        # each device's block, in device order (= the mesh's flat order)
        return [np.asarray(s.data) for s in sorted(x.addressable_shards, key=lambda s: s.device.id)]

    out = {}
    shape = ShapeConfig("serve", CAP, B, "prefill")
    with open(os.path.join(work, "plan.pkl"), "rb") as f:
        cells = [(a, ms) for a, ms in pickle.load(f)["cells"] if "x".join(map(str, ms)) == part]
    for arch in dict.fromkeys(a for a, _ in cells):
        cfg = arch_config(arch, get=get_config)
        flat = dict(np.load(os.path.join(work, f"w_{arch}.npz")))
        params = unflatten_like(RM.abstract_params(cfg, max_positions=64), flat)
        z = dict(np.load(os.path.join(work, f"b_{arch}.npz")))
        cont = z.pop("cont")
        batch = {k: jnp.asarray(v) for k, v in z.items()}
        for ms in [m for a, m in cells if a == arch]:
            devices = jax.devices()[:int(np.prod(ms))]
            mesh = jax.sharding.Mesh(np.array(devices).reshape(ms), ("data", "model"))
            caches_abs = RM.abstract_caches(cfg, shape)
            want = partition.tree_shardings(partition.cache_logical_axes(caches_abs), mesh,
                                            DEFAULT_RULES, abstract_tree=caches_abs)
            pre = RS.build_prefill_step(cfg, shape, mesh=mesh)
            dec = RS.build_decode_step(cfg, shape, mesh=mesh)
            logits, caches = pre(params, batch)
            row = {"logits": [np.asarray(logits)], "logits_shards": [shards(logits)],
                   "prefill_caches": [np.asarray(x) for x in jax.tree.leaves(caches)],
                   "prefill_cache_shards": [shards(x) for x in jax.tree.leaves(caches)]}
            for t in range(STEPS):
                logits, caches = dec(params, jnp.asarray(cont[:, t]),
                                     jnp.full((B,), S + t, jnp.int32), caches)
                row["logits"].append(np.asarray(logits))
                row["logits_shards"].append(shards(logits))
            leaves = jax.tree.leaves(caches)
            row["caches"] = [np.asarray(x) for x in leaves]
            row["cache_shards"] = [shards(x) for x in leaves]
            row["spec_shapes"] = [w.shard_shape(x.shape) for w, x in
                                  zip(jax.tree.leaves(want), leaves)]
            out[(arch, ms)] = row
    with open(os.path.join(work, f"reference_{part}.pkl"), "wb") as f:
        pickle.dump(out, f)
    """
)


def _serve_unsharded(cfg, model, batch, cont):
    shape = ShapeConfig("serve", CAP, B, "prefill")
    logits, caches = build_prefill_step(cfg, shape)(model, batch)
    out = {"logits": [logits.numpy()], "prefill_caches": convert.caches_to_numpy(cfg, caches)}
    decode = build_decode_step(cfg, shape)
    for t in range(STEPS):
        logits, caches = decode(model, cont[:, t], np.full((B,), S + t, np.int32), caches)
        out["logits"].append(logits.numpy())
    out["caches"] = convert.caches_to_numpy(cfg, caches)
    return out


def start_worlds(work: str, served, cells, one, seed: int = 200) -> dict:
    """Draw the weights and inputs of each arch of ``served`` into ``work``,
    then run at once: a gloo world for each mesh size of ``cells`` ((arch,
    mesh shape) pairs), a world of one serving each arch of ``one``, the
    reference's mesh steps of the cells of each mesh shape in a child with
    4 fake XLA devices, and here the port's ``mesh=None`` steps.  Returns every
    process's results: ``ranks`` (mesh size -> each rank's results by
    cell), ``one``, ``reference`` and ``unsharded`` (by arch)."""
    inputs = {}
    for i, arch in enumerate(served):
        cfg = arch_config(arch)
        model = M.init_model(cfg, generator=torch.Generator().manual_seed(seed + i), device="cpu",
                             max_positions=64)
        np.savez(os.path.join(work, f"w_{arch}.npz"),
                 **convert.reference_flat(cfg, model, dict(model.named_parameters())))
        batch = make_batch(cfg, ShapeConfig("p", S, B, "prefill"), 0, seed=2026)
        batch.pop("labels")
        cont = np.random.default_rng(i).integers(0, cfg.vocab, (B, STEPS)).astype(np.int32)
        np.savez(os.path.join(work, f"b_{arch}.npz"), cont=cont, **batch)
        inputs[arch] = (cfg, model, batch, cont)
    with open(os.path.join(work, "plan.pkl"), "wb") as f:
        pickle.dump({"cells": list(cells), "one": list(one)}, f)

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    src = os.path.join(REPO, "src")
    rank_py, ref_py = os.path.join(work, "rank.py"), os.path.join(work, "ref.py")
    with open(rank_py, "w") as f:
        f.write(_LEAVES + _RANK)
    with open(ref_py, "w") as f:
        f.write(_REF)

    def start(args):
        return subprocess.Popen([sys.executable, *args], cwd=work, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    sizes = sorted({int(np.prod(ms)) for _, ms in cells})
    procs = [start([rank_py, str(r), str(n), os.path.join(work, f"store{n}"), work, src])
             for n in sizes for r in range(n)]
    if one:
        procs.append(start([rank_py, "0", "1", os.path.join(work, "store1"), work, src]))
    parts = ["x".join(map(str, ms)) for ms in dict.fromkeys(ms for _, ms in cells)]
    procs += [start([ref_py, work, src, part]) for part in parts]
    unsharded = {arch: _serve_unsharded(cfg, model, batch, cont)
                 for arch, (cfg, model, batch, cont) in inputs.items()}
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

    def load(name):
        with open(os.path.join(work, name), "rb") as f:
            return pickle.load(f)

    reference = {}
    for part in parts:
        reference.update(load(f"reference_{part}.pkl"))
    return dict(inputs=inputs, unsharded=unsharded, reference=reference,
                ranks={n: [load(f"rank{r}_of{n}.pkl") for r in range(n)] for n in sizes},
                one=load("rank0_of1.pkl") if one else {})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return start_worlds(str(tmp_path_factory.mktemp("lm_serve_mesh")), SERVED, CELLS, ONE)


def _result(world, cell, rank=0):
    res = world["ranks"][int(np.prod(cell[1]))][rank][cell]
    assert "error" not in res, res.get("error")
    return res


def _hold(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == np.int32:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    if want.dtype == np.int8:                   # int8 k/v payloads
        assert got.dtype == np.int8, (what, got.dtype)
        assert np.abs(got.astype(np.int32) - want).max(initial=0) <= 1, what
        return
    err = float(np.abs(got - want).max()) if want.size else 0.0
    bound = REL * float(np.abs(want).max()) if want.size else 0.0
    assert err <= bound, (what, err, bound)


def _leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_mesh_steps_match_unsharded(world, arch, mesh):
    """Every step's logits and the gathered caches after the last step
    equal the port's ``mesh=None`` steps within 1e-4 * max |ref|."""
    res, want = _result(world, (arch, mesh)), world["unsharded"][arch]
    for i, (g, w) in enumerate(zip(res["logits"], want["logits"])):
        _hold(g, w, f"logits {i}")
    for i, (g, w) in enumerate(zip(_leaves(res["caches"]), _leaves(want["caches"]))):
        _hold(g, w, f"cache leaf {i}")


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_mesh_steps_match_reference_mesh_steps(world, arch, mesh):
    """The same against the reference's own mesh steps: logits of every
    step, the caches after prefill (each rank's blocks, gathered by the
    reference) and after the last step."""
    res, ref = _result(world, (arch, mesh)), world["reference"][(arch, mesh)]
    for i, (g, w) in enumerate(zip(res["logits"], ref["logits"])):
        _hold(g, w, f"logits {i}")
    got = _leaves(res["caches"])
    assert len(got) == len(ref["caches"])
    for i, (g, w) in enumerate(zip(got, ref["caches"])):
        _hold(g, w, f"cache leaf {i}")


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_rank_blocks_follow_reference_layout(world, arch, mesh):
    """Each rank's blocks of the caches (after prefill and after the last
    step) and of every step's logits have the shape of the reference's
    shard on the same device (for the caches, the shard shape of
    ``partition.tree_shardings``) and its values; cutting the gathered
    caches into blocks gives the rank's blocks back bit for bit."""
    ref = world["reference"][(arch, mesh)]
    for r in range(int(np.prod(mesh))):
        res = _result(world, (arch, mesh), r)
        assert res["round_trip"]
        for label, key in (("prefill", "prefill_cache"), ("final", "cache")):
            got = _leaves(res[f"local_{key}s"])
            assert len(got) == len(ref[f"{key}s"])
            for i, g in enumerate(got):
                want = ref[f"{key}_shards"][i][r]
                if key == "cache":
                    assert want.shape == tuple(ref["spec_shapes"][i]), (i, want.shape)
                _hold(g, want, f"rank {r} {label} cache leaf {i}")
        for i, g in enumerate(res["local_logits"]):
            _hold(g, ref["logits_shards"][i][r], f"rank {r} logits {i}")


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_ranks_gather_the_same_bits(world, arch, mesh):
    """Every rank's gathered logits and caches are the same bits."""
    digests = {_result(world, (arch, mesh), r)["digest"] for r in range(int(np.prod(mesh)))}
    assert len(digests) == 1


def held_local(world, cells):
    """Every rank of every cell: no weight gathered over "model" during the
    first decode step (each layer computes on its blocks; a "model" dim
    that does not divide is no "model" dim of the spec), and no recurrent
    state gathered there by any collective (the mixes step their state
    blocks)."""
    for arch, mesh in cells:
        for r in range(int(np.prod(mesh))):
            res = _result(world, (arch, mesh), r)
            assert res["gathers"], (arch, mesh, r, "no gather was logged")
            over_model = [(n, a) for n, a in res["gathers"] if "model" in a]
            assert not over_model, (arch, mesh, r, over_model)
            assert not res["state_gathers"], (arch, mesh, r, res["state_gathers"])


@pytest.mark.parametrize("mesh", MESHES)
def test_split_weights_are_not_gathered_over_model(world, mesh):
    """During one decode step no rank gathers over "model" any weight whose
    spec has "model": attention, the MLP, the embedding and the head, the
    rg-lru and rwkv mixes, the MoE's router and experts all compute on
    their blocks; nor is a recurrent state gathered."""
    held_local(world, [(a, m) for a, m in CELLS if m == mesh])


@pytest.mark.parametrize("arch", ONE)
def test_world_of_one_is_bitwise(world, arch):
    """On a mesh (1, 1) the mesh arms compute exactly what ``mesh=None``
    does: every step's logits and every cache leaf, bit for bit."""
    res = world["one"][arch]
    assert "error" not in res, res.get("error")
    assert res["differ"] == []


@pytest.mark.parametrize("arch", ONE)
def test_mesh_step_does_not_keep_the_model(world, arch):
    """A built mesh step holds no reference to the model it last served:
    once the caller drops the model, its weights are freed while the step
    lives on."""
    res = world["one"][arch]
    assert "error" not in res, res.get("error")
    assert res["model_kept"] is False


def test_rules_and_meshes_are_checked():
    """``rules`` other than ``DEFAULT_RULES`` raise ``ValueError`` (the
    blocks are cut by them everywhere); a mesh that is not a
    ``DeviceMesh`` raises ``TypeError``."""
    cfg = arch_config("gemma2-9b")
    shape = ShapeConfig("serve", CAP, B, "prefill")
    other = sh.LogicalAxisRules(rules=sh.DEFAULT_RULES.rules[1:])
    for build in (build_prefill_step, build_decode_step):
        with pytest.raises(ValueError, match="DEFAULT_RULES"):
            build(cfg, shape, rules=other)
        with pytest.raises(TypeError, match="DeviceMesh"):
            build(cfg, shape, mesh=object())


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "recurrentgemma-2b"])
def test_init_blocks_cut_one_whole_model(arch):
    """``convert.init_blocks`` draws each parameter from its own seeded
    generator: every rank of a (1, 4) or (2, 2) mesh gets the blocks of the
    one whole model that ``init_blocks`` gives without a mesh, and a rank
    holds no whole parameter's storage."""
    from types import SimpleNamespace

    cfg = get_config(arch).reduced()
    whole = convert.init_blocks(cfg, 5, device="cpu", max_positions=64)
    again = convert.init_blocks(cfg, 5, device="cpu", max_positions=64)
    other = convert.init_blocks(cfg, 6, device="cpu", max_positions=64)
    ref = dict(whole.named_parameters())
    for name, p in again.named_parameters():
        assert torch.equal(p, ref[name]), name
    assert not torch.equal(other.embed, whole.embed)
    assert abs(float(whole.embed.float().std()) - 0.02) < 2e-3
    assert float(whole.final_norm.abs().max()) == 0.0 or not cfg.norm_plus_one
    for shape in MESHES:
        for coord in np.ndindex(*shape):
            mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape,
                                   device_type="cpu", get_coordinate=lambda c=coord: list(c))
            specs = param_specs(cfg, mesh)
            blocks = convert.init_blocks(cfg, 5, mesh=mesh, specs=specs, max_positions=64)
            for name, p in blocks.named_parameters():
                assert p.untyped_storage().nbytes() == p.numel() * p.element_size(), name
                assert torch.equal(p, sh.shard_local(ref[name], mesh, specs[name])), name
