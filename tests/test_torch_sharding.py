"""``runtime/{sharding,compat,compression}.py`` of the port against the
reference's modules of the same names.

A gloo world of 4 CPU processes (one module fixture, file-store rendezvous
under ``tmp_path``) builds a (2, 2) ``("data", "model")`` mesh and a (1, 2,
2) ``("pod", "data", "model")`` mesh and returns, from every rank at once:
the sharding specs, the logical-axis rules, block round trips, the
rank-ordered sum and the compressed sums.  The reference's specs and rules
are computed here on ``jax.make_mesh((1, 1))`` and ``(1, 1, 1)`` (specs do
not depend on axis sizes); its ``compressed_psum`` runs in a child with 4
fake XLA host devices, so this process keeps seeing one.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.runtime import sharding as ref_sharding  # noqa: E402
from repro.runtime.compat import token_prefix_sum as ref_prefix_sum  # noqa: E402
from repro_torch.runtime import sharding  # noqa: E402
from repro_torch.runtime.compat import token_prefix_sum  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 300
AXES = {"2": ("data", "model"), "3": ("pod", "data", "model")}
LOGICAL = (
    ("batch", "seq", "embed"),
    ("embed", "mlp"),
    ("batch", "heads", "kv_seq"),
    ("vocab", "embed"),
    ("experts", "embed", "expert_mlp"),
    ("layers", "state", None),
    ("kv_heads", "kv_seq"),
    ("unknown", "batch"),
)
COMPRESSED_AXES = ("data", "model", ("data", "model"))

_WORLD_CHILD = textwrap.dedent(
    r"""
    import datetime, os, pickle, sys
    rank, world, store, work, src = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=240))
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.compat import shard_map
    from repro_torch.runtime.compression import build_compressed_grad_sync, compressed_psum

    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    logical = pickle.load(open(os.path.join(work, "logical.pkl"), "rb"))
    meshes = {
        "2": init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")),
        "3": init_device_mesh("cpu", (1, 2, 2), mesh_dim_names=("pod", "data", "model")),
    }
    res = {"coord": {k: list(m.get_coordinate()) for k, m in meshes.items()}}
    for key, mesh in meshes.items():
        res[f"specs_{key}"] = {
            mode: {k: tuple(v.spec) for k, v in sh.gwas_shardings(mesh, mode=mode).items()}
            for mode in ("mp", "sample")
        }
        try:
            sh.gwas_shardings(mesh, mode="pipeline")
            res[f"bad_mode_{key}"] = None
        except ValueError as e:
            res[f"bad_mode_{key}"] = str(e)
        res[f"rules_{key}"] = [tuple(sh.DEFAULT_RULES.physical(l, mesh)) for l in logical]
        res[f"logical_{key}"] = [tuple(sh.logical_to_sharding(l, mesh).spec) for l in logical]
        full = torch.from_numpy(inp["full"])
        trips = {}
        for name, spec in (("rows", sh.P(sh.batch_axes(mesh), None)),
                           ("cols", sh.P(None, "model")),
                           ("tiles", sh.P(sh.batch_axes(mesh), "model")),
                           ("replicated", sh.P())):
            local = sh.shard_local(full, mesh, spec)
            trips[name] = (local.numpy(), sh.gather_full(local, mesh, spec).numpy())
        res[f"trips_{key}"] = trips
        # shard_map: a function of the local block, the full result back
        f = shard_map(lambda a, b: (a * 2.0, (a.sum(1, keepdim=True) + b).expand_as(a)),
                      mesh=mesh,
                      in_specs=(sh.P(sh.batch_axes(mesh), "model"), sh.P(sh.batch_axes(mesh))),
                      out_specs=(sh.P(sh.batch_axes(mesh), "model"),
                                 sh.P(sh.batch_axes(mesh), "model")))
        twice, sums = f(full, torch.from_numpy(inp["vec"]).reshape(-1, 1))
        res[f"shard_map_{key}"] = (twice.numpy(), sums.numpy())
        part = torch.from_numpy(inp["parts"][rank])
        res[f"sum_data_{key}"] = sh.sum_over(part, mesh, sh.batch_axes(mesh)).numpy()
        res[f"sum_all_{key}"] = sh.sum_over(part, mesh, sh.mesh_axes(mesh)).numpy()
    mesh = meshes["2"]
    x = torch.from_numpy(inp["vals"][rank])
    res["psum"] = {str(a): compressed_psum(x, a, mesh=mesh, bits=8).numpy()
                   for a in ("data", "model", ("data", "model"), ("data",))}
    grads = {k: torch.from_numpy(v) for k, v in
             (("w", inp["grad_w"]), ("b", inp["grad_b"]))}
    sync = build_compressed_grad_sync(mesh, grads, bits=8, axes=("data",))
    res["grad_sync"] = {k: v.numpy() for k, v in sync(grads).items()}
    as_list = build_compressed_grad_sync(mesh, [grads["w"], grads["b"]], bits=4,
                                         axes=("data", "model", "pod"))
    res["grad_sync_list"] = [v.numpy() for v in as_list([grads["w"], grads["b"]])]
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    """
)

_REF_CHILD = textwrap.dedent(
    r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.runtime.compression import build_compressed_grad_sync, compressed_psum

    work = sys.argv[1]
    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    spec = P(("data", "model"), None)
    out = {"psum": {}}
    for a in ("data", "model", ("data", "model")):
        f = jax.shard_map(lambda x, a=a: compressed_psum(x, a, bits=8), mesh=mesh,
                          in_specs=spec, out_specs=spec, check_vma=False)
        out["psum"][str(a)] = np.asarray(f(jnp.asarray(inp["vals"])))
    grads = {"w": jnp.asarray(inp["grad_w"]), "b": jnp.asarray(inp["grad_b"])}
    try:
        build_compressed_grad_sync(mesh, grads, bits=8, axes=("data",))(grads)
        out["reference_sync_error"] = None
    except ValueError as e:
        out["reference_sync_error"] = str(e).splitlines()[0]

    def grad_sync(grads_like, bits, axes):
        # build_compressed_grad_sync's body, with its in_specs given per
        # positional argument (a one-tuple), as shard_map takes them
        names = tuple(a for a in axes if a in mesh.axis_names)
        n = 1
        for a in names:
            n *= mesh.shape[a]

        def local_sync(g):
            def one(x):
                for a in names:
                    x = compressed_psum(x, a, bits=bits)
                return x / float(n)
            return jax.tree.map(one, g)

        specs = jax.tree.map(lambda _: P(), grads_like)
        return jax.shard_map(local_sync, mesh=mesh, in_specs=(specs,), out_specs=specs,
                             check_vma=False)

    out["grad_sync"] = {k: np.asarray(v) for k, v in
                        grad_sync(grads, 8, ("data",))(grads).items()}
    got = grad_sync(grads, 4, ("data", "model", "pod"))(grads)
    out["grad_sync_list"] = [np.asarray(got["w"]), np.asarray(got["b"])]
    with open(os.path.join(work, "reference.pkl"), "wb") as f:
        pickle.dump(out, f)
    """
)


def _spawn(args, env, cwd):
    return subprocess.Popen(args, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sharding"))
    rng = np.random.default_rng(5)
    inputs = dict(
        full=rng.normal(size=(8, 6)).astype(np.float32),
        vec=rng.normal(size=8).astype(np.float32),
        parts=rng.normal(size=(WORLD, 5, 3)).astype(np.float32),
        # one row per rank; rank 3's holds the largest magnitude, and a few
        # entries sit on a rounding tie of the int8 grid
        vals=(rng.normal(size=(WORLD, 256)) * np.array([[1.0], [0.5], [2.0], [3.0]]))
        .astype(np.float32),
        grad_w=rng.normal(size=(16, 8)).astype(np.float32),
        grad_b=rng.normal(size=(8,)).astype(np.float32),
    )
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    with open(os.path.join(work, "logical.pkl"), "wb") as f:
        pickle.dump(LOGICAL, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    src = os.path.join(REPO, "src")
    procs = [_spawn([sys.executable, "-c", _WORLD_CHILD, str(r), str(WORLD),
                     os.path.join(work, "store"), work, src], env, work)
             for r in range(WORLD)]
    procs.append(_spawn([sys.executable, "-c", _REF_CHILD, work],
                        dict(env, JAX_PLATFORMS="cpu"), work))
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=TIMEOUT_S)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n{err[-4000:]}"
    ranks = [pickle.load(open(os.path.join(work, f"rank{r}.pkl"), "rb")) for r in range(WORLD)]
    ref = pickle.load(open(os.path.join(work, "reference.pkl"), "rb"))
    return dict(ranks=ranks, ref=ref, inputs=inputs)


def _ref_mesh(key):
    return jax.make_mesh((1,) * len(AXES[key]), AXES[key])


@pytest.mark.parametrize("key", list(AXES))
@pytest.mark.parametrize("mode", ["mp", "sample"])
def test_gwas_shardings_match_reference(world, mode, key):
    ref = ref_sharding.gwas_shardings(_ref_mesh(key), mode=mode)
    for r in range(WORLD):
        got = world["ranks"][r][f"specs_{key}"][mode]
        assert set(got) == set(ref)
        for name, sh in ref.items():
            assert got[name] == tuple(sh.spec), (name, got[name], sh.spec)
    with pytest.raises(ValueError, match="unknown GWAS sharding mode"):
        ref_sharding.gwas_shardings(_ref_mesh(key), mode="pipeline")
    assert "unknown GWAS sharding mode" in world["ranks"][0][f"bad_mode_{key}"]


@pytest.mark.parametrize("key", list(AXES))
def test_logical_rules_match_reference(world, key):
    """First fit, each physical axis used at most once per spec, absent axes
    dropped: the port's ``DEFAULT_RULES`` give the reference's specs."""
    mesh = _ref_mesh(key)
    want = [tuple(ref_sharding.DEFAULT_RULES.physical(l, mesh)) for l in LOGICAL]
    want_ls = [tuple(ref_sharding.logical_to_sharding(l, mesh).spec) for l in LOGICAL]
    got = world["ranks"][0]
    assert got[f"rules_{key}"] == want
    assert got[f"logical_{key}"] == want_ls
    assert sharding.DEFAULT_RULES == sharding.LogicalAxisRules(
        rules=ref_sharding.DEFAULT_RULES.rules)


def test_partition_spec_is_an_immutable_tuple():
    spec = sharding.P(("pod", "data"), None)
    assert spec == (("pod", "data"), None) and isinstance(spec, tuple)
    assert tuple(spec) == tuple(ref_sharding.P(("pod", "data"), None))
    with pytest.raises(TypeError):
        spec[0] = "model"
    with pytest.raises(TypeError, match="DeviceMesh"):
        sharding.check_mesh(object())


@pytest.mark.parametrize("key", list(AXES))
def test_blocks_round_trip(world, key):
    """``shard_local`` cuts the rank's block by its coordinate (the first
    axis of an entry major) and ``gather_full`` restores the full tensor on
    every rank; ``shard_map`` maps a function of the blocks."""
    full = world["inputs"]["full"]
    for r in range(WORLD):
        res = world["ranks"][r]
        coord = res["coord"][key]
        d, m = coord[-2], coord[-1]
        want = {"rows": full[4 * d:4 * d + 4], "cols": full[:, 3 * m:3 * m + 3],
                "tiles": full[4 * d:4 * d + 4, 3 * m:3 * m + 3], "replicated": full}
        for name, (local, back) in res[f"trips_{key}"].items():
            np.testing.assert_array_equal(local, want[name])
            np.testing.assert_array_equal(back, full)
        twice, sums = res[f"shard_map_{key}"]
        np.testing.assert_array_equal(twice, full * 2.0)
        vec = world["inputs"]["vec"]
        for mm in range(2):
            block = full[:, 3 * mm:3 * mm + 3].sum(1, keepdims=True, dtype=np.float32)
            np.testing.assert_allclose(sums[:, 3 * mm:3 * mm + 3],
                                       np.broadcast_to(block + vec[:, None], (8, 3)),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("key", list(AXES))
def test_sum_over_adds_in_rank_order(world, key):
    """The sum over mesh axes is the float32 chain in rank order, bitwise,
    and the same bits on every rank."""
    parts = world["inputs"]["parts"]
    for r in range(WORLD):
        res = world["ranks"][r]
        coord = res["coord"][key]
        m = coord[-1]
        data_ranks = [d * 2 + m for d in range(2)]
        want = parts[data_ranks[0]] + parts[data_ranks[1]]
        np.testing.assert_array_equal(res[f"sum_data_{key}"], want)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        np.testing.assert_array_equal(res[f"sum_all_{key}"], acc)


def test_token_prefix_sum_matches_reference():
    rng = np.random.default_rng(3)
    ints = rng.integers(0, 5, size=(7, 9)).astype(np.int32)
    for axis in (0, 1):
        got = token_prefix_sum(torch.from_numpy(ints), axis=axis).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref_prefix_sum(ints, axis=axis)))
    floats = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(token_prefix_sum(torch.from_numpy(floats)).numpy(),
                               np.asarray(ref_prefix_sum(floats)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axes", [str(a) for a in COMPRESSED_AXES])
def test_compressed_psum_matches_reference(world, axes):
    """The int8 quantize / int32 sum / dequantize of every rank's row is the
    reference's bit for bit (integer sums are exact; the float32 scale and
    rounding are the same IEEE operations), and within ~1% of the exact sum."""
    ref = world["ref"]["psum"][axes]
    vals = world["inputs"]["vals"]
    for r in range(WORLD):
        got = world["ranks"][r]["psum"]
        np.testing.assert_array_equal(got[axes], ref[r])
        if axes == "data":   # a one-axis tuple names the same group
            np.testing.assert_array_equal(got[str(("data",))], ref[r])
    exact = {"data": lambda r: vals[r % 2] + vals[r % 2 + 2],
             "model": lambda r: vals[2 * (r // 2)] + vals[2 * (r // 2) + 1],
             str(("data", "model")): lambda r: vals.sum(0)}[axes]
    for r in range(WORLD):
        want = exact(r)
        rms = np.sqrt(np.mean((ref[r] - want) ** 2) / np.mean(want ** 2))
        assert rms < 0.02, rms


def test_compressed_grad_sync_matches_reference(world):
    """``build_compressed_grad_sync`` over a dict (8 bits, the data axis) and
    over a list (4 bits, every axis present; "pod" is absent and skipped)
    gives the reference's means bit for bit on every rank.  The reference's
    own function raises under the installed jax (it passes ``shard_map`` a
    dict of specs where its one positional argument needs a one-tuple), so
    its body runs here with the specs wrapped."""
    ref = world["ref"]
    assert ref["reference_sync_error"] is None or "pytree" in ref["reference_sync_error"]
    for r in range(WORLD):
        got = world["ranks"][r]
        for k in ("w", "b"):
            np.testing.assert_array_equal(got["grad_sync"][k], ref["grad_sync"][k])
        for a, b in zip(got["grad_sync_list"], ref["grad_sync_list"]):
            np.testing.assert_array_equal(a, b)
