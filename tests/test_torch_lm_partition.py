"""``train/partition.py``, ``train_step.batch_shardings`` and
``launch/mesh.py`` of the port against the reference's.

The reference's tables run in a child process with 4 fake XLA host devices
(``XLA_FLAGS`` is set in the child's environment only, so this process
keeps seeing one), on meshes built with ``jax.sharding.Mesh`` (Auto axes:
``jax.make_mesh`` gives Explicit axes under jax 0.9.0, on which the
reference's steps raise).  The port resolves the same tables on stand-in
meshes that carry only axis names and sizes, which is all the resolution
reads.  Every LM arch at ``reduced()`` and gemma2-9b at full size
(abstract: no weights) on the meshes (2, 2), (4, 1), (1, 4) and (1, 2, 2)
with pod axes.  The reference stacks each pattern position's leaves over
the repeats: its stacked leaves carry one more, leading, unsharded axis,
stripped here through ``models/convert.py::reference_keys``.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")

from repro_torch.configs import LM_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import POD_CHIPS, production_shape  # noqa: E402
from repro_torch.models import api as M  # noqa: E402
from repro_torch.models.convert import reference_keys  # noqa: E402
from repro_torch.runtime.sharding import P  # noqa: E402
from repro_torch.train import partition  # noqa: E402
from repro_torch.train.train_step import batch_shardings, param_specs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2": ((2, 2), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")), "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}
CASES = [(a, True) for a in LM_ARCHS] + [("gemma2-9b", False)]
DECODE = ShapeConfig("d", seq_len=64, global_batch=4, kind="decode")
# (mesh, spec, shape): the reference's own (3, 64) degrade among them
DIVISIBLE = [("2x2", ("data", "model"), (3, 64)), ("4x1", ("data", "model"), (3, 64)),
             ("2x2", ("data", "model"), (4, 64)), ("1x4", (None, "model"), (8, 6)),
             ("1x2x2", (("pod", "data"), "model"), (6, 4)), ("2x2", (("data", "model"),), (8,)),
             ("2x2", (("data", "model"),), (6,)), ("4x1", ("data",), (8, 3))]
# (arch, batch): a batch that divides every mesh and one that does not
BATCHES = [("gemma2-9b", 8), ("qwen2-vl-7b", 8), ("qwen2-vl-7b", 3), ("whisper-small", 8),
           ("whisper-small", 6), ("granite-moe-1b-a400m", 2)]

_CHILD = textwrap.dedent(
    r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.models import api as RM
    from repro.train import partition
    from repro.train.train_step import batch_shardings

    cases, meshes, divisible, batches, out_path = pickle.load(open(sys.argv[1], "rb"))
    devs = np.array(jax.devices())
    mesh_of = {k: jax.sharding.Mesh(devs.reshape(shape), axes) for k, (shape, axes) in meshes.items()}
    is_axes = lambda x: isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)

    def key(path):
        return "/".join(str(getattr(e, "key", getattr(e, "name", e))) for e in path)

    def flat(tree, leaf=None):
        return {key(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]}

    def entries(spec):
        return tuple(None if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec)

    out = {"params": {}, "caches": {}, "divisible": [], "batch": []}
    for arch, reduced in cases:
        cfg = get_config(arch).reduced() if reduced else get_config(arch)
        for kind, abstract, axes_fn in (
            ("params", RM.abstract_params(cfg), partition.param_logical_axes),
            ("caches", RM.abstract_caches(cfg, ShapeConfig("d", 64, 4, "decode")),
             partition.cache_logical_axes),
        ):
            logical = axes_fn(abstract)
            row = {"logical": flat(logical, is_axes), "specs": {}}
            for label, mesh in mesh_of.items():
                shard = partition.tree_shardings(logical, mesh, abstract_tree=abstract)
                row["specs"][label] = {k: entries(s.spec) for k, s in flat(shard).items()}
            out[kind][(arch, reduced)] = row
    for label, spec, shape in divisible:
        out["divisible"].append(entries(partition.divisible_sharding(mesh_of[label], P(*spec), shape).spec))
    for arch, b in batches:
        cfg = get_config(arch).reduced()
        specs = RM.input_specs(cfg, ShapeConfig("t", 32, b, "train"))
        out["batch"].append({label: {k: entries(s.spec) for k, s in batch_shardings(specs, mesh).items()}
                             for label, mesh in mesh_of.items()})
    pickle.dump(out, open(out_path, "wb"))
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    work = tmp_path_factory.mktemp("partition")
    args, out = str(work / "args.pkl"), str(work / "ref.pkl")
    with open(args, "wb") as f:
        pickle.dump((CASES, MESHES, DIVISIBLE, BATCHES, out), f)
    script = work / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(script), args], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _mesh(label):
    shape, axes = MESHES[label]
    return SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _entries(spec):
    return tuple(None if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec)


def _cfg(arch, reduced):
    return get_config(arch).reduced() if reduced else get_config(arch)


def _strip(axes, stacked: bool):
    if stacked:
        assert axes[0] is None, axes     # the reference's layers axis is never sharded
        return axes[1:]
    return axes


@pytest.mark.parametrize("arch,reduced", CASES)
def test_param_axes_and_specs(reference, arch, reduced):
    """Every port parameter's logical axes and its resolved spec on the four
    meshes equal its reference leaf's, the stacking axis stripped."""
    cfg = _cfg(arch, reduced)
    model = M.abstract_params(cfg)
    want = reference["params"][(arch, reduced)]
    keys = reference_keys(cfg, model)
    assert {k for k, _ in keys.values()} == set(want["logical"])
    logical = partition.param_logical_axes(model)
    for name, (key, idx) in keys.items():
        assert logical[name] == _strip(want["logical"][key], idx is not None), name
    for label in MESHES:
        specs = param_specs(cfg, _mesh(label))
        for name, (key, idx) in keys.items():
            got = _entries(specs[name])
            assert got == _strip(want["specs"][label][key], idx is not None), (label, name)
    if arch == "gemma2-9b" and not reduced:   # FSDP on (4, 1): "embed" over data
        specs = param_specs(cfg, _mesh("4x1"))
        assert _entries(specs["layers.0.attn.wq"])[0] == ("data",)
        assert _entries(specs["embed"]) == (("model",), ("data",))


def _port_cache_leaves(cfg, caches, axes):
    """(reference key, stacked?, port logical axes) of every cache tensor."""
    from repro_torch.models.layers import LayerCache
    from repro_torch.models.transformer import stack_geometry

    def fields(c, a):
        if isinstance(c, LayerCache):
            return [(f, v, x) for f, v, x in zip(LayerCache._fields, c, a) if v is not None]
        return [(k, c[k], a[k]) for k in c]

    out = []
    if cfg.family == "encdec":
        for c, a in zip(caches, axes):
            for f, v, x in fields(c["self"], a["self"]):
                out.append((f"self/{f}", True, v, x))
            for f in ("cross_k", "cross_v"):
                out.append((f, True, c[f], a[f]))
        return out
    reps, _ = stack_geometry(cfg)
    k = len(cfg.block_pattern)
    for i, (c, a) in enumerate(zip(caches, axes)):
        prefix, stacked = ((f"[0]/[{i % k}]", True) if i < reps * k
                           else (f"[1]/[{i - reps * k}]", False))
        for f, v, x in fields(c, a):
            out.append((f"{prefix}/{f}", stacked, v, x))
    return out


@pytest.mark.parametrize("arch,reduced", CASES)
def test_cache_axes_and_specs(reference, arch, reduced):
    """``cache_logical_axes`` of every layer's cache, and the specs the
    shape-aware resolver gives it (the kv_seq fallback included), equal the
    reference's stacked leaves with the stacking axis stripped."""
    cfg = _cfg(arch, reduced)
    caches = M.abstract_caches(cfg, DECODE)
    axes = partition.cache_logical_axes(caches)
    want = reference["caches"][(arch, reduced)]
    leaves = _port_cache_leaves(cfg, caches, axes)
    assert {k for k, *_ in leaves} == set(want["logical"])
    for key, stacked, _, logical in leaves:
        assert logical == _strip(want["logical"][key], stacked), key
    logical = {f"{i}": x for i, (_, _, _, x) in enumerate(leaves)}
    shapes = {f"{i}": tuple(v.shape) for i, (_, _, v, _) in enumerate(leaves)}
    for label in MESHES:
        got = partition.tree_shardings(logical, _mesh(label), shapes=shapes)
        for i, (key, stacked, _, _) in enumerate(leaves):
            assert _entries(got[f"{i}"].spec) == _strip(want["specs"][label][key], stacked), \
                (label, key)


def test_divisible_sharding(reference):
    got = [_entries(partition.divisible_sharding(_mesh(label), P(*spec), shape).spec)
           for label, spec, shape in DIVISIBLE]
    assert got == reference["divisible"]
    assert got[0] == (None, ("model",))     # the reference's own (3, 64) degrade


@pytest.mark.parametrize("i", range(len(BATCHES)))
def test_batch_shardings(reference, i):
    """Batch dims over the data axes, vlm positions (3, B, S) on dim 1, a
    batch that does not divide replicated; the port's ``(shape, dtype)``
    specs against the reference's ``ShapeDtypeStruct`` ones."""
    arch, b = BATCHES[i]
    specs = M.input_specs(get_config(arch).reduced(), ShapeConfig("t", 32, b, "train"))
    for label in MESHES:
        got = {k: _entries(s.spec) for k, s in batch_shardings(specs, _mesh(label)).items()}
        assert got == reference["batch"][i][label], label


def test_first_fit_without_shapes():
    """Without shapes the rules' first fit applies, as the reference's
    ``tree_shardings(abstract_tree=None)``: no dim degrades."""
    got = partition.tree_shardings({"w": ("embed", "heads", None)}, _mesh("1x2x2"))
    assert _entries(got["w"].spec) == (("data",), ("model",), None)


@pytest.mark.parametrize("world,multi,want", [
    (1, False, (1, 1)), (4, False, (4, 1)), (8, False, (8, 1)), (POD_CHIPS, False, (16, 16)),
    (2, True, (2, 1, 1)), (4, True, (2, 2, 1)), (2 * POD_CHIPS, True, (2, 16, 16)),
])
def test_production_shape(world, multi, want):
    """The reference's pod shapes at 256 and 512 ranks; a smaller world puts
    every rank on "data" (FSDP only)."""
    shape, axes = production_shape(world, multi_pod=multi)
    assert shape == want
    assert axes == (("pod", "data", "model") if multi else ("data", "model"))


@pytest.mark.parametrize("world,multi", [(POD_CHIPS + 1, False), (3, True), (2 * POD_CHIPS + 2, True),
                                         (0, False)])
def test_production_shape_refuses(world, multi):
    with pytest.raises(ValueError):
        production_shape(world, multi_pod=multi)
