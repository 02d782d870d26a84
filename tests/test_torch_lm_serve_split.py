"""The LM serve steps' split recurrent and expert layers on a ("data",
"model") mesh (1, 2), on the CPU: a gloo world of 2 processes serves the
rg-lru, rwkv6 (its one ``reduced()`` head, whole on every rank, and 4
heads of 16, split) and the MoE (GSPMD, arctic's with its parallel dense
MLP, and the manual expert-parallel layer) through
``build_prefill_step(mesh=)`` / ``build_decode_step(mesh=)``, held against
the port's ``mesh=None`` steps and the reference's own mesh steps.

On (1, 2) the rg-lru's ``w_branch`` pairs worst: rank 0 holds the whole
gate half and rank 1 the whole signal half, so each rank's channels need a
block the other holds.  The machinery and the bounds are
``tests/test_torch_lm_serve_mesh.py``'s (``start_worlds``): a prefill of a
B=4, 24-position prompt into 32-slot caches, 8 teacher-forced decode steps,
logits and caches within 1e-4 * max |ref|, positions exactly; during the
first decode step no weight and no recurrent state is gathered over
"model".  The worlds of 4 and of one of these archs are in that file.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_lm_serve_mesh import _hold, _leaves, _result, held_local, start_worlds  # noqa: E402

MESH = (1, 2)
ARCHS = ("recurrentgemma-2b", "rwkv6-3b", "rwkv6-3b-4h", "granite-moe-1b-a400m",
         "granite-moe-manual", "arctic-480b")
CELLS = [(a, MESH) for a in ARCHS]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return start_worlds(str(tmp_path_factory.mktemp("lm_serve_split")), ARCHS, CELLS, (), seed=300)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_layers_match_unsharded(world, arch):
    """Every step's logits and the gathered caches after the last step
    equal the port's ``mesh=None`` steps within 1e-4 * max |ref|."""
    res, want = _result(world, (arch, MESH)), world["unsharded"][arch]
    for i, (g, w) in enumerate(zip(res["logits"], want["logits"])):
        _hold(g, w, f"logits {i}")
    for i, (g, w) in enumerate(zip(_leaves(res["caches"]), _leaves(want["caches"]))):
        _hold(g, w, f"cache leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_split_layers_match_reference_mesh_steps(world, arch):
    """The same against the reference's own mesh steps on (1, 2), and each
    rank's blocks of the caches and logits against the reference's shards
    on the same device."""
    res, ref = _result(world, (arch, MESH)), world["reference"][(arch, MESH)]
    for i, (g, w) in enumerate(zip(res["logits"], ref["logits"])):
        _hold(g, w, f"logits {i}")
    got = _leaves(res["caches"])
    assert len(got) == len(ref["caches"])
    for i, (g, w) in enumerate(zip(got, ref["caches"])):
        _hold(g, w, f"cache leaf {i}")
    for r in range(2):
        mine = _result(world, (arch, MESH), r)
        assert mine["round_trip"]
        for i, g in enumerate(_leaves(mine["local_caches"])):
            want = ref["cache_shards"][i][r]
            assert want.shape == tuple(ref["spec_shapes"][i]), (i, want.shape)
            _hold(g, want, f"rank {r} cache leaf {i}")
        for i, g in enumerate(mine["local_logits"]):
            _hold(g, ref["logits_shards"][i][r], f"rank {r} logits {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_split_layers_gather_nothing_over_model(world, arch):
    """No weight and no recurrent state is gathered over "model" in a
    decode step, and both ranks gather the same bits of the results."""
    held_local(world, [(arch, MESH)])
    assert len({_result(world, (arch, MESH), r)["digest"] for r in range(2)}) == 1


def _states(tree):
    """(key, array) of every recurrent state in a cache structure."""
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            if k in ("h", "conv", "wkv"):
                yield k, np.asarray(v)
            else:
                yield from _states(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _states(v)


@pytest.mark.parametrize("arch,split", [("recurrentgemma-2b", True), ("rwkv6-3b-4h", True),
                                        ("rwkv6-3b", False)])
def test_recurrent_states_are_the_ranks_blocks(world, arch, split):
    """The rg-lru's ``h`` and ``conv`` and the 4-head rwkv6's ``wkv`` are
    held as each rank's half of their "state" channels or heads; the
    one-head rwkv6's ``wkv`` whole on each rank."""
    for r in range(2):
        res = _result(world, (arch, MESH), r)
        local = list(_states(res["local_caches"]))
        whole = list(_states(world["unsharded"][arch]["caches"]))
        assert local and [k for k, _ in local] == [k for k, _ in whole]
        for (k, g), (_, w) in zip(local, whole):
            dim = {"h": -1, "conv": -1, "wkv": -3}[k]
            want = list(w.shape)
            if split:
                want[dim] //= 2
            assert list(g.shape) == want, (k, g.shape, w.shape)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_branch_pairing_gives_each_rank_its_gate_and_signal(n):
    """``rglru._pairing``: on ``n`` ranks, what each rank sends each other
    (spans of its ``w_branch`` column block) concatenated in rank order is
    the receiver's gate columns then its signal columns, and the counts it
    expects match what it is sent."""
    from repro_torch.models.rglru import _pairing

    width = 6 * n
    block, chans = 2 * width // n, width // n
    cols = np.arange(2 * width)
    sends = [_pairing(width, n, r) for r in range(n)]
    for dst in range(n):
        got = np.concatenate([cols[src * block:(src + 1) * block][slice(*sends[src][0][dst])]
                              for src in range(n)])
        want = np.concatenate([np.arange(dst * chans, (dst + 1) * chans),
                               width + np.arange(dst * chans, (dst + 1) * chans)])
        np.testing.assert_array_equal(got, want)
        assert sends[dst][1] == [hi - lo for lo, hi in (sends[src][0][dst] for src in range(n))]
