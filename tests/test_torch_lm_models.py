"""The decoder-only families (``repro_torch.models.transformer``) against the
reference on the same inputs: every LM arch but whisper at ``reduced()``,
weights drawn by the reference and carried across by ``params_from_jax``.

Each (arch, variant) runs once per module (the ``runs`` fixture): the
reference's prefill of a 20-token prompt into caches of 28 positions (so
the local layers' 16-slot rings wrap), four decode steps and the
full-sequence forward, then the same through the port.

Tolerances: float32, whole model, max |port - ref| <= 1e-4 * max |ref| on
logits and cache values; bfloat16 within ``atol`` 5e-2, the reference's own
bound, on logits (cache values 5e-2 * max |ref|).  Cache positions are
bitwise; int8 payloads within one unit (``quantize_kv`` is bitwise on the
same float32 input, ``tests/test_torch_lm_layers.py``; here the inputs
differ by float32 rounding).  The port's own identities mirror
``tests/test_models.py``: prefill/decode == forward at the same positions,
and ``scan_layers`` does not change the logits.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import LM_ARCHS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

torch.set_num_threads(1)

REL = 1e-4          # float32, whole model, relative to max |ref|
BF16_ATOL = 5e-2    # bfloat16, the reference's own bound
B, S, STEPS, CAP = 2, 20, 4, 28
ARCHS = [a for a in LM_ARCHS if a != "whisper-small"]
KEY = jax.random.PRNGKey(0)


def _cfgs(arch, dtype="float32", **changes):
    out = []
    for get in (ref_config, port_config):
        cfg = dataclasses.replace(get(arch).reduced(), dtype=dtype, **changes)
        if cfg.moe is not None:   # permissive capacity, as the reference's tests: no drops
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        out.append(cfg)
    return out


def _inputs(cfg, seed=0):
    """tokens (B, S+STEPS), positions, vision stub embeddings (vlm)."""
    rng = np.random.default_rng(seed)
    patches = 4 if cfg.family == "vlm" else 0
    tokens = rng.integers(0, cfg.vocab, (B, S + STEPS - patches)).astype(np.int32)
    extra = (rng.normal(size=(B, patches, cfg.d_model)) * 0.02).astype(np.float32) if patches else None
    n = S + STEPS
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (3, B, n) if patches else (B, n)).copy()
    return tokens, pos, extra, patches


def _f32(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _reference(rcfg, params, tokens, pos, extra, patches):
    n_prompt = S - patches
    extra_j = None if extra is None else jnp.asarray(extra)
    full, _ = RT.forward_train(rcfg, params, jnp.asarray(tokens), jnp.asarray(pos), extra_embeds=extra_j)
    last, caches = RT.prefill(rcfg, params, jnp.asarray(tokens[:, :n_prompt]), jnp.asarray(pos[..., :S]),
                              cache_capacity=CAP, extra_embeds=extra_j)
    out = {"full": _f32(full), "prefill": _f32(last),
           "prefill_caches": jax.tree.leaves(jax.tree.map(np.asarray, caches)), "decode": []}
    for i in range(STEPS):
        logits, caches = RT.decode(rcfg, params, jnp.asarray(tokens[:, n_prompt + i]),
                                   jnp.full((B,), S + i, jnp.int32), caches)
        out["decode"].append(_f32(logits))
    out["caches"] = jax.tree.leaves(jax.tree.map(np.asarray, caches))
    return out


def _port(pcfg, model, tokens, pos, extra, patches):
    n_prompt = S - patches
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    extra_t = None if extra is None else t(extra)
    full, _ = PT.forward_train(pcfg, model, t(tokens).long(), t(pos), extra_embeds=extra_t)
    last, caches = PT.prefill(pcfg, model, t(tokens[:, :n_prompt]).long(), t(pos[..., :S]),
                              cache_capacity=CAP, extra_embeds=extra_t)
    out = {"full": full.numpy(), "prefill": last.numpy(),
           "prefill_caches": jax.tree.leaves(convert.caches_to_numpy(pcfg, caches)), "decode": [],
           "caches_in": caches}
    for i in range(STEPS):
        logits, caches = PT.decode(pcfg, model, t(tokens[:, n_prompt + i]).long(),
                                   torch.full((B,), S + i, dtype=torch.int32), caches)
        out["decode"].append(logits.numpy())
    out["caches"] = jax.tree.leaves(convert.caches_to_numpy(pcfg, caches))
    out["caches_out"] = caches
    return out


@pytest.fixture(scope="module")
def runs():
    """``get(arch, dtype, **changes) -> (ref, port, pcfg, model)``, each run
    once per module."""
    memo = {}

    def get(arch, dtype="float32", **changes):
        key = (arch, dtype, tuple(sorted(changes.items())))
        if key not in memo:
            rcfg, pcfg = _cfgs(arch, dtype, **changes)
            params = RT.init_params(rcfg, KEY)
            model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu")
            inputs = _inputs(rcfg)
            memo[key] = (_reference(rcfg, params, *inputs), _port(pcfg, model, *inputs), pcfg, model)
        return memo[key]

    return get


def _hold(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = REL * float(np.abs(want).max()) if dtype == "float32" else BF16_ATOL
    assert err <= bound, (err, bound)


def _hold_caches(got, want, dtype):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype == np.int32:                      # positions
            np.testing.assert_array_equal(g, w)
        elif w.dtype == np.int8:                     # int8 payloads
            assert g.dtype == np.int8 and np.abs(g.astype(np.int32) - w).max() <= 1
        else:
            rel = REL if dtype == "float32" else BF16_ATOL
            assert float(np.abs(_f32(g) - _f32(w)).max()) <= rel * float(np.abs(_f32(w)).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(runs, arch):
    ref, port, _, _ = runs(arch)
    _hold(port["prefill"], ref["prefill"], "float32")
    _hold_caches(port["prefill_caches"], ref["prefill_caches"], "float32")
    for got, want in zip(port["decode"], ref["decode"]):
        _hold(got, want, "float32")
    _hold_caches(port["caches"], ref["caches"], "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(runs, arch):
    ref, port, _, _ = runs(arch)
    _hold(port["full"], ref["full"], "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(runs, arch):
    """The port's prefill logits equal its forward at S-1, each decode step
    its forward at the step's position (as the reference's
    ``test_prefill_decode_consistency``)."""
    _, port, _, _ = runs(arch)
    _hold(port["prefill"], port["full"][:, S - 1], "float32")
    for i, got in enumerate(port["decode"]):
        _hold(got, port["full"][:, S + i], "float32")


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-2b", "rwkv6-3b", "granite-moe-1b-a400m"])
def test_bfloat16_matches_reference(runs, arch):
    ref, port, _, _ = runs(arch, "bfloat16")
    for got, want in zip([port["prefill"], *port["decode"]], [ref["prefill"], *ref["decode"]]):
        _hold(got, want, "bfloat16")
    _hold(port["full"], ref["full"], "bfloat16")
    _hold_caches(port["caches"], ref["caches"], "bfloat16")


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "gemma2-9b"])
def test_int8_kv_cache_matches_reference(runs, arch):
    ref, port, _, _ = runs(arch, kv_cache_dtype="int8")
    assert any(leaf.dtype == np.int8 for leaf in port["caches"])
    _hold(port["prefill"], ref["prefill"], "float32")
    for got, want in zip(port["decode"], ref["decode"]):
        _hold(got, want, "float32")
    _hold_caches(port["caches"], ref["caches"], "float32")


@pytest.mark.parametrize("arch,chunk", [("gemma2-9b", 7), ("deepseek-coder-33b", 8)])
def test_chunked_attention_matches_reference(runs, arch, chunk):
    """Flash-style attention over ragged KV chunks (local and global masks)
    in the forward and in prefill; decode keeps the dense path."""
    ref, port, _, _ = runs(arch, attn_chunk=chunk)
    _hold(port["full"], ref["full"], "float32")
    _hold(port["prefill"], ref["prefill"], "float32")
    for got, want in zip(port["decode"], ref["decode"]):
        _hold(got, want, "float32")


def test_local_ring_capacity():
    """Local layers get a ring of min(capacity, local_window) slots, global
    layers the whole capacity."""
    _, pcfg = _cfgs("gemma2-9b")
    cache = PT.init_cache(pcfg, 1, CAP, torch.float32, "cpu")
    kinds = PT._layer_kinds(pcfg)
    assert [c.k.shape[1] for c in cache] == [16 if k == "local" else CAP for k in kinds]


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-2b"])
def test_ring_positions_after_decode(runs, arch):
    """The 20-token prompt overflows the 16-slot local ring and decode goes
    on overwriting the oldest slot: the ring ends holding the last 16
    positions, each at slot position % 16."""
    _, port, pcfg, _ = runs(arch)
    last = S + STEPS - 1
    for kind, cache in zip(PT._layer_kinds(pcfg), port["caches_out"]):
        if kind == "local":
            assert sorted(cache.positions[0].tolist()) == list(range(last - 15, last + 1))
            assert all(p % 16 == i for i, p in enumerate(cache.positions[0].tolist()))


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-2b", "granite-moe-1b-a400m"])
def test_scan_layers_has_no_effect(runs, arch):
    """The reference's ``test_scan_vs_unrolled_identical``: in the port both
    values of ``scan_layers`` run the same layers in the same order."""
    _, port, pcfg, model = runs(arch)
    tokens, pos, extra, _ = _inputs(pcfg)
    args = (model, torch.from_numpy(tokens).long(), torch.from_numpy(pos))
    unrolled, _ = PT.forward_train(dataclasses.replace(pcfg, scan_layers=False), *args)
    assert torch.equal(unrolled, torch.from_numpy(port["full"]))


def test_decode_writes_attention_caches_in_place(runs):
    """The decode step consumes the caches it is given: attention caches
    come back as the same tensors, written in place."""
    _, port, pcfg, _ = runs("gemma2-9b")
    for c_in, c_out in zip(port["caches_in"], port["caches_out"]):
        assert c_in.k is c_out.k and c_in.positions is c_out.positions
    assert int(port["caches_in"][1].positions.max()) == S + STEPS - 1
