"""The LM wing's layer modules (``models/layers.py``, ``moe.py``,
``rglru.py``, ``rwkv6.py``) against the reference's on the same inputs:
weights drawn by the reference's init functions and carried across by
``convert.load_params``, inputs made from numpy seeds.

Tolerances: float32 at module level, max |port - ref| <= 1e-5 * max |ref|;
bfloat16 (rms_norm, rope) within ``atol`` 5e-2, the reference's own bound.
Bitwise: masks, cache positions, int8 payloads and scales of
``quantize_kv`` on the same float32 input, and the MoE routing integers
(``dest_e``, ``dest_c``, ``keep``).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import rglru as RG  # noqa: E402
from repro.models import rwkv6 as RW  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import rglru as PG  # noqa: E402
from repro_torch.models import rwkv6 as PW  # noqa: E402
from repro_torch.models.convert import load_params, to_torch  # noqa: E402

torch.set_num_threads(1)

REL = 1e-5          # float32, module level, relative to max |ref|
BF16_ATOL = 5e-2    # bfloat16, the reference's own bound
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")


def _cfgs(arch, capacity_factor=None, **changes):
    """The reference's and the port's reduced config of ``arch``, float32,
    with the same changes."""
    out = []
    for get in (ref_config, port_config):
        cfg = dataclasses.replace(get(arch).reduced(), dtype="float32", **changes)
        if capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return out


def _np(x):
    return np.asarray(x).astype(np.float32) if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)


def _t(x):
    return to_torch(np.asarray(x), CPU)


def _close(got, want, rel=REL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else _np(got)
    want = _np(want).astype(np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _module(cls, cfg, tree, **kw):
    """The port's module of ``cls`` holding the reference's ``tree``."""
    m = cls(cfg, dtype=PL.model_dtype(cfg), device=CPU, **kw)
    load_params(m, jax.tree.map(np.asarray, tree))
    return m


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------- norms, rope


@pytest.mark.parametrize("arch,dtype", [("gemma2-9b", "float32"), ("deepseek-coder-33b", "float32"),
                                        ("gemma2-9b", "bfloat16")])
def test_rms_norm(arch, dtype):
    rcfg, pcfg = _cfgs(arch)
    x = _x((2, 5, 64), 1, 3.0)
    w = _x((64,), 2, 0.1)
    want = RL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), rcfg)
    got = PL.rms_norm(_t(x).to(getattr(torch, dtype)), _t(w), pcfg)
    if dtype == "float32":
        _close(got, want)
    else:
        assert float(np.abs(got.float().numpy() - _np(want)).max()) <= BF16_ATOL


def test_rope_1d_and_mrope():
    rcfg, pcfg = _cfgs("qwen2-vl-7b")
    rng = np.random.default_rng(3)
    pos2 = rng.integers(0, 500, (2, 7)).astype(np.int32)
    pos3 = rng.integers(0, 500, (3, 2, 7)).astype(np.int32)    # distinct streams
    for pos in (pos2, pos3):
        want = RL.rope_angles(rcfg, jnp.asarray(pos))
        got = PL.rope_angles(pcfg, _t(pos))
        _close(got, want)
        x = _x((2, 7, 4, 16), 4)
        _close(PL.apply_rope(_t(x), got), RL.apply_rope(jnp.asarray(x), want))
        xb = jnp.asarray(x, jnp.bfloat16)
        got_b = PL.apply_rope(_t(np.asarray(xb)), got)
        assert got_b.dtype == torch.bfloat16
        assert float(np.abs(got_b.float().numpy() - _np(RL.apply_rope(xb, want))).max()) <= BF16_ATOL
    with pytest.raises(ValueError, match="mrope"):
        PL.rope_angles(_cfgs("gemma2-9b")[1], _t(pos3))


def test_masks_bitwise():
    for s, window in ((9, 4), (16, 16), (5, 1)):
        np.testing.assert_array_equal(PL.causal_mask(s, device=CPU).numpy(), _np(RL.causal_mask(s)))
        np.testing.assert_array_equal(PL.local_causal_mask(s, window, device=CPU).numpy(),
                                      _np(RL.local_causal_mask(s, window)))
    rng = np.random.default_rng(5)
    kv_pos = rng.integers(-1, 30, (3, 12)).astype(np.int32)
    q_pos = rng.integers(0, 30, (3,)).astype(np.int32)
    for window in (None, 4):
        np.testing.assert_array_equal(
            PL.decode_mask(_t(q_pos), _t(kv_pos), window).numpy(),
            _np(RL.decode_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), window)))


# ---------------------------------------------------------------- KV cache


def test_quantize_kv_bitwise():
    x = _x((2, 9, 3, 16), 6, 2.0)
    x[0, 0, 0] = 0.0                              # an all-zero row: scale floor 1e-8
    x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 2.5]        # halves: round half to even
    q, s = PL.quantize_kv(_t(x))
    rq, rs = RL.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.view(torch.int16).numpy(), np.asarray(rs).view(np.int16))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(PL.dequantize_kv(q, s, torch.float32).numpy(),
                                  _np(RL.dequantize_kv(rq, rs, jnp.float32)))


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_cache_ring_insert(kv_dtype):
    """Inserting 13 decode steps into a ring of 5 slots: positions bitwise,
    payloads as the reference's."""
    rcfg, pcfg = _cfgs("gemma2-9b", kv_cache_dtype=kv_dtype)
    b, cap = 2, 5
    rc = RL.init_layer_cache(rcfg, b, cap, jnp.float32)
    pc = PL.init_layer_cache(pcfg, b, cap, torch.float32, CPU)
    for step in range(13):
        k = _x((b, 1, 2, 16), 10 + step)
        v = _x((b, 1, 2, 16), 50 + step)
        pos = np.array([step, step + 3], np.int32)
        rc = RL.cache_insert(rc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        pc = PL.cache_insert(pc, _t(k), _t(v), _t(pos))
        np.testing.assert_array_equal(pc.positions.numpy(), np.asarray(rc.positions))
    for got, want in zip(pc, rc):
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    for got, want in zip(PL.cache_kv_values(pc, torch.float32), RL.cache_kv_values(rc, jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), _np(want))


# --------------------------------------------------------------- attention


def _attn(arch, seed=0, **changes):
    rcfg, pcfg = _cfgs(arch, **changes)
    tree = RL.init_attention_params(rcfg, jax.random.PRNGKey(seed), jnp.float32)
    if rcfg.qkv_bias:   # non-zero biases, so the bias path is held too
        tree = {k: (v + 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1), v.shape)
                    if k.startswith("b") else v) for k, v in tree.items()}
    return rcfg, pcfg, tree, _module(PL.Attention, pcfg, tree)


@pytest.mark.parametrize("arch,chunk,window", [
    ("gemma2-9b", 0, None), ("gemma2-9b", 0, 16), ("qwen1.5-32b", 0, None),
    ("gemma2-9b", 7, 16), ("deepseek-coder-33b", 8, None),
])
def test_attention_full_sequence(arch, chunk, window):
    """Dense (softcap, GQA, biases) and chunked online-softmax attention,
    ragged chunks and a local window included, with rope."""
    rcfg, pcfg, tree, mod = _attn(arch, attn_chunk=chunk)
    b, s = 2, 40
    x = _x((b, s, 64), 7)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    r_ang = RL.rope_angles(rcfg, jnp.asarray(pos))
    p_ang = PL.rope_angles(pcfg, _t(pos))
    r_mask = None if chunk else (RL.local_causal_mask(s, window) if window else RL.causal_mask(s))
    p_mask = None if chunk else (PL.local_causal_mask(s, window, device=CPU) if window
                                 else PL.causal_mask(s, device=CPU))
    want, _ = RL.attention(rcfg, tree, jnp.asarray(x), angles=r_ang, mask=r_mask, window=window)
    got, cache = PL.attention(pcfg, mod, _t(x), angles=p_ang, mask=p_mask, window=window)
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("chunk", [0, 8])
def test_attention_bidirectional(chunk):
    """The encoder's non-causal attention, dense and chunked."""
    rcfg, pcfg, tree, mod = _attn("whisper-small", attn_chunk=chunk)
    x = _x((2, 19, 64), 8)
    want, _ = RL.attention(rcfg, tree, jnp.asarray(x), angles=None, mask=None, causal=False)
    got, _ = PL.attention(pcfg, mod, _t(x), angles=None, mask=None, causal=False)
    _close(got, want)


def test_attention_cross_kv_override():
    rcfg, pcfg, tree, mod = _attn("whisper-small")
    x = _x((2, 3, 64), 9)
    k, v = _x((2, 11, 4, 16), 10), _x((2, 11, 4, 16), 11)
    want, _ = RL.attention(rcfg, tree, jnp.asarray(x), angles=None, mask=None,
                           kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got, _ = PL.attention(pcfg, mod, _t(x), angles=None, mask=None, kv_override=(_t(k), _t(v)))
    _close(got, want)


@pytest.mark.parametrize("kv_dtype,window", [("bfloat16", None), ("bfloat16", 6), ("int8", 6)])
def test_attention_decode_ring(kv_dtype, window):
    """Twenty decode steps against a cache of 6 slots that wraps (local
    window 6), and against a global cache; float and int8 payloads."""
    rcfg, pcfg, tree, mod = _attn("gemma2-9b", kv_cache_dtype=kv_dtype)
    b, steps = 2, 20
    cap = 6 if window else steps
    rc = RL.init_layer_cache(rcfg, b, cap, jnp.float32)
    pc = PL.init_layer_cache(pcfg, b, cap, torch.float32, CPU)
    for step in range(steps):
        x = _x((b, 1, 64), 100 + step)
        pos = np.array([step, step], np.int32)
        r_ang = RL.rope_angles(rcfg, jnp.asarray(pos[:, None]))
        p_ang = PL.rope_angles(pcfg, _t(pos[:, None]))
        want, rc = RL.attention(rcfg, tree, jnp.asarray(x), angles=r_ang, mask=None, cache=rc,
                                decode_pos=jnp.asarray(pos), window=window)
        got, pc = PL.attention(pcfg, mod, _t(x), angles=p_ang, mask=None, cache=pc,
                               decode_pos=_t(pos), window=window)
        _close(got, want)
        np.testing.assert_array_equal(pc.positions.numpy(), np.asarray(rc.positions))
    for got, want in zip(PL.cache_kv_values(pc, torch.float32), RL.cache_kv_values(rc, jnp.float32)):
        _close(got, want)


# --------------------------------------------------------------------- mlp


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "gemma-7b", "whisper-small"])
def test_mlp_activations(arch):
    """silu, geglu and gelu; both GELUs in their tanh form."""
    rcfg, pcfg = _cfgs(arch)
    tree = RL.init_mlp_params(rcfg, KEY, jnp.float32)
    mod = _module(PL.MLP, pcfg, tree)
    x = _x((2, 7, 64), 12, 2.0)
    _close(PL.mlp(pcfg, mod, _t(x)), RL.mlp(rcfg, tree, jnp.asarray(x)))


def test_final_softcap():
    rcfg, pcfg = _cfgs("gemma2-9b")
    x = _x((2, 3, 50), 13, 40.0)
    _close(PL.final_softcap(pcfg, _t(x)), RL.final_softcap(rcfg, jnp.asarray(x)))


# --------------------------------------------------------------------- moe


class _JnpRecorder:
    """Stands in for ``jnp`` inside ``repro.models.moe`` and keeps each
    round's ``where(keep, expert, 0)`` and ``clip(pos_tok, ...)``."""

    def __init__(self):
        self.wheres, self.clips = [], []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, *args):
        out = jnp.where(*args)
        self.wheres.append((args, out))
        return out

    def clip(self, *args, **kw):
        out = jnp.clip(*args, **kw)
        self.clips.append(out)
        return out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "arctic-480b"])
def test_moe_layer_with_drops(arch, monkeypatch):
    """Capacity factor 0.5: tokens are dropped.  Output and aux loss as the
    reference's; every round's routing integers bitwise."""
    rcfg, pcfg = _cfgs(arch, capacity_factor=0.5)
    tree = RMOE.init_moe_params(rcfg, KEY, jnp.float32)
    mod = _module(PMOE.MoE, pcfg, tree)
    x = _x((2, 16, 64), 14)
    rec = _JnpRecorder()
    monkeypatch.setattr(RMOE, "jnp", rec)
    want, want_aux = RMOE.moe_layer(rcfg, tree, jnp.asarray(x))
    monkeypatch.undo()
    got, got_aux = PMOE.moe_layer(pcfg, mod, _t(x))
    _close(got, want)
    _close(got_aux, want_aux)

    probs = torch.softmax(_t(x).reshape(-1, 64) @ mod.router, dim=-1)
    routes, _ = PMOE.moe_route(pcfg, probs)
    top_k = rcfg.moe.top_k
    assert len(routes) == top_k and len(rec.clips) == top_k and len(rec.wheres) == 3 * top_k
    dropped = 0
    for r, route in enumerate(routes):
        (keep, _, _), dest_e = rec.wheres[3 * r]
        np.testing.assert_array_equal(route.keep.numpy(), np.asarray(keep))
        np.testing.assert_array_equal(route.dest_e.numpy(), np.asarray(dest_e).astype(np.int32))
        np.testing.assert_array_equal(route.dest_c.numpy(), np.asarray(rec.clips[r]).astype(np.int32))
        dropped += int((~route.keep).sum())
    assert dropped > 0
    # a kept token's (expert, slot) is unique across tokens and rounds
    kept = [(int(e), int(c)) for route in routes
            for e, c, k in zip(route.dest_e, route.dest_c, route.keep) if k]
    assert len(kept) == len(set(kept))


# -------------------------------------------------------------- recurrences


def test_rglru_fresh_and_carried():
    """A fresh 9-token mix, then 3 tokens more from its cache, then one
    decode token: outputs and the float32 state as the reference's."""
    rcfg, pcfg = _cfgs("recurrentgemma-2b")
    tree = RG.init_rglru_params(rcfg, KEY, jnp.float32)
    mod = _module(PG.RGLRU, pcfg, tree)
    r_cache = p_cache = None
    for n, seed in ((9, 15), (3, 16), (1, 17)):
        x = _x((2, n, 64), seed)
        want, r_cache = RG.rglru_mix(rcfg, tree, jnp.asarray(x), r_cache)
        got, p_cache = PG.rglru_mix(pcfg, mod, _t(x), p_cache)
        _close(got, want)
        assert p_cache["h"].dtype == torch.float32
        for key in ("h", "conv"):
            _close(p_cache[key], r_cache[key])


def test_rwkv_block_fresh_and_carried():
    rcfg, pcfg = _cfgs("rwkv6-3b")
    tree = RW.init_rwkv_params(rcfg, KEY, jnp.float32)
    # non-trivial static mixes, bonus and decay base, so each term is held
    rng = np.random.default_rng(18)
    tree = dict(tree)
    for name in ("mu_x", "bonus", "cm_mu_k", "cm_mu_r", "decay_base"):
        tree[name] = tree[name] + jnp.asarray(rng.normal(scale=0.3, size=tree[name].shape), jnp.float32)
    mod = _module(PW.RWKV, pcfg, tree)
    n1, n2 = _x((64,), 19, 0.1) + 1.0, _x((64,), 20, 0.1) + 1.0
    r_cache = p_cache = None
    for n, seed in ((9, 21), (3, 22), (1, 23)):
        x = _x((2, n, 64), seed)
        want, r_cache = RW.rwkv_block(rcfg, tree, jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(x), r_cache)
        got, p_cache = PW.rwkv_block(pcfg, mod, _t(n1), _t(n2), _t(x), p_cache)
        _close(got, want)
        assert p_cache["wkv"].dtype == torch.float32
        for key in ("wkv", "shift_tm", "shift_cm"):
            _close(p_cache[key], r_cache[key])


def test_rwkv_decay_clip_and_group_norm():
    """The decay exponent clips at [-10, 4]; the group norm divides by the
    population variance."""
    rcfg, pcfg = _cfgs("rwkv6-3b")
    tree = RW.init_rwkv_params(rcfg, KEY, jnp.float32)
    tree = dict(tree, decay_base=jnp.asarray(_x((1, 64), 24, 20.0)))   # far outside [-10, 4]
    mod = _module(PW.RWKV, pcfg, tree)
    x = _x((2, 5, 64), 25)
    _close(PW._decay(mod, _t(x)), RW._decay(tree, jnp.asarray(x)))
    y = _x((2, 5, 1, 64), 26, 3.0)
    g = _x((1, 64), 27)
    _close(PW._group_norm(_t(y), _t(g)), RW._group_norm(jnp.asarray(y), jnp.asarray(g)))
