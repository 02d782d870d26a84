"""The LM wing's serving surface against the reference: whisper's
encoder-decoder (``models/encdec.py``), ``models/api.py``,
``train/serve_step.py``, ``configs/``, ``train/data.py`` and the weight and
cache carry-over (``models/convert.py``).

Tolerances: float32, whole model, max |port - ref| <= 1e-4 * max |ref|;
bfloat16 within ``atol`` 5e-2, the reference's own bound.  Bitwise: every
config field (``reduced()``, ``padded_vocab`` and ``supported_shapes``
included), ``make_batch`` arrays, cache positions, and caches carried
across and back.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.models import api as RM  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import data as RD  # noqa: E402
from repro.train import serve_step as RS  # noqa: E402
import repro_torch.configs as PC  # noqa: E402
from repro_torch.models import api as PM  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import encdec as PE  # noqa: E402
from repro_torch.models import sharding_ctx  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.train import TokenStream, make_batch  # noqa: E402
from repro_torch.train import serve_step as PS  # noqa: E402

torch.set_num_threads(1)

REL = 1e-4          # float32, whole model, relative to max |ref|
BF16_ATOL = 5e-2    # bfloat16, the reference's own bound
B, S, STEPS, CAP = 2, 12, 4, 20
KEY = jax.random.PRNGKey(0)


def _f32(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _hold(got, want, dtype="float32"):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = REL * float(np.abs(want).max()) if dtype == "float32" else BF16_ATOL
    assert err <= bound, (err, bound)


def _hold_caches(got, want, rel=REL):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _f32(g), _f32(w)
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            assert float(np.abs(g - w).max()) <= rel * float(np.abs(w).max())


def _cfgs(arch, dtype="float32", **changes):
    return [dataclasses.replace(get(arch).reduced(), dtype=dtype, **changes)
            for get in (RC.get_config, PC.get_config)]


# ------------------------------------------------------------------ configs


def test_configs_field_for_field():
    assert PC.list_archs() == RC.list_archs()
    assert PC.LM_ARCHS == RC.LM_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in PC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    for name, shape in PC.SHAPES.items():
        assert dataclasses.asdict(shape.reduced()) == dataclasses.asdict(RC.SHAPES[name].reduced())
    for arch in RC.list_archs():
        ref, port = RC.get_config(arch), PC.get_config(arch)
        assert type(port).__name__ == type(ref).__name__
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
        assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced()), arch
        if arch == "gwas_ukb":
            continue
        for cfg_p, cfg_r in ((port, ref), (port.reduced(), ref.reduced())):
            for prop in ("resolved_head_dim", "padded_vocab", "attention_free", "sub_quadratic"):
                assert getattr(cfg_p, prop) == getattr(cfg_r, prop), (arch, prop)
            got = {k: None if v is None else dataclasses.asdict(v)
                   for k, v in PC.supported_shapes(cfg_p).items()}
            want = {k: None if v is None else dataclasses.asdict(v)
                    for k, v in RC.supported_shapes(cfg_r).items()}
            assert got == want, arch
    with pytest.raises(KeyError, match="unknown arch"):
        PC.get_config("gpt-5")


@pytest.mark.parametrize("arch", RC.LM_ARCHS)
def test_make_batch_bitwise(arch):
    shape = RC.ShapeConfig("t", seq_len=24, global_batch=3, kind="train")
    pshape = PC.ShapeConfig("t", seq_len=24, global_batch=3, kind="train")
    for step, seed in ((0, 0), (5, 2026)):
        want = RD.make_batch(RC.get_config(arch).reduced(), shape, step, seed=seed)
        got = make_batch(PC.get_config(arch).reduced(), pshape, step, seed=seed)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    ref = RD.TokenStream(RC.get_config(arch).reduced(), shape, seed=3, start_step=2)
    port = TokenStream(PC.get_config(arch).reduced(), pshape, seed=3, start_step=2)
    for _ in range(2):
        a, b = next(ref), next(port)
        for key in a:
            np.testing.assert_array_equal(b[key], a[key])


# ---------------------------------------------------------------- whisper


def _whisper_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(B, cfg.encoder_len, cfg.d_model)) * 0.02).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    return frames, tokens


@pytest.fixture(scope="module")
def whisper():
    """``get(dtype, **changes) -> (ref, port, pcfg)``: whisper's forward,
    prefill and four decode steps through both packages, once each."""
    memo = {}

    def get(dtype="float32", **changes):
        key = (dtype, tuple(sorted(changes.items())))
        if key in memo:
            return memo[key]
        rcfg, pcfg = _cfgs("whisper-small", dtype, **changes)
        params = RE.init_encdec_params(rcfg, KEY, max_positions=64)
        model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu")
        frames, tokens = _whisper_inputs(rcfg)
        ref, port = {"decode": []}, {"decode": []}
        ref["full"] = _f32(RE.forward_train(rcfg, params, jnp.asarray(frames), jnp.asarray(tokens)))
        last, caches = RE.prefill(rcfg, params, jnp.asarray(frames), jnp.asarray(tokens[:, :S]),
                                  cache_capacity=CAP)
        ref["prefill"], ref["prefill_caches"] = _f32(last), jax.tree.map(np.asarray, caches)
        f_t, tok_t = torch.from_numpy(frames), torch.from_numpy(tokens).long()
        port["full"] = PE.forward_train(pcfg, model, f_t, tok_t).numpy()
        last, pc = PE.prefill(pcfg, model, f_t, tok_t[:, :S], cache_capacity=CAP)
        port["prefill"], port["prefill_caches"] = last.numpy(), convert.caches_to_numpy(pcfg, pc)
        for i in range(STEPS):
            logits, caches = RE.decode(rcfg, params, jnp.asarray(tokens[:, S + i]),
                                       jnp.full((B,), S + i, jnp.int32), caches)
            ref["decode"].append(_f32(logits))
            logits, pc = PE.decode(pcfg, model, tok_t[:, S + i], torch.full((B,), S + i, dtype=torch.int32), pc)
            port["decode"].append(logits.numpy())
        ref["caches"] = jax.tree.map(np.asarray, caches)
        port["caches"] = convert.caches_to_numpy(pcfg, pc)
        memo[key] = (ref, port, pcfg)
        return memo[key]

    return get


def test_whisper_prefill_and_decode_match_reference(whisper):
    ref, port, _ = whisper()
    _hold(port["full"], ref["full"])
    _hold(port["prefill"], ref["prefill"])
    _hold_caches(port["prefill_caches"], ref["prefill_caches"])
    for got, want in zip(port["decode"], ref["decode"]):
        _hold(got, want)
    _hold_caches(port["caches"], ref["caches"])


def test_whisper_prefill_decode_consistency(whisper):
    _, port, _ = whisper()
    _hold(port["prefill"], port["full"][:, S - 1])
    for i, got in enumerate(port["decode"]):
        _hold(got, port["full"][:, S + i])


def test_whisper_chunked_attention_matches_reference(whisper):
    """Chunks of 8: the bidirectional encoder and the causal decoder prompt."""
    ref, port, _ = whisper(attn_chunk=8)
    _hold(port["full"], ref["full"])
    _hold(port["prefill"], ref["prefill"])
    _hold(port["decode"][-1], ref["decode"][-1])


def test_whisper_bfloat16_matches_reference(whisper):
    ref, port, _ = whisper("bfloat16")
    for got, want in zip([port["full"], port["prefill"], *port["decode"]],
                         [ref["full"], ref["prefill"], *ref["decode"]]):
        _hold(got, want, "bfloat16")
    _hold_caches(port["caches"], ref["caches"], rel=BF16_ATOL)


def test_whisper_self_cache_carries_kv_biases():
    """With ``qkv_bias`` on and non-zero biases, the port's prefill lays the
    self-attention k/v biases into the cache, so decode equals the forward.
    The reference's prefill leaves them out (ROADMAP.md §3); whisper-small
    itself has no biases."""
    _, pcfg = _cfgs("whisper-small", qkv_bias=True)
    gen = torch.Generator().manual_seed(0)
    model = PM.init_model(pcfg, generator=gen, device="cpu", max_positions=64)
    for block in model.decoder:
        for name in ("bq", "bk", "bv"):
            getattr(block.self_attn, name).normal_(generator=gen)
    frames, tokens = (torch.from_numpy(a) for a in _whisper_inputs(pcfg))
    tokens = tokens.long()
    full = PE.forward_train(pcfg, model, frames, tokens)
    last, caches = PE.prefill(pcfg, model, frames, tokens[:, :S], cache_capacity=CAP)
    dec, _ = PE.decode(pcfg, model, tokens[:, S], torch.full((B,), S, dtype=torch.int32), caches)
    _hold(last, full[:, S - 1])
    _hold(dec, full[:, S])


# --------------------------------------------------------------------- api


_DTYPE_NAMES = {torch.int32: "int32", torch.float32: "float32", torch.bfloat16: "bfloat16"}


@pytest.mark.parametrize("arch", RC.LM_ARCHS)
def test_input_specs_match_reference(arch):
    for cfg_r, cfg_p in ((RC.get_config(arch), PC.get_config(arch)),
                         (RC.get_config(arch).reduced(), PC.get_config(arch).reduced())):
        for name in RC.SHAPES:
            for sr, sp in ((RC.SHAPES[name], PC.SHAPES[name]),
                           (RC.SHAPES[name].reduced(), PC.SHAPES[name].reduced())):
                want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
                        for k, v in RM.input_specs(cfg_r, sr).items()}
                got = {k: (shape, _DTYPE_NAMES[dt]) for k, (shape, dt) in PM.input_specs(cfg_p, sp).items()}
                assert got == want, (arch, name)


def _ref_layer_leaves(cfg_r, tree, kinds_len):
    """Per layer of the port, the reference's leaves as {dotted path: (shape,
    dtype name)}: pattern stacks unstacked over repeats, then the tail."""
    reps, tail = RT.stack_geometry(cfg_r)
    k = len(cfg_r.block_pattern)

    def leaves(block, stacked):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(block)[0]:
            name = ".".join(str(p.key if hasattr(p, "key") else p.name) for p in path)
            out[name] = (tuple(leaf.shape[1:] if stacked else leaf.shape), np.dtype(leaf.dtype).name)
        return out

    layers = [leaves(tree["pattern"][i % k], True) for i in range(reps * k)]
    layers += [leaves(tree["tail"][i], False) for i in range(len(tail))]
    assert len(layers) == kinds_len
    return layers


def _port_leaves(module):
    return {name: (tuple(p.shape), _DTYPE_NAMES[p.dtype]) for name, p in module.named_parameters()}


@pytest.mark.parametrize("arch", RC.LM_ARCHS)
def test_abstract_params_and_caches_match_reference(arch):
    """Full-size configs on the ``meta`` device: every parameter and cache
    leaf of the port has the reference's shape and dtype, layer by layer."""
    cfg_r, cfg_p = RC.get_config(arch), PC.get_config(arch)
    ref = RM.abstract_params(cfg_r)
    port = PM.abstract_params(cfg_p)
    assert all(p.device.type == "meta" for p in port.parameters())
    if cfg_p.family == "encdec":
        for part in ("encoder", "decoder"):
            for block in getattr(port, part):
                want = {".".join(str(q.key) for q in path): (tuple(leaf.shape[1:]), np.dtype(leaf.dtype).name)
                        for path, leaf in jax.tree_util.tree_flatten_with_path(ref[part])[0]}
                assert _port_leaves(block) == want
        top = {k: v for k, v in ref.items() if k not in ("encoder", "decoder")}
    else:
        for block, want in zip(port.layers, _ref_layer_leaves(cfg_r, ref, len(port.layers))):
            assert _port_leaves(block) == want, arch
        top = {k: v for k, v in ref.items() if k not in ("pattern", "tail")}
    got_top = {k: v for k, v in _port_leaves(port).items() if "." not in k}
    assert got_top == {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in top.items()}

    shape_r, shape_p = RC.SHAPES["decode_32k"], PC.SHAPES["decode_32k"]
    ref_c = jax.tree.leaves(RM.abstract_caches(cfg_r, shape_r))
    port_c = PM.abstract_caches(cfg_p, shape_p)
    if cfg_p.family == "encdec":
        want = [(tuple(leaf.shape[1:]), np.dtype(leaf.dtype).name) for leaf in ref_c]
        for layer in port_c:
            got = [(tuple(t.shape), _DTYPE_NAMES[t.dtype]) for t in jax.tree.leaves(
                {"cross_k": layer["cross_k"], "cross_v": layer["cross_v"], "self": layer["self"]})]
            assert got == want
    else:
        reps, _ = PT.stack_geometry(cfg_p)
        k = len(cfg_p.block_pattern)
        pattern, tail = RM.abstract_caches(cfg_r, shape_r)
        for i, layer in enumerate(port_c):
            ref_layer = pattern[i % k] if i < reps * k else tail[i - reps * k]
            want = [(tuple(leaf.shape[1:] if i < reps * k else leaf.shape), np.dtype(leaf.dtype).name)
                    for leaf in jax.tree.leaves(ref_layer)]
            got = [(tuple(t.shape), _DTYPE_NAMES[t.dtype]) for t in jax.tree.leaves(layer)]
            assert got == want, (arch, i)


def test_init_model_draws_from_the_generator():
    cfg = PC.get_config("recurrentgemma-2b").reduced()
    make = lambda seed: PM.init_model(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")  # noqa: E731
    a, b, c = make(7), make(7), make(8)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.embed, c.embed)
    assert abs(float(a.embed.float().std()) - 0.02) < 2e-3
    lam = a.layers[0].rec.lam
    assert lam.dtype == torch.float32 and float(lam.min()) >= 2.0 and float(lam.max()) <= 4.0
    assert float(a.final_norm.abs().max()) == 0.0          # gemma's (1 + w) convention
    assert a.embed.dtype == torch.bfloat16 and not a.embed.requires_grad


def test_entry_points_default_to_cuda():
    """No quiet CPU fallback: without a card the default device is an error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.init_model(PC.get_config("gemma2-9b").reduced(), generator=None)


# -------------------------------------------------------------- serve steps


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2-vl-7b", "whisper-small"])
def test_serve_steps_match_reference(arch):
    """``build_prefill_step`` / ``build_decode_step`` against the
    reference's jitted steps (``mesh=None``) on ``make_batch`` inputs,
    numpy arrays passed straight in; two greedy decode steps."""
    rcfg, pcfg = _cfgs(arch)
    rshape = RC.ShapeConfig("serve", seq_len=CAP, global_batch=B, kind="prefill")
    pshape = PC.ShapeConfig("serve", seq_len=CAP, global_batch=B, kind="prefill")
    batch = RD.make_batch(rcfg, RC.ShapeConfig("p", S, B, "prefill"), 0, seed=2026)
    batch.pop("labels")
    params = RM.init_model(rcfg, KEY, max_positions=64)
    model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu")
    r_logits, r_caches = RS.build_prefill_step(rcfg, rshape)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    p_logits, p_caches = PS.build_prefill_step(pcfg, pshape)(model, batch)
    assert p_logits.is_inference()
    _hold(p_logits, r_logits)
    _hold_caches(convert.caches_to_numpy(pcfg, p_caches), jax.tree.map(np.asarray, r_caches))
    r_decode, p_decode = RS.build_decode_step(rcfg, rshape), PS.build_decode_step(pcfg, pshape)
    token = np.asarray(np.argmax(_f32(r_logits), axis=-1), np.int32)
    for i in range(2):
        pos = np.full((B,), S + i, np.int32)
        r_logits, r_caches = r_decode(params, jnp.asarray(token), jnp.asarray(pos), r_caches)
        p_logits, p_caches = p_decode(model, token, pos, p_caches)
        _hold(p_logits, r_logits)
        token = np.asarray(np.argmax(_f32(r_logits), axis=-1), np.int32)
    _hold_caches(convert.caches_to_numpy(pcfg, p_caches), jax.tree.map(np.asarray, r_caches))


def test_a_mesh_is_refused():
    """Both serve steps accept a ``DeviceMesh``: on a gloo world of one
    (started in this process) the mesh arms' prefill and two decode steps
    equal ``mesh=None`` bit for bit.  Anything else as a mesh is a
    ``TypeError``; ``constrain`` stays the identity.  The gloo world of 4
    is ``tests/test_torch_lm_serve_mesh.py``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _, cfg = _cfgs("gemma2-9b")
    shape = PC.ShapeConfig("serve", seq_len=CAP, global_batch=B, kind="prefill")
    for build in (PS.build_prefill_step, PS.build_decode_step):
        with pytest.raises(TypeError, match="DeviceMesh"):
            build(cfg, shape, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        with sharding_ctx.activation_sharding_scope(object()):
            pass
    with sharding_ctx.activation_sharding_scope(None):
        x = torch.ones(2, 3)
        assert sharding_ctx.constrain(x, ("batch", "embed")) is x
        assert sharding_ctx.current_mesh() is None

    batch = make_batch(cfg, PC.ShapeConfig("p", S, B, "prefill"), 0, seed=2026)
    batch.pop("labels")
    model = PM.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        runs = []
        for m in (None, mesh):
            logits, caches = PS.build_prefill_step(cfg, shape, mesh=m)(model, batch)
            out = [logits]
            decode = PS.build_decode_step(cfg, shape, mesh=m)
            for i in range(2):
                logits, caches = decode(model, np.full((B,), 7 + i, np.int32),
                                        np.full((B,), S + i, np.int32), caches)
                out.append(logits)
            runs.append(out + jax.tree.leaves(convert.caches_to_numpy(cfg, caches)))
    finally:
        dist.destroy_process_group()
    for a, b in zip(*runs):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------- convert


@pytest.mark.parametrize("arch,kv", [("gemma2-9b", "int8"), ("recurrentgemma-2b", "bfloat16"),
                                     ("rwkv6-3b", "bfloat16")])
def test_caches_round_trip_bitwise(arch, kv):
    """The reference's bfloat16 and int8 caches, carried into the port and
    back, equal themselves bit for bit (bfloat16 widened to float32)."""
    rcfg, pcfg = _cfgs(arch, "bfloat16", kv_cache_dtype=kv)
    params = RT.init_params(rcfg, KEY)
    tokens = np.random.default_rng(1).integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    _, caches = RT.prefill(rcfg, params, jnp.asarray(tokens), jnp.asarray(pos), cache_capacity=CAP)
    caches = jax.tree.map(np.asarray, caches)
    back = convert.caches_to_numpy(pcfg, convert.caches_from_jax(pcfg, caches, device="cpu"))
    want, got = jax.tree.leaves(caches), jax.tree.leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, _f32(w))
        assert g.dtype == _f32(w).dtype


def test_params_from_jax_checks_every_leaf():
    rcfg, pcfg = _cfgs("recurrentgemma-2b")     # (rec, rec, local) + a 2-layer tail
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, KEY))
    model = convert.params_from_jax(pcfg, tree, device="cpu")
    np.testing.assert_array_equal(model.layers[2].attn.wq.numpy(), tree["pattern"][2]["attn"]["wq"][0])
    np.testing.assert_array_equal(model.layers[4].rec.lam.numpy(), tree["tail"][1]["rec"]["lam"])
    short = dict(tree)
    short.pop("final_norm")
    with pytest.raises(ValueError, match="copied"):
        convert.params_from_jax(pcfg, short, device="cpu")
    bad = dict(tree, embed=tree["embed"][:10])
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(pcfg, bad, device="cpu")
    b16 = jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16)
    t = convert.to_torch(np.asarray(b16), "cpu")
    assert t.dtype == torch.bfloat16 and t.view(torch.int16).tolist() == np.asarray(b16).view(np.int16).tolist()
