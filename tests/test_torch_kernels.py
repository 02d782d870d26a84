"""The port's gwas_dot (its plain version, on the CPU) against the reference
Pallas kernel run in interpret mode, at the reference's own tolerances
(tests/test_kernels.py): fp32 r 2e-6 / t 2e-4, bf16 r 5e-3.  The CUDA kernel
itself runs only on a card: the ``gpu`` tests below hold it against the plain
version there and skip elsewhere.  An emulation of the kernel's arithmetic
(its sample order, 3xTF32 or bf16 products, chunked accumulation) and the
plain version of its prologue (the trait operand) against numpy run here."""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels.gwas_dot import ops as ref_ops  # noqa: E402
from repro_torch.kernels.gwas_dot import gwas_dot as gd  # noqa: E402
from repro_torch.kernels.gwas_dot import ops, ref  # noqa: E402

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)


def _mk(m, n, seed=0, missing=0.02):
    rng = np.random.default_rng(seed)
    codes = rng.choice(
        [0, 1, 2, 3], p=[0.3, missing, 0.4 - missing, 0.3], size=(m, n)
    ).astype(np.uint8)
    return codes, rng


@pytest.mark.parametrize(
    "m,n,p,bm,bn,bp",
    [
        (64, 256, 32, 32, 128, 16),     # aligned
        (70, 1000, 40, 32, 128, 16),    # all dims ragged
        (8, 128, 8, 8, 128, 8),         # single tile
        (33, 131, 17, 16, 64, 16),      # prime-ish everything
        (300, 1003, 300, 256, 512, 256),  # N % 4 != 0, M and P not multiples of 256
    ],
)
def test_gwas_dot_matches_reference_kernel(m, n, p, bm, bn, bp):
    codes, rng = _mk(m, n, seed=m + n)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    y = rng.normal(size=(n, p)).astype(np.float32)
    packed = ops.pack_tiled(codes, bn)
    r_ref, t_ref = ref_ops.gwas_dot(
        packed, mean, inv_std, y, n_samples=n, dof=n - 2,
        block_m=bm, block_n=bn, block_p=bp, interpret=True,
    )
    r, t = ops.gwas_dot(packed, mean, inv_std, y, n_samples=n, dof=n - 2,
                        block_n=bn, block_p=bp)
    assert r.shape == (m, p) and t.shape == (m, p)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=2e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=2e-4)


@pytest.mark.parametrize("dtype,atol", [("fp32", 2e-6), ("bf16", 5e-3)])
def test_gwas_dot_dtype_matches_reference(dtype, atol):
    codes, rng = _mk(48, 512, seed=3)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    y = rng.normal(size=(512, 24)).astype(np.float32)
    packed = ops.pack_tiled(codes, 128)
    r_ref, _ = ref_ops.gwas_dot(
        packed, mean, inv_std, y, n_samples=512, dof=510, block_m=16, block_n=128,
        block_p=8, input_dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32,
        interpret=True,
    )
    r, _ = ops.gwas_dot(packed, mean, inv_std, y, n_samples=512, dof=510,
                        block_n=128, block_p=8, input_dtype=dtype)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=atol)


def test_gwas_dot_all_missing_and_monomorphic():
    codes = np.zeros((8, 128), np.uint8)
    codes[0, :] = 1          # all missing
    codes[1, :] = 3          # monomorphic (all dosage 0)
    codes[2, ::2] = 2        # polymorphic het pattern
    mean, inv_std, valid = ops.marker_stats_from_codes(codes)
    assert not valid[0] and not valid[1] and valid[2]
    y = np.random.default_rng(0).normal(size=(128, 8)).astype(np.float32)
    packed = ops.pack_tiled(codes, 128)
    r, t = ops.gwas_dot(packed, mean, inv_std, y, n_samples=128, dof=126,
                        block_n=128, block_p=8)
    r_ref, t_ref = ref_ops.gwas_dot(packed, mean, inv_std, y, n_samples=128, dof=126,
                                    block_m=8, block_n=128, block_p=8, interpret=True)
    assert np.all(r.numpy()[:2] == 0.0) and np.all(t.numpy()[:2] == 0.0)
    assert np.all(np.isfinite(t.numpy()))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=2e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=2e-4)


def test_plain_version_matches_reference_oracle():
    """``ref.gwas_dot_ref`` on codes against the reference's pure-jnp oracle."""
    from repro.kernels.gwas_dot import ref as jref

    codes, rng = _mk(40, 300, seed=5)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    y = rng.normal(size=(300, 12)).astype(np.float32)
    r_o, t_o = jref.gwas_dot_ref(jnp.asarray(codes.astype(np.int32)), jnp.asarray(mean),
                                 jnp.asarray(inv_std), jnp.asarray(y), n_samples=300, dof=298)
    r, t = ref.gwas_dot_ref(torch.from_numpy(codes.astype(np.int32)), torch.from_numpy(mean),
                            torch.from_numpy(inv_std), torch.from_numpy(y),
                            n_samples=300, dof=298)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_o), atol=2e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_o), atol=2e-4)


def test_trait_chunks_make_blocking_bitwise():
    """Any split of the trait axis into multiples of block_p computes the
    identical columns — the blocked == unblocked contract."""
    codes, rng = _mk(50, 700, seed=9)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    y = rng.normal(size=(700, 100)).astype(np.float32)
    packed = ops.pack_tiled(codes, 128)
    kw = dict(n_samples=700, dof=698, block_n=128, block_p=32)
    r_full, t_full = ops.gwas_dot(packed, mean, inv_std, y, **kw)
    for lo, hi in ((0, 64), (64, 100)):
        r_b, t_b = ops.gwas_dot(packed, mean, inv_std, y[:, lo:hi], **kw)
        np.testing.assert_array_equal(r_b.numpy(), r_full.numpy()[:, lo:hi])
        np.testing.assert_array_equal(t_b.numpy(), t_full.numpy()[:, lo:hi])


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    codes, rng = _mk(10, 64, seed=1)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    y = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    before = gd.launches
    gd.gwas_dot_fused(torch.from_numpy(ops.pack_tiled(codes, 64)), torch.from_numpy(mean),
                      torch.from_numpy(inv_std), y, n_samples=64, dof=62, block_n=64)
    assert gd.launches == before   # only kernel launches count


@pytest.mark.parametrize("bad", ["dtype", "width", "stats", "rows", "input_dtype", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    codes, rng = _mk(10, 64, seed=1)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    args = dict(
        packed=torch.from_numpy(ops.pack_tiled(codes, 64)),
        mean=torch.from_numpy(mean),
        inv_std=torch.from_numpy(inv_std),
        y=torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)),
    )
    kw = dict(n_samples=64, dof=62, block_n=64)
    if bad == "dtype":
        args["packed"] = args["packed"].to(torch.int32)
    elif bad == "width":
        kw["block_n"] = 128          # 16 bytes per row is not a whole 128-sample tile
    elif bad == "stats":
        args["mean"] = args["mean"][:5]
    elif bad == "rows":
        args["y"] = torch.zeros((65, 3))
    elif bad == "input_dtype":
        kw["input_dtype"] = "fp16"
    elif bad == "device":
        args = {k: v.to("meta") for k, v in args.items()}
    with pytest.raises(ValueError):
        gd.gwas_dot_fused(*args.values(), **kw)


# (M, N, P, block_n) on the card: a ragged shape, then the kernel loop's
# edges: P=301 (y rows not 16-byte aligned), block_n 64 and 36 (the per-code
# decode; with 36 the last step and chunk are partial), M and P under one
# tile.  Each has an all-missing last row.
GPU_SHAPES = [(300, 1003, 300, 512), (300, 1003, 301, 512), (200, 700, 64, 64),
              (130, 460, 40, 36), (5, 77, 3, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m,n,p,bn", GPU_SHAPES)
def test_cuda_kernel_matches_plain_version(m, n, p, bn, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    codes, rng = _mk(m, n, seed=m + n + p)
    codes[-1] = 1                              # an all-missing row
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    y = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32)).to(dev)
    packed = torch.from_numpy(ops.pack_tiled(codes, bn)).to(dev)
    mean_d, inv_d = torch.from_numpy(mean).to(dev), torch.from_numpy(inv_std).to(dev)
    before = gd.launches
    r, t = gd.gwas_dot_fused(packed, mean_d, inv_d, y, n_samples=n, dof=n - 2,
                             block_n=bn, input_dtype=dtype)
    torch.cuda.synchronize()
    assert gd.launches == before + 1
    y_pad = torch.cat([y, y.new_zeros((packed.shape[1] * 4 - n, p))])
    r0, t0 = ref.gwas_dot_ref(ref.unpack_tiled(packed, bn), mean_d, inv_d, y_pad,
                              n_samples=n, dof=n - 2, input_dtype=dtype)
    assert bool((r[-1] == 0).all() and (t[-1] == 0).all())
    atol = 2e-6 if dtype == "fp32" else 5e-3
    np.testing.assert_allclose(r.cpu().numpy(), r0.cpu().numpy(), atol=atol)
    if dtype == "fp32":
        np.testing.assert_allclose(t.cpu().numpy(), t0.cpu().numpy(), atol=2e-4)


# --------------------------------------------------------------------------
# The CUDA kernel's arithmetic, emulated (csrc/gwas_dot.cu).  The kernel
# walks each row's packed bytes in order, a stage of SK/4 bytes at a time
# (SK = 64 samples bf16, 32 fp32), each byte at its four 2-bit slots:
# wgmma's A fragment gives thread t of four, per k-slice j, the slice's
# columns {2t, 2t+1, 2t+8, 2t+9} (bf16, k = 16) or {t, t+4} (tf32, k = 8),
# and element e of those is slot j of the thread's byte e (its bytes: SK/16
# from SK/16 * t).  fp32: operands split as hi = tf32_rna(x), lo =
# tf32_rna(x - hi); per k8 slice one wgmma per pass, in the order lo*hi,
# hi*lo, hi*hi; bf16: one k16 wgmma per slice, products exact.  Each wgmma
# is modelled as the exact sum of its products and the accumulator, rounded
# once to fp32; the accumulator restarts every KC samples of that order and
# is added into an fp32 total (round to nearest).

KC_FP32 = 32    # the kernel's fp32 chunk: one 32-sample stage
KC_BF16 = 256   # the kernel's bf16 chunk: four 64-sample stages


def _sample_order(n_pad: int, block_n: int, dtype: str) -> np.ndarray:
    """The sample each column of the kernel's sample axis stands for (-1:
    none), spelled from the fragment layout and the tile-local packing."""
    if dtype == "bf16":   # 64-sample stages, k16 slices
        sk, k, cols = 64, 16, lambda t: [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
    else:                 # 32-sample stages, k8 slices
        sk, k, cols = 32, 8, lambda t: [t, t + 4]
    per_stage, per_thread = sk // 4, sk // 16      # bytes
    stride, q = n_pad // 4, block_n // 4
    n_cols = -(-n_pad // 64) * 64
    out = np.full(n_cols, -1, np.int64)
    for s0 in range(0, n_cols, sk):
        for t in range(4):
            for j in range(sk // k):
                for e, c in enumerate(cols(t)):
                    byte = (s0 // sk) * per_stage + per_thread * t + e
                    if byte < stride:
                        out[s0 + k * j + c] = (byte // q) * block_n + j * q + byte % q
    return out


@pytest.mark.parametrize("n_pad,block_n", [(1024, 512), (23040, 512), (704, 64), (468, 36)])
def test_sample_order_matches_fragment_layout(n_pad, block_n):
    for dtype in ("bf16", "fp32"):
        order = _sample_order(n_pad, block_n, dtype)
        assert sorted(order[order >= 0].tolist()) == list(range(n_pad))
        np.testing.assert_array_equal(ref.sample_order(n_pad, block_n, dtype).numpy(), order)


def _logical_order(x: torch.Tensor, dtype: str, axis: int, block_n: int) -> torch.Tensor:
    """``x`` with its sample axis in the kernel's order (zeros for columns
    that stand for no sample)."""
    order = _sample_order(x.shape[axis], block_n, dtype)
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - axis) + 1] = 1          # one zero slice at the end
    x = torch.nn.functional.pad(x, pad)
    return x.index_select(axis, torch.from_numpy(np.where(order >= 0, order, x.shape[axis] - 1)))


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: add 0x1000 to the magnitude bits and clear the
    low 13 (round to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    out = (bits & 0x80000000) | (((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000)
    out = torch.where(out >= 2**31, out - 2**32, out)
    return out.to(torch.int32).view(torch.float32)


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    f = x.to(torch.float32)
    over = f.to(torch.float64).abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _emulate_kernel(g, y, *, dtype, rounding, chunk, block_n):
    """Emulated kernel sum ``g @ y`` ((M, N_pad) x (N_pad, P) float32 in the
    packing's sample order); ``chunk=None`` keeps one accumulator over all
    samples."""
    rnd = (lambda v: v.to(torch.float32)) if rounding == "nearest" else _round_toward_zero
    m = g.shape[0]
    p = y.shape[1]
    g = _logical_order(g, dtype, 1, block_n)
    y = _logical_order(y, dtype, 0, block_n)
    k = 8 if dtype == "fp32" else 16

    def slices(a, b):   # exact per-slice sums, (N/k, M, P) float64
        return torch.einsum("mkj,kjp->kmp", a.double().reshape(m, -1, k),
                            b.double().reshape(-1, k, p))

    if dtype == "fp32":
        gh, yh = _tf32_rna(g), _tf32_rna(y)
        gl, yl = _tf32_rna(g - gh), _tf32_rna(y - yh)
        passes = (slices(gl, yh), slices(gh, yl), slices(gh, yh))
    else:
        passes = (slices(g.to(torch.bfloat16).float(), y.to(torch.bfloat16).float()),)
    acc = torch.zeros((m, p), dtype=torch.float32)
    total = torch.zeros((m, p), dtype=torch.float32)
    for s in range(g.shape[1] // k):
        for part in passes:
            acc = rnd(acc.double() + part[s])
        if chunk is not None and (s + 1) * k % chunk == 0:
            total, acc = total + acc, torch.zeros_like(acc)
    return total + acc


def _emulation_inputs():
    """32 markers x 32 traits at N = 23,000 (padded to 23,040), trait j
    carrying marker j at r ~ c_j, up to 0.9."""
    m = p = 32
    n, bn = 23000, 512
    codes, rng = _mk(m, n, seed=14)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    g = ref.decode_standardize_ref(torch.from_numpy(codes.astype(np.int32)),
                                   torch.from_numpy(mean), torch.from_numpy(inv_std))
    c = np.linspace(0.0, 0.9, p)[None, :]
    y = (np.sqrt(1 - c**2) * rng.normal(size=(n, p)) + c * g.numpy().T).astype(np.float32)
    packed = ops.pack_tiled(codes, bn)
    n_pad = packed.shape[1] * 4
    g_pad = torch.nn.functional.pad(g, (0, n_pad - n))
    y_pad = torch.nn.functional.pad(torch.from_numpy(y), (0, 0, 0, n_pad - n))
    return codes, packed, mean, inv_std, y, g_pad, y_pad, n, bn


@pytest.mark.parametrize("rounding,chunk,holds", [
    ("nearest", KC_FP32, True),
    ("toward_zero", KC_FP32, True),
    # the chunk of the mma.sync kernel before it (64 samples) held too
    ("toward_zero", 64, True),
    # truncating adds into one accumulator over 23,000 samples drift far
    # past the tolerance: why the kernel restarts it every KC samples
    ("toward_zero", None, False),
])
def test_kernel_fp32_arithmetic_holds_reference(rounding, chunk, holds):
    codes, packed, mean, inv_std, y, g_pad, y_pad, n, bn = _emulation_inputs()
    m, p = codes.shape[0], y.shape[1]
    r_ref, t_ref = ref_ops.gwas_dot(packed, mean, inv_std, y, n_samples=n, dof=n - 2,
                                    block_m=m, block_n=bn, block_p=p, interpret=True)
    acc = _emulate_kernel(g_pad, y_pad, dtype="fp32", rounding=rounding, chunk=chunk,
                          block_n=bn)
    r = torch.clamp(acc / float(n), -1.0, 1.0)
    t = r * torch.rsqrt(torch.clamp(1.0 - r * r, min=1e-12) / float(n - 2))
    assert float(np.abs(np.asarray(r_ref)).max()) > 0.85
    r_err = float(np.abs(r.numpy() - np.asarray(r_ref)).max())
    t_err = float(np.abs(t.numpy() - np.asarray(t_ref)).max())
    if holds:
        # t: 2e-4, plus the r tolerance carried through dt/dr =
        # sqrt(dof) / (1 - r^2)^1.5 (~1,800 at r = 0.9, where one ulp of r
        # moves t by 1.1e-4), as chip_smoke.py holds the kernel on the card
        r_ref = torch.from_numpy(np.array(r_ref))
        slope = np.sqrt(n - 2) / torch.clamp(1 - r_ref * r_ref, min=1e-6) ** 1.5
        t_excess = (t - torch.from_numpy(np.array(t_ref))).abs() - (2e-4 + 2e-6 * slope)
        assert r_err <= 2e-6 and float(t_excess.max()) <= 0.0, (r_err, t_err)
    else:
        assert r_err > 2e-6, r_err


@pytest.mark.parametrize("chunk,holds", [
    (KC_BF16, True),
    (64, True),
    # one truncating accumulator over 23,000 samples leaves r 2e-6 (though
    # not the bf16 mode's own 5e-3)
    (None, False),
])
def test_kernel_bf16_arithmetic_holds_plain_version(chunk, holds):
    """The bf16 mode's chunk: with truncating adds, r within 2e-6 of the
    plain version (bf16 operands, the sum rounded once)."""
    codes, packed, mean, inv_std, y, g_pad, y_pad, n, bn = _emulation_inputs()
    r0, _ = ref.gwas_dot_ref(torch.from_numpy(codes.astype(np.int32)), torch.from_numpy(mean),
                             torch.from_numpy(inv_std), torch.from_numpy(y), n_samples=n,
                             dof=n - 2, input_dtype="bf16")
    acc = _emulate_kernel(g_pad, y_pad, dtype="bf16", rounding="toward_zero", chunk=chunk,
                          block_n=bn)
    r = torch.clamp(acc / float(n), -1.0, 1.0)
    assert float(r0.abs().max()) > 0.85
    r_err = float((r - r0).abs().max())
    assert r_err <= 5e-3, r_err
    assert (r_err <= 2e-6) == holds, r_err


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 (round to nearest even), returned as float32."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return rounded.astype(np.uint32).view(np.float32)


def _tf32_rna_np(x: np.ndarray) -> np.ndarray:
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("n_rows,n_pad,p,block_n", [
    (1003, 1024, 301, 512),   # P not a multiple of the 128-trait tile, rows past y
    (460, 468, 40, 36),       # N_pad not a multiple of the stage or of 64
    (64, 64, 128, 64),        # whole tiles
    (77, 512, 3, 512),
])
def test_trait_operand_plain_version_matches_numpy(dtype, n_rows, n_pad, p, block_n):
    """The kernel prologue's plain version: y transposed to samples-contiguous
    rows of 128-trait tiles, samples padded to 64, in the kernel's sample
    order, zero past y's rows and P; bf16 rounded to nearest even, or fp32
    split into tf32 hi and lo planes."""
    y = np.random.default_rng(n_rows + p).normal(size=(n_rows, p)).astype(np.float32)
    got = ref.trait_operand_ref(torch.from_numpy(y), n_pad, dtype, block_n)
    p_pad, k_pad = -(-p // 128) * 128, -(-n_pad // 64) * 64
    order = _sample_order(n_pad, block_n, dtype)
    yt = np.zeros((p_pad, k_pad), np.float32)
    for k, n in enumerate(order):
        if 0 <= n < n_rows:
            yt[:p, k] = y[n]
    if dtype == "bf16":
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (p_pad, k_pad)
        want = _bf16_rne(yt)
        np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))
    else:
        assert got.dtype == torch.float32 and tuple(got.shape) == (2 * p_pad, k_pad)
        hi = _tf32_rna_np(yt)
        lo = _tf32_rna_np((yt - hi).astype(np.float32))
        np.testing.assert_array_equal(got.numpy()[:p_pad].view(np.uint32), hi.view(np.uint32))
        np.testing.assert_array_equal(got.numpy()[p_pad:].view(np.uint32), lo.view(np.uint32))
        np.testing.assert_allclose(got.numpy()[:p_pad].astype(np.float64) + got.numpy()[p_pad:],
                                   yt, rtol=2.0**-21, atol=0)
    # what stands for no row of y, and what lies past P, is zero
    assert not got.float().numpy()[p:p_pad].any() and not got.float().numpy()[p_pad + p:].any()
    assert not got.float().numpy()[:, (order < 0) | (order >= n_rows)].any()


def test_tf32_split_is_exact_to_22_bits():
    """hi + lo carries x to within 2^-22 relative; hi and lo are tf32."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    hi = _tf32_rna(x)
    lo = _tf32_rna(x - hi)
    for v in (hi, lo):
        assert not bool((v.view(torch.int32) & 0x1FFF).any())
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0**-22
    # ties go away from zero: 1 + 2^-11 lies halfway between two tf32 values
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)], dtype=torch.float32)
    assert _tf32_rna(tie).tolist() == [1 + 2.0**-10, -(1 + 2.0**-10)]
