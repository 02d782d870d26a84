"""The port's gwas_dot (its plain version, on the CPU) against the reference
Pallas kernel run in interpret mode, at the reference's own tolerances
(tests/test_kernels.py): fp32 r 2e-6 / t 2e-4, bf16 r 5e-3.  The CUDA kernel
itself runs only on a card: the ``gpu`` test below holds it against the plain
version there and skips elsewhere."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ with no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    codes, rng = _mk(300, 1003, seed=2)
    mean, inv_std, _ = ops.marker_stats_from_codes(codes)
    y = torch.from_numpy(rng.normal(size=(1003, 300)).astype(np.float32)).to(dev)
    packed = torch.from_numpy(ops.pack_tiled(codes, 512)).to(dev)
    mean_d, inv_d = torch.from_numpy(mean).to(dev), torch.from_numpy(inv_std).to(dev)
    before = gd.launches
    r, t = gd.gwas_dot_fused(packed, mean_d, inv_d, y, n_samples=1003, dof=1001,
                             block_n=512, input_dtype=dtype)
    torch.cuda.synchronize()
    assert gd.launches == before + 1
    y_pad = torch.cat([y, y.new_zeros((packed.shape[1] * 4 - 1003, 300))])
    r0, t0 = ref.gwas_dot_ref(ref.unpack_tiled(packed, 512), mean_d, inv_d, y_pad,
                              n_samples=1003, dof=1001, input_dtype=dtype)
    atol = 2e-6 if dtype == "fp32" else 5e-3
    np.testing.assert_allclose(r.cpu().numpy(), r0.cpu().numpy(), atol=atol)
