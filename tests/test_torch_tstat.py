"""The port's t-statistic and screen kernels (their plain versions, on the
CPU) against the reference Pallas kernels ``repro.kernels.tstat.tstat`` and
``screen_compact`` run in interpret mode, on the same seeded inputs: t at
atol = rtol = 1e-6, survivor indices and counts exactly equal (overflow of
the fixed capacity included).  The CUDA kernels run only on a card: the
``gpu`` tests hold them against the plain versions there and skip here."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.kernels import tstat as ref_tstat  # noqa: E402
from repro_torch.kernels import tstat as ts  # noqa: E402

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)

DOF = 100.0
T2_SCREEN = 9.0
SHAPES = [((64, 64), 64, 64), ((37, 53), 32, 32)]


def _r(shape, seed):
    """Correlations spanning the epilogue's range: the clip edges, exact
    zeros, and lanes on both sides of the screen.  Lanes whose t^2 falls
    within 1e-4 (relative) of the screen are moved to 0: each package
    rounds its rsqrt its own way, and such a lane could fall on either side
    of the compare."""
    rng = np.random.default_rng(seed)
    r = rng.normal(scale=0.3, size=shape).astype(np.float32)
    flat = r.reshape(-1)
    flat[:6] = [1.0, -1.0, 1.5, -2.0, 0.0, 0.999999]
    r64 = np.clip(r.astype(np.float64), -1, 1)
    t2 = r64 * r64 * DOF / np.maximum(1 - r64 * r64, 1e-12)
    r[np.abs(t2 / T2_SCREEN - 1) < 1e-4] = 0.0
    return r


@pytest.mark.parametrize("shape,bm,bp", SHAPES)
def test_tstat_matches_reference_kernel(shape, bm, bp):
    r = _r(shape, seed=sum(shape))
    want = np.asarray(ref_tstat.tstat(r, DOF, block_m=bm, block_p=bp, interpret=True))
    before = ts.tstat_launches
    got = ts.tstat(torch.from_numpy(r), DOF, block_m=bm, block_p=bp)
    assert ts.tstat_launches == before          # the CPU runs the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.all(np.isfinite(got.numpy()))


@pytest.mark.parametrize("capacity", [4096, 64, 5])
@pytest.mark.parametrize("shape,bm,bp", SHAPES)
def test_screen_compact_matches_reference_kernel(shape, bm, bp, capacity):
    r = _r(shape, seed=sum(shape) + 1)
    t_want, idx_want, count_want = (
        np.asarray(a) for a in ref_tstat.screen_compact(
            r, DOF, T2_SCREEN, capacity, block_m=bm, block_p=bp, interpret=True)
    )
    before = ts.screen_launches
    t, idx, count = ts.screen_compact(torch.from_numpy(r), DOF, T2_SCREEN, capacity,
                                      block_m=bm, block_p=bp)
    assert ts.screen_launches == before
    np.testing.assert_allclose(t.numpy(), t_want, rtol=1e-6, atol=1e-6)
    assert idx.dtype == torch.int32 and count.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), idx_want)
    assert int(count) == int(count_want)
    if capacity == 5:   # overflow: the first 5 survivors in row-major order
        assert int(count) > capacity and np.all(idx.numpy() >= 0)


@pytest.mark.parametrize("shape,bm,bp", SHAPES)
def test_screen_t_is_the_tstat_t_bitwise(shape, bm, bp):
    """The sparse epilogue's t tile equals the dense fused path's, bit for
    bit: both come from one formula."""
    r = torch.from_numpy(_r(shape, seed=3))
    t_dense = ts.tstat(r, DOF, block_m=bm, block_p=bp)
    t_sparse, idx, count = ts.screen_compact(r, DOF, T2_SCREEN, 4096, block_m=bm, block_p=bp)
    assert torch.equal(t_dense, t_sparse)
    # and the screen is the host's plain float32 compare on that t
    host = np.nonzero(np.square(t_dense.numpy().ravel()) >= np.float32(T2_SCREEN))[0]
    assert int(count) == host.size
    np.testing.assert_array_equal(idx.numpy()[: host.size], host)


def test_plain_versions_use_the_kernel_formula():
    """``r * rsqrt(denom / dof)``: within an ulp or two of the float64 value,
    masked lanes (r = 0) give t = 0 exactly."""
    r = torch.tensor([[0.0, 0.5, -0.25, 1.0]])
    t = ts.tstat_plain(r, DOF).numpy().astype(np.float64)
    r64 = r.numpy().astype(np.float64)
    want = r64 * np.sqrt(DOF / np.maximum(1 - r64 * r64, 1e-12))
    np.testing.assert_allclose(t, want, rtol=1e-6)
    assert t[0, 0] == 0.0


@pytest.mark.parametrize("bad", ["dtype", "rank", "device", "block", "t2_screen"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    r = torch.zeros((4, 4))
    kw = {}
    if bad == "dtype":
        r = r.to(torch.float64)
    elif bad == "rank":
        r = r.reshape(-1)
    elif bad == "device":
        r = r.to("meta")
    elif bad == "block":
        kw = dict(block_m=0)
    with pytest.raises(ValueError):
        if bad == "t2_screen":
            ts.screen_compact(r, DOF, 0.0, 64)
        else:
            ts.tstat(r, DOF, **kw)
    with pytest.raises(ValueError):
        ts.screen_compact(r, DOF, -1.0 if bad == "t2_screen" else T2_SCREEN, 64, **kw)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 1024), (1000, 300)])
def test_cuda_tstat_kernel_matches_plain_version(shape):
    dev = _cuda()
    r = torch.from_numpy(_r(shape, seed=11)).to(dev)
    before = ts.tstat_launches
    t = ts.tstat(r, 22985.0)
    torch.cuda.synchronize()
    assert ts.tstat_launches == before + 1
    t0 = ts.tstat_plain(r, 22985.0)
    np.testing.assert_allclose(t.cpu().numpy(), t0.cpu().numpy(), rtol=2e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 1024), (1000, 300)])
def test_cuda_screen_kernel_matches_plain_version(shape):
    dev = _cuda()
    r = torch.from_numpy(_r(shape, seed=12)).to(dev)
    before = ts.screen_launches
    t, idx, count = ts.screen_compact(r, DOF, T2_SCREEN, 4096)
    torch.cuda.synchronize()
    assert ts.screen_launches == before + 1
    t0, idx0, count0 = ts.screen_compact_plain(r, DOF, T2_SCREEN, 4096)
    np.testing.assert_allclose(t.cpu().numpy(), t0.cpu().numpy(), rtol=2e-6, atol=0)
    assert torch.equal(t, ts.tstat(r, DOF))
    np.testing.assert_array_equal(idx.cpu().numpy(), idx0.cpu().numpy())
    assert int(count) == int(count0) > 4096
