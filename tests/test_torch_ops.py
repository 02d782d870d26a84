"""Bitwise equality of the port's byte and integer helpers with the reference:
tile packing, the device-side PLINK repack and decode fronts, and the packed
marker stats (ragged N included)."""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.io.plink import pack_dosages  # noqa: E402
from repro.kernels.gwas_dot import ops as ref_ops  # noqa: E402
from repro_torch.kernels.gwas_dot import ops, ref  # noqa: E402

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)


def _codes(m, n, seed=0, missing=0.05):
    rng = np.random.default_rng(seed)
    codes = rng.choice(
        [0, 1, 2, 3], p=[0.3, missing, 0.4 - missing, 0.3], size=(m, n)
    ).astype(np.uint8)
    codes[0, :] = 1          # all missing
    if m > 1:
        codes[1, :] = 3      # monomorphic
    return codes


def _plink_bytes(codes):
    c32 = codes.astype(np.int32)
    dosage = np.where(c32 == 1, -9, 2 - c32 + (c32 >> 1)).astype(np.int8)
    return pack_dosages(dosage)


SHAPES = [(20, 333, 128), (64, 512, 512), (7, 1003, 256), (33, 131, 64), (5, 4, 4)]


@pytest.mark.parametrize("m,n,bn", SHAPES)
def test_pack_tiled_bitwise(m, n, bn):
    codes = _codes(m, n, seed=m + n)
    np.testing.assert_array_equal(ops.pack_tiled(codes, bn), ref_ops.pack_tiled(codes, bn))
    plink = _plink_bytes(codes)
    np.testing.assert_array_equal(
        ops.unpack_plink_to_codes(plink, n), ref_ops.unpack_plink_to_codes(plink, n)
    )
    np.testing.assert_array_equal(
        ops.repack_plink_tiled(plink, n, bn), ref_ops.repack_plink_tiled(plink, n, bn)
    )


@pytest.mark.parametrize("m,n,bn", SHAPES)
def test_unpack_tiled_inverts_pack_tiled(m, n, bn):
    codes = _codes(m, n, seed=3)
    packed = torch.from_numpy(ops.pack_tiled(codes, bn))
    out = ref.unpack_tiled(packed, bn).numpy()
    n_pad = packed.shape[1] * 4
    np.testing.assert_array_equal(out[:, :n], codes)
    assert np.all(out[:, n:n_pad] == 1)   # sample padding carries the missing code


@pytest.mark.parametrize("m,n,bn,bm", [(20, 333, 128, 16), (64, 512, 512, 256),
                                        (7, 1003, 256, 8), (300, 37, 64, 256)])
def test_repack_plink_tiled_device_bitwise(m, n, bn, bm):
    plink = _plink_bytes(_codes(m, n, seed=m))
    want = np.asarray(ref_ops.repack_plink_tiled_device(
        jnp.asarray(plink), n_samples=n, block_n=bn, block_m=bm))
    got = ops.repack_plink_tiled_device(
        torch.from_numpy(plink), n_samples=n, block_n=bn, block_m=bm)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n", [(20, 333), (64, 512), (7, 1003), (3, 5)])
def test_decode_packed_device_bitwise(m, n):
    plink = _plink_bytes(_codes(m, n, seed=n))
    want = np.asarray(ref_ops.decode_packed_device(jnp.asarray(plink), n_samples=n))
    got = ops.decode_packed_device(torch.from_numpy(plink), n_samples=n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 331, 333, 1002, 1003])
def test_marker_stats_from_packed_bitwise_ragged(n):
    codes = _codes(17, n, seed=n)
    plink = _plink_bytes(codes)
    got = ops.marker_stats_from_packed(plink, n)
    want = ref_ops.marker_stats_from_packed(plink, n)
    from_codes = ops.marker_stats_from_codes(codes)
    for g, w, c in zip(got, want, from_codes):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, c)
