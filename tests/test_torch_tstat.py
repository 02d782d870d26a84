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


# ------------------------------------------- the compaction kernel's arithmetic
#
# An emulation of csrc/tstat.cu's compact_kernel in torch ops, with its
# layout: tiles of 4,096 elements, 256 threads per tile, each holding four
# chunks of four consecutive elements (element tile * 4096 + k * 1024 +
# 4 * thread + j); per-chunk counts in 16-bit lanes of one 64-bit word, a
# warp scan as __shfl_up_sync does it, a scan over the 8 warp totals; the
# decoupled look-back over epoch-tagged status words, resolved in a random
# order; the scatter with the capacity cut and the last tile's -1 fill.

TILE_THREADS, CHUNKS = 256, 4
CHUNK = TILE_THREADS * 4
TILE = CHUNK * CHUNKS
AGGREGATE, PREFIX = 1, 2
EPOCHS = 2**30 - 1
UNWRITTEN = 2**31 - 1


def _status(epoch, state, count):
    return (epoch << 34) | (state << 32) | count


def _decode(word, epoch):
    """(state, count) of a status word as the current launch reads it."""
    state = (word >> 32) & 3 if (word >> 34) == epoch else 0
    return state, word & 0xFFFFFFFF


def _look_back(agg, epoch, rng):
    """Each tile's exclusive prefix, found as the kernel's warp 0 finds it:
    windows of 32 predecessors (lane 0 the nearest), summed back to the
    nearest inclusive prefix.  Every tile posts before any resolves, and
    the tiles resolve in a random order, so windows meet any mix of
    aggregates and prefixes."""
    n_tiles = len(agg)
    stale = epoch - 1 if epoch > 1 else EPOCHS
    # words an earlier launch left in the workspace: another epoch, not posted
    status = [_status(stale, PREFIX, int(c)) for c in rng.integers(0, 2**31, n_tiles)]
    assert all(_decode(w, epoch)[0] == 0 for w in status)
    status = [_status(epoch, PREFIX if i == 0 else AGGREGATE, a) for i, a in enumerate(agg)]
    prefix = [0] * n_tiles
    for tile in rng.permutation(n_tiles).tolist():
        if tile == 0:
            continue
        total, top = 0, tile - 1
        while True:
            window = [_decode(status[p], epoch) if p >= 0 else (PREFIX, 0)
                      for p in range(top, top - 32, -1)]
            assert all(state != 0 for state, _ in window)
            prefixes = [lane for lane, (state, _) in enumerate(window) if state == PREFIX]
            stop = prefixes[0] if prefixes else 31
            total += sum(c for _, c in window[: stop + 1])
            if prefixes:
                break
            top -= 32
        prefix[tile] = total
        status[tile] = _status(epoch, PREFIX, total + agg[tile])
    return prefix


def _emulate_compact(keep, capacity, *, epoch=7, seed=0):
    """(idx, count) as compact_kernel writes them for the flat bool ``keep``."""
    n = keep.numel()
    n_tiles = max(1, -(-n // TILE))
    k = torch.zeros(n_tiles * TILE, dtype=torch.bool)
    k[:n] = keep
    k = k.reshape(n_tiles, CHUNKS, TILE_THREADS, 4)      # [tile, chunk, thread, j]
    counts = k.sum(-1).to(torch.int64)                   # (tiles, chunk, thread)
    mine = sum(counts[:, c] << (16 * c) for c in range(CHUNKS))
    warps = mine.reshape(n_tiles, TILE_THREADS // 32, 32)
    incl = warps.clone()
    for d in (1, 2, 4, 8, 16):                           # __shfl_up_sync steps
        up = torch.zeros_like(incl)
        up[..., d:] = incl[..., :-d]
        incl = incl + up
    warp_sums = incl[..., 31]
    before = torch.cumsum(warp_sums, 1) - warp_sums
    excl = (before[..., None] + incl - warps).reshape(n_tiles, TILE_THREADS)
    tile_sum = warp_sums.sum(1)
    lanes = torch.stack([(tile_sum >> (16 * c)) & 0xFFFF for c in range(CHUNKS)], 1)
    assert int(lanes.max()) <= CHUNK                     # no carry between lanes
    chunk_base = torch.cumsum(lanes, 1) - lanes
    agg = lanes.sum(1)
    prefix = torch.tensor(_look_back(agg.tolist(), epoch, np.random.default_rng(seed)))
    rank = torch.stack([(excl >> (16 * c)) & 0xFFFF for c in range(CHUNKS)], 1)
    in_thread = torch.cumsum(k.to(torch.int64), -1) - k.to(torch.int64)
    pos = (prefix[:, None, None, None] + chunk_base[:, :, None, None] + rank[..., None]
           + in_thread)
    elem = torch.arange(n_tiles * TILE).reshape(k.shape)
    idx = torch.full((capacity,), UNWRITTEN, dtype=torch.int64)
    scatter = k & (pos < capacity)
    assert torch.unique(pos[scatter]).numel() == int(scatter.sum())   # no slot twice
    idx[pos[scatter]] = elem[scatter]
    total = int(prefix[-1] + agg[-1])
    idx[min(total, capacity):] = -1                      # the last tile's fill
    assert not bool((idx == UNWRITTEN).any())            # every slot written once
    return idx.to(torch.int32), total


def _nonzero_compact(keep, capacity):
    found = np.nonzero(keep.numpy())[0][:capacity]
    idx = np.full(capacity, -1, np.int32)
    idx[: found.size] = found
    return idx, int(keep.sum())


def _hold_emulation(r, capacity, reference=True):
    """The emulation on the port's t against np.nonzero, the plain version
    and (when asked) the reference kernel in interpret mode."""
    t = ts.tstat_plain(torch.from_numpy(r), DOF)
    keep = (t * t).reshape(-1) >= T2_SCREEN
    idx, count = _emulate_compact(keep, capacity, seed=r.size)
    want_idx, want_count = _nonzero_compact(keep, capacity)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert count == want_count
    t_plain, idx_plain, count_plain = ts.screen_compact(torch.from_numpy(r), DOF, T2_SCREEN,
                                                        capacity)
    np.testing.assert_array_equal(idx_plain.numpy(), want_idx)
    assert int(count_plain) == want_count
    if reference:
        _, ref_idx, ref_count = ref_tstat.screen_compact(r, DOF, T2_SCREEN, capacity,
                                                         interpret=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        assert count == int(ref_count)
    return count


@pytest.mark.parametrize("capacity", [5, 64, 4096, "above_n"])
@pytest.mark.parametrize("shape,bm,bp", SHAPES)
def test_compaction_emulation_matches_reference(shape, bm, bp, capacity):
    r = _r(shape, seed=sum(shape) + 2)
    cap = r.size + 64 if capacity == "above_n" else capacity
    count = _hold_emulation(r, cap)
    assert count > 5


def _edge_r(case):
    """Tiles at the compaction's edges: (r, whether the reference runs)."""
    rng = np.random.default_rng(41)
    if case == "none":
        return np.zeros((100, 130), np.float32), True
    if case == "all":
        return np.full((100, 130), 0.9, np.float32), True
    if case == "straddle":          # survivors on both sides of each tile edge
        r = np.zeros((100, 130), np.float32)
        flat = r.reshape(-1)
        for edge in (TILE, 2 * TILE, 3 * TILE):
            flat[edge - 3: edge + 3] = 0.5
        flat[0], flat[-1] = -0.7, 0.7
        return r, True
    if case == "nan":               # NaN never survives
        r = _r((64, 64), seed=5)
        r.reshape(-1)[::7] = np.nan
        return r, True
    if case == "many_tiles":        # 38 tiles: look-back windows past 32 tiles
        r = rng.normal(scale=0.05, size=(512, 300)).astype(np.float32)
        r.reshape(-1)[rng.choice(r.size, 200, replace=False)] = 0.6
        return r, True
    assert case == "empty"
    return np.zeros((0, 8), np.float32), False


@pytest.mark.parametrize("capacity", [5, 4096])
@pytest.mark.parametrize("case", ["none", "all", "straddle", "nan", "many_tiles", "empty"])
def test_compaction_emulation_edges(case, capacity):
    r, reference = _edge_r(case)
    count = _hold_emulation(r, capacity, reference=reference)
    want = {"none": 0, "all": r.size, "straddle": 20, "empty": 0}
    if case in want:
        assert count == want[case]


@pytest.mark.parametrize("n_tiles", [1, 2, 33, 100])
@pytest.mark.parametrize("epoch", [1, 12345, EPOCHS])
def test_look_back_finds_each_exclusive_prefix(n_tiles, epoch):
    """Whatever order the tiles resolve in, and whatever an earlier launch
    left in the workspace, each tile's prefix is the exclusive sum."""
    rng = np.random.default_rng(n_tiles + epoch)
    agg = rng.integers(0, TILE + 1, n_tiles)
    agg[rng.random(n_tiles) < 0.3] = 0
    prefix = _look_back(agg.tolist(), epoch, rng)
    assert prefix == (np.cumsum(agg) - agg).tolist()


def test_compact_survivors_plain_is_the_nonzero_code_it_replaces():
    """The plain t mode equals the sparse epilogue's former inline
    compaction and the reference's, on the same t (overflow included)."""
    from repro.core import association as ref_assoc

    for capacity in (5, 64, 4096):
        t = torch.from_numpy(_r((64, 64), seed=capacity)) * 10.0
        t2 = t * t
        keep = t2.reshape(-1) >= T2_SCREEN
        screen_count = torch.sum(keep).to(torch.int32)
        found = torch.nonzero(keep).reshape(-1)[:capacity].to(torch.int32)
        old_idx = torch.full((capacity,), -1, dtype=torch.int32)
        old_idx[: found.shape[0]] = found
        before = ts.compact_launches
        idx, count = ts.compact_survivors(t, T2_SCREEN, capacity)
        assert ts.compact_launches == before
        idx_plain, count_plain = ts.compact_survivors_plain(t, T2_SCREEN, capacity)
        assert torch.equal(idx, old_idx) and torch.equal(idx_plain, old_idx)
        assert count.dtype == torch.int32 and int(count) == int(count_plain) == int(screen_count)
        ref = ref_assoc.sparse_epilogue_outputs(
            t.numpy(), t.numpy(), DOF, ref_assoc.SparseEpilogue(7.301, T2_SCREEN, capacity))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref["hit_idx"]))
        assert int(count) == int(ref["screen_count"])


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 1024), (1000, 300)])
def test_cuda_compact_survivors_matches_plain_version(shape):
    dev = _cuda()
    t = ts.tstat(torch.from_numpy(_r(shape, seed=13)).to(dev), DOF)
    before = ts.compact_launches
    idx, count = ts.compact_survivors(t, T2_SCREEN, 4096)
    torch.cuda.synchronize()
    assert ts.compact_launches == before + 1
    idx0, count0 = ts.compact_survivors_plain(t, T2_SCREEN, 4096)
    assert torch.equal(idx, idx0)
    assert count.dtype == torch.int32 and int(count) == int(count0)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [5, 4096])
@pytest.mark.parametrize("case", ["none", "all", "straddle", "nan", "many_tiles", "empty"])
def test_cuda_compaction_edges_match_plain_version(case, capacity):
    """Both entries at the compaction's edges: no survivors, all, survivors
    across tile edges, NaN r, 38 tiles, an empty tile; capacity 5 overflows
    and 4096 exceeds some tiles' size."""
    dev = _cuda()
    r = torch.from_numpy(_edge_r(case)[0]).to(dev)
    t, idx, count = ts.screen_compact(r, DOF, T2_SCREEN, capacity)
    t0, idx0, count0 = ts.screen_compact_plain(r, DOF, T2_SCREEN, capacity)
    assert torch.equal(t.view(torch.int32), ts.tstat(r, DOF).view(torch.int32))  # NaN too
    assert torch.equal(idx, idx0) and int(count) == int(count0)
    idx_t, count_t = ts.compact_survivors(t, T2_SCREEN, capacity)
    assert torch.equal(idx_t, idx) and int(count_t) == int(count)


@pytest.mark.gpu
def test_cuda_compaction_reuses_its_workspace_across_launches_and_streams():
    """Back-to-back launches of growing and shrinking sizes, on the default
    stream and on a second one: each workspace retires the last launch's
    status words by its epoch, and each result equals the plain version."""
    dev = _cuda()
    side = torch.cuda.Stream(dev)
    for i, shape in enumerate([(64, 64), (1000, 300), (37, 53), (4096, 1024), (3, 5)] * 4):
        stream = side if i % 2 else torch.cuda.current_stream(dev)
        with torch.cuda.stream(stream):
            t = ts.tstat(torch.from_numpy(_r(shape, seed=i)).to(dev), DOF)
            idx, count = ts.compact_survivors(t, T2_SCREEN, 64)
            idx0, count0 = ts.compact_survivors_plain(t, T2_SCREEN, 64)
            assert torch.equal(idx, idx0) and int(count) == int(count0)


@pytest.mark.gpu
def test_cuda_compaction_waits_for_no_host():
    """No torch op of either entry, nor of the sparse epilogue that calls
    the t mode, reads a device value back to the host."""
    from repro_torch.core.association import SparseEpilogue, sparse_epilogue_outputs

    dev = _cuda()
    r = torch.from_numpy(_r((1000, 300), seed=14)).to(dev)
    t = ts.tstat(r, DOF)
    plan = SparseEpilogue(7.301, T2_SCREEN, 4096)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts.screen_compact(r, DOF, T2_SCREEN, 4096)
        ts.compact_survivors(t, T2_SCREEN, 4096)
        sparse_epilogue_outputs(r, t, DOF, plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
