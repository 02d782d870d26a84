"""The port's statistical epilogue against the reference on the (t, dof) grids
of tests/test_stats.py, across all three -log10 p lanes (tolerance 2e-3
relative / 5e-3 absolute), plus the screen inversion, the canonical refine
and genomic control."""
import math

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
sps = pytest.importorskip("scipy.stats")

from repro.core import stats as R  # noqa: E402
from repro_torch.core import stats as S  # noqa: E402

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)

NUS = [2, 5, 18, 100, 1000, 4095, 4097, 21000, 499000, 2000000]
T_GRID = np.concatenate(
    [
        [0.0, 0.3, 1.0, 2.0, 2.44, 2.46, 3.2, 5.0, 10.0, 12.1, 30.0, 100.0],
        np.linspace(0.01, 30.0, 40),
        np.geomspace(30.0, 1000.0, 25),
    ]
).astype(np.float32)


def _port(t, nu):
    return S.neglog10_p_from_t(torch.from_numpy(np.asarray(t, np.float32)), float(nu)).numpy()


@pytest.mark.parametrize("nu", NUS)
def test_neglog10_p_matches_reference(nu):
    """Every lane (tail CF, beta bulk for nu <= 4096, Edgeworth above)."""
    ref = np.asarray(R.neglog10_p_from_t(jnp.asarray(T_GRID), float(nu)))
    ours = _port(T_GRID, nu)
    assert np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=5e-3)
    assert _port([0.0], nu)[0] == 0.0


@pytest.mark.parametrize("nu", NUS)
def test_neglog10_p_within_scipy_envelope(nu):
    """The same <5e-3 relative envelope the reference holds against scipy."""
    ts = T_GRID[T_GRID > 0]
    ours = _port(ts, nu)
    worst = 0.0
    for t, o in zip(ts, ours):
        ref = -(sps.t.logsf(float(t), nu) + math.log(2)) / math.log(10)
        if math.isinf(ref) or math.isnan(ref):
            assert o > 300
            continue
        worst = max(worst, abs(float(o) - ref) / max(abs(ref), 1e-2))
    assert worst < 5e-3, (nu, worst)


def test_neglog10_p_deep_tail_monotone():
    ts = np.linspace(0, 2000, 4001).astype(np.float32)
    nlp = _port(ts, 21000.0)
    assert np.all(np.isfinite(nlp))
    assert np.all(np.diff(nlp) >= -1e-3)
    assert nlp[-1] > 10_000


@pytest.mark.parametrize("r", [[0.0, 0.1, -0.5, 0.99], [1.0, -1.0, 0.3, 0.0]])
def test_t_from_r_matches_reference(r):
    r32 = np.asarray(r, np.float32)
    want = np.asarray(R.t_from_r(jnp.asarray(r32), 998))
    got = S.t_from_r(torch.from_numpy(r32), 998).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("thr,nu", [(3.0, 5.0), (7.301, 398.0), (7.301, 22986.0),
                                    (20.0, 2000000.0), (1.0, 100.0)])
def test_t2_screen_threshold_conservative(thr, nu):
    """Every t the port's own function calls a hit passes the screen, and the
    screen is tight (admits only a thin sub-threshold margin)."""
    t2s = S.t2_screen_threshold(thr, nu)
    assert t2s is not None and t2s > 0
    assert np.float32(t2s) == t2s            # an f32 value: the screen compares in f32
    tstar = math.sqrt(t2s)
    ts = np.concatenate(
        [np.linspace(0.0, 3 * tstar, 400), np.geomspace(max(tstar, 1.0), 1000.0, 50)]
    ).astype(np.float32)
    nlp = _port(ts, nu)
    hits = nlp >= thr
    assert np.all(ts[hits] ** 2 >= t2s), (thr, nu, t2s)
    assert float(_port([tstar], nu)[0]) > 0.5 * thr
    # same inversion as the reference, up to the two functions' own f32 error
    ref = R.t2_screen_threshold(thr, nu)
    assert abs(t2s - ref) <= 1e-3 * ref


def test_t2_screen_threshold_degenerate():
    cap = S.t2_screen_threshold(1e6, 3.0)
    assert cap is not None and cap >= 1e36
    assert S.t2_screen_threshold(0.0, 100.0) is None
    assert S.t2_screen_threshold(-1.0, 100.0) is None


@pytest.mark.parametrize("nu", [10.0, 998.0, 4097.0, 21000.0])
def test_refine_is_canonical(nu):
    """Fixed-width chunks: a value's bits do not depend on the buffer it came
    in — its length, its position, or how many chunks were evaluated together."""
    rng = np.random.default_rng(int(nu))
    big = rng.normal(0, 8, 1000).astype(np.float32)
    a = S.refine_neglog10p(big, nu)
    for lo, hi in ((0, 10), (5, 64), (64, 130), (999, 1000), (300, 1000)):
        np.testing.assert_array_equal(S.refine_neglog10p(big[lo:hi], nu), a[lo:hi])
    chunk = np.zeros(S.REFINE_WIDTH, np.float32)
    chunk[:10] = big[:10]
    np.testing.assert_array_equal(S.refine_neglog10p(chunk, nu, width=None)[:10], a[:10])
    np.testing.assert_allclose(a, _port(big, nu), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        a, np.asarray(R.refine_neglog10p(big, nu, width=64)), rtol=2e-3, atol=5e-3
    )


@pytest.mark.parametrize("n", [4, 7, 100, 1000])
def test_genomic_control_lambda_matches_reference(n):
    t = np.random.default_rng(n).standard_t(200, n).astype(np.float32)
    want = float(R.genomic_control_lambda(jnp.asarray(t)))
    got = float(S.genomic_control_lambda(torch.from_numpy(t)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_genomic_control_lambda_even_length_averages_middles():
    # median of t^2 = (4 + 9) / 2, not the lower middle value 4
    got = float(S.genomic_control_lambda(torch.tensor([1.0, 2.0, 3.0, 4.0])))
    assert got == pytest.approx(6.5 / 0.45493642311957184, rel=1e-6)


def test_lambda_gc_calibrated_on_null():
    t = np.random.default_rng(0).standard_t(200, 100_000).astype(np.float32)
    assert 0.97 < float(S.genomic_control_lambda(torch.from_numpy(t))) < 1.03
