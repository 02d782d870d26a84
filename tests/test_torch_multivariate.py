"""The multivariate slice of the port against the reference package, on the
same seeded inputs:

  * stats — ``chi2_from_r`` (1 ulp), ``neglog10_p_from_r`` (the p-value
    contract: 2e-3 rel / 5e-3 abs), ``_log_gammaincc_cf`` and
    ``neglog10_sf_chi2`` on the bulk and the tail branch at k in {3, 12, 200,
    2048} (port vs reference 2e-3 rel / 5e-3 abs; each against
    ``scipy.special.gammaincc`` in float64), ``bh_qvalues`` with ties (1e-6);
  * ``whiten_panel`` held on ``W W^T`` (1e-4 of its largest entry) and the
    eigenvalues (1e-6 of the largest), never on ``W`` itself: eigenvector
    signs and the basis of a near-degenerate eigenspace differ between
    eigensolvers;
  * ``omnibus_chi2``, ``max_abs_t`` and ``effective_tests`` (the latter on the
    reference's own eigenvalues, 1e-5), and ``assoc_batch`` in both dof modes
    (dense oracle tolerances: r 2e-5, t 2e-4, nlp 2e-3 rel / 5e-3 abs);
  * the port's multivariate dense step, split prolog bitwise equal to the
    monolithic one;
  * a whole ``ScanPlan`` multivariate scan on the shared cohort (N=400,
    M=600, P=12): the same hits, ``omnibus_nlp`` within 2e-3 rel / 5e-3 abs,
    ``n_traits_eff`` within 1e-3; its ``qc.tsv`` column and npz key, a
    checkpoint replay, and the executor's slots bitwise equal to serial;
  * the refusals: a blocked grid, the lmm engine and the fused engine.
"""
import os

import numpy as np
import pytest
import scipy.special as sp
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.api import GridSpec as RefGridSpec  # noqa: E402
from repro.api import Study as RefStudy  # noqa: E402
from repro.core import association as ref_assoc  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.core import multivariate as ref_mv  # noqa: E402
from repro.core import stats as ref_stats  # noqa: E402
from repro.core.residualize import covariate_basis as ref_basis  # noqa: E402
from repro.io import synth  # noqa: E402
from repro_torch.api import (  # noqa: E402
    CheckpointReplay,
    ExecSpec,
    GridSpec,
    LmmSpec,
    NpzShardWriter,
    Study,
    TsvWriter,
)
from repro_torch.core import association, engines, multivariate, stats  # noqa: E402
from repro_torch.core.residualize import covariate_basis  # noqa: E402
from repro_torch.launch.gwas import main  # noqa: E402

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)

NLP_RTOL, NLP_ATOL = 2e-3, 5e-3        # the p-value contract (tests/test_oracle.py)
R_TOL, T_TOL = 2e-5, 2e-4              # dense oracle tolerances
WWT_TOL = 1e-4                         # of max |W W^T|
EIG_TOL = 1e-6                         # of the largest eigenvalue
MEFF_TOL = 1e-3                        # n_traits_eff end to end


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _nlp_close(got, want, rtol=NLP_RTOL, atol=NLP_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------- stats


def test_chi2_from_r_matches_reference():
    r = np.random.default_rng(1).normal(scale=0.1, size=(64, 9)).astype(np.float32)
    got = stats.chi2_from_r(_t(r), 400).numpy()
    want = np.asarray(ref_stats.chi2_from_r(r, 400))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_neglog10_p_from_r_matches_reference_and_scipy():
    rng = np.random.default_rng(2)
    r = np.concatenate([rng.normal(scale=0.05, size=300), rng.uniform(-0.6, 0.6, 100),
                        [0.0, 1.0, -1.0]]).astype(np.float32)
    dof = 398.0
    got = stats.neglog10_p_from_r(_t(r), dof).numpy()
    _nlp_close(got, ref_stats.neglog10_p_from_r(r, dof))
    inner = np.abs(r) < 0.6
    t64 = r[inner].astype(np.float64) * np.sqrt(dof / (1.0 - r[inner].astype(np.float64) ** 2))
    exact = -np.log10(sp.betainc(dof / 2, 0.5, dof / (dof + t64 * t64)))
    _nlp_close(got[inner], exact)


@pytest.mark.parametrize("k", [3, 12, 200, 2048])
def test_log_gammaincc_cf_matches_reference_and_scipy(k):
    a = k / 2.0
    z = np.linspace(a + 2.0, a + 20.0 * np.sqrt(a) + 40.0, 64).astype(np.float32)
    got = stats._log_gammaincc_cf(torch.full((64,), a), _t(z)).numpy()
    want = np.asarray(ref_stats._log_gammaincc_cf(jnp.full((64,), a, jnp.float32), z))
    # log sf: the same 2e-3 rel / 5e-3 abs as -log10 p
    np.testing.assert_allclose(got, want, rtol=NLP_RTOL, atol=NLP_ATOL)
    exact = np.log(sp.gammaincc(a, z.astype(np.float64)))
    np.testing.assert_allclose(got, exact, rtol=NLP_RTOL, atol=NLP_ATOL)


def _chi2_stats(k: int, branch: str) -> np.ndarray:
    """Statistics on one branch of ``neglog10_sf_chi2``: the bulk (sf >=
    1e-6 or stat/2 <= k/2 + 1) or the tail (sf < 1e-6), here with sf still
    above float64's underflow so scipy can say what it should be."""
    sd = np.sqrt(2.0 * k)
    if branch == "bulk":
        s = np.linspace(0.0, k + 4.0 * sd + 10.0, 80)
    else:
        lo = sp.gammainccinv(k / 2.0, 1e-7) * 2.0
        hi = sp.gammainccinv(k / 2.0, 1e-250) * 2.0
        s = np.linspace(lo, hi, 80)
    return s.astype(np.float32)


@pytest.mark.parametrize("branch", ["bulk", "tail"])
@pytest.mark.parametrize("k", [3, 12, 200, 2048])
def test_neglog10_sf_chi2_matches_reference_and_scipy(k, branch):
    s = _chi2_stats(k, branch)
    got = stats.neglog10_sf_chi2(_t(s), k).numpy()
    exact = -np.log10(sp.gammaincc(k / 2.0, s.astype(np.float64) / 2.0))
    if branch == "tail":
        assert exact.min() > 6.0        # every lane takes the continued fraction
    else:
        assert exact.min() < 1.0 and np.all(exact < 6.5)
    _nlp_close(got, ref_stats.neglog10_sf_chi2(s, k))
    _nlp_close(got, exact)


def test_neglog10_sf_chi2_deep_tail_matches_reference():
    """Past float64's underflow only the reference can say: both log-space."""
    s = np.array([1e4, 3e4, 1e5], np.float32)
    for k in (3, 12, 200, 2048):
        got = stats.neglog10_sf_chi2(_t(s), k).numpy()
        assert np.all(np.isfinite(got)) and np.all(got > 300)
        _nlp_close(got, ref_stats.neglog10_sf_chi2(s, k))


def _bh_oracle(nlp: np.ndarray) -> np.ndarray:
    """Plain float64 Benjamini-Hochberg, as -log10 q."""
    p = np.power(10.0, -nlp.astype(np.float64))
    m = p.size
    order = np.argsort(p, kind="stable")
    q = p[order] * m / np.arange(1, m + 1)
    q = np.minimum.accumulate(q[::-1])[::-1]
    out = np.empty(m)
    out[order] = np.minimum(q, 1.0)
    return -np.log10(out)


def test_bh_qvalues_with_ties_matches_reference():
    rng = np.random.default_rng(3)
    nlp = np.abs(rng.normal(scale=3.0, size=(40, 10))).astype(np.float32)
    nlp.reshape(-1)[::9] = nlp.reshape(-1)[0]         # a run of tied p-values
    nlp[5, :4] = 0.0                                   # ties at p = 1
    got = stats.bh_qvalues(_t(nlp)).numpy()
    want = np.asarray(ref_stats.bh_qvalues(nlp))
    assert got.shape == nlp.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, _bh_oracle(nlp.reshape(-1)).reshape(nlp.shape),
                               rtol=1e-5, atol=1e-5)
    # tied inputs get tied q-values
    flat = got.reshape(-1)
    assert np.all(flat[::9] == flat[0])


# --------------------------------------------------------------- multivariate


def _panel(n: int, p: int, seed: int) -> np.ndarray:
    """A standardized panel with correlated traits (4 latent factors)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, 4)) @ rng.normal(size=(4, p)) + 0.5 * rng.normal(size=(n, p))
    return ((y - y.mean(0)) / y.std(0)).astype(np.float32)


def _wwt(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w, np.float64)
    return w @ w.T


@pytest.mark.parametrize("n,p", [(400, 12), (300, 40), (8, 12)])
def test_whiten_panel_matches_reference_on_wwt(n, p):
    """``W W^T`` and the eigenvalues agree; ``W`` is not compared.  (8, 12)
    is rank-deficient: the floor drops the null directions in both."""
    y = _panel(n, p, seed=n + p)
    w_ref, lam_ref = (np.asarray(a) for a in ref_mv.whiten_panel(y))
    w, lam = multivariate.whiten_panel(_t(y), device="cpu")
    w, lam = w.numpy(), lam.numpy()
    assert w.shape == w_ref.shape == (p, p) and w.dtype == np.float32
    np.testing.assert_allclose(lam, lam_ref, rtol=0, atol=EIG_TOL * lam_ref[0])
    kept = lambda m: int((np.abs(m).sum(0) > 0).sum())  # noqa: E731
    assert kept(w) == kept(w_ref)
    a, b = _wwt(w), _wwt(w_ref)
    np.testing.assert_allclose(a, b, rtol=0, atol=WWT_TOL * np.abs(b).max())
    if n > p:
        # full rank: Y W has identity trait correlation
        yw = y.astype(np.float64) @ w
        np.testing.assert_allclose(yw.T @ yw / n, np.eye(p), atol=1e-3)


def test_effective_tests_on_the_same_eigenvalues():
    for seed, p in ((0, 12), (1, 40), (2, 200)):
        lam = np.asarray(ref_mv.whiten_panel(_panel(500, p, seed))[1])
        got = float(multivariate.effective_tests(_t(lam)))
        want = float(ref_mv.effective_tests(lam))
        assert abs(got - want) <= 1e-5, (p, got, want)


@pytest.fixture(scope="module")
def tiles():
    """A correlation tile, its t, a panel's whitening (the reference's W)."""
    rng = np.random.default_rng(4)
    n, m, p = 400, 96, 12
    y = _panel(n, p, seed=5)
    g = rng.normal(size=(m, n)).astype(np.float32)
    g[: m // 2] += 0.3 * y[:, :1].T                   # half the markers carry signal
    g = (g - g.mean(1, keepdims=True)) / g.std(1, keepdims=True)
    r = np.clip(g @ y / n, -1, 1).astype(np.float32)
    t = (r * np.sqrt(398.0 / (1.0 - r * r))).astype(np.float32)
    return n, y, r, t


def test_omnibus_chi2_matches_reference(tiles):
    n, y, r, _ = tiles
    w_ref = np.array(ref_mv.whiten_panel(y)[0])
    meff = 11.5
    # on the same W: one float32 product and sum apart
    s, nlp = multivariate.omnibus_chi2(_t(r), n, meff, whitening=_t(w_ref))
    s_ref, nlp_ref = (np.asarray(a) for a in ref_mv.omnibus_chi2(r, n, meff, whitening=w_ref))
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5)
    _nlp_close(nlp.numpy(), nlp_ref)
    # on the port's own W: S depends on W only through W W^T
    w, _ = multivariate.whiten_panel(_t(y))
    s2, nlp2 = multivariate.omnibus_chi2(_t(r), n, meff, whitening=w)
    np.testing.assert_allclose(s2.numpy(), s_ref, rtol=1e-4)
    _nlp_close(nlp2.numpy(), nlp_ref)
    # without whitening: the panel is taken as already white
    s3, _ = multivariate.omnibus_chi2(_t(r), n, meff)
    np.testing.assert_allclose(s3.numpy(), np.asarray(ref_mv.omnibus_chi2(r, n, meff)[0]),
                               rtol=1e-6)


def test_max_abs_t_and_screen_match_reference(tiles):
    n, _, r, t = tiles
    tmax, nlp = multivariate.max_abs_t(_t(t), 398.0, 7.25)
    tmax_ref, nlp_ref = (np.asarray(a) for a in ref_mv.max_abs_t(t, 398, 7.25))
    np.testing.assert_array_equal(tmax.numpy(), tmax_ref)
    _nlp_close(nlp.numpy(), nlp_ref)
    got = multivariate.screen(_t(r), _t(t), n_samples=n, dof=398.0, n_traits_eff=7.25)
    want = ref_mv.screen(r, t, n_samples=n, dof=398, n_traits_eff=7.25)
    assert got._fields == want._fields
    np.testing.assert_allclose(got.omnibus.numpy(), np.asarray(want.omnibus), rtol=1e-6)
    np.testing.assert_array_equal(got.max_t.numpy(), np.asarray(want.max_t))
    for key in ("omnibus_nlp", "max_t_nlp"):
        _nlp_close(getattr(got, key).numpy(), getattr(want, key))


@pytest.mark.parametrize("dof_mode", ["paper", "exact"])
def test_assoc_batch_matches_reference(dof_mode, cohort):
    n = cohort.dosages.shape[1]
    g = cohort.dosages[:128].astype(np.float32)
    g[3] = 1.0                                        # a monomorphic marker: masked
    y = _panel(n, 12, seed=6)
    q_ref = ref_basis(jnp.asarray(cohort.covariates), n)
    q = covariate_basis(cohort.covariates, n, device="cpu")
    kw = dict(n_samples=n, n_covariates=int(q.shape[1]) - 1)
    res_ref, ms_ref = ref_assoc.assoc_batch(
        g, y, options=ref_assoc.AssocOptions(dof_mode=dof_mode), q_basis=q_ref, **kw)
    res, ms = association.assoc_batch(
        _t(g), _t(y), options=association.AssocOptions(dof_mode=dof_mode), q_basis=q, **kw)
    np.testing.assert_array_equal(ms.valid.numpy(), np.asarray(ms_ref.valid))
    assert not ms.valid[3] and np.all(res.r[3].numpy() == 0) and np.all(res.neglog10p[3].numpy() == 0)
    np.testing.assert_allclose(res.r.numpy(), np.asarray(res_ref.r), atol=R_TOL)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(res_ref.t), rtol=T_TOL, atol=T_TOL)
    _nlp_close(res.neglog10p.numpy(), res_ref.neglog10p)
    if dof_mode == "exact":
        with pytest.raises(ValueError, match="q_basis"):
            association.assoc_batch(_t(g), _t(y), options=association.AssocOptions(
                dof_mode="exact"), **kw)


# --------------------------------------------------------------- dense step


def test_multivariate_dense_step_split_prolog_bitwise(cohort):
    """The port's form of the reference's ``test_dense_prolog_split_bitwise``
    (tests/test_screening.py): the memoized prolog equals the monolithic
    step bitwise, the omnibus included, and the memo serves a second trait
    block on the same staged batch."""
    rng = np.random.default_rng(0)
    n, m, p = 150, 48, 12
    g = rng.binomial(2, 0.3, size=(m, n)).astype(np.float32)
    g[rng.random(g.shape) < 0.02] = -9.0
    y = rng.normal(size=(n, p)).astype(np.float32)
    q = covariate_basis(rng.normal(size=(n, 2)).astype(np.float32), n, device="cpu")
    w, lam = multivariate.whiten_panel(_t(y))
    for dof_mode in ("paper", "exact"):
        kw = dict(
            n_samples=n, n_covariates=2,
            options=association.AssocOptions(dof_mode=dof_mode), q_basis=q,
            trait_tile=4, maf_min=0.05, multivariate=(dof_mode == "paper"),
            n_traits_eff=float(multivariate.effective_tests(lam)), whitening=w,
            sparse_epilogue=True,
        )
        split = engines.build_dense_step(split_prolog=True, **kw)
        mono = engines.build_dense_step(split_prolog=False, **kw)
        gd, yd = _t(g), _t(y)
        out_split, out_mono = split(gd, yd), mono(gd, yd)
        assert out_split.keys() == out_mono.keys()
        assert ("omnibus_nlp" in out_mono) == (dof_mode == "paper")
        # the multivariate step keeps the dense epilogue; the plain one is sparse
        assert ("nlp" in out_mono) == (dof_mode == "paper")
        for key in out_mono:
            assert torch.equal(out_split[key], out_mono[key]), f"{dof_mode}:{key}"
        y2 = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
        a, b = split(gd, y2), mono(gd, y2)
        for key in b:
            assert torch.equal(a[key], b[key]), f"{dof_mode}:{key} (second block)"


def test_multivariate_dense_step_matches_reference_step(cohort):
    n = cohort.dosages.shape[1]
    g = cohort.dosages[:200].astype(np.float32)
    y = _panel(n, 12, seed=8)
    w_ref, lam_ref = ref_mv.whiten_panel(y)
    meff = float(ref_mv.effective_tests(lam_ref))
    ref_step = ref_engines.build_dense_step(
        n_samples=n, n_covariates=0, options=ref_assoc.AssocOptions(), multivariate=True,
        n_traits_eff=meff, whitening=w_ref, trait_tile=4, sparse_epilogue=True)
    want = {k: np.asarray(v) for k, v in ref_step(jnp.asarray(g), jnp.asarray(y)).items()}
    w, _ = multivariate.whiten_panel(_t(y))
    step = engines.build_dense_step(
        n_samples=n, n_covariates=0, options=association.AssocOptions(), multivariate=True,
        n_traits_eff=meff, whitening=w, trait_tile=4, sparse_epilogue=True)
    got = {k: v.numpy() for k, v in step(_t(g), _t(y)).items()}
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["r"], want["r"], atol=R_TOL)
    np.testing.assert_allclose(got["omnibus"], want["omnibus"], rtol=1e-3)
    _nlp_close(got["omnibus_nlp"], want["omnibus_nlp"])
    _nlp_close(got["nlp"], want["nlp"])


# ------------------------------------------------------------ the whole scan


@pytest.fixture(scope="module")
def mv_files(cohort, tmp_path_factory):
    return synth.write_cohort_files(cohort, str(tmp_path_factory.mktemp("mv") / "toy"))


def _collect(session):
    """Hits (sorted), their stats, the omnibus track and per-trait best."""
    m = session.n_markers
    omni = np.zeros(m, np.float32)
    hits, hstats = [np.zeros((0, 2), np.int32)], [np.zeros((0, 3), np.float32)]
    for cell in session.events():
        if cell.omnibus_nlp is not None:
            omni[cell.lo:cell.hi] = cell.omnibus_nlp
        hits.append(cell.hits)
        hstats.append(cell.hit_stats)
    h, s = np.concatenate(hits), np.concatenate(hstats)
    order = np.lexsort((h[:, 1], h[:, 0]))
    return h[order], s[order], omni


@pytest.fixture(scope="module")
def mv_runs(mv_files, tmp_path_factory):
    f = mv_files
    ref = RefStudy.from_files(f["bed"], f["pheno"], f["cov"]).plan(
        engine="dense", grid=RefGridSpec(batch_markers=256), multivariate=True).run()
    port_plan = Study.from_files(f["bed"], f["pheno"], f["cov"]).plan(
        engine="dense", grid=GridSpec(batch_markers=256), multivariate=True, device="cpu")
    port = port_plan.run()
    return {"ref": (ref, _collect(ref)), "port": (port, _collect(port)), "plan": port_plan}


def test_multivariate_scan_matches_reference(mv_runs, cohort):
    ref_sess, (h_ref, s_ref, o_ref) = mv_runs["ref"]
    sess, (h, s, o) = mv_runs["port"]
    ctx, ref_ctx = sess.prepared.ctx, ref_sess.prepared.ctx
    assert ctx.multivariate and ctx.whitening is not None
    assert abs(ctx.n_traits_eff - ref_ctx.n_traits_eff) <= MEFF_TOL, (
        ctx.n_traits_eff, ref_ctx.n_traits_eff)
    np.testing.assert_array_equal(h, h_ref)
    np.testing.assert_allclose(s[:, 0], s_ref[:, 0], atol=R_TOL)
    np.testing.assert_allclose(s[:, 1], s_ref[:, 1], rtol=T_TOL, atol=T_TOL)
    _nlp_close(s[:, 2], s_ref[:, 2])
    _nlp_close(o, o_ref)
    # the screen finds the planted markers and stays quiet on the rest
    planted = sorted({mk for mk, _, _ in cohort.effects})
    null = np.setdiff1d(np.arange(cohort.dosages.shape[0]), planted)
    assert np.median(o[planted]) > 5.0 and np.median(o[null]) < 1.0


def test_multivariate_scan_writes_the_omnibus_column(mv_runs, tmp_path):
    """qc.tsv gains ``omnibus_neglog10p``, the npz ``qc.npz`` its
    ``omnibus_nlp``; a checkpointed run replays the same column."""
    plan = mv_runs["plan"]
    _, (_, _, omni) = mv_runs["port"]
    ck = str(tmp_path / "ck")
    study = plan.study
    ck_plan = study.plan(engine="dense", grid=GridSpec(batch_markers=256), multivariate=True,
                         checkpoint_dir=ck, device="cpu")
    live = str(tmp_path / "live")
    ck_plan.run().stream_to(TsvWriter(live), NpzShardWriter(live))
    with open(os.path.join(live, "qc.tsv")) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fh]
    assert header == ["marker", "maf", "valid", "omnibus_neglog10p"]
    np.testing.assert_allclose([float(r[3]) for r in rows], omni, atol=6e-4)  # 3 dp
    qc_npz = [f for f in os.listdir(live) if f.endswith(".npz") and "qc" in f]
    assert qc_npz, os.listdir(live)
    with np.load(os.path.join(live, qc_npz[0])) as z:
        np.testing.assert_array_equal(z["omnibus_nlp"], omni)
    replay = CheckpointReplay(ck, marker_ids=study.marker_ids, trait_names=study.trait_names)
    assert replay.multivariate
    merged = str(tmp_path / "merged")
    replay.stream_to(TsvWriter(merged))
    for name in ("qc.tsv", "hits.tsv", "per_trait_best.tsv"):
        with open(os.path.join(live, name)) as a, open(os.path.join(merged, name)) as b:
            assert a.read() == b.read(), name


def test_multivariate_executor_slots_bitwise_equal_serial(mv_runs):
    """Two executor slots (each with its own device state, so its own copy of
    the whitening) reproduce the serial scan bit for bit."""
    _, (h, s, o) = mv_runs["port"]
    study = mv_runs["plan"].study
    sess = study.plan(engine="dense", grid=GridSpec(batch_markers=256), multivariate=True,
                      executor=ExecSpec(devices=2), device="cpu").run()
    h2, s2, o2 = _collect(sess)
    assert sess.executor_info["kind"] != "serial"
    for a, b in ((h, h2), (s, s2), (o, o2)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("what", ["blocked", "lmm", "fused"])
def test_multivariate_refusals(what, mv_files):
    f = mv_files
    study = Study.from_files(f["bed"], f["pheno"], f["cov"])
    kw = {
        "blocked": dict(engine="dense", grid=GridSpec(trait_block=4, block_p=4)),
        "lmm": dict(engine="lmm", lmm=LmmSpec(delta=1.0)),
        "fused": dict(engine="fused"),
    }[what]
    match = {"blocked": "unblocked", "lmm": "exclusive", "fused": "dense engine"}[what]
    with pytest.raises(ValueError, match=match):
        study.plan(multivariate=True, device="cpu", **kw).prepare()


@pytest.mark.parametrize("engine", ["fused", "lmm"])
def test_cli_multivariate_on_other_engines_refuses_without_a_column(engine, mv_files, tmp_path):
    f = mv_files
    out = str(tmp_path / "out")
    with pytest.raises(ValueError):
        main(["scan", "--genotypes", f["bed"], "--pheno", f["pheno"], "--covar", f["cov"],
              "--out", out, "--device", "cpu", "--engine", engine, "--multivariate",
              "--lmm-delta", "1.0"])
    assert not os.path.exists(os.path.join(out, "qc.tsv"))
