"""The port's dense and fused step outputs against the reference steps on the
same ``HostBatch`` and the same residualized panel, at the oracle tolerances
(tests/test_oracle.py): dense r 2e-5, t 2e-4; fused r 5e-5, t 5e-4.  Hit
indices and per-trait winners must be equal wherever the decision is not
within the tolerance of a tie or of the screen threshold."""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import engines as ref_engines  # noqa: E402
from repro.core.association import AssocOptions as RefOptions  # noqa: E402
from repro.core.residualize import covariate_basis, residualize_and_standardize  # noqa: E402
from repro.io.plink import PlinkBed as RefPlinkBed  # noqa: E402
from repro.io.plink import write_plink  # noqa: E402
from repro.runtime.prefetch import BatchPlanner  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.core.association import AssocOptions  # noqa: E402

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)

TOL = {  # engine -> (r atol, t rtol=atol, nlp rtol, nlp atol)
    "dense": (2e-5, 2e-4, 2e-3, 5e-3),
    "fused": (5e-5, 5e-4, 5e-3, 1e-2),
}
BLOCKS = dict(block_m=64, block_n=128, block_p=8)


@pytest.fixture(scope="module")
def scan_inputs(cohort, tmp_path_factory):
    stem = str(tmp_path_factory.mktemp("engines") / "toy")
    bed = write_plink(stem, cohort.dosages, sample_ids=cohort.sample_ids)
    source = RefPlinkBed(bed)
    n = source.n_samples
    q = covariate_basis(jnp.asarray(cohort.covariates), n)
    y = np.array(residualize_and_standardize(jnp.asarray(cohort.phenotypes), q).y, copy=True)
    # the last batch is ragged (600 = 2 * 256 + 88 markers)
    batches = BatchPlanner(256).plan(source)
    return source, y, int(q.shape[1]) - 1, batches


def _run_both(scan_inputs, engine, sparse, staging, batch_idx, capacity=4096):
    source, y, n_cov, batches = scan_inputs
    n = source.n_samples
    batch = batches[batch_idx]
    ref_ctx = ref_engines.EngineContext(
        n_samples=n, n_covariates=n_cov, options=RefOptions(),
        sparse_epilogue=sparse, hit_capacity=capacity, genotype_staging=staging, **BLOCKS,
    )
    ref_engine = ref_engines.get_engine(engine)
    hb = ref_engine.prepare_batch(source, batch, ref_ctx)
    ref_out = ref_engine.build_step(ref_ctx)(
        *[jnp.asarray(a) for a in hb.device_args], jnp.asarray(y)
    )
    ref_out = {k: np.asarray(v) for k, v in ref_out.items()}

    ctx = engines.EngineContext(
        n_samples=n, n_covariates=n_cov, options=AssocOptions(), device=torch.device("cpu"),
        sparse_epilogue=sparse, hit_capacity=capacity, genotype_staging=staging, **BLOCKS,
    )
    port_engine = engines.get_engine(engine)
    state = port_engine.make_device_state(ctx)
    port_hb = engines.host_batch_from_reference(hb)
    out = state.step(*state.stage(port_hb), torch.from_numpy(y))
    out = {k: v.numpy() for k, v in out.items()}
    return ref_out, out, hb


def _winner_decided(t_ref, tol_t):
    """Traits whose best and runner-up |t| differ by more than the tolerance."""
    a = np.sort(np.abs(t_ref), axis=0)
    if a.shape[0] < 2:
        return np.ones(a.shape[1], bool)
    top, second = a[-1], a[-2]
    return (top - second) > 2 * (tol_t + tol_t * top)


@pytest.mark.parametrize("staging", ["packed", "dense"])
@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("engine", ["dense", "fused"])
@pytest.mark.parametrize("batch_idx", [0, 2])
def test_step_matches_reference(scan_inputs, engine, sparse, staging, batch_idx):
    r_tol, t_tol, nlp_rtol, nlp_atol = TOL[engine]
    ref_out, out, hb = _run_both(scan_inputs, engine, sparse, staging, batch_idx)
    assert set(out) == set(ref_out)
    m = hb.batch.n_markers
    r_ref, t_ref = ref_out["r"][:m], ref_out["t"][:m]
    np.testing.assert_allclose(out["r"][:m], r_ref, atol=r_tol)
    np.testing.assert_allclose(out["t"][:m], t_ref, rtol=t_tol, atol=t_tol)
    for key in ("maf", "valid"):
        if key in ref_out:
            np.testing.assert_array_equal(out[key], ref_out[key])
    decided = _winner_decided(t_ref, t_tol)
    np.testing.assert_array_equal(
        out["batch_best_row"][decided], ref_out["batch_best_row"][decided]
    )
    np.testing.assert_allclose(out["batch_best_t"], ref_out["batch_best_t"],
                               rtol=t_tol, atol=t_tol)
    if not sparse:
        np.testing.assert_allclose(out["nlp"][:m], ref_out["nlp"][:m],
                                   rtol=nlp_rtol, atol=nlp_atol)
        np.testing.assert_allclose(out["batch_best_nlp"], ref_out["batch_best_nlp"],
                                   rtol=nlp_rtol, atol=nlp_atol)
        return
    # Sparse: the screened index sets agree away from the screen boundary
    # (each package inverts the threshold through its own f32 function).
    from repro.core.stats import t2_screen_threshold as ref_t2
    from repro_torch.core.stats import t2_screen_threshold as port_t2

    n = scan_inputs[0].n_samples
    dof = n - 2
    t2a, t2b = ref_t2(7.301, dof), port_t2(7.301, dof)
    flat_t2 = np.square(t_ref.ravel().astype(np.float64))
    band = 2 * (t_tol + t_tol * np.sqrt(flat_t2)) * np.sqrt(flat_t2) + abs(t2a - t2b)
    near = np.abs(flat_t2 - min(t2a, t2b)) <= band + 1e-6
    sure = set(np.nonzero((flat_t2 >= max(t2a, t2b)) & ~near)[0].tolist())
    ref_idx = set(ref_out["hit_idx"][ref_out["hit_idx"] >= 0].tolist())
    port_idx = set(out["hit_idx"][out["hit_idx"] >= 0].tolist())
    assert sure <= ref_idx and sure <= port_idx
    assert (ref_idx ^ port_idx) <= set(np.nonzero(near)[0].tolist())
    assert (out["hit_idx"] >= 0).sum() == min(int(out["screen_count"]), out["hit_idx"].size)
    # ascending, -1 padded
    live = out["hit_idx"][out["hit_idx"] >= 0]
    assert np.all(np.diff(live) > 0)
    for i, idx in enumerate(out["hit_idx"]):
        if idx >= 0:
            assert out["hit_t"][i] == out["t"][:m].ravel()[idx]
            assert out["hit_r"][i] == out["r"][:m].ravel()[idx]


def test_sparse_buffer_overflow_is_truncated_first_k(scan_inputs):
    """A capacity smaller than the survivors keeps the first-K lanes in
    row-major order and reports the exact total (the host then falls back)."""
    from repro_torch.core.association import SparseEpilogue, sparse_epilogue_outputs

    t = torch.tensor([[3.0, 0.0, 5.0], [0.0, 4.0, 6.0]])
    out = sparse_epilogue_outputs(t * 0.1, t, 10.0, SparseEpilogue(7.3, 1.0, 2))
    assert out["hit_idx"].tolist() == [0, 2]
    assert int(out["screen_count"]) == 4


def test_argmax_takes_first_index_on_ties():
    """Winners are the first marker on exact t^2 ties, as in the reference."""
    from repro_torch.core.association import SparseEpilogue, sparse_epilogue_outputs

    t = torch.tensor([[1.0, -2.0], [-1.0, 2.0], [1.0, 0.5]])
    out = sparse_epilogue_outputs(t * 0.1, t, 10.0, SparseEpilogue(7.3, 100.0, 64))
    assert out["batch_best_row"].tolist() == [0, 0]
    dense = engines._dense_best_and_hits(torch.zeros_like(t), t, 7.3)
    assert dense["batch_best_row"].tolist() == [0, 0]


def test_host_batch_from_reference_copies_bytes(scan_inputs):
    source, y, n_cov, batches = scan_inputs
    ctx = ref_engines.EngineContext(
        n_samples=source.n_samples, n_covariates=n_cov, options=RefOptions(),
        genotype_staging="dense", **BLOCKS,
    )
    hb = ref_engines.get_engine("fused").prepare_batch(source, batches[2], ctx)
    port = engines.host_batch_from_reference(hb)
    assert port.batch.lo == hb.batch.lo and port.batch.hi == hb.batch.hi
    for a, b in zip(port.device_args, hb.device_args):
        assert a is not b
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.host_valid, hb.host_valid)
    np.testing.assert_array_equal(port.host_maf, hb.host_maf)


def test_lmm_engine_refused():
    """The mixed-model engine refuses what it does not support: a sharding
    mode other than mp, the multivariate screen, an unknown epilogue, and a
    step before its per-scan setup."""
    engine = engines.get_engine("lmm")
    ctx = engines.EngineContext(n_samples=10, n_covariates=0, options=AssocOptions(),
                                device=torch.device("cpu"))
    for bad, match in ((dict(mode="sample"), "sharding"),
                       (dict(multivariate=True), "multivariate"),
                       (dict(lmm_epilogue="pallas"), "epilogue")):
        with pytest.raises(ValueError, match=match):
            engine.validate(engines.EngineContext(**{**ctx.__dict__, **bad}))
    with pytest.raises(RuntimeError, match="setup_scan"):
        engine.build_step(ctx)
