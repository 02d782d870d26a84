"""The port's ``GenomeScan`` shim (``repro_torch.core.screening``) on the
ragged 3-shard fileset of tests/test_shim_golden.py (N=500, M=300 in shards
of 100, P=16, a blocked 2-D grid), on the CPU: it must reproduce that
file's golden table for all three engines, at that file's rounding (best
-log10 p 1e-3, hit -log10 p sum 1e-2, MAF sum and lambda_gc 1e-3, indices
exact).  Also: the streamed writers agree with the shim, a swapped ``_step``
(the monolithic dense step) gives the same result bitwise, and the shim's
multivariate screen runs on the dense engine and is refused on the fused
one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import GridSpec, LmmSpec, Study, TsvWriter
from repro_torch.core.engines import build_dense_step
from repro_torch.core.screening import GenomeScan, ScanConfig
from repro_torch.io import open_genotypes, synth

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)

# Copied from tests/test_shim_golden.py (GOLDEN, captured on the JAX
# package's pre-redesign scan loop): engine -> summary of hits/best/QC/lambda
# on the fixture below.
GOLDEN = {
    "dense": {
        "best_nlp": [23.9688, 25.2223, 28.0233, 20.8547, 24.7267, 24.3832,
                     22.756, 29.8587, 5.2958, 1.7119, 2.5333, 2.6408,
                     3.0878, 2.4077, 2.6485, 2.7077],
        "best_marker": [116, 278, 263, 155, 122, 86, 17, 133, 257, 290,
                        189, 99, 253, 156, 299, 89],
        "n_hits": 10,
        "hits_marker_sum": 1493,
        "hits_trait_sum": 40,
        "hits_nlp_sum": 209.332,
        "maf_sum": 82.9204,
        "n_valid": 300,
        "lambda_gc": 1.3209,
        "dof": 498,
    },
    "fused": {
        "best_nlp": [23.9688, 25.2223, 28.0233, 20.8547, 24.7267, 24.3832,
                     22.756, 29.8587, 5.2958, 1.7119, 2.5333, 2.6408,
                     3.0878, 2.4077, 2.6485, 2.7077],
        "best_marker": [116, 278, 263, 155, 122, 86, 17, 133, 257, 290,
                        189, 99, 253, 156, 299, 89],
        "n_hits": 10,
        "hits_marker_sum": 1493,
        "hits_trait_sum": 40,
        "hits_nlp_sum": 209.332,
        "maf_sum": 82.9204,
        "n_valid": 300,
        "lambda_gc": 1.3209,
        "dof": 498,
    },
    "lmm": {
        "best_nlp": [23.65, 23.8221, 30.0065, 20.3694, 26.0932, 22.9383,
                     22.8679, 27.3632, 6.4209, 2.4792, 2.9346, 3.0886,
                     3.5512, 2.6117, 3.0704, 2.8654],
        "best_marker": [116, 278, 263, 155, 122, 86, 17, 133, 257, 290,
                        215, 99, 253, 123, 299, 89],
        "n_hits": 10,
        "hits_marker_sum": 1493,
        "hits_trait_sum": 40,
        "hits_nlp_sum": 208.262,
        "maf_sum": 82.9204,
        "n_valid": 300,
        "lambda_gc": 1.3095,
        "dof": 496,
    },
}

ENGINE_EXTRAS = {
    "dense": {},
    "fused": {},
    "lmm": {"lmm_delta": 1.0, "loco": True},
}
GRID = dict(batch_markers=64, trait_block=8, block_m=32, block_n=128, block_p=8)


@pytest.fixture(scope="module")
def ragged_source(tmp_path_factory):
    cohort = synth.make_cohort(
        n_samples=500, n_markers=300, n_traits=16, n_covariates=2,
        n_causal=8, effect_size=0.5, missing_rate=0.01, seed=97,
    )
    stem = str(tmp_path_factory.mktemp("shim_golden") / "cohort")
    beds = synth.write_split_plink(cohort, stem, n_shards=3)
    return cohort, open_genotypes(",".join(beds))


def _config(engine, **kw):
    return ScanConfig(engine=engine, hit_threshold_nlp=4.0, device="cpu",
                      **GRID, **ENGINE_EXTRAS[engine], **kw)


@pytest.mark.parametrize("engine", ["dense", "fused", "lmm"])
def test_port_shim_reproduces_goldens(ragged_source, engine):
    cohort, src = ragged_source
    assert src.n_shards == 3
    res = GenomeScan(src, cohort.phenotypes, cohort.covariates, config=_config(engine)).run()
    order = np.lexsort((res.hits[:, 1], res.hits[:, 0]))
    hits, hstats = res.hits[order], res.hit_stats[order]
    g = GOLDEN[engine]
    np.testing.assert_allclose(res.best_nlp, g["best_nlp"], atol=1e-3)
    np.testing.assert_array_equal(res.best_marker, g["best_marker"])
    assert len(hits) == g["n_hits"]
    assert int(hits[:, 0].sum()) == g["hits_marker_sum"]
    assert int(hits[:, 1].sum()) == g["hits_trait_sum"]
    assert float(hstats[:, 2].sum()) == pytest.approx(g["hits_nlp_sum"], abs=1e-2)
    assert float(res.maf.sum()) == pytest.approx(g["maf_sum"], abs=1e-3)
    assert int(res.valid.sum()) == g["n_valid"]
    assert res.lambda_gc == pytest.approx(g["lambda_gc"], abs=1e-3)
    assert res.dof == g["dof"]
    assert res.omnibus_nlp is None


@pytest.mark.parametrize("engine", ["dense", "fused", "lmm"])
def test_port_streamed_writers_match_goldens(ragged_source, engine, tmp_path):
    """The same fileset through the API's streaming path: the writers'
    outputs agree with the golden-pinned shim result."""
    cohort, src = ragged_source
    study = Study.from_arrays(src, cohort.phenotypes, cohort.covariates, device="cpu")
    session = study.plan(
        engine=engine, grid=GridSpec(**GRID),
        lmm=LmmSpec(delta=1.0, loco=True) if engine == "lmm" else None,
        hit_threshold_nlp=4.0, device="cpu",
    ).run()
    out = tmp_path / engine
    summary = session.stream_to(TsvWriter(str(out)))
    g = GOLDEN[engine]
    assert summary["hits"] == g["n_hits"]
    assert summary["lambda_gc"] == pytest.approx(g["lambda_gc"], abs=1e-3)
    best_lines = (out / "per_trait_best.tsv").read_text().strip().splitlines()[1:]
    got_best = [float(line.split("\t")[2]) for line in best_lines]
    np.testing.assert_allclose(got_best, g["best_nlp"], atol=2e-3)


def test_port_shim_swapped_monolithic_step_bitwise(ragged_source):
    """The port's form of the reference's
    ``test_dense_blocked_scan_equals_monolithic_step_scan``: a blocked scan
    driven by the memoized dense step equals one whose ``_step`` was swapped
    for the monolithic step, bit for bit."""
    cohort, src = ragged_source
    cfg = _config("dense")
    a = GenomeScan(src, cohort.phenotypes, cohort.covariates, config=cfg).run()
    scan_b = GenomeScan(src, cohort.phenotypes, cohort.covariates, config=cfg)
    scan_b._step = build_dense_step(
        n_samples=scan_b.n_samples,
        n_covariates=scan_b.n_covariates,
        options=cfg.options,
        hit_threshold=cfg.hit_threshold_nlp,
        trait_tile=cfg.block_p,
        split_prolog=False,
    )
    b = scan_b.run()
    for key in ("best_nlp", "best_marker", "hits", "hit_stats", "maf", "valid"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), key
    assert a.lambda_gc == b.lambda_gc


def test_port_shim_multivariate(ragged_source):
    """The omnibus track through the shim: unblocked on the dense engine it
    finds the planted markers; the fused engine refuses the flag instead of
    returning an all-zero track."""
    cohort, src = ragged_source
    cfg = dataclasses.replace(_config("dense"), multivariate=True, trait_block=0)
    res = GenomeScan(src, cohort.phenotypes, cohort.covariates, config=cfg).run()
    omni = res.omnibus_nlp
    assert omni is not None and omni.shape == (300,) and np.all(np.isfinite(omni))
    planted = sorted({m for m, _, _ in cohort.effects})
    null = np.setdiff1d(np.arange(300), planted)
    assert np.median(omni[planted]) > 5.0 and np.median(omni[null]) < 1.0
    fused = dataclasses.replace(cfg, engine="fused")
    with pytest.raises(ValueError, match="dense engine"):
        GenomeScan(src, cohort.phenotypes, cohort.covariates, config=fused)
