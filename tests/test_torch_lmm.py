"""The mixed-model slice of the port against the reference package, on the
same seeded inputs (the structured cohort of tests/test_oracle.py: N=150,
M=110 in a ragged 3-shard fileset, P=4):

  * modules — streamed GRM (full and LOCO, both estimators, rtol 1e-5), the
    spectrum against numpy (1e-10), ``rotate_panel`` bitwise on the same
    ``(s, u)``, KING kinship and the relatedness exclusion;
  * the step — ``build_lmm_step`` against the reference step on the same
    ``(g_raw, rotation, qhat, y)`` for both epilogues, sparse and dense
    p-value modes, packed and dense input: r 2e-5, t 2e-4;
  * the whole slice — ``gwas scan --engine lmm --lmm-epilogue fused
    --device cpu`` against the reference CLI, with REML, with and without
    ``--loco``: the same hits outside +/-0.05 of the threshold, t 5e-4,
    nlp 5e-3 rel / 1e-2 abs, ``lmm.h2`` 1e-3 rel, the same scopes;
  * the port's own identities, bitwise — sparse == dense epilogue, blocked
    == unblocked, packed == dense staging — and the checkpoint refusing a
    resume against another GRM.
"""
import json
import os

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import engines as ref_engines  # noqa: E402
from repro.core import grm as ref_grm  # noqa: E402
from repro.core import kinship as ref_kinship  # noqa: E402
from repro.core import lmm as ref_lmm  # noqa: E402
from repro.core.association import AssocOptions as RefOptions  # noqa: E402
from repro.io import open_genotypes as ref_open  # noqa: E402
from repro.io import synth  # noqa: E402
from repro.launch.gwas import main as ref_main  # noqa: E402
from repro.runtime.prefetch import BatchPlanner  # noqa: E402
from repro_torch.api import GridSpec, LmmSpec, Study  # noqa: E402
from repro_torch.core import engines, grm, kinship, lmm  # noqa: E402
from repro_torch.core.association import AssocOptions  # noqa: E402
from repro_torch.io import open_genotypes  # noqa: E402
from repro_torch.launch.gwas import main  # noqa: E402

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)

CPU = torch.device("cpu")
THRESHOLD = 3.0      # the step's screen: some survivors, most lanes screened out
CLI_THRESHOLD = 1.0  # low enough that the small cohort has many hits to compare
BAND = 0.05
BLOCKS = dict(block_m=16, block_p=16)


@pytest.fixture(scope="module")
def lmm_cohort():
    return synth.make_structured_cohort(
        n_samples=150, n_markers=110, n_traits=4, n_covariates=2,
        n_pops=2, fst=0.15, h2=0.4, n_causal=3, effect_size=0.5, seed=23,
    )


@pytest.fixture(scope="module")
def lmm_paths(lmm_cohort, tmp_path_factory):
    stem = str(tmp_path_factory.mktemp("lmm") / "lmm")
    paths = synth.write_cohort_files(lmm_cohort, stem)
    paths["split"] = synth.write_split_plink(lmm_cohort, stem, n_shards=3)
    return paths


@pytest.fixture(scope="module")
def spectrum(lmm_paths):
    """The reference's GRM spectrum of the full cohort, for the modules that
    take ``(s, u)``."""
    k = ref_grm.stream_grm(ref_open(lmm_paths["bed"]), batch_markers=32).full()
    return ref_grm.grm_spectrum(k)


# -------------------------------------------------------------------- modules


@pytest.mark.parametrize("staging", ["packed", "dense"])
@pytest.mark.parametrize("method", ["std", "centered"])
def test_stream_grm_matches_reference(lmm_paths, method, staging):
    split = ",".join(lmm_paths["split"])
    want = ref_grm.stream_grm(ref_open(split), batch_markers=32, method=method,
                              staging=staging)
    got = grm.stream_grm(open_genotypes(split), batch_markers=32, method=method,
                         staging=staging, device="cpu")
    assert got.n_shards == want.n_shards == 3 and got.method == method
    np.testing.assert_allclose(got.shard_norms, want.shard_norms, rtol=1e-5)
    np.testing.assert_allclose(got.full(), want.full(), rtol=1e-5, atol=1e-5)
    for sid in range(3):
        np.testing.assert_allclose(got.loco(sid), want.loco(sid), rtol=1e-5, atol=1e-5)


def test_stream_grm_keep_mask_matches_reference(lmm_paths):
    keep = np.ones(150, bool)
    keep[::7] = False
    want = ref_grm.stream_grm(ref_open(lmm_paths["bed"]), keep=keep, batch_markers=32)
    got = grm.stream_grm(open_genotypes(lmm_paths["bed"]), keep=keep, batch_markers=32,
                         device="cpu")
    assert got.n_samples == want.n_samples == int(keep.sum())
    np.testing.assert_allclose(got.full(), want.full(), rtol=1e-5, atol=1e-5)


def test_grm_spectrum_matches_numpy(lmm_paths):
    k = grm.stream_grm(open_genotypes(lmm_paths["bed"]), batch_markers=32, device="cpu").full()
    s, u = grm.grm_spectrum(k, device="cpu")
    s_np, _ = np.linalg.eigh(k)
    assert s.dtype == u.dtype == np.float64 and u.shape == k.shape
    assert np.all(np.diff(s) >= 0) and np.all(s >= 0)
    np.testing.assert_allclose(s, np.maximum(s_np, 0.0), rtol=1e-10, atol=1e-10 * s_np.max())
    # reconstruction up to the clipped negative (roundoff) eigenvalues
    clipped = float(np.abs(np.minimum(s_np, 0.0)).max())
    np.testing.assert_allclose((u * s) @ u.T, k, atol=1e-10 * s_np.max() + clipped)
    np.testing.assert_allclose(u.T @ u, np.eye(k.shape[0]), atol=1e-10)
    # rank-deficient (N > M): the clipped null space hashes like numpy's
    assert grm.spectrum_fingerprint({-1: s}) == ref_grm.spectrum_fingerprint(
        {-1: np.maximum(s_np, 0.0)})


@pytest.mark.parametrize("delta", [None, 1.5])
def test_rotate_panel_bitwise_on_the_same_spectrum(lmm_cohort, spectrum, delta):
    s, u = spectrum
    want = ref_lmm.rotate_panel(lmm_cohort.phenotypes, lmm_cohort.covariates, s, u, delta=delta)
    got = lmm.rotate_panel(lmm_cohort.phenotypes, lmm_cohort.covariates, s, u, delta=delta)
    for key in ("rotation", "qhat", "y", "trait_valid"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
    assert (got.n_covariates, got.dof, got.delta) == (want.n_covariates, want.dof, want.delta)
    if delta is None:
        for key in ("delta", "h2", "sigma_g2", "loglik"):
            assert getattr(got.reml, key).tobytes() == getattr(want.reml, key).tobytes(), key
        assert got.reml.delta_pooled == want.reml.delta_pooled
    else:
        assert got.reml is None and want.reml is None


def test_king_kinship_and_exclusion_match_reference():
    co = synth.make_cohort(n_samples=120, n_markers=300, n_traits=2, n_related_pairs=4, seed=3)
    g = co.dosages.T
    phi = kinship.king_kinship(g, block_markers=128, device="cpu")
    want = ref_kinship.king_kinship(g, block_markers=128)
    assert phi.tobytes() == want.tobytes()     # integer counts: exact in both
    keep, ids, _ = kinship.exclude_related(g, co.sample_ids, device="cpu")
    keep_ref, ids_ref, _ = ref_kinship.exclude_related(g, co.sample_ids)
    np.testing.assert_array_equal(keep, keep_ref)
    assert ids == ids_ref and (~keep).sum() >= 4


def test_study_exclude_related_matches_reference(tmp_path):
    from repro.api import Study as RefStudy

    co = synth.make_cohort(n_samples=120, n_markers=300, n_traits=2, n_related_pairs=4, seed=3)
    files = synth.write_cohort_files(co, str(tmp_path / "rel"))
    ref = RefStudy.from_files(files["bed"], files["pheno"], files["cov"], exclude_related=True)
    got = Study.from_files(files["bed"], files["pheno"], files["cov"], exclude_related=True,
                           device="cpu")
    assert got.excluded_samples == ref.excluded_samples > 0
    np.testing.assert_array_equal(got.keep, ref.keep)
    np.testing.assert_array_equal(got.phenotypes, ref.phenotypes)
    # the excluded study runs the mixed model on the kept samples
    session = got.plan(engine="lmm", lmm=LmmSpec(delta=1.0), grid=GridSpec(batch_markers=128),
                       device="cpu").run()
    assert session.n_samples == 120 - got.excluded_samples
    assert session.prepared.ctx.genotype_staging == "dense"
    list(session.events())


# ----------------------------------------------------------------------- step


@pytest.fixture(scope="module")
def step_inputs(lmm_cohort, lmm_paths, spectrum):
    s, u = spectrum
    panel = ref_lmm.rotate_panel(lmm_cohort.phenotypes, lmm_cohort.covariates, s, u, delta=1.5)
    source = ref_open(lmm_paths["bed"])
    return source, panel, BatchPlanner(48).plan(source)   # 48 + 48 + 14 markers


@pytest.mark.parametrize("staging", ["packed", "dense"])
@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("epilogue", ["fused", "dense"])
def test_lmm_step_matches_reference(step_inputs, epilogue, sparse, staging):
    source, panel, batches = step_inputs
    n = source.n_samples
    kw = dict(n_samples=n, n_covariates=panel.n_covariates, hit_threshold=THRESHOLD,
              epilogue=epilogue, sparse_epilogue=sparse, packed_input=staging == "packed",
              **BLOCKS)
    ctx = ref_engines.EngineContext(n_samples=n, n_covariates=panel.n_covariates,
                                    options=RefOptions(), genotype_staging=staging)
    engine = ref_engines.get_engine("lmm")
    survivors = 0
    for batch in (batches[0], batches[-1]):   # a full and a ragged batch
        hb = engine.prepare_batch(source, batch, ctx)
        want = ref_engines.build_lmm_step(options=RefOptions(), **kw)(
            jnp.asarray(hb.device_args[0]), jnp.asarray(panel.rotation),
            jnp.asarray(panel.qhat), jnp.asarray(panel.y))
        want = {k: np.asarray(v) for k, v in want.items()}
        got = engines.build_lmm_step(options=AssocOptions(), **kw)(
            torch.from_numpy(np.array(hb.device_args[0])), torch.from_numpy(panel.rotation),
            torch.from_numpy(panel.qhat), torch.from_numpy(panel.y))
        got = {k: v.numpy() for k, v in got.items()}
        assert set(got) == set(want)
        np.testing.assert_allclose(got["r"], want["r"], atol=2e-5)
        np.testing.assert_allclose(got["t"], want["t"], rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_allclose(got["maf"], want["maf"], rtol=1e-6)
        np.testing.assert_allclose(got["batch_best_t"], want["batch_best_t"],
                                   rtol=2e-4, atol=2e-4)
        if not sparse:
            np.testing.assert_allclose(got["nlp"], want["nlp"], rtol=2e-3, atol=5e-3)
            continue
        # the same survivors wherever t^2 is not within the t tolerance of
        # the screen (each package inverts the threshold on its own)
        t2 = np.square(want["t"].astype(np.float64)).ravel()
        from repro.core.stats import t2_screen_threshold

        cut = t2_screen_threshold(THRESHOLD, n - 2 - panel.n_covariates)
        near = np.abs(np.sqrt(t2) - np.sqrt(cut)) <= 1e-3 * np.sqrt(cut)
        got_idx = set(got["hit_idx"][got["hit_idx"] >= 0].tolist())
        want_idx = set(want["hit_idx"][want["hit_idx"] >= 0].tolist())
        assert (got_idx ^ want_idx) <= set(np.nonzero(near)[0].tolist())
        assert int(got["screen_count"]) == len(got_idx)
        live = got["hit_idx"][got["hit_idx"] >= 0]
        np.testing.assert_array_equal(got["hit_t"][: live.size], got["t"].ravel()[live])
        survivors += len(want_idx)
    assert sparse is False or survivors > 0


def test_lmm_engine_refuses_unsupported_combinations(lmm_paths):
    study = Study.from_files(lmm_paths["bed"], lmm_paths["pheno"], lmm_paths["cov"],
                             device="cpu")
    with pytest.raises(ValueError, match="sharding"):
        study.plan(engine="lmm", mode="sample", device="cpu").prepare()
    with pytest.raises(ValueError, match="fileset"):
        study.plan(engine="lmm", lmm=LmmSpec(loco=True), device="cpu").prepare()
    with pytest.raises(RuntimeError, match="setup_scan"):
        engines.get_engine("lmm").build_step(engines.EngineContext(
            n_samples=150, n_covariates=2, options=AssocOptions(), device=CPU))


# ------------------------------------------------------------------ the slice


def _read_tsv(path):
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        return header, [line.rstrip("\n").split("\t") for line in f]


def _hits(out_dir):
    _, rows = _read_tsv(os.path.join(out_dir, "hits.tsv"))
    return {(m, t): tuple(float(v) for v in rest) for m, t, *rest in rows}


def _summary(out_dir):
    with open(os.path.join(out_dir, "summary.json")) as f:
        return json.load(f)


def _argv(paths, out_dir, *extra):
    return ["scan", "--genotypes", ",".join(paths["split"]), "--pheno", paths["pheno"],
            "--covar", paths["cov"], "--out", out_dir, "--engine", "lmm",
            "--lmm-epilogue", "fused", "--batch-markers", "32", "--block-p", "2",
            "--hit-threshold", str(CLI_THRESHOLD), *extra]


def _port(paths, out_dir, *extra):
    main(_argv(paths, out_dir, "--device", "cpu", "--writer", "tsv,npz", *extra))
    return _summary(out_dir)


@pytest.fixture(scope="module")
def port_runs(lmm_paths, tmp_path_factory):
    """The port's uninterrupted CLI runs, with and without LOCO."""
    out = {}
    for name, extra in (("reml", ()), ("loco", ("--loco",))):
        d = str(tmp_path_factory.mktemp(f"port_{name}"))
        _port(lmm_paths, d, *extra)
        out[name] = d
    return out


@pytest.mark.parametrize("name,extra", [("reml", ()), ("loco", ("--loco",))])
def test_cli_lmm_fused_matches_reference(lmm_cohort, lmm_paths, port_runs, tmp_path, name,
                                         extra):
    ref_dir = str(tmp_path / "ref")
    ref_main(_argv(lmm_paths, ref_dir, *extra))
    got_dir = port_runs[name]
    got, want = _summary(got_dir), _summary(ref_dir)
    assert got["device"] == "cpu" and got["engine"] == "lmm"
    assert got["dof"] == want["dof"] == 150 - 2 - 2
    assert got["lmm"]["scopes"] == want["lmm"]["scopes"] == (3 if extra else 1)
    assert got["lmm"]["loco"] == want["lmm"]["loco"] == bool(extra)
    # h2 is REML's, rounded to 4 decimals in summary.json by both packages
    h_got, h_want = np.asarray(got["lmm"]["h2_per_trait"]), np.asarray(want["lmm"]["h2_per_trait"])
    assert np.all(np.abs(h_got - h_want) <= 1e-3 * np.abs(h_want) + 1e-4), (h_got, h_want)
    hits_got, hits_want = _hits(got_dir), _hits(ref_dir)
    for a, b in ((hits_got, hits_want), (hits_want, hits_got)):
        missing = [k for k, v in a.items() if v[2] >= CLI_THRESHOLD + BAND and k not in b]
        assert not missing, missing
    common = set(hits_got) & set(hits_want)
    assert len(common) >= 20
    for k in common:
        (_, t1, n1), (_, t2, n2) = hits_got[k], hits_want[k]
        assert abs(t1 - t2) <= 5e-4 + 5e-4 * abs(t2) + 1e-4, (k, t1, t2)   # + TSV rounding
        assert abs(n1 - n2) <= 1e-2 + 5e-3 * abs(n2) + 1e-3, (k, n1, n2)
    # the planted effects surface
    for m, t, _ in lmm_cohort.effects:
        assert (lmm_cohort.marker_ids[m], f"trait{t}") in hits_got


def _assert_bitwise_same(a_dir, b_dir):
    names = sorted(f for f in os.listdir(a_dir) if f != "summary.json")
    assert names == sorted(f for f in os.listdir(b_dir) if f != "summary.json")
    for name in names:
        pa, pb = os.path.join(a_dir, name), os.path.join(b_dir, name)
        if name.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype
                    assert za[k].tobytes() == zb[k].tobytes(), (name, k)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name
    assert _summary(a_dir)["lambda_gc"] == _summary(b_dir)["lambda_gc"]


@pytest.mark.parametrize(
    "variant",
    [["--no-sparse-epilogue"], ["--trait-block", "2"], ["--genotype-staging", "dense"]],
    ids=["sparse-vs-dense-epilogue", "blocked-vs-unblocked", "packed-vs-dense-staging"],
)
def test_port_lmm_identities_bitwise(lmm_paths, port_runs, tmp_path, variant):
    out = str(tmp_path / "variant")
    summary = _port(lmm_paths, out, "--loco", *variant)
    if "--trait-block" in variant:
        assert summary["trait_blocks"] == 2
    _assert_bitwise_same(out, port_runs["loco"])


def test_lmm_checkpoint_refuses_another_grm(lmm_paths, tmp_path):
    """Resuming against other variance components (hence another rotation)
    is refused; the identical scan resumes, replaying every cell."""
    ck = str(tmp_path / "ck")
    study = Study.from_files(lmm_paths["bed"], lmm_paths["pheno"], lmm_paths["cov"],
                             device="cpu")

    def plan(delta):
        return study.plan(engine="lmm", lmm=LmmSpec(delta=delta),
                          grid=GridSpec(batch_markers=64, block_p=16), checkpoint_dir=ck,
                          device="cpu")

    first = plan(1.0).run()
    n_cells = len(list(first.events()))
    again = plan(1.0).run()
    assert len(list(again.events())) == n_cells
    assert again.metrics.summary()["replayed_cells"] == n_cells
    with pytest.raises(ValueError, match="different scan"):
        plan(2.0).run()


# ---------------------------------------------------------------- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lmm fused epilogue runs CUDA C++ kernels")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("sparse", [True, False])
def test_cuda_lmm_step_matches_cpu_and_launches_its_kernel(step_inputs, sparse):
    from repro_torch.kernels import tstat as ts

    dev = _cuda()
    source, panel, batches = step_inputs
    n = source.n_samples
    step_kw = dict(n_samples=n, n_covariates=panel.n_covariates, options=AssocOptions(),
                   hit_threshold=THRESHOLD, epilogue="fused", sparse_epilogue=sparse,
                   packed_input=True, **BLOCKS)
    ctx = ref_engines.EngineContext(n_samples=n, n_covariates=panel.n_covariates,
                                    options=RefOptions(), genotype_staging="packed")
    hb = ref_engines.get_engine("lmm").prepare_batch(source, batches[0], ctx)
    args = [torch.from_numpy(np.array(a)) for a in
            (hb.device_args[0], panel.rotation, panel.qhat, panel.y)]
    want = engines.build_lmm_step(**step_kw)(*args)
    before = (ts.tstat_launches, ts.screen_launches)
    got = engines.build_lmm_step(**step_kw)(*[a.to(dev) for a in args])
    torch.cuda.synchronize()
    after = (ts.tstat_launches, ts.screen_launches)
    assert after == ((before[0], before[1] + 1) if sparse else (before[0] + 1, before[1]))
    np.testing.assert_allclose(got["r"].cpu().numpy(), want["r"].numpy(), atol=2e-5)
    np.testing.assert_allclose(got["t"].cpu().numpy(), want["t"].numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_cuda_grm_spectrum_and_kinship_match_cpu(lmm_paths, lmm_cohort):
    dev = _cuda()
    src = open_genotypes(lmm_paths["bed"])
    k = grm.stream_grm(src, batch_markers=32, device=dev).full()
    k_cpu = grm.stream_grm(src, batch_markers=32, device="cpu").full()
    np.testing.assert_allclose(k, k_cpu, rtol=1e-5, atol=1e-5)
    s, u = grm.grm_spectrum(k, device=dev)
    s_cpu, _ = grm.grm_spectrum(k, device="cpu")
    np.testing.assert_allclose(s, s_cpu, rtol=1e-10, atol=1e-10 * s_cpu.max())
    g = lmm_cohort.dosages.T
    assert np.array_equal(kinship.king_kinship(g, device=dev),
                          kinship.king_kinship(g, device="cpu"))
