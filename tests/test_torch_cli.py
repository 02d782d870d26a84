"""The port's ``grm``, ``merge`` and ``report`` subcommands, and the CLI scan
paths the other files do not cover, against the reference CLI on the same
files, on the CPU (``--device cpu``):

  * ``grm --loco --spectrum``: the GRM and every LOCO GRM at PR 12's
    tolerances (rtol 1e-5, atol 1e-5); the eigenvalues against numpy on the
    port's own GRM (1e-10) and against the reference's (1e-5 of the
    largest); ``u`` held by its subspace (the projector onto the range,
    1e-6, and the reconstruction), never column by column;
  * ``merge`` of a committed checkpoint: TSVs byte-equal to the scan's own,
    and to the reference CLI's merge of the same directory;
  * ``report``: the same text as the reference's on the same directory;
  * ``scan`` on the default dense engine, on a ``.bgen`` input, and on the
    lmm engine's default (dense) epilogue: the same hits outside +/-0.05 of
    the threshold, values at the oracle tolerances (dense r 2e-5, t 2e-4,
    nlp 2e-3 rel / 5e-3 abs; lmm t 5e-4, nlp 1e-2 abs / 5e-3 rel), each plus
    the TSV's rounding, and the same QC table.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.io import synth  # noqa: E402
from repro.launch.gwas import main as ref_main  # noqa: E402
from repro_torch.launch import gwas as port_gwas  # noqa: E402
from repro_torch.launch.gwas import main  # noqa: E402

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 7.301
BAND = 0.05
# (r atol, t rtol=atol, nlp rtol, nlp atol) + the TSV's rounding (r 5 dp,
# t 4 dp, nlp 3 dp)
DENSE_TOL = (2e-5, 2e-4, 2e-3, 5e-3)
LMM_TOL = (None, 5e-4, 5e-3, 1e-2)
ROUND = (1e-5, 1e-4, 1e-3)


def _read_tsv(path):
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f]
    return header, rows


def _hits(out_dir):
    _, rows = _read_tsv(os.path.join(out_dir, "hits.tsv"))
    return {(m, t): tuple(float(v) for v in rest) for m, t, *rest in rows}


def _summary(out_dir):
    with open(os.path.join(out_dir, "summary.json")) as f:
        return json.load(f)


def _assert_scan_close(got_dir, want_dir, tol, threshold=THRESHOLD):
    tol_r, tol_t, nlp_rtol, nlp_atol = tol
    got, want = _hits(got_dir), _hits(want_dir)
    for a, b in ((got, want), (want, got)):
        missing = [k for k, v in a.items() if v[2] >= threshold + BAND and k not in b]
        assert not missing, missing
    common = set(got) & set(want)
    assert common
    for k in common:
        (r1, t1, n1), (r2, t2, n2) = got[k], want[k]
        if tol_r is not None:
            assert abs(r1 - r2) <= tol_r + ROUND[0], (k, r1, r2)
        assert abs(t1 - t2) <= tol_t + tol_t * abs(t2) + ROUND[1], (k, t1, t2)
        assert abs(n1 - n2) <= nlp_atol + nlp_rtol * abs(n2) + ROUND[2], (k, n1, n2)
    h1, best_got = _read_tsv(os.path.join(got_dir, "per_trait_best.tsv"))
    h2, best_want = _read_tsv(os.path.join(want_dir, "per_trait_best.tsv"))
    assert h1 == h2 and len(best_got) == len(best_want)
    for (tr1, m1, n1), (tr2, m2, n2) in zip(best_got, best_want):
        assert tr1 == tr2
        assert abs(float(n1) - float(n2)) <= nlp_atol + nlp_rtol * abs(float(n2)) + ROUND[2]
        if float(n2) >= threshold + BAND:
            assert m1 == m2, (tr1, m1, m2)
    with open(os.path.join(got_dir, "qc.tsv")) as f1, open(os.path.join(want_dir, "qc.tsv")) as f2:
        assert f1.read() == f2.read()
    assert abs(_summary(got_dir)["lambda_gc"] - _summary(want_dir)["lambda_gc"]) <= 1e-3


@pytest.fixture(scope="module")
def files(cohort, tmp_path_factory):
    stem = str(tmp_path_factory.mktemp("cli") / "toy")
    paths = synth.write_cohort_files(cohort, stem)
    paths["split"] = synth.write_split_plink(cohort, stem, n_shards=3)
    return paths


def _scan_argv(files, out_dir, genotypes=None, *extra):
    return ["scan", "--genotypes", genotypes or files["bed"], "--pheno", files["pheno"],
            "--covar", files["cov"], "--out", out_dir, "--batch-markers", "256", *extra]


# ------------------------------------------------------------------------ grm


@pytest.fixture(scope="module")
def grm_npz(files, tmp_path_factory):
    d = tmp_path_factory.mktemp("grm")
    argv = ["grm", "--genotypes", ",".join(files["split"]), "--loco", "--spectrum",
            "--batch-markers", "128"]
    main(argv + ["--out", str(d / "port.npz"), "--device", "cpu"])
    ref_main(argv + ["--out", str(d / "ref.npz")])
    with np.load(d / "port.npz") as p, np.load(d / "ref.npz") as r:
        return {k: p[k] for k in p.files}, {k: r[k] for k in r.files}


def test_cli_grm_matches_reference(grm_npz):
    got, want = grm_npz
    assert sorted(got) == sorted(want) == sorted(
        ["k", "shard_boundaries", "loco_0", "loco_1", "loco_2", "s", "u"])
    np.testing.assert_array_equal(got["shard_boundaries"], want["shard_boundaries"])
    for key in ("k", "loco_0", "loco_1", "loco_2"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_cli_grm_spectrum_held_by_its_subspace(grm_npz):
    got, want = grm_npz
    k, s, u = got["k"], got["s"], got["u"]
    assert s.dtype == u.dtype == np.float64 and np.all(np.diff(s) >= 0) and np.all(s >= 0)
    s_np = np.linalg.eigh(k)[0]
    np.testing.assert_allclose(s, np.maximum(s_np, 0.0), rtol=1e-10, atol=1e-10 * s_np.max())
    np.testing.assert_allclose(s, want["s"], rtol=0, atol=1e-5 * want["s"].max())
    clipped = float(np.abs(np.minimum(s_np, 0.0)).max())
    np.testing.assert_allclose((u * s) @ u.T, k, atol=1e-10 * s_np.max() + clipped)
    np.testing.assert_allclose(u.T @ u, np.eye(k.shape[0]), atol=1e-10)
    # the range of K (eigenvalues above roundoff) is one subspace in both
    rng_p = u[:, s > 1e-8 * s.max()]
    rng_r = want["u"][:, want["s"] > 1e-8 * want["s"].max()]
    assert rng_p.shape == rng_r.shape
    np.testing.assert_allclose(rng_p @ rng_p.T, rng_r @ rng_r.T, atol=1e-6)


def test_cli_grm_summary_and_loco_refusal(files, tmp_path, capsys):
    out = str(tmp_path / "g.npz")
    main(["grm", "--genotypes", files["bed"], "--out", out, "--device", "cpu",
          "--batch-markers", "256"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["samples"] == 400 and summary["markers"] == 600
    assert summary["loco_scopes"] == 0 and summary["device"] == "cpu"
    with np.load(out) as z:
        assert sorted(z.files) == ["k", "shard_boundaries"]
    with pytest.raises(SystemExit, match="per-chromosome"):
        main(["grm", "--genotypes", files["bed"], "--out", out, "--device", "cpu", "--loco"])
    if not torch.cuda.is_available():
        # the default device is the card: without one, an error
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["grm", "--genotypes", files["bed"], "--out", out])


# ---------------------------------------------------------------- merge, report


def _tsvs(out_dir):
    return {name: open(os.path.join(out_dir, name), "rb").read()
            for name in ("hits.tsv", "per_trait_best.tsv", "qc.tsv")}


@pytest.mark.parametrize("multivariate", [False, True])
def test_cli_merge_equals_the_scan(files, tmp_path, multivariate):
    extra = ("--multivariate",) if multivariate else ("--trait-block", "4", "--block-p", "4")
    scan_dir, ck = str(tmp_path / "scan"), str(tmp_path / "ck")
    main(_scan_argv(files, scan_dir, None, "--device", "cpu", "--checkpoint-dir", ck, *extra))
    merged = str(tmp_path / "merged")
    main(["merge", "--checkpoint-dir", ck, "--out", merged, "--genotypes", files["bed"],
          "--pheno", files["pheno"]])
    assert _tsvs(merged) == _tsvs(scan_dir)
    got = _summary(merged)
    assert got["complete"] and got["hits"] == _summary(scan_dir)["hits"]
    assert got["lambda_gc"] == _summary(scan_dir)["lambda_gc"]
    header = open(os.path.join(merged, "qc.tsv")).readline()
    assert ("omnibus_neglog10p" in header) == multivariate


def test_cli_merge_of_a_reference_checkpoint_matches_reference_merge(files, tmp_path):
    ck = str(tmp_path / "ck")
    ref_main(_scan_argv(files, str(tmp_path / "scan"), None, "--checkpoint-dir", ck,
                        "--engine", "fused"))
    argv = ["merge", "--checkpoint-dir", ck, "--genotypes", files["bed"],
            "--pheno", files["pheno"]]
    main(argv + ["--out", str(tmp_path / "port")])
    ref_main(argv + ["--out", str(tmp_path / "ref")])
    assert _tsvs(str(tmp_path / "port")) == _tsvs(str(tmp_path / "ref"))
    assert _summary(str(tmp_path / "port")) == _summary(str(tmp_path / "ref"))


@pytest.fixture(scope="module")
def dense_runs(files, tmp_path_factory):
    """The default (dense) engine: the port's CLI and the reference's."""
    port = str(tmp_path_factory.mktemp("port_dense"))
    ref = str(tmp_path_factory.mktemp("ref_dense"))
    main(_scan_argv(files, port, None, "--device", "cpu"))
    ref_main(_scan_argv(files, ref))
    return port, ref


@pytest.mark.parametrize("top", ["20", "3"])
def test_cli_report_matches_reference(dense_runs, capsys, top):
    for out_dir in dense_runs:
        main(["report", "--out", out_dir, "--top", top])
        got = capsys.readouterr().out
        ref_main(["report", "--out", out_dir, "--top", top])
        want = capsys.readouterr().out
        assert got == want and "== top" in got


def test_cli_report_without_hits_refuses(tmp_path):
    with pytest.raises(SystemExit, match="no hits.tsv"):
        main(["report", "--out", str(tmp_path)])


def test_cli_subcommands_and_serve_refusal():
    """Every subcommand of the reference is ported, ``serve`` included; a
    ``serve`` without its cohort is refused by its parser."""
    assert port_gwas.SUBCOMMANDS == ("scan", "grm", "merge", "report", "serve")
    assert not hasattr(port_gwas, "NOT_PORTED")
    with pytest.raises(SystemExit):
        main(["serve", "--pheno", "x.tsv"])


def _marker_rows(path, lo, hi):
    """A TSV's data rows whose marker (``rs%08d``, first column) lies in
    ``[lo, hi)``, in file order."""
    with open(path) as f:
        next(f)
        return [line for line in f if lo <= int(line.split("\t", 1)[0][2:]) < hi]


def test_cli_serve_matches_cli_scan(files, tmp_path):
    """``serve --device cpu --ready-file`` as a subprocess: an upload of the
    study's own panel returns the CLI scan's tables byte for byte, and a
    window query returns the scan's hit and QC rows of the covered markers;
    ``POST /shutdown`` ends the process with 0."""
    import subprocess
    import sys

    from repro_torch.api import Study
    from repro_torch.serve import ServeClient

    grid = ["--batch-markers", "256", "--trait-block", "4", "--block-p", "4",
            "--hit-threshold", "2.0"]
    scan_out = str(tmp_path / "scan")
    main(["scan", "--genotypes", files["bed"], "--pheno", files["pheno"], "--covar",
          files["cov"], "--out", scan_out, "--device", "cpu", *grid])
    ready = tmp_path / "ready"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gwas", "serve", "--genotypes", files["bed"],
         "--pheno", files["pheno"], "--covar", files["cov"], "--device", "cpu", *grid,
         "--ready-file", str(ready), "--out-root", str(tmp_path / "served")],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.time() + 120
        while not ready.exists() and proc.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        assert ready.exists(), proc.stderr.read() if proc.poll() is not None else "no boot"
        host, port = ready.read_text().split()
        client = ServeClient(host, int(port), timeout=60.0)
        study = Study.from_files(files["bed"], files["pheno"], files["cov"], device="cpu")
        pid = client.scan_panel("default", np.asarray(study.phenotypes), study.trait_names)
        wid = client.scan_window("default", 300, 400)
        client.wait(pid, timeout=300)
        lo, hi = client.wait(wid, timeout=300)["covered"]
        assert (lo, hi) == (256, 512)
        for name in ("hits.tsv", "per_trait_best.tsv", "qc.tsv"):
            with open(os.path.join(scan_out, name), "rb") as f:
                assert client.fetch(pid, name) == f.read(), name
            client.fetch_to(wid, name, str(tmp_path / f"w_{name}"))
        for name in ("hits.tsv", "qc.tsv"):
            got = _marker_rows(tmp_path / f"w_{name}", lo, hi)
            assert got and got == _marker_rows(os.path.join(scan_out, name), lo, hi), name
        assert client.shutdown() == {"ok": True}
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    lines = [json.loads(line) for line in out.splitlines()]
    assert lines[0]["serving"]["device"] == "cpu" and lines[0]["serving"]["prepare_s"] > 0
    assert lines[-1] == {"stopped": {"requests": {"done": 2}}}


# ---------------------------------------------------------------- scan parity


def test_cli_dense_default_engine_matches_reference(dense_runs, cohort):
    port, ref = dense_runs
    got = _summary(port)
    assert got["engine"] == "dense" and got["device"] == "cpu"
    _assert_scan_close(port, ref, DENSE_TOL)
    hits = _hits(port)
    for m, t, _ in cohort.effects:
        assert (cohort.marker_ids[m], f"trait{t}") in hits


def test_cli_bgen_input_matches_reference(files, tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    main(_scan_argv(files, port, files["bgen"], "--device", "cpu"))
    ref_main(_scan_argv(files, ref, files["bgen"]))
    assert _summary(port)["genotype_staging"] == "dense"   # BGEN has no 2-bit layout
    _assert_scan_close(port, ref, DENSE_TOL)


@pytest.fixture(scope="module")
def lmm_paths(tmp_path_factory):
    cohort = synth.make_structured_cohort(
        n_samples=150, n_markers=110, n_traits=4, n_covariates=2,
        n_pops=2, fst=0.15, h2=0.4, n_causal=3, effect_size=0.5, seed=23,
    )
    stem = str(tmp_path_factory.mktemp("lmm") / "lmm")
    paths = synth.write_cohort_files(cohort, stem)
    paths["split"] = synth.write_split_plink(cohort, stem, n_shards=3)
    return paths


def test_cli_lmm_dense_epilogue_matches_reference(lmm_paths, tmp_path):
    """``--engine lmm`` with its default (dense) epilogue and REML."""
    threshold = 1.0
    argv = ["scan", "--genotypes", ",".join(lmm_paths["split"]), "--pheno", lmm_paths["pheno"],
            "--covar", lmm_paths["cov"], "--engine", "lmm", "--batch-markers", "32",
            "--block-p", "2", "--hit-threshold", str(threshold), "--loco"]
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    main(argv + ["--out", port, "--device", "cpu"])
    ref_main(argv + ["--out", ref])
    got, want = _summary(port), _summary(ref)
    assert got["lmm"]["scopes"] == want["lmm"]["scopes"] == 3
    h_got, h_want = np.asarray(got["lmm"]["h2_per_trait"]), np.asarray(want["lmm"]["h2_per_trait"])
    assert np.all(np.abs(h_got - h_want) <= 1e-3 * np.abs(h_want) + 1e-4), (h_got, h_want)
    _assert_scan_close(port, ref, LMM_TOL, threshold=threshold)
