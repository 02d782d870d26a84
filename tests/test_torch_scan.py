"""The slice as a whole: ``gwas scan --engine fused`` through the port's CLI
(``--device cpu``) against the reference package on the same files, the
port's internal bitwise identities, resuming a checkpoint the reference
wrote, and the port's import hygiene."""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.api import GridSpec as RefGridSpec  # noqa: E402
from repro.api import Study as RefStudy  # noqa: E402
from repro.api import TsvWriter as RefTsvWriter  # noqa: E402
from repro.io import synth  # noqa: E402
from repro_torch.api import GridSpec, Study, TsvWriter  # noqa: E402
from repro_torch.launch.gwas import main  # noqa: E402

# The suite runs several worker processes at once; PyTorch's intra-op pool
# (one thread per core in each) would oversubscribe the cores for no gain
# at these sizes.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 7.301
BAND = 0.05
# fused-engine oracle tolerances (tests/test_oracle.py)
R_TOL, T_TOL, NLP_RTOL, NLP_ATOL = 5e-5, 5e-4, 5e-3, 1e-2


def _read_tsv(path):
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f]
    return header, rows


def _hits(out_dir):
    _, rows = _read_tsv(os.path.join(out_dir, "hits.tsv"))
    return {(m, t): tuple(float(v) for v in rest) for m, t, *rest in rows}


def _close(a, b, atol, rtol=0.0):
    return abs(a - b) <= atol + rtol * abs(b)


def _assert_outputs_close(got_dir, want_dir):
    """Same hit set outside the +/-band, values at the fused oracle
    tolerances, same QC table, lambda_gc within 1e-3."""
    got, want = _hits(got_dir), _hits(want_dir)
    for a, b in ((got, want), (want, got)):
        missing = [k for k, v in a.items() if v[2] >= THRESHOLD + BAND and k not in b]
        assert not missing, missing
    common = set(got) & set(want)
    assert common
    for k in common:
        (r1, t1, n1), (r2, t2, n2) = got[k], want[k]
        assert _close(r1, r2, R_TOL + 1e-5), (k, r1, r2)        # + TSV rounding (5 dp)
        assert _close(t1, t2, T_TOL + 1e-4, T_TOL), (k, t1, t2)  # (4 dp)
        assert _close(n1, n2, NLP_ATOL + 1e-3, NLP_RTOL), (k, n1, n2)
    h1, best_got = _read_tsv(os.path.join(got_dir, "per_trait_best.tsv"))
    h2, best_want = _read_tsv(os.path.join(want_dir, "per_trait_best.tsv"))
    assert h1 == h2 and len(best_got) == len(best_want)
    for (tr1, m1, n1), (tr2, m2, n2) in zip(best_got, best_want):
        assert tr1 == tr2
        assert _close(float(n1), float(n2), NLP_ATOL + 1e-3, NLP_RTOL), (tr1, n1, n2)
        if float(n2) >= THRESHOLD + BAND:
            assert m1 == m2, (tr1, m1, m2)
    with open(os.path.join(got_dir, "qc.tsv")) as f1, open(os.path.join(want_dir, "qc.tsv")) as f2:
        assert f1.read() == f2.read()
    lam = [json.load(open(os.path.join(d, "summary.json")))["lambda_gc"]
           if os.path.exists(os.path.join(d, "summary.json")) else None
           for d in (got_dir, want_dir)]
    if None not in lam:
        assert abs(lam[0] - lam[1]) <= 1e-3, lam


def _reference_scan(files, out_dir, **plan_kwargs):
    study = RefStudy.from_files(files["bed"], files["pheno"], files["cov"])
    plan = study.plan(engine="fused", grid=RefGridSpec(batch_markers=256), **plan_kwargs)
    summary = plan.run().stream_to(RefTsvWriter(out_dir))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"lambda_gc": summary["lambda_gc"], "hits": summary["hits"]}, f)
    return summary


def _port_cli(files, out_dir, *extra):
    main(["scan", "--genotypes", files["bed"], "--pheno", files["pheno"],
          "--covar", files["cov"], "--out", out_dir, "--device", "cpu",
          "--batch-markers", "256", "--writer", "tsv,npz", *extra])
    with open(os.path.join(out_dir, "summary.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def reference_out(cohort_files, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref_fused"))
    _reference_scan(cohort_files, out)
    return out


@pytest.fixture(scope="module")
def wide_files(tmp_path_factory):
    """P > 256 traits, so --trait-block 256 makes a 2-block grid."""
    cohort = synth.make_cohort(n_samples=203, n_markers=300, n_traits=300,
                               n_covariates=2, n_causal=6, effect_size=0.8, seed=5)
    return synth.write_cohort_files(cohort, str(tmp_path_factory.mktemp("wide") / "wide"))


@pytest.fixture(scope="module")
def port_baselines(cohort_files, wide_files, tmp_path_factory):
    """Uninterrupted port scans, per (cohort, engine)."""
    out = {}
    for name, files in (("toy", cohort_files), ("wide", wide_files)):
        for engine in ("fused", "dense"):
            d = str(tmp_path_factory.mktemp(f"base_{name}_{engine}"))
            _port_cli(files, d, "--engine", engine)
            out[(name, engine)] = d
    return out


def test_cli_fused_matches_reference(cohort_files, reference_out, tmp_path, cohort):
    out = str(tmp_path / "port")
    summary = _port_cli(cohort_files, out, "--engine", "fused")
    assert summary["device"] == "cpu" and summary["engine"] == "fused"
    assert summary["genotype_staging"] == "packed"
    _assert_outputs_close(out, reference_out)
    # the planted effects surface, as in the reference
    hits = _hits(out)
    for m, t, _ in cohort.effects:
        assert (cohort.marker_ids[m], f"trait{t}") in hits


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
    la = json.load(open(os.path.join(a_dir, "summary.json")))["lambda_gc"]
    lb = json.load(open(os.path.join(b_dir, "summary.json")))["lambda_gc"]
    assert la == lb


@pytest.mark.parametrize("engine", ["fused", "dense"])
@pytest.mark.parametrize(
    "cohort_name,variant",
    [
        ("toy", ["--no-sparse-epilogue"]),
        ("toy", ["--genotype-staging", "dense"]),
        ("wide", ["--trait-block", "256"]),
        ("wide", ["--no-sparse-epilogue", "--trait-block", "256"]),
    ],
)
def test_port_identities_bitwise(cohort_name, variant, engine, port_baselines,
                                 cohort_files, wide_files, tmp_path):
    """sparse == dense epilogue, packed == dense staging, blocked == unblocked."""
    files = {"toy": cohort_files, "wide": wide_files}[cohort_name]
    out = str(tmp_path / "variant")
    summary = _port_cli(files, out, "--engine", engine, *variant)
    if "--trait-block" in variant:
        assert summary["trait_blocks"] == 2
    _assert_bitwise_same(out, port_baselines[(cohort_name, engine)])


@pytest.mark.parametrize("engine", ["fused", "dense"])
def test_resumed_equals_uninterrupted_bitwise(engine, wide_files, port_baselines, tmp_path):
    files = wide_files
    ck = str(tmp_path / "ck")

    def plan():
        study = Study.from_files(files["bed"], files["pheno"], files["cov"])
        return study.plan(engine=engine, grid=GridSpec(batch_markers=256, trait_block=0),
                          checkpoint_dir=ck, device="cpu")

    events = plan().run().events()
    next(events)            # one cell computed and committed, then the "crash"
    events.close()
    session = plan().run()
    out = str(tmp_path / "resumed")
    from repro_torch.api import NpzShardWriter

    summary = session.stream_to(TsvWriter(out), NpzShardWriter(out))
    assert session.metrics.summary()["replayed_cells"] == 1
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump({"lambda_gc": summary["lambda_gc"]}, f)
    base = port_baselines[("wide", engine)]
    _assert_bitwise_same(out, base)


def test_port_resumes_reference_checkpoint(cohort_files, reference_out, tmp_path):
    """A scan the JAX package checkpointed resumes in the port: same manifest,
    shard format and fingerprint (the port's ``device`` stays out of it)."""
    ck = str(tmp_path / "ck")
    study = RefStudy.from_files(cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"])
    events = study.plan(engine="fused", grid=RefGridSpec(batch_markers=256),
                        checkpoint_dir=ck).run().events()
    next(events)
    events.close()
    port = Study.from_files(cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"])
    session = port.plan(engine="fused", grid=GridSpec(batch_markers=256),
                        checkpoint_dir=ck, device="cpu").run()
    out = str(tmp_path / "resumed")
    summary = session.stream_to(TsvWriter(out))
    m = session.metrics.summary()
    assert m["replayed_cells"] == 1 and m["live_cells"] == session.n_batches - 1
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump({"lambda_gc": summary["lambda_gc"]}, f)
    _assert_outputs_close(out, reference_out)


def test_fingerprint_payload_matches_reference():
    from repro.api.specs import ScanConfig as RefConfig
    from repro_torch.api.specs import ScanConfig

    assert ScanConfig(device="cpu").fingerprint_payload() == RefConfig().fingerprint_payload()
    assert ScanConfig(device="cuda:3").fingerprint_payload() == RefConfig().fingerprint_payload()


def test_cuda_device_without_a_card_raises(cohort_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    study = Study.from_files(cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.plan(engine="fused").prepare()


@pytest.mark.parametrize("what", ["mesh", "multivariate"])
def test_unported_paths_raise_not_implemented(what, cohort_files, tmp_path):
    study = Study.from_files(cohort_files["bed"], cohort_files["pheno"], cohort_files["cov"])
    with pytest.raises(NotImplementedError):
        if what == "mesh":
            study.plan(engine="fused", device="cpu", mesh=object())
        elif what == "multivariate":
            study.plan(engine="dense", device="cpu", multivariate=True)


@pytest.mark.parametrize("capacity", [5, 64, 4096])
def test_sparse_epilogue_compaction_matches_reference(capacity):
    """The sparse epilogue's own compaction (``screen=None``, the fused OLS
    path's) against the reference's on the same r and t tiles: every output
    exactly equal, overflow of the capacity included."""
    from repro.core import association as ref_assoc
    from repro_torch.core import association

    rng = np.random.default_rng(capacity)
    r = rng.normal(scale=0.05, size=(300, 70)).astype(np.float32)
    r[7] = 0.0                                   # a masked marker
    r[8:].reshape(-1)[rng.choice(r[8:].size, 40, replace=False)] = 0.5
    t = (r * np.sqrt(398.0 / (1.0 - r * r))).astype(np.float32)
    t2 = 40.0
    got = association.sparse_epilogue_outputs(
        torch.from_numpy(r), torch.from_numpy(t), 398.0,
        association.SparseEpilogue(THRESHOLD, t2, capacity))
    want = ref_assoc.sparse_epilogue_outputs(
        r, t, 398.0, ref_assoc.SparseEpilogue(THRESHOLD, t2, capacity))
    assert set(got) == set(want)
    for key, value in got.items():
        w = np.asarray(want[key])
        assert value.numpy().dtype == w.dtype, key
        np.testing.assert_array_equal(value.numpy(), w, err_msg=key)
    assert int(got["screen_count"]) == 40


@pytest.mark.gpu
def test_cuda_sparse_epilogue_compacts_in_kernel():
    """On a card the sparse epilogue compacts through the screen kernel's t
    mode, once per call, with the CPU's results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compaction is a CUDA C++ kernel")
    from repro_torch.core import association
    from repro_torch.kernels import tstat as ts

    rng = np.random.default_rng(3)
    r = rng.normal(scale=0.05, size=(4096, 1024)).astype(np.float32)
    r.reshape(-1)[rng.choice(r.size, 5000, replace=False)] = 0.5
    t = (r * np.sqrt(398.0 / (1.0 - r * r))).astype(np.float32)
    plan = association.SparseEpilogue(THRESHOLD, 40.0, 4096)
    want = association.sparse_epilogue_outputs(torch.from_numpy(r), torch.from_numpy(t),
                                               398.0, plan)
    before = ts.compact_launches
    got = association.sparse_epilogue_outputs(torch.from_numpy(r).cuda(),
                                              torch.from_numpy(t).cuda(), 398.0, plan)
    torch.cuda.synchronize()
    assert ts.compact_launches == before + 1
    for key, value in got.items():
        assert torch.equal(value.cpu(), want[key]), key


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s]|$)", re.M)


def test_port_imports_neither_jax_nor_reference():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "src", "repro_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    offenders = []
    for path in paths:
        with open(path) as f:
            offenders += [(path, m.group(0).strip()) for m in _IMPORT.finditer(f.read())]
    assert not offenders, offenders
    # and at run time: importing the whole port loads neither package
    code = (
        "import sys, repro_torch.api, repro_torch.launch.gwas, repro_torch.kernels.build;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')];"
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    """Without a CUDA device, and in a directory holding only the script,
    chip_smoke.py exits non-zero and prints no result line."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone / "chip_smoke.py")
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(alone),
                           capture_output=True, text=True, timeout=120)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                                   cwd=str(tmp_path), capture_output=True, text=True,
                                   timeout=120))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
