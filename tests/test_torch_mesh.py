"""The sharding mesh on the CPU: a gloo world of 4 processes on a (2, 2)
``("data", "model")`` mesh runs the port's sharded steps and whole
``ScanPlan(mesh=)`` scans, held against the reference's ``mesh=None`` steps
(the reference's own mesh steps raise ``ShardingTypeError`` under the
installed jax) and against the port's serial scan on the same files.

One module fixture starts the world once (file-store rendezvous under
``tmp_path``, one intra-op thread per rank) and returns every rank's results
at once; the tests below read them.  Tolerances are the oracle's
(tests/test_oracle.py): dense r 2e-5, t 2e-4, nlp 2e-3 rel / 5e-3 abs; fused
5e-5 / 5e-4 / 5e-3 rel, 1e-2 abs.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core.association import AssocOptions as RefOptions  # noqa: E402
from repro.core.screening import build_dense_step as ref_dense  # noqa: E402
from repro.core.screening import build_fused_step as ref_fused  # noqa: E402
from repro.core.screening import build_lmm_step as ref_lmm  # noqa: E402
from repro_torch.api import GridSpec, LmmSpec, Study, TsvWriter  # noqa: E402
from repro_torch.kernels.gwas_dot import ops as kops  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 300
TOL = {  # (r atol, t rtol=atol, nlp rtol, nlp atol)
    "dense": (2e-5, 2e-4, 2e-3, 5e-3),
    "fused": (5e-5, 5e-4, 5e-3, 1e-2),
}
# (M, N, P): one shape that divides the (2, 2) mesh, one that does not
SHAPES = {"even": (32, 64, 8), "ragged": (37, 61, 11)}
FUSED = dict(block_m=16, block_n=32, block_p=4)
LMM = dict(block_m=8, block_p=4)
N_COV = 2
# the file scans: ragged batches (600 = 2 x 255 + 90: 255 does not divide
# over the data axis), and trait blocks 11 + 1 (12 traits): the first does
# not divide over the model axis, the second is narrower than it
SCAN_GRID = dict(batch_markers=255, trait_block=11, block_p=11)
SCANS = {
    "fused_mp": dict(engine="fused"),
    "dense_mp": dict(engine="dense"),
    "dense_sample": dict(engine="dense", mode="sample"),
    "dense_mv_mp": dict(engine="dense", multivariate=True, unblocked=True),
    "lmm_fused_mp": dict(engine="lmm", lmm=dict(epilogue="fused", delta=1.0)),
    "lmm_dense_mp": dict(engine="lmm", lmm=dict(epilogue="dense", delta=1.0)),
}
REFUSALS = ("fused_sample", "lmm_sample", "devices", "shared_fs", "packed",
            "device_mismatch", "plan_mismatch")

_CHILD = textwrap.dedent(
    r"""
    import datetime, json, os, pickle, sys, traceback
    rank, world, store, work, src = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=240))
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.api import ExecSpec, GridSpec, IOSpec, LmmSpec, Study, TsvWriter
    from repro_torch.core.association import AssocOptions
    from repro_torch.core.engines import build_dense_step, build_fused_step, build_lmm_step

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = json.load(open(os.path.join(work, "config.json")))
    res = {}

    def record(name, fn):
        try:
            res[name] = fn()
        except Exception:
            res[name] = {"error": traceback.format_exc()}

    def np_out(out):
        return {k: v.numpy() for k, v in out.items()}

    T = lambda a: torch.from_numpy(np.array(a))
    for shape in cfg["shapes"]:
        inp = dict(np.load(os.path.join(work, f"steps_{shape}.npz")))
        n = int(inp["g"].shape[1])
        for mode in ("mp", "sample"):
            for mv in (False, True):
                def dense(mode=mode, mv=mv):
                    step = build_dense_step(
                        n_samples=n, n_covariates=cfg["n_cov"],
                        options=AssocOptions(dof_mode="exact"), q_basis=T(inp["q"]),
                        multivariate=mv, n_traits_eff=float(inp["y"].shape[1]),
                        whitening=T(inp["w"]) if mv else None, trait_tile=4,
                        mesh=mesh, mode=mode)
                    out = np_out(step(T(inp["g"]), T(inp["y"])))
                    # a fresh batch tensor re-runs the prolog: the same bits
                    again = np_out(step(T(inp["g"]), T(inp["y"])))
                    out["repeat_equal"] = np.array(all(
                        np.array_equal(out[k], again[k]) for k in again))
                    return out
                record(f"dense_{mode}_{'mv' if mv else 'uni'}_{shape}", dense)

        def fused():
            step = build_fused_step(n_samples=n, n_covariates=0, options=AssocOptions(),
                                    mesh=mesh, **cfg["fused"])
            return np_out(step(T(inp["packed"]), T(inp["mean2d"]), T(inp["inv2d"]),
                               T(inp["valid"]), T(inp["y"])))
        record(f"fused_{shape}", fused)
        for epi in ("dense", "fused"):
            def lmm(epi=epi):
                step = build_lmm_step(n_samples=n, n_covariates=cfg["n_cov"],
                                      options=AssocOptions(), epilogue=epi, mesh=mesh,
                                      **cfg["lmm"])
                return np_out(step(T(inp["g"]), T(inp["rot"]), T(inp["qhat"]), T(inp["y"])))
            record(f"lmm_{epi}_{shape}", lmm)

    files = cfg["files"]
    study = Study.from_files(files["bed"], files["pheno"], files["cov"], device="cpu")

    def plan(kind, **extra):
        spec = dict(cfg["scans"][kind]) if kind in cfg["scans"] else {}
        grid = GridSpec(**({"batch_markers": cfg["grid"]["batch_markers"]}
                           if spec.pop("unblocked", False) else cfg["grid"]))
        lmm = spec.pop("lmm", None)
        if lmm is not None:
            spec["lmm"] = LmmSpec(**lmm)
        spec.update(extra)
        return study.plan(device="cpu", grid=grid, mesh=mesh, **spec)

    def scan(kind, out_dir=None, ckpt=None, stop_after=None):
        session = plan(kind, checkpoint_dir=ckpt).run()
        writer = TsvWriter(out_dir) if out_dir and rank == 0 else None
        if writer is not None:
            writer.open(session)
        cells = {}
        events = session.events()
        for i, cell in enumerate(events):
            cells[f"{cell.batch_index}_{cell.block_index}"] = dict(cell.arrays)
            if writer is not None:
                writer.write(cell)
            if stop_after is not None and i + 1 == stop_after:
                break
        events.close()
        if writer is not None and stop_after is None:
            writer.close()
        return {"cells": cells, "executor": session.executor_info}

    for kind in cfg["scans"]:
        record(f"scan_{kind}", lambda kind=kind: scan(kind, os.path.join(work, kind)))
    record("scan_cut", lambda: scan("fused_mp", ckpt=os.path.join(work, "ck"), stop_after=2))

    def shim():
        from repro_torch.core.screening import GenomeScan, ScanConfig
        config = ScanConfig(engine="fused", device="cpu", **cfg["grid"])
        got = GenomeScan(study.source, np.asarray(study.phenotypes), study.covariates,
                         config=config, mesh=mesh).run()
        return {k: getattr(got, k) for k in ("best_nlp", "best_marker", "hits", "hit_stats",
                                             "maf", "valid")}
    record("shim_fused_mp", shim)

    def refuse(name):
        def run():
            if name == "fused_sample":
                plan("fused_mp", mode="sample").prepare()
            elif name == "lmm_sample":
                plan("lmm_fused_mp", mode="sample").prepare()
            elif name == "devices":
                plan("dense_mp", executor=ExecSpec(devices=2)).run()
            elif name == "shared_fs":
                plan("dense_mp", checkpoint_dir=os.path.join(work, f"ck_fs{rank}"),
                     executor=ExecSpec(backend="shared-fs")).run()
            elif name == "packed":
                plan("fused_mp", io=IOSpec(genotype_staging="packed")).prepare()
            elif name == "device_mismatch":
                study.plan(engine="dense", device="cuda", mesh=mesh).prepare()
            elif name == "plan_mismatch":
                # rank 1 asks for another hit threshold: no rank starts the walk
                session = plan("dense_mp", hit_threshold_nlp=7.301 + (rank == 1)).run()
                next(iter(session.events()))
            return {"raised": None}
        try:
            return run()
        except Exception as e:
            return {"raised": type(e).__name__, "message": str(e)}

    for name in cfg["refusals"]:
        res[f"refuse_{name}"] = refuse(name)
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    """
)


def _step_inputs(shape: str, seed: int) -> dict:
    m, n, p = SHAPES[shape]
    rng = np.random.default_rng(seed)
    g = rng.choice([0.0, 1.0, 2.0], p=[0.45, 0.4, 0.15], size=(m, n)).astype(np.float32)
    g[rng.random((m, n)) < 0.03] = -9.0
    g[1, :] = 1.0                                 # monomorphic: not valid
    y = rng.normal(size=(n, p)).astype(np.float32)
    y[:, 0] += 0.8 * np.where(g[3] < 0, 0.0, g[3])   # one strong association
    y = ((y - y.mean(0)) / y.std(0)).astype(np.float32)
    cov = rng.normal(size=(n, N_COV))
    q = np.linalg.qr(np.column_stack([np.ones(n), cov]))[0].astype(np.float32)
    w = np.linalg.qr(rng.normal(size=(p, p)))[0].astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(n, n)))[0].astype(np.float32)
    qhat = np.linalg.qr(rng.normal(size=(n, N_COV + 1)))[0].astype(np.float32)
    mf = 48
    codes = rng.choice([0, 1, 2, 3], p=[0.3, 0.02, 0.38, 0.3], size=(mf, n)).astype(np.uint8)
    codes[5] = 1                                  # all missing
    mean, inv, valid = kops.marker_stats_from_codes(codes)
    packed = kops.pack_tiled(codes, FUSED["block_n"])
    return dict(g=g, y=y, q=q, w=w, rot=rot, qhat=qhat, packed=packed,
                mean2d=mean.reshape(-1, 1).astype(np.float32),
                inv2d=inv.reshape(-1, 1).astype(np.float32), valid=valid)


def _references(inp: dict) -> dict:
    """The reference's ``mesh=None`` steps on the same inputs."""
    n = inp["g"].shape[1]
    p = inp["y"].shape[1]
    J = jnp.asarray
    out = {}
    for mv in (False, True):
        step = ref_dense(n_samples=n, n_covariates=N_COV, options=RefOptions(dof_mode="exact"),
                         q_basis=J(inp["q"]), multivariate=mv, n_traits_eff=float(p),
                         whitening=J(inp["w"]) if mv else None, trait_tile=4)
        out["mv" if mv else "uni"] = step(J(inp["g"]), J(inp["y"]))
    out["fused"] = ref_fused(n_samples=n, n_covariates=0, options=RefOptions(),
                             interpret=True, **FUSED)(
        J(inp["packed"]), J(inp["mean2d"]), J(inp["inv2d"]), J(inp["valid"]), J(inp["y"]))
    for epi in ("dense", "fused"):
        out[f"lmm_{epi}"] = ref_lmm(n_samples=n, n_covariates=N_COV, options=RefOptions(),
                                    epilogue=epi, **LMM)(
            J(inp["g"]), J(inp["rot"]), J(inp["qhat"]), J(inp["y"]))
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in out.items()}


@pytest.fixture(scope="module")
def world(cohort_files, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("mesh"))
    inputs, refs = {}, {}
    for i, shape in enumerate(SHAPES):
        inputs[shape] = _step_inputs(shape, seed=11 + i)
        np.savez(os.path.join(work, f"steps_{shape}.npz"), **inputs[shape])
        refs[shape] = _references(inputs[shape])
    cfg = dict(shapes=list(SHAPES), n_cov=N_COV, fused=FUSED, lmm=LMM,
               files={k: cohort_files[k] for k in ("bed", "pheno", "cov")},
               grid=SCAN_GRID, scans=SCANS, refusals=list(REFUSALS))
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(cfg, f)
    store = os.path.join(work, "store")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(r), str(WORLD), store, work,
             os.path.join(REPO, "src")],
            cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(WORLD)
    ]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-4000:]}"
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return dict(work=work, ranks=ranks, inputs=inputs, refs=refs, files=cohort_files)


def _result(world, name, rank=0):
    res = world["ranks"][rank][name]
    assert "error" not in res, res.get("error")
    return res


def _hold(got, ref, tol, m=None):
    r_tol, t_tol, nlp_rtol, nlp_atol = tol
    sl = slice(None) if m is None else slice(0, m)
    np.testing.assert_allclose(got["r"][sl], ref["r"][sl], atol=r_tol)
    np.testing.assert_allclose(got["t"][sl], ref["t"][sl], rtol=t_tol, atol=t_tol)
    np.testing.assert_allclose(got["nlp"][sl], ref["nlp"][sl], rtol=nlp_rtol, atol=nlp_atol)
    np.testing.assert_allclose(got["batch_best_t"], ref["batch_best_t"], rtol=t_tol, atol=t_tol)
    np.testing.assert_allclose(got["batch_best_nlp"], ref["batch_best_nlp"],
                               rtol=nlp_rtol, atol=nlp_atol)
    # winners agree wherever the best |t| is not within tolerance of a tie
    a = np.sort(np.abs(ref["t"][sl]), axis=0)
    decided = (a[-1] - a[-2]) > 2 * (t_tol + t_tol * a[-1])
    np.testing.assert_array_equal(got["batch_best_row"][decided],
                                  ref["batch_best_row"][decided])
    assert abs(int(got["hit_count"]) - int(ref["hit_count"])) <= int(
        np.sum(np.abs(ref["nlp"][sl] - 7.301) <= nlp_atol + nlp_rtol * 7.301))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mv", ["uni", "mv"])
@pytest.mark.parametrize("mode", ["mp", "sample"])
def test_mesh_dense_step_matches_reference(world, mode, mv, shape):
    got = _result(world, f"dense_{mode}_{mv}_{shape}")
    ref = world["refs"][shape][mv]
    m, _, p = SHAPES[shape]
    assert got["r"].shape == (m, p) and got["t"].shape == (m, p)
    _hold(got, ref, TOL["dense"])
    for key in ("maf", "valid"):
        np.testing.assert_array_equal(got[key], ref[key])
    if mv == "mv":
        np.testing.assert_allclose(got["omnibus"], ref["omnibus"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got["omnibus_nlp"], ref["omnibus_nlp"], rtol=2e-3, atol=5e-3)
    assert bool(got["repeat_equal"]), "a repeated mesh step gave other bits"


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mesh_fused_step_matches_reference(world, shape):
    got = _result(world, f"fused_{shape}")
    ref = world["refs"][shape]["fused"]
    assert got["r"].shape == ref["r"].shape
    _hold(got, ref, TOL["fused"])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("epilogue", ["dense", "fused"])
def test_mesh_lmm_step_matches_reference(world, epilogue, shape):
    got = _result(world, f"lmm_{epilogue}_{shape}")
    ref = world["refs"][shape][f"lmm_{epilogue}"]
    _hold(got, ref, TOL["dense"])
    for key in ("maf", "valid"):
        np.testing.assert_array_equal(got[key], ref[key])


def _bitwise_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_bitwise_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


def test_every_rank_gathers_the_same_bits(world):
    """Every step's and every scan cell's outputs are bitwise equal on all
    four ranks: each rank holds the full tiles of the scan."""
    names = [k for k in world["ranks"][0] if not k.startswith("refuse_")]
    assert len(names) > 20
    for name in names:
        base = _result(world, name)
        base = base.get("cells", base)
        for r in range(1, WORLD):
            other = _result(world, name, r)
            assert _bitwise_equal(base, other.get("cells", other)), (name, r)


def _serial(world, kind, out_dir, **extra):
    spec = dict(SCANS[kind])
    grid = GridSpec(**({"batch_markers": SCAN_GRID["batch_markers"]}
                       if spec.pop("unblocked", False) else SCAN_GRID))
    if "lmm" in spec:
        spec["lmm"] = LmmSpec(**spec["lmm"])
    spec.pop("mode", None)
    files = world["files"]
    study = Study.from_files(files["bed"], files["pheno"], files["cov"], device="cpu")
    session = study.plan(device="cpu", grid=grid, **spec, **extra).run()
    session.stream_to(TsvWriter(out_dir))
    return session


def _tables(out_dir) -> dict:
    return {f: open(os.path.join(out_dir, f), "rb").read()
            for f in ("hits.tsv", "per_trait_best.tsv", "qc.tsv")}


def _tsv_rows(path):
    with open(path) as f:
        f.readline()
        return [line.rstrip("\n").split("\t") for line in f]


def test_mesh_fused_scan_tables_byte_equal_serial(world, tmp_path):
    """``ScanPlan(mesh=)`` on the fused engine writes the port's serial
    tables byte for byte (the mesh keeps the dense p-value epilogue; the
    serial scan runs the sparse one), with ragged batches and trait blocks
    that do not divide over the mesh (``SCAN_GRID``)."""
    scan = _result(world, "scan_fused_mp")
    assert scan["executor"]["mesh"] == {"axes": ["data", "model"], "shape": [2, 2]}
    _serial(world, "fused_mp", str(tmp_path / "serial"))
    assert _tables(os.path.join(world["work"], "fused_mp")) == _tables(str(tmp_path / "serial"))


@pytest.mark.parametrize("kind", [k for k in SCANS if k != "fused_mp"])
def test_mesh_scan_matches_serial(world, kind, tmp_path):
    """Dense ``mp`` and ``sample``, the dense multivariate screen and both
    lmm epilogues: the mesh scan's tables against the port's serial scan of
    the same plan at the oracle tolerances (TSV text: 5 decimals of r, 4 of
    t and nlp), hit sets equal away from the threshold."""
    _result(world, f"scan_{kind}")
    serial = str(tmp_path / "serial")
    _serial(world, kind, serial)
    mesh_dir = os.path.join(world["work"], kind)
    r_tol, t_tol, nlp_rtol, nlp_atol = TOL["dense"]
    got = {(m, t): [float(v) for v in rest] for m, t, *rest in
           _tsv_rows(os.path.join(mesh_dir, "hits.tsv"))}
    want = {(m, t): [float(v) for v in rest] for m, t, *rest in
            _tsv_rows(os.path.join(serial, "hits.tsv"))}
    assert want
    for a, b in ((got, want), (want, got)):
        missing = [k for k, v in a.items() if v[2] >= 7.301 + 0.05 and k not in b]
        assert not missing, missing
    for k in set(got) & set(want):
        (r1, t1, n1), (r2, t2, n2) = got[k], want[k]
        assert abs(r1 - r2) <= r_tol + 1e-5, (k, r1, r2)
        assert abs(t1 - t2) <= t_tol + t_tol * abs(t2) + 1e-4, (k, t1, t2)
        assert abs(n1 - n2) <= nlp_atol + nlp_rtol * abs(n2) + 1e-3, (k, n1, n2)
    best_got = _tsv_rows(os.path.join(mesh_dir, "per_trait_best.tsv"))
    best_want = _tsv_rows(os.path.join(serial, "per_trait_best.tsv"))
    assert [r[0] for r in best_got] == [r[0] for r in best_want]
    for (_, m1, n1), (_, m2, n2) in zip(best_got, best_want):
        assert abs(float(n1) - float(n2)) <= nlp_atol + nlp_rtol * abs(float(n2)) + 1e-3
        if float(n2) >= 7.301 + 0.05:
            assert m1 == m2
    qc_got = _tsv_rows(os.path.join(mesh_dir, "qc.tsv"))
    qc_want = _tsv_rows(os.path.join(serial, "qc.tsv"))
    assert len(qc_got) == len(qc_want)
    for a, b in zip(qc_got, qc_want):
        assert a[:3] == b[:3], (a, b)     # marker, maf, valid
        for x, y in zip(a[3:], b[3:]):    # the multivariate omnibus column
            assert abs(float(x) - float(y)) <= nlp_atol + nlp_rtol * abs(float(y)) + 1e-3


def test_mesh_checkpoint_resumes_without_a_mesh(world, tmp_path):
    """A checkpoint cut after 2 cells under the (2, 2) mesh (rank 0 commits)
    resumes with no mesh and writes the uninterrupted scan's tables."""
    cut = _result(world, "scan_cut")
    assert len(cut["cells"]) == 2
    ck = os.path.join(world["work"], "ck")
    resumed = _serial(world, "fused_mp", str(tmp_path / "resumed"), checkpoint_dir=ck)
    m = resumed.metrics.summary()
    assert (m["replayed_cells"], m["live_cells"]) == (2, resumed.metrics.n_cells_total - 2)
    _serial(world, "fused_mp", str(tmp_path / "whole"))
    assert _tables(str(tmp_path / "resumed")) == _tables(str(tmp_path / "whole"))


def test_genome_scan_shim_on_a_mesh(world):
    """``GenomeScan(mesh=)`` passes the mesh to its plan: the fused shim's
    ``ScanResult`` on the (2, 2) mesh equals the serial shim's bit for bit."""
    from repro_torch.core.screening import GenomeScan, ScanConfig

    got = _result(world, "shim_fused_mp")
    files = world["files"]
    study = Study.from_files(files["bed"], files["pheno"], files["cov"], device="cpu")
    want = GenomeScan(study.source, np.asarray(study.phenotypes), study.covariates,
                      config=ScanConfig(engine="fused", device="cpu", **SCAN_GRID)).run()
    assert len(want.hits)
    for key, value in got.items():
        assert _bitwise_equal(value, getattr(want, key)), key


@pytest.mark.parametrize("name", REFUSALS)
def test_mesh_refusals(world, name):
    """Fused or lmm ``sample``, ``devices > 1``, the shared-fs backend, an
    explicit packed staging, a device of the other kind than the mesh, and
    a rank whose plan differs from the others' each raise ``ValueError`` on
    every rank."""
    for r in range(WORLD):
        res = world["ranks"][r][f"refuse_{name}"]
        assert res["raised"] == "ValueError", (r, res)
    want = {
        "fused_sample": "marker x phenotype", "lmm_sample": "marker x phenotype",
        "devices": "exclusive", "shared_fs": "shared-fs", "packed": "sharding mesh",
        "device_mismatch": "mesh lies on", "plan_mismatch": "plans differ",
    }[name]
    assert want in world["ranks"][0][f"refuse_{name}"]["message"]
