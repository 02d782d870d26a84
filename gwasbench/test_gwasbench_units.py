"""Unit checks of the benchmark's yardstick, on the CPU in seconds: the
reference against a direct OLS, the cycled source, the contract's names and
units, the roofline counts, the trace arithmetic, the metric readers, and
that nothing here imports ``jax`` or ``repro``."""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.special
import torch

from gwasbench import harness, roofline, trace
from gwasbench.cohort import make_cohort
from gwasbench.reference import PanelReference, neglog10p, t2_for_nlp
from gwasbench.source import CycledSource

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

TRAFFIC = {"n_traits": 6, "maf_range": [0.05, 0.5], "missing_rate": 0.05, "n_planted": 4,
           "planted_effect": [0.3, 0.5], "covariate_effect": 0.5}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cohort"))
    return make_cohort(TRAFFIC, n_samples=103, n_covariates=3, n_markers=40, seed=2**31 + 5,
                       device=torch.device("cpu"), out_dir=d)


def test_reference_matches_direct_ols(tiny):
    from repro_torch.io.plink import PlinkBed

    dos = PlinkBed(tiny.bed_path).read_dosages(0, 40).astype(np.float64)
    dos[dos < 0] = np.nan
    y, c = tiny.phenotypes.astype(np.float64), tiny.covariates.astype(np.float64)
    x = np.column_stack([np.ones(len(y)), c])
    y_res = y - x @ np.linalg.lstsq(x, y, rcond=None)[0]
    ref = PanelReference(tiny.phenotypes, tiny.covariates, device=torch.device("cpu"))
    blk = ref.block(tiny.bed_path, 0, 40)
    n, dof = y.shape[0], y.shape[0] - 2
    for m in range(40):
        g = np.where(np.isnan(dos[m]), np.nanmean(dos[m]), dos[m])
        for j in range(y.shape[1]):
            r = np.corrcoef(g, y_res[:, j])[0, 1]
            assert abs(blk["r"][m, j].item() - r) < 1e-12
            t = r * np.sqrt(dof / (1 - r * r))
            assert abs(blk["t"][m, j].item() - t) < 1e-9
            p = scipy.special.betainc(dof / 2, 0.5, dof / (dof + t * t))
            assert abs(neglog10p(np.array([t]), dof)[0] + np.log10(p)) < 1e-9
        af = np.nanmean(dos[m]) / 2
        assert abs(blk["maf"][m] - min(af, 1 - af)) < 1e-15
    assert blk["valid"].all()
    assert n == ref.n


def test_t2_for_nlp_inverts_the_tail():
    for dof in (101.0, 22998.0):
        t2 = t2_for_nlp(7.301, dof)
        assert abs(neglog10p(np.array([np.sqrt(t2)]), dof)[0] - 7.301) < 1e-9


def test_cohort_repeats_from_its_seed(tiny, tmp_path):
    again = make_cohort(TRAFFIC, n_samples=103, n_covariates=3, n_markers=40,
                        seed=2**31 + 5, device=torch.device("cpu"), out_dir=str(tmp_path))
    with open(tiny.bed_path, "rb") as a, open(again.bed_path, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(tiny.phenotypes, again.phenotypes)
    np.testing.assert_array_equal(tiny.covariates, again.covariates)


def test_cycled_source_reads_the_file_at_virtual_offsets(tiny):
    from repro_torch.io.packed_cache import PackedSlabCache
    from repro_torch.io.plink import PlinkBed

    bed = PlinkBed(tiny.bed_path)
    src = CycledSource(bed, 1000)
    assert (src.n_markers, src.n_samples) == (1000, 103)
    np.testing.assert_array_equal(src.read_packed(80, 88), bed.read_packed(0, 8))
    wrap = src.read_packed(36, 44)  # crosses the period
    np.testing.assert_array_equal(wrap, np.concatenate([bed.read_packed(36, 40),
                                                        bed.read_packed(0, 4)]))
    np.testing.assert_array_equal(src.read_dosages(41, 43), bed.read_dosages(1, 3))
    assert src.marker_ids[81] == f"{bed.marker_ids[1]}.2" and len(src.marker_ids) == 1000
    cache = PackedSlabCache(1 << 20)
    for lo in (0, 40, 80, 0):
        cache.read(src, lo, lo + 8)
    assert (cache.misses, cache.hits) == (3, 1)  # one key a virtual range


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_benchmark_names_units_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    one_line = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s  # noqa: E731
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py"))
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and one_line(m["layer"])
        assert set(m.get("workloads", [])) <= {w["name"] for w in b["workloads"]}
    used = set()
    for w in b["workloads"]:
        assert one_line(w["why"]) and w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
        used.add(w["config"])
        cell = harness.load_cell(w["name"], ROOT)
        assert cell.chips == w["chips"]
    for c in b["configs"]:
        assert c["name"] in used and one_line(c["source"]) and one_line(c["why"])
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["reduced"] == c["reduced"] and all(k in cfg for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    assert all(one_line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert len(json.dumps(b)) < 64 * 1024


def test_product_counts():
    m, n, p = 8192, 23000, 20480
    assert roofline.product_flops(m, n, p) == 2 * 8192 * 23000 * 20480
    assert roofline.product_bytes(m, n, p) == 8192 * 5750 + 4 * 23000 * 20480 + 4 * 8192 * 20480
    assert roofline.product_least_s(m, n, p) == pytest.approx(2 * m * n * p / 989e12)
    # a narrow panel is bound by its bytes
    assert roofline.product_least_s(8192, 23000, 1) == pytest.approx(
        (8192 * 5750 + 4 * 23000 + 4 * 8192) / 3.35e12)


def test_trace_arithmetic():
    iv = trace.Interval
    tr = trace.Trace(
        device_ops=[iv("sm90_xmma_gemm_f32", 0, 10, 0), iv("elementwise", 5, 12, 0),
                    iv("sm90_xmma_gemm_f32", 20, 30, 0), iv("Memcpy HtoD", 0, 4, 1)],
        host_ops=[iv("aten::nonzero", 12, 19, -1), iv("wrapper", 0, 1000, -1)],
        window_s=40e-6, devices=(0, 1))
    assert trace.busy_s_by_device(tr) == {0: pytest.approx(22e-6), 1: pytest.approx(4e-6)}
    assert trace.busy_s(tr) == pytest.approx(13e-6)
    assert trace.device_seconds_matching(tr, ["(?i)gemm"]) == (pytest.approx(20e-6), 2)
    assert trace.top_device_ops(tr)[0] == ["sm90_xmma_gemm_f32", pytest.approx(20e-6)]
    assert trace.idle_gaps(tr) == [["aten::nonzero", pytest.approx(8e-6)]]


def _fake_run(with_trace: bool) -> harness.Run:
    cell = harness.load_cell("ols_dense_p20k", ROOT)
    run = harness.Run(cell, seconds=10.0, setup_s=20.0, prepare_s=3.0, window_cells=50,
                      window_batches=50, window_tests=50 * 8192 * 20480.0,
                      window_flops=50 * 2.0 * 8192 * 23000 * 20480, traced_cells=51,
                      traced_flops=51 * 2.0 * 8192 * 23000 * 20480,
                      metrics_start={"step_s": 1.0, "extract_s": 0.5, "decode_s": 0.2},
                      metrics_end={"step_s": 9.0, "extract_s": 2.5, "decode_s": 1.2},
                      peak_bytes=6 * 2**30)
    if with_trace:
        iv = trace.Interval
        run.trace = trace.Trace(device_ops=[iv("ampere_sgemm_128x64_nn", 0, 7.65e6, 0)],
                                window_s=10.0, devices=(0,))
    return run


def test_metric_readers():
    from gwasbench import run as entry

    run = _fake_run(True)
    read = entry.read_metric
    assert read("trait_markers_per_s", run) == pytest.approx(5 * 8192 * 20480)
    assert read("peak_device_gib", run) == 6.0 and read("setup_s", run) == 20.0
    assert read("step_ms_per_cell", run) == pytest.approx(160.0)
    assert read("extract_ms_per_cell", run) == pytest.approx(40.0)
    assert read("decode_ms_per_batch", run) == pytest.approx(20.0)
    least = 51 * roofline.product_least_s(8192, 23000, 20480)
    assert read("product_roofline", run) == pytest.approx(100 * least / 7.65)
    assert read("scan_mfu_pct", run) == pytest.approx(
        100 * 51 * 2 * 8192 * 23000 * 20480 / 10 / 989e12)
    assert read("device_idle_pct", run) == pytest.approx(23.5)
    bare = _fake_run(False)
    for name in ("product_roofline", "scan_mfu_pct", "device_idle_pct"):
        assert read(name, bare) is None
    bare.trace = trace.Trace(device_ops=[trace.Interval("elementwise", 0, 5, 0)], window_s=1.0)
    assert read("product_roofline", bare) is None


def test_nothing_here_imports_jax_or_repro():
    forbidden = {"jax", "jaxlib", "flax", "repro"}
    for dirpath, _, files in os.walk(HERE):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                assert not {n.split(".")[0] for n in names} & forbidden, (fn, names)
    from gwasbench import run as entry

    assert "repro_torch" not in entry.FORBIDDEN
    assert set(entry.forbidden_modules()) <= forbidden


def test_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(HERE, "reference")
    for fn in os.listdir(ref_dir):
        if fn.endswith(".py"):
            with open(os.path.join(ref_dir, fn)) as fh:
                tree = ast.parse(fh.read())
            mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
            mods += [n.module for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.level == 0]
            assert not [m for m in mods if m.split(".")[0] in ("repro_torch", "repro", "jax")]


def test_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                        "ols_dense_p20k", "--seed", str(2**31 + 9), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=str(tmp_path),
                       env=env, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
