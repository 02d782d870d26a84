"""Whole runs of the harness on the CPU at a size a test run holds: the
port as it is comes out ``correct``; the control (products in TF32) and each
fault planted in the timed path come out not correct under the limits that
``ols_dense_p20k``'s configuration states.  The harness's look for a card
is skipped: ``run_cell`` is driven on the CPU directly.  ``gpu``-marked
cases repeat the sound run and the control on a card."""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from gwasbench import harness

WORKLOADS = ["ols_dense_p20k", "mv_dense_p2k"]
SMALL = dict(n_samples=512, n_covariates=3, distinct_markers=1024, n_markers=65536,
             batch_markers=256)


def _cell(workload: str = "ols_dense_p20k") -> harness.Cell:
    cell = harness.load_cell(workload)
    cfg = dict(cell.config, **SMALL)
    traffic = dict(cell.traffic, n_traits=64, n_planted=32, planted_effect=[0.25, 0.45])
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def _run(cell, device_type="cpu", seed=2**31 + 77, control=None, seconds=0.5):
    return harness.run_cell(cell, seed=seed, seconds=seconds, trace_on=False,
                            t_process=time.perf_counter(), device_type=device_type,
                            control=control)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_port_is_correct(workload):
    # a window that a loaded CPU still fills with cells
    run, verdict = _run(_cell(workload), seconds=2.0)
    assert verdict.correct, verdict.numbers
    assert verdict.cells > 0 and run.window_cells > 0 and run.setup_s > 0


def _faults():
    from repro_torch.core import association as assoc
    from repro_torch.core import engines
    from repro_torch.core import multivariate as mv

    corr, sparse, stdz = (assoc.correlation, engines.sparse_epilogue_outputs,
                          engines.standardize_genotype_batch)
    omni = mv.omnibus_chi2

    def half_samples(g, y, n, **kw):
        h = g.shape[1] // 2
        return corr(g[:, :h].contiguous(), y[:h], h, **kw)

    def tf32_products(g, y, n, **kw):
        return corr(_tf32(g), _tf32(y), n, **kw)

    def hit_r_altered(r, t, dof, plan, **kw):
        out = sparse(r, t, dof, plan, **kw)
        out["hit_r"] = torch.where(out["hit_idx"] >= 0, out["hit_r"] + 1e-3, out["hit_r"])
        return out

    def best_row_altered(r, t, dof, plan, **kw):
        out = sparse(r, t, dof, plan, **kw)
        out["batch_best_row"] = (out["batch_best_row"] + 1) % r.shape[0]
        return out

    def half_markers(g, **kw):
        g_std, ms = stdz(g, **kw)
        valid = ms.valid.clone()
        valid[valid.shape[0] // 2:] = False
        return g_std, ms._replace(valid=valid)

    def maf_altered(g, **kw):
        g_std, ms = stdz(g, **kw)
        return g_std, ms._replace(maf=ms.maf + 1e-3)

    def omnibus_altered(r, n, n_eff, whitening=None):
        s, nlp = omni(r, n, n_eff, whitening=whitening)
        return s, nlp * 1.01

    return {
        "control_tf32": (assoc, "correlation", tf32_products),
        "omnibus_altered": (mv, "omnibus_chi2", omnibus_altered),
        "half_samples": (assoc, "correlation", half_samples),
        "hit_r_altered": (engines, "sparse_epilogue_outputs", hit_r_altered),
        "best_row_altered": (engines, "sparse_epilogue_outputs", best_row_altered),
        "half_markers": (engines, "standardize_genotype_batch", half_markers),
        "maf_altered": (engines, "standardize_genotype_batch", maf_altered),
    }


@pytest.mark.parametrize("workload, fault", [
    ("ols_dense_p20k", "control_tf32"), ("mv_dense_p2k", "control_tf32"),
    ("ols_dense_p20k", "half_samples"), ("ols_dense_p20k", "hit_r_altered"),
    ("ols_dense_p20k", "best_row_altered"), ("ols_dense_p20k", "half_markers"),
    ("ols_dense_p20k", "maf_altered"), ("mv_dense_p2k", "omnibus_altered"),
])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    module, name, broken = _faults()[fault]
    monkeypatch.setattr(module, name, broken)
    _, verdict = _run(_cell(workload))
    assert not verdict.correct, verdict.numbers


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_port_is_correct_on_a_card(workload):
    _card()
    _, verdict = _run(_cell(workload), device_type="cuda")
    assert verdict.correct, verdict.numbers


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_tf32_control_is_not_correct_on_a_card(workload):
    _card()
    _, verdict = _run(_cell(workload), device_type="cuda", control="tf32")
    assert not verdict.correct, verdict.numbers
