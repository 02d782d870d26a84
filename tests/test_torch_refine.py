"""The canonical refine's two routes (``core.stats.refine_neglog10p``).

Host values (a numpy array, a CPU tensor) take the host refine, bit for bit
as before, and count ``refine_lanes_host``; a tensor off the CPU takes the
card's refine kernel (``kernels.tstat.refine_neglog10p_device``) and counts
``refine_lanes_device``, and never falls back to the host.  Both routes
read one set of per-scan scalars (``stats._refine_scalars``).  ``gpu``-marked
cases hold the kernel on a card against the float64 reference, the host
refine and the plain version on the card, check that a lane's bits do not
depend on its position, and run the scan's identities (sparse == dense
audit, overflow == compact) on one card.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.api import GridSpec, Study
from repro_torch.core import sinks, stats
from repro_torch.io import plink, synth
from repro_torch.kernels import tstat as ts
from repro_torch.runtime import spans

torch.set_num_threads(1)

DOFS = (50.0, 4096.0, 4097.0, 22986.0, 1e6)


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.stop()
    spans.take()
    yield
    spans.stop()
    spans.take()


def _lanes(counter: str, fn) -> int:
    base = spans.snapshot()
    spans.start()
    try:
        fn()
    finally:
        spans.stop()
    return (spans.summary(since=base) or {"counters": {}})["counters"].get(counter, 0)


# ------------------------------------------------------------------- the CPU


@pytest.mark.parametrize("kind", ["numpy", "cpu_tensor"])
def test_host_values_take_the_host_refine(kind):
    t = np.random.default_rng(3).normal(0, 8, 1000).astype(np.float32)
    arg = t if kind == "numpy" else torch.from_numpy(t.copy())
    launches = ts.refine_launches
    got = []
    lanes = _lanes("refine_lanes_host", lambda: got.append(stats.refine_neglog10p(arg, 998.0)))
    assert ts.refine_launches == launches
    assert lanes == 1000
    assert isinstance(got[0], np.ndarray) and got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], stats._refine(t, 998.0, stats.REFINE_WIDTH))


@pytest.mark.parametrize("dof", DOFS)
def test_refine_scalars_are_the_host_paths_constants(dof):
    """The constants ``neglog10_p_from_t``, ``_log_p_tail`` and
    ``_p_bulk_beta`` computed inline before both routes shared them."""
    s = stats._refine_scalars(dof)
    nu = float(np.float32(dof))
    a = nu * 0.5
    assert s.nu == nu
    assert s.t2_switch == float(np.float32(min(max(nu / 2000.0, 6.0), 144.0)))
    assert s.x_cf_max == nu / (nu + 6.0)
    assert s.z_switch == 3.0 * nu / (nu + 2.0)
    assert s.betaln_half == stats._betaln_half(a)
    assert s.log_a == math.log(a) == math.log(nu * 0.5)
    assert len(s) == 6    # the kernel's six float arguments


def test_the_kernel_wrapper_takes_no_host_tensor():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.refine_neglog10p_device(torch.zeros(8), stats._refine_scalars(100.0))


def test_a_tensor_routed_to_the_card_never_falls_back_to_the_host(monkeypatch):
    """With the route check patched to send a CPU tensor to the card, the
    refine raises from the kernel's wrapper: the host refine is not
    reached."""
    monkeypatch.setattr(stats, "_on_card", lambda t: True)
    launches = ts.refine_launches

    def run():
        with pytest.raises(ValueError, match="CUDA tensors"):
            stats.refine_neglog10p(torch.linspace(-8, 8, 64), 100.0)

    assert _lanes("refine_lanes_host", run) == 0
    assert ts.refine_launches == launches


def test_the_card_route_takes_no_chunk_width(monkeypatch):
    """``width`` chunks the host refine only: on the card's route a width
    other than the default raises before any launch."""
    monkeypatch.setattr(stats, "_on_card", lambda t: True)
    launches = ts.refine_launches
    for width in (None, 32, 128):
        with pytest.raises(ValueError, match="chunk width"):
            stats.refine_neglog10p(torch.linspace(-8, 8, 64), 100.0, width=width)
    assert ts.refine_launches == launches


@pytest.mark.parametrize("dof", DOFS)
def test_refine_grid_crosses_the_lane_switches(dof):
    """The check grid holds t = 0, negative t, |t| up to 1e4, and lanes on
    both sides of each switch of ``neglog10_p_from_t``."""
    s = stats._refine_scalars(dof)
    t = stats._refine_grid(dof)
    assert t.dtype == np.float32 and t[0] == 0.0 and (t < 0).any()
    assert np.abs(t).max() >= 1e4 * (1 - 1e-6)
    t2 = t.astype(np.float64) ** 2
    for edge in (s.t2_switch, s.z_switch, dof / 2000.0):
        assert (t2 < edge).any() and (t2 > edge).any(), edge


def test_a_step_output_off_the_cpu_is_refined_off_the_host():
    """Every emitted value of a view whose step outputs lie off the CPU
    (meta tensors stand in for a card's) goes to the card's route: the
    winners, the hit slots, and host-screened survivors, which are copied
    to the outputs' device first."""
    from repro_torch.core.engines import HostBatch
    from repro_torch.runtime.prefetch import MarkerBatch

    batch = MarkerBatch(index=0, lo=0, hi=4, source_id=0, local_lo=0, local_hi=4)
    host = HostBatch(batch=batch, device_args=())
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    view = sinks.BatchView(host, {"batch_best_t": meta(3), "hit_t": meta(64), "t": meta(4, 3)},
                           3, dof=100.0, t2_screen=10.0)
    for read in (lambda: view.best_nlp, lambda: view.hit_nlp, lambda: view.nlp,
                 lambda: sinks._refined(np.ones(5, np.float32), 100.0, on=view._out["t"])):
        assert _lanes("refine_lanes_host", lambda: pytest.raises(ValueError, read)) == 0


# ------------------------------------------------------------------ the card


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the refine kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _scipy_nlp(t: np.ndarray, dof: float) -> np.ndarray:
    sps = pytest.importorskip("scipy.stats")
    tt = np.abs(t.astype(np.float64))
    return -(sps.t.logsf(tt, dof) + math.log(2.0)) / math.log(10.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dof", [50.0, 4096.0, 22986.0, 1e6])
def test_cuda_refine_kernel_holds_to_the_float64_reference(dof):
    """The kernel within the envelope ``tests/test_torch_stats.py`` holds the
    host refine to against scipy (5e-3 relative, 1e-2 floor), t = 0 -> 0,
    and within 1e-5 relative (1e-6 absolute) of the host refine and of the
    plain version on the card."""
    dev = _cuda()
    t = stats._refine_grid(dof)
    launches = ts.refine_launches
    got = stats.refine_neglog10p(torch.from_numpy(t).to(dev), dof)
    torch.cuda.synchronize()
    assert ts.refine_launches == launches + 1
    assert got.device.type == "cuda" and got.dtype == torch.float32 and got.shape == t.shape
    k = got.cpu().numpy()
    assert np.all(np.isfinite(k)) and k[0] == 0.0
    ref = _scipy_nlp(t, dof)
    finite = np.isfinite(ref)
    assert np.all(k[~finite] > 300)
    rel = np.abs(k[finite] - ref[finite]) / np.maximum(np.abs(ref[finite]), 1e-2)
    assert rel.max() < 5e-3, (dof, float(rel.max()))
    host = stats.refine_neglog10p(t, dof)
    plain = stats.neglog10_p_from_t(torch.from_numpy(t).to(dev), dof).cpu().numpy()
    for other in (host, plain):
        np.testing.assert_allclose(k, other, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_cuda_refine_bits_do_not_depend_on_position():
    dev = _cuda()
    t = torch.from_numpy(np.random.default_rng(5).normal(0, 8, 5000).astype(np.float32)).to(dev)
    whole = stats.refine_neglog10p(t, 22986.0)
    for lo, hi in ((0, 1), (1, 2), (3, 67), (64, 130), (999, 5000), (4999, 5000), (17, 4111)):
        part = stats.refine_neglog10p(t[lo:hi].clone(), 22986.0)
        assert torch.equal(part.view(torch.int32), whole[lo:hi].view(torch.int32)), (lo, hi)
        view = stats.refine_neglog10p(t[lo:hi], 22986.0)
        assert torch.equal(view.view(torch.int32), whole[lo:hi].view(torch.int32)), (lo, hi)
    padded = torch.cat([torch.zeros(7, device=dev), t, torch.zeros(100, device=dev)])
    out = stats.refine_neglog10p(padded, 22986.0)
    assert torch.equal(out[7:5007].view(torch.int32), whole.view(torch.int32))
    assert not bool(out[:7].any())


@pytest.fixture(scope="module")
def cuda_study(tmp_path_factory):
    _cuda()
    cohort = synth.make_cohort(n_samples=300, n_markers=384, n_traits=8, n_causal=6,
                               effect_size=0.6, missing_rate=0.02, seed=13)
    files = synth.write_cohort_files(cohort, str(tmp_path_factory.mktemp("refine") / "toy"))
    return Study.from_arrays(plink.PlinkBed(files["bed"]), cohort.phenotypes,
                             cohort.covariates, device="cuda")


def _cells(study, **plan_kwargs) -> tuple[list, dict]:
    plan = study.plan(device="cuda", grid=GridSpec(batch_markers=96), hit_threshold_nlp=1.0,
                      **plan_kwargs)
    plan.prepare()
    session = plan.run(resume=False)
    spans.start()
    try:
        cells = [(c.batch_index, c.block_index, c.payload()) for c in session.events()]
    finally:
        spans.stop()
    counters = session.metrics.summary()["spans"]["counters"]
    return sorted(cells, key=lambda c: c[:2]), counters


@pytest.mark.gpu
def test_cuda_scan_identities_are_bitwise(cuda_study):
    """On one card, the dense engine: the sparse epilogue == the dense
    audit, and a buffer that overflows (capacity 64 against ~100 survivors
    a cell at threshold 1) == one that holds them all; every emitted value
    is refined on the card."""
    runs = {name: _cells(cuda_study, **kw) for name, kw in (
        ("compact", {}), ("dense_audit", dict(sparse_epilogue=False)),
        ("overflow", dict(hit_capacity=64)))}
    base, counters = runs["compact"]
    assert sum(len(p["hits"]) for _, _, p in base) > 0
    for name, (cells, c) in runs.items():
        assert c.get("refine_lanes_host", 0) == 0 and c["refine_lanes_device"] > 0, name
        assert [x[:2] for x in cells] == [x[:2] for x in base], name
        for (_, _, a), (_, _, b) in zip(cells, base):
            assert sorted(a) == sorted(b), name
            for key in a:
                assert np.asarray(a[key]).tobytes() == np.asarray(b[key]).tobytes(), (name, key)
