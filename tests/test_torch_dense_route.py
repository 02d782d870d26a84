"""The dense step's two product routes (``engines.dense_product_route``).

On a card, under packed staging and the paper's dof, the dense step
multiplies the staged codes in the hand-written ``gwas_dot``, standardized
from the prolog's marker statistics; everywhere else it multiplies the
standardized float32 genotypes with a PyTorch GEMM.  Here the route's glue
runs on CPU tensors (the predicate patched to "kernel", so ``gwas_dot_fused``
runs its plain version) and is held against the library route: r within
2e-6, t within that carried through dt/dr, ``valid`` and ``maf`` bit for bit,
at a ragged sample count, a ragged batch, an all-missing and a monomorphic
marker and a MAF filter; blocked and unblocked trait grids bitwise.  The
``gpu`` cases hold the CUDA kernel route against CUDA dense staging and count
its launches.  No JAX: the ``gpu`` cases run on a card without it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import engines
from repro_torch.core.association import AssocOptions
from repro_torch.kernels.gwas_dot import gwas_dot as gd
from repro_torch.kernels.gwas_dot import ops as kops
from repro_torch.runtime import spans

torch.set_num_threads(1)

N_SAMPLES = 301          # not a multiple of block_n = 128, nor of 4
M_MARKERS = 200          # not a multiple of 128: a ragged batch
N_TRAITS = 12
BLOCK_N = 128
R_TOL = 2e-6


def _codes(m: int, n: int, seed: int) -> np.ndarray:
    """2-bit PLINK codes (0b00 -> 2, 0b01 missing, 0b10 -> 1, 0b11 -> 0):
    2% missing, marker 0 all missing, marker 1 monomorphic, marker 2 rare."""
    rng = np.random.default_rng(seed)
    c = rng.choice([0, 1, 2, 3], p=[0.3, 0.02, 0.38, 0.3], size=(m, n)).astype(np.uint8)
    c[0] = 0b01
    c[1] = 0b11
    c[2] = 0b11
    c[2, :3] = 0b10                       # MAF 3 / (2 n): under a 0.01 filter
    return c


def _plink_bytes(codes: np.ndarray) -> np.ndarray:
    """PLINK's layout: sample ``n`` at byte ``n // 4``, slot ``n % 4``."""
    m, n = codes.shape
    c = np.zeros((m, -(-n // 4) * 4), np.uint8)
    c[:, :n] = codes
    c = c.reshape(m, -1, 4)
    return (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)).astype(np.uint8)


def _panel(n: int, p: int, seed: int) -> torch.Tensor:
    y = np.random.default_rng(seed).normal(size=(n, p))
    y = (y - y.mean(0)) / y.std(0)
    return torch.from_numpy(y.astype(np.float32))


def _inputs(device="cpu", seed=0, m=M_MARKERS, n=N_SAMPLES):
    packed = torch.from_numpy(_plink_bytes(_codes(m, n, seed))).to(device)
    dosages = kops.decode_packed_device(packed, n_samples=n)
    return packed, dosages, _panel(n, N_TRAITS, seed + 1).to(device)


def _step(packed_input: bool, **kw):
    args = dict(n_samples=N_SAMPLES, n_covariates=0, options=AssocOptions(),
                trait_tile=4, block_n=BLOCK_N, packed_input=packed_input)
    args.update(kw)
    return engines.build_dense_step(**args)


_ROUTE = engines.dense_product_route


def _take(monkeypatch, route: str) -> None:
    """Steps take ``route`` from now on: "library" always; "kernel" where
    the predicate gives it with every tensor read as lying on a card."""
    if route == "kernel":
        monkeypatch.setattr(engines, "dense_product_route",
                            lambda device, **kw: _ROUTE(torch.device("cuda"), **kw))
    else:
        monkeypatch.setattr(engines, "dense_product_route", lambda device, **kw: "library")


@pytest.fixture
def kernel_route(monkeypatch):
    """Take the kernel route on CPU tensors: ``gwas_dot_fused`` then runs
    its plain version (float64 sums, rounded once)."""
    _take(monkeypatch, "kernel")


def _t_tol(r: np.ndarray, dof: float) -> np.ndarray:
    """The r tolerance carried into t through dt/dr = sqrt(dof) (1 - r^2)^-3/2,
    plus the float32 rounding of t's two formulas."""
    r = np.abs(r.astype(np.float64)) + R_TOL
    return R_TOL * np.sqrt(dof) * (1.0 - r * r) ** -1.5 + 1e-6 * np.sqrt(dof) * r


def _assert_matches_library(got: dict, want: dict, dof: float) -> None:
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"].numpy())
    np.testing.assert_array_equal(got["maf"].numpy(), want["maf"].numpy())
    r, r0 = got["r"].numpy(), want["r"].numpy()
    np.testing.assert_allclose(r, r0, rtol=0, atol=R_TOL)
    t, t0 = got["t"].numpy(), want["t"].numpy()
    assert np.all(np.abs(t - t0) <= _t_tol(r0, dof))
    invalid = ~got["valid"].numpy()
    assert invalid[:2].all()              # all missing, monomorphic
    assert np.all(r[invalid] == 0) and np.all(t[invalid] == 0)


# ------------------------------------------------------------------ the route


@pytest.mark.parametrize("device,packed,dof_mode,mesh,route", [
    ("cuda", True, "paper", None, "kernel"),     # a card, packed staging, paper dof
    ("cuda:1", True, "paper", None, "kernel"),
    ("cpu", True, "paper", None, "library"),     # the kernel has no CPU mode
    ("cuda", False, "paper", None, "library"),   # dense staging: no codes
    ("cuda", True, "exact", None, "library"),    # residualized genotypes
    ("cuda", True, "paper", "mesh", "library"),  # the dense mesh step
])
def test_route_follows_device_staging_dof_and_mesh(device, packed, dof_mode, mesh, route):
    assert engines.dense_product_route(torch.device(device), packed_input=packed,
                                       dof_mode=dof_mode, mesh=mesh) == route


# ------------------------------------------------------ the glue on the CPU


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("maf_min", [0.0, 0.01])
def test_kernel_route_matches_library_route(kernel_route, monkeypatch, precision, sparse,
                                           maf_min):
    packed, _, y = _inputs()
    kw = dict(options=AssocOptions(precision=precision), sparse_epilogue=sparse,
              maf_min=maf_min)
    launches = gd.launches
    got = _step(True, **kw)(packed, y)
    assert gd.launches == launches         # the plain version: nothing launched
    _take(monkeypatch, "library")
    want = _step(True, **kw)(packed, y)
    dof = N_SAMPLES - 2
    _assert_matches_library(got, want, dof)
    assert bool(got["valid"][2]) == (maf_min == 0.0)
    assert set(got) == set(want)
    if sparse:
        np.testing.assert_array_equal(got["batch_best_row"].numpy(),
                                      want["batch_best_row"].numpy())
    else:
        nlp = got["nlp"].numpy()
        assert np.all(nlp[~got["valid"].numpy()] == 0)
        np.testing.assert_allclose(nlp, want["nlp"].numpy(), rtol=1e-4, atol=1e-4)


def test_kernel_route_statistics_equal_dense_staging(kernel_route):
    """The statistics come from the decoded batch as under dense staging: a
    dense-staged step (library route) gives the same ``valid`` and ``maf``
    bits and r within the contract."""
    packed, dosages, y = _inputs(seed=3)
    got = _step(True)(packed, y)
    want = _step(False)(dosages, y)
    _assert_matches_library(got, want, N_SAMPLES - 2)


def test_kernel_route_ragged_last_batch(kernel_route, monkeypatch):
    """A last batch of 37 markers (not a multiple of any tile) keeps its
    rows: nothing is padded into the outputs."""
    packed, _, y = _inputs(seed=5, m=37)
    got = _step(True, sparse_epilogue=True)(packed, y)
    assert got["r"].shape == (37, N_TRAITS) and got["t"].shape == (37, N_TRAITS)
    _take(monkeypatch, "library")
    want = _step(True, sparse_epilogue=True)(packed, y)
    _assert_matches_library(got, want, N_SAMPLES - 2)


@pytest.mark.parametrize("sparse", [True, False])
def test_kernel_route_blocked_equals_unblocked(kernel_route, monkeypatch, sparse):
    """Trait blocks at multiples of the trait tile give the unblocked
    columns bit for bit, as do calls over trait chunks narrower than the
    panel, and the memoized prolog gives what a fresh one does."""
    packed, _, y = _inputs(seed=7)
    whole = _step(True, sparse_epilogue=sparse)(packed, y)
    monkeypatch.setattr(engines, "KERNEL_TRAIT_CHUNK", 8)
    chunked = _step(True, sparse_epilogue=sparse)(packed, y)
    for k in whole:
        np.testing.assert_array_equal(chunked[k].numpy(), whole[k].numpy())
    step = _step(True, sparse_epilogue=sparse)
    mono = _step(True, sparse_epilogue=sparse, split_prolog=False)
    for lo, hi in ((0, 4), (4, 12)):
        for s in (step, mono):
            part = s(packed, y[:, lo:hi].contiguous())
            for k in ("r", "t") + (() if sparse else ("nlp",)):
                np.testing.assert_array_equal(part[k].numpy(), whole[k][:, lo:hi].numpy())


@pytest.mark.parametrize("route", ["kernel", "library"])
def test_each_cell_counts_its_route(monkeypatch, route):
    _take(monkeypatch, route)
    packed, _, y = _inputs(seed=9)
    step = _step(True, sparse_epilogue=True)
    base = spans.snapshot()
    spans.start()
    try:
        for lo, hi in ((0, 4), (4, 8), (8, 12)):
            step(packed, y[:, lo:hi].contiguous())
    finally:
        spans.stop()
        spans.take()
    assert spans.summary(base)["counters"] == {f"product_cells_{route}": 3}


# ------------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: gwas_dot is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("sparse", [True, False])
def test_cuda_packed_step_launches_gwas_dot_once_a_cell(precision, sparse):
    _card()
    packed, dosages, y = _inputs("cuda", seed=11)
    kw = dict(options=AssocOptions(precision=precision), sparse_epilogue=sparse)
    step, dense = _step(True, **kw), _step(False, **kw)
    for lo, hi in ((0, 8), (8, 12)):
        y_blk = y[:, lo:hi].contiguous()
        before = gd.launches
        got = step(packed, y_blk)
        assert gd.launches == before + 1
        want = dense(dosages, y_blk)
        assert gd.launches == before + 1
        _assert_matches_library({k: v.cpu() for k, v in got.items()},
                                {k: v.cpu() for k, v in want.items()}, N_SAMPLES - 2)


@pytest.mark.gpu
def test_cuda_exact_dof_keeps_the_library_product():
    _card()
    from repro_torch.core.residualize import covariate_basis

    packed, _, y = _inputs("cuda", seed=13)
    cov = np.random.default_rng(13).normal(size=(N_SAMPLES, 3))
    q = covariate_basis(cov, N_SAMPLES, device="cuda")
    before = gd.launches
    out = _step(True, n_covariates=3, options=AssocOptions(dof_mode="exact"),
                q_basis=q)(packed, y)
    torch.cuda.synchronize()
    assert gd.launches == before and out["r"].is_cuda


@pytest.mark.gpu
def test_cuda_trait_chunks_equal_one_call(monkeypatch):
    """Calls over trait chunks give the one wide call's tiles bit for bit,
    one launch a chunk."""
    _card()
    packed, _, y = _inputs("cuda", seed=17)
    whole = _step(True)(packed, y)
    monkeypatch.setattr(engines, "KERNEL_TRAIT_CHUNK", 8)
    before = gd.launches
    chunked = _step(True)(packed, y)
    torch.cuda.synchronize()
    assert gd.launches == before + 2
    for k in whole:
        assert torch.equal(chunked[k], whole[k]), k
