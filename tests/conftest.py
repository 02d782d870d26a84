"""Shared fixtures.  NOTE: no XLA_FLAGS here by design — unit/smoke tests
must see the real single-CPU device; only launch/dryrun.py forces the
512-device placeholder topology (in a subprocess)."""
from __future__ import annotations

import os

import numpy as np
import pytest

from repro.io import synth


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)"
    )


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Tooling byproducts that may legitimately appear in the checkout.
_TREE_IGNORED = {".pytest_cache", "__pycache__", ".hypothesis"}


@pytest.fixture(autouse=True)
def _no_repo_tree_dirt():
    """Fail any test that leaves new entries in the repo root (e.g. a
    subprocess child running with a repo cwd and writing relative paths —
    the historical ``hostB/`` leak).  Write under ``tmp_path`` instead."""
    before = set(os.listdir(_REPO_ROOT)) - _TREE_IGNORED
    yield
    new = (set(os.listdir(_REPO_ROOT)) - _TREE_IGNORED) - before
    assert not new, (
        f"test dirtied the repo root with {sorted(new)}; tests and their "
        "subprocesses must write under tmp_path"
    )


@pytest.fixture(scope="session")
def cohort():
    return synth.make_cohort(
        n_samples=400,
        n_markers=600,
        n_traits=12,
        n_causal=8,
        effect_size=0.6,
        missing_rate=0.02,
        seed=7,
    )


@pytest.fixture(scope="session")
def cohort_files(cohort, tmp_path_factory):
    stem = str(tmp_path_factory.mktemp("cohort") / "toy")
    return synth.write_cohort_files(cohort, stem)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
