"""Remat ``full``/``dots``, the chunked loss and microbatches on gemma2-9b,
granite-moe-1b-a400m and qwen2-vl-7b: one training step of the port
against the reference's jitted step with the same settings, at the
tolerances of ``tests/test_torch_train_parity.py``."""
import pytest

pytest.importorskip("jax")

from torch_train_ref import check_step, runs  # noqa: E402,F401

VARIANTS = {"remat_full": dict(remat="full"), "remat_dots": dict(remat="dots"),
            "loss_chunk_8": dict(loss_chunk=8), "microbatches_4": dict(n_microbatches=4)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-moe-1b-a400m", "qwen2-vl-7b"])
def test_variant_parity(arch, variant, runs):
    """Remat, the chunked loss and microbatches, each held to the reference
    run with the same settings at the same tolerances."""
    check_step(arch, *runs(arch, **VARIANTS[variant]))
