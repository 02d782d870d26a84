"""The analytic roofline (``repro_torch.launch.roofline``) against the
reference's ``repro.launch.roofline``, bit for bit: parameter counts, model
FLOPs, the HBM floor and the recurrences' FLOPs for every LM arch x every
shape, and the GWAS step's FLOPs."""
import pytest

from repro.configs import get_config as ref_config
from repro.launch import roofline as RR
from repro_torch.configs import LM_ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline as PR


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_counts_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert PR.param_count(cfg) == RR.param_count(rcfg)
    for shape in SHAPES.values():
        assert PR.model_flops(cfg, shape) == RR.model_flops(rcfg, shape)
        assert PR.recurrence_flops(cfg, shape) == RR.recurrence_flops(rcfg, shape)
        for n in (1, 4, 16, 256):
            for state_bytes in (2, 4):
                assert (PR.memory_floor_bytes(cfg, shape, n, state_dtype_bytes=state_bytes)
                        == RR.memory_floor_bytes(rcfg, shape, n, state_dtype_bytes=state_bytes))


@pytest.mark.parametrize("reduced", [False, True])
def test_gwas_flops_equal_the_reference(reduced):
    cfg, rcfg = get_config("gwas_ukb"), ref_config("gwas_ukb")
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    for batch_only in (True, False):
        assert PR.gwas_flops(cfg, batch_only=batch_only) == RR.gwas_flops(rcfg, batch_only=batch_only)


def test_granite_train_bound():
    """granite-moe-1b-a400m's training cell: 1,384,912,896 parameters
    (478,943,232 active), and ~5.70e13 FLOP for a B=4, S=4,096 step: 57.6
    ms at the H100's 989 TFLOP/s."""
    cfg = get_config("granite-moe-1b-a400m")
    assert PR.param_count(cfg) == (1_384_912_896, 478_943_232)
    shape = ShapeConfig("train_4k", 4096, 4, "train")
    flops = PR.model_flops(cfg, shape)
    assert flops == pytest.approx(5.70e13, rel=2e-3)
    assert flops / PR.HW().peak_flops == pytest.approx(0.0576, rel=2e-3)
