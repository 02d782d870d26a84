"""The roofline (``repro_torch.launch.roofline``) against the reference's
``repro.launch.roofline``, bit for bit: parameter counts, model FLOPs, the
HBM floor and the recurrences' FLOPs for every LM arch x every shape, and
the GWAS step's FLOPs; a collective's wire bytes against the reference's
``parse_collectives`` on HLO lines of the same kind, dtype, shape and
group; and the trace half (``trace_step``, ``roofline_from_trace``) on
real CPU tensors."""
import pytest
import torch

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


@pytest.mark.parametrize("form", ["list", "iota"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32, torch.uint8,
                                   torch.bool])
@pytest.mark.parametrize("kind", PR.KINDS)
def test_wire_bytes_equal_parse_collectives(kind, dtype, form):
    """The HLO line carries the buffer the ring formula reads (a
    reduce-scatter's full input, as the reference's docstring has it) over a
    group of 4 ranks, written as a list or as the iota form."""
    c = PR.Collective.of(kind, 8 * 24, dtype, (4, 5, 6, 7))
    name = PR.hlo_dtype(dtype)
    groups = "{{4,5,6,7}}" if form == "list" else "[2,4]<=[8]"
    line = (f"  %c.1 = {name}[8,24]{{1,0}} {kind}({name}[2,24]{{1,0}} %p.0), "
            f"channel_id=1, replica_groups={groups}, dimensions={{0}}")
    (parsed,) = RR.parse_collectives(line)
    assert (c.kind, c.out_bytes, c.group_size, c.wire_bytes) == (
        parsed.kind, parsed.out_bytes, parsed.group_size, parsed.wire_bytes)
    assert c.ranks == (4, 5, 6, 7)


def test_links():
    hw = PR.HW()
    assert hw.link_bw(range(8)) == hw.link_bw((8, 15)) == 450e9
    assert hw.link_bw((7, 8)) == hw.link_bw(range(0, 256, 16)) == 50e9
    assert (hw.hbm_bytes, hw.peak_flops) == (80e9, 989e12)


def test_trace_step_on_real_tensors():
    """A step of known work: two products and a sum, one input updated in
    place.  FLOPs by FlopCounterMode; argument, output, alias and peak bytes
    in the card allocator's 512-byte blocks; temp by the reference's
    identity."""
    a = torch.ones(64, 32)
    b = torch.ones(32, 16)

    def step(a, b):
        h = a @ b                  # 4 KB
        y = (h @ b.T).sum()        # 8 KB, then a 0-d result
        a.mul_(2.0)
        return a, y

    (a_out, y), trace = PR.trace_step(step, a, b, device="cpu")
    assert a_out is a and float(y) == 64 * 32 * 16 * 32
    assert trace.flops == 2 * 64 * 32 * 16 + 2 * 64 * 16 * 32
    m = trace.memory
    assert m["argument_bytes"] == 8192 + 2048
    assert m["output_bytes"] == 8192 + 512 and m["alias_bytes"] == 8192
    # h (4 KB), h @ b.T (8 KB) and the sum (one 512-byte block) are live together
    assert m["peak_bytes"] == m["argument_bytes"] + 4096 + 8192 + 512
    assert m["peak_bytes"] == (m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
                               - m["alias_bytes"])
    assert trace.bytes_accessed > 0 and trace.collectives == [] and trace.kernel_calls == {}
    roof = PR.roofline_from_trace(trace, n_devices=1)
    assert roof["compute_s"] == trace.flops / 989e12 and roof["collective_s"] == 0.0
    assert roof["memory"] == m and roof["n_collectives"] == 0


def test_roofline_keys_equal_the_reference():
    class Compiled:
        def cost_analysis(self):
            return {"flops": 1.0, "bytes accessed": 1.0}

        def as_text(self):
            return ""

        def memory_analysis(self):
            return type("M", (), dict(argument_size_in_bytes=1, output_size_in_bytes=1,
                                      temp_size_in_bytes=1, alias_size_in_bytes=0))()

    ref = RR.roofline_from_compiled(Compiled(), n_devices=1)
    got = PR.roofline_from_trace(PR.trace_step(lambda x: x + 1, torch.ones(4), device="cpu")[1],
                                 n_devices=1)
    assert set(got) == set(ref) and set(got["memory"]) == set(ref["memory"])
