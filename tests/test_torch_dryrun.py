"""The dry run (``repro_torch.launch.dryrun``) on the CPU.

- A gloo world of 4 processes runs the port's steps on real tensors:
  gemma2-9b training on (2, 2), granite-moe-1b-a400m training on (4, 1),
  qwen1.5-32b prefill and decode on (1, 4), and recurrentgemma-2b, rwkv6-3b
  and granite-moe-1b-a400m decode on (1, 4), all at ``reduced()`` widths in
  float32.  Each rank then leaves the world and traces the same cells as the
  same rank of a fake world of 4 (``launch.mesh.fake_world``, under
  ``FakeTensorMode``).  Both run through ``launch.roofline.trace_step`` on
  the CPU, as the gloo world runs there: the argument bytes, the list of
  (kind, bytes, ranks) collectives and the FLOP total must be equal.
- Every cell of ``cell_inventory`` but the assigned skips (every arch x
  every supported shape, every GWAS engine at both trait counts), at
  ``reduced()`` widths, comes back ``status: ok`` on fake (2, 2) and
  (2, 4, 1) worlds (two child processes each, run at once), with no kernel
  launched, every key of the reference's records present, and the analytic
  numbers (model FLOPs, HBM floor, parameter counts) equal to the
  reference's functions.
- ``cell_inventory``, ``TRAIN_OVERRIDES`` and ``VARIANT_FLAGS`` equal the
  reference's (read in a child: importing ``repro.launch.dryrun`` sets
  ``XLA_FLAGS`` for 512 devices).
"""
import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
import textwrap

import pytest

from repro.configs import get_config as ref_config
from repro.configs.base import ShapeConfig as RefShape
from repro.launch import roofline as RR
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
WORLD = 4
TIMEOUT_S = 300
# the gloo world's cells: (label, arch, mesh shape, shape, training overrides)
GLOO_CELLS = (
    ("gemma2_train", "gemma2-9b", (2, 2), ("train_4k", 32, 8, "train"),
     dict(n_microbatches=2, remat="full", loss_chunk=16)),
    ("granite_train", "granite-moe-1b-a400m", (4, 1), ("train_4k", 32, 8, "train"),
     dict(remat="dots")),
    ("qwen_prefill", "qwen1.5-32b", (1, 4), ("prefill_32k", 48, 4, "prefill"), None),
    ("qwen_decode", "qwen1.5-32b", (1, 4), ("decode_32k", 48, 4, "decode"), None),
    # the split recurrent and expert layers' collectives: an all-to-all and a
    # reduce-scatter (rg-lru), sums after rwkv6's channel mix and the experts
    ("recurrentgemma_decode", "recurrentgemma-2b", (1, 4), ("decode_32k", 48, 4, "decode"),
     None),
    ("rwkv6_decode", "rwkv6-3b", (1, 4), ("decode_32k", 48, 4, "decode"), None),
    ("granite_decode", "granite-moe-1b-a400m", (1, 4), ("decode_32k", 48, 4, "decode"), None),
)
WORLDS = {"pod": (2, 2), "multipod": (2, 4, 1)}


def env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH")) if p))


def gloo_cell(arch: str, shape, tcfg):
    """(float32 reduced config, ShapeConfig, TrainStepConfig or None) of a
    gloo cell."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.train_step import TrainStepConfig

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return cfg, ShapeConfig(*shape), None if tcfg is None else TrainStepConfig(**tcfg)


def summary(trace) -> dict:
    return {"argument_bytes": trace.memory["argument_bytes"],
            "collectives": [(c.kind, c.out_bytes, c.ranks) for c in trace.collectives],
            "flops": trace.flops}


_RANK = textwrap.dedent(
    r"""
    import datetime, pickle, sys
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from test_torch_dryrun import GLOO_CELLS, gloo_cell, summary
    from repro_torch.launch.dryrun import trace_lm_cell
    from repro_torch.launch.mesh import fake_world, make_mesh

    def traces(fake):
        res = {}
        for label, arch, mesh_shape, shape, tcfg in GLOO_CELLS:
            cfg, shape, tcfg = gloo_cell(arch, shape, tcfg)
            mesh = make_mesh(mesh_shape, ("data", "model"))
            res[label] = summary(trace_lm_cell(arch, shape, mesh, cfg=cfg, tcfg=tcfg,
                                               fake=fake)[0])
        return res

    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=240))
    real = traces(False)
    dist.destroy_process_group()
    with fake_world(world, rank, device="cpu"):
        fake = traces(True)
    with open(out, "wb") as f:
        pickle.dump({"real": real, "fake": fake}, f)
    """
)

_INVENTORY = textwrap.dedent(
    r"""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun as D
    from repro_torch.kernels import tstat as ts
    from repro_torch.kernels.gwas_dot import gwas_dot as gd
    kind, shape, cells = sys.argv[1], tuple(json.loads(sys.argv[2])), json.loads(sys.argv[3])
    records = []
    for arch, name in cells:
        try:
            records.append(D.run_cell(arch, name, kind, world_shape=shape, reduced=True))
        except Exception as e:
            records.append({"arch": arch, "shape": name, "status": "error", "error": repr(e)})
    launches = [gd.launches, ts.tstat_launches, ts.screen_launches, ts.compact_launches]
    print("RESULT " + json.dumps({"records": records, "launches": launches}))
    """
)


def inventory_cells() -> list[tuple[str, str]]:
    """Every cell of ``cell_inventory`` but the assigned skips: every arch x
    every supported shape, and every GWAS engine at both trait counts."""
    return [(arch, shape) for arch, shape, skip in D.cell_inventory() if skip is None]


def _halves(cells: list) -> list[list]:
    return [cells[0::2], cells[1::2]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo world's and the inventory children's results, all started
    at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    store = str(tmp / "store")
    ranks = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(WORLD), store,
                               str(tmp / f"rank{r}.pkl")], env=env(), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    inventory = {(kind, i): subprocess.Popen(
        [sys.executable, "-c", _INVENTORY, kind, json.dumps(shape), json.dumps(cells)],
        env=env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for kind, shape in WORLDS.items() for i, cells in enumerate(_halves(inventory_cells()))}
    out = {"ranks": [], "inventory": {}}
    try:
        for r, proc in enumerate(ranks):
            log, _ = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, f"rank {r}:\n{log[-4000:]}"
            with open(tmp / f"rank{r}.pkl", "rb") as f:
                out["ranks"].append(pickle.load(f))
        for (kind, i), proc in inventory.items():
            log, _ = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, f"inventory {kind}:\n{log[-4000:]}"
            line = next(ln for ln in log.splitlines() if ln.startswith("RESULT "))
            res = json.loads(line[len("RESULT "):])
            got = out["inventory"].setdefault(kind, {"records": [None] * len(inventory_cells()),
                                                     "launches": [0, 0, 0, 0]})
            got["records"][i::2] = res["records"]
            got["launches"] = [a + b for a, b in zip(got["launches"], res["launches"])]
    finally:
        for proc in ranks + list(inventory.values()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("label", [c[0] for c in GLOO_CELLS])
def test_fake_world_equals_gloo_world(runs, label):
    for r, res in enumerate(runs["ranks"]):
        real, fake = res["real"][label], res["fake"][label]
        assert real["collectives"], f"rank {r}: no collective recorded"
        assert fake == real, f"rank {r}"


def test_gloo_cells_split_their_ranks(runs):
    """The ranks' argument bytes are their blocks: under a split they are
    smaller than the whole model's, and the collectives name the rank's
    groups."""
    for label, arch, mesh_shape, _, _ in GLOO_CELLS:
        groups = {c[2] for res in runs["ranks"] for c in res["real"][label]["collectives"]}
        data, model = mesh_shape
        want = ({tuple(range(r * model, (r + 1) * model)) for r in range(data)} if model > 1
                else set())
        want |= ({tuple(range(c, WORLD, model)) for c in range(model)} if data > 1 else set())
        assert groups <= want and groups, (label, groups)


def _reference_keys() -> set[str]:
    """The keys of the reference's ok records: the ones ``run_cell`` sets,
    and ``roofline_from_compiled``'s (from a stub compiled executable)."""
    with open(os.path.join(SRC, "repro", "launch", "dryrun.py")) as f:
        src = f.read()
    body = src[src.index("def run_cell"):src.index("def cell_inventory")]
    keys = set(re.findall(r'record\["(\w+)"\]', body))
    keys |= set(re.findall(r'^\s+"(\w+)": ', body[:body.index("hw = ")], re.M))

    class Compiled:
        def cost_analysis(self):
            return {"flops": 1.0, "bytes accessed": 1.0}

        def as_text(self):
            return ""

        def memory_analysis(self):
            return type("M", (), dict(argument_size_in_bytes=1, output_size_in_bytes=1,
                                      temp_size_in_bytes=1, alias_size_in_bytes=0))()

    return keys | set(RR.roofline_from_compiled(Compiled(), n_devices=1))


@pytest.mark.parametrize("kind", list(WORLDS))
def test_every_cell_traces(runs, kind):
    res = runs["inventory"][kind]
    assert res["launches"] == [0, 0, 0, 0], "a kernel launched in a dry run"
    keys = _reference_keys()
    assert {"accounting", "memory", "fits_hbm"} <= keys
    cells = inventory_cells()
    assert len(res["records"]) == len(cells)
    for (arch, name), rec in zip(cells, res["records"]):
        assert rec["status"] == "ok", rec
        missing = keys - set(rec) - ({"accounting"} if arch == "gwas_ukb" else set())
        assert not missing, (arch, name, missing)
        assert rec["compile_s"] == 0.0 and rec["n_devices"] == (4 if kind == "pod" else 8)
        assert rec["traced_on"] == ("cuda" if arch == "gwas_ukb" else "cpu")
        assert rec["hbm_bytes"] == 80e9 and rec["fits_hbm"]
        assert rec["hbm_util"] == round(rec["memory"]["peak_bytes"] / 80e9, 3)
        assert rec["flops_per_device"] > 0 and rec["memory"]["peak_bytes"] > 0
        m = rec["memory"]
        assert m["peak_bytes"] == (m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
                                   - m["alias_bytes"])
        if arch == "gwas_ukb":
            # the fused engines count the kernel by its formula; nothing launched
            assert rec["kernel_calls"] == ({"gwas_dot": 1} if name.startswith("fused") else {})
        else:
            assert rec["collectives_by_kind"], (arch, name)


@pytest.mark.parametrize("kind", list(WORLDS))
def test_analytic_numbers_equal_the_reference(runs, kind):
    for (arch, name), rec in zip(inventory_cells(), runs["inventory"][kind]["records"]):
        if arch == "gwas_ukb":
            g = ref_config("gwas_ukb").reduced()
            if name.endswith("_p2k"):
                g = dataclasses.replace(g, n_traits=2_048)
            assert rec["model_flops_global"] == RR.gwas_flops(g)
            continue
        rcfg = ref_config(arch).reduced()
        dp = 2 if kind == "pod" else 8
        rshape = RefShape(name, 32, max(2, dp), SHAPES[name].kind)
        n = rec["n_devices"]
        ov = D.TRAIN_OVERRIDES.get(arch, {})
        assert rec["model_flops_global"] == RR.model_flops(rcfg, rshape)
        assert rec["memory_floor_bytes"] == RR.memory_floor_bytes(
            rcfg, rshape, n, state_dtype_bytes=2 if ov.get("state_dtype") == "bfloat16" else 4)
        assert (rec["params_total"], rec["params_active"]) == RR.param_count(rcfg)


def test_tables_equal_the_reference():
    code = ("import json; from repro.launch import dryrun as R; print('RESULT ' + json.dumps("
            "{'cells': R.cell_inventory(), 'overrides': R.TRAIN_OVERRIDES, "
            "'variants': R.VARIANT_FLAGS}))")
    out = subprocess.run([sys.executable, "-c", code], env=dict(env(), JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=TIMEOUT_S, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(next(ln for ln in out.stdout.splitlines()
                          if ln.startswith("RESULT "))[len("RESULT "):])
    assert [list(c) for c in D.cell_inventory()] == ref["cells"]
    assert D.TRAIN_OVERRIDES == ref["overrides"]
    assert D.VARIANT_FLAGS == ref["variants"]


def test_orchestrator_resumes_and_records_skips(tmp_path, capsys):
    """``--all`` runs only the cells without a record, and writes the
    assigned skips as the reference does."""
    cells = D.cell_inventory()
    for arch, shape, skip in cells:
        if skip is None:
            for kind in ("pod", "multipod"):
                (tmp_path / f"{arch}__{shape}__{kind}.json").write_text("{}")
    D.main(["--all", "--mesh", "both", "--out-dir", str(tmp_path)])
    assert "0 cells to run" in capsys.readouterr().out
    skips = [(a, s, r) for a, s, r in cells if r is not None]
    assert skips
    for arch, shape, reason in skips:
        for kind in ("pod", "multipod"):
            rec = json.loads((tmp_path / f"{arch}__{shape}__{kind}.json").read_text())
            assert rec == {"arch": arch, "shape": shape, "mesh_kind": kind, "status": "skip",
                           "skip_reason": reason}


def test_fake_card_only_under_fake_mode():
    """On a fake world the meshes lie on the card; its device resolves to a
    fake ``cuda:0`` under ``FakeTensorMode`` and nowhere else (without a
    card, resolving it outside raises, as before)."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.device import resolve_device

    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        assert mesh.device_type == "cuda" and dist.get_backend() == "fake"
        with FakeTensorMode():
            assert sh.local_device(mesh) == torch.device("cuda", 0)
            assert sh.mesh_device(mesh) == torch.device("cuda", 0)
            assert resolve_device("cuda:1") == torch.device("cuda", 1)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                resolve_device("cuda")
        with pytest.raises(RuntimeError):
            with fake_world(2):
                pass
    assert not dist.is_initialized()
