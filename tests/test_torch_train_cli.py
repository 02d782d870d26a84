"""``python -m repro_torch.launch.train`` on the CPU: the reference's log
lines, checkpoints under the reference's flat keys, resume, and checkpoints
carried between the two packages' drivers.

Across packages both drivers run a float32 copy of granite-moe-1b-a400m's
``reduced()`` (the reference's driver cannot restore its own bfloat16
checkpoints: ``np.load`` gives its bfloat16 arrays back as ``|V2`` words,
which ``jnp.asarray`` cannot cast; ROADMAP.md §3).  One package writes step
2; each package resumes from a copy and takes step 3.  Their step-3 states
agree at the parity tolerances: AdamW's m within 1e-4 * max |m| and v
within 2e-4 * max |v| per leaf (the gradients' tolerance; v is quadratic
in them), the count exactly, and every parameter within 2.5 * lr of the
other's (Adam's early steps move an entry by about lr * sign(g), whose sign
a near-zero gradient may flip between two correct implementations).
"""
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.launch.train as ref_train  # noqa: E402
import repro_torch.launch.train as port_train  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.runtime.checkpoint import TrainCheckpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-moe-1b-a400m"
LOG = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})  gnorm \d+\.\d{2}  lr \d\.\d{2}e[-+]\d{2}  "
                 r"tok/s [\d,]+$")


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
                          "--reduced", "--device", "cpu", *args],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def _losses(lines):
    return {int(m.group(1)): m.group(2) for m in map(LOG.match, lines) if m}


def test_cli_logs_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    first = _cli(tmp_path, "--steps", "2", "--log-every", "2", "--checkpoint-dir", ck,
                 "--checkpoint-every", "2")
    assert LOG.match(first[0]) and first[-1] == "done.", first
    resumed = _cli(tmp_path, "--steps", "4", "--log-every", "2", "--checkpoint-dir", ck,
                   "--checkpoint-every", "2")
    assert resumed[0] == "resumed from step 2" and resumed[-1] == "done.", resumed
    whole = _cli(tmp_path, "--steps", "4", "--log-every", "2")
    assert _losses(resumed) == {4: _losses(whole)[4]}          # the same run
    step, flat = TrainCheckpoint(ck).restore()
    assert step == 4 and int(flat["o/count"]) == 4
    # bfloat16 leaves are stored as the 2-byte words the reference's files hold
    assert flat["p/embed"].dtype == np.dtype("V2") and flat["p/pattern/[0]/ln1"].dtype == np.float32
    assert flat["o/m/pattern/[0]/moe/w_in"].shape == (2, 4, 64, 64)


def test_mesh_raises(monkeypatch):
    """``--mesh pod`` with no torch.distributed world (none initialized, no
    torchrun environment) raises; it never falls back to one process.  The
    mesh runs in ``tests/test_torch_lm_mesh.py``."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        port_train.main(["--arch", ARCH, "--reduced", "--mesh", "pod", "--device", "cpu"])


@pytest.fixture
def float32_configs(monkeypatch):
    """Both drivers on float32 configs."""
    for module, get in ((ref_train, ref_config), (port_train, port_config)):
        monkeypatch.setattr(module, "get_config",
                            lambda arch, get=get: dataclasses.replace(get(arch), dtype="float32"))


def _run(package, ck, steps, capsys):
    args = ["--arch", ARCH, "--reduced", "--steps", str(steps), "--log-every", "1",
            "--checkpoint-dir", ck, "--checkpoint-every", "1"]
    if package == "port":
        port_train.main([*args, "--device", "cpu"])
    else:
        ref_train.main(args)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages(writer, tmp_path, float32_configs, capsys):
    base = str(tmp_path / "base")
    _run(writer, base, 2, capsys)
    # the port restores the written state exactly, under the same keys
    _, flat = TrainCheckpoint(base).restore()
    cfg = dataclasses.replace(port_config(ARCH), dtype="float32").reduced()
    tcfg = port_train.TrainStepConfig()
    model, opt = port_train.init_train_state(cfg, tcfg, None, device="cpu", max_positions=64)
    opt = port_train.restore_state(cfg, model, opt, flat)
    again = port_train.flatten_state(cfg, model, opt)
    assert again.keys() == flat.keys()
    assert all(np.array_equal(again[k], flat[k]) for k in flat)
    # each package resumes from a copy and takes step 3
    logs, states = {}, {}
    for package in ("reference", "port"):
        ck = str(tmp_path / package)
        shutil.copytree(base, ck)
        logs[package] = _run(package, ck, 3, capsys)
        assert logs[package][0] == "resumed from step 2", logs[package]
        step, states[package] = TrainCheckpoint(ck).restore()
        assert step == 3
    ref, port = states["reference"], states["port"]
    assert ref.keys() == port.keys() and int(ref["o/count"]) == int(port["o/count"]) == 3
    loss = {p: float(_losses(lines)[3]) for p, lines in logs.items()}
    assert abs(loss["port"] - loss["reference"]) <= 1e-4 + 1e-5 * loss["reference"]
    lr = 3e-4 * 3 / 100          # the cosine schedule's warm-up at count 3
    for key in ref:
        diff = float(np.abs(port[key].astype(np.float64) - ref[key]).max())
        scale = float(np.abs(ref[key]).max())
        if key.startswith("o/m/"):
            assert diff <= 1e-4 * scale, key
        elif key.startswith("o/v/"):
            assert diff <= 2e-4 * scale, key
        elif key.startswith("p/"):
            assert diff <= 2.5 * lr, key
