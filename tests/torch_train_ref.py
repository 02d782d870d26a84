"""Shared by ``tests/test_torch_train_parity.py`` and
``tests/test_torch_train_variants.py``: one training step of the reference
and of the port on the same weights and batch, and the comparison with its
tolerances (the first file's docstring gives them and their reason)."""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch.train import flatten_state  # noqa: E402
from repro.models import api as RM  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import train_step as RS  # noqa: E402
from repro.train.data import make_batch  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.train import optimizer as PO  # noqa: E402
from repro_torch.train import train_step as PS  # noqa: E402

torch.set_num_threads(1)

SHAPE = ShapeConfig("t", 32, 4, "train")
KEY = jax.random.PRNGKey(0)
LOSS_REL = 1e-5
GRAD_REL = {"rwkv6-3b": 1e-3}          # every other arch: 1e-4
NORM_REL = {"rwkv6-3b": 1e-3}          # every other arch: 1e-5


def _cfgs(arch):
    return [dataclasses.replace(get(arch).reduced(), dtype="float32")
            for get in (ref_config, port_config)]


def _hand_back(cfg, grads, state, params):
    return grads, state, {"grad_norm": RO.global_norm(grads), "lr": jnp.zeros((), jnp.float32)}


def reference_run(rcfg, params, batch, **tcfg):
    """The reference's jitted step, with the gradients as its output."""
    with mock.patch.object(RS, "adamw_update", _hand_back):
        step = RS.build_train_step(rcfg, tcfg=RS.TrainStepConfig(**tcfg), donate=False)
        grads, _, metrics = step(params, RO.adamw_init(RO.AdamWConfig(), params),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, grads), {k: float(v) for k, v in metrics.items()}


def port_run(pcfg, model, batch, **tcfg):
    loss, metrics, grads = PS.loss_and_grads(pcfg, PS.TrainStepConfig(**tcfg), model,
                                             {k: torch.as_tensor(v) for k, v in batch.items()})
    out = {"loss": float(loss), **{k: float(v) for k, v in metrics.items()},
           "grad_norm": float(PO.global_norm(grads.values()))}
    return convert.params_to_numpy(pcfg, model, grads), out


@pytest.fixture(scope="module")
def runs():
    """``get(arch, **tcfg) -> (ref grads, ref metrics, port grads, port
    metrics)``, each run once per module."""
    memo = {}

    def get(arch, **tcfg):
        key = (arch, tuple(sorted(tcfg.items())))
        if key not in memo:
            rcfg, pcfg = _cfgs(arch)
            params = RM.init_model(rcfg, KEY, max_positions=64)
            batch = make_batch(rcfg, SHAPE, 0)
            model = convert.params_from_jax(pcfg, jax.tree.map(np.asarray, params), device="cpu")
            memo[key] = (*reference_run(rcfg, params, batch, **tcfg),
                         *port_run(pcfg, model, batch, **tcfg))
        return memo[key]

    return get


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want else abs(got)


def check_step(arch, ref_tree, ref_m, port_tree, port_m):
    for name in ("loss", "xent", "moe_aux"):
        assert _rel(port_m[name], ref_m[name]) <= LOSS_REL, (arch, name, port_m, ref_m)
    assert jax.tree.structure(port_tree) == jax.tree.structure(ref_tree)
    ref_g, port_g = flatten_state(ref_tree), flatten_state(port_tree)
    tol = GRAD_REL.get(arch, 1e-4)
    worst = {k: float(np.abs(port_g[k] - ref_g[k]).max()) / max(float(np.abs(ref_g[k]).max()), 1e-30)
             for k in ref_g}
    bad = {k: v for k, v in worst.items() if v > tol}
    assert not bad, (arch, tol, bad)
    assert _rel(port_m["grad_norm"], ref_m["grad_norm"]) <= NORM_REL.get(arch, 1e-5), (arch, port_m, ref_m)


