"""One training step of the port (``repro_torch.train.train_step``) against
the reference's on the same inputs: every LM arch at ``reduced()`` in
float32, the reference's weights carried across by ``params_from_jax`` and
the reference's ``make_batch`` batch at ``ShapeConfig("t", 32, 4,
"train")``.

The reference's gradients are those of its own jitted step: its
``build_train_step`` with ``adamw_update`` swapped for a function that
hands the gradients back, so the reference's ``_loss_fn`` runs under its
own ``jax.value_and_grad`` (and its microbatch scan).  Gradients are
compared leaf by leaf in the reference's layout: the port's go through
``convert.params_to_numpy`` into the reference's pytree, same structure.

Tolerances: loss, xent and moe_aux within 1e-5 relative; every gradient
leaf within 1e-4 * max |g| of that leaf; ``grad_norm`` within 1e-5
relative.  rwkv6-3b is the one exception, held at 1e-3 for the gradients
and ``grad_norm``: its gradient with respect to the second layer's input is
ill-conditioned (the WKV state's cotangent cancels), so float32 rounding is
amplified a hundredfold in any implementation.  The reference's own
gradients move by more than 1e-4 * max |g| when its weights move by one
float32 ulp (``test_rwkv6_gradient_is_ill_conditioned``), while the two
time-mix backwards, given the same inputs and cotangent, agree at 1e-4
(``test_rwkv6_time_mix_backward``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import LM_ARCHS  # noqa: E402
from repro.launch.train import flatten_state  # noqa: E402
from repro.models import api as RM  # noqa: E402
from repro.models import rwkv6 as RR  # noqa: E402
from repro.train.data import make_batch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import rwkv6 as PR  # noqa: E402
from torch_train_ref import (GRAD_REL, KEY, SHAPE, _cfgs, check_step, reference_run,  # noqa: E402,F401
                             runs)

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_one_step_parity(arch, runs):
    check_step(arch, *runs(arch))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "gemma2-9b"])
def test_rwkv6_gradient_is_ill_conditioned(arch):
    """Every weight moved by one float32 ulp (up or down at random): the
    reference's own gradients move by more than 1e-4 * max |g| on rwkv6-3b,
    and by less than its 1e-3 bound; on gemma2-9b, well-conditioned, by less
    than 1e-5."""
    rcfg, _ = _cfgs(arch)
    params = jax.tree.map(np.asarray, RM.init_model(rcfg, KEY, max_positions=64))
    rng = np.random.default_rng(5)
    bumped = jax.tree.map(lambda a: np.nextafter(a, np.where(rng.random(a.shape) < 0.5, np.inf,
                                                             -np.inf).astype(a.dtype)), params)
    batch = make_batch(rcfg, SHAPE, 0)
    g0, g1 = (flatten_state(reference_run(rcfg, p, batch)[0]) for p in (params, bumped))
    moved = max(float(np.abs(g1[k] - g0[k]).max()) / float(np.abs(g0[k]).max()) for k in g0)
    if arch == "rwkv6-3b":
        assert 1e-4 < moved < GRAD_REL[arch], moved
    else:
        assert moved < 1e-5, moved


def test_rwkv6_time_mix_backward():
    """The time mix's backward alone, on the same inputs and cotangent: the
    reference's ``jax.vjp`` and the port's autograd within 1e-4 * max |g|
    for the input and every parameter."""
    rcfg, pcfg = _cfgs("rwkv6-3b")
    params = RM.init_model(rcfg, KEY, max_positions=64)
    p0 = jax.tree.map(lambda a: np.asarray(a)[0], params["pattern"][0]["rwkv"])
    rng = np.random.default_rng(3)
    h = rng.normal(size=(4, 32, rcfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(4, 32, rcfg.d_model)).astype(np.float32)
    _, vjp = jax.vjp(lambda hh, pp: RR._time_mix(rcfg, pp, hh, None, None)[0],
                     jnp.asarray(h), jax.tree.map(jnp.asarray, p0))
    ref_dh, ref_dp = vjp(jnp.asarray(ct))
    block = PR.RWKV(pcfg, dtype=torch.float32, device="cpu")
    convert.load_params(block, p0)
    block.requires_grad_(True)
    ht = torch.tensor(h, requires_grad=True)
    out, _, _ = PR._time_mix(pcfg, block, ht, None, None)
    names = [n for n, _ in block.named_parameters()]
    got = torch.autograd.grad(out, [ht, *block.parameters()], torch.tensor(ct), allow_unused=True)
    for name, want, g in zip(["input", *names], [ref_dh, *(ref_dp[n] for n in names)], got):
        want = np.asarray(want)
        g = np.zeros_like(want) if g is None else g.numpy()
        assert float(np.abs(g - want).max()) <= 1e-4 * float(np.abs(want).max()), name
