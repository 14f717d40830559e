"""One training step of the port against JAX's, on the CPU: the MoE
architectures (B2's gradient inside a real step, on its plain version
here), then ``cfg.remat`` and ``make_train_step(remat=True)``.

Tolerances and the comparison as in ``test_torch_train_dense.py``.  Remat
recomputes each layer body's activations in the backward
(``torch.utils.checkpoint``; ``dots`` keeps the matrix products' outputs):
the gradients must equal those without it, and the step's metrics too.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.models import init_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from repro_torch.training.train_lib import batch_to_device  # noqa: E402
from test_torch_train_dense import assert_step_matches, batches, configs, jax_and_port  # noqa: E402

MOE = ["arctic-480b", "deepseek-v2-236b"]
# recomputation runs the same operations on the same values
REMAT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", MOE)
def test_one_step_matches_jax(arch):
    jm, want, m, model, _ = jax_and_port(arch)
    assert float(m["aux"]) > 0.0                 # the router's loss is in the step
    assert_step_matches(jm, want, m, model)


def _grads(cfg, batch, seed=0):
    model = init_model(torch.Generator().manual_seed(seed), cfg, device="cpu")
    step = make_train_step(cfg)
    loss, parts, grads, _ = step.loss_and_grads(model, batch_to_device(batch, "cpu"))
    return loss, grads


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-v2-236b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_remat_gives_the_same_gradients(arch, policy):
    _, cfg = configs(arch)
    batch = batches(*configs(arch), 1)[0]
    loss, want = _grads(cfg, batch)
    loss_r, got = _grads(dataclasses.replace(cfg, remat=True, remat_policy=policy), batch)
    np.testing.assert_allclose(float(loss_r), float(loss), rtol=REMAT_TOL)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=REMAT_TOL,
                                   atol=REMAT_TOL, err_msg=name)


def test_remat_recomputes_the_layers(monkeypatch):
    """With ``cfg.remat`` each layer body runs again in the backward: the
    flash attention's forward runs twice per layer."""
    from repro_torch.kernels.flash_attention import ops

    calls = []
    inner = ops.FlashAttention.forward
    monkeypatch.setattr(ops.FlashAttention, "forward",
                        staticmethod(lambda *a: calls.append(1) or inner(*a)))
    _, cfg = configs("phi4-mini-3.8b")
    batch = batches(*configs("phi4-mini-3.8b"), 1)[0]
    _grads(cfg, batch)
    plain = len(calls)
    _grads(dataclasses.replace(cfg, remat=True), batch)
    assert plain == cfg.n_layers and len(calls) - plain == 2 * cfg.n_layers


def test_whole_loss_remat_step_equals_the_plain_step():
    _, cfg = configs("arctic-480b")
    data = batches(*configs("arctic-480b"), 1)[0]
    out = []
    for remat in (False, True):
        model = init_model(torch.Generator().manual_seed(1), cfg, device="cpu")
        state = adamw_init(dict(model.named_parameters()))
        m = make_train_step(cfg, remat=remat)(model, state, batch_to_device(data, "cpu"))[2]
        out.append((m, [p.detach().clone() for p in model.parameters()]))
    (m0, p0), (m1, p1) = out
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=REMAT_TOL, err_msg=k)
    for a, b in zip(p0, p1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=REMAT_TOL)
