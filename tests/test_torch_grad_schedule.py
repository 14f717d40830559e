"""Gradients through a schedule: the port's Nimble over ``torch.func.grad``
of a loss, against ``jax.grad`` of the JAX package's (the counterpart of
``test_aot_engine.py::test_grad_through_schedule``, paper §5.3: AoT
scheduling works for training graphs too).

On ``_branchy`` and the four branchy cells at full size, with the JAX
weights carried over, the backward graph goes through the whole pipeline:
``make_fx(functionalize(...))``, Algorithm 1's streams, the memory plan and
the rewriter's packs (the weight gradients' and the input gradients' mm
groups go to stream_pack, its plain version on the CPU).  Single-stream,
multi-stream and packed schedules agree with the port's eager
``torch.func.grad`` within rtol 1e-4, atol 1e-5, as the JAX test holds its
own, and with ``jax.grad`` at the same rtol and atol on each gradient
divided by its largest magnitude: the cells' weight gradients are large
and some of their elements cancel to near 0, where the two frameworks'
float32 rounding of the summands exceeds an absolute 1e-5.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import Nimble  # noqa: E402
from test_torch_aot import CASES, _case  # noqa: E402

ENGINES = {"single_stream": dict(multi_stream=False), "multi_stream": {},
           "packed": dict(pack_streams=True)}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _losses(name):
    """(JAX loss, port loss, JAX args, port args), weights first."""
    c = _case(name)
    if name == "branchy4":               # (x, ws): differentiate the weights
        jx, jws = c.jax_args
        x, ws = c.args
        return (lambda ws, x: jnp.sum(c.jax_fn(x, ws) ** 2),
                lambda ws, x: torch.sum(c.fn(x, ws) ** 2), (jws, jx), (ws, x))
    return (lambda p, x: jnp.sum(c.jax_fn(p, x) ** 2),
            lambda p, x: torch.sum(c.fn(p, x) ** 2), c.jax_args, c.args)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", CASES)
def test_grad_through_schedule_matches_jax(name, engine):
    jloss, loss, jargs, args = _losses(name)
    want = jax.tree_util.tree_leaves(jax.grad(jloss)(*jargs))
    grad = torch.func.grad(loss)
    eager = jax.tree_util.tree_leaves(grad(*args))
    nimble = Nimble(grad, *args, **ENGINES[engine])
    got = jax.tree_util.tree_leaves(nimble(*args))
    assert len(got) == len(want) == len(eager)
    for g, e, w in zip(got, eager, want):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-4, atol=1e-5)
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy() / scale, np.asarray(w) / scale, rtol=1e-4,
                                   atol=1e-5)
    st = nimble.stats
    assert st.num_tasks > 2 * len(want)            # the forward and the backward
    if engine == "multi_stream":
        assert st.num_streams > 1 and st.num_syncs == (
            len(nimble.schedule.streams.meg_edges) - nimble.schedule.streams.matching_size)


def test_packed_gradient_schedule_packs_the_backward_products():
    """darts-like: beside the forward's mm and tanh groups, the backward's
    tanh_backward groups and both products of each branch (its weight's
    gradient and its input's) are packed, n_branches lanes each."""
    _, loss, _, args = _losses("darts_like")
    rep = Nimble(torch.func.grad(loss), *args, pack_streams=True).schedule.pack_report
    ops = {op for op, _ in rep.groups}
    assert {"mm", "tanh", "tanh_backward"} <= ops
    n = _case("darts_like").n_branches
    assert all(lanes == n for _, lanes in rep.groups)
    assert sum(1 for op, _ in rep.groups if op == "mm") > _case("darts_like").n_cells
