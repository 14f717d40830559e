"""The port's ``JitPerOpEngine`` (Fig. 7's TorchScript column) against the
JAX package's, on the CPU.

On ``_branchy`` and the four branchy cells at full size, with the JAX
weights carried over by ``bridge.branchy_params_from_jax``: its outputs
equal the port's ``EagerInterpreter`` and JAX's ``JitPerOpEngine`` within
1e-5 (float32 summation order), on the example input and on another one;
the work it schedules at run time is the traced task list.
"""

import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.core.engine as JE  # noqa: E402
from repro.configs import branchy_cell as jax_cells  # noqa: E402
from repro.models import branchy as jax_branchy  # noqa: E402
from repro_torch.bridge import branchy_params_from_jax  # noqa: E402
from repro_torch.configs import branchy_cell as cells  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DispatchProfile,
    EagerInterpreter,
    JitPerOpEngine,
    compare_engines,
)
from repro_torch.models import branchy  # noqa: E402

CONFIGS = ["darts_like", "nasnet_mobile_like", "amoebanet_like", "inception_like"]
TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _cell(name: str):
    """(JAX fn, JAX params, port fn, port params, inputs as numpy)."""
    jcfg, cfg = getattr(jax_cells, name)(), getattr(cells, name)()
    params = jax_branchy.init_branchy(jax.random.key(0), jcfg)
    xs = [np.array(jax_branchy.example_input(jcfg, seed)) for seed in (0, 1)]

    def jax_fn(p, x, _c=jcfg):
        return jax_branchy.branchy_forward(p, x, _c)

    def fn(p, x, _c=cfg):
        return branchy.branchy_forward(p, x, _c)

    tparams = branchy_params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jax_fn, params, fn, tparams, xs


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_matches_the_interpreter_and_jax(name):
    jax_fn, params, fn, tparams, xs = _cell(name)
    x0 = torch.from_numpy(xs[0])
    jit = JitPerOpEngine(fn, tparams, x0)
    eager = EagerInterpreter(fn, tparams, x0)
    jax_jit = JE.JitPerOpEngine(jax_fn, params, xs[0])
    for x in xs:                          # the example input and another one
        tx = torch.from_numpy(x)
        got = jit(tparams, tx)
        _close(got, eager(tparams, tx))
        _close(got, jax_jit(params, x))


@pytest.mark.parametrize("name", CONFIGS)
def test_schedules_every_task_at_run_time(name):
    """Every traced task is dispatched on every call (the profile counts
    them), and the engine reads its arguments from where the trace put
    them: a call with other weights gives the eager function's result."""
    _, _, fn, tparams, xs = _cell(name)
    x = torch.from_numpy(xs[0])
    jit = JitPerOpEngine(fn, tparams, x)
    prof = DispatchProfile()
    jit(tparams, x, profile=prof)
    jit(tparams, x, profile=prof)
    assert prof.num_tasks == 2 * jit.traced.graph.num_tasks and prof.total_s > 0
    other = {k: v * 0.5 for k, v in tparams.items()}
    with torch.no_grad():
        _close(jit(other, x), fn(other, x))


def test_compare_engines_times_the_jit_column():
    _, _, fn, tparams, xs = _cell("darts_like")
    res = compare_engines(fn, tparams, torch.from_numpy(xs[0]), iters=2, warmup=1)
    assert res["jit_us"] > 0 and res["eager_us"] > 0 and res["aot_us"] > 0
