"""The port's AdamW and schedules against the JAX package's, on the CPU.

One numpy-seeded tree of float32 or bfloat16 parameters and gradients goes
through ``repro.optim`` and ``repro_torch.optim``: the updated parameters,
the moments, the step and the pre-clip norm agree within 1e-6 (float32
rounding of the same expressions; bf16 parameters round to the same
values), with clipping on, off and not reached.  The port updates in place
and keeps its step counter as an int32 tensor; the schedules take and give
tensors.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.optim import adamw as J  # noqa: E402
from repro.optim import schedules as JS  # noqa: E402
from repro_torch.optim import adamw as T  # noqa: E402
from repro_torch.optim import schedules as TS  # noqa: E402

SHAPES = {"a": (8, 16), "b": {"c": (5,), "d": (3, 4, 2)}, "e": [(7, 3)]}
TOL = 1e-6


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
                                  SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _both(tree, dtype):
    return (jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree),
            jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)), tree))


def _close(jtree, ttree, tol=TOL):
    for a, b in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(ttree)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0, 1e3])
def test_adamw_matches_jax(dtype, clip):
    jp, tp = _both(_tree(0), dtype)
    jg, tg = _both(_tree(1, scale=3.0), dtype)
    js, ts = J.adamw_init(jp), T.adamw_init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.dim() == 0
    leaves = jax.tree_util.tree_leaves(tp)
    for _ in range(3):
        jp, js, jn = J.adamw_update(jg, js, jp, lr=1e-2, max_grad_norm=clip)
        out, ts, tn = T.adamw_update(tg, ts, tp, lr=torch.tensor(1e-2), max_grad_norm=clip)
        np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    # in place: the same tensors, updated
    assert all(a is b for a, b in zip(jax.tree_util.tree_leaves(out), leaves))
    _close(jp, tp)
    _close(js.mu, ts.mu)
    _close(js.nu, ts.nu)
    assert int(ts.step) == int(js.step) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_jax(dtype):
    jg, tg = _both(_tree(2, scale=5.0), dtype)
    np.testing.assert_allclose(float(T.global_norm(tg)), float(J.global_norm(jg)), rtol=TOL)
    for max_norm in (1.0, 1e4):
        jc, jn = J.clip_by_global_norm(jg, max_norm)
        tc, tn = T.clip_by_global_norm(tg, max_norm)
        assert isinstance(tn, torch.Tensor)
        np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
        _close(jc, tc)
        for a, b in zip(jax.tree_util.tree_leaves(tc), jax.tree_util.tree_leaves(tg)):
            assert a.dtype == b.dtype


@pytest.mark.parametrize("step", [0, 3, 9, 50, 99, 150])
def test_schedules_match_jax_as_tensors(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10)
    s = torch.tensor(step, dtype=torch.int32)
    got = TS.linear_warmup(s, **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(JS.linear_warmup(step, **kw)), rtol=1e-6)
    got = TS.cosine_schedule(s, total_steps=100, **kw)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(float(got), float(JS.cosine_schedule(step, total_steps=100, **kw)),
                               rtol=1e-6)
