"""The port's ``AsyncDispatcher`` over real engines against the JAX
package's, on the CPU.

Two lanes, stablelm-1.6b's smoke config (dense) and deepseek-v2-236b's (MoE,
MLA), float32, with one set of weights: drawn by JAX and carried into the
port through ``repro_torch.bridge``.  The same requests go through JAX's
``AsyncDispatcher`` over JAX engines and through the port's over the port's
engines, in the ``per-engine``, ``single`` and ``pool`` stepping modes: the
greedy tokens are equal, and no stepper seals a step.  Prompts stay within
buckets 8 and 16, so every MoE call is dropless and a request's tokens do
not depend on which requests share its batch (the stepping threads decide
that).
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.dispatch as JD  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.dispatch as TD  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ARCHS = ("stablelm-1.6b", "deepseek-v2-236b")
ENGINE = dict(max_slots=2, max_len=48, bucketing=(8, 16))


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lanes():
    """``{arch: (jax engine, port engine, vocab)}``, one set of weights."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = dataclasses.replace(JC.get(arch, smoke=True), dtype="float32")
        tcfg = dataclasses.replace(TC.get(arch, smoke=True), dtype="float32")
        params, _ = jax_init_model(jax.random.key(i), jcfg)
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
        out[arch] = (JaxServingEngine(jcfg, params, **ENGINE),
                     ServingEngine(tcfg, model, device="cpu", **ENGINE), jcfg.vocab)
    return out


def _work(vocab, seed, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(3, 17))), int(rng.integers(2, 9)))
            for _ in range(n)]


def _serve(D, engines: dict, work: dict, stepping: str, dtype) -> dict:
    disp = D.AsyncDispatcher(stepping=stepping, pool_size=2, max_pending=100,
                             fairness="priority:round_robin")
    for cls, (arch, engine) in enumerate(engines.items()):
        disp.register_model(arch, engine, priority_class=cls)
    with disp:
        futs = {(arch, i): disp.submit(arch, p.astype(dtype), max_new_tokens=n)
                for i in range(max(len(w) for w in work.values()))
                for arch, w in work.items() if i < len(w) for p, n in [w[i]]}
        out = {k: list(f.result(timeout=300).generated) for k, f in futs.items()}
        builds = disp.builds_on_thread
    return out, builds


@pytest.mark.timeout(600)
@pytest.mark.parametrize("stepping", ["per-engine", "single", "pool"])
def test_dispatched_tokens_equal_jax(lanes, stepping):
    """Five requests a lane (prompts of 3-16 tokens, 2-8 new ones) over two
    slots, the MoE lane at priority class 1: the port's dispatcher gives
    JAX's dispatcher's tokens, request by request."""
    work = {arch: _work(vocab, seed=7 + k) for k, (arch, (_, _, vocab)) in enumerate(lanes.items())}
    want, jbuilds = _serve(JD, {a: e[0] for a, e in lanes.items()}, work, stepping, np.int32)
    got, tbuilds = _serve(TD, {a: e[1] for a, e in lanes.items()}, work, stepping, np.int64)
    assert got == want
    assert tbuilds == 0 and jbuilds == 0
    assert sum(len(t) for t in got.values()) == sum(n for w in work.values() for _, n in w)
