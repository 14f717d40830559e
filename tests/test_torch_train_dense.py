"""One training step of the port against JAX's ``make_train_step``, on the
CPU: the dense architectures, then the schedule over two steps, the sealed
step against the unsealed one, and the trainer's command line.

Each architecture's smoke config at float32: the JAX weights are carried
into the port (``bridge.params_from_jax``), both packages take one AdamW
step (lr 1e-3) on the same ``SyntheticLM`` batch (the port's copy of the
pipeline gives JAX's batch bit for bit).  Loss, ce, aux and the pre-clip
grad norm agree within rtol 1e-5 (float32 summation order), and the new
parameters, carried back through the bridge, within ``PARAM_ATOL`` = 0.2 x
lr: Adam's first step is lr x m / (sqrt(v) + eps), about lr x sign(g), so a
gradient element within rounding of 0 may step anywhere in [-lr, lr].  The
MoE and the other families are in ``test_torch_train_moe.py`` and
``test_torch_train_families.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as C  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.data import data_config_for as jax_data_config_for  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.training.train_lib import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticLM, data_config_for  # noqa: E402
from repro_torch.optim import adamw_init, cosine_schedule  # noqa: E402
from repro_torch.training import make_train_step, seal_train_step  # noqa: E402
from repro_torch.training.train_lib import batch_to_device  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-3
METRIC_TOL = 1e-5
PARAM_ATOL = 0.2 * LR
DENSE = ["phi4-mini-3.8b", "stablelm-1.6b", "starcoder2-15b", "gemma2-27b"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def configs(arch):
    return (dataclasses.replace(JC.get(arch, smoke=True), dtype="float32"),
            dataclasses.replace(C.get(arch, smoke=True), dtype="float32"))


def batches(jcfg, cfg, n, seq=16):
    """``n`` batches of the JAX pipeline, checked equal to the port's."""
    jdata = JaxSyntheticLM(jax_data_config_for(jcfg, batch_size=2, seq_len=seq))
    data = SyntheticLM(data_config_for(cfg, batch_size=2, seq_len=seq))
    out = [jdata.batch(i) for i in range(n)]
    for i, want in enumerate(out):
        got = data.batch(i)
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    return out


def jax_and_port(arch, *, lr=LR, steps=1, seq=16):
    """(JAX metrics, JAX new params as a port model, port metrics, port
    model, port optimizer state) after ``steps`` steps from one set of
    weights; ``lr`` is a number or a (JAX, port) pair of schedules."""
    jcfg, cfg = configs(arch)
    params, _ = jax_init_model(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    jlr, tlr = lr if isinstance(lr, tuple) else (lr, lr)
    jstep = jax.jit(jax_make_train_step(jcfg, lr=jlr))
    step = make_train_step(cfg, lr=tlr)
    jstate, state = jax_adamw_init(params), adamw_init(dict(model.named_parameters()))
    for batch in batches(jcfg, cfg, steps, seq):
        params, jstate, jm = jstep(params, jstate, batch)
        _, state, m = step(model, state, batch_to_device(batch, "cpu"))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return jm, want, m, model, state


def assert_step_matches(jm, want, m, model, param_atol=PARAM_ATOL):
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=METRIC_TOL, atol=1e-6,
                                   err_msg=key)
    got, ref = dict(model.named_parameters()), dict(want.named_parameters())
    assert set(got) == set(ref)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].detach().numpy(), rtol=0,
                                   atol=param_atol, err_msg=name)


@pytest.mark.parametrize("arch", DENSE)
def test_one_step_matches_jax(arch):
    jm, want, m, model, state = jax_and_port(arch)
    assert int(state.step) == 1 and state.step.dtype == torch.int32
    assert all(isinstance(v, torch.Tensor) for v in m.values())
    np.testing.assert_allclose(float(m["lr"]), LR, rtol=1e-7)
    assert_step_matches(jm, want, m, model)


def test_two_steps_with_the_cosine_schedule():
    kw = dict(peak_lr=LR, warmup_steps=1, total_steps=4)
    lr = (lambda s: jax_cosine(s, **kw), lambda s: cosine_schedule(s, **kw))
    jm, want, m, model, state = jax_and_port("phi4-mini-3.8b", lr=lr, steps=2)
    assert int(state.step) == 2
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    # two Adam steps: each element within rounding of a sign flip twice
    assert_step_matches(jm, want, m, model, param_atol=2 * PARAM_ATOL)


def test_sealed_step_equals_the_unsealed_one():
    """On the CPU ``seal_train_step`` is the eager step over fixed batch
    buffers: the same metrics and parameters as the step it seals, step by
    step, and it moves the state it was given."""
    _, cfg = configs("phi4-mini-3.8b")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import init_model

    a = init_model(gen, cfg, device="cpu")
    b = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = make_train_step(cfg, lr=LR)
    sa, sb = adamw_init(dict(a.named_parameters())), adamw_init(dict(b.named_parameters()))
    data = batches(*configs("phi4-mini-3.8b"), 3)
    sealed = seal_train_step(step, b, sb, data[0])
    assert sealed.graph is None and sealed.static["tokens"].dtype == torch.long
    for batch in data:
        ma = step(a, sa, batch_to_device(batch, "cpu"))[2]
        mb = sealed(batch)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert int(sb.step) == 3


@pytest.mark.timeout(240)
def test_trainer_runs_and_writes_a_checkpoint(tmp_path):
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm-1.6b",
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
         "--log-every", "1", "--ckpt", str(ckpt)],
        env=env, capture_output=True, text=True, timeout=200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    losses = [float(line.split()[3]) for line in proc.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert json.loads((ckpt / "manifest.json").read_text())["step"] == 3
    assert (ckpt / "arrays.npz").is_file()


def test_trainer_refuses_a_mesh(monkeypatch):
    # run alone (not under torchrun), a model axis has no processes to shard over
    from repro_torch.launch import train

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        train.main(["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
                    "--model-axis", "2"])


@pytest.mark.timeout(240)
def test_example_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "examples/train_lm_torch.py", "--smoke", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path / "c")],
        env=env, capture_output=True, text=True, timeout=200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "xlstm-smoke" in proc.stdout and "checkpoint at" in proc.stdout
    assert (tmp_path / "c" / "manifest.json").is_file()
