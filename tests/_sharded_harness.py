"""Shared by the sharded-execution tests (``test_torch_sharded*.py``): the
configs and batch they run, the single-process or sharded forward and
train step, the comparison of a sharded step with the single-process one,
and the spawn of one gloo process per device of a ``("data", "model")``
mesh.

Each process takes its share of the parent's threads and rendezvouses on
a ``FileStore`` in the test's temporary directory (no port, so xdist
workers never collide); each join has a time limit and a failure shows
the child's traceback.  Tolerances (float32, smoke configs):

* **forward:** logits within atol 1e-5, rtol 1e-5;
* **train step:** loss, ce, aux and grad norm within rtol 1e-5; every
  gradient, divided by its leaf's largest magnitude, within rtol 1e-4 and
  atol 1e-5; the parameters after the step within 0.2 x lr
  (``test_torch_train_dense.py``'s rule: Adam's first step is about lr x
  sign(g)); the step counter replicated.
"""

import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro_torch.configs as C
from repro_torch.data import SyntheticLM, data_config_for
from repro_torch.launch.serve import init_params
from repro_torch.models import forward
from repro_torch.optim import adamw_init
from repro_torch.training import make_train_step, seal_train_step
from repro_torch.training.train_lib import batch_to_device

LR = 1e-3
LOGIT_TOL = 1e-5
METRIC_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
PARAM_ATOL = 0.2 * LR
JOIN_S = 240.0


def config(arch):
    return dataclasses.replace(C.get(arch, smoke=True), dtype="float32")


def batch_of(cfg):
    return SyntheticLM(data_config_for(cfg, batch_size=2, seq_len=16)).batch(0)


def local_step(cfg, batch, mesh=None):
    """``(logits, grads, metrics, params, step counter)`` of the forward and
    one AdamW step from seed 0's weights, on ``mesh`` when given (every
    result gathered whole, as numpy).  The forward takes the batch's inputs
    (tokens, and vision embeddings or audio frames), not its labels."""
    from repro_torch.data import shard_batch
    from repro_torch.distributed import shard_model, use_sharding_ctx
    from repro_torch.models import param_axes

    def whole(t):
        t = t.detach()
        return (t.full_tensor() if mesh is not None else t).numpy()

    def model_on_mesh():
        model = init_params(cfg, seed=0, device="cpu")
        return model if mesh is None else shard_model(model, param_axes(cfg), mesh)

    placed = (batch_to_device(batch, "cpu") if mesh is None
              else shard_batch(batch, mesh, "cpu"))
    model = model_on_mesh()
    with torch.no_grad(), use_sharding_ctx(mesh):
        logits = whole(forward(model, {k: v for k, v in placed.items() if k != "labels"},
                               cfg)[0])
    model = model_on_mesh()
    state = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, lr=LR, mesh=mesh)
    grads = {n: whole(g) for n, g in step.loss_and_grads(model, placed)[2].items()}
    metrics = seal_train_step(step, model, state, batch)(batch)
    return dict(logits=logits, grads=grads,
                metrics={k: float(v) for k, v in metrics.items()},
                params={n: whole(p) for n, p in model.named_parameters()},
                counter=(int(state.step), type(state.step).__name__))


def assert_logits_equal(got, want):
    np.testing.assert_allclose(got["logits"], want["logits"], atol=LOGIT_TOL, rtol=LOGIT_TOL)


def assert_step_equal(got, want):
    """A sharded :func:`local_step`'s train step against the single-process
    one, at the module's tolerances."""
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key],
                                   rtol=METRIC_TOL, atol=1e-7, err_msg=key)
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        scale = max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(got["grads"][name] / scale, g / scale,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
    for name, p in want["params"].items():
        np.testing.assert_allclose(got["params"][name], p, rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
    assert got["counter"] == (1, "DTensor") and want["counter"] == (1, "Tensor")


def _child(rank, world, shape, body, args, store, threads, out, names=("data", "model")):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        results = body(mesh, shape, *args)
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def run_mesh(shape, body, args, tmp: Path, names=("data", "model")) -> dict:
    """Spawn ``prod(shape)`` gloo processes over a mesh of ``shape`` whose
    dimensions are ``names``, each running ``body(mesh, shape, *args)`` (a
    module-level function); returns rank 0's result."""
    world = int(np.prod(shape))
    threads = max(1, torch.get_num_threads() // world)
    out = tmp / "results.pt"
    ctx = mp.start_processes(_child, args=(world, shape, body, args, str(tmp / "store"),
                                           threads, str(out), names),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"mesh {shape}: processes still running after {JOIN_S:.0f}s")
    except mp.ProcessRaisedException as e:    # carries the child's traceback
        pytest.fail(f"mesh {shape}: a process failed:\n{e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return torch.load(out, weights_only=False)
