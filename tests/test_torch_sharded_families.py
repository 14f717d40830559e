"""Sharded execution of the families ``test_torch_sharded.py`` does not
train, on the CPU: a sharded ``forward`` and one sharded AdamW step over
spawned gloo processes, held against the port's single-process step from
the same weights and batch (that step is held against JAX in
``test_torch_train_{dense,families}.py``).

One spawn per mesh, (1, 2) and (2, 1) ``("data", "model")`` over 2
processes, every architecture inside it (``_sharded_harness.run_mesh``).
Configs at smoke size, float32, a ``SyntheticLM`` batch of 2 x 16:

* gemma2-27b (dense: sliding windows on every other layer, attention and
  final soft-caps, post-attention norms; its layer period is 2);
* llava-next-34b (vlm: vision embeddings before the text, image positions
  out of the loss);
* seamless-m4t-medium (audio: the encoder over the frames, the decoder's
  cross attention);
* zamba2-2.7b (hybrid: Mamba2's causal conv and SSD scan on each device's
  rows and channels or heads, the shared attention block);
* xlstm-125m (ssm: the mLSTM's chunked form and the sLSTM on each
  device's rows and heads).

Tolerances are the harness's: logits within 1e-5; loss, ce, aux and grad
norm within rtol 1e-5; every gradient, divided by its leaf's largest
magnitude, within rtol 1e-4 and atol 1e-5; parameters within 0.2 x lr.
"""

import traceback

import pytest
import torch

from _sharded_harness import (assert_logits_equal, assert_step_equal, batch_of, config,
                              local_step, run_mesh)

ARCHS = ["gemma2-27b", "llava-next-34b", "seamless-m4t-medium", "zamba2-2.7b", "xlstm-125m"]
MESHES = [(1, 2), (2, 1)]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def cases(mesh, shape):
    """Each architecture's sharded forward and train step, on one rank."""
    return {arch: local_step(config(arch), batch_of(config(arch)), mesh) for arch in ARCHS}


_RUNS: dict = {}


@pytest.fixture(scope="module")
def reference():
    return {arch: local_step(config(arch), batch_of(config(arch))) for arch in ARCHS}


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def sharded(request, tmp_path_factory):
    shape = request.param
    if shape not in _RUNS:
        try:
            _RUNS[shape] = run_mesh(shape, cases, (), tmp_path_factory.mktemp("mesh"))
        except BaseException:
            print(traceback.format_exc())
            raise
    return _RUNS[shape]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_equals_single_process(sharded, reference, arch):
    assert_logits_equal(sharded[arch], reference[arch])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_equals_single_process(sharded, reference, arch):
    assert_step_equal(sharded[arch], reference[arch])
