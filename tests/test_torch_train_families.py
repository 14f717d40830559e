"""One training step of the port against JAX's, on the CPU: the vlm,
audio, hybrid and ssm architectures (image positions padded out of the
labels, the encoder and cross attention's gradients, Mamba2's SSD,
xLSTM's cells).  Tolerances and the comparison as in
``test_torch_train_dense.py``."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_train_dense import assert_step_matches, jax_and_port  # noqa: E402

FAMILIES = ["llava-next-34b", "seamless-m4t-medium", "zamba2-2.7b", "xlstm-125m"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_step_matches_jax(arch):
    jm, want, m, model, _ = jax_and_port(arch)
    assert_step_matches(jm, want, m, model)
