"""The port's stream_pack against the JAX package's, on the CPU.

The port's plain version (what ``stream_pack`` runs on CPU tensors) is held
against the Pallas kernel in interpret mode, mirroring
``test_kernels.py``; the CUDA kernel itself is checked on the card by
``chip_smoke.py``.  Tolerances as in ``test_kernels.py``: float32 1e-5
(summation order; 1e-4 in the property test), bfloat16 2e-2 (bf16 rounding
of the output).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.kernels.stream_pack import stream_pack_matmul as jax_stream_pack  # noqa: E402
from repro.kernels.stream_pack import stream_pack_matmul_ref as jax_ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.stream_pack import (  # noqa: E402
    kernel,
    packed_branches,
    stream_pack,
    stream_pack_matmul,
    stream_pack_matmul_ref,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(seed, shape, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a, dtype=dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("lanes", [1, 2, 7])
@pytest.mark.parametrize("mkn", [(16, 16, 16), (64, 32, 16), (128, 128, 128), (256, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shapes_dtypes(lanes, mkn, dtype):
    M, K, N = mkn
    jx, tx = _pair(0, (lanes, M, K), dtype)
    jw, tw = _pair(1, (lanes, K, N), dtype)
    got = stream_pack(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (lanes, M, N)
    _close(got, jax_stream_pack(jx, jw, interpret=True), TOL[dtype])
    _close(got, jax_ref(jx, jw), TOL[dtype])


@pytest.mark.parametrize("blocks", [(16, 16, 16), (32, 64, 16), (64, 32, 32)])
def test_block_sweep(blocks):
    """The port accepts every block the TPU kernel accepts, and its plain
    version agrees with the TPU kernel run at those blocks."""
    bm, bn, bk = blocks
    jx, tx = _pair(2, (3, 64, 64), "float32")
    jw, tw = _pair(3, (3, 64, 64), "float32")
    assert kernel.check_blocks(64, 64, 64, bm, bn, bk) == (bm, bn, bk)
    want = jax_stream_pack(jx, jw, block_m=bm, block_n=bn, block_k=bk, interpret=True)
    _close(stream_pack(tx, tw), want, TOL["float32"])


def test_rejects_misaligned():
    """96 rows do not divide a 64-row block: the TPU kernel's ValueError,
    raised before any device is touched."""
    _, tx = _pair(4, (2, 96, 64), "float32")
    _, tw = _pair(5, (2, 64, 64), "float32")
    with pytest.raises(ValueError, match="must divide blocks"):
        stream_pack_matmul(tx, tw, block_m=64)
    jx, jw = jnp.asarray(tx.numpy()), jnp.asarray(tw.numpy())
    with pytest.raises(ValueError):
        jax_stream_pack(jx, jw, block_m=64, interpret=True)


def test_packed_branches_list_api():
    xs = [_pair(10 + i, (32, 16), "float32")[1] for i in range(5)]
    ws = [_pair(20 + i, (16, 8), "float32")[1] for i in range(5)]
    outs = packed_branches(xs, ws)
    assert len(outs) == 5
    for x, w, o in zip(xs, ws, outs):
        _close(o, (x @ w).numpy(), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_lhs_form(dtype):
    """One x for every lane (2-d, or a stride-0 lane broadcast) gives each
    lane's x @ w; the list API passes a repeated x once."""
    _, x = _pair(6, (8, 64), dtype)
    _, w = _pair(7, (7, 64, 48), dtype)
    want = [(x.float() @ w[i].float()).to(x.dtype) for i in range(7)]
    for got in (stream_pack(x, w), stream_pack(x.expand(7, 8, 64), w),
                stream_pack_matmul_ref(x, w), torch.stack(packed_branches([x] * 7, list(w)))):
        assert got.shape == (7, 8, 48) and got.dtype == x.dtype
        for i in range(7):
            _close(got[i], want[i].float().numpy(), TOL[dtype])


@given(
    lanes=st.integers(1, 4),
    m=st.sampled_from([16, 32, 64]),
    k=st.sampled_from([16, 32]),
    n=st.sampled_from([16, 32]),
)
@settings(max_examples=25, deadline=None)
def test_property(lanes, m, k, n):
    jx, tx = _pair(lanes * m, (lanes, m, k), "float32")
    jw, tw = _pair(k * n, (lanes, k, n), "float32")
    _close(stream_pack(tx, tw), jax_stream_pack(jx, jw, interpret=True), 1e-4)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and never counts
    a launch; the kernel's own wrapper refuses CPU tensors."""
    _, x = _pair(8, (2, 16, 16), "float32")
    before = kernel.launches
    stream_pack(x, x)
    packed_branches(list(x), list(x))
    assert kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        stream_pack_matmul(x, x)


@pytest.mark.parametrize("bad, match", [
    (lambda x, w: (x[0], w), "3-d"),
    (lambda x, w: (x, w[:, :8]), "does not match"),
    (lambda x, w: (x.to("meta"), w.to("meta")), "CUDA"),
])
def test_kernel_wrapper_checks(bad, match):
    _, x = _pair(9, (2, 16, 16), "float32")
    with pytest.raises(ValueError, match=match):
        stream_pack_matmul(*bad(x, x))


def test_build_command_targets_hopper():
    out = build.library_path(kernel.SOURCE)
    argv = build.nvcc_argv("nvcc", kernel.SOURCE, out)
    assert "arch=compute_90a,code=sm_90a" in argv and str(kernel.SOURCE) in argv
    assert out.parent == build.BUILD_DIR and out.name.startswith("libstream_pack_")
    src = kernel.SOURCE.read_text()
    # a hand-written kernel: no library GEMM behind it
    assert "cublas" not in src.lower() and "extern \"C\" int stream_pack_matmul(" in src
