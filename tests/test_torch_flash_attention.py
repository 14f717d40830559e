"""The port's flash attention against the JAX package's, on the CPU.

The port's plain version (what ``mha_flash`` runs on CPU tensors) is held
against the Pallas kernel in interpret mode and against the JAX oracle,
mirroring ``test_kernels.py``; the CUDA kernel itself is checked on the
card by ``chip_smoke.py``.  Tolerances as in ``test_kernels.py``: float32
2e-5 (summation order), bfloat16 3e-2 (bf16 rounding of the output).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
    kernel,
    mha_flash,
)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _pair(arrays, dtype):
    """The same values as JAX arrays and as CPU torch tensors of ``dtype``."""
    return ([jnp.asarray(a, dtype=dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _check(seed, shapes, dtype="float32", jax_kernel=True, **kw):
    (jq, jk, jv), (tq, tk, tv) = _pair(_data(seed, *shapes), dtype)
    got = flash_attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jax_flash_ref(jq, jk, jv, **kw), TOL[dtype])
    if jax_kernel:
        want = jax_flash(jq, jk, jv, interpret=True, block_q=64, block_kv=64, **kw)
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("seq", [64, 128])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_shapes(seq, hd, dtype):
    _check(0, [(4, seq, hd)] * 3, dtype)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_gqa_groups(group):
    _check(1, [(2 * group, 128, 32), (2, 128, 32), (2, 128, 32)], group=group)


@pytest.mark.parametrize("window", [16, 64, 100])
def test_sliding_window(window):
    _check(2, [(2, 256, 32)] * 3, window=window)


@pytest.mark.parametrize("cap", [20.0, 50.0])
def test_softcap(cap):
    _check(3, [(2, 128, 32)] * 3, softcap=cap)


def test_bidirectional():
    _check(4, [(2, 128, 32)] * 3, causal=False)


def test_cross_lengths():
    _check(5, [(2, 64, 32), (2, 256, 32), (2, 256, 32)], causal=False)


@pytest.mark.parametrize("kw", [dict(), dict(window=16, softcap=50.0, group=2)])
def test_ragged_length(kw):
    """200 divides no TPU block; the port takes any length (the JAX oracle
    is the reference, the Pallas kernel refuses it)."""
    g = kw.get("group", 1)
    _check(6, [(2 * g, 200, 64), (2, 200, 64), (2, 200, 64)], jax_kernel=False, **kw)


def test_fully_masked_row_is_zero_like_the_kernel():
    """Row 100 sees no key (window 16 ends at 84 > Skv 64): the TPU kernel
    gives 0, the JAX oracle the mean of v.  The port follows the kernel."""
    kw = dict(causal=False, window=16)
    (jq, jk, jv), (tq, tk, tv) = _pair(_data(7, (2, 128, 32), (2, 64, 32), (2, 64, 32)),
                                       "float32")
    got = flash_attention_ref(tq, tk, tv, **kw)
    want = jax_flash(jq, jk, jv, interpret=True, block_q=64, block_kv=64, **kw)
    _close(got, want, TOL["float32"])
    assert float(got[:, 100].abs().max()) == 0.0
    assert float(jnp.abs(jax_flash_ref(jq, jk, jv, **kw)[:, 100]).max()) > 0.1


def test_mha_flash_matches_model_attention():
    """The model-layout wrapper against the port's and JAX's ``_sdpa``."""
    from repro.models.layers import _sdpa as jax_sdpa
    from repro_torch.models.layers import _sdpa

    B, S, NH, NKV, hd = 2, 64, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _pair(
        _data(8, (B, S, NH, hd), (B, S, NKV, hd), (B, S, NKV, hd)), "float32")
    kw = dict(scale=1.0 / np.sqrt(hd), softcap_val=50.0, window=16, kv_valid=None)
    got = mha_flash(tq, tk, tv, softcap=50.0, window=16)
    pos = torch.arange(S)
    _close(got, _sdpa(tq, tk, tv, q_pos=pos, kv_pos=pos, **kw), 3e-5)
    _close(got, jax_sdpa(jq, jk, jv, q_pos=jnp.arange(S), kv_pos=jnp.arange(S), **kw), 3e-5)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and never counts
    a launch; the kernel's own wrapper refuses CPU tensors."""
    q, k, v = (torch.randn(1, 16, 4, 32) for _ in range(3))
    before = kernel.launches
    mha_flash(q, k, v)
    assert kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(*(torch.randn(2, 16, 32) for _ in range(3)))


def test_build_command_targets_hopper():
    out = build.library_path(kernel.SOURCE)
    argv = build.nvcc_argv("nvcc", kernel.SOURCE, out)
    assert "arch=compute_90a,code=sm_90a" in argv
    assert "-shared" in argv and "-O3" in argv
    assert out.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    gitignore = (build.BUILD_DIR.parents[1] / ".gitignore").read_text().split()
    assert "build/" in gitignore


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load(kernel.SOURCE)
    assert not (tmp_path / "build").exists()
