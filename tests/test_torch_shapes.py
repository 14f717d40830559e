"""The port's input shapes against the JAX package's, on the CPU.

``repro_torch.configs.shapes`` copies ``INPUT_SHAPES``,
``LONG_CONTEXT_ARCHS`` and ``applicable``; its ``input_specs`` gives, for
all ten full configs at every applicable shape, meta-device tensors of
JAX's ``ShapeDtypeStruct`` shapes and dtypes, leaf by leaf: the batch
(tokens, labels, vision embeddings, audio frames) and the synchronized
decode cache, its ``pos`` 0-d.  Integer ids are int64 in the port where
JAX's are int32 (torch's index type); every other dtype is JAX's.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.configs.shapes as JSH  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.configs.shapes as TSH  # noqa: E402

DTYPES = {jnp.dtype(jnp.int32): torch.int64, jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}
CASES = [(arch, shape) for arch in JC.all_archs() for shape in JSH.INPUT_SHAPES
         if JSH.applicable(JC.get(arch), shape)]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def test_tables_are_jax_tables():
    assert TSH.INPUT_SHAPES.keys() == JSH.INPUT_SHAPES.keys()
    for name, sh in JSH.INPUT_SHAPES.items():
        got = TSH.INPUT_SHAPES[name]
        assert (got.name, got.seq_len, got.global_batch, got.kind) == \
            (sh.name, sh.seq_len, sh.global_batch, sh.kind)
    assert TSH.LONG_CONTEXT_ARCHS == JSH.LONG_CONTEXT_ARCHS
    for arch in JC.all_archs():
        for shape in JSH.INPUT_SHAPES:
            assert TSH.applicable(TC.get(arch), shape) == JSH.applicable(JC.get(arch), shape)


@pytest.mark.parametrize("arch,shape", CASES)
def test_input_specs_equal_jax(arch, shape):
    kind, specs = TSH.input_specs(TC.get(arch), shape)
    jkind, jspecs = JSH.input_specs(JC.get(arch), shape)
    assert kind == jkind
    got, want = dict(_leaves(specs)), dict(_leaves(jspecs))
    assert list(got) == list(want)
    for name, sds in want.items():
        t = got[name]
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(sds.shape), name
        assert t.dtype == DTYPES[jnp.dtype(sds.dtype)], (name, t.dtype, sds.dtype)
    if kind == "decode":
        assert got["cache.pos"].dim() == 0 and got["tokens"].shape == (
            TSH.INPUT_SHAPES[shape].global_batch, 1)
