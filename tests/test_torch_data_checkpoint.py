"""The port's data pipeline and checkpoints against the JAX package's, on
the CPU.

``repro_torch.data`` is a numpy copy of ``repro.data``: its batches equal
JAX's bit for bit, for every family's extra inputs, over several steps and
shards, and through the prefetcher.  ``repro_torch.checkpoint`` writes the
JAX package's format (``arrays.npz`` + ``manifest.json``, bf16 as raw
bytes): a checkpoint round-trips, refuses a tree it does not match, and
each package restores the other's, down to the same model through the
bridge.
"""

import dataclasses
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as C  # noqa: E402
from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.data import Prefetcher as JaxPrefetcher  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.data import data_config_for as jax_data_config_for  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.data import Prefetcher, SyntheticLM, data_config_for  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "llava-next-34b", "seamless-m4t-medium"])
@pytest.mark.parametrize("shards", [1, 3])
def test_batches_equal_jax(arch, shards):
    jcfg, cfg = JC.get(arch, smoke=True), C.get(arch, smoke=True)
    for shard in range(shards):
        want = JaxSyntheticLM(jax_data_config_for(jcfg, batch_size=3, seq_len=32, seed=4),
                              shard=shard, num_shards=shards)
        got = SyntheticLM(data_config_for(cfg, batch_size=3, seq_len=32, seed=4),
                          shard=shard, num_shards=shards)
        for step in (0, 1, 7):
            a, b = want.batch(step), got.batch(step)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (k, step)


def test_prefetcher_yields_the_same_stream():
    jcfg, cfg = JC.get("stablelm-1.6b", smoke=True), C.get("stablelm-1.6b", smoke=True)
    want = JaxPrefetcher(JaxSyntheticLM(jax_data_config_for(jcfg, batch_size=2, seq_len=16)))
    got = Prefetcher(SyntheticLM(data_config_for(cfg, batch_size=2, seq_len=16)), start_step=0)
    try:
        for _ in range(4):
            a, b = next(want), next(got)
            assert all(np.array_equal(a[k], b[k]) for k in a)
    finally:
        want.close()
        got.close()


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g).bfloat16(),
            "b": [torch.arange(5, dtype=torch.int32), torch.randn(2, generator=g)],
            "n": {"x": torch.randn(2, 2, generator=g, dtype=torch.float64)}}


def test_round_trip_and_manifest(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, tree, step=7, metadata={"arch": "x"})
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["step"] == 7 and manifest["metadata"] == {"arch": "x"}
    assert manifest["arrays"]["w"] == {"shape": [3, 4], "dtype": "bfloat16"}
    assert manifest["arrays"]["b/0"] == {"shape": [5], "dtype": "int32"}
    like = {"w": torch.zeros(3, 4, dtype=torch.bfloat16),
            "b": [torch.zeros(5, dtype=torch.int32), torch.zeros(2)],
            "n": {"x": torch.zeros(2, 2, dtype=torch.float64)}}
    got, _ = restore_checkpoint(tmp_path, like)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_model_and_optimizer_state_round_trip_in_place(tmp_path):
    cfg = C.get("phi4-mini-3.8b", smoke=True)
    a = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    sa = adamw_init(dict(a.named_parameters()))
    sa.step.fill_(4)
    save_checkpoint(tmp_path, {"params": a, "opt": sa}, step=4)
    b = init_model(torch.Generator().manual_seed(1), cfg, device="cpu")
    sb = adamw_init(dict(b.named_parameters()))
    got, manifest = restore_checkpoint(tmp_path, {"params": b, "opt": sb})
    assert manifest["step"] == 4
    assert all(got["params"][n] is p for n, p in b.named_parameters())   # in place
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert type(got["opt"]).__name__ == "AdamWState" and int(got["opt"].step) == 4


@pytest.mark.parametrize("case,match", [("missing", "missing"), ("extra", "extra"),
                                        ("shape", "shape")])
def test_mismatches_raise(tmp_path, case, match):
    save_checkpoint(tmp_path, _tree())
    like = _tree()
    if case == "missing":
        like["more"] = torch.zeros(1)
    elif case == "extra":
        del like["n"]
    else:
        like["w"] = torch.zeros(4, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(tmp_path, like)


def test_jax_checkpoint_restores_into_the_same_model(tmp_path):
    """JAX writes a bf16 params tree (stacked layers); the port restores
    it and carries it through the bridge: the model of JAX's weights."""
    jcfg = dataclasses.replace(JC.get("phi4-mini-3.8b", smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(C.get("phi4-mini-3.8b", smoke=True), dtype="bfloat16")
    params, _ = jax_init_model(jax.random.key(0), jcfg)
    jax_save(tmp_path, {"params": params}, step=2)
    like = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), {"params": params})
    got, manifest = restore_checkpoint(tmp_path, like)
    assert manifest["step"] == 2
    leaves = jax.tree_util.tree_leaves(got)
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    restored = params_from_jax(jax.tree_util.tree_map(lambda t: t.float().numpy(), got["params"]),
                               cfg, device="cpu")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    for (n, a), (_, b) in zip(restored.named_parameters(), want.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port writes a params tree and its AdamW state; JAX restores both
    into its own structures (the named tuple by field, bf16 from bytes)."""
    g = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(4, 3, generator=g).bfloat16(),
              "layers": [{"w": torch.randn(2, 5, generator=g)}]}
    state = adamw_init(params)
    state.step.fill_(9)
    state.mu["a"].normal_(generator=g)
    save_checkpoint(tmp_path, {"params": params, "opt": state}, step=9)
    like = {"params": {"a": jnp.zeros((4, 3), jnp.bfloat16), "layers": [{"w": jnp.zeros((2, 5))}]},
            "opt": JaxAdamWState(step=jnp.zeros((), jnp.int32),
                                 mu={"a": jnp.zeros((4, 3)), "layers": [{"w": jnp.zeros((2, 5))}]},
                                 nu={"a": jnp.zeros((4, 3)), "layers": [{"w": jnp.zeros((2, 5))}]})}
    got, manifest = jax_restore(tmp_path, like)
    assert manifest["step"] == 9 and int(got["opt"].step) == 9
    assert got["params"]["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["params"]["a"], np.float32),
                                  params["a"].float().numpy())
    np.testing.assert_array_equal(np.asarray(got["opt"].mu["a"]), state.mu["a"].numpy())
    np.testing.assert_array_equal(np.asarray(got["params"]["layers"][0]["w"]),
                                  params["layers"][0]["w"].numpy())
