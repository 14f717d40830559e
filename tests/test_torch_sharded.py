"""Sharded execution of the port on the CPU: DTensor parameters, AdamW
state and batches over a ``DeviceMesh`` of spawned gloo processes, held
against the port's single-process step from the same weights and batch
(that step is held against JAX in ``test_torch_train_{dense,moe}.py``).

One spawn per mesh, every case inside it (``_sharded_harness.run_mesh``,
which this file shares with ``test_torch_sharded_families.py``): (1, 2)
and (2, 1) ``("data", "model")`` over 2 processes, a sharded ``forward``,
decode steps and one sharded train step each; (2, 2) over 4 processes,
the train step.  Configs at smoke size, float32: phi4-mini (dense, GQA 6
over 2 heads), arctic (MoE on B2's plain version, beside a dense FFN) and
deepseek-v2 (MoE with MLA and shared experts), a ``SyntheticLM`` batch of
2 x 16 (the train tests').  The forward and train step are held at the
harness's tolerances (logits 1e-5; metrics rtol 1e-5; gradients over
their leaf's largest magnitude rtol 1e-4, atol 1e-5; parameters 0.2 x lr).

* **decode:** synchronized decode steps of phi4-mini, deepseek-v2 (MLA),
  zamba2 (the in-layer cache write) and xlstm (the sLSTM on each device's
  rows) with the cache placed by its axes, and phi4-mini under the
  long-context rules (the cache's positions sharded on the data axis):
  logits and the cache within 1e-5;
* **the hand-checked collectives,** the dense forward on (1, 2):
  ``test_dense_forward_collectives_are_the_rules``, and its loss on the
  vocabulary-sharded logits: ``test_loss_collectives_are_the_combine_all_reduces``.
* **no hidden all-gather:** B1 and B2 on DTensors run inside ``local_map``
  with no collective, on their local shards.
* **the trainer under torchrun:** ``launch/train.py --model-axis 2`` on 2
  gloo ranks gives the one-process launcher's losses, and its checkpoint
  restores into a single-process model.
* **MoE routing on each device's tokens,** on every mesh, at 2 x 100
  tokens (capacity 125 a expert, so experts overflow): ``apply_moe`` of
  arctic and deepseek-v2 alone on tokens that share a common direction
  (one expert's run crosses the batch rows, the data shards), against
  JAX's ``apply_moe`` and the single-process run (experts, slots and kept
  mask equal); one train step of each on a ``SyntheticLM`` batch of 2 x
  100 (tokens dropped in its first layer) at the harness's tolerances;
  on a one-device mesh, bf16 forward and gradients bit for bit; tokens
  sharded on ``seq`` refused.
"""

import dataclasses
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from _sharded_harness import (LOGIT_TOL, METRIC_TOL, assert_logits_equal, assert_step_equal,
                              batch_of, config, local_step, run_mesh)
from repro_torch.data import SyntheticLM, data_config_for
import repro_torch.models.moe as TM
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.launch.serve import init_params
from repro_torch.models import Transformer, forward
from repro_torch.optim import cosine_schedule

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["phi4-mini-3.8b", "arctic-480b", "deepseek-v2-236b"]
# mesh -> the step kinds run on it
MESHES = {(1, 2): ("forward", "train"), (2, 1): ("forward", "train"), (2, 2): ("train",)}
MOE_ARCHS = ["arctic-480b", "deepseek-v2-236b"]
# the MoE cases' batch: 200 tokens, capacity(200) = 125 slots a expert
MOE_TOKENS = (2, 100)
# apply_moe against JAX: test_torch_moe.py's tolerance at N = 200, whose
# outputs hold sums that cancel: rtol 1e-5, atol 1e-6 of the largest |ref|
MOE_JAX_RTOL, MOE_JAX_SHARE = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


DECODE_ARCHS = ["phi4-mini-3.8b", "deepseek-v2-236b", "zamba2-2.7b", "xlstm-125m"]
DECODE_STEPS, DECODE_LEN = 3, 8


def decode_run(cfg, mesh=None, rules=None):
    """``DECODE_STEPS`` synchronized decode steps (``init_cache(per_slot=
    False)``, batch 2) from seed 0's weights: each step's logits and the
    cache after them, whole, as numpy."""
    from repro_torch.distributed import shard_model, shard_tree, use_sharding_ctx
    from repro_torch.models import cache_axes, decode_step, init_cache, param_axes

    model = init_params(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, 2, DECODE_LEN, per_slot=False, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (DECODE_STEPS, 2, 1)))
    if mesh is not None:
        shard_model(model, param_axes(cfg), mesh, rules)
        cache = shard_tree(cache, cache_axes(cfg, per_slot=False), mesh, rules)
    logits = []
    with torch.no_grad(), use_sharding_ctx(mesh, rules):
        for step in tokens:
            if mesh is not None:
                step = shard_tree(step, "batch seq", mesh, rules)
            out = decode_step(model, cache, step, cfg)[0]
            logits.append((out.full_tensor() if mesh is not None else out).numpy())
    whole = {pytree.keystr(path): (t.full_tensor() if mesh is not None else t).numpy()
             for path, t in pytree.tree_flatten_with_path(cache)[0]}
    return dict(logits=np.stack(logits), cache=whole)


def dense_collectives(mesh):
    """The records of the dense smoke forward on ``mesh`` (the hand case)."""
    from repro_torch.data import shard_batch
    from repro_torch.distributed import shard_model, use_sharding_ctx
    from repro_torch.launch.comm_analysis import CommCounter, collective_bytes
    from repro_torch.models import param_axes

    cfg = config("phi4-mini-3.8b")
    model = shard_model(init_params(cfg, seed=0, device="cpu"), param_axes(cfg), mesh)
    tokens = shard_batch(batch_of(cfg), mesh, "cpu")["tokens"]
    with torch.no_grad(), use_sharding_ctx(mesh), CommCounter() as counter:
        logits = forward(model, {"tokens": tokens}, cfg)[0]
    return dict(collectives=collective_bytes(counter.records),
                logits_placements=[str(p) for p in logits.placements])


def loss_collectives(mesh):
    """The dense smoke forward's logits on ``mesh`` (vocabulary-sharded),
    made a leaf, then the loss and its gradient, each under a counter: the
    records (op, operand bytes) of each, the logits' local bytes, the loss
    and the gradient's placements."""
    from repro_torch.data import shard_batch
    from repro_torch.distributed import shard_model, use_sharding_ctx
    from repro_torch.launch.comm_analysis import CommCounter
    from repro_torch.models import param_axes
    from repro_torch.training.train_lib import cross_entropy

    cfg = config("phi4-mini-3.8b")
    model = shard_model(init_params(cfg, seed=0, device="cpu"), param_axes(cfg), mesh)
    batch = shard_batch(batch_of(cfg), mesh, "cpu")
    with torch.no_grad(), use_sharding_ctx(mesh):
        logits = forward(model, {"tokens": batch["tokens"]}, cfg)[0]
    logits = logits.detach().requires_grad_()
    with use_sharding_ctx(mesh), CommCounter() as fwd:
        loss = cross_entropy(logits, batch["labels"])
    with CommCounter() as bwd:
        (grad,) = torch.autograd.grad(loss, logits)

    def kept(counter):
        return [r for r in counter.records if r[0] != "wait_tensor"]

    return dict(forward=kept(fwd), backward=kept(bwd),
                logits_bytes=logits.to_local().numel() * 4, loss=float(loss.full_tensor()),
                grad_placements=[str(p) for p in grad.placements])


def kernel_regions(mesh):
    """B1 and B2 on DTensors sharded on the model axis, forward and
    backward, under a counter: their collectives, one device's FLOPs
    against the global ones and the shapes their plain versions saw."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import place
    from repro_torch.kernels.flash_attention import mha_flash, ops
    from repro_torch.kernels.stream_pack import stream_pack
    from repro_torch.launch.comm_analysis import CommCounter, collective_bytes

    gen = torch.Generator().manual_seed(0)
    heads = [Replicate(), Shard(2)]
    q, k, v = (torch.randn(2, 16, n, 32, generator=gen) for n in (6, 2, 2))
    x, w = torch.randn(4, 8, 16, generator=gen), torch.randn(4, 16, 12, generator=gen)
    out = {}
    for name, args, placements, fn in (
            ("flash", (q, k, v), [heads] * 3, mha_flash),
            ("stream_pack", (x, w), [[Replicate(), Shard(0)]] * 2, stream_pack)):
        with FlopCounterMode(display=False) as flops:
            fn(*[a.clone().requires_grad_() for a in args]).sum().backward()
        placed = [place(a, mesh, p).requires_grad_() for a, p in zip(args, placements)]
        seen = []
        inner = ops.flash_attention_lse_ref

        def lse_ref(*a, **kw):                   # what B1's plain version is given
            seen.append(tuple(a[0].shape))
            return inner(*a, **kw)

        ops.flash_attention_lse_ref = lse_ref
        try:
            with CommCounter() as counter:
                y = fn(*placed)
                y.to_local().sum().backward()
        finally:
            ops.flash_attention_lse_ref = inner
        out[name] = dict(collectives=collective_bytes(counter.records)["counts"],
                         flops=counter.flops, global_flops=flops.get_total_flops(),
                         out=[str(p) for p in y.placements], seen=seen,
                         grads=[[str(g) for g in p.grad.placements] for p in placed])
    return out


def moe_input(cfg) -> np.ndarray:
    """(2, 100, D) float32 tokens sharing a common direction (as
    ``test_torch_moe.py`` draws N = 200): the router sends most of them to
    the same experts, which overflow."""
    rng = np.random.default_rng(200)
    x = rng.standard_normal((*MOE_TOKENS, cfg.d_model), dtype=np.float32)
    x += 3 * rng.standard_normal(cfg.d_model, dtype=np.float32)
    return x


def moe_layer(cfg, mesh=None) -> dict:
    """``route`` and ``apply_moe`` of layer 0 (seed 0's weights) on
    :func:`moe_input`, the tokens sharded ``batch seq embed`` on ``mesh``
    when given: every result whole, as numpy."""
    from repro_torch.distributed import shard_model, shard_tree, use_sharding_ctx
    from repro_torch.models import param_axes

    model = init_params(cfg, seed=0, device="cpu")
    x = torch.from_numpy(moe_input(cfg))
    if mesh is not None:
        shard_model(model, param_axes(cfg), mesh)
        x = shard_tree(x, "batch seq embed", mesh)
    p = model.layers[0]["moe"]
    with torch.no_grad(), use_sharding_ctx(mesh):
        r = TM.route(p, x, cfg)
        out, aux = TM.apply_moe(p, x, cfg)

    def whole(t):
        return (t.full_tensor() if mesh is not None else t).numpy()

    return dict(out=whole(out), aux=float(whole(aux)), gates=whole(r.gates),
                experts=whole(r.experts), slots=whole(r.slots), keep=whole(r.keep), cap=r.cap)


def moe_batch(cfg):
    return SyntheticLM(data_config_for(cfg, batch_size=MOE_TOKENS[0],
                                       seq_len=MOE_TOKENS[1])).batch(0)


def cases(mesh, shape, kinds):
    """Every case of ``shape``, on one rank of its mesh."""
    results = {}
    for arch in ARCHS:
        cfg = config(arch)
        results[arch] = local_step(cfg, batch_of(cfg), mesh)
        if "forward" not in kinds:
            results[arch].pop("logits")
    if "forward" in kinds:
        from repro_torch.distributed import LONG_CONTEXT_OVERRIDES

        for arch in DECODE_ARCHS:
            results[f"decode {arch}"] = decode_run(config(arch), mesh)
        # the long-context rules shard the cache's positions on the data axis
        results["decode long"] = decode_run(config("phi4-mini-3.8b"), mesh,
                                            dict(LONG_CONTEXT_OVERRIDES))
    for arch in MOE_ARCHS:
        cfg = config(arch)
        results[f"moe {arch}"] = moe_layer(cfg, mesh)
        results[f"moe train {arch}"] = local_step(cfg, moe_batch(cfg), mesh)
    if shape == (1, 2):
        results["dense_collectives"] = dense_collectives(mesh)
        results["kernel_regions"] = kernel_regions(mesh)
        results["loss_collectives"] = loss_collectives(mesh)
    return results


_RUNS: dict = {}


@pytest.fixture(scope="module")
def reference():
    return {arch: local_step(config(arch), batch_of(config(arch))) for arch in ARCHS}


@pytest.fixture(scope="module", params=list(MESHES), ids=lambda s: f"{s[0]}x{s[1]}")
def sharded(request, tmp_path_factory):
    shape = request.param
    if shape not in _RUNS:
        try:
            _RUNS[shape] = run_mesh(shape, cases, (MESHES[shape],),
                                    tmp_path_factory.mktemp("mesh"))
        except BaseException:
            print(traceback.format_exc())
            raise
    return shape, _RUNS[shape]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_equals_single_process(sharded, reference, arch):
    shape, runs = sharded
    if "forward" not in MESHES[shape]:
        assert "logits" not in runs[arch]     # (2, 2) runs the train step only
        return
    assert_logits_equal(runs[arch], reference[arch])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_equals_single_process(sharded, reference, arch):
    _, runs = sharded
    assert_step_equal(runs[arch], reference[arch])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", DECODE_ARCHS + ["long"])
def test_sharded_decode_equals_single_process(sharded, arch):
    """Synchronized decode steps with the cache placed by its axes (the
    cache written on each device's shard, attention on its rows and heads;
    under the long-context rules the cache's positions sharded on the data
    axis): each step's logits within 1e-5 and the cache equal."""
    shape, runs = sharded
    if "forward" not in MESHES[shape]:
        return
    got = runs[f"decode {arch}"]
    want = decode_run(config("phi4-mini-3.8b" if arch == "long" else arch))
    np.testing.assert_allclose(got["logits"], want["logits"], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert set(got["cache"]) == set(want["cache"])
    for name, c in want["cache"].items():
        np.testing.assert_allclose(got["cache"][name], c, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=name)


@pytest.mark.timeout(300)
def test_dense_forward_collectives_are_the_rules(sharded):
    """The dense smoke forward (phi4-mini: D = 192, L = 2 layers, GQA 6
    over 2 heads, d_ff 384, vocab 512; tokens B x S = 2 x 16, float32) on
    the (1, 2) mesh: the data axis has one device, so the batch, the
    ``fsdp`` dims and the token ids are whole, and the model axis shards
    heads (6 and 2 over 2), ``mlp`` (384) and ``vocab`` (512).  What the
    rules imply, per device:

    * the embedding: the table is vocab-sharded, each device looks up its
      rows, a partial sum reduced by ``constrain(x, batch, seq, embed)``:
      one all-reduce of (B, S, D) float32;
    * each layer: q, k, v are column products (heads sharded, no
      collective), B1 runs on the local heads, the out-projection ``wo``
      (heads sharded on its rows) gives a partial sum that the residual's
      ``constrain(..., embed)`` reduces: one all-reduce of (B, S, D); the
      FFN is column (w_gate, w_up) then row (w_down): one more;
    * the logits: ``unembed`` is vocab-sharded on its columns and the
      logits stay ``constrain``-ed vocab-sharded: no collective.

    So 1 + 2 L = 5 all-reduces of B·S·D·4 = 24576 bytes, and nothing else."""
    shape, runs = sharded
    if shape != (1, 2):
        return
    record = runs["dense_collectives"]
    cfg = config("phi4-mini-3.8b")
    per = 2 * 16 * cfg.d_model * 4
    n = 1 + 2 * cfg.n_layers
    assert per == 24576 and n == 5
    assert record["collectives"]["counts"] == {
        "all-gather": 0, "all-reduce": n, "reduce-scatter": 0, "all-to-all": 0,
        "collective-permute": 0}
    assert record["collectives"]["bytes_per_kind"]["all-reduce"] == n * per
    assert record["collectives"]["total_bytes"] == n * per
    assert record["logits_placements"] == ["R", "S(2)"]


@pytest.mark.timeout(300)
def test_loss_collectives_are_the_combine_all_reduces(sharded):
    """The loss of the dense smoke logits on (1, 2): B x S = 2 x 16 rows,
    the vocabulary (512) split over the model axis, 256 columns a device.
    Each device runs B5's plain version on its own columns, and the
    combine reduces its per-row partials: one max all-reduce of the rows'
    maxima, (32,) float32 = 128 B, and one sum all-reduce of (32, 2)
    float32 = 256 B.  The backward runs on the local shard with no
    collective, and its gradient stays vocabulary-sharded.  No collective
    carries the logits (2 x 16 x 256 x 4 = 32768 B a device).  The loss
    equals the single-process one within the metrics' rtol."""
    shape, runs = sharded
    if shape != (1, 2):
        return
    record = runs["loss_collectives"]
    rows = 2 * 16
    assert record["forward"] == [("all_reduce", 4 * rows), ("all_reduce", 8 * rows)]
    assert record["backward"] == []
    assert record["logits_bytes"] == 2 * 16 * 256 * 4
    assert all(nbytes < record["logits_bytes"] for _, nbytes in record["forward"])
    assert record["grad_placements"] == ["R", "S(2)"]
    from repro_torch.training.train_lib import cross_entropy

    cfg = config("phi4-mini-3.8b")
    batch = batch_of(cfg)
    model = init_params(cfg, seed=0, device="cpu")
    with torch.no_grad():
        logits = forward(model, {"tokens": torch.as_tensor(batch["tokens"]).long()}, cfg)[0]
        want = float(cross_entropy(logits, torch.as_tensor(batch["labels"]).long()))
    np.testing.assert_allclose(record["loss"], want, rtol=METRIC_TOL)


@pytest.mark.timeout(300)
def test_kernels_run_on_local_shards_with_no_collective(sharded):
    """B1 (q 6 heads over k, v 2, sharded on heads) and B2 (4 lanes over
    lanes), forward and backward through ``local_map`` on (1, 2): no
    collective at all, one device's FLOPs half the global ones, B1's plain
    version given 3 q heads, the outputs and gradients sharded as the
    inputs: no q, k, v or expert weight is gathered."""
    shape, runs = sharded
    if shape != (1, 2):
        return
    regions = runs["kernel_regions"]
    for name, r in regions.items():
        assert sum(r["collectives"].values()) == 0, (name, r["collectives"])
        assert r["flops"] * 2 == r["global_flops"] > 0, name
    flash, pack = regions["flash"], regions["stream_pack"]
    assert flash["seen"] == [(2 * 3, 16, 32)]          # batch x local q heads
    assert flash["out"] == ["R", "S(2)"] and flash["grads"] == [["R", "S(2)"]] * 3
    assert pack["out"] == ["R", "S(0)"] and pack["grads"] == [["R", "S(0)"]] * 2


@pytest.fixture(scope="module")
def moe_reference():
    """Per MoE arch, single-process: :func:`moe_layer`, JAX's ``apply_moe``
    on the same weights and tokens (its out and aux), the train step on
    :func:`moe_batch` and the tokens each MoE layer dropped in its
    forward."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    import repro.configs as JC
    import repro.models.moe as JM

    refs = {}
    for arch in MOE_ARCHS:
        cfg = config(arch)
        jcfg = dataclasses.replace(JC.get(arch, smoke=True), dtype="float32")
        weights: dict = {}
        for name, w in init_params(cfg, seed=0, device="cpu").layers[0]["moe"].named_parameters():
            owner, _, leaf = name.rpartition(".")
            (weights.setdefault(owner, {}) if owner else weights)[leaf] = \
                jnp.asarray(w.detach().numpy())
        want, waux = jax.jit(JM.apply_moe, static_argnums=2)(
            weights, jnp.asarray(moe_input(cfg)), jcfg)
        dropped, routed = [], TM._routed

        def counted(*args):
            r = routed(*args)
            dropped.append(int((~r.keep).sum()))
            return r

        TM._routed = counted
        try:
            train = local_step(cfg, moe_batch(cfg))
        finally:
            TM._routed = routed
        refs[arch] = dict(layer=moe_layer(cfg), jax_out=np.asarray(want), jax_aux=float(waux),
                          train=train, dropped=dropped[:cfg.n_layers])
    return refs


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_moe_matches_jax_and_routes_as_one_process(sharded, moe_reference, arch):
    """``apply_moe`` alone on the mesh, each device routing its own
    tokens: the experts, the slots and the kept mask equal the
    single-process run's exactly (the global capacity, 125, and the
    global order of each expert's run), the gates within float32's
    rounding, out and aux within 1e-5 of the single-process run, and of
    JAX's ``apply_moe`` on the same weights at ``test_torch_moe.py``'s
    tolerance for these 200 tokens."""
    _, runs = sharded
    got, ref = runs[f"moe {arch}"], moe_reference[arch]
    single = ref["layer"]
    assert got["cap"] == single["cap"] == 125
    for key in ("experts", "slots", "keep"):
        np.testing.assert_array_equal(got[key], single[key], err_msg=key)
    assert 0 < int((~got["keep"]).sum())            # the capacity path ran
    np.testing.assert_allclose(got["gates"], single["gates"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["out"], single["out"], rtol=MOE_JAX_RTOL,
                               atol=MOE_JAX_SHARE * float(np.abs(single["out"]).max()))
    np.testing.assert_allclose(got["aux"], single["aux"], rtol=1e-5, atol=1e-7)
    want = ref["jax_out"]
    np.testing.assert_allclose(got["out"], want, rtol=MOE_JAX_RTOL,
                               atol=MOE_JAX_SHARE * float(np.abs(want).max()))
    np.testing.assert_allclose(got["aux"], ref["jax_aux"], rtol=1e-5, atol=1e-5)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_overflow_straddles_the_data_shards(sharded, moe_reference, arch):
    """The tokens of :func:`moe_input`: one expert's run has assignments in
    both batch rows (the data shards of (2, 1) and (2, 2)) and reaches its
    capacity in the second row, so the second row's drops depend on the
    first row's count.  A capacity per shard (``capacity(100)`` = 62 of
    each row's own run) would keep another set of tokens; the mesh keeps
    the global set."""
    _, runs = sharded
    single, got = moe_reference[arch]["layer"], runs[f"moe {arch}"]
    cfg = config(arch)
    E, half = cfg.moe.num_experts, single["experts"].size // 2
    row = [single["experts"][:half], single["experts"][half:]]
    straddles = [e for e in range(E) if (row[0] == e).sum() < single["cap"]
                 < (row[0] == e).sum() + (row[1] == e).sum() and (row[0] == e).any()]
    assert straddles, [(int((row[0] == e).sum()), int((row[1] == e).sum())) for e in range(E)]

    def ranks(run):                    # each assignment's rank in its expert's run
        return np.array([int((run[:i] == e).sum()) for i, e in enumerate(run)])

    np.testing.assert_array_equal(single["slots"], ranks(single["experts"]))
    per_shard = np.concatenate([ranks(r) < TM.capacity(MOE_TOKENS[1], cfg) for r in row])
    assert not np.array_equal(per_shard, single["keep"])
    np.testing.assert_array_equal(got["keep"], single["keep"])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_moe_train_step_equals_single_process(sharded, moe_reference, arch):
    """One train step on a ``SyntheticLM`` batch of 2 x 100 tokens, whose
    first MoE layer drops tokens: the logits, metrics, gradients and
    parameters at the harness's tolerances.  On (1, 2) the router runs
    whole on both model shards: a gradient that summed its share over
    them would be twice the single-process one."""
    _, runs = sharded
    ref = moe_reference[arch]
    assert ref["dropped"][0] > 0, ref["dropped"]
    assert_logits_equal(runs[f"moe train {arch}"], ref["train"])
    assert_step_equal(runs[f"moe train {arch}"], ref["train"])


@pytest.fixture
def fake_mesh():
    from repro_torch.launch.dryrun import fake_mesh

    with fake_mesh((1, 3), ("data", "model")) as mesh:
        yield mesh


def test_flash_refuses_shards_that_break_gqa_groups(fake_mesh):
    """6 q heads over 2 kv heads on a 3-way axis: q shards (2 a device), k
    and v cannot; B1 raises with the shapes rather than gather."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import place
    from repro_torch.kernels.flash_attention import mha_flash

    q = place(torch.randn(2, 16, 6, 32), fake_mesh, [Replicate(), Shard(2)])
    k, v = (place(torch.randn(2, 16, 2, 32), fake_mesh, [Replicate(), Replicate()])
            for _ in range(2))
    with pytest.raises(ValueError, match=r"q \(2, 16, 6, 32\).*k \(2, 16, 2, 32\)"):
        mha_flash(q, k, v)


def test_kernels_never_take_a_dtensor_whole(fake_mesh):
    """A DTensor reaches neither a kernel launch nor a plain version whole:
    ``takes_plain`` and the kernels' checks refuse it; B2 refuses operands
    it would have to gather."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import place
    from repro_torch.kernels import takes_plain
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.stream_pack import kernel as pack_kernel
    from repro_torch.kernels.stream_pack import stream_pack

    t = place(torch.randn(2, 16, 3, 32), fake_mesh, [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="local shard"):
        takes_plain(t)
    with pytest.raises(TypeError, match="local shard"):
        kernel.attention(t, t, t, group=1)
    w = place(torch.randn(3, 16, 12), fake_mesh, [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="local shard"):
        pack_kernel.stream_pack_matmul(place(torch.randn(3, 8, 16), fake_mesh,
                                             [Replicate(), Replicate()]), w)
    x_rows = place(torch.randn(3, 9, 16), fake_mesh, [Replicate(), Shard(1)])
    w_cols = place(torch.randn(3, 16, 12), fake_mesh, [Replicate(), Shard(2)])
    with pytest.raises(ValueError, match="would gather an operand"):
        stream_pack(x_rows, w_cols)


def test_moe_refuses_tokens_sharded_on_seq(fake_mesh):
    """The slots need the global token order ``b·S + s``, whose batch
    shards are contiguous: tokens sharded on ``seq`` are refused, with
    their layout, before anything is routed."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import place, use_sharding_ctx

    cfg = config("deepseek-v2-236b")
    p = init_params(cfg, seed=0, device="cpu").layers[0]["moe"]
    x = place(torch.randn(2, 6, cfg.d_model), fake_mesh, [Replicate(), Shard(1)])
    with use_sharding_ctx(fake_mesh):
        for fn in (TM.route, TM.apply_moe):
            with pytest.raises(ValueError, match=r"whole along seq: x \(2, 6, 128\)"):
                fn(p, x, cfg)


def _moe_grads(cfg, mesh=None) -> list:
    """out, aux and the gradients of x and of every MoE weight of layer 0
    (bf16, seed 0) for :func:`moe_input`, on ``mesh`` when given: local
    tensors, as float32."""
    from repro_torch.distributed import shard_model, shard_tree, use_sharding_ctx
    from repro_torch.models import param_axes

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = init_params(cfg, seed=0, device="cpu")
    x = torch.from_numpy(moe_input(cfg)).to(torch.bfloat16)
    if mesh is not None:
        shard_model(model, param_axes(cfg), mesh)
        x = shard_tree(x, "batch seq embed", mesh)
    x.requires_grad_()
    p = model.layers[0]["moe"]
    weights = list(p.parameters())
    for w in weights:
        w.requires_grad_()
    with use_sharding_ctx(mesh):
        out, aux = TM.apply_moe(p, x, cfg)
        grads = torch.autograd.grad(out.float().square().sum() + aux, [x] + weights)
    return [(t.to_local() if mesh is not None else t).detach().float()
            for t in (out, aux, *grads)]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_one_device_mesh_moe_is_the_single_process_arithmetic(arch):
    """On a (1, 1) mesh (a process group of one) every mesh dimension
    holds one device, so no collective runs and each op is the
    single-process one: bf16 ``apply_moe`` at 2 x 100 tokens (experts
    overflowing), its out, aux and the gradients of x and of every MoE
    weight bit for bit, and a float32 train step's logits, metrics,
    gradients and parameters bit for bit (the card's 21f holds the bf16
    step at full width the same way)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.dryrun import fake_mesh as one_mesh

    cfg = config(arch)
    want, step = _moe_grads(cfg), local_step(cfg, moe_batch(cfg))
    with one_mesh((1, 1), ("data", "model")) as mesh, CommDebugMode() as comm:
        got, on_mesh = _moe_grads(cfg, mesh), local_step(cfg, moe_batch(cfg), mesh)
    assert comm.get_total_counts() == 0
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(on_mesh["logits"], step["logits"])
    assert on_mesh["metrics"] == step["metrics"]
    for key in ("grads", "params"):
        assert set(on_mesh[key]) == set(step[key])
        assert all(np.array_equal(on_mesh[key][n], v) for n, v in step[key].items()), key


def _launch(args, env, tmp_path, tag):
    proc = subprocess.run(args, env=env, capture_output=True, text=True, timeout=240,
                          cwd=tmp_path)
    assert proc.returncode == 0, f"{tag}:\n{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}"
    return [float(line.split()[3]) for line in proc.stdout.splitlines()
            if line.startswith("step ")]


@pytest.mark.timeout(300)
def test_trainer_under_torchrun_gives_the_single_process_losses(tmp_path):
    """``launch/train.py --model-axis 2`` on 2 gloo ranks (``torchrun
    --standalone``, CPU) takes the steps the one-process launcher takes:
    the same losses, and a checkpoint that restores into a single-process
    model within 0.2 x the steps' summed lr of the one-process one."""
    steps, lr, warmup = 3, 1e-3, 1
    flags = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu", "--steps", str(steps),
             "--batch", "2", "--seq", "16", "--log-every", "1", "--lr", str(lr),
             "--warmup", str(warmup), "--dtype", "float32"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    alone = _launch([sys.executable, "-m", "repro_torch.launch.train", *flags,
                     "--ckpt", str(tmp_path / "alone")], env, tmp_path, "one process")
    ranks = _launch([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *flags,
                     "--model-axis", "2", "--ckpt", str(tmp_path / "sharded")],
                    env, tmp_path, "torchrun")
    assert len(alone) == len(ranks) == steps
    np.testing.assert_allclose(ranks, alone, rtol=METRIC_TOL)
    cfg = config("stablelm-1.6b")
    models = []
    for name in ("alone", "sharded"):
        model = Transformer(cfg, device="cpu")
        _, manifest = restore_checkpoint(tmp_path / name, {"params": model})
        assert manifest["step"] == steps
        models.append(dict(model.named_parameters()))
    summed = sum(float(cosine_schedule(torch.tensor(s), peak_lr=lr, warmup_steps=warmup,
                                       total_steps=steps)) for s in range(steps))
    for name, p in models[0].items():
        np.testing.assert_allclose(models[1][name].detach().numpy(), p.detach().numpy(),
                                   rtol=0, atol=0.2 * summed, err_msg=name)
