"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package, on the CPU, with nothing allocated.

* ``abstract_model`` builds every parameter on the meta device; its names
  (the ``repro_torch.bridge`` names of JAX's leaves), shapes, dtypes and
  logical axes equal JAX's ``abstract_model``'s for all ten archs.
* Full-size cases, one of each step kind (and the long-context overrides
  at ``long_500k``), on both production meshes: every group's bytes per
  device (params, AdamW's moments, the cache, the batch) equal a sum over
  JAX's leaves of the elements their JAX ``PartitionSpec`` leaves one
  device, times the port's element size (the port's ids are int64 where
  JAX's are int32; every other dtype is JAX's).
* The FLOPs the dry run counts for phi4-mini-3.8b at full size are within
  1% of the analytic count of the step's matrix products (the formula is
  in :func:`_phi4_flops`), and the shape cache under the counter changes
  no count and hands back no meta tensor for an op that made a CPU one.
* A meta tensor goes through each kernel wrapper (B1 forward and
  backward, B2) to its plain version and counts no launch.
* The partitioned pass, at smoke size on small fake meshes: the dense
  prefill's collectives are the ones the rules imply (derived in
  :func:`test_partitioned_collectives_are_the_rules`), one device's FLOPs
  times the devices are the global count where every product is sharded,
  and a column-then-row MLP's are its global FLOPs over the model axis;
  the depth extrapolation equals a run at full depth, the peak too; every
  arch x applicable shape partitions, and a case that cannot fails naming
  its op.
* The counts of one device's memory: a column-then-row MLP's bytes
  accessed, output and temp bytes equal the hand counts
  (:func:`test_partitioned_memory_and_traffic_are_the_hand_counts`), a
  kernel's plain version counts as one launch, and the prediction for a
  train step on meta tensors equals the count of the real step on the CPU.
* The MoE layer on each device's tokens: its collectives counted by hand
  (:func:`test_the_moe_layer_gathers_no_tokens`), and the full MoE
  configs' temps on the production meshes under their ceilings.
"""

import dataclasses
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.distributed.sharding as JS  # noqa: E402
from repro.configs.shapes import input_specs as j_input_specs  # noqa: E402
from repro.models.transformer import abstract_model as j_abstract_model  # noqa: E402
from repro.models.transformer import cache_axes as j_cache_axes  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import mha_flash  # noqa: E402
from repro_torch.kernels.stream_pack import stream_pack  # noqa: E402
from repro_torch.configs.shapes import INPUT_SHAPES, applicable  # noqa: E402
from repro_torch.distributed import batch_axes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import abstract_model, forward  # noqa: E402

ARCHS = JC.all_archs()
MESHES = (False, True)
# one case of each step kind; zamba2 at long_500k takes the overrides
BYTE_CASES = [("phi4-mini-3.8b", "train_4k"), ("llava-next-34b", "prefill_32k"),
              ("deepseek-v2-236b", "decode_32k"), ("zamba2-2.7b", "long_500k")]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _leaves(tree, axes, prefix=""):
    """(name, leaf, axes) of a tree of dicts and lists and its axes tree."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, axes[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, axes[i], f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree, axes


def _bridge_names(sds, axes):
    """JAX's abstract params by the bridge's per-layer names: (name, shape,
    dtype, axes), a stacked leaf's ``layers`` axis dropped."""
    for name, leaf, ax in _leaves(sds, axes):
        head, _, rest = name.partition(".")
        if ax.startswith("layers ") and head in ("layers", "encoder", "decoder"):
            for i in range(leaf.shape[0]):
                yield f"{head}.{i}.{rest}", tuple(leaf.shape[1:]), leaf.dtype, ax[7:]
        else:
            yield name, tuple(leaf.shape), leaf.dtype, ax


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_model_equals_jax(arch):
    model, axes = abstract_model(TC.get(arch))
    params = dict(model.named_parameters())
    assert all(p.is_meta for p in params.values())              # nothing allocated
    want = list(_bridge_names(*j_abstract_model(JC.get(arch))))
    assert sorted(params) == sorted(name for name, *_ in want)
    for name, shape, dtype, ax in want:
        p = params[name]
        assert tuple(p.shape) == shape, name
        assert p.dtype == getattr(torch, jnp.dtype(dtype).name), name
        assert axes[name] == ax == p.axes, name


class JaxFakeMesh:
    def __init__(self, mesh):
        self.axis_names = mesh.mesh_dim_names
        self.devices = np.empty(mesh.shape, object)


def _jax_local_elements(shape, axes, mesh, rules):
    """Elements of one device's share of a leaf under JAX's pspec."""
    r = {**JS.DEFAULT_RULES, **(rules or {})}
    spec = JS.logical_to_pspec(JS.parse_axes(axes), shape, JaxFakeMesh(mesh), r)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        n *= dim // math.prod(sizes[a] for a in names)
    return n


_RECORDS: dict = {}


def _records(arch, shape):
    if (arch, shape) not in _RECORDS:
        _RECORDS[(arch, shape)] = dryrun.run_case(arch, shape, meshes=MESHES)
    return _RECORDS[(arch, shape)]


def _jax_groups(arch, shape):
    """JAX's leaves by dry-run group as (name, shape, axes), with the
    port's element size of each."""
    jcfg = JC.get(arch)
    kind, specs = j_input_specs(jcfg, shape)
    sds, axes = j_abstract_model(jcfg)
    params = list(_leaves(sds, axes))
    tparams = dict(abstract_model(TC.get(arch))[0].named_parameters())
    by_name = {}
    for name, leaf, ax in _leaves(sds, axes):
        head, _, rest = name.partition(".")
        port = f"{head}.0.{rest}" if ax.startswith("layers ") else name
        by_name[name] = tparams[port].element_size()
    groups = {"params": [(n, leaf.shape, ax, by_name[n]) for n, leaf, ax in params],
              "optimizer": [], "cache": [], "batch": []}
    if kind == "train":
        groups["optimizer"] = [("step", (), "", 4)] + [
            (n, leaf.shape, ax, 4) for _ in range(2) for n, leaf, ax in params]
    if kind == "decode":
        groups["cache"] = [(n, leaf.shape, ax, 8 if leaf.dtype == jnp.int32 else
                            jnp.dtype(leaf.dtype).itemsize)
                           for n, leaf, ax in _leaves(specs["cache"],
                                                      j_cache_axes(jcfg, per_slot=False))]
        groups["batch"] = [("tokens", specs["tokens"].shape, "batch seq", 8)]
    else:
        batch = specs["batch"]
        groups["batch"] = [(n, leaf.shape, batch_axes(batch)[n],
                            8 if leaf.dtype == jnp.int32 else jnp.dtype(leaf.dtype).itemsize)
                           for n, leaf in batch.items()]
    return groups


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch,shape", BYTE_CASES)
def test_device_bytes_equal_jax_pspecs(arch, shape):
    rules = dict(dryrun.LONG_CONTEXT_OVERRIDES) if shape == "long_500k" else None
    groups = _jax_groups(arch, shape)
    for multi_pod, record in zip(MESHES, _records(arch, shape)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert record["mesh"] == ("2x16x16" if multi_pod else "16x16")
        assert record["devices"] == mesh.size
        memory = record["memory"]
        for group, leaves in groups.items():
            want = sum(_jax_local_elements(s, ax, mesh, rules) * size
                       for _, s, ax, size in leaves)
            assert memory[f"{group}_bytes"] == want, group
        assert memory["argument_bytes"] == sum(memory[f"{g}_bytes"] for g in dryrun.GROUPS)
        assert memory["fits"] == (memory["argument_bytes"] + memory["temp_bytes"]
                                  + memory["output_bytes"] <= 80e9)
        assert record["params"] == JC.get(arch).param_count
        assert record["active_params"] == JC.get(arch).active_param_count


def _phi4_flops(kind: str, B: int, S: int) -> int:
    """phi4-mini's matrix-product FLOPs (2 per multiply-add) for one step
    at batch B and length S (the cache's length for decode):

    per layer, over N tokens: projections 2·N·D·(2·H + 2·KV)·hd, FFN
    6·N·D·F; attention A: the plain version's two products over every
    (query, key) pair, 4·B·H·Sq·Skv·hd (the masked half included; decode
    against the cache, 4·B·H·(S + 1)·hd with its new token); unembed
    U = 2·N·D·V over the padded vocab.  prefill and decode: L·(P + A) + U.
    train (``cfg.remat``: each layer recomputed in the backward, up to the
    last product whose output the backward needs, so the FFN's down
    projection, 2·N·F·D, is not recomputed): forward L·(P + A), recompute
    L·(P - 2·N·F·D + A), backward 2·P and the plain backward's five
    products (2.5·A) a layer, and 2·U: L·(4·P - 2·N·F·D + 4.5·A) + 3·U."""
    cfg = TC.get("phi4-mini-3.8b")
    D, H, KV, hd, F, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                             cfg.d_ff, cfg.n_layers, cfg.padded_vocab)
    N = B * (1 if kind == "decode" else S)
    P = 2 * N * D * (2 * H + 2 * KV) * hd + 6 * N * D * F
    A = 4 * B * H * (S + 1) * hd if kind == "decode" else 4 * B * H * S * S * hd
    U = 2 * N * D * V
    if kind == "train":
        return L * (4 * P - 2 * N * F * D + 9 * A // 2) + 3 * U
    return L * (P + A) + U


@pytest.mark.timeout(300)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_phi4_flops_match_the_products(shape):
    sh = INPUT_SHAPES[shape]
    got = _records("phi4-mini-3.8b", shape)[0]["flops"]
    want = _phi4_flops(sh.kind, sh.global_batch, sh.seq_len)
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_shape_cache_changes_no_count():
    cfg = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), dtype="bfloat16")
    model, _ = abstract_model(cfg)
    tokens = torch.empty((2, 64), dtype=torch.int64, device="meta")

    def run():
        with torch.no_grad():
            return forward(model, {"tokens": tokens}, cfg)[0]

    with FlopCounterMode(display=False) as plain:
        a = run()
    with dryrun.MetaShapeCache(), FlopCounterMode(display=False) as cached:
        b = run()
        b = run()                                  # every op a cache hit
    assert plain.get_total_flops() * 2 == cached.get_total_flops() > 0
    assert a.shape == b.shape and a.dtype == b.dtype and b.is_meta


def test_shape_cache_runs_ops_that_make_cpu_tensors():
    # a factory op with no tensor input makes a CPU tensor: repeated under
    # the cache, it must run again and give CPU data, never a meta stand-in
    with dryrun.MetaShapeCache():
        made = [torch.arange(5, dtype=torch.float32) for _ in range(2)]
        meta = [torch.ones(3, device="meta") for _ in range(2)]
    for t in made:
        assert t.device.type == "cpu" and torch.equal(t, torch.arange(5.0))
    assert all(t.is_meta and t.shape == (3,) for t in meta)


def test_main_writes_records_and_fails_on_a_failure(tmp_path, monkeypatch, capsys):
    failures = dryrun.run(["phi4-mini-3.8b"], ["decode_32k", "long_500k"], (False,),
                          out_dir=tmp_path)
    assert failures == []
    assert [p.name for p in tmp_path.iterdir()] == ["phi4-mini-3.8b_decode_32k_16x16.json"]
    assert "SKIP  phi4-mini-3.8b x long_500k" in capsys.readouterr().out

    def broken(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(dryrun, "run_case", broken)
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k"])
    assert exc.value.code == 1


def test_meta_tensors_take_the_plain_versions_and_count_no_launch():
    before = launch_counts()
    q = torch.empty((2, 4096, 24, 128), dtype=torch.bfloat16, device="meta", requires_grad=True)
    k = torch.empty((2, 4096, 8, 128), dtype=torch.bfloat16, device="meta", requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    out = mha_flash(q, k, v)                           # through FlashAttention
    assert out.shape == q.shape and out.is_meta
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    with torch.no_grad():
        assert mha_flash(q, k, v, causal=False).shape == q.shape
    x = torch.empty((160, 64, 5120), dtype=torch.bfloat16, device="meta")
    w = torch.empty((160, 5120, 1536), dtype=torch.bfloat16, device="meta")
    assert stream_pack(x, w).shape == (160, 64, 1536)
    assert stream_pack(x[0], w).shape == (160, 64, 1536)          # a shared x
    assert launch_counts() == before


# the partitioned pass, at smoke size on fake meshes of 2 and 4 ranks
MESH_1x2 = ((1, 2), ("data", "model"))
MUST_PARTITION = [a for a in ARCHS if TC.get(a).family in dryrun.MUST_PARTITION]
CASES = [(a, s) for a in ARCHS for s in INPUT_SHAPES if applicable(TC.get(a), s)]
_PARTITIONED: dict = {}


def _partitioned(arch, shape):
    """The smoke config's partitioned pass on (2, 2), once per case."""
    if (arch, shape) not in _PARTITIONED:
        rules = dict(dryrun.LONG_CONTEXT_OVERRIDES) if shape == "long_500k" else None
        _PARTITIONED[(arch, shape)] = dryrun.partitioned(
            TC.get(arch, smoke=True), shape, (2, 2), ("data", "model"), rules)
    return _PARTITIONED[(arch, shape)]


@pytest.mark.timeout(300)
def test_partitioned_collectives_are_the_rules():
    """phi4-mini smoke (D = 192, L = 2, bf16) at prefill_32k (B 32 x S
    32768) on (1, 2): the data axis is one device, the model axis shards
    heads (6 and 2 kv over 2), mlp and vocab.  Per device: the embedding's
    vocab-sharded partial sum is reduced once, each layer's out-projection
    and FFN down-projection give a partial sum reduced at the residual, and
    the logits stay vocab-sharded: 1 + 2 L all-reduces of B·S·D·2 bytes."""
    cfg = TC.get("phi4-mini-3.8b", smoke=True)
    r = dryrun.partitioned(cfg, "prefill_32k", *MESH_1x2)
    sh = INPUT_SHAPES["prefill_32k"]
    per, n = sh.global_batch * sh.seq_len * cfg.d_model * 2, 1 + 2 * cfg.n_layers
    assert r["partitioned"] and r["partitioned_layers"] == [cfg.n_layers]
    assert r["collectives"]["counts"] == {"all-gather": 0, "all-reduce": n, "reduce-scatter": 0,
                                          "all-to-all": 0, "collective-permute": 0}
    assert r["collectives"]["bytes_per_kind"]["all-reduce"] == r["collectives"]["total_bytes"] \
        == n * per


@pytest.mark.timeout(300)
def test_the_train_step_gathers_no_logits():
    """phi4-mini smoke at train_4k (B 256 x S 4096, vocab 512) on a fake
    (2, 2) mesh: one device holds 128 x 4096 rows of 256 vocabulary
    columns, 512 MiB of float32 logits.  The loss runs B5 on that shard
    and all-reduces its per-row partials over the model axis (a max of
    (rows,) and a sum of (rows, 2) float32): no all-gather is as large as
    the device's logits (the largest moves bf16 activations of (rows, D),
    192 MiB), and both of the combine's all-reduces are there.  Before B5
    the loss gathered the logits whole over the vocabulary: one all-gather
    of exactly the device's 512 MiB."""
    from repro_torch.launch.comm_analysis import KINDS, CommCounter

    cfg = TC.get("phi4-mini-3.8b", smoke=True)
    sh = INPUT_SHAPES["train_4k"]
    rows = sh.global_batch // 2 * sh.seq_len
    logits = rows * (cfg.padded_vocab // 2) * 4
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        case = dryrun.build_case(cfg, "train_4k", mesh)
        with dryrun.MetaShapeCache(), CommCounter() as counter:
            case.step()
    gathers = [n for op, n in counter.records if KINDS.get(op) == "all-gather"]
    reduces = [n for op, n in counter.records if KINDS.get(op) == "all-reduce"]
    assert logits == 512 * 2**20
    assert gathers and max(gathers) < logits
    assert reduces.count(4 * rows) >= 1 and reduces.count(8 * rows) >= 1


@pytest.mark.timeout(300)
def test_the_moe_layer_gathers_no_tokens():
    """deepseek-v2 smoke's MoE layer (D 128, E 4 top-2, d_ff 64, one shared
    expert, bf16) forward and backward on train_4k's tokens (B 256 x S
    4096, N = 1,048,576) on a fake (2, 2) mesh, meta tensors.  A device
    holds N_l = 524,288 tokens (128 MiB) and E_loc = 2 experts of
    capacity(N) = 655,360 slots.  Its collectives, by hand:

    * the router: its (D, E) weight gathered from its fsdp halves, (64, 4)
      float32; the aux loss's probability sums, one all-reduce of (E,)
      float32; the slots: one all-gather of the (E,) int64 counts;
    * the dispatch: one all-reduce of the local buffer, (E_loc·cap + 1, D)
      bf16 (one writer a slot);
    * the combine: one all-reduce of the (N_l, K, D) rows (one nonzero an
      entry);
    * besides those, all-gathers of the shared expert's weights (4 KiB
      each) and of B2's products' D halves, (E_loc, cap, D / 2) bf16: the
      expert outputs, laid out on the fsdp halves of ``w_down``'s D, made
      whole for the combine, and the capacity buffer's gradient from the
      gate and up products on the halves of their D.

    No all-gather carries tokens (N_l·D, or N_l·K·D, bytes) and none the
    expert outputs over the model axis (E_loc·cap·D bytes).  The routing on
    the global tokens gathered both: the tokens whole over the data axis
    (an all-gather of exactly N_l·D·2 bytes) and every expert's outputs
    over the model axis.  At this width a D half of the products
    (E_loc·cap·D/2 = 1.25 N_l·D) is larger than the token shard (K·1.25
    over a model axis of 2); DeepSeek-V2's on 16x16 is 0.47 of it."""
    from repro_torch.distributed import shard_model, shard_tree, use_sharding_ctx
    from repro_torch.launch.comm_analysis import KINDS, CommCounter
    from repro_torch.models import moe

    cfg = TC.get("deepseek-v2-236b", smoke=True)
    m, D = cfg.moe, cfg.d_model
    sh = INPUT_SHAPES["train_4k"]
    N = sh.global_batch * sh.seq_len
    N_l, E_loc, cap = N // 2, m.num_experts // 2, moe.capacity(N, cfg)
    assert cap == 655360 and cfg.dtype == "bfloat16"
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        model, axes = abstract_model(cfg)
        shard_model(model, axes, mesh)
        p = model.layers[0]["moe"]
        weights = [w.requires_grad_() for w in p.parameters()]
        x = shard_tree(torch.empty(sh.global_batch, sh.seq_len, D, dtype=torch.bfloat16,
                                   device="meta"), "batch seq embed", mesh).requires_grad_()
        with dryrun.MetaShapeCache(), CommCounter() as counter, use_sharding_ctx(mesh):
            out, aux = moe.apply_moe(p, x, cfg)
            torch.autograd.grad(out.sum() + aux, [x] + weights)
    gathers = [n for op, n in counter.records if KINDS.get(op) == "all-gather"]
    reduces = [n for op, n in counter.records if KINDS.get(op) == "all-reduce"]
    halves = E_loc * cap * D // 2 * 2
    assert gathers.count(m.num_experts * 8) == 1                      # the counts
    assert gathers.count(D // 2 * m.num_experts * 4) == 1             # the router
    assert sorted(n for n in gathers if n > 4096) == [halves] * 3
    assert max(n for n in gathers if n != halves) <= 4096
    tokens = N_l * D * 2
    assert tokens not in gathers and tokens * m.top_k not in gathers
    assert max(gathers) < E_loc * cap * D * 2
    assert reduces.count((E_loc * cap + 1) * D * 2) == 1              # the dispatch
    assert reduces.count(N_l * m.top_k * D * 2) == 1                  # the combine
    assert reduces.count(m.num_experts * 4) == 1                      # the aux loss


# the temps the local routing keeps the MoE configs' steps under (GiB a
# device): a quarter of deepseek-v2's train_4k at 16x16 on the global
# tokens (448.685), and about a fifth of the others' (425.365, 277.654,
# 380.151)
MOE_TEMP_CEILINGS = [("deepseek-v2-236b", "train_4k", False, 112),
                     ("deepseek-v2-236b", "train_4k", True, 107),
                     ("arctic-480b", "train_4k", False, 90),
                     ("deepseek-v2-236b", "prefill_32k", False, 95)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch, shape, multi_pod, ceiling", MOE_TEMP_CEILINGS)
def test_moe_steps_stay_under_their_temp_ceilings(arch, shape, multi_pod, ceiling):
    """The full configs on the production mesh (fake, meta tensors; the
    dry run's own pass at depths 2 and 3, extrapolated): each device routes
    its own tokens, so the step's temp is well under the global tokens'."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    r = dryrun.partitioned(TC.get(arch), shape, mesh.shape, mesh.mesh_dim_names)
    assert r["temp_bytes"] <= ceiling * 2**30, r["temp_bytes"] / 2**30


def _long_decode_counts(arch, positions):
    """One device's share of ``arch`` smoke's long_500k decode step over a
    cache of ``positions`` on a fake (2, 2) mesh under the long-context
    rules: the counts and the collective records (wait_tensor left out)."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.comm_analysis import CommCounter

    shape = InputShape("long_500k", positions, 1, "decode")
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        case = dryrun.build_case(TC.get(arch, smoke=True), shape, mesh,
                                 dict(dryrun.LONG_CONTEXT_OVERRIDES))
        with dryrun.MetaShapeCache(), CommCounter() as counter:
            case.step()
    return counter, [r for r in counter.records if r[0] != "wait_tensor"]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma2-27b"])
def test_the_long_decode_combines_partials_and_gathers_no_scores(arch):
    """zamba2 and gemma2 smoke at long_500k (batch 1, 524288 positions) on
    a fake (2, 2) mesh: the data axis splits the cache's positions, the
    model axis its kv heads.  Each attention layer runs B3's partials on
    the device's positions and the combine's two all-reduces over the data
    axis: a max of (1, 1, NH / 2) and a sum of (1, 1, NH / 2, hd + 1)
    float32.  No all-gather grows with the cache (the same records at
    65536 positions; on the parent, DTensor's plain version gathered the
    float32 scores: 18 all-gathers, 2,171,832 B, for zamba2), and the only
    bytes that do are one read of the device's K and V: the cache writes
    move their new rows, not the shard."""
    from repro_torch.launch.comm_analysis import KINDS

    cfg = TC.get(arch, smoke=True)
    layers = cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else cfg.n_layers
    heads, hd = cfg.n_heads // 2, cfg.resolved_head_dim
    counter, records = _long_decode_counts(arch, 524288)
    short, short_records = _long_decode_counts(arch, 65536)
    reduces = [n for op, n in records if KINDS.get(op) == "all-reduce"]
    assert reduces.count(4 * heads) == reduces.count(4 * heads * (hd + 1)) == layers > 0
    assert records == short_records
    kv_local = (cfg.n_kv_heads // 2) * hd * 2 * getattr(torch, cfg.dtype).itemsize
    assert counter.bytes_accessed - short.bytes_accessed == \
        layers * kv_local * (524288 - 65536) // 2


def test_a_cache_write_moves_its_rows_not_the_shard():
    """A synchronized append of one new row to every layer of a cache
    sharded over positions (the data axis of a fake (2, 2) mesh): its
    bytes accessed do not grow with the cache, and stay below 16 x the new
    rows' bytes (the rows read and written, the old rows kept where a
    write falls in another shard, the indices), where rewriting the shard
    moved it twice."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import place
    from repro_torch.models import layers as TL

    L_, NKV, hd = 2, 2, 32
    counts = []
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        for positions in (4096, 65536):
            cache = [place(torch.empty((L_, 1, positions, NKV, hd), dtype=torch.bfloat16,
                                       device="meta"), mesh, [Shard(2), Replicate()])
                     for _ in range(2)]
            new = [torch.empty((L_, 1, 1, NKV, hd), dtype=torch.bfloat16, device="meta")
                   for _ in range(2)]
            pos = torch.tensor(positions - 3, device="meta")
            counts.append(dryrun.count_step(lambda: TL.append_kv_synced(*cache, *new, pos)))
    rows = 2 * L_ * NKV * hd * 2
    assert counts[0]["bytes_accessed"] == counts[1]["bytes_accessed"] < 16 * rows
    assert counts[1]["temp_bytes"] < 16 * rows


@pytest.mark.timeout(300)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_flops_per_device_times_devices_is_the_global_count(shape):
    # on (1, 2) every product of the dense forward and decode is sharded
    cfg = TC.get("phi4-mini-3.8b", smoke=True)
    whole = dryrun.step_flops(dryrun.build_case(cfg, shape))
    r = dryrun.partitioned(cfg, shape, *MESH_1x2)
    assert abs(2 * r["flops_per_device"] - whole) <= 0.01 * whole, (r["flops_per_device"], whole)


def test_column_then_row_mlp_flops_are_split_by_the_model_axis():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import place
    from repro_torch.launch.comm_analysis import CommCounter, collective_bytes

    B, D, F, axis = 8, 64, 256, 4
    with dryrun.fake_mesh((1, axis), ("data", "model")) as mesh:
        x = place(torch.empty(B, D, device="meta"), mesh, [Replicate(), Replicate()])
        w1 = place(torch.empty(D, F, device="meta"), mesh, [Replicate(), Shard(1)])
        w2 = place(torch.empty(F, D, device="meta"), mesh, [Replicate(), Shard(0)])
        with CommCounter() as counter:
            y = ((x @ w1) @ w2).redistribute(mesh, [Replicate(), Replicate()])
    assert y.shape == (B, D)
    assert counter.flops == 2 * (2 * B * D * F) // axis
    assert collective_bytes(counter.records)["counts"]["all-reduce"] == 1


COUNTS = ("collectives", "flops_per_device", "bytes_accessed", "temp_bytes", "output_bytes")


@pytest.mark.timeout(300)
def test_depth_extrapolation_equals_the_full_depth():
    # 4 layers, period 1: run at 2 and 3 layers, extrapolated by one period
    cfg = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), n_layers=4)
    got = dryrun.partitioned(cfg, "train_4k", (2, 2), ("data", "model"))
    assert got["partitioned_layers"] == [2, 3]
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        full = dryrun._partition_once(cfg, "train_4k", mesh, None)
    assert got["collectives"] == full["collectives"]
    assert got["flops_per_device"] == full["flops_per_device"]
    for key in ("bytes_accessed", "temp_bytes", "output_bytes"):
        assert got[key] == full[key] > 0, key


@pytest.mark.timeout(300)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_depth_extrapolation_of_the_peak_holds_without_autograd(shape):
    """Without autograd the first layer's peak holds no earlier layer's
    output, so the peak grows from 1 to 2 layers by another amount than
    from 2 on: the pass runs at 2P and 3P and equals a 5-layer run in every
    count, where 1 and 2 layers would miss it.  So for the prefill (not at
    all after 2 layers) and for the decode (each layer's new keys and
    values from 2 on): its attention is decode attention's plain version,
    counted as one launch that holds no float32 copy of the cache, and its
    cache append writes the new rows alone, with no temporary the size of
    the cache's shard."""
    cfg = dataclasses.replace(TC.get("phi4-mini-3.8b", smoke=True), n_layers=5)
    got = dryrun.partitioned(cfg, shape, (2, 2), ("data", "model"))
    assert got["partitioned_layers"] == [2, 3]
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        full = dryrun._partition_once(cfg, shape, mesh, None)
        one, two = (dryrun._partition_once(dataclasses.replace(cfg, n_layers=n), shape, mesh,
                                           None) for n in (1, 2))
    for key in COUNTS:
        assert got[key] == full[key], key
    from_one = dryrun._extrapolate(one, two, 4)["temp_bytes"]
    assert from_one != full["temp_bytes"]              # 1 and 2 layers would miss the peak


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", MUST_PARTITION)
def test_attention_families_partition(arch):
    for shape in INPUT_SHAPES:
        if not applicable(TC.get(arch), shape):
            continue
        r = _partitioned(arch, shape)
        assert r["partitioned"] is True, (shape, r)
        assert r["flops_per_device"] > 0 and r["collectives"]["total_bytes"] > 0, shape


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch,shape", CASES)
def test_every_case_partitions(arch, shape):
    """Every family partitions at every applicable shape (the mLSTM, the
    sLSTM, Mamba2's conv and scan on each device's shards), with one
    device's FLOPs, collectives, bytes accessed and peak."""
    assert set(dryrun.MUST_PARTITION) == {TC.get(a).family for a in ARCHS}
    r = _partitioned(arch, shape)
    assert r["partitioned"] is True
    assert r["flops_per_device"] > 0 and r["collectives"]["total_bytes"] > 0
    assert r["bytes_accessed"] > 0 and r["temp_bytes"] > 0 and r["output_bytes"] > 0


def test_a_case_that_cannot_partition_fails(monkeypatch):
    def refuse(step):
        raise NotImplementedError("Operator aten.cummax.default does not have a sharding "
                                  "strategy registered.")

    monkeypatch.setattr(dryrun, "count_step", refuse)
    with pytest.raises(RuntimeError, match=r"xlstm-smoke x train_4k does not partition on "
                                           r"2x2: aten\.cummax\.default"):
        dryrun.partitioned(TC.get("xlstm-125m", smoke=True), "train_4k", (2, 2),
                           ("data", "model"))


def test_partitioned_memory_and_traffic_are_the_hand_counts():
    """A column-then-row MLP, y = (x @ w1) @ w2, forward and backward
    (``autograd.grad`` of y against a given gy into w1 and w2) on a fake
    (1, 2) mesh: x (B, D) and gy replicated, w1 (D, F) sharded on its
    columns, w2 (F, D) on its rows, float32, so one device holds F/2 = f
    of the hidden units and no collective runs.  Its five products on
    local shards, in the order they run:

    1. h = x @ w1 (B, f);          2. y = h @ w2 (B, D), a partial sum;
    3. dw2 = hᵀ @ gy (f, D);       4. dh = gy @ w2ᵀ (B, f), after which the
       second product's backward frees h, its saved input;
    5. dw1 = xᵀ @ dh (D, f).

    Each reads its operands and writes its output: every product touches
    one (B, D), one (D, f) and one (B, f) tensor, so the bytes accessed
    are 5·4·(B·D + D·f + B·f).  The storages the pass makes are h, y, dw2,
    dh and dw1; the peak is at the last product, y + dw2 + dh + dw1 (h
    freed).  The outputs, y, dw1 and dw2, are made by the pass: output
    bytes 4·(B·D + 2·D·f), temp bytes the peak less those, 4·B·f (dh).
    Run twice, the second pass on the shape cache's memoised products
    counts the same."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import place

    B, D, F = 8, 64, 256
    f = F // 2
    with dryrun.fake_mesh(*MESH_1x2) as mesh:
        x = place(torch.empty(B, D, device="meta"), mesh, [Replicate(), Replicate()])
        gy = place(torch.empty(B, D, device="meta"), mesh, [Replicate(), Replicate()])
        w1 = place(torch.empty(D, F, device="meta"), mesh, [Replicate(), Shard(1)])
        w2 = place(torch.empty(F, D, device="meta"), mesh, [Replicate(), Shard(0)])
        w1.requires_grad_()
        w2.requires_grad_()

        def mlp():
            y = (x @ w1) @ w2
            return (y, *torch.autograd.grad(y, (w1, w2), gy))

        def twice():
            mlp()
            return mlp()

        once, again = dryrun.count_step(mlp), dryrun.count_step(twice)
    assert once["collectives"]["total_bytes"] == 0
    assert once["flops_per_device"] == 5 * 2 * B * D * f
    assert once["bytes_accessed"] == 5 * 4 * (B * D + D * f + B * f)
    assert once["output_bytes"] == 4 * (B * D + 2 * D * f)
    assert once["temp_bytes"] == 4 * B * f
    assert again["bytes_accessed"] == 2 * once["bytes_accessed"]
    assert again["flops_per_device"] == 2 * once["flops_per_device"]
    assert (again["temp_bytes"], again["output_bytes"]) == (once["temp_bytes"],
                                                            once["output_bytes"])


def test_a_plain_version_counts_as_one_launch():
    """B1's plain version on meta tensors holds every score of a head, but
    on the card B1 reads q, k, v and writes o: the counter sees that one
    launch (and still the plain version's FLOPs)."""
    q = torch.empty((2, 1024, 6, 64), device="meta")
    k, v = (torch.empty((2, 1024, 2, 64), device="meta") for _ in range(2))
    with torch.no_grad():
        got = dryrun.count_step(lambda: mha_flash(q, k, v))
    size = 4 * (q.numel() + k.numel() + v.numel())
    assert got["bytes_accessed"] == size + 4 * q.numel()
    assert got["output_bytes"] == 4 * q.numel() and got["temp_bytes"] == 0
    assert got["flops_per_device"] == 4 * 2 * 6 * 1024 * 1024 * 64


def test_the_mla_decode_counts_latent_attention_as_one_launch(monkeypatch):
    """deepseek-v2 smoke's decode step on meta tensors: B6's plain version
    runs once a layer and counts as one launch (q, the layer's latents and
    the offsets read once, the context written), so the bytes accessed grow
    with the cache by exactly one read of every layer's latents, and the
    temp holds no (B, N, S, T) float32 scores and no float32 copy of the
    cache, which the plain absorbed form made before B6."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels.latent_attention import kernel as b6

    cfg = TC.get("deepseek-v2-236b", smoke=True)
    m, B = cfg.mla, 8
    calls = []
    inner = b6.latent_attention_ref

    def counting(*args, **kw):
        calls.append(args[2].shape)
        return inner(*args, **kw)

    monkeypatch.setattr(b6, "latent_attention_ref", counting)
    counts = {}
    for T in (4096, 16384):
        case = dryrun.build_case(cfg, InputShape("decode_mla", T, B, "decode"))
        counts[T] = dryrun.count_step(case.step)
    assert calls == [(B, 4096, m.kv_lora_rank)] * cfg.n_layers + \
        [(B, 16384, m.kv_lora_rank)] * cfg.n_layers
    esize = getattr(torch, cfg.dtype).itemsize
    latents = cfg.n_layers * B * (m.kv_lora_rank + m.qk_rope_head_dim) * esize
    grown = counts[16384]["bytes_accessed"] - counts[4096]["bytes_accessed"]
    assert grown == latents * (16384 - 4096)
    scores = B * cfg.n_heads * 1 * 16384 * 4
    assert counts[16384]["temp_bytes"] == counts[4096]["temp_bytes"] < scores


@pytest.mark.timeout(300)
def test_the_meta_prediction_equals_the_counted_cpu_step():
    """The counter's prediction for a train step on meta DTensors over a
    fake (1, 1) mesh (chip_smoke's check of phase 19c's step, at smoke
    size) equals what the same counter sees on the real step on the CPU,
    from real weights: the bytes made and accessed do not depend on the
    data, the mesh of one device or the shape cache."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.launch.comm_analysis import CommCounter
    from repro_torch.launch.serve import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.training import make_train_step
    from repro_torch.training.train_lib import batch_to_device

    cfg = TC.get("phi4-mini-3.8b", smoke=True)
    shape = InputShape("train_2x16", 16, 2, "train")
    meta = dryrun.partitioned(cfg, shape, (1, 1), ("data", "model"), remat=False)
    model = init_params(cfg, seed=0, device="cpu")
    state = adamw_init(dict(model.named_parameters()))
    batch = batch_to_device(SyntheticLM(data_config_for(cfg, batch_size=2, seq_len=16)).batch(0),
                            "cpu")
    step = make_train_step(cfg, lr=1e-4)
    with CommCounter() as counter:
        metrics = step(model, state, batch)[2]
    output = sum(t.untyped_storage().nbytes() for t in metrics.values())
    assert meta["output_bytes"] == output
    assert meta["temp_bytes"] == counter.peak_bytes - output > 0
    assert meta["bytes_accessed"] == counter.bytes_accessed


def test_a_failed_partition_names_its_op():
    # DTensor names a missing rule in its message; else the op it was
    # dispatching is the innermost ``op_call`` of its frames
    def dispatch(op_call):
        raise IndexError("list index out of range")

    try:
        dispatch(torch.ops.aten.constant_pad_nd.default)
    except IndexError as e:
        assert dryrun._op_of(e) == ("aten.constant_pad_nd.default "
                                    "(IndexError: list index out of range)")
    missing = NotImplementedError("Operator aten.cummax.default does not have a sharding "
                                  "strategy registered.")
    assert dryrun._op_of(missing) == "aten.cummax.default"
