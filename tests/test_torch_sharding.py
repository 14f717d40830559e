"""The port's logical-axis sharding against the JAX package's, on the CPU.

For every parameter of the ten full configs, on both production meshes
(16x16 and 2x16x16), ``repro_torch.distributed.logical_to_pspec`` gives
JAX's ``PartitionSpec`` entries; so it does for the synchronized decode
cache (``cache_axes(per_slot=False)``) at each decode shape, with the
long-context overrides at ``long_500k``.  JAX takes a fake mesh (axis
names and a device array's shape), the port a ``MeshSpec``: neither needs
512 devices.  Then the rules themselves (``parse_axes``, divisibility, no
mesh axis used twice), the DTensor placements, ``constrain`` and
``gather_fsdp`` as no-ops outside a context and on plain tensors, and, in
a one-process gloo group, ``constrain`` redistributing a DTensor.
"""

import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.distributed.sharding as JS  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.distributed as TD  # noqa: E402
from repro.configs.shapes import input_specs as j_input_specs  # noqa: E402
from repro.models.transformer import abstract_model as j_abstract_model  # noqa: E402
from repro.models.transformer import cache_axes as j_cache_axes  # noqa: E402
from repro_torch.configs.shapes import applicable, input_specs  # noqa: E402
from repro_torch.launch.mesh import MeshSpec, make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import abstract_model, cache_axes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = JC.all_archs()
MESHES = {"16x16": False, "2x16x16": True}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class JaxFakeMesh:
    """What JAX's ``logical_to_pspec`` reads of a mesh: axis names and the
    device array's shape (as ``tests/test_substrate.py`` fakes it)."""

    def __init__(self, spec: MeshSpec):
        self.axis_names = spec.mesh_dim_names
        self.devices = np.empty(spec.shape, object)


def _jax_pspec(axes: str, shape, mesh: MeshSpec, rules=None) -> tuple:
    r = {**JS.DEFAULT_RULES, **(rules or {})}
    return tuple(JS.logical_to_pspec(JS.parse_axes(axes), shape, JaxFakeMesh(mesh), r))


def _jax_leaves(tree, axes, prefix=""):
    """(name, shape, axes) of a JAX tree, the stacked subtrees unstacked
    into per-layer names as ``repro_torch.bridge`` names them (a stacked
    leaf's ``layers`` axis dropped)."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _jax_leaves(sub, axes[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _jax_leaves(sub, axes[i], f"{prefix}{i}.")
    else:
        yield prefix[:-1], tuple(tree.shape), axes


def _per_layer(name: str, shape, axes: str):
    """A stacked JAX leaf (``layers.attn.wq``, axes ``layers ...``) as the
    port's per-layer leaves (``layers.i.attn.wq``); other leaves as they
    are."""
    head, _, rest = name.partition(".")
    if axes.startswith("layers ") and head in ("layers", "encoder", "decoder"):
        return [(f"{head}.{i}.{rest}", shape[1:], axes[len("layers "):])
                for i in range(shape[0])]
    return [(name, shape, axes)]


_JAX_PARAMS: dict = {}


def _jax_params(arch):
    if arch not in _JAX_PARAMS:
        sds, axes = j_abstract_model(JC.get(arch))
        _JAX_PARAMS[arch] = [leaf for name, shape, ax in _jax_leaves(sds, axes)
                             for leaf in _per_layer(name, shape, ax)]
    return _JAX_PARAMS[arch]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_jax(arch, mesh_name):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    model, axes = abstract_model(TC.get(arch))
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    want = _jax_params(arch)
    assert sorted(shapes) == sorted(name for name, _, _ in want)
    sharded = 0
    for name, shape, jax_axes in want:
        assert shapes[name] == shape and axes[name] == jax_axes, name
        got = TD.logical_to_pspec(TD.parse_axes(axes[name]), shape, mesh, TD.DEFAULT_RULES)
        assert got == _jax_pspec(jax_axes, shape, mesh), name
        sharded += any(e is not None for e in got)
    assert sharded > 0


def _decode_cases():
    return [(arch, shape) for arch in ARCHS for shape in ("decode_32k", "long_500k")
            if applicable(TC.get(arch), shape)]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch,shape", _decode_cases())
def test_cache_pspecs_equal_jax(arch, shape, mesh_name):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    rules = dict(TD.LONG_CONTEXT_OVERRIDES) if shape == "long_500k" else None
    cfg = TC.get(arch)
    _, specs = input_specs(cfg, shape)
    port = {name: (shape, ax)
            for name, shape, ax in _jax_leaves(specs["cache"], cache_axes(cfg, per_slot=False))}
    jcfg = JC.get(arch)
    _, jspecs = j_input_specs(jcfg, shape)
    want = list(_jax_leaves(jspecs["cache"], j_cache_axes(jcfg, per_slot=False)))
    assert sorted(port) == sorted(name for name, _, _ in want)
    for name, jshape, jaxes in want:
        assert port[name] == (jshape, jaxes), name
        got = TD.pspec(jshape, jaxes, mesh, rules)
        assert got == _jax_pspec(jaxes, jshape, mesh, rules), name
    if shape == "long_500k":           # batch 1: the data axis shards the sequence
        for s, a in port.values():
            if "kv_seq" in a:
                assert "data" in str(TD.pspec(s, a, mesh, rules)), a


def test_parse_axes():
    assert TD.parse_axes("vocab fsdp") == ("vocab", "fsdp") == JS.parse_axes("vocab fsdp")
    assert TD.parse_axes("_ mlp") == (None, "mlp")
    assert TD.parse_axes("") == ()


def test_pspec_skips_nondividing_axis():
    mesh = MeshSpec((16,), ("model",))
    # 24 heads on a 16-wide model axis do not divide: replicated
    assert TD.logical_to_pspec(("heads",), (24,), mesh, {"heads": "model"}) == (None,)
    assert TD.logical_to_pspec(("heads",), (32,), mesh, {"heads": "model"}) == ("model",)
    # a one-wide axis shards nothing
    assert TD.logical_to_pspec(("heads",), (32,), MeshSpec((1,), ("model",)),
                               {"heads": "model"}) == (None,)


def test_pspec_never_reuses_mesh_axis():
    mesh = MeshSpec((4, 4), ("data", "model"))
    assert TD.logical_to_pspec(("mlp", "mlp"), (16, 16), mesh, {"mlp": "model"}) == ("model", None)
    # fsdp over ("pod", "data") on a single-pod mesh keeps "data" only
    assert TD.logical_to_pspec(("fsdp", "mlp"), (8, 8), mesh, TD.DEFAULT_RULES) == \
        ("data", "model")


def test_placements_and_local_shape():
    mesh = make_production_mesh(multi_pod=True)
    spec = TD.pspec((256, 3072, 8), "batch _ kv_heads", mesh)
    assert spec == (("pod", "data"), None, None)
    assert TD.placements_for(spec, mesh) == [Shard(0), Shard(0), Replicate()]
    assert TD.local_shape((256, 3072, 8), spec, mesh) == (8, 3072, 8)
    tree = TD.tree_shardings({"w": ((3072, 8192), "fsdp mlp"), "s": ((3072,), "_")}, mesh)
    assert tree == {"w": [Shard(0), Shard(0), Shard(1)], "s": [Replicate()] * 3}
    with pytest.raises(ValueError, match="rank"):
        TD.pspec((4, 4), "mlp", mesh)


def test_constrain_and_gather_are_noops_outside_a_context():
    x = torch.randn(4, 8)
    assert TD.constrain(x, "batch", "embed") is x
    assert TD.gather_fsdp(x, "fsdp", "mlp") is x
    mesh = MeshSpec((2, 2), ("data", "model"))
    with TD.use_sharding_ctx(mesh, {"gather_fsdp": "all"}) as ctx:
        assert ctx.rules["gather_fsdp"] == "all" and ctx.rules["heads"] == "model"
        assert TD.constrain(x, "batch", "embed") is x           # a plain tensor
        assert TD.gather_fsdp(x, "fsdp", "mlp") is x
        with TD.use_sharding_ctx(None):
            assert TD.sharding.current_ctx() is None
        assert TD.sharding.current_ctx() is ctx
    assert TD.sharding.current_ctx() is None


def test_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(model_axis=1, device="cpu")


CHILD = r"""
import torch, torch.distributed as dist
from torch.distributed.tensor import distribute_tensor, DTensor, Replicate, Shard
import repro_torch.distributed as TD
from repro_torch.launch.mesh import make_host_mesh
dist.init_process_group("gloo", init_method="tcp://localhost:%d", rank=0, world_size=1)
try:
    mesh = make_host_mesh(model_axis=1, device="cpu")
    assert tuple(mesh.mesh_dim_names) == ("data", "model") and tuple(mesh.shape) == (1, 1)
    x = torch.arange(12.0).reshape(3, 4)
    d = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    with TD.use_sharding_ctx(mesh):
        y = TD.constrain(d, "batch", "embed")
    assert isinstance(y, DTensor) and list(y.placements) == [Replicate(), Replicate()]
    assert torch.equal(y.full_tensor(), x)
    print("redistributed")
finally:
    dist.destroy_process_group()
"""


@pytest.mark.timeout(120)
def test_constrain_redistributes_a_dtensor():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", CHILD % port], env=env, capture_output=True,
                          text=True, timeout=100, cwd=ROOT)
    assert proc.returncode == 0 and "redistributed" in proc.stdout, proc.stderr[-2000:]
