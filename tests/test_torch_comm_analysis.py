"""The port's collective-byte accounting (``repro_torch.launch.comm_analysis``)
case for case against what ``tests/test_hlo_analysis.py`` checks of the JAX
package's HLO parser, on DTensor redistributions and functional
collectives recorded over a fake process group of 4 ranks (no devices,
nothing moved): operand bytes per kind, an async collective and its wait
counted once, a coalesced op's operands summed, other ops ignored; and the
JAX record's keys and kind names.
"""

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch.comm_analysis import (COLLECTIVES, CommCounter, collective_bytes,
                                              shape_bytes)

WORLD = 4


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mesh():
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=WORLD)
    yield init_device_mesh("cpu", (WORLD,), mesh_dim_names=("model",))
    dist.destroy_process_group()


def test_shape_bytes():
    assert shape_bytes(torch.float32, (128, 64)) == 128 * 64 * 4
    assert shape_bytes("bfloat16", (2, 3)) == 12
    assert shape_bytes(torch.bool, (8,)) == 8
    assert shape_bytes("token", ()) == 0  # unknown dtype ignored
    assert shape_bytes(torch.int32, ()) == 4    # scalar


def test_collective_bytes_counts_operands(mesh):
    p0 = torch.ones(128, 64)
    with CommCounter() as counter:
        # Partial -> Replicate: an all-reduce of the local (128, 64)
        ar = DTensor.from_local(p0, mesh, [Partial()]).redistribute(mesh, [Replicate()])
        # Shard -> Replicate: an all-gather whose operand is the local shard
        ag = DTensor.from_local(ar.to_local(), mesh, [Shard(0)]).redistribute(mesh, [Replicate()])
        # Partial -> Shard: a reduce-scatter of the local (128, 64)
        rs = DTensor.from_local(p0, mesh, [Partial()]).redistribute(mesh, [Shard(0)])
    assert ag.shape == (WORLD * 128, 64) and rs.to_local().shape == (128 // WORLD, 64)
    r = collective_bytes(counter.records)
    assert r["bytes_per_kind"]["all-reduce"] == 128 * 64 * 4
    assert r["bytes_per_kind"]["all-gather"] == 128 * 64 * 4  # operand = the local shard
    assert r["bytes_per_kind"]["reduce-scatter"] == 128 * 64 * 4
    assert r["counts"]["all-reduce"] == 1
    assert r["total_bytes"] == 3 * 128 * 64 * 4
    # the same counts as CommDebugMode's, which the counter is
    assert sum(r["counts"].values()) == counter.get_total_counts()


def test_async_pairs_counted_once(mesh):
    p0 = torch.ones(100)
    c10d = torch.ops._c10d_functional
    with CommCounter() as counter:
        # the collective and its wait, JAX's -start / -done pair
        out = c10d.all_reduce(p0, "sum", mesh.get_group().group_name)
        c10d.wait_tensor(out)
    names = [name for name, _ in counter.records]
    assert "wait_tensor" in names
    r = collective_bytes(counter.records)
    assert r["counts"]["all-reduce"] == 1
    assert r["bytes_per_kind"]["all-reduce"] == 400


def test_tuple_outputs_and_multi_operands(mesh):
    a, b = torch.ones(10), torch.ones(20)
    with CommCounter() as counter:
        outs = funcol.all_reduce_coalesced([a, b], "sum", mesh)
        outs = [t + 0 for t in outs]
    r = collective_bytes(counter.records)
    assert r["counts"]["all-reduce"] == 1
    assert r["bytes_per_kind"]["all-reduce"] == 40 + 80


def test_non_collective_lines_ignored(mesh):
    x = torch.ones(1000, 10)
    with CommCounter() as counter:
        y = (x @ x.T) + 1
        DTensor.from_local(y, mesh, [Replicate()]).redistribute(mesh, [Replicate()])
    assert collective_bytes(counter.records)["total_bytes"] == 0
    assert collective_bytes([("mm", 4_000_000), ("wait_tensor", 400)])["total_bytes"] == 0


def test_record_is_jax_record():
    r = collective_bytes([])
    assert set(r) == {"bytes_per_kind", "counts", "total_bytes"}
    assert tuple(r["bytes_per_kind"]) == tuple(r["counts"]) == COLLECTIVES == (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
