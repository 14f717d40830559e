"""Meshes, and the card's constants for the roofline.

The JAX package's ``launch/mesh.py`` for DTensor.  The production mesh is
a description (:class:`MeshSpec`: axis names and sizes), which the dry run
maps every model onto with no process group; :func:`make_host_mesh` is a
real ``DeviceMesh`` over the processes of one host, which needs
``torch.distributed.init_process_group`` first (:func:`init_distributed`
under ``torchrun``).  Functions, not module constants, so importing
touches no device.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

# NVIDIA H100 SXM (data sheet, dense rates, at the 700 W limit): the
# tensor cores' bf16 rate, float32 outside the tensor cores, and HBM3
# bandwidth -- the roofline of chip_smoke.py and the dry run
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# the card's memory, 80 GB (data sheet): the dry run's "fits"
DEVICE_MEMORY_BYTES = 80e9
# NVLink 4 between the cards of a host: 900 GB/s a card, 450 GB/s each way
# (data sheet)
NVLINK_BYTES = 450e9


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh as the sharding rules read it: ``mesh_dim_names`` and
    ``shape`` (a ``DeviceMesh`` has both), with no devices behind it."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """JAX's production mesh: 16x16 ``("data", "model")``, or 2x16x16
    ``("pod", "data", "model")`` with ``multi_pod``."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL
    with one card a process, ``cuda:LOCAL_RANK``, for ``device="cuda"``;
    gloo for ``"cpu"``.  The backend follows the device asked for.  Returns
    this process's device."""
    import torch.distributed as dist

    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device == "cuda":
        here = torch.device("cuda", local)
        torch.cuda.set_device(here)
        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=here)
    elif device == "cpu":
        here = torch.device("cpu")
        dist.init_process_group("gloo", rank=rank, world_size=world)
    else:
        raise ValueError(f"device must be cuda or cpu, not {device!r}")
    return here


def make_host_mesh(*, model_axis: int = 1, device: str = "cuda"):
    """A ``DeviceMesh`` of shape ``(world // model_axis, model_axis)``,
    ``("data", "model")``, over this host's processes (one device each).
    Raises unless ``torch.distributed`` is initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_host_mesh needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide {world} processes")
    return init_device_mesh(device, (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def host_device_count(device: str = "cuda") -> int:
    """This host's devices of ``device``'s type: the device axis the worker
    plane (``repro_torch.dispatch.workers.device_topology``) assigns
    processes over.  The CPU is one device."""
    if device == "cpu":
        return 1
    return torch.cuda.device_count()
