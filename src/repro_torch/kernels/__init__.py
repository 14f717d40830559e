"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  ``build`` compiles the CUDA sources at first use.

A wrapper takes its kernel's plain version only for a tensor on one of
:data:`PLAIN_DEVICES`: the CPU computes it, the meta device only
propagates its shapes (the dry run, ``launch/dryrun.py``), and neither
counts a launch.  On a CUDA tensor it launches the kernel or raises.  A
``DTensor`` never reaches either: each wrapper runs its kernel through
``local_map`` on the local shards (no shard is gathered first), and
:func:`takes_plain` refuses one."""

import sys

import torch
from torch.distributed.tensor import DTensor

#: the devices whose tensors take a kernel's plain version
PLAIN_DEVICES = ("cpu", "meta")


#: who watches the plain versions run in their kernels' places (the dry
#: run's counter, ``launch.comm_analysis.CommCounter``): the innermost is
#: called as ``watcher(fn, args, writes)`` and returns ``fn(*args)``
plain_watchers: list = []


def run_plain(fn, *args, writes=()):
    """``fn(*args)``, a kernel's plain version run in the kernel's place:
    a watcher counts it as the one launch it stands for (its inputs read,
    its outputs written, no intermediate in memory).  ``writes`` names the
    tensors among the inputs that the kernel writes in place (a tree of
    them): they count as read and written, and as made by no one.  A
    version that writes in place returns None or only tensors it makes."""
    if plain_watchers:
        return plain_watchers[-1](fn, args, writes)
    return fn(*args)


def takes_plain(t) -> bool:
    """``t`` lies on one of :data:`PLAIN_DEVICES`.  Raises ``TypeError`` on
    a ``DTensor``, whose device is its mesh's: neither the kernel nor the
    plain version takes one whole."""
    if isinstance(t, DTensor):
        raise TypeError("a DTensor reaches a kernel only as its local shard, through local_map")
    return t.device.type in PLAIN_DEVICES


def readable(t: torch.Tensor) -> bool:
    """A kernel that reads by TMA or bulk copies reads ``t`` in place: its
    last dimension is contiguous, its base pointer and the strides of its
    other dimensions longer than 1 are multiples of 16 bytes."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        return False
    if t.data_ptr() % 16:
        return False
    return all(n == 1 or st * t.element_size() % 16 == 0
               for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def needs_grad(*tensors) -> bool:
    """Grad is enabled and one of ``tensors`` (None allowed) requires it."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)

#: the kernel modules, by kernel name
KERNEL_MODULES = {
    "flash_attention": f"{__name__}.flash_attention.kernel",
    "flash_attention_bwd": f"{__name__}.flash_attention.backward",
    "stream_pack": f"{__name__}.stream_pack.kernel",
    "decode_attention": f"{__name__}.decode_attention.kernel",
    "adamw": f"{__name__}.adamw.kernel",
    "cross_entropy": f"{__name__}.cross_entropy.kernel",
    "latent_attention": f"{__name__}.latent_attention.kernel",
    "expanded_attention": f"{__name__}.expanded_attention.kernel",
    "expanded_attention_bwd": f"{__name__}.expanded_attention.backward",
    "rms_norm": f"{__name__}.rms_norm.kernel",
    "rms_norm_bwd": f"{__name__}.rms_norm.backward",
    "rotary": f"{__name__}.rotary.kernel",
}


def launch_counts() -> dict:
    """Each kernel's ``launches`` count in this process, by kernel name; a
    kernel module not imported yet is left out (it has launched nothing).
    A worker process reports these with its stats, so the parent sees the
    kernels its lanes launched."""
    out = {}
    for name, module in KERNEL_MODULES.items():
        mod = sys.modules.get(module)
        if mod is not None:
            out[name] = mod.launches
    return out
