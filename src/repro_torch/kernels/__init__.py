"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  ``build`` compiles the CUDA sources at first use."""

import sys

#: the kernel modules, by kernel name
KERNEL_MODULES = {
    "flash_attention": f"{__name__}.flash_attention.kernel",
    "stream_pack": f"{__name__}.stream_pack.kernel",
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
