"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each kernel is one ``.cu`` file with a plain C interface, which may include
headers beside it (``#include "name.cuh"``).  It is compiled for Hopper
(``sm_90a``) at first use into ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), as a shared library whose name carries
a hash of the source and of the local headers it includes, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.  A
missing ``nvcc`` or a failed build raises: nothing falls back to a kernel's
plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)
_mu = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``).  Raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
        "kernels cannot be built"
    )


def source_files(source: Path) -> list[Path]:
    """``source`` and the local headers it includes with ``#include
    "..."``, each resolved beside the file that includes it, recursively
    (angle-bracket includes are the toolkit's and are not followed)."""
    files: list[Path] = []
    todo = [Path(source)]
    while todo:
        path = todo.pop(0)
        if path in files or not path.is_file():
            continue
        files.append(path)
        todo += [path.parent / name for name in _INCLUDE.findall(path.read_text())]
    return files


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` goes: its stem plus the
    first 12 hex digits of the SHA-256 of :func:`source_files` (the
    source's own bytes alone when it includes no local header)."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in source_files(source)))
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:12]}.so"


def nvcc_argv(nvcc: str, source: Path, out: Path) -> list[str]:
    """The compile command for one kernel source."""
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(source),
    ]


def build(source: Path) -> Path:
    """Compile ``source`` unless its library exists; returns the library
    path.  ``nvcc``'s output, with the ``-Xptxas -v`` report of registers,
    shared memory and spills, is kept beside it as ``.log``."""
    out = library_path(source)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a per-process name, then rename: concurrent builders
    # (test workers, two engines) never load a half-written library
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        nvcc_argv(nvcc, source, tmp), capture_output=True, text=True
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} (rc {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def build_log(source: Path) -> str:
    """The compiler output kept by :func:`build` ("" if none)."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the library for ``source``, once per
    process."""
    key = str(source)
    with _mu:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(Path(source))))
            _loaded[key] = lib
        return lib
