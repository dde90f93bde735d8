"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each kernel is one ``.cu`` file under ``ops/csrc`` with a plain C
interface (shared device helpers live in ``.cuh`` headers beside it).
``nvcc`` compiles it for ``sm_90a`` into a shared library under
``kubeflow_tpu_torch/_build/``, named by a hash of the source, the headers
and the flags, so an edit rebuilds and an unchanged source loads the
library that is already there. Importing this module needs neither ``nvcc`` nor CUDA:
only :func:`load_library` does, and it raises when the compiler is missing
or the build fails, with the compiler's output in the message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
#: Where the CUDA toolkit installs nvcc by default.
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    conventional install location; raises when none exists."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from kubeflow_tpu_torch/ops/csrc at first use"
    )


def library_path(source: str, nvcc: str) -> str:
    """Where the library built from ``source`` by ``nvcc`` lives. The name
    hashes the source, every header of ``ops/csrc`` (the kernels share
    ``flash_common.cuh``) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile ``ops/csrc/<source>`` unless an identical build exists;
    returns the library path. The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside it as ``.log``."""
    nvcc = find_nvcc()
    out = library_path(source, nvcc)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) building {source}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)       # atomic: a reader never sees half a library
    return out


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``source`` once per
    process."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            _loaded[source] = lib
        return lib
