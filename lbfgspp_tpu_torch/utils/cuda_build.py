"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each library is compiled on first use from the sources under
``lbfgspp_tpu_torch/csrc/`` into ``lbfgspp_tpu_torch/_build/``, under a
file name that carries a hash of the sources and the flags: editing a
source (or the flags) builds a new library, and an unchanged checkout
reuses the one it built before.  The sources have a plain C interface, so
the build does not include PyTorch's headers and takes seconds.

A failed build raises with the compiler's output; nothing falls back to a
slower path.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# sm_90a: the Hopper target (the "a" keeps wgmma/setmaxnreg available to
# later kernels).  -Xptxas=-v puts registers/spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict = {}
# name -> the compiler's output of the build made by this process
build_logs: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else the toolkit under
    ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str, sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def load(name: str, sources) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>`` from ``sources`` (file
    names under ``csrc/``)."""
    with _lock:
        if name in _libs:
            return _libs[name]
        path = library_path(name, sources)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # PID-unique scratch name, renamed into place atomically, so
            # two processes building at once never load a partial file.
            tmp = f"{path}.tmp.{os.getpid()}"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *(os.path.join(CSRC, s) for s in sources)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=900)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {name} (exit "
                        f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
                build_logs[name] = proc.stdout + proc.stderr
                os.replace(tmp, path)
            finally:
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(tmp)
        lib = ctypes.CDLL(path)
        _libs[name] = lib
        return lib
