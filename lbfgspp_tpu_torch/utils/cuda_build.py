"""Builds the port's native sources and loads them with ctypes.

Each library is compiled on first use from the sources under
``lbfgspp_tpu_torch/csrc/`` into ``lbfgspp_tpu_torch/_build/``, under a
file name that carries a hash of the sources, every header under
``csrc/`` and the flags: editing any of them builds a new library, and an
unchanged checkout reuses the one it built before.  :func:`load` builds
CUDA sources with ``nvcc``; :func:`load_host` and :func:`host_library`
build host C++ (the native core's host build) with ``g++``.  The sources
have a plain C interface, so no build includes PyTorch's headers.

A failed build raises with the compiler's output; nothing falls back to a
slower path.  Builds of different libraries may run at once (each under
its own lock; a process builds into a PID-unique file and renames it into
place, so processes building the same library never load a partial one).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import platform
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

# The host build of the native core takes the flags of the JAX package's
# own build of it (lbfgspp_tpu/native/__init__.py), so that its solves are
# bit-identical to that module's on the same machine.
HOST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_name_locks: dict = {}
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


def _headers():
    """Every header under ``csrc/``, as paths relative to it, sorted."""
    return sorted(os.path.relpath(os.path.join(d, f), CSRC)
                  for d, _, files in os.walk(CSRC) for f in files
                  if f.endswith((".cuh", ".h")))


def _cpu() -> str:
    """The host CPU's model and feature flags (``-march=native`` builds
    for them), or the machine type where ``/proc/cpuinfo`` is absent."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine()
    keys = ("model name", "flags")
    return "\n".join(next((ln for ln in lines if ln.startswith(k)), "")
                     for k in keys)


def library_path(name: str, sources, flags=NVCC_FLAGS,
                 suffix: str = ".so") -> str:
    """The library's file name hashes the flags, the sources and every
    header under ``csrc/`` (a source may include any of them); a host
    build's (``-march=native``) also the CPU it is built for."""
    h = hashlib.sha256(" ".join(flags).encode())
    if "-march=native" in flags:
        h.update(_cpu().encode())
    for src in [*sources, *_headers()]:
        h.update(src.encode())
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}{suffix}")


def _includes(sources):
    """``-I`` for the directory of each source under ``csrc/``."""
    dirs = sorted({os.path.dirname(os.path.join(CSRC, s)) for s in sources})
    return [f"-I{d}" for d in dirs]


def _name_lock(name: str):
    with _lock:
        return _name_locks.setdefault(name, threading.RLock())


def _build(name: str, path: str, cmd_head, sources, what: str) -> None:
    """Compile ``sources`` into ``path`` unless it exists; the command is
    ``cmd_head + [-o tmp] + -I... + sources``."""
    if os.path.exists(path):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    # PID-unique temporary name, renamed into place atomically, so two
    # processes building at once never load a partial file.
    tmp = f"{path}.tmp.{os.getpid()}"
    cmd = [*cmd_head, "-o", tmp, *_includes(sources),
           *(os.path.join(CSRC, s) for s in sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{what} failed to build {name} (exit {proc.returncode}):"
                f"\n{proc.stdout}{proc.stderr}")
        build_logs[name] = proc.stdout + proc.stderr
        os.replace(tmp, path)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)


def load(name: str, sources, flags=()) -> ctypes.CDLL:
    """Build (if needed) with nvcc, :data:`NVCC_FLAGS` and then ``flags``,
    and load ``lib<name>`` from ``sources`` (paths under ``csrc/``)."""
    with _name_lock(name):
        if name in _libs:
            return _libs[name]
        all_flags = (*NVCC_FLAGS, *flags)
        path = library_path(name, sources, all_flags)
        _build(name, path, [nvcc(), *all_flags], sources, "nvcc")
        lib = ctypes.CDLL(path)
        _libs[name] = lib
        return lib


def host_library(name: str, sources, flags=(), suffix: str = ".so") -> str:
    """Build (if needed) host C++ ``sources`` (paths under ``csrc/``) with
    g++ and :data:`HOST_FLAGS` (then ``flags``) into a shared object named
    ``lib<name>-<hash><suffix>``; returns its path."""
    with _name_lock(name):
        all_flags = (*HOST_FLAGS, *flags)
        path = library_path(name, sources, all_flags, suffix)
        _build(name, path, ["g++", *all_flags], sources, "g++")
        return path


def load_host(name: str, sources, flags=()) -> ctypes.CDLL:
    """:func:`host_library`, loaded with ctypes."""
    with _name_lock(name):
        if name not in _libs:
            _libs[name] = ctypes.CDLL(host_library(name, sources, flags))
        return _libs[name]
