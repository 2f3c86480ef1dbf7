"""The native L-BFGS / L-BFGS-B core, on the card and on the host.

The port's counterpart of ``lbfgspp_tpu.native``, with its names.  One C++
source (``csrc/native/core.h``, ``lbfgsb.h``: the JAX package's
``core.cpp`` and ``lbfgsb.cpp`` with every function ``__host__
__device__`` and templated on an execution policy, every vector a slice of
one workspace and the objective a functor) is built twice:

* for the card (``csrc/native/batch.cu``, nvcc, the ``Warp`` policy): one
  warp per instance, a builtin objective; :func:`native_lbfgs_batch` and
  :func:`native_lbfgsb_batch` launch it, ``W`` warps a block as the card's
  shared memory and occupancy allow (:func:`plan`).  Each warp's workspace
  is its slice of the block's shared memory when the block's ``W`` fit the
  card's limit (x copied in and out), else a row of a ``[B, stride]``
  buffer the wrapper allocates in device memory;
* for the host (``csrc/native/host.cpp``, g++ with the JAX module's flags):
  under the ``Serial`` policy, bit-identical to ``lbfgspp_tpu.native`` on
  the same machine, the C ABI of its ``libnative.so`` and the threaded
  batches through ctypes, and a CPython binding
  (``csrc/native/fastcall.cpp``) for builtin single solves; and under the
  ``Lanes`` policy, the card's arithmetic on one thread per solve
  (:func:`_lanes_batch`, :func:`_lanes_b_batch`: not an entry point, the
  tests' and ``chip_smoke.py``'s witness).

The card's warp sums each reduction as 32 strided partials and a butterfly,
where ``lbfgspp_tpu.native`` sums in index order, and both compilers
contract multiply-adds into FMAs, each in its own places, so the card's and
the JAX-identical host solves part in the last bits.  The kernels'
wrappers take ``contract=False`` for the builds with no contraction (nvcc
``-fmad=false``, g++ ``-ffp-contract=off``): the card's is bit for bit the
``Lanes`` host build's without contraction.

Where a call runs:

=========================================  ==========================  =============================
call                                       ``device="cuda"`` (default)  ``device="cpu"``
=========================================  ==========================  =============================
``minimize(builtin, ...)``                 the kernel at B = 1          the host build (fastcall)
``minimize_b(builtin, ...)``               the box kernel at B = 1      the host build (fastcall)
``minimize_batch(builtin, x0s, ...)``      the kernel at B              the host build, threaded
``minimize_b_batch(builtin, x0s, ...)``    the box kernel at B          the host build, threaded
``minimize`` / ``minimize_b``, a callable  ``ValueError``               the host build (ctypes)
=========================================  ==========================  =============================

While a ``torch.profiler`` records (or inside :func:`probing`), a card
launch of either kernel takes its probed build: the same solve, whose
lane 0 also clocks each instance's phases (the objective's evaluations,
the line search without them, the new direction, the box solve's Cauchy
points and subspace steps inside it, and the whole slot in SM cycles and
``%globaltimer`` nanoseconds).  Each such launch leaves one summary, read
by :func:`probe_records`.  The card path of both kernels' wrappers and of
:func:`minimize_batch` and :func:`minimize_b_batch`, from the call to the
C launch's return, is the profiler span ``lbfgspp.native.launch``.

A Python callable ``f(x) -> (fx, grad)`` gets an f64 CPU tensor; it needs
``device="cpu"`` (for an objective that runs on the card, use
:func:`lbfgspp_tpu_torch.minimize`).  Results are f64 tensors (counts
int32) on the device the solve ran on; ``x0`` is never changed.  The
libraries build on first use into ``lbfgspp_tpu_torch/_build``; a failed
build raises with the compiler's output, and nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib.util
import sysconfig
import time
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..params import LBFGSBParams, LBFGSParams
from ..types import resolve_device
from ..utils import cuda_build

Tensor = torch.Tensor

BUILTIN_OBJECTIVES = {"rosenbrock": 0, "quadratic": 1}

LS_KINDS = {"backtracking": 0, "bracketing": 1, "nocedalwright": 2,
            "morethuente": 3}

_HOST_SOURCES = ["native/host.cpp"]
# the builds with no multiply-add contraction (``contract=False``)
_NO_CONTRACT = {"cuda": ("-fmad=false",), "cpu": ("-ffp-contract=off",)}
_FAST_SOURCES = ["native/fastcall.cpp", "native/host.cpp"]
_CUDA_SOURCES = ["native/batch.cu"]

_OBJ_CB = ctypes.CFUNCTYPE(
    ctypes.c_double, ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p)
_NULL_CB = _OBJ_CB()


class _CParams(ctypes.Structure):
    """``Params`` of csrc/native/core.h, field for field."""
    _fields_ = [
        ("m", ctypes.c_int),
        ("epsilon", ctypes.c_double),
        ("epsilon_rel", ctypes.c_double),
        ("past", ctypes.c_int),
        ("delta", ctypes.c_double),
        ("max_iterations", ctypes.c_int),
        ("linesearch", ctypes.c_int),
        ("max_linesearch", ctypes.c_int),
        ("min_step", ctypes.c_double),
        ("max_step", ctypes.c_double),
        ("ftol", ctypes.c_double),
        ("wolfe", ctypes.c_double),
    ]


class _CParamsB(ctypes.Structure):
    """``ParamsB`` of csrc/native/lbfgsb.h, field for field."""
    _fields_ = [
        ("m", ctypes.c_int),
        ("epsilon", ctypes.c_double),
        ("epsilon_rel", ctypes.c_double),
        ("past", ctypes.c_int),
        ("delta", ctypes.c_double),
        ("max_iterations", ctypes.c_int),
        ("max_submin", ctypes.c_int),
        ("max_linesearch", ctypes.c_int),
        ("min_step", ctypes.c_double),
        ("max_step", ctypes.c_double),
        ("ftol", ctypes.c_double),
        ("wolfe", ctypes.c_double),
    ]


@functools.lru_cache(maxsize=64)
def _cparams(params: LBFGSParams) -> _CParams:
    """The ctypes struct of a (frozen, hashable) params object, built once:
    its construction costs ~10 us, a share of a small solve."""
    return _CParams(**{f: getattr(params, f) for f, _ in _CParams._fields_})


@functools.lru_cache(maxsize=64)
def _cparams_b(params: LBFGSBParams) -> _CParamsB:
    return _CParamsB(**{f: getattr(params, f) for f, _ in _CParamsB._fields_})


class NativeResult(NamedTuple):
    x: Tensor        # [n] f64
    fx: Tensor       # f64
    gnorm: Tensor    # f64 (projected-gradient inf-norm for minimize_b)
    niter: Tensor    # int32
    nfev: Tensor     # int32
    status: Tensor   # int32, a Status value


class NativeBatchResult(NamedTuple):
    x: Tensor        # [B, n] f64 solutions
    fx: Tensor       # [B] f64
    niter: Tensor    # [B] int32
    nfev: Tensor     # [B] int32
    status: Tensor   # [B] int32


class _Out(NamedTuple):
    fx: Tensor
    gnorm: Tensor
    niter: Tensor
    nfev: Tensor
    status: Tensor


# ---------------------------------------------------------------------------
# The libraries
# ---------------------------------------------------------------------------

def _host(contract: bool = True) -> ctypes.CDLL:
    """The host build, loaded with ctypes and typed."""
    lib = cuda_build.load_host(
        "native_host" if contract else "native_host_exact", _HOST_SOURCES,
        () if contract else _NO_CONTRACT["cpu"])
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lbfgspp_native_minimize.argtypes = [
            _OBJ_CB, p, ctypes.c_int, ctypes.c_int, p, p, ctypes.c_int,
            p, p, p, p]
        lib.lbfgspp_native_minimize.restype = ctypes.c_int
        for fn in (lib.lbfgspp_native_minimize_b,
                   lib.lbfgspp_native_lanes_minimize_b):
            fn.argtypes = [_OBJ_CB, p, i, i, p, p, p, p, p, p, p, p]
            fn.restype = i
        for fn in (lib.lbfgspp_native_minimize_batch,
                   lib.lbfgspp_native_lanes_batch):
            fn.argtypes = [i, i, ll, p, p, i, p, p, p, p, p, i]
            fn.restype = None
        for fn in (lib.lbfgspp_native_minimize_b_batch,
                   lib.lbfgspp_native_lanes_b_batch):
            fn.argtypes = [i, i, ll, p, p, p, p, p, p, p, p, p, i]
            fn.restype = None
        for fn in (lib.lbfgspp_native_workspace,
                   lib.lbfgspp_native_workspace_b):
            fn.argtypes = [i] * 3
            fn.restype = ll
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _fast():
    """The CPython binding (fastcall.cpp with host.cpp), built and imported
    once."""
    path = cuda_build.host_library(
        "native_fastcall", _FAST_SOURCES,
        flags=(f"-I{sysconfig.get_paths()['include']}",),
        suffix=sysconfig.get_config_var("EXT_SUFFIX") or ".so")
    spec = importlib.util.spec_from_file_location("_lbfgspp_torch_fastcall",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_lib(contract: bool = True) -> ctypes.CDLL:
    """The card build (csrc/native/batch.cu), loaded and typed."""
    return _typed_device(cuda_build.load(
        "native_batch" if contract else "native_batch_exact", _CUDA_SOURCES,
        () if contract else _NO_CONTRACT["cuda"]))


def _typed_device(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A build of csrc/native/batch.cu with its C functions typed."""
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lbfgspp_native_lbfgs_batch.argtypes = [
            i, ll, i, p, p, i, p, ll, i, p, p, p, p, p, p]
        lib.lbfgspp_native_lbfgs_batch.restype = i
        lib.lbfgspp_native_lbfgs_batch_probed.argtypes = [
            i, ll, i, p, p, i, p, ll, i, p, p, p, p, p, p, p]
        lib.lbfgspp_native_lbfgs_batch_probed.restype = i
        lib.lbfgspp_native_lbfgsb_batch.argtypes = [
            i, ll, i, p, p, p, p, p, ll, i, p, p, p, p, p, p]
        lib.lbfgspp_native_lbfgsb_batch.restype = i
        lib.lbfgspp_native_lbfgsb_batch_probed.argtypes = [
            i, ll, i, p, p, p, p, p, ll, i, p, p, p, p, p, p, p]
        lib.lbfgspp_native_lbfgsb_batch_probed.restype = i
        lib.lbfgspp_native_plan.argtypes = [i, i, i, i, p, p, p]
        lib.lbfgspp_native_plan.restype = i
        for fn in (lib.lbfgspp_native_workspace,
                   lib.lbfgspp_native_workspace_b):
            fn.argtypes = [i] * 3
            fn.restype = ll
        lib.lbfgspp_native_cuda_error_string.argtypes = [i]
        lib.lbfgspp_native_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def build(device="cuda", contract: bool = True) -> None:
    """Build and load the libraries a solve on ``device`` uses now (they
    are otherwise built on first use): the card's, or the host's two
    (``contract=False``: the card's or the host's build without
    multiply-add contraction)."""
    if torch.device(device).type == "cuda":
        _device_lib(contract)
    elif contract:
        _host()
        _fast()
    else:
        _host(False)


def available() -> bool:
    """True when the host build compiles and loads here (its error is then
    :func:`build_error`'s None)."""
    return build_error() is None


def build_error() -> Optional[str]:
    """The host build's compiler output if it fails, else None (a failed
    build is tried again on the next call)."""
    try:
        _host()
    except RuntimeError as e:
        return str(e)
    return None


def fast_error() -> Optional[str]:
    """The CPython binding's build or import error, else None."""
    try:
        _fast()
    except (RuntimeError, ImportError) as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------

def _builtin_id(fun: str, n: int) -> int:
    if fun not in BUILTIN_OBJECTIVES:
        raise ValueError(f"unknown builtin objective {fun!r}; available: "
                         f"{sorted(BUILTIN_OBJECTIVES)}")
    if fun == "rosenbrock" and n % 2:
        raise ValueError(f"the builtin rosenbrock pairs coordinates: n must "
                         f"be even, got {n}")
    return BUILTIN_OBJECTIVES[fun]


def _ls_kind(line_search: str) -> int:
    if line_search not in LS_KINDS:
        raise ValueError(f"unknown line search {line_search!r}; available: "
                         f"{sorted(LS_KINDS)}")
    return LS_KINDS[line_search]


def _where(fun, device) -> torch.device:
    """The solve's device; a callable runs on the host only."""
    if not isinstance(fun, str) and \
            torch.device(device if device is not None else "cuda").type \
            != "cpu":
        raise ValueError(
            "a Python callable objective runs on the host build only: pass "
            "device='cpu', or use lbfgspp_tpu_torch.minimize for an "
            "objective that runs on the card")
    return resolve_device(device)


def _f64(t, device, shape=None) -> Tensor:
    """A fresh contiguous f64 copy of ``t`` on ``device`` (broadcast to
    ``shape``): the solve writes into it, never into the caller's."""
    t = torch.as_tensor(t, dtype=torch.float64, device=device)
    if shape is not None:
        t = t.broadcast_to(shape)
    return t.clone(memory_format=torch.contiguous_format)


def _scalars(device, fx, gnorm, niter, nfev, status) -> _Out:
    f64, i32 = torch.float64, torch.int32
    return _Out(torch.tensor(fx, dtype=f64, device=device),
                torch.tensor(gnorm, dtype=f64, device=device),
                torch.tensor(niter, dtype=i32, device=device),
                torch.tensor(nfev, dtype=i32, device=device),
                torch.tensor(status, dtype=i32, device=device))


def _outputs(batch: int, device) -> _Out:
    f64, i32 = torch.float64, torch.int32
    return _Out(*(torch.empty(batch, dtype=t, device=device)
                  for t in (f64, f64, i32, i32, i32)))


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _launch_check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.lbfgspp_native_cuda_error_string(err).decode()}")


def _check_rows(xs: Tensor, what: str, *others) -> None:
    for name, t in (("x", xs),) + others:
        if t.dtype != torch.float64 or t.dim() != 2 or \
                not t.is_contiguous() or t.shape != xs.shape or \
                t.device != xs.device:
            raise ValueError(f"{what}: {name} must be a contiguous f64 "
                             f"[B, n] tensor like x on {xs.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _threads(threads: Optional[int], device) -> int:
    if threads is not None and device.type != "cpu":
        raise ValueError("threads= is the host build's; the card runs one "
                         "warp per instance")
    return -1 if threads is None else int(threads)


class Plan(NamedTuple):
    warps: int           # instances (warps) a block
    blocks_per_sm: int   # blocks resident on an SM
    shared_bytes: int    # dynamic shared memory a block; 0: device memory

    @property
    def placement(self) -> str:
        return "shared" if self.shared_bytes else "global"


@functools.lru_cache(maxsize=None)
def _plan(lib: ctypes.CDLL, kernel: int, n: int, m: int, past: int,
          device: int) -> Plan:
    vals = (ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong())
    with torch.cuda.device(device):
        err = lib.lbfgspp_native_plan(kernel, n, m, past,
                                      *(ctypes.byref(v) for v in vals))
    _launch_check(lib, err, "the native kernels' plan")
    return Plan(*(v.value for v in vals))


def plan(box: bool, n: int, params, device="cuda",
         lib: Optional[ctypes.CDLL] = None, probed: bool = False) -> Plan:
    """How the card runs ``native_lbfgsb_batch`` (``box``) or
    ``native_lbfgs_batch`` (``probed``: its probed build, planned on its
    own) at ``n`` and ``params`` (its ``m`` and ``past``): warps per
    block, blocks resident per SM and the block's shared memory (0 when
    the workspace is in device memory).  ``lib``: a build of its own
    (``tools/native_study.py``'s register caps)."""
    dev = torch.device(device)
    # batch.cu's kernel ids: 0, 1 the default kernels, 2, 3 the probed
    return _plan(lib or _device_lib(), int(box) + 2 * int(probed), n,
                 params.m, params.past,
                 torch.cuda.current_device() if dev.index is None
                 else dev.index)


def _launch(lib: ctypes.CDLL, box: bool, bid: int, xs: Tensor, params,
            ls: int, out: _Out, lb: Optional[Tensor] = None,
            ub: Optional[Tensor] = None, warps: Optional[int] = None,
            probe: Optional[Tensor] = None) -> Plan:
    """Launch a build's native kernel on ``xs``'s device with the plan's
    warps per block (or ``warps``) and its workspace placement, its probed
    build when given ``probe`` (int64 ``[B, 6]``, :data:`PROBE_FIELDS`;
    ``box``: ``[B, 8]``, :data:`PROBE_FIELDS_B`); raises if the card
    refuses the launch.  Returns the plan."""
    batch, n = xs.shape
    pl = plan(box, n, params, xs.device, lib, probed=probe is not None)
    ws, stride = None, 0
    if not pl.shared_bytes:
        size = (lib.lbfgspp_native_workspace_b if box
                else lib.lbfgspp_native_workspace)(n, params.m, params.past)
        stride = -(-size // 8)
        ws = torch.empty(batch, stride, dtype=torch.float64,
                         device=xs.device)
    w = pl.warps if warps is None else warps
    wsp = None if ws is None else ws.data_ptr()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        if box:
            args = (bid, batch, n, xs.data_ptr(), lb.data_ptr(),
                    ub.data_ptr(), ctypes.addressof(_cparams_b(params)), wsp,
                    stride, w, *(t.data_ptr() for t in out), stream)
            err = lib.lbfgspp_native_lbfgsb_batch(*args) if probe is None \
                else lib.lbfgspp_native_lbfgsb_batch_probed(
                    *args, probe.data_ptr())
        else:
            args = (bid, batch, n, xs.data_ptr(),
                    ctypes.addressof(_cparams(params)), ls, wsp, stride, w,
                    *(t.data_ptr() for t in out), stream)
            err = lib.lbfgspp_native_lbfgs_batch(*args) if probe is None \
                else lib.lbfgspp_native_lbfgs_batch_probed(
                    *args, probe.data_ptr())
    _launch_check(lib, err, "native_lbfgsb_batch" if box
                  else "native_lbfgs_batch")
    return pl


def native_lbfgs_batch(fun: str, xs: Tensor, params: LBFGSParams,
                       line_search: str = "nocedalwright",
                       threads: Optional[int] = None,
                       contract: bool = True) -> _Out:
    """L-BFGS on ``xs [B, n]`` (contiguous f64), solved in place, each row
    an instance of the builtin ``fun``; returns ``fx, gnorm, niter, nfev,
    status [B]``.

    A CUDA tensor launches ``native_lbfgs_batch`` (csrc/native/batch.cu; one
    warp per instance, its workspace in shared memory when :func:`plan`
    finds room; probed while :func:`is_probing`), counted in
    ``native_lbfgs_batch.launches``; a CPU tensor
    takes the host build's threaded batch over ``threads`` OS threads
    (default: every hardware thread), bit-identical to
    ``lbfgspp_tpu.native``.  ``contract=False`` takes the builds without
    multiply-add contraction: the card's is then bit for bit
    :func:`_lanes_batch`'s without contraction."""
    if xs.device.type == "cuda":
        return _card_batch(lambda: xs, fun, params, line_search, threads,
                           contract)[1]
    _check_rows(xs, "native_lbfgs_batch")
    batch, n = xs.shape
    bid, ls = _builtin_id(fun, n), _ls_kind(line_search)
    nthreads = _threads(threads, xs.device)
    if xs.device.type != "cpu":
        raise ValueError(f"native_lbfgs_batch: no kernel for {xs.device}")
    out = _outputs(batch, xs.device)
    _host(contract).lbfgspp_native_minimize_batch(
        bid, n, batch, xs.data_ptr(), ctypes.addressof(_cparams(params)),
        ls, *(t.data_ptr() for t in out), nthreads)
    return out


def _card_batch(rows: Callable[[], Tensor], fun: str, params,
                line_search: Optional[str], threads: Optional[int],
                contract: bool, bounds: Optional[Callable] = None) -> tuple:
    """:func:`native_lbfgs_batch` on the card, or with ``bounds``
    :func:`native_lbfgsb_batch`, on the rows ``rows()`` makes and the boxes
    ``bounds(rows) -> (lb, ub)`` makes: the span :data:`LAUNCH_SPAN` from
    the call to the C launch's return, then, when the launch was probed,
    its summary (enqueued after the kernel, outside the span).  Returns
    ``(xs, outputs)``."""
    box = bounds is not None
    kernel = native_lbfgsb_batch if box else native_lbfgs_batch
    t0 = time.perf_counter_ns()
    with torch.profiler.record_function(LAUNCH_SPAN):
        xs = rows()
        boxes = dict(zip(("lb", "ub"), bounds(xs))) if box else {}
        _check_rows(xs, kernel.__name__, *boxes.items())
        batch, n = xs.shape
        bid = _builtin_id(fun, n)
        ls = 0 if box else _ls_kind(line_search)
        _threads(threads, xs.device)
        out = _outputs(batch, xs.device)
        probe = _probe_buffer(batch, xs.device, box) if is_probing() \
            else None
        pl = _launch(_device_lib(contract), box, bid, xs, params, ls, out,
                     probe=probe, **boxes)
        kernel.launches += 1
    if probe is not None:
        _keep_probe(probe, pl, xs.device, time.perf_counter_ns() - t0, box)
    return xs, out


def native_lbfgsb_batch(fun: str, xs: Tensor, lb: Tensor, ub: Tensor,
                        params: LBFGSBParams, threads: Optional[int] = None,
                        contract: bool = True) -> _Out:
    """L-BFGS-B on ``xs [B, n]`` (contiguous f64) over the per-instance
    boxes ``lb, ub [B, n]``, solved in place, each row an instance of the
    builtin ``fun``; returns ``fx, gnorm`` (projected-gradient inf-norm)
    ``, niter, nfev, status [B]``.

    A CUDA tensor launches ``native_lbfgsb_batch`` (csrc/native/batch.cu;
    one warp per instance; probed while :func:`is_probing`), counted in
    ``native_lbfgsb_batch.launches``; a CPU tensor takes the host build's
    threaded batch, as :func:`native_lbfgs_batch` does, and ``contract``
    is its (:func:`_lanes_b_batch` is the card's witness)."""
    if xs.device.type == "cuda":
        return _card_batch(lambda: xs, fun, params, None, threads, contract,
                           lambda _: (lb, ub))[1]
    _check_rows(xs, "native_lbfgsb_batch", ("lb", lb), ("ub", ub))
    batch, n = xs.shape
    bid = _builtin_id(fun, n)
    nthreads = _threads(threads, xs.device)
    if xs.device.type != "cpu":
        raise ValueError(f"native_lbfgsb_batch: no kernel for {xs.device}")
    out = _outputs(batch, xs.device)
    _host(contract).lbfgspp_native_minimize_b_batch(
        bid, n, batch, xs.data_ptr(), lb.data_ptr(), ub.data_ptr(),
        ctypes.addressof(_cparams_b(params)), *(t.data_ptr() for t in out),
        nthreads)
    return out


def _lanes_batch(fun: str, xs: Tensor, params: LBFGSParams,
                 line_search: str = "nocedalwright",
                 contract: bool = False) -> _Out:
    """The kernel's arithmetic on the host: :func:`native_lbfgs_batch` on a
    CPU ``xs`` under the ``Lanes`` policy (each reduction as the card's 32
    strided partials and butterfly), every hardware thread.  Without
    contraction (the default here) it is the card's ``contract=False``
    build bit for bit.  For the tests and ``chip_smoke.py``."""
    _check_rows(xs, "_lanes_batch")
    batch, n = xs.shape
    out = _outputs(batch, "cpu")
    _host(contract).lbfgspp_native_lanes_batch(
        _builtin_id(fun, n), n, batch, xs.data_ptr(),
        ctypes.addressof(_cparams(params)), _ls_kind(line_search),
        *(t.data_ptr() for t in out), -1)
    return out


def _lanes_b_batch(fun: str, xs: Tensor, lb: Tensor, ub: Tensor,
                   params: LBFGSBParams, contract: bool = False) -> _Out:
    """:func:`_lanes_batch` for :func:`native_lbfgsb_batch`."""
    _check_rows(xs, "_lanes_b_batch", ("lb", lb), ("ub", ub))
    batch, n = xs.shape
    out = _outputs(batch, "cpu")
    _host(contract).lbfgspp_native_lanes_b_batch(
        _builtin_id(fun, n), n, batch, xs.data_ptr(), lb.data_ptr(),
        ub.data_ptr(), ctypes.addressof(_cparams_b(params)),
        *(t.data_ptr() for t in out), -1)
    return out


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------

# the host span of a card launch of either kernel
LAUNCH_SPAN = "lbfgspp.native.launch"
# the probed kernel's record of an instance (csrc/native/batch.cu): its
# %globaltimer at the entry into its warp slot and after its outputs, then
# SM cycles: the whole slot, the objective's evaluations, the line search
# without them, the new direction
PROBE_FIELDS = ("start_ns", "end_ns", "total", "eval", "search",
                "direction")
# the probed native_lbfgsb_batch's record: those, then the SM cycles of the
# Cauchy points and of the subspace steps (both inside the directions')
PROBE_FIELDS_B = PROBE_FIELDS + ("cauchy", "subspace")
# a probed launch's summary (probe_records): its batch, the card's resident
# warp slots under the probed plan (SMs x blocks an SM x warps a block),
# the launch's span (last end_ns - first start_ns), the sum of end_ns -
# start_ns, the sums of the cycle fields, and the host span's nanoseconds;
# besides, ``kernel`` ("lbfgs" or "lbfgsb")
SUMMARY_FIELDS = ("batch", "slots", "span_ns", "busy_ns", "total", "eval",
                  "search", "direction", "host_ns")
# a probed box launch's: the Cauchy points' and subspace steps' cycles too
SUMMARY_FIELDS_B = SUMMARY_FIELDS[:-1] + ("cauchy", "subspace", "host_ns")

_PROBING: list = [None]     # probing()'s setting; None: follow the profiler
_RECORDS: list = []         # (device summary, batch, slots, host_ns, box)
_PROBE_BUFFERS: dict = {}   # (device, box) -> the last launch's records


@contextlib.contextmanager
def probing(on: bool = True):
    """Within the block, card launches of the native kernels take their
    probed builds (``on``) or the default ones, whether a profiler records
    or not."""
    prev = _PROBING[0]
    _PROBING[0] = bool(on)
    try:
        yield
    finally:
        _PROBING[0] = prev


def is_probing() -> bool:
    """Whether a card launch now takes the probed kernel: the setting of
    the innermost :func:`probing`, else whether a ``torch.profiler``
    records."""
    on = _PROBING[0]
    return torch.autograd._profiler_enabled() if on is None else on


def _probe_buffer(batch: int, device, box: bool = False) -> Tensor:
    """The records' buffer of a launch of a kernel (``box``): the device's
    last one for that kernel while the batch size holds (the launches of a
    stream reuse it in turn, each reduced before the next writes it), else
    a new one."""
    key = (str(device), box)
    buf = _PROBE_BUFFERS.get(key)
    if buf is None or buf.shape[0] != batch:
        buf = _PROBE_BUFFERS[key] = torch.empty(
            batch, len(PROBE_FIELDS_B if box else PROBE_FIELDS),
            dtype=torch.int64, device=device)
    return buf


def probe_summary(probe: Tensor) -> Tensor:
    """The records ``probe [B, 6]`` (or a box launch's ``[B, 8]``) reduced
    on their device, with no sync: int64 ``[span_ns, busy_ns, total, eval,
    search, direction]`` (:data:`SUMMARY_FIELDS` 2-7; then ``cauchy,
    subspace``)."""
    start, end = probe[:, 0], probe[:, 1]
    return torch.cat([(end.max() - start.min()).reshape(1),
                      (end - start).sum().reshape(1), probe[:, 2:].sum(0)])


def _keep_probe(probe: Tensor, pl: Plan, device, host_ns: int,
                box: bool = False) -> None:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    _RECORDS.append((probe_summary(probe), probe.shape[0],
                     sms * pl.blocks_per_sm * pl.warps, host_ns, box))


def probe_records() -> list:
    """Each probed launch's summary since :func:`reset_counts`, oldest
    first, as a dict of :data:`SUMMARY_FIELDS` (a box launch's:
    :data:`SUMMARY_FIELDS_B`; cycles are SM cycles, the rest nanoseconds)
    and its ``kernel``, ``"lbfgs"`` or ``"lbfgsb"``; waits once for the
    card."""
    if not _RECORDS:
        return []
    dev = _RECORDS[0][0].device
    flat = torch.cat([r[0].to(dev) for r in _RECORDS]).tolist()
    out, at = [], 0
    for summary, b, slots, host, box in _RECORDS:
        row, at = flat[at:at + len(summary)], at + len(summary)
        out.append(dict(zip(SUMMARY_FIELDS_B if box else SUMMARY_FIELDS,
                            (b, slots, *row, host)),
                        kernel="lbfgsb" if box else "lbfgs"))
    return out


def reset_counts() -> None:
    """Set both kernels' launch counts to zero and drop the probe's
    summaries."""
    native_lbfgs_batch.launches = 0
    native_lbfgsb_batch.launches = 0
    _RECORDS.clear()


reset_counts()


# ---------------------------------------------------------------------------
# The host build through ctypes (Python callables; builtins for the tests
# that hold the two bindings against each other)
# ---------------------------------------------------------------------------

def _bridge(fun: Callable, errors: list):
    """``fun(x: f64 CPU tensor) -> (fx, grad)`` as a C callback.  An
    exception inside it is kept (the callback returns NaN, which ends the
    search) and raised when the solve returns."""
    def call(xp, gp, nn, _user):
        try:
            x = torch.from_numpy(np.ctypeslib.as_array(xp, shape=(nn,))
                                 .copy())
            fx, grad = fun(x)
            g = torch.as_tensor(grad, dtype=torch.float64).detach()
            np.ctypeslib.as_array(gp, shape=(nn,))[:] = \
                g.reshape(nn).cpu().numpy()
            return float(fx)
        except Exception as e:      # re-raised after the solve returns
            errors.append(e)
            return float("nan")
    return _OBJ_CB(call)


def _ctypes_solve(fn, fun, *args) -> tuple:
    """``fn(cb, None, builtin_id, ..., outputs)`` for a builtin name or a
    callable; returns ``(status, fx, gnorm, niter, nfev)``."""
    errors: list = []
    if isinstance(fun, str):
        cb, bid = _NULL_CB, BUILTIN_OBJECTIVES[fun]
    else:
        cb, bid = _bridge(fun, errors), -1
    outd = (ctypes.c_double * 2)()
    outi = (ctypes.c_int * 2)()
    oda, oia = ctypes.addressof(outd), ctypes.addressof(outi)
    status = fn(cb, None, bid, *args, oda, oda + 8, oia, oia + 4)
    if errors:
        raise errors[0]
    return status, outd[0], outd[1], outi[0], outi[1]


def _ctypes_minimize(fun, x: Tensor, params: LBFGSParams,
                     line_search: str) -> tuple:
    return _ctypes_solve(_host().lbfgspp_native_minimize, fun, x.numel(),
                         x.data_ptr(), ctypes.addressof(_cparams(params)),
                         _ls_kind(line_search))


def _ctypes_minimize_b(fun, x: Tensor, lb: Tensor, ub: Tensor,
                       params: LBFGSBParams, lanes: bool = False) -> tuple:
    """The host's L-BFGS-B solve of ``x`` in place; ``lanes``: under the
    Lanes policy, built without contraction (the tests' witness)."""
    fn = _host(False).lbfgspp_native_lanes_minimize_b if lanes \
        else _host().lbfgspp_native_minimize_b
    return _ctypes_solve(fn, fun, x.numel(), x.data_ptr(), lb.data_ptr(),
                         ub.data_ptr(), ctypes.addressof(_cparams_b(params)))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def minimize(fun: Union[str, Callable],
             x0,
             params: LBFGSParams = LBFGSParams(),
             line_search: str = "nocedalwright",
             device=None) -> NativeResult:
    """Native L-BFGS solve of ``fun`` from ``x0 [n]``.

    ``fun`` is a builtin name (:data:`BUILTIN_OBJECTIVES`) or, with
    ``device="cpu"``, a callable ``f(x) -> (fx, grad)``.  Semantics mirror
    :func:`lbfgspp_tpu_torch.minimize` (same defaults, status codes and
    iteration counts)."""
    dev = _where(fun, device)
    x = _f64(x0, dev)
    if x.dim() != 1:
        raise ValueError(f"x0 must be [n], got {tuple(x.shape)}")
    if isinstance(fun, str):
        bid = _builtin_id(fun, x.numel())
        if dev.type == "cuda":
            out = native_lbfgs_batch(fun, x[None], params, line_search)
            return NativeResult(x, *(t[0] for t in out))
        status, fx, gnorm, niter, nfev = _fast().minimize(
            bid, x.numpy(), ctypes.addressof(_cparams(params)),
            _ls_kind(line_search))
    else:
        status, fx, gnorm, niter, nfev = _ctypes_minimize(fun, x, params,
                                                          line_search)
    return NativeResult(x, *_scalars(dev, fx, gnorm, niter, nfev, status))


def minimize_b(fun: Union[str, Callable],
               x0,
               lb,
               ub,
               params: Optional[LBFGSBParams] = None,
               device=None) -> NativeResult:
    """Native L-BFGS-B solve over the box ``[lb, ub]``.

    Semantics mirror :func:`lbfgspp_tpu_torch.minimize_b` (More-Thuente,
    same defaults and status codes); ``gnorm`` in the result is the
    projected-gradient infinity norm.  ``lb``/``ub`` entries may be
    ``+/-inf``; ``lb[i] == ub[i]`` pins a variable."""
    if params is None:
        params = LBFGSBParams()
    dev = _where(fun, device)
    x = _f64(x0, dev)
    if x.dim() != 1:
        raise ValueError(f"x0 must be [n], got {tuple(x.shape)}")
    lo, hi = _f64(lb, dev, x.shape), _f64(ub, dev, x.shape)
    if isinstance(fun, str):
        bid = _builtin_id(fun, x.numel())
        if dev.type == "cuda":
            out = native_lbfgsb_batch(fun, x[None], lo[None], hi[None],
                                      params)
            return NativeResult(x, *(t[0] for t in out))
        status, fx, pg, niter, nfev = _fast().minimize_b(
            bid, x.numpy(), lo.numpy(), hi.numpy(),
            ctypes.addressof(_cparams_b(params)))
    else:
        status, fx, pg, niter, nfev = _ctypes_minimize_b(fun, x, lo, hi,
                                                         params)
    return NativeResult(x, *_scalars(dev, fx, pg, niter, nfev, status))


def minimize_batch(fun: str,
                   x0s,
                   params: LBFGSParams = LBFGSParams(),
                   line_search: str = "nocedalwright",
                   threads: Optional[int] = None,
                   device=None) -> NativeBatchResult:
    """Multistart batch over a builtin objective: ``x0s [B, n]``, each row
    an independent solve, equal to its :func:`minimize`.

    On the card one launch solves the batch, a warp per instance; on the
    host the solves fan out over ``threads`` OS threads (default: every
    hardware thread) with the interpreter lock released.  Python
    callables are refused (their callbacks would serialize on the lock):
    use :func:`lbfgspp_tpu_torch.minimize_batched`."""
    if not isinstance(fun, str):
        raise TypeError("minimize_batch supports builtin objectives only "
                        "(Python callbacks serialize on the interpreter "
                        "lock); use lbfgspp_tpu_torch.minimize_batched")
    dev = resolve_device(device)

    def rows():
        xs = _f64(x0s, dev)
        if xs.dim() != 2:
            raise ValueError("x0s must be [batch, n]")
        return xs

    if dev.type == "cuda":
        xs, out = _card_batch(rows, fun, params, line_search, threads, True)
    else:
        xs = rows()
        out = native_lbfgs_batch(fun, xs, params, line_search, threads)
    return NativeBatchResult(xs, out.fx, out.niter, out.nfev, out.status)


def minimize_b_batch(fun: str,
                     x0s,
                     lb,
                     ub,
                     params: LBFGSBParams = LBFGSBParams(),
                     threads: Optional[int] = None,
                     device=None) -> NativeBatchResult:
    """Box-constrained multistart batch over a builtin objective: ``x0s
    [B, n]``, each row an independent solve over its box, equal to its
    :func:`minimize_b`.  ``lb``, ``ub``: ``[n]`` (every row's box) or ``[B,
    n]``; entries may be ``+/-inf``, and ``lb[i] == ub[i]`` pins a
    coordinate.

    On the card one launch of ``native_lbfgsb_batch`` solves the batch, a
    warp per instance; on the host the solves fan out over ``threads`` OS
    threads as in :func:`minimize_batch`, which also refuses callables."""
    if not isinstance(fun, str):
        raise TypeError("minimize_b_batch supports builtin objectives only "
                        "(Python callbacks serialize on the interpreter "
                        "lock); use lbfgspp_tpu_torch.minimize_b_batched")
    dev = resolve_device(device)

    def rows():
        xs = _f64(x0s, dev)
        if xs.dim() != 2:
            raise ValueError("x0s must be [batch, n]")
        return xs

    def bounds(xs):
        return _f64(lb, dev, xs.shape), _f64(ub, dev, xs.shape)

    if dev.type == "cuda":
        xs, out = _card_batch(rows, fun, params, None, threads, True, bounds)
    else:
        xs = rows()
        out = native_lbfgsb_batch(fun, xs, *bounds(xs), params, threads)
    return NativeBatchResult(xs, out.fx, out.niter, out.nfev, out.status)


__all__ = ["BUILTIN_OBJECTIVES", "LAUNCH_SPAN", "LS_KINDS", "NativeResult",
           "NativeBatchResult", "PROBE_FIELDS", "PROBE_FIELDS_B", "Plan",
           "SUMMARY_FIELDS", "SUMMARY_FIELDS_B", "available", "build_error",
           "fast_error", "is_probing", "minimize", "minimize_b",
           "minimize_b_batch", "minimize_batch", "native_lbfgs_batch",
           "native_lbfgsb_batch", "plan", "probe_records", "probe_summary",
           "probing", "reset_counts", "build"]
