"""The batched two-loop direction ``a * H * v``: CUDA kernel and plain
version.

The JAX package computes this in a Pallas kernel for the TPU, in two
layouts: ``_batched_fused`` and ``_batched_fused_mmajor``
(lbfgspp_tpu/ops/fused.py:111-151 and :265-307).  Here one CUDA kernel,
``csrc/two_loop.cu``, serves both, and also the incremental-``R^{-1}``
schedule (``tri="rinv"``, lbfgspp_tpu/ops/history.py:358-372) that the
batched main phase runs.  Every batched ``apply_hv`` on a CUDA tensor in
``sweeps`` or ``rinv`` mode launches it.

Bound and design (details in the source): the call is memory-bound, about
64 MB and 19 us at the H100's 3.35 TB/s for B=4096, m=16, n=100 in f32.
One block per instance streams its s/y rows once for the 2m dots, builds
the ring-distance masks from ``ptr``/``ncorr`` itself (no [B, m, m] mask
tensors in device memory), runs the O(m^2)-per-sweep recursion on one warp
from shared memory, and re-reads the rows from L1 for the combine.

:func:`two_loop` dispatches on the device of its tensors: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes :func:`two_loop_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build

Tensor = torch.Tensor

MODES = {"sweeps": 0, "rinv": 1}
# Per-block dynamic shared memory of an H100 (227 KB).
MAX_SMEM_BYTES = 232448


def _prep_masks(ys: Tensor, ptr: Tensor, ncorr: Tensor, sy: Tensor,
                dtype):
    """Slot-space masks from the integer ring state, batched
    (lbfgspp_tpu/ops/fused.py:154-168).  Returns ``(msy, msyT, ys_safe,
    vmask, valid)``: slot j is newer than slot i when its ring distance
    ``(ptr - 1 - j) mod m`` is smaller."""
    m = ys.shape[-1]
    slots = torch.arange(m, device=ys.device)
    dist = (ptr[:, None] - 1 - slots) % m            # floor remainder
    valid = dist < ncorr[:, None]
    pair = valid[:, :, None] & valid[:, None, :]
    newer = (dist[:, None, :] < dist[:, :, None]) & pair
    older = (dist[:, None, :] > dist[:, :, None]) & pair
    msy = torch.where(newer, sy, 0.0)
    msyT = torch.where(older, sy.transpose(1, 2), 0.0)
    ys_safe = torch.where(valid, ys, 1.0)
    return msy, msyT, ys_safe, valid.to(dtype), valid


def _matvec(mat: Tensor, vec: Tensor) -> Tensor:
    """Batched ``mat @ vec``: [B, i, j] x [B, j] -> [B, i]."""
    return torch.matmul(mat, vec[:, :, None])[:, :, 0]


def combine(s: Tensor, y: Tensor, v: Tensor, alpha: Tensor, beta: Tensor,
            valid: Tensor, theta: Tensor, a: float) -> Tensor:
    """The masked combine both modes end with
    (lbfgspp_tpu/ops/history.py:414-418):
    ``(a/theta) v + S^T w_s + Y^T w_y``."""
    th = theta[:, None]
    w_s = torch.where(valid, alpha - beta, 0.0)
    w_y = torch.where(valid, -alpha / th, 0.0)
    return ((a / th) * v + _matvec(s.transpose(1, 2), w_s)
            + _matvec(y.transpose(1, 2), w_y))


def two_loop_plain(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a: float,
                   mode: str = "sweeps") -> Tensor:
    """The kernel's function in plain PyTorch, batched.  ``sweeps`` is the
    Pallas kernel's ``_sweep_math`` recursion
    (lbfgspp_tpu/ops/fused.py:78-101); ``rinv`` is
    lbfgspp_tpu/ops/history.py:358-372."""
    m = ys.shape[-1]
    th = theta[:, None]
    msy, msyT, ys_safe, vmask, valid = _prep_masks(ys, ptr, ncorr, sy,
                                                   v.dtype)
    sv = _matvec(s, v)
    yv = _matvec(y, v)
    if mode == "rinv":
        alpha = _matvec(rinv, a * sv)
        base = (a * yv - _matvec(yy, alpha)) / th
        beta = vmask * (alpha - _matvec(rinv.transpose(1, 2),
                                        ys * alpha - base))
    elif mode == "sweeps":
        rhs_a = a * sv
        alpha = torch.zeros_like(sv)
        for _ in range(m):
            alpha = vmask * (rhs_a - _matvec(msy, alpha)) / ys_safe
        base = (a * yv - _matvec(yy, alpha)) / th
        beta = torch.zeros_like(sv)
        for _ in range(m):
            beta = vmask * (base + _matvec(msyT, alpha - beta)) / ys_safe
    else:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}")
    return combine(s, y, v, alpha, beta, valid, theta, a)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("two_loop", ["two_loop.cu"])
    if not getattr(lib, "_typed", False):
        args = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + \
            [ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.lbfgs_two_loop_f32, lib.lbfgs_two_loop_f64):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.lbfgs_two_loop_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.lbfgs_two_loop_smem_bytes.restype = ctypes.c_longlong
        lib.lbfgs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lbfgs_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def build() -> None:
    """Build and load the kernel library now (it is otherwise built on the
    first launch)."""
    _library()


def _check(name: str, t: Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"two_loop: {name} is on {t.device}, v on {device}")
    if t.dtype != dtype:
        raise ValueError(f"two_loop: {name} has dtype {t.dtype}, expected "
                         f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"two_loop: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"two_loop: {name} must be contiguous")


def _two_loop_cuda(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}")
    if v.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"two_loop: the kernel takes float32 or float64, "
                         f"got {v.dtype}")
    if v.dim() != 2 or s.dim() != 3:
        raise ValueError("two_loop: expected v [B, n] and s [B, m, n]")
    batch, m, n = s.shape
    dev, dt = v.device, v.dtype
    _check("s", s, (batch, m, n), dt, dev)
    _check("y", y, (batch, m, n), dt, dev)
    _check("ys", ys, (batch, m), dt, dev)
    _check("theta", theta, (batch,), dt, dev)
    _check("ptr", ptr, (batch,), torch.int32, dev)
    _check("ncorr", ncorr, (batch,), torch.int32, dev)
    _check("yy", yy, (batch, m, m), dt, dev)
    _check("v", v, (batch, n), dt, dev)
    if mode == "rinv":
        if rinv is None:
            raise ValueError("two_loop: mode 'rinv' needs rinv")
        _check("rinv", rinv, (batch, m, m), dt, dev)
    else:
        _check("sy", sy, (batch, m, m), dt, dev)
    lib = _library()
    f64 = dt == torch.float64
    smem = lib.lbfgs_two_loop_smem_bytes(m, int(f64))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"two_loop: m={m} needs {smem} bytes of shared "
                         f"memory per block, above the {MAX_SMEM_BYTES} "
                         f"a Hopper block can have")
    out = torch.empty_like(v)
    fn = lib.lbfgs_two_loop_f64 if f64 else lib.lbfgs_two_loop_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(s.data_ptr(), y.data_ptr(), ys.data_ptr(),
                 theta.data_ptr(), ptr.data_ptr(), ncorr.data_ptr(),
                 None if sy is None else sy.data_ptr(), yy.data_ptr(),
                 None if rinv is None else rinv.data_ptr(),
                 v.data_ptr(), out.data_ptr(), batch, m, n, float(a),
                 MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"two_loop kernel launch failed: "
                           f"{lib.lbfgs_cuda_error_string(err).decode()}")
    two_loop.launches += 1
    return out


def two_loop(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a: float,
             mode: str = "sweeps") -> Tensor:
    """Batched ``a * H * v`` from the raw ring state: ``s, y [B, m, n]``,
    ``ys [B, m]``, ``theta [B]``, ``ptr, ncorr [B]`` int32, ``sy, yy
    [B, m, m]``, ``rinv [B, m, m]`` (``rinv`` mode only), ``v [B, n]``.

    A CUDA tensor launches the kernel and counts the launch in
    ``two_loop.launches``; a CPU tensor takes :func:`two_loop_plain`."""
    if v.device.type == "cpu":
        return two_loop_plain(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
                              a, mode)
    if v.device.type != "cuda":
        raise ValueError(f"two_loop: no kernel for device {v.device}")
    return _two_loop_cuda(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a,
                          mode)


two_loop.launches = 0
