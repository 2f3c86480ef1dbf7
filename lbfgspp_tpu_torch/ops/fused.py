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
A warp serves one instance at a time; the blocks of a persistent grid
each own an even share of the batch, which their warps take one instance
at a time.  Each warp keeps a ring of shared-memory stages that bulk
asynchronous copies (or ``cp.async`` where a run is not 16-byte aligned)
fill with the next instances' bytes while it computes the current one.
:func:`launch_plan` decides warps, stages, grid and each operand's copy
path in Python, and the wrapper passes that plan to the kernel.

:func:`two_loop` dispatches on the device of its tensors: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes :func:`two_loop_plain`.
:func:`two_loop_simple` launches the first design of the kernel (a block
per instance), kept only as a yardstick for the card tests and
``chip_smoke.py``; nothing on the solver's path calls it.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch

from ..utils import cuda_build

Tensor = torch.Tensor

MODES = {"sweeps": 0, "rinv": 1}
# Per-block dynamic shared memory of an H100 (227 KB), and per SM (228 KB,
# of which the runtime keeps 1 KB for each resident block).
MAX_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
# The kernel's launch bounds hold it to 128 registers a thread in f32 and
# 255 in f64, so 16 or 8 of its warps fit in an SM's 65,536 registers.
MAX_WARPS_PER_SM_BY_REGISTERS = {4: 16, 8: 8}
MAX_WARPS = 8
MAX_STAGES = 2
# How the plan weighs warps against stages and stages rows (measured by
# lbfgspp_tpu_torch/tools/two_loop_study.py; see _launch_plan): with rows
# by bulk copy, more warps beat more stages up to this many warps per SM;
MIN_WARPS_PER_SM = 4
# with rows by cp.async, one round of copies from every lane on an SM must
# move 32 bytes a lane (8 warps at 4-byte granules, 4 at 8) for staged
# rows to pay.
CP_ASYNC_BYTES_PER_LANE = 32
# The operands a stage holds, in the kernel's order of the packed copy
# codes: 0 = bulk asynchronous copy, 1 / 2 = cp.async of 4 / 8 bytes (the
# kernel also takes 3 = 16 bytes, which a 16-byte aligned run never needs:
# it goes by bulk copy).  "mat" is sy (sweeps) or rinv (rinv).
OPERANDS = ("s", "y", "mat", "yy", "v", "ys")
_GRANULE_CODE = {4: 1, 8: 2}


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


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _layout(m: int, n: int, itemsize: int, warps: int, stages: int,
            staged: bool = True):
    """Shared-memory layout of the kernel (csrc/two_loop.cu: make_layout):
    ``(ld, stage_bytes, smem_bytes)``.  A stage holds s and y as m rows of
    stride ``ld`` (n rounded up to 16 bytes), the two [m, m] runs, v, ys
    and a 16-byte header (unstaged: no s, y or v); each warp adds 9m
    values and m ints of scratch; the block's instance counter (16 bytes)
    and the mbarriers (8 bytes per stage) lead the block."""
    vn = 16 // itemsize
    ld = -(-n // vn) * vn
    row = ld * itemsize if staged else 0
    stage = (2 * _round16(m * row) + 2 * _round16(m * m * itemsize)
             + _round16(row) + _round16(m * itemsize) + 16)
    scratch = _round16(9 * m * itemsize + 4 * m)
    smem = 16 + _round16(8 * warps * stages) + \
        warps * (stages * stage + scratch)
    return ld, stage, smem


def _blocks_per_sm(warps: int, smem: int, itemsize: int) -> int:
    """Blocks of ``warps`` warps and ``smem`` bytes an SM holds at once."""
    return min(MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // (32 * warps),
               MAX_WARPS_PER_SM_BY_REGISTERS[itemsize] // warps,
               SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM))


def _copy_path(address: int, row_bytes: int, itemsize: int) -> int:
    """0 (bulk copy) where the address and the run are 16-byte multiples,
    else the widest cp.async granule (8 or 4 bytes) dividing both."""
    if address % 16 == 0 and row_bytes % 16 == 0:
        return 0
    for g in (8, 4):
        if g >= itemsize and address % g == 0 and row_bytes % g == 0:
            return g
    raise ValueError(f"two_loop: an operand's address is not a multiple "
                     f"of its {itemsize}-byte elements")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call of the kernel is laid out on the card."""
    batch: int
    m: int
    n: int
    warps: int           # warps per block, one instance at a time each
    stages: int          # shared-memory stages in each warp's ring
    grid: int            # persistent blocks
    blocks_per_sm: int
    ld: int              # shared row stride of s / y / v, in elements
    staged: bool         # False: s, y and v stay in device memory
    stage_bytes: int
    smem_bytes: int      # dynamic shared memory per block
    copy: dict           # operand -> "bulk", "cp.async/<bytes>" or "none"
    codes: int           # the copy paths packed for the kernel

    def instances(self, block: int) -> range:
        """The instances block ``block`` serves (its warps take them one
        at a time, in order, from a shared counter)."""
        return range(block * self.batch // self.grid,
                     (block + 1) * self.batch // self.grid)


def launch_plan(batch: int, m: int, n: int, dtype, num_sms: int,
                addresses=None) -> LaunchPlan:
    """Warps per block, stages, shared bytes, grid and each operand's copy
    path for one kernel call on a card with ``num_sms`` SMs.

    ``addresses`` maps operand names (:data:`OPERANDS`) to their device
    addresses (``data_ptr()``); a missing one counts as 16-byte aligned.
    The plan takes the layout (one or two stages, up to :data:`MAX_WARPS`
    warps and no more than the batch) that keeps the most stage buffers
    resident per SM, the deeper ring on a tie, after the most warps per
    SM up to :data:`MIN_WARPS_PER_SM`.  Rows (s, y, v) that go by bulk
    copy are staged in shared memory wherever one stage fits; rows that go
    by ``cp.async`` (n * itemsize not a multiple of 16, or an unaligned
    view) only where that keeps ``CP_ASYNC_BYTES_PER_LANE // granule``
    warps on an SM (at m=16: odd n up to 195 in f32, 197 in f64).
    Otherwise the plan is unstaged:
    s, y and v stay in device memory.  Raises ``ValueError`` where one
    unstaged stage of one warp does not fit.

    Plans are cached: only the addresses' offsets within 16 bytes matter,
    so the solver's every-iteration call costs a dictionary lookup."""
    addresses = addresses or {}
    offsets = tuple(int(addresses.get(op, 0)) % 16 for op in OPERANDS)
    return _launch_plan(batch, m, n, dtype, num_sms, offsets)


def _itemsize(dtype) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    if itemsize not in (4, 8):
        raise ValueError(f"two_loop: the kernel takes float32 or float64, "
                         f"got {dtype}")
    return itemsize


def _no_fit(m: int, smem: int) -> ValueError:
    return ValueError(f"two_loop: m={m} needs {smem} bytes of shared memory "
                      f"per block, above the {MAX_SMEM_BYTES} a Hopper "
                      f"block can have")


@functools.lru_cache(maxsize=256)
def _launch_plan(batch, m, n, dtype, num_sms, offsets):
    itemsize = _itemsize(dtype)
    # Among the layouts that fit, take the one that keeps the most stage
    # buffers resident on an SM (warps per SM x stages), counting first
    # the warps per SM up to MIN_WARPS_PER_SM; on a tie, the deeper ring,
    # then the wider block.  Measured on the H100 (B=4096,
    # m=16): with bulk rows a second stage pays only where it costs no
    # warps (f32 n=100: 7 warps x 2 stages per SM), and below four warps
    # per SM one more warp beats a second stage (f32 n=600: 2 x 1 in
    # 0.155 ms, 1 x 2 in 0.198).  A bulk copy keeps a whole row run in
    # flight, so staged rows beat rows read twice from device memory even
    # at one or two warps per SM (f32 n=600-1700, f64 n=300: 0.35-0.67x
    # the time; f64 sweeps at one warp, n=600, is the exception at 1.22x).
    # cp.async rows keep only a granule per lane in flight: their time
    # falls with every warp added (f32 n=101: 0.118 ms at 4 warps x 2
    # stages per SM, 0.059 at 14 x 1), and they beat
    # unstaged rows from 8 warps per SM at 4-byte granules (f32 n=101:
    # 0.069 ms at 8, unstaged 0.111; n=301 at 5: 0.261 against 0.255) and
    # from 4 at 8-byte ones (f64 n=151: 0.173 against 0.198; n=199 at 3:
    # 0.290 against 0.273).
    grain = min((g for g in (
        _copy_path(offsets[OPERANDS.index(op)], n * itemsize, itemsize)
        for op in ("s", "y", "v")) if g), default=0)
    need = min(CP_ASYNC_BYTES_PER_LANE // grain, batch) if grain else 1
    cap = min(MIN_WARPS_PER_SM, batch)
    best = None
    for staged in (True, False):
        for stages in (2, 1):
            for warps in range(1, min(MAX_WARPS, batch) + 1):
                smem = _layout(m, n, itemsize, warps, stages, staged)[2]
                if smem > MAX_SMEM_BYTES:
                    continue
                per_sm = warps * _blocks_per_sm(warps, smem, itemsize)
                if staged and per_sm < need:
                    continue
                key = (min(per_sm, cap), per_sm * stages, stages, warps)
                if best is None or key > best[0]:
                    best = (key, (warps, stages, staged))
        if best is not None:
            break
    if best is None:
        raise _no_fit(m, _layout(m, n, itemsize, 1, 1, False)[2])
    return _layout_plan(batch, m, n, dtype, num_sms, *best[1],
                        dict(zip(OPERANDS, offsets)))


def _layout_plan(batch, m, n, dtype, num_sms, warps, stages, staged,
                 addresses=None) -> LaunchPlan:
    """The plan of one given layout (``warps`` per block, ``stages`` per
    ring, rows ``staged`` or in device memory): shared bytes, grid and copy
    paths.  :func:`launch_plan` chooses the layout; tests and measurements
    call this to reach a layout it would not choose.  Raises ``ValueError``
    where the layout does not fit a block."""
    itemsize = _itemsize(dtype)
    if not (1 <= warps <= MAX_WARPS and 1 <= stages <= MAX_STAGES):
        raise ValueError(f"two_loop: warps and stages must be in "
                         f"1..{MAX_WARPS} and 1..{MAX_STAGES}")
    ld, stage_bytes, smem = _layout(m, n, itemsize, warps, stages, staged)
    if smem > MAX_SMEM_BYTES:
        raise _no_fit(m, smem)
    addresses = addresses or {}
    runs = {"s": n * itemsize, "y": n * itemsize, "mat": m * m * itemsize,
            "yy": m * m * itemsize, "v": n * itemsize, "ys": m * itemsize}
    copy, codes = {}, 0
    for k, op in enumerate(OPERANDS):
        if not staged and op in ("s", "y", "v"):
            copy[op] = "none"
            continue
        g = _copy_path(int(addresses.get(op, 0)), runs[op], itemsize)
        copy[op] = "bulk" if g == 0 else f"cp.async/{g}"
        codes |= (0 if g == 0 else _GRANULE_CODE[g]) << (2 * k)
    per_sm = max(1, _blocks_per_sm(warps, smem, itemsize))
    grid = max(1, min(num_sms * per_sm, -(-batch // warps)))
    return LaunchPlan(batch=batch, m=m, n=n, warps=warps, stages=stages,
                      grid=grid, blocks_per_sm=per_sm, ld=ld, staged=staged,
                      stage_bytes=stage_bytes, smem_bytes=smem, copy=copy,
                      codes=codes)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("two_loop", ["two_loop.cu"])
    if not getattr(lib, "_typed", False):
        common = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + \
            [ctypes.c_double, ctypes.c_int]
        for fn in (lib.lbfgs_two_loop_f32, lib.lbfgs_two_loop_f64):
            fn.argtypes = common + [ctypes.c_int] * 4 + [
                ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.lbfgs_two_loop_simple_f32,
                   lib.lbfgs_two_loop_simple_f64):
            fn.argtypes = common + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.lbfgs_two_loop_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.lbfgs_two_loop_smem_bytes.restype = ctypes.c_longlong
        lib.lbfgs_two_loop_simple_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.lbfgs_two_loop_simple_smem_bytes.restype = ctypes.c_longlong
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


def _check_args(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, mode):
    """Device, type, shape and contiguity checks shared by both kernels;
    returns ``(batch, m, n)``."""
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
    return batch, m, n


_num_sms: dict = {}


def num_sms(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _num_sms:
        _num_sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _num_sms[index]


def plan_for(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
             mode) -> LaunchPlan:
    """The launch plan of a call on these (CUDA) tensors."""
    batch, m, n = s.shape
    mat = rinv if mode == "rinv" else sy
    addresses = {"s": s.data_ptr(), "y": y.data_ptr(),
                 "mat": mat.data_ptr(), "yy": yy.data_ptr(),
                 "v": v.data_ptr(), "ys": ys.data_ptr()}
    return launch_plan(batch, m, n, v.dtype, num_sms(v.device), addresses)


def _on_device(device):
    """The device context for a launch, entered only when the tensors are
    not on the current device (the launch goes to the current one)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.lbfgs_cuda_error_string(err).decode()}")


def _launch(plan: LaunchPlan, s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
            a, mode) -> Tensor:
    """Launch the kernel on checked tensors with ``plan``; counts
    nothing."""
    lib = _library()
    out = torch.empty_like(v)
    f64 = v.dtype == torch.float64
    fn = lib.lbfgs_two_loop_f64 if f64 else lib.lbfgs_two_loop_f32
    with _on_device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(s.data_ptr(), y.data_ptr(), ys.data_ptr(),
                 theta.data_ptr(), ptr.data_ptr(), ncorr.data_ptr(),
                 None if sy is None else sy.data_ptr(), yy.data_ptr(),
                 None if rinv is None else rinv.data_ptr(),
                 v.data_ptr(), out.data_ptr(), plan.batch, plan.m, plan.n,
                 float(a), MODES[mode], plan.warps, plan.stages, plan.grid,
                 int(plan.staged), plan.codes, plan.smem_bytes, stream)
    _raise_on(lib, err, "two_loop kernel")
    return out


def _two_loop_cuda(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a, mode):
    args = (s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v)
    _check_args(*args, mode)
    out = _launch(plan_for(*args, mode), *args, a, mode)
    two_loop.launches += 1
    return out


def two_loop(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a: float,
             mode: str = "sweeps") -> Tensor:
    """Batched ``a * H * v`` from the raw ring state: ``s, y [B, m, n]``,
    ``ys [B, m]``, ``theta [B]``, ``ptr, ncorr [B]`` int32, ``sy, yy
    [B, m, m]``, ``rinv [B, m, m]`` (``rinv`` mode only), ``v [B, n]``.

    A CUDA tensor launches the kernel with :func:`launch_plan`'s plan and
    counts the launch in ``two_loop.launches``; a CPU tensor takes
    :func:`two_loop_plain`."""
    if v.device.type == "cpu":
        return two_loop_plain(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
                              a, mode)
    if v.device.type != "cuda":
        raise ValueError(f"two_loop: no kernel for device {v.device}")
    return _two_loop_cuda(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a,
                          mode)


two_loop.launches = 0


def two_loop_simple(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a: float,
                    mode: str = "sweeps") -> Tensor:
    """The first design of the kernel (one 128-thread block per instance),
    kept as a yardstick: the card tests and ``chip_smoke.py`` time it in
    turns with :func:`two_loop`.  Same arguments and function; a CPU tensor
    takes :func:`two_loop_plain`.  Counts its launches in
    ``two_loop_simple.launches``, apart from the main kernel's."""
    if v.device.type == "cpu":
        return two_loop_plain(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
                              a, mode)
    if v.device.type != "cuda":
        raise ValueError(f"two_loop_simple: no kernel for device {v.device}")
    batch, m, n = _check_args(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
                              mode)
    lib = _library()
    f64 = v.dtype == torch.float64
    smem = lib.lbfgs_two_loop_simple_smem_bytes(m, int(f64))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"two_loop_simple: m={m} needs {smem} bytes of "
                         f"shared memory per block, above the "
                         f"{MAX_SMEM_BYTES} a Hopper block can have")
    out = torch.empty_like(v)
    fn = lib.lbfgs_two_loop_simple_f64 if f64 else \
        lib.lbfgs_two_loop_simple_f32
    with _on_device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(s.data_ptr(), y.data_ptr(), ys.data_ptr(),
                 theta.data_ptr(), ptr.data_ptr(), ncorr.data_ptr(),
                 None if sy is None else sy.data_ptr(), yy.data_ptr(),
                 None if rinv is None else rinv.data_ptr(),
                 v.data_ptr(), out.data_ptr(), batch, m, n, float(a),
                 MODES[mode], stream)
    _raise_on(lib, err, "two_loop_simple kernel")
    two_loop_simple.launches += 1
    return out


two_loop_simple.launches = 0
