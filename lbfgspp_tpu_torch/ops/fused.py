"""The batched two-loop direction ``a * H * v``: CUDA kernel and plain
version.

The JAX package computes this in a Pallas kernel for the TPU, in two
layouts: ``_batched_fused`` and ``_batched_fused_mmajor``
(lbfgspp_tpu/ops/fused.py:111-151 and :265-307).  Here one CUDA kernel,
``csrc/two_loop.cu``, serves both, and also the incremental-``R^{-1}``
schedule (``tri="rinv"``, lbfgspp_tpu/ops/history.py:358-372) that the
batched main phase runs.  Every batched ``apply_hv`` on a CUDA tensor in
``sweeps`` or ``rinv`` mode launches it, where it can serve.  It takes s
and y in f32, f64 or bf16, and the other operands in the rows' type or,
beside bf16 rows, in f32 (a float32 solve whose history is stored in
bfloat16); bf16 values are computed in f32.

Bound and design (details in the source): the call is memory-bound, about
64 MB and 19 us at the H100's 3.35 TB/s for B=4096, m=16, n=100 in f32.
A warp serves one instance at a time; the blocks of a persistent grid
each own an even share of the batch, which their warps take one instance
at a time.  Each warp keeps a ring of shared-memory stages that bulk
asynchronous copies (or ``cp.async`` where a run is not 16-byte aligned)
fill with the next instances' bytes while it computes the current one.
:func:`launch_plan` decides warps, stages, grid and each operand's copy
path in Python, and the wrapper passes that plan to the kernel.

:func:`two_loop` dispatches on the device of its tensors: a CPU tensor
takes :func:`two_loop_plain`; a CUDA tensor launches the kernel (or
raises), except where :func:`route` finds before any launch that the
kernel cannot serve the call (its types, a plan that fits no block) or
serves it slower (rows longer than :data:`LARGE_N` in a small batch):
those calls take the plain version and are counted apart.
:func:`two_loop_simple` launches the first design of the kernel (a block
per instance), kept only as a yardstick for the card tests and
``chip_smoke.py``; nothing on the solver's path calls it.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools

import torch

from ..parallel import collectives as coll
from ..utils import cuda_build

Tensor = torch.Tensor

MODES = {"sweeps": 0, "rinv": 1}
# The kernel's instantiations by (row dtype, operand dtype): s and y are
# rows; v, ys, theta, the [m, m] runs and the output are operands.  "bf16"
# is the Pallas kernel's bf16 mode; "bf16rows" a float32 solve whose
# history stores its rows in bfloat16.
KINDS = {(torch.float32, torch.float32): "f32",
         (torch.float64, torch.float64): "f64",
         (torch.bfloat16, torch.bfloat16): "bf16",
         (torch.bfloat16, torch.float32): "bf16rows"}
# Bytes of a row element, of an operand element and of a computed value,
# by instantiation, in the order of the ``kind`` argument of
# lbfgs_two_loop_smem_bytes (0 f32, 1 f64, 2 bf16, 3 bf16rows).
SIZES = {"f32": (4, 4, 4), "f64": (8, 8, 8), "bf16": (2, 2, 4),
         "bf16rows": (2, 4, 4)}
# Per-block dynamic shared memory of an H100 (227 KB), and per SM (228 KB,
# of which the runtime keeps 1 KB for each resident block).
MAX_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
# The kernel's launch bounds hold it to 128 registers a thread where it
# computes in f32 (bf16 rows included) and 255 in f64, so 16 or 8 of its
# warps fit in an SM's 65,536 registers (ptxas reports the instantiations
# within those bounds without spills: chip_smoke.py phase 1).
MAX_WARPS_PER_SM_BY_REGISTERS = {"f32": 16, "f64": 8, "bf16": 16,
                                 "bf16rows": 16}
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
# codes: 0 = bulk asynchronous copy, 1 / 2 = cp.async of 4 / 8 bytes, 3 =
# two-byte elements copied by the lanes' own loads and stores (a bf16 run
# that no 4-byte granule divides).  "mat" is sy (sweeps) or rinv (rinv).
OPERANDS = ("s", "y", "mat", "yy", "v", "ys")
_GRANULE_CODE = {4: 1, 8: 2, 2: 3}
# The dispatch rule on (B, n) for long rows (see route).  Rows of up to
# LARGE_N elements always take the kernel.  Longer rows are streamed from
# device memory by one warp per instance: the kernel's time per call grows
# slowly with B until the card is full, while the plain version's grows
# with B * n.  So long rows take the kernel from LARGE_N_KERNEL_BATCH_PER_SM
# instances per SM on, and the plain version below that (None: at every
# batch).  Measured by tools/two_loop_study.py --part route on an NVIDIA
# H100 80GB HBM3, 700 W (B = 1..2112, n = 2^14..2^17, m=6, rinv): at
# these batches the kernel takes less device time and less time per call
# (bf16 rows at B=264, n=2^17: a tie); below them, for n above 2^14, the
# plain version takes less device time, and less time per call too but at
# some B <= 8 with n = 2^15, where its ~40 launches cost the host about as
# long as the kernel runs.  f32 and all-bf16 reach it at 16 per SM, the
# card's resident warps; bf16 rows, which the plain version widens, at 2;
# f64 at no batch up to 2112.
LARGE_N = 1 << 14
LARGE_N_KERNEL_BATCH_PER_SM = {"f32": 16, "f64": None, "bf16": 16,
                               "bf16rows": 2}


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


# Bytes of the widened chunk the plain version makes at a time where the
# rows are stored narrower than v (a bf16 history of an f32 solve): the
# rows are widened into one reused buffer of this size, chunk by chunk
# along n, so no widened copy of a whole [B, m, n] history is made.
# Chunks that stay in the L2 cost more than they save: at n = 2^27, m=6
# (chip_smoke.py phase 20) the solve took 0.248, 0.125, 0.113, 0.086,
# 0.084 and 0.082 s/iteration at 4, 16, 32, 128, 256 and 512 MiB, the
# launches and cuBLAS's per-chunk products growing as the chunk shrinks
# (tools/two_loop_study.py --part chunk, NVIDIA H100 80GB HBM3, 700 W).
PLAIN_CHUNK_BYTES = 1 << 27


def _chunk_columns(rows: Tensor, dtype) -> int:
    batch, m, _ = rows.shape
    return max(1, PLAIN_CHUNK_BYTES // (batch * m * dtype.itemsize))


def rows_times(rows: Tensor, rhs: Tensor) -> Tensor:
    """``rows @ rhs``, [B, m, n] x [B, n, k] -> [B, m, k], in rhs's dtype;
    rows of another dtype are widened to it chunk by chunk along n."""
    if rows.dtype == rhs.dtype:
        return torch.bmm(rows, rhs)
    batch, m, n = rows.shape
    cols = _chunk_columns(rows, rhs.dtype)
    if cols >= n:
        return torch.bmm(rows.to(rhs.dtype), rhs)
    buf = rhs.new_empty((batch, m, cols))
    out = rhs.new_zeros((batch, m, rhs.shape[2]))
    for c in range(0, n, cols):
        part = buf[:, :, :min(cols, n - c)]
        part.copy_(rows[:, :, c:c + cols])
        out.baddbmm_(part, rhs[:, c:c + cols])
    return out


def rows_dot(rows: Tensor, v: Tensor) -> Tensor:
    """``rows @ v``, [B, m, n] x [B, n] -> [B, m] (:func:`rows_times`)."""
    return rows_times(rows, v[:, :, None])[:, :, 0]


def rows_combine(rows: Tensor, w: Tensor) -> Tensor:
    """``rows^T w``, [B, m, n] x [B, m] -> [B, n], in w's dtype; rows of
    another dtype are widened to it chunk by chunk along n."""
    if rows.dtype == w.dtype:
        return _matvec(rows.transpose(1, 2), w)
    batch, m, n = rows.shape
    cols = _chunk_columns(rows, w.dtype)
    if cols >= n:
        return _matvec(rows.to(w.dtype).transpose(1, 2), w)
    buf = w.new_empty((batch, m, cols))
    out = w.new_empty((batch, n))
    for c in range(0, n, cols):
        part = buf[:, :, :min(cols, n - c)]
        part.copy_(rows[:, :, c:c + cols])
        out[:, c:c + cols] = _matvec(part.transpose(1, 2), w)
    return out


def combine(s: Tensor, y: Tensor, v: Tensor, alpha: Tensor, beta: Tensor,
            valid: Tensor, theta: Tensor, a: float) -> Tensor:
    """The masked combine both modes end with
    (lbfgspp_tpu/ops/history.py:414-418):
    ``(a/theta) v + S^T w_s + Y^T w_y``."""
    th = theta[:, None]
    w_s = torch.where(valid, alpha - beta, 0.0)
    w_y = torch.where(valid, -alpha / th, 0.0)
    return (a / th) * v + rows_combine(s, w_s) + rows_combine(y, w_y)


def _coefficients(sv, yv, ys, theta, ptr, ncorr, sy, yy, rinv, a: float,
                  mode: str, dtype):
    """The two-loop coefficients ``(alpha, beta, valid)`` from the row
    products ``sv = S v`` and ``yv = Y v`` ([B, m]): the recursion both
    the plain version and the grouped route run on replicated state."""
    m = ys.shape[-1]
    th = theta[:, None]
    msy, msyT, ys_safe, vmask, valid = _prep_masks(ys, ptr, ncorr, sy,
                                                   dtype)
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
    return alpha, beta, valid


def two_loop_plain(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a: float,
                   mode: str = "sweeps", group=None) -> Tensor:
    """The kernel's function in plain PyTorch, batched.  ``sweeps`` is the
    Pallas kernel's ``_sweep_math`` recursion
    (lbfgspp_tpu/ops/fused.py:78-101); ``rinv`` is
    lbfgspp_tpu/ops/history.py:358-372.  Every op rounds to v's dtype (in
    bf16, per op as the Pallas kernel's bf16 mode does); s and y may be
    stored narrower than v (bf16 rows of an f32 solve), and are then
    widened per element, as the JAX package's XLA path promotes them
    (history.py:336-418).

    ``group``: the rows and ``v`` are this rank's feature block; the
    local ``S v`` and ``Y v`` ride ONE all-reduce of ``[B, 2m]``
    (lbfgspp_tpu/ops/history.py:332-337) and the recursion runs on the
    replicated coefficients."""
    sv = rows_dot(s, v)
    yv = rows_dot(y, v)
    if group is not None:
        sv, yv = coll.pfused([sv, yv], group, "history.apply_hv")
    alpha, beta, valid = _coefficients(sv, yv, ys, theta, ptr, ncorr, sy,
                                       yy, rinv, a, mode, v.dtype)
    return combine(s, y, v, alpha, beta, valid, theta, a)


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _layout(m: int, n: int, kind: str, warps: int, stages: int,
            staged: bool = True):
    """Shared-memory layout of the kernel (csrc/two_loop.cu: make_layout)
    for one of :data:`KINDS`: ``(ld, stage_bytes, smem_bytes)``.  A stage
    holds s and y as m rows of stride ``ld`` (n rounded up to 16 bytes of
    row elements), the two [m, m] runs, v (at the same stride), ys and a
    16-byte header (unstaged: no s, y or v); each warp adds 9m computed
    values and m ints of scratch; the block's instance counter (16 bytes)
    and the mbarriers (8 bytes per stage) lead the block."""
    row, op, comp = SIZES[kind]
    vn = 16 // row
    ld = -(-n // vn) * vn
    srow = ld * row if staged else 0
    vrow = ld * op if staged else 0
    stage = (2 * _round16(m * srow) + 2 * _round16(m * m * op)
             + _round16(vrow) + _round16(m * op) + 16)
    scratch = _round16(9 * m * comp + 4 * m)
    smem = 16 + _round16(8 * warps * stages) + \
        warps * (stages * stage + scratch)
    return ld, stage, smem


def _blocks_per_sm(warps: int, smem: int, kind: str) -> int:
    """Blocks of ``warps`` warps and ``smem`` bytes an SM holds at once."""
    return min(MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // (32 * warps),
               MAX_WARPS_PER_SM_BY_REGISTERS[kind] // warps,
               SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM))


def _copy_path(address: int, row_bytes: int, itemsize: int) -> int:
    """0 (bulk copy) where the address and the run are 16-byte multiples,
    else the widest cp.async granule (8 or 4 bytes) dividing both, else 2
    for two-byte elements (copied by the lanes)."""
    if address % 16 == 0 and row_bytes % 16 == 0:
        return 0
    for g in (8, 4, 2):
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
    copy: dict           # operand -> "bulk", "cp.async/<bytes>", "lanes/2"
                         # or "none"
    codes: int           # the copy paths packed for the kernel
    kind: str            # the instantiation (a key of SIZES)

    def instances(self, block: int) -> range:
        """The instances block ``block`` serves (its warps take them one
        at a time, in order, from a shared counter)."""
        return range(block * self.batch // self.grid,
                     (block + 1) * self.batch // self.grid)


def kind_of(row_dtype, dtype):
    """The kernel's instantiation for rows (s, y) of ``row_dtype`` and
    operands of ``dtype`` (a key of :data:`SIZES`), or None where it has
    none."""
    return KINDS.get((row_dtype, dtype))


def launch_plan(batch: int, m: int, n: int, kind: str, num_sms: int,
                addresses=None) -> LaunchPlan:
    """Warps per block, stages, shared bytes, grid and each operand's copy
    path for one kernel call of instantiation ``kind`` (a key of
    :data:`SIZES`, as :func:`kind_of` names it) on a card with ``num_sms``
    SMs.

    ``addresses`` maps operand names (:data:`OPERANDS`) to their device
    addresses (``data_ptr()``); a missing one counts as 16-byte aligned.
    The plan takes the layout (one or two stages, up to :data:`MAX_WARPS`
    warps and no more than the batch) that keeps the most stage buffers
    resident per SM, the deeper ring on a tie, after the most warps per
    SM up to :data:`MIN_WARPS_PER_SM`.  Rows (s, y, v) that go by bulk
    copy are staged in shared memory wherever one stage fits; rows that go
    by ``cp.async`` (n * itemsize not a multiple of 16, or an unaligned
    view) only where that keeps ``CP_ASYNC_BYTES_PER_LANE // granule``
    warps on an SM (at m=16: odd n up to 195 in f32, 197 in f64); bf16
    rows that no 4-byte granule divides (odd n) never.  Otherwise the plan
    is unstaged: s, y and v stay in device memory.  Raises ``ValueError``
    where one unstaged stage of one warp does not fit, or where ``kind``
    is not an instantiation (None from :func:`kind_of`).

    Plans are cached: only the addresses' offsets within 16 bytes matter,
    so the solver's every-iteration call costs a dictionary lookup."""
    _check_kind(kind)
    plan = _launch_plan(batch, m, n, kind, num_sms, _offsets(addresses))
    if plan is None:
        raise _no_fit(m, _layout(m, n, kind, 1, 1, False)[2])
    return plan


def _offsets(addresses) -> tuple:
    addresses = addresses or {}
    return tuple(int(addresses.get(op, 0)) % 16 for op in OPERANDS)


def _check_kind(kind) -> None:
    if kind not in SIZES:
        raise ValueError(f"two_loop: the kernel takes float32 or float64 "
                         f"rows and operands, or bfloat16 rows with "
                         f"bfloat16 or float32 operands; no instantiation "
                         f"{kind!r}")


def _no_fit(m: int, smem: int) -> ValueError:
    return ValueError(f"two_loop: m={m} needs {smem} bytes of shared memory "
                      f"per block, above the {MAX_SMEM_BYTES} a Hopper "
                      f"block can have")


@functools.lru_cache(maxsize=256)
def _launch_plan(batch, m, n, kind, num_sms, offsets):
    """:func:`launch_plan` on a kind and address offsets; None where no
    layout fits a block."""
    row, op, _ = SIZES[kind]
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
    # bf16 rows of odd n are not staged: no cp.async granule divides them.
    grains = [_copy_path(offsets[OPERANDS.index(o)], n * size, size)
              for o, size in (("s", row), ("y", row), ("v", op))]
    grain = min((g for g in grains if g), default=0)
    need = min(CP_ASYNC_BYTES_PER_LANE // grain, batch) if grain else 1
    cap = min(MIN_WARPS_PER_SM, batch)
    best = None
    for staged in (True, False) if grain != 2 else (False,):
        for stages in (2, 1):
            for warps in range(1, min(MAX_WARPS, batch) + 1):
                smem = _layout(m, n, kind, warps, stages, staged)[2]
                if smem > MAX_SMEM_BYTES:
                    continue
                per_sm = warps * _blocks_per_sm(warps, smem, kind)
                if staged and per_sm < need:
                    continue
                key = (min(per_sm, cap), per_sm * stages, stages, warps)
                if best is None or key > best[0]:
                    best = (key, (warps, stages, staged))
        if best is not None:
            break
    if best is None:
        return None
    return _layout_plan(batch, m, n, kind, num_sms, *best[1],
                        dict(zip(OPERANDS, offsets)))


def _layout_plan(batch, m, n, kind, num_sms, warps, stages, staged,
                 addresses=None) -> LaunchPlan:
    """The plan of one given layout (``warps`` per block, ``stages`` per
    ring, rows ``staged`` or in device memory) of instantiation ``kind``:
    shared bytes, grid and copy paths.  :func:`launch_plan` chooses the
    layout; tests and measurements call this to reach a layout it would
    not choose.  Raises ``ValueError`` where the layout does not fit a
    block."""
    _check_kind(kind)
    row, op, _ = SIZES[kind]
    if not (1 <= warps <= MAX_WARPS and 1 <= stages <= MAX_STAGES):
        raise ValueError(f"two_loop: warps and stages must be in "
                         f"1..{MAX_WARPS} and 1..{MAX_STAGES}")
    ld, stage_bytes, smem = _layout(m, n, kind, warps, stages, staged)
    if smem > MAX_SMEM_BYTES:
        raise _no_fit(m, smem)
    addresses = addresses or {}
    runs = {"s": (n, row), "y": (n, row), "mat": (m * m, op),
            "yy": (m * m, op), "v": (n, op), "ys": (m, op)}
    copy, codes = {}, 0
    for k, name in enumerate(OPERANDS):
        if not staged and name in ("s", "y", "v"):
            copy[name] = "none"
            continue
        count, size = runs[name]
        g = _copy_path(int(addresses.get(name, 0)), count * size, size)
        copy[name] = ("bulk" if g == 0 else "lanes/2" if g == 2
                      else f"cp.async/{g}")
        codes |= (0 if g == 0 else _GRANULE_CODE[g]) << (2 * k)
    per_sm = max(1, _blocks_per_sm(warps, smem, kind))
    grid = max(1, min(num_sms * per_sm, -(-batch // warps)))
    return LaunchPlan(batch=batch, m=m, n=n, warps=warps, stages=stages,
                      grid=grid, blocks_per_sm=per_sm, ld=ld, staged=staged,
                      stage_bytes=stage_bytes, smem_bytes=smem, copy=copy,
                      codes=codes, kind=kind)


def _library() -> ctypes.CDLL:
    return typed(cuda_build.load("two_loop", ["two_loop.cu"]))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a two-loop library's C
    entry points (this checkout's, or another build of the same
    interface, as ``tools/two_loop_study.py --part ab`` loads)."""
    if not getattr(lib, "_typed", False):
        common = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + \
            [ctypes.c_double, ctypes.c_int]
        for kind in SIZES:
            fn = getattr(lib, f"lbfgs_two_loop_{kind}")
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


def _check_args(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, mode,
                kinds=KINDS):
    """Device, type, shape and contiguity checks shared by both kernels;
    returns ``(batch, m, n)``.  s and y must have one row dtype that
    ``kinds`` pairs with v's."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}")
    rows = [r for r, op in kinds if op == v.dtype]
    if not rows:
        raise ValueError(f"two_loop: the kernel takes float32 or float64 "
                         f"(or bfloat16) operands, got {v.dtype}")
    if v.dim() != 2 or s.dim() != 3:
        raise ValueError("two_loop: expected v [B, n] and s [B, m, n]")
    batch, m, n = s.shape
    dev, dt = v.device, v.dtype
    row = s.dtype if s.dtype in rows else rows[0]
    _check("s", s, (batch, m, n), row, dev)
    _check("y", y, (batch, m, n), row, dev)
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


def _addresses(s, y, ys, sy, yy, rinv, v, mode) -> dict:
    mat = rinv if mode == "rinv" else sy
    return {"s": s.data_ptr(), "y": y.data_ptr(), "mat": mat.data_ptr(),
            "yy": yy.data_ptr(), "v": v.data_ptr(), "ys": ys.data_ptr()}


def plan_for(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
             mode) -> LaunchPlan:
    """The launch plan of a call on these (CUDA) tensors."""
    batch, m, n = s.shape
    return launch_plan(batch, m, n, kind_of(s.dtype, v.dtype),
                       num_sms(v.device),
                       _addresses(s, y, ys, sy, yy, rinv, v, mode))


def route(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, mode):
    """Where :func:`two_loop` sends a call on CUDA tensors, decided from
    the row and operand dtypes, B, m, n and the plan's fit alone, before
    any launch: ``(plan, None)`` for the kernel, or ``(None, reason)`` for
    the plain version, where the reason is one of

    - ``"dtype"``: the kernel has no instantiation for the types;
    - ``"shared memory"``: no layout fits a block (large m: at B=4096,
      n=100 the f32 plan fits up to m=167, the f64 one up to m=117);
    - ``"large n"``: rows longer than :data:`LARGE_N` in a batch smaller
      than :data:`LARGE_N_KERNEL_BATCH_PER_SM` instances per SM (all
      batches in f64), where one warp per instance streams the rows
      slower than the plain version's whole-card products (B=1, n=2^27,
      bf16 rows: 5.8 s against 22 ms); the JAX package never sends long
      rows to its Pallas kernel either, which does not tile n
      (lbfgspp_tpu/ops/fused.py:56-70);

    and :func:`two_loop` adds ``"sharded"`` for a call of a feature-split
    solve, before this function is asked.
    """
    batch, m, n = s.shape
    kind = kind_of(s.dtype, v.dtype)
    if kind is None or y.dtype != s.dtype:
        return None, "dtype"
    if n > LARGE_N:
        per_sm = LARGE_N_KERNEL_BATCH_PER_SM[kind]
        if per_sm is None or batch < per_sm * num_sms(v.device):
            return None, "large n"
    plan = _launch_plan(batch, m, n, kind, num_sms(v.device),
                        _offsets(_addresses(s, y, ys, sy, yy, rinv, v,
                                            mode)))
    if plan is None:
        return None, "shared memory"
    return plan, None


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
            a, mode, lib=None) -> Tensor:
    """Launch the kernel on checked tensors with ``plan``; counts
    nothing.  ``lib``: another build of the kernel (default: this
    checkout's)."""
    lib = _library() if lib is None else lib
    out = torch.empty_like(v)
    fn = getattr(lib, f"lbfgs_two_loop_{plan.kind}")
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


def _two_loop_cuda(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a, mode,
                   plan=None):
    args = (s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v)
    _check_args(*args, mode)
    out = _launch(plan or plan_for(*args, mode), *args, a, mode)
    two_loop.launches += 1
    two_loop.kind_launches[KINDS[s.dtype, v.dtype]] += 1
    return out


def two_loop(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a: float,
             mode: str = "sweeps", group=None) -> Tensor:
    """Batched ``a * H * v`` from the raw ring state: ``s, y [B, m, n]``,
    ``ys [B, m]``, ``theta [B]``, ``ptr, ncorr [B]`` int32, ``sy, yy
    [B, m, m]``, ``rinv [B, m, m]`` (``rinv`` mode only), ``v [B, n]``.
    s and y share one dtype, the others v's; the rows may be stored
    narrower than v (bfloat16 rows of a float32 solve).

    A CPU tensor takes :func:`two_loop_plain`.  A CUDA tensor takes the
    route :func:`route` decides from the dtypes, B, m, n and the plan's
    fit alone: the kernel where it can serve (counted in
    ``two_loop.launches``, and by instantiation in
    ``two_loop.kind_launches``), else the plain version (counted in
    ``two_loop.plain_routes``; ``two_loop.plain_reasons`` by reason).
    Nothing is caught: a kernel that fails to build or launch raises.

    ``group``: the rows and ``v`` are this rank's feature block of a
    feature-split solve; the call takes the plain version with one
    all-reduce (reason ``"sharded"``), as the JAX package turns its Pallas
    kernel off under an axis name (lbfgspp_tpu/ops/fused.py:316-324): the
    kernel fuses the dots that the all-reduce must split."""
    if v.device.type == "cpu":
        return two_loop_plain(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
                              a, mode, group)
    if v.device.type != "cuda":
        raise ValueError(f"two_loop: no kernel for device {v.device}")
    if group is not None:
        two_loop.plain_routes += 1
        two_loop.plain_reasons["sharded"] += 1
        return two_loop_plain(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
                              a, mode, group)
    plan, reason = route(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, mode)
    if plan is None:
        two_loop.plain_routes += 1
        two_loop.plain_reasons[reason] += 1
        return two_loop_plain(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v,
                              a, mode)
    return _two_loop_cuda(s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v, a,
                          mode, plan)


def with_counts(fn):
    """``fn`` with :func:`two_loop`'s launch and route counts, all zero.
    The wrapper counts on whatever ``fused.two_loop`` is bound to, so a
    stand-in for it (``tools/capture.py``) carries them too."""
    fn.launches = fn.plain_routes = 0
    fn.kind_launches = collections.Counter()
    fn.plain_reasons = collections.Counter()
    return fn


def reset_counts() -> None:
    """Set :func:`two_loop`'s launch and route counts to zero."""
    with_counts(two_loop)


reset_counts()


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
                              mode, kinds=[k for k, name in KINDS.items()
                                           if name in ("f32", "f64")])
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
