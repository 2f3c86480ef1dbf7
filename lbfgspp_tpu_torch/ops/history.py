"""L-BFGS correction history, batched: the implicit inverse-Hessian operator.

The port's counterpart of ``lbfgspp_tpu.ops.history`` (itself a re-design
of LBFGS++'s ``BFGSMat``, BFGSMat.h).  The JAX package keeps one instance's
history and ``vmap``s it; here every field carries the leading batch axis
``B`` and each instance has its own ring pointer and fill level.  Writes go
through slot masks (``torch.where`` over the slot axis), the batched form of
the JAX package's ``_masked_row_write`` vmap rule (history.py:171-180).

Products are taken in full float32 on the card:
``torch.backends.cuda.matmul.allow_tf32`` is switched off around them and
the caller's value restored after (the JAX package pins
``Precision.HIGHEST`` on these einsums only, history.py:121, :330).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import fused
from ..parallel import collectives as coll
from ..types import matmul_tf32, resolve_device

Tensor = torch.Tensor


class LBFGSHistory(NamedTuple):
    """Batched implicit BFGS matrix state (BFGSMat.h:35-48) with the
    slot-ordered Gram caches ``sy[i, j] = s_i . y_j`` and ``yy[i, j] =
    y_i . y_j`` and, for ``tri="rinv"``, the incrementally maintained
    ``R^{-1}`` (R = age-ordered ``triu(S'Y)``)."""

    s: Tensor       # [B, m, n] correction s-vectors (rows, ring order)
    y: Tensor       # [B, m, n]
    ys: Tensor      # [B, m]    s'y per slot
    theta: Tensor   # [B]       B0 = theta * I scaling
    ncorr: Tensor   # [B] int32, valid corrections (<= m)
    ptr: Tensor     # [B] int32, ring pointer in [1, m], init m
    sy: Tensor      # [B, m, m]
    yy: Tensor      # [B, m, m]
    rinv: Optional[Tensor] = None   # [B, m, m] or None (not maintained)

    @property
    def m(self) -> int:
        return self.s.shape[1]


def full_precision():
    """No TF32 in the history's own products (the JAX package's
    HIGHEST), the caller's setting restored after."""
    return matmul_tf32(False)


def init_history(batch: int, n: int, m: int, dtype=torch.float32, *,
                 store_dtype=None, device=None,
                 with_rinv: bool = False) -> LBFGSHistory:
    """Fresh history for ``batch`` instances (BFGSMat::reset,
    BFGSMat.h:61-78): ``ptr = m`` so the first write lands in slot 0.

    ``store_dtype`` (such as ``torch.bfloat16``) stores the s and y rows
    at reduced precision while every product, Gram and coefficient stays
    in ``dtype`` (lbfgspp_tpu/ops/history.py:81-104): the gate, theta and
    the Grams come from the full-precision incoming pair, so only the
    direction's combine sees the rounding."""
    device = resolve_device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    rows = dtype if store_dtype is None else store_dtype
    return LBFGSHistory(
        s=z(batch, m, n, dt=rows), y=z(batch, m, n, dt=rows), ys=z(batch, m),
        theta=torch.ones(batch, dtype=dtype, device=device),
        ncorr=torch.zeros(batch, dtype=torch.int32, device=device),
        ptr=torch.full((batch,), m, dtype=torch.int32, device=device),
        sy=z(batch, m, m), yy=z(batch, m, m),
        rinv=z(batch, m, m) if with_rinv else None)


@full_precision()
def correction_products(hist: LBFGSHistory, s: Tensor, y: Tensor,
                        group=None, extra: Optional[Tensor] = None):
    """Every inner product a correction update needs, batched.

    Returns ``(yx, sx, pair, extra)``: ``yx = [Y@y, Y@s]`` and ``sx =
    [S@y, S@s]`` (each [B, m, 2]) and ``pair = (s.y, y.y, s.s)`` (each
    [B]), in the incoming pair's dtype; the new pair's products use the
    full-precision
    s and y, and rows stored at reduced precision are widened in chunks
    along n (no widened copy of the whole history; the JAX package splits
    its product at n >= 2^20 for the same reason).  Three
    batched products instead of one over a concatenated [B, 2m+2, n]
    operand: the same dots, without copying the history every iteration
    (the JAX package takes this form for n >= 2^20, history.py:122-136).

    ``group``: the rows, s and y are this rank's feature block; the three
    products and the caller's ``extra`` local sums ([B, k], or None) ride
    ONE all-reduce, the fused ``[2m+2, 2]`` product of
    lbfgspp_tpu/ops/history.py:137-138 (XLA folds the convergence norms
    into it as well).  ``extra`` comes back summed.
    """
    rhs = torch.stack([y, s], dim=1)                 # [B, 2, n]
    rt = rhs.transpose(1, 2)                         # [B, n, 2]
    yx = fused.rows_times(hist.y, rt)
    sx = fused.rows_times(hist.s, rt)
    pp = torch.bmm(rhs, rt)                          # [B, 2, 2]
    if group is not None:
        parts = [yx, sx, pp] + ([] if extra is None else [extra])
        yx, sx, pp, *rest = coll.pfused(parts, group, "history.products")
        extra = rest[0] if rest else None
    return yx, sx, (pp[:, 1, 0], pp[:, 0, 0], pp[:, 1, 1]), extra


def _write_correction(hist: LBFGSHistory, s: Tensor, y: Tensor,
                      accept: Tensor, yx: Tensor, sx: Tensor,
                      pair) -> LBFGSHistory:
    """Masked ring-buffer write given precomputed products
    (lbfgspp_tpu/ops/history.py:183-247), per instance."""
    m = hist.m
    loc = hist.ptr % m                               # [B]
    ys, yy_new, _ = pair
    slots = torch.arange(m, device=s.device)
    is_loc = slots[None, :] == loc[:, None]          # [B, m]
    write = accept[:, None] & is_loc                 # [B, m]

    new_s = torch.where(write[:, :, None], s[:, None, :].to(hist.s.dtype),
                        hist.s)
    new_y = torch.where(write[:, :, None], y[:, None, :].to(hist.y.dtype),
                        hist.y)
    new_ys = torch.where(write, ys[:, None], hist.ys)
    new_theta = torch.where(accept, yy_new / ys, hist.theta)
    new_ncorr = torch.where(accept, torch.clamp(hist.ncorr + 1, max=m),
                            hist.ncorr)
    new_ptr = torch.where(accept, (loc + 1).to(torch.int32), hist.ptr)

    # Gram updates (slot order): row loc = <new vec, old slots>, column
    # loc = <old slots, new vec>, with the new-pair products at the
    # crossing.
    sy_row = torch.where(is_loc, ys[:, None], yx[:, :, 1])      # s_new.y_j
    sy_col = torch.where(is_loc, ys[:, None], sx[:, :, 0])      # s_i.y_new
    yy_row = torch.where(is_loc, yy_new[:, None], yx[:, :, 0])  # y_new.y_j
    new_sy = torch.where(write[:, :, None], sy_row[:, None, :], hist.sy)
    new_sy = torch.where(write[:, None, :], sy_col[:, :, None], new_sy)
    new_yy = torch.where(write[:, :, None], yy_row[:, None, :], hist.yy)
    new_yy = torch.where(write[:, None, :], yy_row[:, :, None], new_yy)

    new_rinv = hist.rinv
    if hist.rinv is not None:
        # Incremental R^{-1}: replacing the oldest correction (slot loc)
        # by the newest is "drop first row/col, append last row/col" in
        # age order: zero row/col loc, then the new column is
        # -Rinv22 c / d with c_i = s_i . y_new and d = s_new . y_new.
        # The validity mask is over the PRE-WRITE ring, so stale slot data
        # left by a soft reset (ncorr = 0) cannot leak into the column.
        dist = (hist.ptr[:, None] - 1 - slots) % m
        valid = dist < hist.ncorr[:, None]
        live = valid & ~is_loc
        rz = torch.where(live[:, :, None] & live[:, None, :], hist.rinv, 0.0)
        c_vec = torch.where(live, sx[:, :, 0], 0.0)
        d_safe = torch.where(ys != 0, ys, 1.0)
        col = -fused._matvec(rz, c_vec) / d_safe[:, None]
        col = torch.where(is_loc, (1.0 / d_safe)[:, None], col)
        cand = torch.where(is_loc[:, None, :], col[:, :, None], rz)
        new_rinv = torch.where(accept[:, None, None], cand, hist.rinv)

    return LBFGSHistory(new_s, new_y, new_ys, new_theta, new_ncorr, new_ptr,
                        new_sy, new_yy, new_rinv)


def add_correction(hist: LBFGSHistory, s: Tensor, y: Tensor,
                   accept: Tensor, group=None) -> LBFGSHistory:
    """Masked write of one correction pair per instance
    (BFGSMat::add_correction, BFGSMat.h:81-97); an instance whose
    ``accept`` is False keeps its state unchanged."""
    yx, sx, pair, _ = correction_products(hist, s, y, group)
    return _write_correction(hist, s, y, accept, yx, sx, pair)


def update_history(hist: LBFGSHistory, s: Tensor, y: Tensor,
                   allow: Tensor, group=None, products=None):
    """Curvature gate ``s'y > eps * y'y`` (LBFGS.h:161) under the caller's
    ``allow`` mask, plus the write.  Returns ``(new_hist, accept)``.
    ``products``: ``(yx, sx, pair)`` of :func:`correction_products` when
    the caller took them already (to fold its own sums into their
    all-reduce)."""
    eps = torch.finfo(s.dtype).eps
    if products is None:
        products = correction_products(hist, s, y, group)[:3]
    yx, sx, pair = products
    sy_new, yy_new, _ = pair
    accept = allow & (sy_new > eps * yy_new)
    return _write_correction(hist, s, y, accept, yx, sx, pair), accept


def apply_hv(hist: LBFGSHistory, v: Tensor, a: float,
             tri: str = "sweeps", group=None) -> Tensor:
    """Two-loop recursion ``a * H * v`` for every instance (BFGSMat.h:
    276-302), in the compact Gram-cached form of
    lbfgspp_tpu/ops/history.py:289-418.

    ``tri`` selects the triangular-solve schedule: ``"sweeps"`` (m masked
    Jacobi sweeps, the bit-parity default) and ``"rinv"`` (the maintained
    ``R^{-1}`` factor) go through :func:`.fused.two_loop`, which launches
    the CUDA kernel for a CUDA tensor; ``"doubling"`` (repeated squaring
    of the nilpotent series) stays plain PyTorch, as the TPU kernel never
    computed it.

    ``group``: the rows and ``v`` are this rank's feature block; the local
    ``S v`` and ``Y v`` take ONE all-reduce of ``[B, 2m]`` and the
    recursion and the combine run on the replicated coefficients
    (lbfgspp_tpu/ops/history.py:324-337), never in the kernel.
    """
    if tri in ("sweeps", "rinv"):
        if tri == "rinv" and hist.rinv is None:
            raise ValueError("tri='rinv' needs a history built with "
                             "init_history(with_rinv=True)")
        return fused.two_loop(hist.s, hist.y, hist.ys, hist.theta, hist.ptr,
                              hist.ncorr, hist.sy, hist.yy, hist.rinv, v,
                              a, tri, group)
    if tri != "doubling":
        raise ValueError(f"tri must be 'sweeps', 'rinv' or 'doubling', got "
                         f"{tri!r}")
    with full_precision():
        m = hist.m
        th = hist.theta[:, None]
        msy, msyT, ys_safe, vmask, valid = fused._prep_masks(
            hist.ys, hist.ptr, hist.ncorr, hist.sy, v.dtype)
        sv = fused.rows_dot(hist.s, v)
        yv = fused.rows_dot(hist.y, v)
        if group is not None:
            sv, yv = coll.pfused([sv, yv], group, "history.apply_hv")
        n_steps = max(1, (m - 1).bit_length())

        def tri_solve(nmat, rhs):
            b_mat = -(nmat / ys_safe[:, :, None])
            x = vmask * rhs / ys_safe
            for _ in range(n_steps):
                x = x + fused._matvec(b_mat, x)
                b_mat = b_mat @ b_mat
            return vmask * x

        alpha = tri_solve(msy, a * sv)
        base = (a * yv - fused._matvec(hist.yy, alpha)) / th
        beta = tri_solve(msyT, base + fused._matvec(msyT, alpha))
        return fused.combine(hist.s, hist.y, v, alpha, beta, valid,
                             hist.theta, a)


def apply_hv_reference(hist: LBFGSHistory, v: Tensor, a: float) -> Tensor:
    """The literal sequential two-loop (BFGSMat.h:276-302), batched: the
    semantics oracle for :func:`apply_hv`."""
    m = hist.m
    rows = torch.arange(v.shape[0], device=v.device)
    res = a * v
    alphas, saved = [], []
    for i in range(m):
        j = ((hist.ptr - 1 - i) % m).long()
        active = i < hist.ncorr
        sj, yj = hist.s[rows, j].to(v.dtype), hist.y[rows, j].to(v.dtype)
        ysj = hist.ys[rows, j]
        ysj_safe = torch.where(active, ysj, 1.0)
        alpha = torch.where(active, torch.linalg.vecdot(sj, res) / ysj_safe,
                            0.0)
        res = res - alpha[:, None] * yj
        alphas.append(alpha)
        saved.append((sj, yj, ysj_safe, active))
    res = res / hist.theta[:, None]
    for i in reversed(range(m)):
        sj, yj, ysj_safe, active = saved[i]
        beta = torch.where(active, torch.linalg.vecdot(yj, res) / ysj_safe,
                           0.0)
        res = res + (alphas[i] - beta)[:, None] * sj
    return res


def rinv_from_grams(hist: LBFGSHistory) -> Tensor:
    """The slot-order ``R^{-1}`` rebuilt from the cached Gram ``sy`` alone
    (lbfgspp_tpu/ops/history.py:455-484): the nilpotent Neumann series
    ``sum_k (-D^{-1} N)^k D^{-1}`` by repeated squaring."""
    m = hist.m
    slots = torch.arange(m, device=hist.sy.device)
    dist = (hist.ptr[:, None] - 1 - slots) % m
    valid = dist < hist.ncorr[:, None]
    pair_valid = valid[:, :, None] & valid[:, None, :]
    ys_safe = torch.where(valid, hist.ys, 1.0)
    # strictly older: row i older than column j (dist_i > dist_j)
    n_strict = torch.where(pair_valid & (dist[:, :, None] > dist[:, None, :]),
                           hist.sy, 0.0)
    b = -(n_strict / ys_safe[:, :, None])
    acc = torch.eye(m, dtype=hist.sy.dtype,
                    device=hist.sy.device).expand_as(b)
    for _ in range(max(1, (m - 1).bit_length())):
        acc = acc + b @ acc
        b = b @ b
    rinv = acc / ys_safe[:, None, :]
    return torch.where(pair_valid, rinv, 0.0)


def _w_matrices(hist: LBFGSHistory):
    """``(Y_age, S_age [B, m, n], valid [B, m])``: the rows in oldest-to-
    newest order (BFGSMat.h:166-172), zero past each instance's fill
    level (lbfgspp_tpu/ops/history.py:487-505)."""
    m = hist.m
    i = torch.arange(m, device=hist.s.device)
    idx = (hist.ptr[:, None] - hist.ncorr[:, None] + i) % m
    valid = i[None, :] < hist.ncorr[:, None]
    rows = idx.long()[:, :, None].expand(-1, -1, hist.s.shape[2])
    y_age = torch.where(valid[:, :, None], hist.y.gather(1, rows), 0.0)
    s_age = torch.where(valid[:, :, None], hist.s.gather(1, rows), 0.0)
    return y_age, s_age, valid


def _blocks(tl: Tensor, tr: Tensor, bl: Tensor, br: Tensor) -> Tensor:
    """``[[tl, tr], [bl, br]]`` of batched blocks."""
    return torch.cat([torch.cat([tl, tr], dim=2), torch.cat([bl, br], dim=2)],
                     dim=1)


@full_precision()
def bmat(hist: LBFGSHistory) -> Tensor:
    """Dense ``B = theta*I - W Minv^{-1} W'`` with ``W = [Y, theta*S]``,
    ``[B, n, n]`` (BFGSMat::get_Bmat, BFGSMat.h:150-208;
    lbfgspp_tpu/ops/history.py:508-536).  Unused slots add zero columns to
    W and identity rows and columns to ``Minv``, so the result is exact at
    any fill level."""
    m = hist.m
    n = hist.s.shape[2]
    dtype, dev = hist.s.dtype, hist.s.device
    y_age, s_age, valid = _w_matrices(hist)
    theta = hist.theta[:, None, None]
    sy = s_age @ y_age.transpose(1, 2)            # sy[i, j] = s_i . y_j
    ss = s_age @ s_age.transpose(1, 2)
    d = torch.diag_embed(torch.diagonal(sy, dim1=1, dim2=2))
    l_mat = torch.tril(sy, diagonal=-1)
    pair = valid[:, :, None] & valid[:, None, :]
    minv = _blocks(-d, l_mat.transpose(1, 2), l_mat, theta * ss)
    vmask = _blocks(pair, pair, pair, pair)
    minv = torch.where(vmask, minv, torch.eye(2 * m, dtype=dtype, device=dev))
    w = torch.cat([y_age, theta * s_age], dim=1)  # [B, 2m, n]
    mid = torch.linalg.solve(minv, w)
    return theta * torch.eye(n, dtype=dtype, device=dev) - \
        w.transpose(1, 2) @ mid


@full_precision()
def hmat(hist: LBFGSHistory) -> Tensor:
    """Dense ``H = I/theta + W M W'`` with ``W = [Y/theta, S]``,
    ``[B, n, n]`` (BFGSMat::get_Hmat, BFGSMat.h:211-271;
    lbfgspp_tpu/ops/history.py:539-569): the Byrd-Nocedal-Schnabel form
    with ``M = [[0, -R^{-1}], [-R^{-T}, R^{-T}(D + Y'Y/theta)R^{-1}]]``,
    ``R`` the age-ordered upper triangle of ``S'Y``."""
    m = hist.m
    n = hist.s.shape[2]
    dtype, dev = hist.s.dtype, hist.s.device
    y_age, s_age, valid = _w_matrices(hist)
    theta = hist.theta[:, None, None]
    eye_m = torch.eye(m, dtype=dtype, device=dev)
    sy = s_age @ y_age.transpose(1, 2)
    # Unused diagonal entries are 1, so R stays invertible; their rows and
    # columns meet zero W columns.
    r = torch.where(valid[:, :, None] & valid[:, None, :], torch.triu(sy),
                    eye_m)
    rinv = torch.linalg.solve_triangular(r, eye_m.expand_as(r).contiguous(),
                                         upper=True)
    yy = y_age @ y_age.transpose(1, 2)
    block = yy / theta + torch.diag_embed(torch.diagonal(sy, dim1=1, dim2=2))
    br = rinv.transpose(1, 2) @ block @ rinv
    mmat = _blocks(torch.zeros_like(rinv), -rinv, -rinv.transpose(1, 2), br)
    w = torch.cat([y_age / theta, s_age], dim=1)  # [B, 2m, n]
    return torch.eye(n, dtype=dtype, device=dev) / theta + \
        w.transpose(1, 2) @ (mmat @ w)
