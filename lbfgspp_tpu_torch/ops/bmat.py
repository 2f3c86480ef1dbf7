"""The compact-form BFGS matrix of L-BFGS-B, batched: ``B = theta*I - W M
W'`` with ``W = [Y, theta*S]``.

The port's counterpart of ``lbfgspp_tpu.ops.bmat`` (the L-BFGS-B half of
LBFGS++'s ``BFGSMat``, BFGSMat.h:99-615).  On top of the batched ring
history of :mod:`.history`, each instance keeps the 2m x 2m middle matrix

    Minv = [ -D   L'          ]
           [  L   theta * S'S ]

(S'S stored unscaled, identity at unused slots), updated on every accepted
correction, and its inverse ``M``, materialized densely once per update
(``mdense``) so that the Cauchy point and the subspace step apply ``M v``
as one small matvec.  Vectors in W space are ``[B, 2m]`` in slot layout
``[y-part; s-part]``, which is the reference's identity-padded layout, and
index sets are ``[B, n]`` boolean masks, as in the JAX package.

The middle-matrix systems are solved by Gauss-Jordan elimination with
partial pivoting (``middle_solve="gj"``, the default) or by the
reference's Bunch-Kaufman LDL' (``"bkldlt"``, :mod:`.bkldlt`).  A zero
pivot latches ``info`` (per instance) for the history's lifetime; a matrix
reset clears it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import bkldlt
from .fused import _matvec
from ..parallel import collectives as coll
from .history import (LBFGSHistory, _write_correction, full_precision,
                      correction_products, init_history)
from ..types import resolve_device

Tensor = torch.Tensor

# The default of ``middle_solve`` where a call leaves it None
# (lbfgspp_tpu/ops/bmat.py:85-95): Gauss-Jordan.
USE_BKLDLT = False

#: Valid values of the ``middle_solve`` option.
MIDDLE_SOLVES = ("gj", "bkldlt")


class BHistory(NamedTuple):
    """Batched L-BFGS-B matrix state: the ring history, the middle matrix
    and its inverse."""

    base: LBFGSHistory
    minv: Tensor     # [B, 2m, 2m] middle matrix, S'S block unscaled
    mdense: Tensor   # [B, 2m, 2m] inverse of the theta-scaled minv (M)
    info: Tensor     # [B] int32, latched: > 0 once a factorization of
                     # this history met a zero pivot (BKLDLT.h:15-20)

    @property
    def m(self) -> int:
        return self.base.m

    @property
    def theta(self) -> Tensor:
        return self.base.theta


def resolve_middle_solve(middle_solve) -> str:
    """The solve a call uses: its ``middle_solve``, or the module default
    when it is None."""
    if middle_solve is None:
        return "bkldlt" if USE_BKLDLT else "gj"
    if middle_solve not in MIDDLE_SOLVES:
        raise ValueError(f"middle_solve must be one of {MIDDLE_SOLVES}, "
                         f"got {middle_solve!r}")
    return middle_solve


def _dense_inv(a: Tensor):
    """Inverses of the small matrices ``a [B, N, N]`` by Gauss-Jordan
    elimination with partial pivoting, N steps unrolled
    (lbfgspp_tpu/ops/bmat.py:110-153).  Returns ``(inv, info)``, ``info``
    [B] int32 set where a pivot was zero (it is replaced by 1).

    The pivot is the first row of largest magnitude at or below the
    diagonal (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does), and rows are swapped by selects, not gathers, so
    ties and zero pivots go exactly as in the JAX package."""
    batch, n, _ = a.shape
    dtype, dev = a.dtype, a.device
    rows = torch.arange(n, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev).expand(batch, n, n)
    aug = torch.cat([a, eye], dim=2)                  # [B, N, 2N]
    bad = torch.zeros(batch, dtype=torch.bool, device=dev)
    for k in range(n):
        col = torch.where(rows >= k, aug[:, :, k].abs(), -1.0)
        p = torch.argmax(col, dim=1)
        ep = (rows[None, :] == p[:, None])[:, :, None]
        ek = (rows == k)[None, :, None]
        rowk = aug[:, k]
        rowp = torch.where(ep, aug, 0.0).sum(dim=1)
        aug = torch.where(ek, rowp[:, None, :],
                          torch.where(ep, rowk[:, None, :], aug))
        piv = rowp[:, k]
        zero = piv == 0.0
        bad = bad | zero
        piv = torch.where(zero, 1.0, piv)
        newk = aug[:, k] / piv[:, None]
        factors = torch.where(rows == k, 0.0, aug[:, :, k])
        aug = torch.where(ek, newk[:, None, :],
                          aug - factors[:, :, None] * newk[:, None, :])
    return aug[:, :, n:], bad.to(torch.int32)


def _sym_solve(a: Tensor, b: Tensor, middle_solve=None):
    """Solve ``a x = b`` for the symmetric (possibly indefinite) middle
    matrices ``a [B, N, N]``, ``b`` [B, N] or [B, N, K]
    (lbfgspp_tpu/ops/bmat.py:156-170).  Returns ``(x, info)``."""
    if resolve_middle_solve(middle_solve) == "bkldlt":
        fac = bkldlt.compute(a)
        return bkldlt.solve(fac, b), fac.info
    inv, info = _dense_inv(a)
    x = _matvec(inv, b) if b.dim() == 2 else inv @ b
    return x, info


def _factor_minv(minv: Tensor, theta: Tensor, m: int, middle_solve=None):
    """``(mdense, info)``: the inverse of the middle matrix with only its
    S'S block scaled by theta (BFGSMat.h:143-145;
    lbfgspp_tpu/ops/bmat.py:173-188)."""
    sel = torch.arange(2 * m, device=minv.device) >= m
    block = sel[:, None] & sel[None, :]
    scaled = torch.where(block, minv * theta[:, None, None], minv)
    eye = torch.eye(2 * m, dtype=minv.dtype, device=minv.device)
    return _sym_solve(scaled, eye.expand_as(minv), middle_solve)


def init_b_history(batch: int, n: int, m: int, dtype=torch.float32, *,
                   device=None) -> BHistory:
    """Fresh state for ``batch`` instances (BFGSMat::reset with
    LBFGSB=true, BFGSMat.h:61-78): ``minv`` is the identity, and so is
    ``mdense`` (both solves return the identity's inverse exactly: every
    pivot is 1 and every elimination factor 0), with ``info`` 0."""
    device = resolve_device(device)
    base = init_history(batch, n, m, dtype, device=device)
    eye = torch.eye(2 * m, dtype=dtype, device=device).expand(
        batch, 2 * m, 2 * m)
    return BHistory(base=base, minv=eye.clone(), mdense=eye.clone(),
                    info=torch.zeros(batch, dtype=torch.int32,
                                     device=device))


def add_correction_b(bh: BHistory, s: Tensor, y: Tensor, accept: Tensor,
                     middle_solve=None, group=None) -> BHistory:
    """Masked correction update, middle matrix included
    (BFGSMat::add_correction, B branch, BFGSMat.h:81-147)."""
    yx, sx, pair, _ = correction_products(bh.base, s, y, group)
    return _finish_correction_b(bh, s, y, accept, yx, sx, pair,
                                middle_solve)


def update_history_b(bh: BHistory, s: Tensor, y: Tensor, allow: Tensor,
                     middle_solve=None, group=None, products=None):
    """The curvature gate ``s'y > eps * y'y`` (LBFGSB.h:237) under
    ``allow``, and the write.  Returns ``(new_history, accept)``.
    ``products`` as in :func:`.history.update_history`."""
    eps = torch.finfo(s.dtype).eps
    if products is None:
        products = correction_products(bh.base, s, y, group)[:3]
    yx, sx, pair = products
    sy_new, yy_new, _ = pair
    accept = allow & (sy_new > eps * yy_new)
    return _finish_correction_b(bh, s, y, accept, yx, sx, pair,
                                middle_solve), accept


def _finish_correction_b(bh: BHistory, s: Tensor, y: Tensor, accept: Tensor,
                         yx: Tensor, sx: Tensor, pair,
                         middle_solve=None) -> BHistory:
    """The ring write and the middle matrix's masked updates
    (lbfgspp_tpu/ops/bmat.py:255-332), then the refactorization.  Every
    write is a select over the [2m, 2m] slots, with the values the
    reference writes in place (BFGSMat.h:99-146)."""
    m = bh.m
    dev = s.device
    loc = bh.base.ptr % m                                    # [B]
    base = _write_correction(bh.base, s, y, accept, yx, sx, pair)
    new_ncorr = base.ncorr
    ys_new, _, ss_new = pair

    slots = torch.arange(m, device=dev)
    at_loc = slots[None, :] == loc[:, None]                  # [B, m]
    ss_all = torch.where(at_loc, ss_new[:, None], sx[:, :, 1])   # s_j . s
    sy_all = torch.where(at_loc, ys_new[:, None], yx[:, :, 1])   # y_j . s
    valid = slots[None, :] < new_ncorr[:, None]
    none = torch.zeros_like(at_loc)
    e_top = torch.cat([at_loc, none], dim=1)                 # slot loc
    e_bot = torch.cat([none, at_loc], dim=1)                 # slot m + loc
    top_half = torch.arange(2 * m, device=dev) < m
    valid_bot = torch.cat([none, valid], dim=1)
    acc = accept[:, None, None]

    def outer(a, b):
        return a[:, :, None] & b[:, None, :]

    minv = bh.minv
    # the -D block's diagonal entry (BFGSMat.h:107)
    minv = torch.where(acc & outer(e_top, e_top), -ys_new[:, None, None],
                       minv)
    # row and column m + loc of the S'S block over the valid slots
    # (BFGSMat.h:111-113)
    ss2 = torch.cat([ss_all, ss_all], dim=1)
    minv = torch.where(acc & outer(e_bot, valid_bot), ss2[:, None, :], minv)
    minv = torch.where(acc & outer(valid_bot, e_bot), ss2[:, :, None], minv)
    # a full ring's overwritten y column keeps stale L entries: zero it
    # and its mirror row (the setZero at BFGSMat.h:129-130)
    stale = (accept & (new_ncorr == m))[:, None, None]
    bottom = (~top_half)[None, :].expand_as(e_top)
    minv = torch.where(stale & outer(bottom, e_top), 0.0, minv)
    minv = torch.where(stale & outer(e_top, bottom), 0.0, minv)
    # the L row of the new s: ring distances 1..ncorr-1 (BFGSMat.h:115-140)
    dist = (loc[:, None] - slots[None, :]) % m
    in_window = (dist >= 1) & (dist <= new_ncorr[:, None] - 1)
    l_row = torch.where(in_window, sy_all, 0.0)
    l2 = torch.cat([l_row, l_row], dim=1)
    top = top_half[None, :].expand_as(e_top)
    minv = torch.where(acc & outer(e_bot, top), l2[:, None, :], minv)
    minv = torch.where(acc & outer(top, e_bot), l2[:, :, None], minv)

    mdense, info = _factor_minv(minv, base.theta, m, middle_solve)
    return BHistory(base=base, minv=minv, mdense=mdense,
                    info=torch.maximum(bh.info, info))


# The W/M operator family (BFGSMat.h:304-615); [B, 2m] vectors in slot
# layout [y-part; s-part], zero at invalid slots.

def _theta_s(bh: BHistory, v2m: Tensor) -> Tensor:
    """``v2m`` with its s-part scaled by theta."""
    m = bh.m
    return torch.cat([v2m[:, :m], v2m[:, m:] * bh.theta[:, None]], dim=1)


@full_precision()
def apply_wtv(bh: BHistory, v: Tensor, group=None,
              site: str = "bmat.apply_wtv") -> Tensor:
    """``W'v``, ``[B, n] -> [B, 2m]`` (BFGSMat::apply_Wtv,
    BFGSMat.h:315-320); under ``group`` the 2m local dots take one
    all-reduce, before the theta scaling."""
    yv, sv = _matvec(bh.base.y, v), _matvec(bh.base.s, v)
    if group is not None:
        yv, sv = coll.pfused([yv, sv], group, site)
    return torch.cat([yv, sv * bh.theta[:, None]], dim=1)


def apply_mv(bh: BHistory, v2m: Tensor) -> Tensor:
    """``M v`` (BFGSMat::apply_Mv, BFGSMat.h:361-376)."""
    return _matvec(bh.mdense, v2m)


@full_precision()
def w_matvec(bh: BHistory, v2m: Tensor) -> Tensor:
    """``W v2m``, ``[B, 2m] -> [B, n]``."""
    m = bh.m
    return _matvec(bh.base.y.transpose(1, 2), v2m[:, :m]) + \
        _matvec(bh.base.s.transpose(1, 2), v2m[:, m:] * bh.theta[:, None])


def apply_wtpv(bh: BHistory, mask: Tensor, v: Tensor, group=None,
               site: str = "bmat.apply_wtpv") -> Tensor:
    """``W'(P v)``, P the coordinates in ``mask`` (BFGSMat::apply_WtPv,
    BFGSMat.h:382-430)."""
    return apply_wtv(bh, torch.where(mask, v, 0.0), group, site)


def apply_ptwmv(bh: BHistory, mask: Tensor, v2m: Tensor,
                scale: float) -> Tensor:
    """``scale * P'(W M v2m)``, zero off ``mask`` (BFGSMat::apply_PtWMv,
    BFGSMat.h:435-478)."""
    res = w_matvec(bh, apply_mv(bh, v2m))
    return torch.where(mask, scale * res, 0.0)


def compute_ftbab(bh: BHistory, free_mask: Tensor, act_mask: Tensor,
                  wd: Tensor, drt: Tensor, group=None) -> Tensor:
    """``F'BAb = -(F'W) M (W'AA'd)`` (BFGSMat::compute_FtBAb,
    BFGSMat.h:486-522), A the newly active and F the free coordinates."""
    rhs = apply_wtpv(bh, act_mask, drt, group, "bmat.compute_ftbab")
    return apply_ptwmv(bh, free_mask, rhs, -1.0)


@full_precision()
def solve_ptbp(bh: BHistory, mask: Tensor, v: Tensor, middle_solve=None,
               group=None, site: str = "bmat.solve_ptbp"):
    """``inv(P'BP) v`` on the masked coordinates (BFGSMat::solve_PtBP,
    BFGSMat.h:529-565)::

        inv(P'BP) v = v/theta + WP inv(inv(M) - WP'WP/theta) WP' v / theta^2

    with a fresh factorization of the 2m x 2m system per call.  Returns
    ``(res, info)``, ``res`` zero off ``mask``.  Under ``group`` the Gram
    ``WP'WP`` and ``WP'v`` (lbfgspp_tpu/ops/bmat.py:380, :390) ride one
    all-reduce."""
    m = bh.m
    theta = bh.theta
    th = theta[:, None, None]
    ym = torch.where(mask[:, None, :], bh.base.y, 0.0)
    sm = torch.where(mask[:, None, :], bh.base.s, 0.0)
    stacked = torch.cat([ym, sm], dim=1)                     # [B, 2m, n]
    gram = stacked @ stacked.transpose(1, 2)
    wpv = _matvec(stacked, torch.where(mask, v, 0.0))
    if group is not None:
        gram, wpv = coll.pfused([gram, wpv], group, site)
    g_yy = gram[:, :m, :m]
    g_sy = gram[:, m:, :m]
    g_ss = gram[:, m:, m:]
    minv = bh.minv
    mid_tl = minv[:, :m, :m] - g_yy / th
    mid_bl = minv[:, m:, :m] - g_sy
    mid_br = th * (minv[:, m:, m:] - g_ss)
    mid = torch.cat([torch.cat([mid_tl, mid_bl.transpose(1, 2)], dim=2),
                     torch.cat([mid_bl, mid_br], dim=2)], dim=1)
    wpv = _theta_s(bh, wpv)
    z, info = _sym_solve(mid, wpv, middle_solve)
    z = _theta_s(bh, z)
    # WP z with the raw S rows: theta rides in z's s-part (BFGSMat.h:540,
    # :560-564)
    wz = _matvec(bh.base.y.transpose(1, 2), z[:, :m]) + \
        _matvec(bh.base.s.transpose(1, 2), z[:, m:])
    res = v / theta[:, None] + wz / (theta * theta)[:, None]
    return torch.where(mask, res, 0.0), info


def apply_ptbqv(bh: BHistory, p_mask: Tensor, q_mask: Tensor,
                v: Tensor, group=None,
                site: str = "bmat.apply_ptbqv") -> Tensor:
    """``P'BQv = -WP M WQ' v`` for disjoint P and Q
    (BFGSMat::apply_PtBQv, BFGSMat.h:570-615)."""
    res = w_matvec(bh, apply_mv(bh, apply_wtpv(bh, q_mask, v, group, site)))
    return torch.where(p_mask, -res, 0.0)


def w_rows(bh: BHistory) -> Tensor:
    """Every coordinate's row of W, ``[B, n, 2m]`` (``Wb``,
    BFGSMat.h:325-335)."""
    return torch.cat([bh.base.y.transpose(1, 2),
                      bh.base.s.transpose(1, 2) * bh.theta[:, None, None]],
                     dim=2)


def w_columns(bh: BHistory, idx: Tensor) -> Tensor:
    """The rows of W at the coordinates ``idx [B, k]``, ``[B, k, 2m]``
    (``Wb``, BFGSMat.h:325-335)."""
    m = bh.m
    cols = idx[:, None, :].expand(-1, m, -1)
    ycols = bh.base.y.gather(2, cols).transpose(1, 2)
    scols = bh.base.s.gather(2, cols).transpose(1, 2) * \
        bh.theta[:, None, None]
    return torch.cat([ycols, scols], dim=2)
