"""Bunch-Kaufman LDL' of small symmetric (possibly indefinite) matrices,
batched.

The port's counterpart of ``lbfgspp_tpu.ops.bkldlt`` (LBFGS++'s
``BKLDLT``, BKLDLT.h): 1x1 and 2x2 diagonal pivots chosen by the
``alpha = (1 + sqrt(17)) / 8`` test cascade (BKLDLT.h:233-299, :406), used
for the 2m x 2m middle-matrix systems of L-BFGS-B behind
``middle_solve="bkldlt"``.  As in the JAX package the storage is dense
([N, N] per instance: L below the diagonal of each pivot column, the
inverted D blocks on it), the permutation is the reference's ``m_perm``
(entry k: the row interchanged with k) and a pivot-type vector (1: 1x1,
2: head of a 2x2, 0: its tail) replaces the reference's negative indices.

Each of the N static steps chooses its pivot per instance: the
interchanges, the 1x1, 2x2 and last-step eliminations are computed for
the whole batch and selected per instance, which is what ``vmap`` of the
JAX ``lax.cond`` chain computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

SUCCESSFUL = 0
NUMERICAL_ISSUE = 2


class BKFactors(NamedTuple):
    """``P A P' = L D L'`` of every instance."""

    lmat: Tensor    # [B, N, N]
    perm: Tensor    # [B, N] int64: the row interchanged with k at step k
    ptype: Tensor   # [B, N] int8: 1 = 1x1, 2 = 2x2 head, 0 = 2x2 tail
    info: Tensor    # [B] int32 status


def _swap_index(n: int, i, j: Tensor, dev) -> Tensor:
    """Per instance, the index vector that swaps ``i`` and ``j [B]``."""
    idx = torch.arange(n, device=dev)[None, :]
    i = torch.as_tensor(i, device=dev)
    i = i.expand_as(j) if i.dim() == 0 else i
    return torch.where(idx == i[:, None], j[:, None],
                       torch.where(idx == j[:, None], i[:, None], idx))


def _take_rows(a: Tensor, index: Tensor) -> Tensor:
    return a.gather(1, index[:, :, None].expand_as(a))


def _take_cols(a: Tensor, index: Tensor) -> Tensor:
    return a.gather(2, index[:, None, :].expand_as(a))


def _set_col(mat: Tensor, k: int, col: Tensor) -> Tensor:
    out = mat.clone()
    out[:, :, k] = col
    return out


def compute(a: Tensor) -> BKFactors:
    """Factorize the symmetric matrices ``a [B, N, N]`` (BKLDLT::compute,
    BKLDLT.h:390-441; lbfgspp_tpu/ops/bkldlt.py:83-233).  Only the lower
    triangles are read."""
    batch, n, _ = a.shape
    dtype, dev = a.dtype, a.device
    awork = torch.tril(a) + torch.tril(a, diagonal=-1).transpose(1, 2)
    lmat = torch.zeros_like(a)
    perm = torch.arange(n, device=dev).expand(batch, n).clone()
    ptype = torch.ones(batch, n, dtype=torch.int8, device=dev)
    seventeen = torch.tensor(17.0, dtype=dtype)
    alpha = ((1.0 + torch.sqrt(seventeen)) / 8.0).item()
    rows = torch.arange(n, device=dev)
    info = torch.zeros(batch, dtype=torch.int32, device=dev)
    skip = torch.zeros(batch, dtype=torch.bool, device=dev)
    bi = torch.arange(batch, device=dev)
    for k in range(n):
        # Pivot selection (permutate_mat, BKLDLT.h:233-300)
        colk = torch.where(rows >= k + 1, awork[:, :, k], 0.0).abs()
        r = torch.argmax(colk, dim=1)
        lam = colk[bi, r]
        abs_akk = awork[:, k, k].abs()
        # sigma: the largest off-diagonal magnitude in column r of the
        # reduced matrix (find_sigma, BKLDLT.h:207-229)
        col_r = awork[bi, :, r]
        colr = torch.where((rows[None, :] >= k) & (rows[None, :] != r[:, None]),
                           col_r, 0.0).abs()
        sigma = colr.max(dim=1).values
        no_swap = (lam == 0.0) | (abs_akk >= alpha * lam) | \
            (sigma * abs_akk >= alpha * lam * lam)
        swap_1x1 = (~no_swap) & (abs_akk >= alpha * sigma)
        is_2x2 = (~no_swap) & (~swap_1x1)

        # Interchanges: k <-> r for a 1x1 pivot, k+1 <-> r for a 2x2 one
        # (version 1 of the reference, p = k, BKLDLT.h:269-292).  They
        # apply whatever the step's skip flag, as in the JAX package.
        if k + 1 < n:
            lead = torch.where(is_2x2, k + 1, k)
            target = torch.where(swap_1x1 | is_2x2, r, lead)
        else:
            lead = torch.full_like(r, k)
            target = torch.where(swap_1x1, r, lead)
        sw = _swap_index(n, lead, target, dev)
        awork = _take_cols(_take_rows(awork, sw), sw)
        lmat = torch.where(rows[None, None, :] < k, _take_rows(lmat, sw),
                           lmat)
        perm = perm.clone()
        perm[:, k] = torch.where(swap_1x1, r, perm[:, k])
        if k + 1 < n:
            perm[:, k + 1] = torch.where(is_2x2, r, perm[:, k + 1])

        # Eliminations, each for the whole batch, then selected.
        akk = awork[:, k, k]
        bad1 = akk == 0.0
        akk_safe = torch.where(bad1, 1.0, akk)
        if k == n - 1:
            # the trailing 1x1 block (BKLDLT.h:429-436)
            lm = lmat.clone()
            lm[:, k, k] = 1.0 / akk_safe
            run = ~skip
            lmat = torch.where(run[:, None, None], lm, lmat)
            info = torch.where(run & bad1, NUMERICAL_ISSUE, info)
        else:
            l_col = torch.where(rows > k, awork[:, :, k], 0.0)
            aw1 = awork - l_col[:, :, None] * l_col[:, None, :] / \
                akk_safe[:, None, None]
            lm1 = _set_col(lmat, k, torch.where(
                rows > k, l_col / akk_safe[:, None], lmat[:, :, k]))
            lm1[:, k, k] = 1.0 / akk_safe

            e11 = awork[:, k, k]
            e21 = awork[:, k + 1, k]
            e22 = awork[:, k + 1, k + 1]
            delta = e11 * e22 - e21 * e21
            bad2 = delta == 0.0
            delta_safe = torch.where(bad2, 1.0, delta)
            d11 = e22 / delta_safe
            d22 = e11 / delta_safe
            d21 = -e21 / delta_safe
            l1 = torch.where(rows > k + 1, awork[:, :, k], 0.0)
            l2 = torch.where(rows > k + 1, awork[:, :, k + 1], 0.0)
            x1 = l1 * d11[:, None] + l2 * d21[:, None]
            x2 = l1 * d21[:, None] + l2 * d22[:, None]
            aw2 = awork - x1[:, :, None] * l1[:, None, :] - \
                x2[:, :, None] * l2[:, None, :]
            lm2 = _set_col(lmat, k, torch.where(rows > k + 1, x1,
                                                lmat[:, :, k]))
            lm2[:, :, k + 1] = torch.where(rows > k + 1, x2,
                                           lmat[:, :, k + 1])
            lm2[:, k, k] = d11
            lm2[:, k + 1, k] = d21
            lm2[:, k + 1, k + 1] = d22

            use2 = (~skip) & is_2x2
            use1 = (~skip) & (~is_2x2)
            awork = torch.where(use2[:, None, None], aw2,
                                torch.where(use1[:, None, None], aw1, awork))
            lmat = torch.where(use2[:, None, None], lm2,
                               torch.where(use1[:, None, None], lm1, lmat))
            info = torch.where((use1 & bad1) | (use2 & bad2),
                               NUMERICAL_ISSUE, info)
            head = ptype.clone()
            head[:, k] = 2
            head[:, k + 1] = 0
            ptype = torch.where(use2[:, None], head, ptype)
        skip = (~skip) & is_2x2
    return BKFactors(lmat=lmat, perm=perm, ptype=ptype, info=info)


def _swap_entries(x: Tensor, i: int, j: Tensor) -> Tensor:
    """Per instance, ``x[i] <-> x[j]`` (rows of ``x [B, N, K]``)."""
    xi = x[:, i].clone()
    jj = j[:, None, None].expand(-1, 1, x.shape[2])
    xj = x.gather(1, jj)[:, 0]
    out = x.clone()
    out[:, i] = xj
    return out.scatter(1, jj, xi[:, None])


def solve(fac: BKFactors, b: Tensor) -> Tensor:
    """Solve ``A x = b`` from the factors, ``b`` [B, N] or [B, N, K]
    (BKLDLT::solve_inplace, BKLDLT.h:444-520;
    lbfgspp_tpu/ops/bkldlt.py:236-300): ``Pb``, ``Lz = Pb``, ``Dw = z``,
    ``L'y = w``, ``x = P'y``."""
    vector = b.dim() == 2
    x = b[:, :, None] if vector else b
    lmat, perm, ptype = fac.lmat, fac.perm, fac.ptype
    n = lmat.shape[1]
    rows = torch.arange(n, device=b.device)

    for i in range(n):                       # Pb (BKLDLT.h:451-457)
        x = _swap_entries(x, i, perm[:, i])

    for i in range(n):                       # Lz = Pb (BKLDLT.h:459-478)
        i1 = min(i + 1, n - 1)
        two = (ptype[:, i] == 2)[:, None, None]
        one = (ptype[:, i] == 1)[:, None, None]
        l_one = torch.where(rows > i, lmat[:, :, i], 0.0)[:, :, None]
        x_one = x - l_one * x[:, i:i + 1]
        l1 = torch.where(rows > i + 1, lmat[:, :, i], 0.0)[:, :, None]
        l2 = torch.where(rows > i + 1, lmat[:, :, i1], 0.0)[:, :, None]
        x_two = x - l1 * x[:, i:i + 1] - l2 * x[:, i1:i1 + 1]
        x = torch.where(two, x_two, torch.where(one, x_one, x))

    for i in range(n):                       # Dw = z (BKLDLT.h:480-496)
        i1 = min(i + 1, n - 1)
        head1 = (ptype[:, i] == 1)[:, None]
        head2 = (ptype[:, i] == 2)[:, None]
        xi, xi1 = x[:, i], x[:, i1]
        e11 = lmat[:, i, i][:, None]
        e21 = lmat[:, i1, i][:, None]
        e22 = lmat[:, i1, i1][:, None]
        x2 = x.clone()
        x2[:, i] = xi * e11 + xi1 * e21
        x2[:, i1] = xi * e21 + xi1 * e22
        x1 = x.clone()
        x1[:, i] = xi * e11
        x = torch.where(head2[:, :, None], x2,
                        torch.where(head1[:, :, None], x1, x))

    for t in range(n):                       # L'y = w (BKLDLT.h:498-513)
        i = n - 1 - t
        l_col = torch.where(rows > i, lmat[:, :, i], 0.0)
        x = x.clone()
        x[:, i] = x[:, i] - (l_col[:, :, None] * x).sum(dim=1)

    for t in range(n):                       # x = P'y (BKLDLT.h:515-519)
        i = n - 1 - t
        x = _swap_entries(x, i, perm[:, i])
    return x[:, :, 0] if vector else x
