"""Operation and byte counts, peaks and the quality bar: frozen copies.

Each function but the last is copied from ``chip_smoke.py`` as it stood
when the benchmark was written (the line numbers cite that file), so that
the yardstick does not move when the program or its smoke test changes;
the split logistic regression's byte count was written here.  The
peaks are the data sheet's of one NVIDIA H100 SXM at its 700 W limit.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12       # chip_smoke.py:212
# outside tensor cores; chip_smoke.py:214
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}


def args_bytes(args, mode) -> int:
    """Bytes one two-loop call on ``args`` (the kernel's ten tensors
    ``s, y, ys, theta, ptr, ncorr, sy, yy, rinv, v``) must move: each
    input read once, the output (v's shape and type) written once.
    chip_smoke.py:338-345."""
    v = args[9]
    mats = (args[8] if mode == "rinv" else args[6], args[7])
    return sum(t.numel() * t.element_size()
               for t in args[:6] + (v,) + mats) + \
        v.numel() * v.element_size()


def two_loop_args(batch: int, m: int, n: int, dtype=torch.float32,
                  row_dtype=None):
    """The ten argument tensors of one two-loop call at ``[batch, m, n]``,
    on the meta device (shapes and types only), in the kernel's order."""
    row_dtype = dtype if row_dtype is None else row_dtype

    def t(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    i32 = torch.int32
    return (t((batch, m, n), row_dtype), t((batch, m, n), row_dtype),
            t((batch, m), dtype), t((batch,), dtype), t((batch,), i32),
            t((batch,), i32), t((batch, m, m), dtype),
            t((batch, m, m), dtype), t((batch, m, m), dtype),
            t((batch, n), dtype))


def two_loop_flops(batch, m, n, mode) -> int:
    """chip_smoke.py:348-352: 2m dots and the 2m-row combine, 8mn; the
    recursion, 3 (rinv) or 2m+1 (sweeps) [m, m] matvecs."""
    matvecs = 3 if mode == "rinv" else 2 * m + 1
    return batch * (8 * m * n + 2 * n + 2 * m * m * matvecs)


def native_flops(niter, nfev, n, m, obj_flops, box=False) -> float:
    """f64 flops of the native solves, counted from each instance's
    iterations k and evaluations e, iteration i (0-based) with c = min(i, m)
    corrections: per evaluation a trial point, the objective (``obj_flops``
    per coordinate) and ``g.d``, (4 + obj) n; per L-BFGS iteration the
    two-loop 8cn + 2n and the update's and norms' dots 10n; per L-BFGS-B
    iteration the Cauchy point's W'd and the update's S'S and L rows, 8cn,
    the vector work around them, 20n, and the middle matrix's inverse of
    order d = 2c, one LU (2/3) d^3 and d solves of 2 d^2.  The box count
    leaves out the subspace step's products over the free set, so it is a
    lower bound.  chip_smoke.py:416-439."""
    k = niter.double().cpu()
    per_eval = (4 + obj_flops) * n * nfev.double().cpu()
    c = k.new_tensor(range(m + 1))
    iters = (k[:, None] - c).clamp(min=0)
    iters[:, :m] = iters[:, :m].clamp(max=1)
    if not box:
        per_iter = (8 * c + 12) * n
    else:
        d = 2 * c
        per_iter = (8 * c + 20) * n + (2 / 3) * d ** 3 + 2 * d ** 3
    return float((per_eval.sum() + (iters * per_iter).sum()))


# the builtin Rosenbrock's flops a coordinate (chip_smoke.py:2795)
ROSENBROCK_FLOPS = 6


def native_bytes(batch: int, n: int, box: bool = False) -> int:
    """Bytes a native launch must move: x0 (and the bounds) read, x and the
    five outputs written.  chip_smoke.py:2796-2799."""
    return batch * ((4 if box else 2) * n * 8 + 28)


def native_bound_s(flops: float, nbytes: float) -> float:
    """The least time of a native launch: its f64 flops over the FP64
    peak or its bytes over the memory rate, the larger.
    chip_smoke.py:453-461."""
    return max(flops / PEAK_FLOPS["float64"], nbytes / HBM_BYTES_PER_S)


def frac_within(x, tol) -> float:
    """Share of the rows of ``x`` within ``tol`` of 1 in every coordinate:
    the reference's multistart criterion.  chip_smoke.py:498-500."""
    return ((x.double() - 1.0).abs().max(dim=1).values <= tol).double() \
        .mean().item()


def within(x, tol, x_star: float = 1.0):
    """Per row: ``max|x - x_star| <= tol`` (frac_within's test, kept per
    instance so that a run counts its solves)."""
    return (x.double() - x_star).abs().max(dim=1).values <= tol


def logreg_eval_bytes(nnz: int, rows: int, n_local: int,
                      touched: int) -> int:
    """Bytes one evaluation of the split logistic regression must move on
    one card, its all-reduce left out (float32 values, 4-byte indices):
    the design read twice, as CSR and as its transpose (a value and an
    index a nonzero, a pointer a row or a column); w read at the
    ``touched`` columns that hold a nonzero; the ``[rows]`` logits
    written, read back with the labels, and the loss's derivative written
    and read; the gradient written and w read once more for the L2 term.
    Each is the least its pass needs, so the count bounds the time from
    below."""
    design = 2 * 8 * nnz + 4 * (rows + 1) + 4 * (n_local + 1)
    return design + 4 * touched + 4 * 5 * rows + 4 * 2 * n_local
