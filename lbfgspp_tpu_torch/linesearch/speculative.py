"""Speculative (K-candidate) line search, batched.

The port's counterpart of ``lbfgspp_tpu.linesearch.speculative``, which
has no reference counterpart: each round evaluates a geometric ladder of K
candidate steps, ``[inc t, t, dec t, dec^2 t, ...]`` clipped to
``[min_step, min(max_step, step_max)]``, in one objective call over
``[K * B, n]`` points, and takes each instance's largest candidate that
meets strong Wolfe, else regular Wolfe, else Armijo; an instance with none
re-ladders below its smallest candidate.  K evaluations per round; rounds
are capped at ``ceil(max_linesearch / K)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel import collectives as coll
from ..types import LineSearchResult, Status, i32_like
from .backtracking import run_trials

Tensor = torch.Tensor


class _SpecCarry(NamedTuple):
    base: Tensor      # ladder anchor step
    step: Tensor      # accepted step
    fx: Tensor
    dg: Tensor
    x: Tensor
    grad: Tensor
    it: Tensor        # rounds completed
    done: Tensor
    status: Tensor
    nfev: Tensor


def make_speculative(k: int = 8, dec: float = 0.5, inc: float = 2.0):
    """A speculative search with a K-wide candidate ladder."""
    if k < 2:
        raise ValueError("speculative line search needs k >= 2")

    def speculative(fg, param, xp: Tensor, drt: Tensor, step_max, step0,
                    fx0: Tensor, grad0: Tensor, dg0: Tensor,
                    active: Optional[Tensor] = None,
                    group=None) -> LineSearchResult:
        dtype, dev = xp.dtype, xp.device
        batch, n = xp.shape
        step0 = torch.as_tensor(step0, dtype=dtype, device=dev).expand(
            fx0.shape).clone()
        ladder = torch.tensor([inc] + [dec ** j for j in range(k - 1)],
                              dtype=dtype, device=dev)[:, None]     # [K, 1]
        # This search reuses the caller's dg0 (no recompute).
        invalid = step0 <= 0.0
        not_descent = dg0 > 0.0
        pre_status = torch.where(
            invalid, i32_like(Status.LS_INVALID_STEP, fx0),
            torch.where(not_descent, i32_like(Status.LS_NOT_DESCENT, fx0),
                        i32_like(Status.RUNNING, fx0)))
        stopped = invalid | not_descent
        if active is not None:
            stopped = stopped | ~active
        test_decr = param.ftol * dg0
        hi = torch.clamp(torch.as_tensor(step_max, dtype=dtype, device=dev),
                         max=param.max_step)
        lo = param.min_step
        max_rounds = max(1, -(-param.max_linesearch // k))
        rows = torch.arange(batch, device=dev)

        def trial(c: _SpecCarry) -> _SpecCarry:
            raw = c.base[None, :] * ladder                          # [K, B]
            steps = torch.minimum(torch.clamp(raw, min=lo), hi)
            xs = xp[None] + steps[:, :, None] * drt[None]
            # The K candidates' values and directional derivatives take
            # one all-reduce under a group (speculative.py:126-129).
            fxs, grads, dgs = coll.evaluate(
                fg, xs.reshape(k * batch, n),
                lambda g: torch.linalg.vecdot(
                    g.reshape(k, batch, n), drt[None]).reshape(-1, 1),
                group, "speculative.trial")
            fxs = fxs.reshape(k, batch)
            grads = grads.reshape(k, batch, n)
            dgs = dgs.reshape(k, batch)

            in_range = (raw >= lo) & (raw <= hi)
            armijo = (fxs <= fx0 + steps * test_decr) & \
                torch.isfinite(fxs) & in_range
            curv = dgs >= param.wolfe * dg0
            strong = curv & (dgs <= -param.wolfe * dg0)
            m_strong = armijo & strong
            m_wolfe = armijo & curv
            mask = torch.where(m_strong.any(0), m_strong,
                               torch.where(m_wolfe.any(0), m_wolfe, armijo))
            has = mask.any(0)
            idx = mask.to(torch.int32).argmax(0)   # the largest acceptable

            # Anchor the next round below the smallest candidate tried.
            next_base = c.base * ladder[-1, 0] * dec
            status = torch.where(
                has | ~(next_base < lo), c.status,
                i32_like(Status.LS_STEP_TOO_SMALL, fx0))
            h = has[:, None]
            return _SpecCarry(
                base=torch.where(has, c.base, next_base),
                step=torch.where(has, steps[idx, rows], c.step),
                fx=torch.where(has, fxs[idx, rows], c.fx),
                dg=torch.where(has, dgs[idx, rows], c.dg),
                x=torch.where(h, xs[idx, rows], c.x),
                grad=torch.where(h, grads[idx, rows], c.grad),
                it=c.it + 1, done=has, status=status, nfev=c.nfev + k)

        c = _SpecCarry(base=step0, step=step0, fx=fx0, dg=dg0, x=xp,
                       grad=grad0, it=i32_like(0, fx0), done=stopped,
                       status=pre_status, nfev=i32_like(0, fx0))
        c, status = run_trials(trial, c, max_rounds)
        return LineSearchResult(step=c.step, fx=c.fx, grad=c.grad, dg=c.dg,
                                x=c.x, status=status, nfev=c.nfev)

    return speculative


speculative = make_speculative()
