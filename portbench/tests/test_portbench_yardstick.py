"""The copied operation and byte counts against hand counts at small
shapes."""

import pytest
import torch

from portbench import yardstick as ys


@pytest.mark.parametrize("mode", ["rinv", "sweeps"])
def test_args_bytes_by_hand(mode):
    b, m, n = 3, 4, 5
    args = ys.two_loop_args(b, m, n, torch.float32)
    # s, y; ys; theta; ptr, ncorr (int32); v; rinv or sy; yy; the output
    hand = (2 * b * m * n + b * m + b + 2 * b + b * n + 2 * b * m * m
            + b * n) * 4
    assert ys.args_bytes(args, mode) == hand


def test_args_bytes_bf16_rows():
    b, m, n = 2, 3, 8
    args = ys.two_loop_args(b, m, n, torch.float32, torch.bfloat16)
    hand = 2 * b * m * n * 2 + (b * m + b + 2 * b + b * n + 2 * b * m * m
                                + b * n) * 4
    assert ys.args_bytes(args, "rinv") == hand


@pytest.mark.parametrize("mode,matvecs", [("rinv", 3), ("sweeps", 9)])
def test_two_loop_flops_by_hand(mode, matvecs):
    b, m, n = 2, 4, 10
    assert ys.two_loop_flops(b, m, n, mode) == \
        b * (8 * m * n + 2 * n + 2 * m * m * matvecs)


def test_native_flops_by_hand():
    n, m, obj = 10, 2, 6
    niter = torch.tensor([0, 1, 4])
    nfev = torch.tensor([1, 3, 6])
    evals = (4 + obj) * n * (1 + 3 + 6)
    # iteration i has c = min(i, m) corrections: (8c + 12) n each
    per = [sum((8 * min(i, m) + 12) * n for i in range(k)) for k in (0, 1, 4)]
    assert ys.native_flops(niter, nfev, n, m, obj) == pytest.approx(
        evals + sum(per))


def test_native_box_flops_by_hand():
    n, m, obj = 4, 1, 6
    niter, nfev = torch.tensor([2]), torch.tensor([3])

    def it(c):
        d = 2 * c
        return (8 * c + 20) * n + (2 / 3) * d ** 3 + 2 * d ** 3
    hand = (4 + obj) * n * 3 + it(0) + it(1)
    assert ys.native_flops(niter, nfev, n, m, obj, box=True) == \
        pytest.approx(hand)


def test_native_bytes_and_bound():
    assert ys.native_bytes(10, 100) == 10 * (2 * 100 * 8 + 28)
    assert ys.native_bytes(10, 4, box=True) == 10 * (4 * 4 * 8 + 28)
    assert ys.native_bound_s(34e12, 0) == pytest.approx(1.0)
    assert ys.native_bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_frac_within():
    x = torch.ones(4, 3)
    x[1, 2] += 2e-4
    x[2, 0] -= 5e-5
    assert ys.frac_within(x, 1e-4) == 0.75
    assert ys.within(x, 1e-4).tolist() == [True, False, True, True]
