"""The two-loop kernel's plain version against the JAX Pallas kernels.

``fused.two_loop_plain`` (what the port runs on the CPU, and what the CUDA
kernel is held against on the card) must compute what the JAX package's
``_batched_fused`` and ``_batched_fused_mmajor`` compute, run here in
Pallas interpret mode with the tiling/padding patched as in
tests/test_fused.py, and its ``rinv`` mode what vmapped
``history.apply_hv(tri="rinv")`` computes.  Tolerance rtol 1e-12 in f64:
the same arithmetic, summed in another order.

The kernel itself needs the card: tests/test_torch_cuda.py holds it
against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu.ops import fused as JF
from lbfgspp_tpu.ops import history as JH
from lbfgspp_tpu_torch.ops import fused as TF
from lbfgspp_tpu_torch.ops import history as TH
from test_torch_history import build_both

RTOL = 1e-12
ATOL = 1e-13

CASES = [
    (4, (0, 1, 3, 6)),        # mixed fill levels incl. empty
    (5, (6, 9, 2, 7, 6)),     # wrapped ring buffers, odd batch (padding)
]


def _plain(th, v, a, mode):
    return TF.two_loop_plain(th.s, th.y, th.ys, th.theta, th.ptr, th.ncorr,
                             th.sy, th.yy, th.rinv, v, a, mode)


def _jax_masks(jh, dtype):
    msy, msyT, ys_safe, vmask = JF._prep_masks(jh.ys, jh.ptr, jh.ncorr,
                                               jh.sy, jh.yy, dtype)
    return msy, msyT, jh.yy, ys_safe, vmask


@pytest.mark.parametrize("layout,tile", [("_batched_fused", "B_TILE"),
                                         ("_batched_fused_mmajor",
                                          "B_TILE2")])
@pytest.mark.parametrize("batch,ncorrs", CASES)
def test_plain_matches_pallas_interpret(layout, tile, batch, ncorrs,
                                        monkeypatch):
    n, m = 24, 6
    monkeypatch.setattr(JF, "INTERPRET", True)
    monkeypatch.setattr(JF, tile, 4)      # force the padding/tiling paths
    jh, th = build_both(batch, n, m, ncorrs, seed=batch)
    v = np.random.default_rng(1).standard_normal((batch, n))
    vj = jnp.asarray(v)
    want = getattr(JF, layout)(jh.s, jh.y, *_jax_masks(jh, vj.dtype),
                               jh.theta, vj, -1.0)
    got = _plain(th, torch.as_tensor(v), -1.0, "sweeps")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("a", [-1.0, 2.5])
@pytest.mark.parametrize("batch,ncorrs", CASES)
def test_plain_rinv_matches_history_apply_hv(a, batch, ncorrs):
    n, m = 24, 6
    jh, th = build_both(batch, n, m, ncorrs, with_rinv=True, seed=7)
    v = np.random.default_rng(2).standard_normal((batch, n))
    want = jax.vmap(lambda h, vv: JH.apply_hv(h, vv, a, tri="rinv"))(
        jh, jnp.asarray(v))
    got = _plain(th, torch.as_tensor(v), a, "rinv")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    _, th = build_both(3, 10, 4, (1, 4, 6), with_rinv=True, seed=3)
    v = torch.as_tensor(np.random.default_rng(4).standard_normal((3, 10)))
    before = TF.two_loop.launches
    got = TH.apply_hv(th, v, -1.0, tri="rinv")
    assert TF.two_loop.launches == before
    assert torch.equal(got, _plain(th, v, -1.0, "rinv"))


def test_other_devices_raise_instead_of_taking_the_plain_version():
    t = torch.empty((2, 3, 4), device="meta")
    v = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TF.two_loop(t, t, None, None, None, None, None, None, None, v, -1.0)


def _kernel_args(th, v):
    return [th.s, th.y, th.ys, th.theta, th.ptr, th.ncorr, th.sy, th.yy,
            th.rinv, v]


@pytest.mark.parametrize("index,spoil,match", [
    (4, lambda t: t.long(), "ptr"),
    (0, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     "contiguous"),
    (7, lambda t: t[:, :2], "yy"),
    (8, lambda t: None, "rinv"),
    (0, lambda t: t.float(), "s has dtype"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(index, spoil,
                                                               match):
    """The checks run before the library is loaded, so they are testable
    here; the kernel gets only contiguous tensors of its exact layout."""
    _, th = build_both(2, 8, 4, (2, 5), with_rinv=True, seed=5)
    args = _kernel_args(th, torch.zeros(2, 8, dtype=torch.float64))
    args[index] = spoil(args[index])
    with pytest.raises(ValueError, match=match):
        TF._two_loop_cuda(*args, -1.0, "rinv")
    half = [t.half() if t is not None and t.is_floating_point() else t
            for t in _kernel_args(th, torch.zeros(2, 8))]
    with pytest.raises(ValueError, match="float32 or float64"):
        TF._two_loop_cuda(*half, -1.0, "sweeps")
