"""Share of the card's resident warp-slot time that solves, over the
traced window's probed ``native_lbfgs_batch`` launches: the instances'
summed time in their slots (``%globaltimer`` at a warp's entry and after
its outputs, the kernel's own records) over each launch's slots (SMs x
blocks an SM x warps a block, of the probed plan) times its span (last
end - first start), from ``lbfgspp_tpu_torch.native.probe_records()``.
The rest is the launch's ramp, its last wave's drain and block tails."""

from lbfgspp_tpu_torch import native


def read(r):
    recs = getattr(native, "probe_records", list)()
    room = sum(x["slots"] * x["span_ns"] for x in recs)
    if not recs or room <= 0:
        return None
    return 100.0 * sum(x["busy_ns"] for x in recs) / room
