"""Feature-split solves on ``torch.distributed`` (the port's counterpart
of ``lbfgspp_tpu.parallel``)."""

from . import collectives

__all__ = ["collectives"]
