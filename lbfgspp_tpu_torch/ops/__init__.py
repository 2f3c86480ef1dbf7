from . import fused, history

__all__ = ["fused", "history"]
