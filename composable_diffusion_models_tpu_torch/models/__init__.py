"""Score models of the port."""

from .dit import DiT, make_folded_apply

__all__ = ["DiT", "make_folded_apply"]
