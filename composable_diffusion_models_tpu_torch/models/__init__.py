"""Score models of the port."""

from .dit import DiT, make_folded_apply
from .unet import UNet

__all__ = ["DiT", "UNet", "make_folded_apply"]
