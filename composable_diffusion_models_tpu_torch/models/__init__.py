"""Score models of the port."""

from .dit import DiT, make_folded_apply
from .mlp import LatentDiffusionMLP, ScoreMLP
from .unet import UNet
from .vae import BetaVAE, vae_loss

__all__ = ["BetaVAE", "DiT", "LatentDiffusionMLP", "ScoreMLP", "UNet",
           "make_folded_apply", "vae_loss"]
