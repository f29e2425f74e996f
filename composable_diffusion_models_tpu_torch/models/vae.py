"""Beta-VAE latent codec: a convolutional encoder to (mu, logvar), the
reparameterisation, and a decoder with a sigmoid output.

Port of ``composable_diffusion_models_tpu.models.vae``: ``BetaVAE`` as a
frozen configuration with ``encode``, ``reparameterize``, ``decode`` and
``apply`` over a params tree, and ``vae_loss``. ``params`` is the flax tree
as torch tensors (``convert.from_flax``), kept in flax's layout: Conv
kernels HWIO (turned to OIHW at use), Dense kernels (in, out). The names
are flax's: ``enc_convs_i``, ``fc_mu``, ``fc_logvar``, ``dec_dense``,
``dec_convs_i``, ``dec_out``.

Public tensors are NHWC, as in the JAX package. Three places where a plain
PyTorch translation would read the weights differently:

* flax's ``"SAME"`` padding with stride 2 pads (0, 1) on an even input (none
  before, one after; 28 -> 14 -> 7), where ``padding=1`` pads (1, 1): the
  padding is computed as flax computes it and applied with ``F.pad``;
* the encoder flattens its (B, s, s, C) features in NHWC order, and the
  decoder's dense output is (B, s, s, C) NHWC: ``fc_mu``, ``fc_logvar``
  and ``dec_dense`` see those orders;
* ``jax.image.resize(..., "nearest")`` at exactly 2x repeats each pixel
  (row i reads row i // 2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """flax / XLA ``"SAME"`` padding of one spatial axis: (before, after)
    with the smaller half before."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(h: torch.Tensor, p: Any, stride: int = 1) -> torch.Tensor:
    """flax ``nn.Conv`` with ``"SAME"`` padding on an NCHW tensor; ``p``
    holds the HWIO ``kernel`` and the ``bias``."""
    w = p["kernel"].permute(3, 2, 0, 1)
    kh, kw = w.shape[-2:]
    ph = _same_pads(h.shape[-2], kh, stride)
    pw = _same_pads(h.shape[-1], kw, stride)
    h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(h, w, p["bias"], stride=stride)


def _dense(h: torch.Tensor, p: Any) -> torch.Tensor:
    return F.linear(h, p["kernel"].t(), p["bias"])


@dataclasses.dataclass(frozen=True)
class BetaVAE:
    """Configuration of the beta-VAE (the flax module's fields): stride-2
    3x3 convolutions of widths ``base_dim * m`` for m in ``channel_mults``
    (ReLU), dense mu and logvar of ``latent_dim``; the decoder mirrors it
    with nearest 2x upsampling before each 3x3 convolution."""

    img_size: int = 28
    in_channels: int = 1
    latent_dim: int = 10
    base_dim: int = 32
    channel_mults: Tuple[int, ...] = (1, 2)

    def __post_init__(self):
        if self.img_size % (2 ** len(self.channel_mults)):
            raise ValueError("img_size must divide by 2^levels")

    @property
    def feat_size(self) -> int:
        """Edge of the innermost feature map."""
        return self.img_size // (2 ** len(self.channel_mults))

    @property
    def feat_channels(self) -> int:
        return self.base_dim * self.channel_mults[-1]

    def encode(self, params: Any,
               x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, logvar), each (B, latent_dim), of NHWC images ``x``."""
        p = params["params"]
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.channel_mults)):
            h = F.relu(_conv(h, p[f"enc_convs_{i}"], stride=2))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC order
        return _dense(h, p["fc_mu"]), _dense(h, p["fc_logvar"])

    @staticmethod
    def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mu + exp(logvar / 2) N(0, 1): the draw from ``generator`` (on
        mu's device), or ``noise`` (mu's shape) in its place."""
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                dtype=mu.dtype, device=mu.device)
        return mu + torch.exp(0.5 * logvar) * noise

    def decode(self, params: Any, z: torch.Tensor) -> torch.Tensor:
        """NHWC images in (0, 1) of latents ``z`` (B, latent_dim)."""
        p = params["params"]
        s, c = self.feat_size, self.feat_channels
        h = F.relu(_dense(z, p["dec_dense"]))
        h = h.reshape(z.shape[0], s, s, c).permute(0, 3, 1, 2)
        for i in range(len(self.channel_mults)):
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h = F.relu(_conv(h, p[f"dec_convs_{i}"]))
        return torch.sigmoid(_conv(h, p["dec_out"])).permute(0, 2, 3, 1)

    def apply(self, params: Any, x: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(reconstruction, mu, logvar) of ``x``, the latent drawn by
        :meth:`reparameterize`."""
        mu, logvar = self.encode(params, x)
        z = self.reparameterize(mu, logvar, generator, noise)
        return self.decode(params, z), mu, logvar


def vae_loss(recon: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """BCE reconstruction + beta * KL, both summed per example then meaned;
    the reconstruction clipped to [1e-6, 1 - 1e-6] before the logs."""
    eps = 1e-6
    recon = torch.clamp(recon, eps, 1.0 - eps)
    bce = -(x * torch.log(recon) + (1.0 - x) * torch.log(1.0 - recon))
    bce = bce.reshape(x.shape[0], -1).sum(dim=1)
    kl = -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar), dim=1)
    return torch.mean(bce + beta * kl)
