"""Noise schedules: the continuous VP schedule of the DDIM serving path.

Port of ``composable_diffusion_models_tpu.schedules.VPSchedule`` for
``kind="stable"`` (sigma^2 = 1 - alpha^2) with linear DDIM spacing. All
arithmetic is float32, in the JAX package's operation order, so the tables
agree with it to float32 rounding. The other kinds and Karras spacing raise.
"""

from __future__ import annotations

import dataclasses

import torch

_STABLE = "stable"


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class VPSchedule:
    """Continuous-time variance-preserving schedule, t in [0, 1]:
    log alpha(t) = -t b0/2 - t^2 (b1 - b0)/4, sigma^2 = 1 - alpha^2."""

    beta_0: float = 0.1
    beta_1: float = 20.0
    kind: str = _STABLE
    eps: float = 1e-9

    def __post_init__(self):
        if self.kind != _STABLE:
            raise NotImplementedError(
                f"schedule kind {self.kind!r} is not ported yet (only "
                f"'stable')")

    def log_alpha(self, t) -> torch.Tensor:
        t = _f32(t)
        return -0.5 * t * self.beta_0 - 0.25 * t**2 * (self.beta_1 - self.beta_0)

    def alpha(self, t) -> torch.Tensor:
        return torch.exp(self.log_alpha(t))

    def log_sigma(self, t) -> torch.Tensor:
        return 0.5 * torch.log(1.0 - torch.exp(2.0 * self.log_alpha(t))
                               + self.eps)

    def sigma(self, t) -> torch.Tensor:
        return torch.exp(self.log_sigma(t))

    def ddim_grid(self, n_steps: int, t_max: float = 1.0, t_min: float = 1e-3,
                  spacing: str = "linear") -> torch.Tensor:
        """(n_steps + 1,) decreasing float32 t grid, linspace(t_max, t_min),
        computed as jnp.linspace does under XLA: start * (1 - s) + stop * s
        with s = arange(n) * float32(1 / n) (XLA turns the division by the
        constant n into that product), then the exact endpoint."""
        if spacing != "linear":
            raise NotImplementedError(
                f"spacing {spacing!r} is not ported yet (only 'linear')")
        start, stop = _f32(t_max), _f32(t_min)
        s = torch.arange(n_steps, dtype=torch.float32) * _f32(1.0 / n_steps)
        return torch.cat([start * (1 - s) + stop * s, stop[None]])

    def ddim_table(self, n_steps: int, t_max: float = 1.0, t_min: float = 1e-3,
                   spacing: str = "linear") -> torch.Tensor:
        """(n_steps, 4) rows of (alpha_now, sigma_now, alpha_next,
        sigma_next) over ``ddim_grid``."""
        ts = self.ddim_grid(n_steps, t_max, t_min, spacing)
        a, s = self.alpha(ts), self.sigma(ts)
        return torch.stack([a[:-1], s[:-1], a[1:], s[1:]], dim=1)
