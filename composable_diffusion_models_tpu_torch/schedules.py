"""Noise schedules: the continuous VP schedule of the serving paths.

Port of ``composable_diffusion_models_tpu.schedules.VPSchedule`` for
``kind="stable"`` (sigma^2 = 1 - alpha^2): the rates, the SDE coefficients
(``dlog_alpha_dt``, ``beta``, ``g2``), the forward process on given noise
(``q_t_eps``) and the samplers' tables (``ddim_table`` with linear spacing,
``em_table``, ``ode_table``). All arithmetic is float32, in the JAX
package's operation order, so the tables agree with it to float32 rounding;
they are built on the host. The other kinds, Karras spacing, ``t_of_sigma``,
``q_t`` with its own draw and ``DDPMSchedule`` are not ported and raise or
are absent.
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

    def dlog_alpha_dt(self, t) -> torch.Tensor:
        t = _f32(t)
        return -0.5 * self.beta_0 - 0.5 * t * (self.beta_1 - self.beta_0)

    def log_sigma(self, t) -> torch.Tensor:
        return 0.5 * torch.log(1.0 - torch.exp(2.0 * self.log_alpha(t))
                               + self.eps)

    def sigma(self, t) -> torch.Tensor:
        return torch.exp(self.log_sigma(t))

    def beta(self, t) -> torch.Tensor:
        """Reverse-SDE diffusion weight: -2 dlog_alpha/dt * sigma^2(t)."""
        t = _f32(t)
        return -2.0 * self.dlog_alpha_dt(t) * self.sigma(t) ** 2

    def g2(self, t) -> torch.Tensor:
        """Forward-SDE squared diffusion coefficient: -2 dlog_alpha/dt."""
        return -2.0 * self.dlog_alpha_dt(t)

    def q_t_eps(self, x0: torch.Tensor, t, eps: torch.Tensor) -> torch.Tensor:
        """x_t = alpha(t) x0 + sigma(t) eps for given noise; ``t`` a scalar
        or (B,), broadcast over the trailing data dims."""
        t = _f32(t).to(x0.device)
        a, s = _bcast(self.alpha(t), x0.dim()), _bcast(self.sigma(t), x0.dim())
        return a * x0 + s * eps

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

    def _step_grid(self, n_steps: int, t_max: float, t_min: float):
        """(ts, dt) of the E-M and ODE tables: t steps down from t_max by
        dt = (t_max - t_min) / n_steps, a Python float as in the JAX
        package."""
        dt = (t_max - t_min) / n_steps
        return t_max - dt * torch.arange(n_steps, dtype=torch.float32), dt

    def em_table(self, n_steps: int, t_max: float = 1.0,
                 t_min: float = 1e-3) -> torch.Tensor:
        """(n_steps, 5) rows (t, dlog_alpha_dt, beta, sigma, dt)."""
        ts, dt = self._step_grid(n_steps, t_max, t_min)
        return torch.stack(
            [ts, self.dlog_alpha_dt(ts), self.beta(ts), self.sigma(ts),
             torch.full((n_steps,), dt, dtype=torch.float32)], dim=1)

    def ode_table(self, n_steps: int, t_max: float = 1.0,
                  t_min: float = 1e-3) -> torch.Tensor:
        """(n_steps, 5) rows (t, dlog_alpha_dt, g2, sigma, dt)."""
        ts, dt = self._step_grid(n_steps, t_max, t_min)
        return torch.stack(
            [ts, self.dlog_alpha_dt(ts), self.g2(ts), self.sigma(ts),
             torch.full((n_steps,), dt, dtype=torch.float32)], dim=1)


def _bcast(coef: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a scalar or (B,) coefficient against an ndim-array."""
    if coef.dim() == 0:
        return coef
    return coef.reshape(tuple(coef.shape) + (1,) * (ndim - coef.dim()))
