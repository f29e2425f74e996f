"""Noise schedules: the continuous VP schedule and the discrete DDPM tables.

Port of ``composable_diffusion_models_tpu.schedules``, whole:

* ``VPSchedule`` of every kind: ``stable`` (sigma^2 = 1 - alpha^2),
  ``jax_faithful`` (sigma(t) = t), ``cosine`` (Improved DDPM's shifted
  cosine, phase clamped so alpha(1) > 0) and ``rectified`` (alpha = 1 - t,
  sigma = t). The rates, the SDE coefficients (``dlog_alpha_dt``, ``beta``,
  ``g2``), the forward process (``q_t`` with its own draw, ``q_t_eps`` on
  given noise), ``t_of_sigma``, and the samplers' tables (``ddim_table``
  with linear or Karras spacing, ``em_table``, ``ode_table``).
* ``DDPMSchedule``: linear or cosine betas and the tables derived from them,
  ``q_sample``, the SDE-coefficient views and the per-step ``table``.

All arithmetic is float32, in the JAX package's operation order, so the
tables agree with it to float32 rounding; they are built on the host. Where
the JAX code takes a PRNG key, ``q_t`` and ``q_sample`` take a
``torch.Generator`` (or the noise itself, ``eps=``, to replay a draw).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

_STABLE = "stable"
_JAX_FAITHFUL = "jax_faithful"
_COSINE = "cosine"
_RECTIFIED = "rectified"
# cosine shift (Improved DDPM eq. 17) and the phase clamp that keeps
# alpha(1) = sin(0.02) > 0, as in the JAX package
_COS_S = 0.008
_COS_U_MAX = math.pi / 2 - 0.02


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


def linspace(start, stop, num: int) -> torch.Tensor:
    """float32 linspace(start, stop, num) as jnp.linspace computes it under
    XLA: start * (1 - s) + stop * s with s = arange(num - 1) * float32(1 /
    (num - 1)) (XLA turns the division by the constant into that product),
    then the exact endpoint."""
    start, stop = _f32(start), _f32(stop)
    s = torch.arange(num - 1, dtype=torch.float32) * _f32(1.0 / (num - 1))
    return torch.cat([start * (1 - s) + stop * s, stop[None]])


def _noise(x0: torch.Tensor, gen: Optional[torch.Generator],
           eps: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward process's noise: ``eps`` when given (a replayed draw),
    else N(0, 1) in x0's shape and dtype from ``gen`` on x0's device."""
    if eps is not None:
        if tuple(eps.shape) != tuple(x0.shape):
            raise ValueError(f"eps {tuple(eps.shape)} does not match x0 "
                             f"{tuple(x0.shape)}")
        return eps.to(device=x0.device, dtype=x0.dtype)
    if gen is None:
        raise ValueError("pass a torch.Generator or the noise itself (eps=)")
    return torch.randn(x0.shape, generator=gen, device=x0.device,
                       dtype=x0.dtype)


@dataclasses.dataclass(frozen=True)
class VPSchedule:
    """Continuous-time variance-preserving schedule, t in [0, 1].

    ``stable``: log alpha(t) = -t b0/2 - t^2 (b1 - b0)/4, sigma^2 = 1 -
    alpha^2; ``jax_faithful``: the same alpha, sigma(t) = t; ``cosine``:
    alpha(t) = cos(pi/2 (t+s)/(1+s)) / cos(pi/2 s/(1+s)), true VP;
    ``rectified``: alpha(t) = 1 - t, sigma(t) = t, with the samplers' grids
    capped at t = 0.999 where g^2 diverges."""

    beta_0: float = 0.1
    beta_1: float = 20.0
    kind: str = _STABLE
    eps: float = 1e-9

    def __post_init__(self):
        if self.kind not in (_STABLE, _JAX_FAITHFUL, _COSINE, _RECTIFIED):
            raise ValueError(f"unknown schedule kind: {self.kind!r}")

    # --- signal rate -----------------------------------------------------
    @staticmethod
    def _cos_u(t) -> torch.Tensor:
        return (t + _COS_S) / (1.0 + _COS_S) * (math.pi / 2)

    def log_alpha(self, t) -> torch.Tensor:
        t = _f32(t)
        if self.kind == _COSINE:
            u = torch.clamp(self._cos_u(t), max=_COS_U_MAX)
            return (torch.log(torch.cos(u))
                    - torch.log(torch.cos(self._cos_u(_f32(0.0)))))
        if self.kind == _RECTIFIED:
            return torch.log(1.0 - t + self.eps)
        return -0.5 * t * self.beta_0 - 0.25 * t**2 * (self.beta_1 - self.beta_0)

    def alpha(self, t) -> torch.Tensor:
        return torch.exp(self.log_alpha(t))

    def dlog_alpha_dt(self, t) -> torch.Tensor:
        t = _f32(t)
        if self.kind == _COSINE:
            u_raw = self._cos_u(t)
            u = torch.clamp(u_raw, max=_COS_U_MAX)
            # alpha is constant in the clamped region: derivative 0 there
            return torch.where(
                u_raw < _COS_U_MAX,
                -(math.pi / 2) / (1.0 + _COS_S) * torch.tan(u), _f32(0.0))
        if self.kind == _RECTIFIED:
            return -1.0 / (1.0 - t + self.eps)
        return -0.5 * self.beta_0 - 0.5 * t * (self.beta_1 - self.beta_0)

    # --- noise rate ------------------------------------------------------
    def log_sigma(self, t) -> torch.Tensor:
        if self.kind in (_JAX_FAITHFUL, _RECTIFIED):  # sigma(t) = t kinds
            return torch.log(_f32(t) + self.eps)
        return 0.5 * torch.log(1.0 - torch.exp(2.0 * self.log_alpha(t))
                               + self.eps)

    def sigma(self, t) -> torch.Tensor:
        if self.kind in (_JAX_FAITHFUL, _RECTIFIED):
            return _f32(t) + self.eps  # sigma(t) = t without exp(log t)
        return torch.exp(self.log_sigma(t))

    # --- SDE coefficients -------------------------------------------------
    def beta(self, t) -> torch.Tensor:
        """Reverse-SDE diffusion weight: -2 dlog_alpha/dt * sigma^2(t) for
        the true-VP kinds and rectified; 1 + t b0/2 + t^2 (b1 - b0)/2 for
        jax_faithful (the notebook's)."""
        t = _f32(t)
        if self.kind != _JAX_FAITHFUL:
            return -2.0 * self.dlog_alpha_dt(t) * self.sigma(t) ** 2
        return 1.0 + 0.5 * t * self.beta_0 + 0.5 * t**2 * (self.beta_1
                                                           - self.beta_0)

    def g2(self, t) -> torch.Tensor:
        """Forward-SDE squared diffusion coefficient, from the variance ODE
        d(sigma^2)/dt = 2 dlog_alpha sigma^2 + g^2."""
        t = _f32(t)
        if self.kind == _RECTIFIED:
            return 2.0 * t / (1.0 - t + self.eps)
        if self.kind != _JAX_FAITHFUL:
            return -2.0 * self.dlog_alpha_dt(t)
        s = self.sigma(t)
        return 2.0 * s - 2.0 * s**2 * self.dlog_alpha_dt(t)

    # --- forward process ---------------------------------------------------
    def q_t(self, x0: torch.Tensor, t, gen: Optional[torch.Generator] = None,
            eps: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x_t = alpha(t) x0 + sigma(t) eps with eps ~ N(0, 1) drawn from
        ``gen`` (or given as ``eps``). Returns (x_t, eps)."""
        eps = _noise(x0, gen, eps)
        return self.q_t_eps(x0, t, eps), eps

    def q_t_eps(self, x0: torch.Tensor, t, eps: torch.Tensor) -> torch.Tensor:
        """x_t = alpha(t) x0 + sigma(t) eps for given noise; ``t`` a scalar
        or (B,), broadcast over the trailing data dims."""
        t = _f32(t).to(x0.device)
        a, s = _bcast(self.alpha(t), x0.dim()), _bcast(self.sigma(t), x0.dim())
        return a * x0 + s * eps

    # --- inversion ----------------------------------------------------------
    def t_of_sigma(self, sigma) -> torch.Tensor:
        """Closed-form inverse of sigma(t) per kind, clipped to [0, 1] (the
        Karras spacing maps its sigmas back through it)."""
        sigma = _f32(sigma)
        if self.kind in (_JAX_FAITHFUL, _RECTIFIED):
            return torch.clamp(sigma, 0.0, 1.0)
        la = 0.5 * torch.log(torch.clamp(1.0 - sigma**2, 1e-12, 1.0))
        if self.kind == _COSINE:
            u0 = self._cos_u(_f32(0.0))
            u = torch.arccos(torch.clamp(torch.exp(la) * torch.cos(u0),
                                         -1.0, 1.0))
            t = u * 2.0 * (1.0 + _COS_S) / math.pi - _COS_S
            return torch.clamp(t, 0.0, 1.0)
        # stable: the root of the quadratic log_alpha(t) = la in t
        db = self.beta_1 - self.beta_0
        disc = 0.25 * self.beta_0**2 - db * la
        t = (-0.5 * self.beta_0 + torch.sqrt(torch.clamp(disc, min=0.0))) / (
            0.5 * db)
        return torch.clamp(t, 0.0, 1.0)

    def ddim_grid(self, n_steps: int, t_max: float = 1.0, t_min: float = 1e-3,
                  spacing: str = "linear", rho: float = 7.0) -> torch.Tensor:
        """(n_steps + 1,) decreasing float32 t grid: ``"linear"`` is
        linspace(t_max, t_min); ``"karras"`` places the steps uniformly in
        sigma^(1/rho) and maps them back through :meth:`t_of_sigma`."""
        t_max = self._clamp_t_max(t_max)
        if spacing == "linear":
            return linspace(t_max, t_min, n_steps + 1)
        if spacing != "karras":
            raise ValueError(f"spacing must be 'linear' or 'karras', "
                             f"got {spacing!r}")
        s_max, s_min = self.sigma(t_max), self.sigma(t_min)
        r = linspace(0.0, 1.0, n_steps + 1)
        sig = (s_max ** (1 / rho)
               + r * (s_min ** (1 / rho) - s_max ** (1 / rho))) ** rho
        return self.t_of_sigma(sig)

    def _clamp_t_max(self, t_max: float) -> float:
        """rectified's alpha hits 0 (and g^2 diverges) at t = 1: the grids
        stop at 0.999."""
        if self.kind == _RECTIFIED:
            return min(t_max, 1.0 - 1e-3)
        return t_max

    # --- precomputed tables for the samplers --------------------------------
    def ddim_table(self, n_steps: int, t_max: float = 1.0, t_min: float = 1e-3,
                   spacing: str = "linear", rho: float = 7.0) -> torch.Tensor:
        """(n_steps, 4) rows of (alpha_now, sigma_now, alpha_next,
        sigma_next) over ``ddim_grid``."""
        ts = self.ddim_grid(n_steps, t_max, t_min, spacing, rho)
        a, s = self.alpha(ts), self.sigma(ts)
        return torch.stack([a[:-1], s[:-1], a[1:], s[1:]], dim=1)

    def _step_grid(self, n_steps: int, t_max: float, t_min: float):
        """(ts, dt) of the E-M and ODE tables: t steps down from t_max by
        dt = (t_max - t_min) / n_steps, a Python float as in the JAX
        package."""
        t_max = self._clamp_t_max(t_max)
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


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Discrete DDPM schedule: betas linspace(beta_start, beta_end, T)
    (``"linear"``) or Improved DDPM's discrete cosine clipped at 0.999
    (``"cosine"``), and the (T,) float32 tables derived from them (built on
    the host; index them with integer timesteps)."""

    num_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    beta_schedule: str = "linear"

    @property
    def betas(self) -> torch.Tensor:
        if self.beta_schedule == "cosine":
            s = 0.008
            steps = torch.arange(self.num_timesteps + 1, dtype=torch.float32)
            f = torch.cos((steps / self.num_timesteps + s) / (1 + s)
                          * math.pi / 2) ** 2
            abar = f / f[0]
            return torch.clamp(1.0 - abar[1:] / abar[:-1], 0.0, 0.999)
        if self.beta_schedule != "linear":
            raise ValueError(f"unknown beta_schedule {self.beta_schedule!r}; "
                             "choose 'linear' or 'cosine'")
        return linspace(self.beta_start, self.beta_end, self.num_timesteps)

    @property
    def alphas(self) -> torch.Tensor:
        return 1.0 - self.betas

    @property
    def alphas_cumprod(self) -> torch.Tensor:
        return torch.cumprod(self.alphas, dim=0)

    @property
    def alphas_cumprod_prev(self) -> torch.Tensor:
        ac = self.alphas_cumprod
        return torch.cat([torch.ones(1), ac[:-1]])

    @property
    def sqrt_alphas_cumprod(self) -> torch.Tensor:
        return torch.sqrt(self.alphas_cumprod)

    @property
    def sqrt_one_minus_alphas_cumprod(self) -> torch.Tensor:
        return torch.sqrt(1.0 - self.alphas_cumprod)

    @property
    def sqrt_recip_alphas(self) -> torch.Tensor:
        return torch.rsqrt(self.alphas)

    @property
    def posterior_variance(self) -> torch.Tensor:
        return (self.betas * (1.0 - self.alphas_cumprod_prev)
                / (1.0 - self.alphas_cumprod))

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 gen: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps at integer steps
        ``t`` (B,), eps drawn from ``gen`` (or given). Returns (x_t, eps)."""
        eps = _noise(x0, gen, eps)
        t = t.to(x0.device).long()
        a = _bcast(self.sqrt_alphas_cumprod.to(x0.device)[t], x0.dim())
        s = _bcast(self.sqrt_one_minus_alphas_cumprod.to(x0.device)[t],
                   x0.dim())
        return a * x0 + s * eps, eps

    def sde_coeffs(self, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """(f_coeff, g2) at integer step t: f = -beta_t / 2, g^2 = beta_t."""
        b = self.betas[torch.as_tensor(t).long()]
        return -0.5 * b, b

    def fd_sde_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Finite-difference (f_coeff, g2) tables, (T,) each: f_coeff[t] =
        (log sqrt(abar_t) - log sqrt(abar_{t-1})) / dtau, g2[t] =
        max(2 sigma_t^2 (dlog sigma - dlog alpha), 1e-8), with abar_{-1} = 1
        and the t = 0 dlog-sigma term zeroed."""
        dtau = 1.0 / self.num_timesteps
        abar = self.alphas_cumprod
        log_a = 0.5 * torch.log(abar)
        log_a_prev = torch.cat([torch.zeros(1), log_a[:-1]])
        dlog_a = (log_a - log_a_prev) / dtau
        sig2 = 1.0 - abar
        log_s = 0.5 * torch.log(sig2)
        log_s_prev = torch.cat([torch.full((1,), -math.inf), log_s[:-1]])
        dlog_s = torch.where(torch.isfinite(log_s_prev),
                             (log_s - log_s_prev) / dtau, _f32(0.0))
        g2 = torch.clamp(2.0 * sig2 * (dlog_s - dlog_a), min=1e-8)
        return dlog_a, g2

    def table(self) -> torch.Tensor:
        """(T, 6) per-step rows, index = timestep: (beta, sqrt_alpha,
        sqrt_recip_alpha, sqrt_1m_abar, posterior_var, sqrt_abar)."""
        return torch.stack([
            self.betas, torch.sqrt(self.alphas), self.sqrt_recip_alphas,
            self.sqrt_one_minus_alphas_cumprod, self.posterior_variance,
            self.sqrt_alphas_cumprod], dim=1)
