"""Reverse-time integrators over a prediction closure, and the CFG closure.

Port of ``composable_diffusion_models_tpu.samplers``:

* continuous time, on a ``VPSchedule``: ``ddim`` (deterministic and
  stochastic, eps / x0 / v prediction, linear or Karras spacing, the x0
  clamp gated by alpha, the Langevin corrector), ``dpm_solver_pp_2m``,
  ``euler_maruyama`` / ``euler_maruyama_traj``, ``prob_flow_ode``,
  ``ito_kappa_ode``, ``superposition_2d``;
* discrete DDPM, on a ``DDPMSchedule``: ``ddpm_ancestral``, SUPERDIFF with
  the Ito density estimator (``superdiff``: OR, AND heuristic, FIXED, AVG),
  the rigorous AND by a K x K linear system (``superdiff_and_solve``) and
  spatial-mask layout composition (``layout``);
* ``make_cfg_eps_fn`` and ``make_classifier_guided_eps_fn``;
* ``parallel_prob_flow`` (Picard sweeps in time), ``log_likelihood`` (the
  probability-flow ODE forward with the change-of-variables integral) and
  ``bits_per_dim``.

Each JAX ``lax.scan`` over a precomputed table becomes a Python loop; the
tables stay on the host with the per-step coefficients computed there in
float32, in the JAX package's operation order, so the loop hands the card
plain floats and never waits for it. A continuous sampler hands its closure
a 0-d float32 ``t`` on the device (its grid goes there once, through
``compose.constant``); a DDPM sampler hands it the integer timestep ``ti``
as a Python int, and the closure maps it to what its model takes.

Randomness: where the JAX sampler splits a PRNG key every step, these take
a ``torch.Generator`` on x's device in its place, and an optional ``noise=``
/ ``probes=`` tensor of shape (n_steps, ...) that replaces the draws (the
two frameworks give different numbers from one seed, so a test replays the
JAX draws through it). Step i of a DDPM sampler is timestep T - 1 - i, and
it draws even where the JAX sampler discards the draw (ti = 0). Where the
JAX sampler folds a step index into its key (``ddim``'s eta noise and
corrector), the port takes a key of ``rng`` (an int, an ``rng.Draws`` or a
``rng.Replay``) and folds the same indices into it.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from . import compose
from .ops.divergence import PROBE_KINDS, draw_probe, exact_div, value_and_div
from .rng import as_draws
from .schedules import DDPMSchedule, VPSchedule, linspace
from .utils.profiling import annotate

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim(eps_fn: EpsFn, schedule: VPSchedule, x_init: torch.Tensor,
         n_steps: int, clip: Optional[Tuple[float, float]] = (-1.0, 1.0),
         clip_min_alpha: float = 0.3, t_max: float = 1.0,
         t_min: float = 1e-3, eta: float = 0.0, key=None,
         predict: str = "eps", spacing: str = "linear",
         corrector_steps: int = 0, corrector_snr: float = 0.16,
         corrector_t_max: float = 1.0) -> torch.Tensor:
    """DDIM update over ``schedule.ddim_grid(n_steps, t_max, t_min,
    spacing)``:

      x0 = (x - sigma_now * eps) / alpha_now, clamped to ``clip`` once
           alpha_now >= clip_min_alpha
      x  = alpha_next * x0 + sigma_next * eps

    ``eps_fn(x, t)`` receives a 0-d float32 ``t`` on x's device.

    ``eta`` > 0 is the stochastic family (Song et al. 2020 eq. 16): noise
    scale sig = eta (s_next / s_now) sqrt(1 - (a_now / a_next)^2), the eps
    coefficient sqrt(s_next^2 - sig^2), step i's noise drawn from
    ``fold_in(key, i)``. ``predict="x0"`` takes a closure that returns the
    clean-image estimate, ``"v"`` a velocity model (x0 = a x - s v; needs
    ``kind="stable"``); both derive eps from the (clamped) x0.
    ``corrector_steps`` > 0 adds that many annealed-Langevin steps after
    each predictor step at the new level, x += e score + sqrt(2 e) z with e
    = 2 (snr ||z|| / ||score||)^2 over batch-mean norms, draw j of step i
    from ``fold_in(key, n_steps + 1 + i * corrector_steps + j)``, only where
    t_next <= ``corrector_t_max``. The gate is decided on the host, and a
    gated-off step makes no forward (the JAX sampler evaluates it under its
    scan and applies a zero step: the same x).

    ``key``: an int key or an ``rng.Draws`` (``rng.Replay`` replays
    recorded draws in the order they are made: step i's eta noise, then its
    corrector draws); needed when eta > 0 or with the corrector."""
    if predict not in ("eps", "x0", "v"):
        raise ValueError(f"predict must be 'eps', 'x0' or 'v', "
                         f"got {predict!r}")
    if predict == "v" and schedule.kind != "stable":
        raise ValueError("predict='v' needs VPSchedule(kind='stable')")
    if eta > 0.0 and key is None:
        raise ValueError("stochastic DDIM (eta > 0) needs a key")
    if corrector_steps > 0 and key is None:
        raise ValueError("the Langevin corrector needs a key")
    grid = schedule.ddim_grid(n_steps, t_max, t_min, spacing)
    table = schedule.ddim_table(n_steps, t_max, t_min, spacing)
    ts = compose.constant(grid.tolist(), torch.float32, x_init.device)
    a_now, s_now, a_next, s_next = table.unbind(1)
    # the float32 coefficients of the JAX step, computed once on the host
    s_safe = s_now.clamp(min=1e-12)
    sig = eta * (s_next / s_safe) * torch.sqrt(
        torch.clamp(1.0 - (a_now / a_next) ** 2, min=0.0))
    coef = torch.sqrt(torch.clamp(s_next ** 2 - sig ** 2, min=0.0))
    rows = zip(*(c.tolist() for c in (a_now, s_now, a_next, s_next, s_safe,
                                      sig, coef, s_next.clamp(min=1e-12))))
    # the gates compare float32 values, as the JAX sampler does
    gate = torch.tensor(clip_min_alpha, dtype=torch.float32).item()
    t_gate = torch.tensor(corrector_t_max, dtype=torch.float32).item()
    t_next = grid[1:].tolist()
    draws = None if key is None else as_draws(key, x_init.device)

    def to_eps(out, x, a, s, s_pos):
        if predict == "x0":
            return (x - a * out) / s_pos
        if predict == "v":
            return s * x + a * out
        return out

    def update(i, x, out, row):
        """Step i's x0, clamp and update (and its corrector) from the
        closure's ``out`` at x."""
        a0, s0, a1, s1, s0_pos, sig_i, coef_i, s1_pos = row
        if predict == "x0":
            x0 = out
        elif predict == "v":
            x0 = a0 * x - s0 * out
        else:
            x0 = (x - s0 * out) / a0
        if clip is not None and a0 >= gate:
            x0 = x0.clamp(clip[0], clip[1])
        # eps prediction keeps the raw model eps in the update; x0 and v
        # derive eps from the (possibly clamped) x0
        eps_hat = out if predict == "eps" else (x - a0 * x0) / s0_pos
        if eta > 0.0:
            z = draws.fold_in(i).normal(x.shape, x.dtype)
            x = a1 * x0 + coef_i * eps_hat + sig_i * z
        else:
            x = a1 * x0 + s1 * eps_hat
        if corrector_steps > 0 and t_next[i] <= t_gate:
            red = tuple(range(1, x.dim()))
            for j in range(corrector_steps):
                score = -to_eps(eps_fn(x, ts[i + 1]), x, a1, s1,
                                s1_pos) / s1_pos
                z = draws.fold_in(n_steps + 1 + i * corrector_steps
                                  + j).normal(x.shape, x.dtype)
                g_norm = score.square().sum(red).sqrt().mean()
                z_norm = z.square().sum(red).sqrt().mean()
                e = 2.0 * (corrector_snr * z_norm
                           / g_norm.clamp(min=1e-20)) ** 2
                x = x + e * score + torch.sqrt(2.0 * e) * z
        return x

    x = x_init
    for i, row in enumerate(rows):
        with annotate("cdm.ddim.step"):
            out = eps_fn(x, ts[i])
            with annotate("cdm.ddim.update"):
                x = update(i, x, out, row)
    return x


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.interp(x, xp, fp)`` (xp increasing), its operations in
    its order."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    df, dx = fp[i] - fp[i - 1], xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def dpm_solver_pp_2m(eps_fn: EpsFn, schedule: VPSchedule,
                     x_init: torch.Tensor, n_steps: int,
                     clip: Optional[Tuple[float, float]] = (-1.0, 1.0),
                     clip_min_alpha: float = 0.3, t_max: float = 1.0,
                     t_min: float = 1e-3,
                     spacing: str = "logsnr") -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022, Alg. 2, data prediction) in the
    half-log-SNR lambda = log(alpha / sigma):

      h_i = lambda_i - lambda_{i-1},  r = h_{i-1} / h_i
      D_i = (1 + 1/(2 r)) x0_i - 1/(2 r) x0_{i-1}   (D_0 = x0_0)
      x_i = (sigma_i / sigma_{i-1}) x_{i-1} - alpha_i (exp(-h_i) - 1) D_i

    with x0 = (x - sigma eps) / alpha clamped as in :func:`ddim`.
    ``spacing="logsnr"`` places the steps uniformly in lambda (the grid is
    the JAX package's: a 4096-point float32 lambda table inverted by linear
    interpolation, computed here on the host in float32), ``"time"``
    uniformly in t."""
    if spacing == "logsnr":
        dense = linspace(t_max, t_min, 4096)
        lam_dense = (torch.log(schedule.alpha(dense))
                     - torch.log(schedule.sigma(dense)))
        ts = _interp(linspace(lam_dense[0], lam_dense[-1], n_steps + 1),
                     lam_dense, dense)
    elif spacing == "time":
        ts = linspace(t_max, t_min, n_steps + 1)
    else:
        raise ValueError(f"spacing must be 'logsnr' or 'time', "
                         f"got {spacing!r}")
    a, s = schedule.alpha(ts), schedule.sigma(ts)
    lam = torch.log(a) - torch.log(s)
    h = lam[1:] - lam[:-1]
    r = torch.cat([torch.zeros(1), h[:-1]]) / h
    rows = zip(*(c.tolist() for c in (
        a[:-1], s[:-1], s[1:] / s[:-1], a[1:] * torch.expm1(-h),
        1.0 + 1.0 / (2.0 * r), 1.0 / (2.0 * r))))
    t_dev = compose.constant(ts.tolist(), torch.float32, x_init.device)
    gate = torch.tensor(clip_min_alpha, dtype=torch.float32).item()
    x, d_prev = x_init, None
    for i, (a0, s0, ratio, c_d, c_new, c_old) in enumerate(rows):
        d = (x - s0 * eps_fn(x, t_dev[i])) / a0
        if clip is not None and a0 >= gate:
            d = d.clamp(clip[0], clip[1])
        d2 = d if d_prev is None else c_new * d - c_old * d_prev
        x = ratio * x - c_d * d2
        d_prev = d
    return x


def make_cfg_eps_fn(apply_fn: Callable[..., torch.Tensor],
                    cond_labels: Sequence[Tuple],
                    null_labels: Tuple, weights) -> EpsFn:
    """eps_fn(x, t) = the CFG-composed prediction of ONE model: the uncond
    slot and the K conditions run as a single forward with the fan-out
    folded into the batch axis (the model sees (K + 1) * B rows).

    ``cond_labels``: K label tuples, one label per slot, each a scalar or
    (B,); ``null_labels``: the uncond tuple; ``weights``: (K,) guidance.
    Port of the JAX package's ``samplers.make_cfg_eps_fn``."""
    k = len(cond_labels)

    @functools.lru_cache(maxsize=1)
    def fanned_labels(b: int, device: torch.device):
        # the same at every sampler step: built (and copied to the device)
        # once per batch size
        labels = []
        for slot in range(len(null_labels)):
            slot_vals = [null_labels[slot]] + [c[slot] for c in cond_labels]
            labels.append(torch.cat(
                [torch.as_tensor(v, device=device).expand(b)
                 for v in slot_vals], dim=0))
        return labels

    def eps_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x_rep = torch.cat([x] * (k + 1), dim=0)
        t_rep = torch.as_tensor(t, device=x.device).expand(b).repeat(k + 1)
        out = apply_fn(x_rep, t_rep, *fanned_labels(b, x.device))
        out = out.reshape(k + 1, b, *out.shape[1:])
        return compose.cfg(out[0], out[1:], weights)

    return eps_fn


def make_classifier_guided_eps_fn(eps_fn: EpsFn, schedule: VPSchedule,
                                  logp_fn: Callable[[torch.Tensor,
                                                     torch.Tensor],
                                                    torch.Tensor],
                                  scale=1.0) -> EpsFn:
    """Classifier guidance: eps'(x, t) = eps(x, t) - scale sigma(t)
    grad_x sum log p(y | x_t), the gradient taken by autograd through
    ``logp_fn(x, t) -> (B,)``, the target class's log-probability under a
    noise-aware classifier. ``scale``: a number or ``scale(t)``. The
    sampler around it must run under ``torch.no_grad()`` (or with grad
    on), not ``torch.inference_mode()``: the gradient needs a graph."""
    def guided(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        eps = eps_fn(x, t)
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            g, = torch.autograd.grad(logp_fn(xx, t).sum(), xx)
        sig = torch.as_tensor(schedule.sigma(t), device=x.device)
        if sig.dim():  # per-sample t: broadcast over the trailing dims
            sig = sig.reshape(tuple(sig.shape) + (1,) * (x.dim() - sig.dim()))
        s = scale(t) if callable(scale) else scale
        return eps - s * sig * g

    return guided


# --------------------------------------------------------- Euler-Maruyama
def _draws(noise: Optional[torch.Tensor], generator, n_steps: int,
           shape: tuple, what: str) -> Optional[torch.Tensor]:
    """Checks a replayed (n_steps, *shape) tensor, or that there is a
    generator to draw from."""
    if noise is None:
        if generator is None:
            raise ValueError(f"needs a torch.Generator or {what}=")
        return None
    if tuple(noise.shape) != (n_steps,) + tuple(shape):
        raise ValueError(f"{what}: shape {tuple(noise.shape)}, expected "
                         f"{(n_steps,) + tuple(shape)}")
    return noise


def _euler_maruyama(eps_fn, schedule, generator, x_init, n_steps, xi, t_max,
                    t_min, noise, keep: bool):
    """The E-M loop; returns (x_final, [x_init, x_1, ...] or None)."""
    table = schedule.ode_table(n_steps, t_max, t_min)  # t, dloga, g2, sigma, dt
    ts = compose.constant(table[:, 0].tolist(), torch.float32,
                          x_init.device)
    g2, dt = table[:, 2], table[:, 4]
    rows = zip(table[:, 1].tolist(),
               (torch.tensor(0.5 * (1.0 + xi)) * g2).tolist(),
               table[:, 3].tolist(), dt.tolist(),
               torch.sqrt(xi * g2 * dt).tolist())
    noise = _draws(noise, generator, n_steps, x_init.shape, "noise")
    x, traj = x_init, [x_init] if keep else None
    for i, (dloga, c_score, sigma, dt_i, c_noise) in enumerate(rows):
        score = -eps_fn(x, ts[i]) / sigma
        drift = dloga * x - c_score * score
        z = (torch.randn(x.shape, generator=generator, dtype=x.dtype,
                         device=x.device) if noise is None else noise[i])
        x = x - drift * dt_i + c_noise * z
        if keep:
            traj.append(x)
    return x, traj


def euler_maruyama(eps_fn: EpsFn, schedule: VPSchedule,
                   generator: Optional[torch.Generator], x_init: torch.Tensor,
                   n_steps: int, xi: float = 1.0, t_max: float = 1.0,
                   t_min: float = 1e-3,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reverse-time SDE, Euler-Maruyama, with churn parameter xi:

      score = -eps_hat / sigma(t)
      x    -= dt * [f - 0.5 (1 + xi) g^2 score] - sqrt(xi g^2 dt) N(0, 1)

    xi = 1 is the standard reverse SDE, xi = 0 the probability-flow ODE.
    The drift moves WITH the score (the JAX package's corrected sign: the
    update it was translated from moved against it and diverged).
    ``noise``: (n_steps, *x.shape) standard normal draws in place of the
    generator's."""
    return _euler_maruyama(eps_fn, schedule, generator, x_init, n_steps, xi,
                           t_max, t_min, noise, keep=False)[0]


def euler_maruyama_traj(eps_fn: EpsFn, schedule: VPSchedule,
                        generator: Optional[torch.Generator],
                        x_init: torch.Tensor, n_steps: int, xi: float = 1.0,
                        t_max: float = 1.0, t_min: float = 1e-3,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """As :func:`euler_maruyama` but returns the whole (n_steps + 1, B, ...)
    trajectory, x_init first. Meant for low-dim latents."""
    return torch.stack(_euler_maruyama(eps_fn, schedule, generator, x_init,
                                       n_steps, xi, t_max, t_min, noise,
                                       keep=True)[1])


# ------------------------------------------------- probability-flow ODE
def prob_flow_ode(score_fn: EpsFn, schedule: VPSchedule, x_init: torch.Tensor,
                  n_steps: int, t_max: float = 1.0,
                  t_min: float = 1e-3) -> torch.Tensor:
    """dx/dt = dlog_alpha/dt * x - 0.5 g^2 * score; Euler, reverse time.
    ``score_fn`` returns the TRUE score (not sigma-scaled): an eps model
    enters as score = -eps_hat / sigma."""
    table = schedule.ode_table(n_steps, t_max, t_min)
    ts = compose.constant(table[:, 0].tolist(), torch.float32,
                          x_init.device)
    rows = zip(table[:, 1].tolist(), (0.5 * table[:, 2]).tolist(),
               table[:, 4].tolist())
    x = x_init
    for i, (dloga, half_g2, dt) in enumerate(rows):
        dxdt = dloga * x - half_g2 * score_fn(x, ts[i])
        x = x - dxdt * dt
    return x


# ----------------------------------- Ito-kappa composed probability flow
def _probe_pair(probes, generator, i: int, x: torch.Tensor, probe: str):
    if probes is not None:
        return probes[i]
    return torch.stack([draw_probe(generator, x.shape, x.dtype, x.device,
                                   probe) for _ in range(2)])


def ito_kappa_ode(score_fns: Tuple[EpsFn, EpsFn], schedule: VPSchedule,
                  generator: Optional[torch.Generator], x_init: torch.Tensor,
                  n_steps: int, probe: str = "rademacher",
                  clip_kappa: Optional[Tuple[float, float]] = None,
                  t_max: float = 1.0, t_min: float = 1e-3,
                  probes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Two-expert equal-density composition via Hutchinson divergence.
    ``score_fns`` return sigma-scaled scores s = sigma * dlog q/dx. Per
    step:

      (s_i, div_i) = jvp-divergence of score_fn_i at x
      kappa  = [sigma (div1 - div2) + <s1, s1 - s2>] / ||s1 - s2||^2
      s      = s2 + kappa (s1 - s2)
      dx/dt  = dlog_alpha/dt * x - 0.5 g^2 (s / sigma);  x -= dt * dx/dt

    ``probes``: (n_steps, 2, *x.shape), one probe per expert and step, in
    place of the generator's. Runs forward-mode AD: call it under
    ``torch.no_grad()``, not ``torch.inference_mode()``."""
    if probe not in PROBE_KINDS:
        raise ValueError(f"unknown probe kind: {probe!r}")
    dt = (t_max - t_min) / n_steps
    ts_host = t_max - dt * torch.arange(n_steps, dtype=torch.float32)
    ts = compose.constant(ts_host.tolist(), torch.float32, x_init.device)
    rows = zip(schedule.sigma(ts_host).tolist(),
               schedule.dlog_alpha_dt(ts_host).tolist(),
               (0.5 * schedule.g2(ts_host)).tolist())
    probes = _draws(probes, generator, n_steps, (2,) + tuple(x_init.shape),
                    "probes")
    x = x_init
    for i, (sigma_t, dloga, half_g2) in enumerate(rows):
        t = ts[i]
        v1, v2 = _probe_pair(probes, generator, i, x, probe)
        s1, div1 = value_and_div(lambda v: score_fns[0](v, t), x, probes=v1)
        s2, div2 = value_and_div(lambda v: score_fns[1](v, t), x, probes=v2)
        kappa = compose.kappa_ito(sigma_t, (div1, div2), (s1, s2), clip_kappa)
        s = compose.combine_kappa(kappa, s1, s2)
        dxdt = dloga * x - half_g2 * s / sigma_t
        x = x - dt * dxdt
    return x


def superposition_2d(score_fns: Tuple[EpsFn, EpsFn], schedule: VPSchedule,
                     generator: Optional[torch.Generator],
                     x_init: torch.Tensor, n_steps: int,
                     probe: str = "rademacher",
                     probes: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D superposition with log-likelihood tracking: the update of
    :func:`ito_kappa_ode` on t = 1 - i / n_steps with beta(t) in place of
    0.5 g^2 / sigma, and ONE probe per step shared by both experts. Returns
    (x_final, ll) with ll the (2, B) integrated d log-likelihood.
    ``probes``: (n_steps, *x.shape)."""
    if probe not in PROBE_KINDS:
        raise ValueError(f"unknown probe kind: {probe!r}")
    dt = 1.0 / n_steps
    ts_host = 1.0 - dt * torch.arange(n_steps, dtype=torch.float32)
    ts = compose.constant(ts_host.tolist(), torch.float32, x_init.device)
    rows = zip(schedule.sigma(ts_host).tolist(),
               schedule.dlog_alpha_dt(ts_host).tolist(),
               schedule.beta(ts_host).tolist())
    probes = _draws(probes, generator, n_steps, x_init.shape, "probes")
    ndim = x_init.shape[-1]
    x = x_init
    ll = torch.zeros((2, x.shape[0]), dtype=x.dtype, device=x.device)
    for i, (sigma_t, dloga, beta) in enumerate(rows):
        t = ts[i]
        v = (draw_probe(generator, x.shape, x.dtype, x.device, probe)
             if probes is None else probes[i])
        s1, div1 = value_and_div(lambda u: score_fns[0](u, t), x, probes=v)
        s2, div2 = value_and_div(lambda u: score_fns[1](u, t), x, probes=v)
        kappa = compose.kappa_ito(sigma_t, (div1, div2), (s1, s2))
        s = compose.combine_kappa(kappa, s1, s2)
        dxdt = dloga * x - beta * s

        def dll(si, divi):
            out = -dloga * ndim + beta * divi
            return out - ((si / sigma_t) * (dloga * x - beta * si
                                            - dxdt)).sum(dim=-1)

        ll = ll - dt * torch.stack([dll(s1, div1), dll(s2, div2)])
        x = x - dt * dxdt
    return x, ll


# ------------------------------------------------------ discrete DDPM
EpsStackFn = Callable[[torch.Tensor, int], torch.Tensor]
SUPERDIFF_OPS = ("OR", "AND", "FIXED", "AVG")


def _ddpm_steps(sde: DDPMSchedule):
    """(i, ti, row) for the T reverse steps, ti = T - 1 .. 0; row holds the
    host floats (beta, sqrt_alpha, sqrt_recip_alpha, sqrt_1m_abar,
    posterior_var, sqrt_abar, sqrt(posterior_var)) of timestep ti."""
    tbl = sde.table()
    cols = torch.cat([tbl, torch.sqrt(tbl[:, 4:5])], dim=1).tolist()
    n = sde.num_timesteps
    return [(i, ti, cols[ti]) for i, ti in enumerate(range(n - 1, -1, -1))]


def _normal(noise: Optional[torch.Tensor], generator, i: int,
            x: torch.Tensor, slot: Optional[int] = None) -> torch.Tensor:
    """Step i's draw: the replayed ``noise[i]`` (``noise[i, slot]`` where a
    step draws more than once), else N(0, 1) from the generator in x's
    shape and dtype."""
    if noise is not None:
        return noise[i] if slot is None else noise[i, slot]
    return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                       device=x.device)


def _clip(x: torch.Tensor, clip) -> torch.Tensor:
    return x if clip is None else x.clamp(clip[0], clip[1])


def ddpm_ancestral(eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                   sde: DDPMSchedule, generator: Optional[torch.Generator],
                   x_init: torch.Tensor,
                   clip: Optional[Tuple[float, float]] = (-1.0, 1.0),
                   noise_scale: float = 1.0,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ancestral DDPM in the score form:

      score = -eps / sqrt(1 - abar_t)
      mean  = (x + beta_t score) / sqrt(alpha_t)
      x     = mean + sqrt(posterior_var_t) noise_scale N(0, 1)  (t > 0)

    over ti = T - 1 .. 0, then ``clip``. ``eps_fn(x, ti)`` gets the integer
    timestep. ``noise``: (T, *x.shape) draws in place of the generator's."""
    noise = _draws(noise, generator, sde.num_timesteps, x_init.shape,
                   "noise")
    x = x_init
    for i, ti, (beta, sqrt_a, _, s1m, _, _, sd) in _ddpm_steps(sde):
        mean = (x + beta * (-eps_fn(x, ti) / s1m)) / sqrt_a
        z = _normal(noise, generator, i, x)
        if noise_scale != 1.0:
            z = noise_scale * z
        x = mean + sd * z if ti > 0 else mean
    return _clip(x, clip)


def superdiff(eps_stack_fn: EpsStackFn, sde: DDPMSchedule,
              generator: Optional[torch.Generator], x_init: torch.Tensor,
              operation: str = "OR", temp: float = 1.0, bias=0.0,
              clip: Optional[Tuple[float, float]] = (-1.0, 1.0),
              noise_scale: float = 1.0,
              kappa_fixed: Optional[Sequence[float]] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Density-tracked composition of K experts. Carry (x, log_q[K, B]);
    per step, with the stack's scores s_i = -eps_i / sqrt(1 - abar_t):

      kappa = softmax(temp log_q + bias)   OR
              softmax(-log_q)              AND (heuristic)
              kappa_fixed                  FIXED
              1 / K                        AVG
      the ancestral step (:func:`ddpm_ancestral`) on sum_i kappa_i s_i,
      d log_q_i = <dx, s_i> + (div f + <f - 0.5 g^2 s_i, s_i>) dtau

    with f = -0.5 beta_t x, g^2 = beta_t, div f = -0.5 beta_t d and dtau =
    1 / T; then ``clip``. ``eps_stack_fn(x, ti) -> (K, B, ...)``; K is read
    from its first call. ``bias`` tilts OR only per expert, shape (K,) (a
    non-zero scalar raises, ``compose.or_softmax``). An ``operation``
    other than the four raises (the JAX sampler takes it as AVG).
    ``noise``: (T, *x.shape)."""
    op = operation.upper()
    if op not in SUPERDIFF_OPS:
        raise ValueError(f"operation must be one of {SUPERDIFF_OPS}, got "
                         f"{operation!r}")
    if op == "FIXED" and kappa_fixed is None:
        raise ValueError("operation='FIXED' requires kappa_fixed=[w_1..w_K]")
    n = sde.num_timesteps
    noise = _draws(noise, generator, n, x_init.shape, "noise")
    dtau = 1.0 / n
    d = np.float32(math.prod(x_init.shape[1:]))
    x, log_q = x_init, None
    for i, ti, (beta, sqrt_a, _, s1m, _, _, sd) in _ddpm_steps(sde):
        eps_stack = eps_stack_fn(x, ti)
        if log_q is None:
            log_q = torch.zeros((eps_stack.shape[0], x.shape[0]),
                                dtype=x.dtype, device=x.device)
        scores = -eps_stack / s1m
        if op == "OR":
            kappa = compose.or_softmax(log_q, temp, bias)
        elif op == "AND":
            kappa = compose.and_heuristic(log_q)
        elif op == "FIXED":
            kappa = compose.constant(kappa_fixed, log_q.dtype,
                                     log_q.device)[:, None].expand_as(log_q)
        else:
            kappa = torch.full_like(log_q, 1.0 / log_q.shape[0])
        kb = kappa.reshape(kappa.shape + (1,) * (x.dim() - 1))
        mean = (x + beta * (kb * scores).sum(dim=0)) / sqrt_a
        z = _normal(noise, generator, i, x)
        if noise_scale != 1.0:
            z = noise_scale * z
        x_prev = mean + sd * z if ti > 0 else mean
        # d log_q = <dx, s> + (div f + <f - 0.5 beta s, s>) dtau
        half_b, axes = 0.5 * beta, tuple(range(2, scores.dim()))
        inner = ((-half_b * x)[None] - half_b * scores) * scores
        bracket = float(np.float32(-half_b) * d) + inner.sum(axes)
        log_q = log_q + (((x_prev - x)[None] * scores).sum(axes)
                         + bracket * dtau)
        x = x_prev
    return _clip(x, clip)


def superdiff_and_solve(eps_stack_fn: EpsStackFn, sde: DDPMSchedule,
                        generator: Optional[torch.Generator],
                        x_init: torch.Tensor, mode: str = "AND",
                        temp: float = 1.0, bias=0.0,
                        k_experts: Optional[int] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SUPERDIFF with the rigorous AND (``mode="AND"``): kappa solves the
    K x K system of equal density change (``compose.and_solve_k``) built
    from the finite-difference tables ``sde.fd_sde_tables()``:

      a[b, r, c] = dtau <-f + 0.5 g^2 s_c, s_r>
      b[b, r]    = dtau (div f + <f - 0.5 g^2 s_r, s_r>)
                   + <sqrt(g^2) dW, s_r>,  dW ~ N(0, dtau)

    with f = f_coeff x; ``mode="OR"`` takes softmax(temp log_q + bias)
    instead. Then the ancestral step on the composed score and the log_q
    update of :func:`superdiff`; no clip at the end. K is read from the
    stack's first call (``k_experts``, if given, must match). AND draws two
    normals a step, dW first, then the step noise; OR one. ``noise``: (T,
    2, *x.shape) for AND, (T, *x.shape) for OR."""
    up = mode.upper()
    if up not in ("OR", "AND"):
        raise ValueError(f"mode must be 'OR' or 'AND', got {mode!r}")
    f_coeffs, g2s = sde.fd_sde_tables()
    n = sde.num_timesteps
    per_step = (2,) if up == "AND" else ()
    noise = _draws(noise, generator, n, per_step + tuple(x_init.shape),
                   "noise")
    dtau = 1.0 / n
    d = np.float32(math.prod(x_init.shape[1:]))
    sqrt_dtau = torch.sqrt(torch.tensor(dtau, dtype=torch.float32)).item()
    f_c_all, g2_all = f_coeffs.tolist(), g2s.tolist()
    sqrt_g2_all = torch.sqrt(g2s).tolist()
    x, log_q = x_init, None
    for i, ti, (beta, _, recip_sa, s1m, _, _, sd) in _ddpm_steps(sde):
        f_c, half_g2 = f_c_all[ti], 0.5 * g2_all[ti]
        div_f = float(np.float32(f_c) * d)
        eps_stack = eps_stack_fn(x, ti)
        k, bsz = eps_stack.shape[:2]
        if k_experts is not None and k != k_experts:
            raise ValueError(f"the stack has {k} experts, k_experts="
                             f"{k_experts}")
        if log_q is None:
            log_q = torch.zeros((k, bsz), dtype=x.dtype, device=x.device)
        scores = -eps_stack / s1m
        f = f_c * x
        # div f + <f - 0.5 g^2 s, s>, each expert: the AND system's
        # deterministic part and the log_q update share it
        axes = tuple(range(2, scores.dim()))
        bracket = div_f + ((f[None] - half_g2 * scores) * scores).sum(axes)
        if up == "OR":
            kappa = compose.or_softmax(log_q, temp, bias)
        else:
            dw = _normal(noise, generator, i, x, 0) * sqrt_dtau
            rev_drift = -f[None] + half_g2 * scores
            a = dtau * torch.einsum("cbf,rbf->brc",
                                    rev_drift.reshape(k, bsz, -1),
                                    scores.reshape(k, bsz, -1))
            sto_part = ((sqrt_g2_all[ti] * dw)[None] * scores).sum(axes)
            kappa = compose.and_solve_k(a, (dtau * bracket + sto_part).T,
                                        bias).T
        kb = kappa.reshape(kappa.shape + (1,) * (x.dim() - 1))
        composed_noise = -(kb * scores).sum(dim=0) * s1m
        mean = recip_sa * (x - beta * composed_noise / s1m)
        z = _normal(noise, generator, i, x, 1 if up == "AND" else None)
        x_prev = mean + sd * z if ti > 0 else mean
        log_q = log_q + (((x_prev - x)[None] * scores).sum(axes)
                         + dtau * bracket)
        x = x_prev
    return x


def layout(eps_stack_fn: EpsStackFn, sde: DDPMSchedule,
           generator: Optional[torch.Generator], x_init: torch.Tensor,
           masks: torch.Tensor,
           clip: Optional[Tuple[float, float]] = (-1.0, 1.0),
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked score composition under the DDPM posterior step. ``masks``:
    (K, H, W), possibly overlapping; occlusion is resolved once, up front
    (``compose.resolve_occlusion``: the last mask on top). Per step:

      eps  = sum_i mask_i eps_i                      (compose.masked)
      x0   = clamp((x - sqrt(1 - abar) eps) / sqrt(abar), -1, 1)
      mean = sqrt(abar_prev) beta / (1 - abar) x0
             + sqrt(alpha) (1 - abar_prev) / (1 - abar) x

    then the posterior noise (t > 0), and ``clip`` at the end. ``noise``:
    (T, *x.shape)."""
    final = compose.resolve_occlusion(masks.to(device=x_init.device,
                                               dtype=x_init.dtype))
    abar, abar_prev = sde.alphas_cumprod, sde.alphas_cumprod_prev
    c_x0 = (torch.sqrt(abar_prev) * sde.betas / (1.0 - abar)).tolist()
    c_x = (torch.sqrt(sde.alphas) * (1.0 - abar_prev) / (1.0 - abar)).tolist()
    noise = _draws(noise, generator, sde.num_timesteps, x_init.shape,
                   "noise")
    x = x_init
    for i, ti, (_, _, _, s1m, _, sqrt_abar, sd) in _ddpm_steps(sde):
        combined = compose.masked(eps_stack_fn(x, ti), final)
        x0 = ((x - s1m * combined) / sqrt_abar).clamp(-1.0, 1.0)
        mean = c_x0[ti] * x0 + c_x[ti] * x
        z = _normal(noise, generator, i, x)
        x = mean + sd * z if ti > 0 else mean
    return _clip(x, clip)


# ------------------------------------------- parallel-in-time prob. flow
def parallel_prob_flow(score_fn: EpsFn, schedule: VPSchedule,
                       x_init: torch.Tensor, n_steps: int, n_iters: int = 12,
                       t_max: float = 1.0, t_min: float = 1e-3
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probability-flow ODE of :func:`prob_flow_ode` (Euler, the same
    grid, ``score_fn`` the TRUE score) solved by Picard iteration in time:
    the Euler trajectory is the fixed point of X[j] = x_init - sum_{i<j}
    dxdt(X[i], t_i) dt. Each of ``n_iters`` sweeps evaluates the score at
    all ``n_steps`` grid points in one forward (time folded into the batch
    axis: the model sees n_steps x B rows) and integrates by a prefix sum.
    Returns (x_final, residuals): residuals[k] = max |update| of sweep k,
    an (n_iters,) tensor on x's device (never read back here)."""
    table = schedule.ode_table(n_steps, t_max, t_min)
    ts, dloga, g2, dt = (compose.constant(table[:, i].tolist(), torch.float32,
                                          x_init.device) for i in (0, 1, 2, 4))
    b, feat = x_init.shape[0], tuple(x_init.shape[1:])

    def col(v):  # (n,) -> (n, 1, ...) against (n, B, ...)
        return v.reshape((-1,) + (1,) * (1 + len(feat)))

    flat_t = ts[:, None].expand(n_steps, b).reshape(-1)
    traj = x_init.expand((n_steps,) + tuple(x_init.shape))
    x_final, residuals = x_init, []
    for _ in range(n_iters):
        s = score_fn(traj.reshape((n_steps * b,) + feat),
                     flat_t).reshape((n_steps, b) + feat)
        steps = (col(dloga) * traj - 0.5 * col(g2) * s) * col(dt)
        csum = torch.cumsum(steps, dim=0)
        new = torch.cat([x_init[None], x_init[None] - csum[:-1]], dim=0)
        residuals.append((new - traj).abs().max())
        traj, x_final = new, x_init - csum[-1]
    return x_final, torch.stack(residuals)


# ---------------------------------------- log-likelihood and bits per dim
def _ll_probes(key, x: torch.Tensor, probe: str, n_probes: int):
    """One step's probes from ``key`` (a ``rng.Draws``) split as the JAX
    ``value_and_div`` splits its key: one probe from the key itself, or one
    from each of ``n_probes`` subkeys. A Rademacher probe is a {0, 1} draw
    times 2 minus 1."""
    keys = [key] if n_probes == 1 else key.split(n_probes)
    out = []
    for k in keys:
        if probe == "rademacher":
            out.append(k.randint(x.shape, 2).to(x.dtype) * 2.0 - 1.0)
        else:
            out.append(k.normal(x.shape, x.dtype))
    return torch.stack(out)


def log_likelihood(score_fn: EpsFn, schedule: VPSchedule,
                   x_data: torch.Tensor, n_steps: int, key=None,
                   probe: str = "rademacher", n_probes: int = 1,
                   exact: bool = False, t_min: float = 1e-3,
                   t_max: float = 1.0,
                   probes: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-example log p(x) in nats under a score model, and the terminal
    latent: the probability-flow ODE dx/dt = f(x, t) = dlog_alpha/dt x -
    0.5 g^2 score integrated FORWARD (Euler, ``n_steps`` from ``t_min`` to
    ``t_max``) with d log p / dt = -div f, so

        log p(x) = log N(x(t_max); 0, v I) + int div f dt,

    v = alpha(t_max)^2 + sigma(t_max)^2. ``score_fn(x, t)`` returns the TRUE
    score (an eps model as -eps_hat / sigma).

    The divergence: Hutchinson probes (``probe``, ``n_probes``), one
    ``torch.func.jvp`` per probe through ``ops.divergence.value_and_div``,
    drawn from ``key`` (an int key, an ``rng.Draws`` or a ``rng.Replay``)
    with the JAX function's structure (the key folded with 0 at every step,
    split in ``n_probes`` when there are several), or handed in as
    ``probes`` (n_steps, n_probes, *x.shape); with ``exact=True`` the exact
    Jacobian trace, one jvp per dimension (tiny dims only). Runs
    forward-mode AD: call it under ``torch.no_grad()``, not
    ``torch.inference_mode()``."""
    if not exact and key is None and probes is None:
        raise ValueError("log_likelihood needs a PRNG key unless exact=True")
    if probe not in PROBE_KINDS:
        raise ValueError(f"unknown probe kind: {probe!r}")
    if probes is not None and tuple(probes.shape) != (
            (n_steps, n_probes) + tuple(x_data.shape)):
        raise ValueError(f"probes: shape {tuple(probes.shape)}, expected "
                         f"{(n_steps, n_probes) + tuple(x_data.shape)}")
    dt = (t_max - t_min) / n_steps
    ts_host = t_min + dt * torch.arange(n_steps, dtype=torch.float32)
    ts = compose.constant(ts_host.tolist(), torch.float32, x_data.device)
    rows = zip(schedule.dlog_alpha_dt(ts_host).tolist(),
               (0.5 * schedule.g2(ts_host)).tolist())
    draws = None if (exact or probes is not None) else as_draws(
        key, x_data.device)
    b = x_data.shape[0]
    x = x_data
    delta = torch.zeros((b,), dtype=torch.float32, device=x.device)
    for i, (dloga, half_g2) in enumerate(rows):
        t = ts[i]

        def f(xx, t=t, dloga=dloga, half_g2=half_g2):
            return dloga * xx - half_g2 * score_fn(xx, t)

        if exact:
            fx, div = exact_div(lambda v: f(v.reshape(x.shape)).reshape(b, -1),
                                x.reshape(b, -1))
            fx = fx.reshape(x.shape)
        else:
            if probes is None:
                draws = draws.fold_in(0)
                v = _ll_probes(draws, x, probe, n_probes)
            else:
                v = probes[i]
            fx, div = value_and_div(f, x, probes=v)
        x = x + fx * dt
        delta = delta + div * dt
    t_end = torch.tensor(t_max, dtype=torch.float32)
    prior_var = float(schedule.alpha(t_end) ** 2 + schedule.sigma(t_end) ** 2)
    dim = math.prod(x_data.shape[1:])
    axes = tuple(range(1, x.dim()))
    log_prior = (-0.5 * (x * x).sum(dim=axes) / prior_var
                 - 0.5 * dim * math.log(2.0 * math.pi * prior_var))
    return log_prior + delta, x


def bits_per_dim(log_p: torch.Tensor, data_shape: Sequence[int],
                 nbins: int = 256) -> torch.Tensor:
    """log p(x) in nats of data in [-1, 1] -> bits per dimension under
    uniform dequantization of ``nbins`` levels (bin width 2 / nbins):
    -log_p / (D ln 2) + log2(nbins / 2)."""
    dim = math.prod(data_shape)
    return -log_p / (dim * math.log(2.0)) + math.log2(nbins / 2.0)
