"""Reverse-time integrators over a prediction closure, and the CFG closure.

Port of ``composable_diffusion_models_tpu.samplers``: ``ddim`` (eta = 0, eps
prediction, linear or Karras spacing, the x0 clamp gated by alpha),
``euler_maruyama`` / ``euler_maruyama_traj``, ``prob_flow_ode``,
``ito_kappa_ode``, ``superposition_2d`` and ``make_cfg_eps_fn``. Each JAX
``lax.scan`` over a precomputed table becomes a Python loop; the tables stay
on the host with the per-step coefficients computed there in float32, in the
JAX package's operation order, so the loop hands the card plain floats and
never waits for it.

Randomness: where the JAX sampler takes a PRNG key, these take a
``torch.Generator`` on x's device in its place, and an optional ``noise=`` /
``probes=`` tensor of shape (n_steps, ...) that replaces the draws (the two
frameworks give different numbers from one seed, so a test replays the JAX
draws through it).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import compose
from .ops.divergence import PROBE_KINDS, draw_probe, value_and_div
from .schedules import VPSchedule

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim(eps_fn: EpsFn, schedule: VPSchedule, x_init: torch.Tensor,
         n_steps: int, clip: Optional[Tuple[float, float]] = (-1.0, 1.0),
         clip_min_alpha: float = 0.3, t_max: float = 1.0,
         t_min: float = 1e-3, eta: float = 0.0, predict: str = "eps",
         spacing: str = "linear", corrector_steps: int = 0) -> torch.Tensor:
    """DDIM update over ``schedule.ddim_grid(n_steps, t_max, t_min)``:

      x0 = (x - sigma_now * eps) / alpha_now, clamped to ``clip`` once
           alpha_now >= clip_min_alpha
      x  = alpha_next * x0 + sigma_next * eps

    ``eps_fn(x, t)`` receives a 0-d float32 ``t`` on x's device. Still to
    port, and raising until then: the stochastic form (eta > 0), x0 and v
    prediction and the Langevin corrector."""
    if predict not in ("eps", "x0", "v"):
        raise ValueError(f"predict must be 'eps', 'x0' or 'v', "
                         f"got {predict!r}")
    if predict != "eps" or eta > 0.0 or corrector_steps > 0:
        raise NotImplementedError(
            "only deterministic eps-prediction DDIM (eta=0, no corrector) "
            "is ported")
    table = schedule.ddim_table(n_steps, t_max, t_min, spacing).tolist()
    ts = schedule.ddim_grid(n_steps, t_max, t_min, spacing)[:-1].to(
        x_init.device)
    # the gate compares float32 values, as the JAX sampler does
    gate = torch.tensor(clip_min_alpha, dtype=torch.float32).item()
    x = x_init
    for i, (a_now, s_now, a_next, s_next) in enumerate(table):
        out = eps_fn(x, ts[i])
        x0 = (x - s_now * out) / a_now
        if clip is not None and a_now >= gate:
            x0 = x0.clamp(clip[0], clip[1])
        x = a_next * x0 + s_next * out
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
    ts = table[:, 0].to(x_init.device)
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
    ts = table[:, 0].to(x_init.device)
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
    ts = ts_host.to(x_init.device)
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
    ts = ts_host.to(x_init.device)
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
