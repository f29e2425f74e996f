"""Port parity: VPSchedule, sinusoidal_embedding and the DDIM sampler core
against the JAX package, on the same float32 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models.embeddings import (
    sinusoidal_embedding as jax_sinusoidal)
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import samplers, schedules
from composable_diffusion_models_tpu_torch.models.embeddings import (
    sinusoidal_embedding)

torch.set_num_threads(1)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.maximum(np.abs(np.asarray(b)), 1e-30)))


@pytest.mark.parametrize("fn", ["alpha", "sigma", "log_alpha", "log_sigma"])
def test_vp_schedule_coefficients(fn):
    t = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    got = getattr(schedules.VPSchedule(), fn)(torch.from_numpy(t)).numpy()
    ref = np.asarray(getattr(JaxVP(), fn)(jnp.asarray(t)))
    assert got.dtype == np.float32
    # float32 closed forms in the same operation order: <= 1e-6 relative
    assert _rel(got, ref) <= 1e-6, _rel(got, ref)


@pytest.mark.parametrize("n_steps", [10, 50])
def test_ddim_grid_and_table(n_steps):
    s = schedules.VPSchedule()
    grid = s.ddim_grid(n_steps).numpy()
    table = s.ddim_table(n_steps).numpy()
    assert table.shape == (n_steps, 4)
    np.testing.assert_allclose(grid, np.asarray(JaxVP().ddim_grid(n_steps)),
                               rtol=1e-6, atol=0)
    assert _rel(table, np.asarray(JaxVP().ddim_table(n_steps))) <= 1e-6


def test_unported_schedule_options_raise():
    """Every kind and spacing of the JAX package is ported; what it refuses
    (an unknown kind, spacing or beta schedule) the port refuses too."""
    with pytest.raises(ValueError):
        schedules.VPSchedule(kind="vp")
    with pytest.raises(ValueError):
        schedules.VPSchedule().ddim_table(10, spacing="quadratic")
    with pytest.raises(ValueError):
        schedules.DDPMSchedule(beta_schedule="sigmoid").betas


KINDS = ["stable", "jax_faithful", "cosine", "rectified"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fn", ["alpha", "sigma", "log_alpha", "log_sigma",
                                "dlog_alpha_dt", "beta", "g2"])
def test_vp_kinds_match_jax(kind, fn):
    """Every kind's closed forms on t in [0, 0.999] (rectified's g^2 and
    dlog alpha diverge at 1), float32 in the JAX package's operation order.
    The two libraries' exp, log, cos and tan differ by an ulp, and sigma =
    sqrt(1 - alpha^2) turns one ulp of alpha^2 near 1 into ~1e-7 / sigma:
    1e-5 relative or 2e-6 absolute."""
    t = np.linspace(0.0, 0.999, 181, dtype=np.float32)
    got = getattr(schedules.VPSchedule(kind=kind), fn)(
        torch.from_numpy(t)).numpy()
    ref = np.asarray(getattr(JaxVP(kind=kind), fn)(jnp.asarray(t)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_t_of_sigma_and_karras_grid_match_jax(kind):
    s = schedules.VPSchedule(kind=kind)
    sig = np.linspace(0.01, 0.99, 50, dtype=np.float32)
    np.testing.assert_allclose(
        s.t_of_sigma(torch.from_numpy(sig)).numpy(),
        np.asarray(JaxVP(kind=kind).t_of_sigma(jnp.asarray(sig))),
        rtol=1e-5, atol=1e-6)
    for spacing in ("linear", "karras"):
        np.testing.assert_allclose(
            s.ddim_table(20, spacing=spacing).numpy(),
            np.asarray(JaxVP(kind=kind).ddim_table(20, spacing=spacing)),
            rtol=1e-5, atol=1e-6)
    for table in ("em_table", "ode_table"):
        np.testing.assert_allclose(
            getattr(s, table)(16).numpy(),
            np.asarray(getattr(JaxVP(kind=kind), table)(16)),
            rtol=1e-5, atol=1e-6)


def test_q_t_draws_or_replays_noise():
    """q_t on replayed noise is the JAX q_t on the same key's noise; with a
    generator it returns the noise it drew."""
    import jax
    key = jax.random.PRNGKey(3)
    x0 = np.random.default_rng(1).standard_normal((4, 3, 3, 1)).astype(
        np.float32)
    t = np.array([0.1, 0.4, 0.7, 0.95], np.float32)
    ref_xt, ref_eps = JaxVP().q_t(key, jnp.asarray(x0), jnp.asarray(t))
    xt, eps = schedules.VPSchedule().q_t(
        torch.from_numpy(x0), torch.from_numpy(t),
        eps=torch.from_numpy(np.asarray(ref_eps)))
    np.testing.assert_allclose(xt.numpy(), np.asarray(ref_xt), rtol=1e-6,
                               atol=1e-6)
    xt, eps = schedules.VPSchedule().q_t(
        torch.from_numpy(x0), 0.5, gen=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        xt, schedules.VPSchedule().q_t_eps(torch.from_numpy(x0), 0.5, eps))
    with pytest.raises(ValueError):
        schedules.VPSchedule().q_t(torch.from_numpy(x0), 0.5)


@pytest.mark.parametrize("beta_schedule", ["linear", "cosine"])
def test_ddpm_tables_match_jax(beta_schedule):
    from composable_diffusion_models_tpu.schedules import (
        DDPMSchedule as JaxDDPM)
    """float32 tables: 1e-5 relative where no difference of numbers near 1
    is taken. Where one is (cosine betas = 1 - abar_t / abar_{t-1}, the
    sqrt(1 - abar) of the first steps, the posterior variance's
    (1 - abar_prev) / (1 - abar)), one float32 ulp of a number near 1
    (6e-8, the libraries' cos and cumulative products differ by that)
    is the scale: 3e-7 absolute, and 3e-6 after sqrt(1 - abar) divides
    it by 2 sqrt(1e-4)."""
    s, j = (schedules.DDPMSchedule(beta_schedule=beta_schedule),
            JaxDDPM(beta_schedule=beta_schedule))
    for name, atol in (("betas", 3e-7), ("alphas_cumprod", 0),
                       ("alphas_cumprod_prev", 0),
                       ("sqrt_alphas_cumprod", 0),
                       ("sqrt_one_minus_alphas_cumprod", 3e-6),
                       ("sqrt_recip_alphas", 0),
                       ("posterior_variance", 3e-7)):
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-5, atol=atol, err_msg=name)
    np.testing.assert_allclose(s.table().numpy(), np.asarray(j.table()),
                               rtol=1e-5, atol=3e-6)
    # finite differences of adjacent logs times T = 1000: an ulp of a log
    # (up to 5e-7 at |log| ~ 5) becomes ~5e-4
    for got, ref in zip(s.fd_sde_tables(), j.fd_sde_tables()):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3,
                                   atol=1e-3)
    steps = np.array([0, 5, 500, 999])
    for got, ref in zip(s.sde_coeffs(torch.from_numpy(steps)),
                        j.sde_coeffs(jnp.asarray(steps))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    x0 = np.ones((4, 2, 2, 1), np.float32)
    eps = np.full((4, 2, 2, 1), 0.5, np.float32)
    xt, _ = s.q_sample(torch.from_numpy(x0), torch.from_numpy(steps),
                       eps=torch.from_numpy(eps))
    ref = (np.asarray(j.sqrt_alphas_cumprod)[steps][:, None, None, None]
           * x0 + np.asarray(j.sqrt_one_minus_alphas_cumprod)[steps][
               :, None, None, None] * eps)
    np.testing.assert_allclose(xt.numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dim", [4, 64, 256])
def test_sinusoidal_embedding(dim):
    t = np.array([0.0, 1e-3, 0.37, 0.5, 1.0], np.float32)
    got = sinusoidal_embedding(torch.from_numpy(t), dim).numpy()
    ref = np.asarray(jax_sinusoidal(jnp.asarray(t), dim))
    assert got.shape == (5, dim)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_sinusoidal_embedding_rejects_bad_dim():
    with pytest.raises(ValueError):
        sinusoidal_embedding(torch.zeros(1), 3)


def test_ddim_matches_jax_on_analytic_eps():
    """Sampler core alone: a fixed eps closure (linear in x, depends on t)
    through both DDIM loops, clip gate included; float32 roundoff only."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 6, 6, 1)).astype(np.float32) * 2
    ref = np.asarray(jsamplers.ddim(lambda x, t: 0.7 * x + t, JaxVP(),
                                    jnp.asarray(x0), 20))
    got = samplers.ddim(lambda x, t: 0.7 * x + t, schedules.VPSchedule(),
                        torch.from_numpy(x0), 20).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_ddim_unported_variants_raise():
    """Every variant of the JAX sampler is ported now; what still raises
    is what the JAX sampler refuses too: eta > 0 or the corrector without
    a key, v prediction off the stable kind, an unknown prediction."""
    x = torch.zeros(1, 4, 4, 1)
    for kw in ({"eta": 0.5}, {"corrector_steps": 1}):
        with pytest.raises(ValueError, match="key"):
            samplers.ddim(lambda x, t: x, schedules.VPSchedule(), x, 2, **kw)
    with pytest.raises(ValueError, match="stable"):
        samplers.ddim(lambda x, t: x, schedules.VPSchedule(kind="cosine"), x,
                      2, predict="v")
    with pytest.raises(ValueError):
        samplers.ddim(lambda x, t: x, schedules.VPSchedule(), x, 2,
                      predict="score")
