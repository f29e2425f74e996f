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
    with pytest.raises(NotImplementedError):
        schedules.VPSchedule(kind="cosine")
    with pytest.raises(NotImplementedError):
        schedules.VPSchedule().ddim_table(10, spacing="karras")


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
    x = torch.zeros(1, 4, 4, 1)
    for kw in ({"eta": 0.5}, {"predict": "v"}, {"corrector_steps": 1}):
        with pytest.raises(NotImplementedError):
            samplers.ddim(lambda x, t: x, schedules.VPSchedule(), x, 2, **kw)
    with pytest.raises(ValueError):
        samplers.ddim(lambda x, t: x, schedules.VPSchedule(), x, 2,
                      predict="score")
