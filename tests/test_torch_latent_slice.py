"""Port parity for the latent slice as a whole: each new sampler against
the JAX package with the JAX draws replayed through ``noise=`` /
``probes=``, and ``entry.sample_latent`` for its four operators against the
scripts' composition written out with the JAX package
(``scripts/latent_shape_experts.py``, ``scripts/sample_latent.py``), at
the presets' full width (two ``ScoreMLP(256, 3, 2)`` experts), small batch
and few steps. float32 throughout.

Tolerances. The experts are random and the samplers start at t = 1, where
alpha ~ 7e-3: latents reach magnitudes of 1e2-1e3, so every bar is relative
to the reference's largest value. Per step the two packages differ by
float32 summation order in four Dense layers; over 25 steps the samplers
reach, as fractions of scale: 2e-7 (Euler-Maruyama, probability flow), 4e-7
(DDIM), 1e-6 (Ito kappa), 2e-5 and 8e-5 (superposition: latents and
log-likelihood). Bar: 1e-3 of scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models import ScoreMLP as JaxScoreMLP
from composable_diffusion_models_tpu.ops import divergence as jdiv
from composable_diffusion_models_tpu.ops import pca as jpca
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import convert, entry, samplers
from composable_diffusion_models_tpu_torch.ops import kernels
from composable_diffusion_models_tpu_torch.schedules import VPSchedule

torch.set_num_threads(1)
N_STEPS, BATCH, REL_TOL = 25, 12, 1e-3
JM = JaxScoreMLP(hidden=256, depth=3, out_dim=2)
TM = entry.SHAPES_LATENT_MLP


def _np(x):
    return np.asarray(x)


def _close(got, ref, rel=REL_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= rel * scale, (
        float(np.abs(got - ref).max()), scale)


@pytest.fixture(scope="module")
def setup():
    """Two full-width experts from ``convert.init_params``, the initial
    latents, and a PCA fitted by the JAX package on seeded 8 x 8 images."""
    trees = [convert.init_params(TM, seed=20 + i) for i in range(2)]
    jtrees = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    rng = np.random.default_rng(0)
    z0 = rng.standard_normal((BATCH, 2)).astype(np.float32)
    basis = rng.standard_normal((2, 64))
    imgs = (rng.standard_normal((80, 2)) @ basis * 0.3
            + 0.02 * rng.standard_normal((80, 64))).reshape(
                80, 8, 8, 1).astype(np.float32)
    jp = jpca.fit_pca(jnp.asarray(imgs), 2)
    tp = convert.pca_from_numpy(_np(jp.mean), _np(jp.components),
                                _np(jp.explained_variance))
    return ([convert.from_flax(t) for t in trees], jtrees, z0, jp, tp)


def _jax_eps_fn(jtrees, w=(1.0, 1.0)):
    def eps_fn(x, t):
        stack = jnp.stack([JM.apply(p, t, x) for p in jtrees])
        return jcompose.weighted(stack, jnp.asarray(w, jnp.float32))
    return eps_fn


def _torch_eps_fn(trees, w=(1.0, 1.0)):
    wt = torch.tensor(w)

    def eps_fn(x, t):
        return kernels.blend_eps(
            torch.stack([TM.apply(p, t, x) for p in trees]), wt)
    return eps_fn


def _jax_score_fns(jtrees):
    return tuple((lambda x, t, p=p: -JM.apply(p, t, x)) for p in jtrees)


def _torch_score_fns(trees):
    return tuple((lambda x, t, p=p: -TM.apply(p, t, x)) for p in trees)


def _em_noise(key, n_steps, shape):
    """The draws of ``jsamplers.euler_maruyama``'s scan body, in its
    order: k, sub = split(k); normal(sub)."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(_np(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def _ito_probes(key, n_steps, shape):
    """``ito_kappa_ode``: k, k1, k2 = split(k, 3); one Rademacher probe per
    expert."""
    out = []
    for _ in range(n_steps):
        key, k1, k2 = jax.random.split(key, 3)
        out.append(np.stack([
            _np(jdiv._probe(k, shape, jnp.float32, "rademacher"))
            for k in (k1, k2)]))
    return np.stack(out)


def _superposition_probes(key, n_steps, shape):
    """``superposition_2d``: k, kp = split(k); ONE probe for both experts."""
    out = []
    for _ in range(n_steps):
        key, kp = jax.random.split(key)
        out.append(_np(jdiv._probe(kp, shape, jnp.float32, "rademacher")))
    return np.stack(out)


# ----------------------------------------------------------------- samplers
@pytest.mark.parametrize("xi", [1.0, 0.0, 0.4])
def test_euler_maruyama_matches_jax(setup, xi):
    trees, jtrees, z0, _, _ = setup
    key = jax.random.PRNGKey(3)
    ref = jsamplers.euler_maruyama(_jax_eps_fn(jtrees), JaxVP(), key,
                                   jnp.asarray(z0), N_STEPS, xi)
    noise = torch.from_numpy(_em_noise(key, N_STEPS, z0.shape))
    got = samplers.euler_maruyama(_torch_eps_fn(trees), VPSchedule(), None,
                                  torch.from_numpy(z0), N_STEPS, xi,
                                  noise=noise)
    _close(got.numpy(), ref)


def test_euler_maruyama_traj_matches_jax(setup):
    trees, jtrees, z0, _, _ = setup
    key = jax.random.PRNGKey(4)
    ref = jsamplers.euler_maruyama_traj(
        _jax_eps_fn(jtrees, (2.0, 0.5)), JaxVP(), key, jnp.asarray(z0),
        N_STEPS, t_max=0.9, t_min=0.01)
    noise = torch.from_numpy(_em_noise(key, N_STEPS, z0.shape))
    got = samplers.euler_maruyama_traj(
        _torch_eps_fn(trees, (2.0, 0.5)), VPSchedule(), None,
        torch.from_numpy(z0), N_STEPS, t_max=0.9, t_min=0.01, noise=noise)
    assert tuple(got.shape) == (N_STEPS + 1, BATCH, 2)
    np.testing.assert_array_equal(got[0].numpy(), z0)
    _close(got.numpy(), ref)


def test_euler_maruyama_own_draws():
    """With a generator: reproducible from its seed, different across
    seeds, and at xi = 0 equal to the noise-free update. A missing
    generator or a wrong ``noise`` shape raises."""
    def eps_fn(x, t):
        return 0.5 * x

    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, 2)).astype(np.float32))

    def run(seed, xi=1.0):
        return samplers.euler_maruyama(
            eps_fn, VPSchedule(), torch.Generator().manual_seed(seed), x0, 8,
            xi)

    np.testing.assert_array_equal(run(0).numpy(), run(0).numpy())
    assert float((run(0) - run(1)).abs().max()) > 1e-3
    np.testing.assert_array_equal(
        run(0, 0.0).numpy(), samplers.euler_maruyama(
            eps_fn, VPSchedule(), None, x0, 8, 0.0,
            noise=torch.zeros(8, 6, 2)).numpy())
    with pytest.raises(ValueError, match="Generator"):
        samplers.euler_maruyama(eps_fn, VPSchedule(), None, x0, 8)
    with pytest.raises(ValueError, match="noise"):
        samplers.euler_maruyama(eps_fn, VPSchedule(), None, x0, 8,
                                noise=torch.zeros(7, 6, 2))


def test_euler_maruyama_moves_with_the_score():
    """The corrected sign: with the exact score of N(0, I) data
    (eps_hat = sigma x) the reverse SDE keeps samples at unit scale; the
    against-the-score update diverges."""
    sched = VPSchedule()
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (512, 2)).astype(np.float32))
    out = samplers.euler_maruyama(
        lambda x, t: sched.sigma(t) * x, sched,
        torch.Generator().manual_seed(0), x0, 200)
    assert 0.8 < float(out.std()) < 1.2


@pytest.mark.parametrize("t_max,t_min", [(1.0, 1e-3), (0.8, 0.05)])
def test_prob_flow_ode_matches_jax(setup, t_max, t_min):
    trees, jtrees, z0, _, _ = setup
    jvp_, tvp = JaxVP(), VPSchedule()
    js, ts_ = _jax_score_fns(jtrees), _torch_score_fns(trees)
    ref = jsamplers.prob_flow_ode(
        lambda x, t: js[0](x, t) / jvp_.sigma(t), jvp_, jnp.asarray(z0),
        N_STEPS, t_max, t_min)
    got = samplers.prob_flow_ode(
        lambda x, t: ts_[0](x, t) / tvp.sigma(t), tvp, torch.from_numpy(z0),
        N_STEPS, t_max, t_min)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("clip_kappa", [None, (-1.0, 2.0)])
def test_ito_kappa_ode_matches_jax(setup, clip_kappa):
    """kappa divides by ||s1 - s2||^2 and multiplies divergences, so this
    sampler amplifies rounding more than the plain ones: ~1e-6 of scale
    here against their 2e-7, under the shared bar."""
    trees, jtrees, z0, _, _ = setup
    key = jax.random.PRNGKey(6)
    ref = jsamplers.ito_kappa_ode(_jax_score_fns(jtrees), JaxVP(), key,
                                  jnp.asarray(z0), N_STEPS,
                                  clip_kappa=clip_kappa)
    probes = torch.from_numpy(_ito_probes(key, N_STEPS, z0.shape))
    with torch.no_grad():
        got = samplers.ito_kappa_ode(
            _torch_score_fns(trees), VPSchedule(), None, torch.from_numpy(z0),
            N_STEPS, clip_kappa=clip_kappa, probes=probes)
    _close(got.numpy(), ref)


def test_ito_kappa_ode_own_draws(setup):
    trees, _, z0, _, _ = setup
    fns = _torch_score_fns(trees)

    def run(seed, probe="rademacher"):
        return samplers.ito_kappa_ode(
            fns, VPSchedule(), torch.Generator().manual_seed(seed),
            torch.from_numpy(z0), 5, probe=probe)

    np.testing.assert_array_equal(run(0).numpy(), run(0).numpy())
    assert float((run(0) - run(1)).abs().max()) > 0
    assert bool(torch.isfinite(run(0, "gaussian")).all())
    with pytest.raises(ValueError, match="unknown probe"):
        run(0, "uniform")
    with pytest.raises(ValueError, match="Generator"):
        samplers.ito_kappa_ode(fns, VPSchedule(), None,
                               torch.from_numpy(z0), 5)


def test_superposition_2d_matches_jax(setup):
    """Starts at t = 1 exactly and ends at 1 / n_steps; the log-likelihood
    integral sums terms of the latents' scale squared: same relative bar,
    on ll's own scale."""
    trees, jtrees, z0, _, _ = setup
    key = jax.random.PRNGKey(7)
    x_ref, ll_ref = jsamplers.superposition_2d(
        _jax_score_fns(jtrees), JaxVP(), key, jnp.asarray(z0), N_STEPS)
    probes = torch.from_numpy(_superposition_probes(key, N_STEPS, z0.shape))
    x, ll = samplers.superposition_2d(
        _torch_score_fns(trees), VPSchedule(), None, torch.from_numpy(z0),
        N_STEPS, probes=probes)
    assert tuple(ll.shape) == (2, BATCH)
    _close(x.numpy(), x_ref)
    _close(ll.numpy(), ll_ref)


# ------------------------------------------------------------ sample_latent
def _jax_composition(op, jtrees, z0, jp, key, n_steps, weights, xi):
    """What the two scripts compute, written out with the JAX package."""
    sched = JaxVP()
    z0 = jnp.asarray(z0)
    eps_fn = _jax_eps_fn(jtrees, weights)
    sa, sb = _jax_score_fns(jtrees)
    if op == "ddim":
        z = jsamplers.ddim(eps_fn, sched, z0, n_steps, clip=None)
    elif op == "em":
        z = jsamplers.euler_maruyama(
            lambda x, t: eps_fn(x, jnp.full((x.shape[0],), t)), sched, key,
            z0, n_steps, xi)
    elif op == "avg":
        z = jsamplers.prob_flow_ode(
            lambda x, t: 0.5 * (sa(x, t) + sb(x, t)) / sched.sigma(t), sched,
            z0, n_steps)
    else:
        z = jsamplers.ito_kappa_ode((sa, sb), sched, key, z0, n_steps)
    return z, jnp.clip(jp.decode(z, (8, 8, 1)), -1.0, 1.0)


@pytest.mark.parametrize("op,weights,fused_blend", [
    ("ddim", None, True), ("ddim", (2.0, 0.5), False), ("em", None, True),
    ("em", (1.0, 3.0), False), ("avg", None, True), ("ito", None, True)])
def test_sample_latent_matches_jax(setup, op, weights, fused_blend):
    """The slice end to end on the CPU: latents within 1e-3 of scale, and
    the decoded, clipped images (one more GEMM over k = 2) within 1e-3 of
    the latents' scale times the components' unit norm."""
    trees, jtrees, z0, jp, tp = setup
    key = jax.random.PRNGKey(11)
    z_ref, img_ref = _jax_composition(op, jtrees, z0, jp, key, N_STEPS,
                                      weights or (1.0, 1.0), 0.7)
    kw = {}
    if op == "em":
        kw["noise"] = torch.from_numpy(_em_noise(key, N_STEPS, z0.shape))
    if op == "ito":
        kw["probes"] = torch.from_numpy(_ito_probes(key, N_STEPS, z0.shape))
    n0 = (kernels.blend_eps.launches, kernels.matmul.launches)
    z, imgs = entry.sample_latent(trees, tp, z0, op=op, n_steps=N_STEPS,
                                  weights=weights, xi=0.7,
                                  fused_blend=fused_blend, device="cpu", **kw)
    assert z.dtype == imgs.dtype == torch.float32
    assert tuple(imgs.shape) == (BATCH, 8, 8, 1)
    assert float(imgs.abs().max()) <= 1.0
    _close(z.numpy(), z_ref)
    scale = max(1.0, float(np.abs(_np(z_ref)).max()))
    assert float(np.abs(imgs.numpy() - _np(img_ref)).max()) <= REL_TOL * scale
    # a CPU tensor never counts as a kernel launch
    assert n0 == (kernels.blend_eps.launches, kernels.matmul.launches)


def test_sample_latent_own_draws_and_checks(setup, monkeypatch):
    """Seeded draws repeat; K = 3 blends; avg and ito want 2 experts; an
    unknown op raises; device=None means the card."""
    trees, _, z0, _, tp = setup

    def run(op, seed=0, params=trees):
        return entry.sample_latent(params, tp, z0, op=op, n_steps=4,
                                   seed=seed, device="cpu")[0]

    for op in ("em", "ito"):
        np.testing.assert_array_equal(run(op).numpy(), run(op).numpy())
        assert float((run(op) - run(op, seed=1)).abs().max()) > 0
    assert tuple(run("ddim", params=trees + trees[:1]).shape) == (BATCH, 2)
    for op in ("avg", "ito"):
        with pytest.raises(ValueError, match="exactly 2"):
            run(op, params=trees[:1])
    with pytest.raises(ValueError, match="op must be"):
        run("superdiff")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.sample_latent(trees, tp, z0, n_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.load_pca(tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.load_latent_experts(trees)


def test_load_pca_from_files(setup, tmp_path):
    """``entry.load_pca`` takes the JAX package's ``.npy`` files."""
    _, _, _, jp, tp = setup
    prefix = str(tmp_path / "pca_grayscale")
    jpca.save_pca(prefix, jp)
    loaded = entry.load_pca(prefix, device="cpu")
    for name in ("mean", "components", "explained_variance", "components_t"):
        np.testing.assert_array_equal(getattr(loaded, name).numpy(),
                                      getattr(tp, name).numpy())
    assert entry.load_pca(tp, device="cpu").mean.device.type == "cpu"
