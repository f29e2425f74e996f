"""Port parity for the discrete-DDPM composition samplers and their entry
points, against the JAX package on the same inputs:

* the samplers' own arithmetic with closed-form Gaussian experts (an exact
  eps per timestep) over the full ``DDPMSchedule(1000)``, on the JAX
  schedule's float32 tables (``test_torch_schedules.py`` holds the port's
  own tables to them; an ulp of abar near 1 is 6e-4 of 1 - abar, which
  would hide the sampler's arithmetic here) and with the JAX draws replayed
  through ``noise=``: ``ddpm_ancestral``, ``superdiff``
  (OR with a scalar and a per-expert bias, AND, FIXED, AVG),
  ``superdiff_and_solve`` (OR and AND at K = 2 and 3) and ``layout`` with
  overlapping masks;
* the two compose repairs: ``or_softmax`` refuses a non-zero scalar bias
  before it makes any tensor, and ``and_solve_k`` (now ``solve_ex``
  without its error check) gives the values of the ``linalg.solve`` form
  bit for bit;
* ``entry.sample_superdiff`` (every operation, and the rigorous AND and
  OR), ``entry.sample_layout`` and ``entry.sample_ancestral`` whole at
  ``device="cpu"`` on narrow UNets (base 8, mults (1, 2), 8 x 8 images) at
  ``DDPMSchedule(12)``, against the computation of ``scripts/superdiff.py``,
  ``scripts/layout_compose.py`` and ``scripts/compose_bbox.py`` with the
  JAX ``UNet`` on XLA's GroupNorm (``use_pallas=False``) and the port on
  ``fused_gn=True`` (K4's plain version on CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu import experts as jexperts
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models import UNet as JaxUNet
from composable_diffusion_models_tpu.schedules import DDPMSchedule as JaxDDPM
from composable_diffusion_models_tpu_torch import (compose, convert, entry,
                                                   samplers)
from composable_diffusion_models_tpu_torch.schedules import DDPMSchedule

torch.set_num_threads(1)

T_FULL = 1000
SHAPE = (4, 4, 4, 2)          # (B, H, W, C) of the closed-form cases
KEY = jax.random.PRNGKey(3)


# ------------------------------------------------ closed-form experts
@dataclasses.dataclass(frozen=True)
class _JaxTables(DDPMSchedule):
    """The port's DDPM schedule reading the JAX schedule's float32 tables."""

    def _jax(self, name):
        val = getattr(JaxDDPM(num_timesteps=self.num_timesteps), name)
        return val if callable(val) else torch.from_numpy(np.array(val))

    betas = property(lambda self: self._jax("betas"))
    alphas = property(lambda self: self._jax("alphas"))
    alphas_cumprod = property(lambda self: self._jax("alphas_cumprod"))
    alphas_cumprod_prev = property(
        lambda self: self._jax("alphas_cumprod_prev"))

    def table(self):
        return torch.from_numpy(np.array(self._jax("table")()))

    def fd_sde_tables(self):
        return tuple(torch.from_numpy(np.array(a)) for a in JaxDDPM(
            num_timesteps=self.num_timesteps).fd_sde_tables())


def _gaussians(k, seed=0):
    """K Gaussian data distributions N(mu_k, v_k I) over SHAPE[1:]."""
    rng = np.random.default_rng(seed)
    mus = rng.uniform(-0.6, 0.6, (k,) + SHAPE[1:]).astype(np.float32)
    vs = rng.uniform(0.03, 0.2, k).astype(np.float32)
    return mus, vs


def _eps_coeffs(mus, vs, n=T_FULL):
    """Per timestep and expert, the exact eps of x_t under N(mu, v):
    eps = c (x - m mu) with m = sqrt(abar), c = sqrt(1 - abar) /
    (abar v + 1 - abar); float32 host tables both sides index."""
    abar = np.asarray(JaxDDPM(num_timesteps=n).alphas_cumprod)[:, None]
    c = (np.sqrt(1 - abar) / (abar * vs[None] + 1 - abar)).astype(np.float32)
    return c, np.sqrt(abar).astype(np.float32)


def _closed_form(k, seed=0, n=T_FULL):
    """(jax eps_stack_fn, torch eps_stack_fn) of K Gaussian experts."""
    mus, vs = _gaussians(k, seed)
    c, m = _eps_coeffs(mus, vs, n)
    jc, jm, jmu = jnp.asarray(c), jnp.asarray(m), jnp.asarray(mus)
    tmu = torch.from_numpy(mus)
    cl, ml = c.tolist(), m[:, 0].tolist()

    def jax_fn(x, ti):
        return jnp.stack([jc[ti, i] * (x - jm[ti, 0] * jmu[i])
                          for i in range(k)])

    def torch_fn(x, ti):
        return torch.stack([cl[ti][i] * (x - ml[ti] * tmu[i])
                            for i in range(k)])

    return jax_fn, torch_fn


def _jax_draws(key, n, shape, per_step=1):
    """The normals a JAX DDPM sampler draws: it splits its carried key
    before each draw, ``per_step`` times a step."""
    def body(k, _):
        zs = []
        for _ in range(per_step):
            k, sub = jax.random.split(k)
            zs.append(jax.random.normal(sub, shape, jnp.float32))
        return k, zs[0] if per_step == 1 else jnp.stack(zs)
    return np.asarray(jax.lax.scan(body, key, None, length=n)[1])


@pytest.fixture(scope="module")
def x_init():
    return np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def draws():
    return {1: np.array(_jax_draws(KEY, T_FULL, SHAPE)),
            2: np.array(_jax_draws(KEY, T_FULL, SHAPE, per_step=2))}


def _close(got, ref, tol):
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert err <= tol * scale, (err, scale)


# Bars: the sampler's arithmetic alone, 1000 steps, on the same tables and
# draws. Measured (max |diff| at output scale ~1): ancestral 2e-7, layout
# 6e-7, AVG 2e-7, FIXED 4e-7, the rigorous AND 2-3e-7, the solve's OR
# 2-5e-6, OR 3e-6: 1e-5 of the scale. The heuristic AND feeds log_q back
# through softmax(-log_q): log_q grows to ~230 over 1000 steps, where the
# float32 sums of <dx, s> in two reduction orders part by ~5e-4 (step 1
# agrees to an ulp), and x by 1.9e-5; the JAX sampler compiled and the same
# sampler run op by op (``jax.disable_jit``) part by 1.2e-5 there. It is
# held to 5e-5 of the scale.
TOL = 1e-5
TOL_AND_HEURISTIC = 5e-5


@pytest.mark.parametrize("noise_scale", [1.0, 0.7])
def test_ddpm_ancestral_matches_jax(x_init, draws, noise_scale):
    jfn, tfn = _closed_form(1)
    ref = np.asarray(jsamplers.ddpm_ancestral(
        lambda x, ti: jfn(x, ti)[0], JaxDDPM(), KEY, jnp.asarray(x_init),
        noise_scale=noise_scale))
    got = samplers.ddpm_ancestral(
        lambda x, ti: tfn(x, ti)[0], _JaxTables(), None,
        torch.from_numpy(x_init), noise_scale=noise_scale,
        noise=torch.from_numpy(draws[1])).numpy()
    _close(got, ref, TOL)


@pytest.mark.parametrize("op,temp,bias,kappa", [
    ("OR", 1.0, 0.0, None), ("OR", 0.5, (0.4, -0.4), None),
    ("AND", 1.0, 0.0, None), ("FIXED", 1.0, 0.0, (0.7, 0.3)),
    ("AVG", 1.0, 0.0, None)])
def test_superdiff_matches_jax(x_init, draws, op, temp, bias, kappa):
    jfn, tfn = _closed_form(2)
    jbias = bias if np.ndim(bias) == 0 else jnp.asarray(bias)
    ref = np.asarray(jsamplers.superdiff(
        jfn, JaxDDPM(), KEY, jnp.asarray(x_init), operation=op, temp=temp,
        bias=jbias, kappa_fixed=kappa))
    got = samplers.superdiff(
        tfn, _JaxTables(), None, torch.from_numpy(x_init), operation=op,
        temp=temp, bias=bias, kappa_fixed=kappa,
        noise=torch.from_numpy(draws[1])).numpy()
    _close(got, ref, TOL_AND_HEURISTIC if op == "AND" else TOL)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("mode", ["OR", "AND"])
def test_superdiff_and_solve_matches_jax(x_init, draws, mode, k):
    jfn, tfn = _closed_form(k, seed=k)
    ref = np.asarray(jsamplers.superdiff_and_solve(
        jfn, JaxDDPM(), KEY, jnp.asarray(x_init), mode=mode, k_experts=k))
    got = samplers.superdiff_and_solve(
        tfn, _JaxTables(), None, torch.from_numpy(x_init), mode=mode,
        noise=torch.from_numpy(draws[2 if mode == "AND" else 1])).numpy()
    _close(got, ref, TOL)


def test_layout_matches_jax(x_init, draws):
    """Three experts, the second and third masks overlapping the first and
    each other (the last on top)."""
    jfn, tfn = _closed_form(3, seed=5)
    h, w = SHAPE[1:3]
    masks = np.zeros((3, h, w), np.float32)
    masks[0] = 1.0
    masks[1, :3, :3] = 1.0
    masks[2, 1:, 2:] = 0.5
    ref = np.asarray(jsamplers.layout(jfn, JaxDDPM(), KEY, jnp.asarray(x_init),
                                      jnp.asarray(masks)))
    got = samplers.layout(tfn, _JaxTables(), None, torch.from_numpy(x_init),
                          torch.from_numpy(masks),
                          noise=torch.from_numpy(draws[1])).numpy()
    _close(got, ref, TOL)


def test_samplers_check_their_arguments(x_init):
    _, tfn = _closed_form(2, n=4)
    x = torch.from_numpy(x_init)
    sde = DDPMSchedule(num_timesteps=4)
    with pytest.raises(ValueError, match="kappa_fixed"):
        samplers.superdiff(tfn, sde, torch.Generator(), x, operation="FIXED")
    with pytest.raises(ValueError, match="operation"):
        samplers.superdiff(tfn, sde, torch.Generator(), x, operation="XOR")
    with pytest.raises(ValueError, match="inert"):
        samplers.superdiff(tfn, sde, torch.Generator(), x, bias=0.5)
    with pytest.raises(ValueError, match="mode"):
        samplers.superdiff_and_solve(tfn, sde, torch.Generator(), x,
                                     mode="AVG")
    with pytest.raises(ValueError, match="k_experts"):
        samplers.superdiff_and_solve(tfn, sde, torch.Generator(), x,
                                     k_experts=3)
    with pytest.raises(ValueError, match="noise"):
        samplers.superdiff_and_solve(tfn, sde, None, x,
                                     noise=torch.zeros((4,) + SHAPE))
    with pytest.raises(ValueError, match="Generator"):
        samplers.ddpm_ancestral(lambda x, ti: x, sde, None, x)


def test_generator_draws_are_reproducible(x_init):
    """Without ``noise=``, a seeded generator gives the same run twice, and
    another seed another run."""
    _, tfn = _closed_form(2, n=6)
    x, sde = torch.from_numpy(x_init), DDPMSchedule(num_timesteps=6)

    def run(seed):
        return samplers.superdiff_and_solve(
            tfn, sde, torch.Generator().manual_seed(seed), x)
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))


# ---------------------------------------------------------- compose repairs
def test_or_softmax_checks_a_scalar_bias_before_making_a_tensor(monkeypatch):
    log_q = torch.randn(2, 3)
    want = torch.softmax(log_q, dim=0)

    def no_tensor(*a, **k):
        raise AssertionError("made a tensor")
    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, no_tensor)
    for bias in (0.5, np.float32(-2.0), np.array(1.0)):
        with pytest.raises(ValueError, match="inert"):
            compose.or_softmax(log_q, bias=bias)
    for bias in (0.0, np.float64(0.0), 0):
        assert torch.equal(compose.or_softmax(log_q, bias=bias), want)
    monkeypatch.undo()
    # a 0-d tensor is read; a per-expert bias tilts the blend as in JAX
    with pytest.raises(ValueError, match="inert"):
        compose.or_softmax(log_q, bias=torch.tensor(0.5))
    for bias in ([0.3, -0.3], np.array([[0.3], [-0.3]]),
                 torch.tensor([0.3, -0.3])):
        ref = np.asarray(jcompose.or_softmax(
            jnp.asarray(log_q.numpy()), 0.7, jnp.asarray(np.asarray(bias))))
        got = compose.or_softmax(log_q, 0.7, bias).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _and_solve_k_before(a, b, bias=0.0):
    """``compose.and_solve_k`` as it was: ``torch.linalg.solve``."""
    bsz, k = b.shape
    mat = torch.cat([a[:, :-1, :] - a[:, 1:, :],
                     torch.ones((bsz, 1, k), dtype=a.dtype)], dim=1)
    rb = torch.as_tensor(bias, dtype=b.dtype)
    rb = rb if rb.dim() == 0 else rb[1:] - rb[:-1]
    rhs = torch.cat([b[:, 1:] - b[:, :-1] + rb,
                     torch.ones((bsz, 1), dtype=b.dtype)], dim=1)
    safe = torch.linalg.det(mat).abs() > 1e-12
    eye = torch.eye(k, dtype=a.dtype).expand_as(mat)
    kappa = torch.linalg.solve(torch.where(safe[:, None, None], mat, eye),
                               rhs[..., None]).squeeze(-1)
    ok = safe & torch.isfinite(kappa).all(dim=1)
    kappa = torch.where(ok[:, None], kappa, 1.0 / k).clamp(0.0, 1.0)
    total = kappa.sum(dim=1, keepdim=True)
    return torch.where(total > 0, kappa / total.clamp(min=1e-12), 1.0 / k)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("bias", [0.25, "per_expert"])
def test_and_solve_k_keeps_its_bits(k, bias):
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((64, k, k)).astype(np.float32))
    a[:4] = 0.0                                   # singular systems
    a[4:8, 1:] = a[4:8, :1]                       # equal rows: singular
    b = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    if bias == "per_expert":
        bias = rng.standard_normal(k).astype(np.float32).tolist()
    got = compose.and_solve_k(a, b, bias)
    assert torch.equal(got, _and_solve_k_before(a, b, bias))
    ref = np.asarray(jcompose.and_solve_k(jnp.asarray(a.numpy()),
                                          jnp.asarray(b.numpy()),
                                          jnp.asarray(bias)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


# ------------------------------------------------------ the entry points
T_SMALL, B, HW = 12, 3, 8
SMALL_GUIDED = dataclasses.replace(entry.GUIDED_UNET, base_dim=8,
                                   channel_mults=(1, 2), time_emb_dim=32)
SMALL_SHAPES = dataclasses.replace(entry.SHAPES_UNET, base_dim=8,
                                   channel_mults=(1, 2), time_emb_dim=32)
IMG = (B, HW, HW, 3)


def _jax_unet(cfg):
    """The flax UNet of a port configuration, on XLA's GroupNorm + SiLU."""
    return JaxUNet(**{f: getattr(cfg, f) for f in (
        "in_channels", "base_dim", "channel_mults", "time_emb_dim",
        "num_classes", "null_token", "cross_attn")}, use_pallas=False)


@pytest.fixture(scope="module")
def guided():
    """Two narrow guided experts, per-expert labels (digit, color) with the
    null token in one slot, the initial noise and the JAX draws."""
    trees = [convert.init_params(SMALL_GUIDED, seed=30 + i) for i in range(2)]
    labels = np.array([[3, 10], [7, 2]], np.int32)
    x = np.random.default_rng(7).standard_normal(IMG).astype(np.float32)
    return (trees, labels, x, np.array(_jax_draws(KEY, T_SMALL, IMG)),
            np.array(_jax_draws(KEY, T_SMALL, IMG, per_step=2)))


def _jax_guided_stack_fn(trees, labels):
    """scripts/superdiff.py's closure: the expert stack with one per-expert
    (K, B) label per slot, fed ``ti.astype(float32)``."""
    stack = jexperts.ExpertStack(
        _jax_unet(SMALL_GUIDED).apply,
        [jax.tree_util.tree_map(jnp.asarray, t) for t in trees])
    lab = jnp.asarray(labels)
    label_args = [jexperts.per_expert(jnp.broadcast_to(
        lab[:, s:s + 1], (len(trees), B))) for s in range(lab.shape[1])]
    return lambda x, ti: stack(x, ti.astype(jnp.float32), *label_args)


# The whole path at narrow width, 12 timesteps: the UNets agree to ~1e-6 a
# forward in float32 (test_torch_unet), and t stays small, where XLA's and
# torch's float32 sinusoids agree (at t up to 999 they part by 4e-5, PERF.md
# section 6). Measured max |diff| 1.3e-6 to 1.1e-5 (layout) on outputs of
# scale 1-4. Bar: 1e-4 of the scale.
TOL_PATH = 1e-4


@pytest.mark.parametrize("op,rigorous", [
    ("OR", False), ("AND", False), ("FIXED", False), ("AVG", False),
    ("OR", True), ("AND", True)])
def test_sample_superdiff_matches_the_script(guided, op, rigorous):
    trees, labels, x, d1, d2 = guided
    sde = JaxDDPM(num_timesteps=T_SMALL)
    fn = _jax_guided_stack_fn(trees, labels)
    if rigorous:
        ref = jsamplers.superdiff_and_solve(fn, sde, KEY, jnp.asarray(x),
                                            mode=op, k_experts=2)
    else:
        ref = jsamplers.superdiff(fn, sde, KEY, jnp.asarray(x), operation=op,
                                  kappa_fixed=(0.7, 0.3))
    got = entry.sample_superdiff(
        [convert.from_flax(t) for t in trees], x, labels, operation=op,
        rigorous_and=rigorous, kappa=(0.7, 0.3), num_timesteps=T_SMALL,
        noise=torch.from_numpy(d2 if rigorous and op == "AND" else d1),
        device="cpu", model=SMALL_GUIDED).numpy()
    _close(got, np.asarray(ref), TOL_PATH)


def test_sample_layout_matches_the_script(guided):
    """scripts/layout_compose.py: label 0 in every slot of both experts."""
    trees, labels, x, d1, _ = guided
    masks = jnp.stack([jnp.ones((HW, HW)),
                       jnp.asarray(entry.circular_mask(HW, HW))])
    ref = jsamplers.layout(_jax_guided_stack_fn(trees, 0 * labels),
                           JaxDDPM(num_timesteps=T_SMALL), KEY,
                           jnp.asarray(x), masks)
    got = entry.sample_layout(
        [convert.from_flax(t) for t in trees], x, num_timesteps=T_SMALL,
        noise=torch.from_numpy(d1), device="cpu", model=SMALL_GUIDED).numpy()
    _close(got, np.asarray(ref), TOL_PATH)


def test_circular_mask_is_the_scripts():
    """The port's copy of scripts/layout_compose.py's circular_mask."""
    want = np.zeros((7, 7), np.float32)
    yy, xx = np.ogrid[:7, :7]
    want[(xx - 3) ** 2 + (yy - 3) ** 2 <= 9] = 1.0
    np.testing.assert_array_equal(entry.circular_mask(7, 7), want)
    assert entry.circular_mask(8, 8, radius=2).sum() == 13


def test_sample_ancestral_matches_the_script():
    """scripts/compose_bbox.py's sampler: three class-conditional experts,
    ``compose.weighted`` with (1, 1, 1), the (B,) t column of the
    script."""
    trees = [convert.init_params(SMALL_SHAPES, seed=40 + i) for i in range(3)]
    labels = np.array([[0, 1, 2], [2, 2, 0], [1, 0, 1]], np.int32)
    x = np.random.default_rng(8).standard_normal(IMG).astype(np.float32)
    model = _jax_unet(SMALL_SHAPES)
    jp = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    w = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)

    def eps_fn(xx, ti):
        t_in = jnp.full((xx.shape[0],), ti, jnp.float32)
        return jcompose.weighted(jnp.stack([
            model.apply(p, xx, t_in, jnp.asarray(labels[i]))
            for i, p in enumerate(jp)]), w)

    ref = jsamplers.ddpm_ancestral(eps_fn, JaxDDPM(num_timesteps=T_SMALL),
                                   KEY, jnp.asarray(x))
    got = entry.sample_ancestral(
        [convert.from_flax(t) for t in trees], x, labels,
        num_timesteps=T_SMALL,
        noise=torch.from_numpy(np.array(_jax_draws(KEY, T_SMALL, IMG))),
        device="cpu", model=SMALL_SHAPES).numpy()
    _close(got, np.asarray(ref), TOL_PATH)


def test_entry_points_check_their_arguments(guided):
    trees, labels, x, _, _ = guided
    tt = [convert.from_flax(t) for t in trees]
    with pytest.raises(ValueError, match="rigorous_and"):
        entry.sample_superdiff(tt, x, labels, operation="AVG",
                               rigorous_and=True, device="cpu",
                               model=SMALL_GUIDED)
    with pytest.raises(ValueError, match="labels"):
        entry.sample_superdiff(tt, x, labels[:, :1], num_timesteps=2,
                               device="cpu", model=SMALL_GUIDED)
    with pytest.raises(ValueError, match="2 experts"):
        entry.sample_layout(tt + tt[:1], x, num_timesteps=2, device="cpu",
                            model=SMALL_GUIDED)


def test_new_entry_points_default_to_cuda(monkeypatch, guided):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trees, labels, x, _, _ = guided
    tt = [convert.from_flax(t) for t in trees]
    for call in (lambda: entry.sample_superdiff(tt, x, labels),
                 lambda: entry.sample_layout(tt, x),
                 lambda: entry.sample_ancestral(tt, x, labels[:, :1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_guided_unet_is_the_presets_model():
    g = entry.GUIDED_UNET
    assert (g.in_channels, g.base_dim, g.channel_mults, g.time_emb_dim,
            g.num_classes, g.null_token, g.cross_attn) == (
        3, 64, (1, 2, 4), 256, (10, 10), True, False)
    shapes = convert.param_shapes(g)
    assert shapes[("label_emb_0", "embedding")][0] == (11, 256)
    assert shapes[("label_emb_1", "embedding")][0] == (11, 256)
