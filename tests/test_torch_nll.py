"""Port parity for the NLL path and the last two samplers:
``samplers.log_likelihood`` (Hutchinson probes replayed from the JAX key
structure, or the exact trace) and ``bits_per_dim`` on a closed-form
Gaussian score and on a narrow UNet, ``entry.eval_nll`` against the
computation of ``scripts/eval_nll.py``, ``parallel_prob_flow`` and
``make_classifier_guided_eps_fn`` on a Gaussian mixture."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import data as jdata
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models import UNet as JaxUNet
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import convert, entry, samplers
from composable_diffusion_models_tpu_torch.models.unet import UNet
from composable_diffusion_models_tpu_torch.rng import Replay
from composable_diffusion_models_tpu_torch.schedules import VPSchedule

torch.set_num_threads(1)
DATA_STD = 0.6


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _gauss_score(lib, sched):
    """The exact score of data ~ N(0, DATA_STD^2 I) under the VP forward
    process: -x / (alpha^2 s^2 + sigma^2)."""
    def score(x, t):
        var = sched.alpha(t) ** 2 * DATA_STD ** 2 + sched.sigma(t) ** 2
        if var.ndim:  # per-sample t
            var = var.reshape(tuple(var.shape) + (1,) * (x.ndim - var.ndim))
        return -x / var
    return score


def _probe_draws(key, n_steps, n_probes, shape, probe):
    """The JAX ``log_likelihood``'s probes step by step: the key folded
    with 0, then one probe from it or one from each of n_probes subkeys
    (Rademacher as the {0, 1} draw)."""
    out, k = [], key
    for _ in range(n_steps):
        k = jax.random.fold_in(k, 0)
        keys = [k] if n_probes == 1 else jax.random.split(k, n_probes)
        for kk in keys:
            if probe == "rademacher":
                out.append(np.asarray(jax.random.randint(kk, shape, 0, 2)))
            else:
                out.append(np.asarray(jax.random.normal(kk, shape)))
    return out


def _as_probes(draws, n_steps, n_probes, probe):
    v = torch.from_numpy(np.stack(draws).astype(np.float32))
    if probe == "rademacher":
        v = v * 2.0 - 1.0
    return v.reshape((n_steps, n_probes) + tuple(v.shape[1:]))


@pytest.mark.parametrize("probe,n_probes", [("rademacher", 1),
                                            ("rademacher", 3),
                                            ("gaussian", 2)])
def test_log_likelihood_gaussian_matches_jax(probe, n_probes):
    """The Gaussian score, 20 steps, the JAX probes replayed through the
    key structure (``rng.Replay``) and as a ``probes`` tensor: log p and
    the terminal latent to 1e-5 relative; near the exact log-density of
    the data's Gaussian."""
    rng = np.random.default_rng(0)
    x = (DATA_STD * rng.standard_normal((5, 6))).astype(np.float32)
    key = jax.random.PRNGKey(1)
    ref_ll, ref_xt = jsamplers.log_likelihood(
        _gauss_score(jnp, JaxVP()), JaxVP(), jnp.asarray(x), 20, key=key,
        probe=probe, n_probes=n_probes)
    draws = _probe_draws(key, 20, n_probes, x.shape, probe)
    sched = VPSchedule()
    with torch.no_grad():
        ll, xt = samplers.log_likelihood(
            _gauss_score(torch, sched), sched, torch.from_numpy(x), 20,
            key=Replay(draws), probe=probe, n_probes=n_probes)
        ll2, _ = samplers.log_likelihood(
            _gauss_score(torch, sched), sched, torch.from_numpy(x), 20,
            probe=probe, n_probes=n_probes,
            probes=_as_probes(draws, 20, n_probes, probe))
    ref_ll = np.asarray(ref_ll)
    np.testing.assert_allclose(ll.numpy(), ref_ll, rtol=1e-5)
    np.testing.assert_allclose(ll2.numpy(), ll.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(xt.numpy(), np.asarray(ref_xt), rtol=1e-5,
                               atol=1e-6)
    exact = (-0.5 * (x ** 2).sum(1) / DATA_STD ** 2
             - 3 * math.log(2 * math.pi * DATA_STD ** 2))
    assert np.abs(ll.numpy() - exact).max() < 0.5 * np.abs(exact).max()


@pytest.mark.parametrize("t_max", [1.0, 0.9])
def test_log_likelihood_exact_trace_matches_jax(t_max):
    """``exact=True``: the Jacobian trace by one jvp per dimension; 1e-5
    relative to the JAX function, and independent of any key."""
    x = (DATA_STD * np.random.default_rng(2).standard_normal((4, 5))).astype(
        np.float32)
    ref, _ = jsamplers.log_likelihood(
        _gauss_score(jnp, JaxVP()), JaxVP(), jnp.asarray(x), 15, exact=True,
        t_max=t_max)
    sched = VPSchedule()
    with torch.no_grad():
        got, _ = samplers.log_likelihood(
            _gauss_score(torch, sched), sched, torch.from_numpy(x), 15,
            exact=True, t_max=t_max)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    with pytest.raises(ValueError, match="PRNG key"):
        samplers.log_likelihood(_gauss_score(torch, sched), sched,
                                torch.from_numpy(x), 15)


def test_bits_per_dim_matches_jax():
    ll = np.array([-1200.5, -800.25, 30.0], np.float32)
    for shape, nbins in (((28, 28, 1), 256), ((8, 8, 3), 32)):
        np.testing.assert_allclose(
            samplers.bits_per_dim(torch.from_numpy(ll), shape, nbins).numpy(),
            np.asarray(jsamplers.bits_per_dim(jnp.asarray(ll), shape, nbins)),
            rtol=1e-6)


SMALL = dict(in_channels=3, base_dim=8, channel_mults=(1, 2, 4),
             num_classes=(3,))


def test_log_likelihood_unet_matches_jax():
    """A narrow UNet's eps as the score (-eps / sigma), 6 steps, 2 probes
    replayed, GroupNorm in PyTorch ops inside the jvps: log p to 1e-4
    relative in nats."""
    cfg = UNet(**SMALL)
    tree = convert.init_params(cfg, seed=4)
    x = np.random.default_rng(3).uniform(-1, 1, (3, 8, 8, 3)).astype(
        np.float32)
    lab = np.array([0, 2, 1], np.int32)
    jm, jsch = JaxUNet(**SMALL), JaxVP()
    jp = _jtree(tree)

    def jscore(xx, t):
        return -jm.apply(jp, xx, t * jnp.ones(xx.shape[0]),
                         jnp.asarray(lab)) / jsch.sigma(t)
    key = jax.random.PRNGKey(6)
    ref, _ = jax.jit(lambda xx: jsamplers.log_likelihood(
        jscore, jsch, xx, 6, key=key, n_probes=2))(jnp.asarray(x))
    sched = VPSchedule()
    params = convert.unet_torch_layout(convert.from_flax(tree))

    def score(xx, t):
        return -cfg.apply(params, xx, t * torch.ones(xx.shape[0]),
                          torch.from_numpy(lab).long()) / sched.sigma(t)
    with torch.no_grad():
        got, _ = samplers.log_likelihood(
            score, sched, torch.from_numpy(x), 6,
            key=Replay(_probe_draws(key, 6, 2, x.shape, "rademacher")),
            n_probes=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)


def _script_nll(tree, predict, conditional, kind, n_data, n_steps,
                n_probes, seed, img):
    """``scripts/eval_nll.py``'s computation after its checkpoint load, on
    the JAX package: the shapes dataset at fold_in(key, 7), the score of
    the expert's eps / x0 / v, the probes from fold_in(key, 11)."""
    key = jax.random.PRNGKey(seed)
    model = JaxUNet(**dict(SMALL, num_classes=(3,) if conditional else ()))
    schedule = JaxVP(kind=kind)
    params = _jtree(tree)
    images, *labels = jdata.get_dataset("shapes", jax.random.fold_in(key, 7),
                                        n_data, img_size=img)
    labels = labels[:1] if conditional else []

    def score_fn(x, t):
        eps = model.apply(params, x, t * jnp.ones(x.shape[0]), *labels)
        if predict == "x0":
            eps = (x - schedule.alpha(t) * eps) / schedule.sigma(t)
        elif predict == "v":
            eps = schedule.sigma(t) * x + schedule.alpha(t) * eps
        return -eps / schedule.sigma(t)
    t_max = 0.99 if kind == "rectified" else 1.0
    ll = jax.jit(lambda x, k: jsamplers.log_likelihood(
        score_fn, schedule, x, n_steps, key=k, n_probes=n_probes,
        t_max=t_max)[0])(images, jax.random.fold_in(key, 11))
    bpd = jsamplers.bits_per_dim(ll, images.shape[1:])
    probes = _probe_draws(jax.random.fold_in(key, 11), n_steps, n_probes,
                          images.shape, "rademacher")
    return ({"nll_nats_mean": -float(ll.mean()),
             "bits_per_dim_mean": float(bpd.mean()),
             "bits_per_dim_sem": float(bpd.std() / jnp.sqrt(bpd.shape[0])),
             "t_max": t_max},
            _as_probes(probes, n_steps, n_probes, "rademacher"))


@pytest.mark.parametrize("predict,conditional,kind", [
    ("eps", True, "stable"), ("x0", False, "rectified"),
    ("v", True, "stable")])
def test_eval_nll_matches_the_script(predict, conditional, kind):
    """``entry.eval_nll`` on the CPU against the script's computation: a
    narrow UNet (its GroupNorm set to the kernel, which the entry point
    turns off inside the jvps) conditioned on the shape label (or an
    unconditional one) on 6 procedural
    8 x 8 shapes, 4 steps, 2 probes (the script's, replayed), eps / x0 / v
    prediction, t_max 0.99 under the rectified kind: the report's NLL and
    bits/dim to 1e-4 relative."""
    cfg = UNet(**dict(SMALL, num_classes=(3,) if conditional else ()),
               fused_gn=True)
    tree = convert.init_params(cfg, seed=5)
    ref, probes = _script_nll(tree, predict, conditional, kind, 6, 4, 2, 42,
                              8)
    got = entry.eval_nll(convert.from_flax(tree), cfg,
                         dataset_kw=dict(img_size=8), n_data=6, n_steps=4,
                         n_probes=2, schedule=VPSchedule(kind=kind),
                         predict=predict, conditional=conditional,
                         probes=probes, device="cpu")
    assert got["t_max"] == ref["t_max"] and got["schedule_kind"] == kind
    for k in ("nll_nats_mean", "bits_per_dim_mean", "bits_per_dim_sem"):
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k


def test_eval_nll_own_probes_and_checks(monkeypatch):
    """Its own probes (fold_in(seed, 11)): finite, deterministic for a seed;
    v prediction off the stable kind raises; without a card it raises."""
    tree = convert.from_flax(convert.init_params(UNet(**SMALL), seed=5))
    kw = dict(dataset_kw=dict(img_size=8), n_data=4, n_steps=3, n_probes=1,
              conditional=True, device="cpu")
    a = entry.eval_nll(tree, UNet(**SMALL), **kw)
    b = entry.eval_nll(tree, UNet(**SMALL), **kw)
    assert a == b and math.isfinite(a["bits_per_dim_mean"])
    with pytest.raises(ValueError, match="stable"):
        entry.eval_nll(tree, UNet(**SMALL), predict="v",
                       schedule=VPSchedule(kind="cosine"), **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.eval_nll(tree, UNet(**SMALL), n_data=4)


# ----------------------------------------------------- the last samplers
def test_parallel_prob_flow_matches_jax():
    """Picard sweeps on the Gaussian score: the final x and every sweep's
    residual to 1e-5 of the scale; after n_steps sweeps the iteration has
    reached the sequential Euler solve (``prob_flow_ode``)."""
    x0 = np.random.default_rng(4).standard_normal((6, 3)).astype(np.float32)
    ref_x, ref_res = jsamplers.parallel_prob_flow(
        _gauss_score(jnp, JaxVP()), JaxVP(), jnp.asarray(x0), 10, n_iters=7)
    sched = VPSchedule()
    x, res = samplers.parallel_prob_flow(_gauss_score(torch, sched), sched,
                                         torch.from_numpy(x0), 10, n_iters=7)
    assert res.shape == (7,)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), rtol=0,
                               atol=1e-5 * np.abs(ref_x).max())
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_res), rtol=0,
                               atol=1e-5 * float(np.abs(ref_res).max()))
    x_full, res_full = samplers.parallel_prob_flow(
        _gauss_score(torch, sched), sched, torch.from_numpy(x0), 10,
        n_iters=11)
    seq = samplers.prob_flow_ode(_gauss_score(torch, sched), sched,
                                 torch.from_numpy(x0), 10)
    assert float(res_full[-1]) <= 1e-5 * float(res_full[0])
    np.testing.assert_allclose(x_full.numpy(), seq.numpy(), rtol=0,
                               atol=1e-5)


def _mixture(lib, sched, mus, s=0.3):
    """A 2-Gaussian mixture (means ``mus``, std s) on 2-D data: its
    closed-form eps and its class-1 log posterior at noise level t (a
    scalar or one per sample)."""
    mus = jnp.asarray(mus) if lib is jnp else torch.tensor(mus)

    def col(v):  # a per-sample coefficient against (B, 2)
        return v.reshape(-1, 1) if v.ndim else v

    def parts(x, t):
        a = col(sched.alpha(t))
        v = col(sched.alpha(t) ** 2 * s ** 2 + sched.sigma(t) ** 2)
        d = lib.stack([((x - a * m) ** 2).sum(-1) for m in mus], -1)
        return a, v, -0.5 * d / v

    def eps(x, t):
        a, v, lg = parts(x, t)
        w = (jax.nn.softmax(lg, axis=-1) if lib is jnp
             else torch.softmax(lg, dim=-1))
        mean = sum(w[:, i:i + 1] * a * m for i, m in enumerate(mus))
        return (x - mean) * col(sched.sigma(t)) / v

    def logp1(x, t):
        lg = parts(x, t)[2]
        if lib is jnp:
            return jax.nn.log_softmax(lg, axis=-1)[:, 1]
        return torch.log_softmax(lg, dim=-1)[:, 1]
    return eps, logp1


@pytest.mark.parametrize("scale", [1.0, 2.5, "ramp"])
def test_classifier_guided_eps_matches_jax(scale):
    """Guidance by the exact class posterior of a 2-Gaussian mixture: the
    guided eps at a scalar and a per-sample t, and a 30-step DDIM run that
    lands on the class-1 component, to 1e-5 of the scale; ``scale`` as a
    number or a function of t."""
    mus = [[-1.5, 0.0], [1.5, 0.0]]
    x = np.random.default_rng(5).standard_normal((64, 2)).astype(np.float32)
    sc_j = (lambda t: 2.0 * (1.0 - t)) if scale == "ramp" else scale
    sc_t = (lambda t: 2.0 * (1.0 - t)) if scale == "ramp" else scale
    jsch, sched = JaxVP(), VPSchedule()
    eps_j, logp_j = _mixture(jnp, jsch, mus)
    jg = jsamplers.make_classifier_guided_eps_fn(eps_j, jsch, logp_j,
                                                 scale=sc_j)
    eps, logp = _mixture(torch, sched, mus)
    tg = samplers.make_classifier_guided_eps_fn(eps, sched, logp, sc_t)
    t_per = np.linspace(0.1, 0.9, 64).astype(np.float32)
    ts = [(jnp.float32(0.4), torch.tensor(0.4))]
    if scale != "ramp":  # scale(t) of a per-sample t is (B,): not a scalar
        ts.append((jnp.asarray(t_per), torch.from_numpy(t_per)))
    for t_j, t_t in ts:
        ref = np.asarray(jg(jnp.asarray(x), t_j))
        with torch.no_grad():
            got = tg(torch.from_numpy(x), t_t).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    ref = np.asarray(jsamplers.ddim(jg, jsch, jnp.asarray(x), 30,
                                    clip=None))
    with torch.no_grad():
        got = samplers.ddim(tg, sched, torch.from_numpy(x), 30,
                            clip=None).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    if scale == 1.0:  # Bayes' rule: the class-1 component
        assert (got[:, 0] > 0).mean() > 0.95
