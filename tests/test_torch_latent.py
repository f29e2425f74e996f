"""Port parity for the latent slice's modules: the plain versions of the
``blend_eps`` and ``matmul`` kernels against the Pallas kernels (interpret
mode on the CPU), both MLPs, the PCA codec, the divergence estimators, the
rest of ``compose`` and the schedule's SDE tables, each against its JAX
counterpart on the same numpy inputs. All float32 unless a test says
otherwise; each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu.models import (
    LatentDiffusionMLP as JaxLatentMLP, ScoreMLP as JaxScoreMLP)
from composable_diffusion_models_tpu.ops import divergence as jdiv
from composable_diffusion_models_tpu.ops import pallas_kernels as pk
from composable_diffusion_models_tpu.ops import pca as jpca
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import compose, convert
from composable_diffusion_models_tpu_torch.models import (LatentDiffusionMLP,
                                                          ScoreMLP)
from composable_diffusion_models_tpu_torch.ops import divergence, kernels, pca
from composable_diffusion_models_tpu_torch.schedules import VPSchedule

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode():
    # CPU backend: run the Pallas kernels in the interpreter
    with pltpu.force_tpu_interpret_mode():
        yield


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    return np.asarray(x.astype(jnp.float32) if hasattr(x, "astype") else x)


# ---------------------------------------------------------------- blend_eps
BLEND_CASES = [((3, 2, 8, 8, 4), [1.0, 2.0, 0.5]),   # the JAX test's shape
               ((2, 16, 2), [1.0, 1.0]),             # the latent stack
               ((1, 3, 5), [0.7]), ((5, 4, 7, 3), [0.1, 3.0, 1.0, 2.0, 0.4]),
               ((3, 7, 5), [0.6, 1.4, 0.9]),         # ragged: 35 a plane
               ((4, 8, 16), [0.5, 1.5, 2.0, 0.25])]  # K = 4


@pytest.mark.parametrize("shape,w", BLEND_CASES)
def test_blend_eps_ref_matches_pallas_f32(interpret_mode, shape, w):
    """Same order and rounding sites as the Pallas body; the interpreter
    may contract w * x + acc into one FMA, so 1e-6 rather than equality.
    Against ``compose.weighted`` (another order, w / sum first): 1e-5, the
    JAX test's bar."""
    eps, wn = _rand(sum(shape), *shape), np.asarray(w, np.float32)
    ref = _np(pk.blend_eps(jnp.asarray(eps), jnp.asarray(wn),
                           use_pallas=True))
    got = kernels.blend_eps_ref(torch.from_numpy(eps), torch.from_numpy(wn))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[1:]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), _np(jcompose.weighted(jnp.asarray(eps), jnp.asarray(wn))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(),
        compose.weighted(torch.from_numpy(eps), torch.from_numpy(wn)).numpy(),
        rtol=1e-5, atol=1e-5)
    # on a CPU tensor the wrapper is the plain version
    wrapped = kernels.blend_eps(torch.from_numpy(eps), torch.from_numpy(wn))
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("shape,w", BLEND_CASES[:2])
def test_blend_eps_ref_matches_pallas_bf16(interpret_mode, shape, w):
    """bf16 stack: float32 accumulation and division, ONE rounding to
    bf16: at most 1 bf16 ulp (2^-8 relative) from the Pallas result."""
    eps, wn = _rand(1 + sum(shape), *shape), np.asarray(w, np.float32)
    ref = _np(pk.blend_eps(jnp.asarray(eps, jnp.bfloat16), jnp.asarray(wn),
                           use_pallas=True))
    got = kernels.blend_eps_ref(torch.from_numpy(eps).bfloat16(),
                                torch.from_numpy(wn))
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -8 * scale)


@pytest.mark.parametrize("bad", ["per_sample", "dtype", "w_dtype", "contig",
                                 "rank", "k"])
def test_blend_eps_rejects(bad):
    eps = torch.zeros(3, 4, 5)
    w = torch.ones(3)
    if bad == "per_sample":
        w = torch.ones(3, 4)
    elif bad == "dtype":
        eps = eps.double()
    elif bad == "w_dtype":
        w = w.double()
    elif bad == "contig":
        eps = torch.zeros(3, 5, 4).transpose(1, 2)
    elif bad == "rank":
        eps = torch.zeros(3)
    elif bad == "k":
        w = torch.ones(2)
    with pytest.raises(ValueError, match="compose.weighted"
                       if bad == "per_sample" else None):
        kernels.blend_eps(eps, w)


# blend_route at the served stacks (latent, compose_scores,
# compose_latent_vae, eval_composition(avg)), the smoke's larger, ragged and
# K = 5 ones and a stack past L2: (K, n) -> (width, grid) in float32 and
# bfloat16 (the route reads only n)
BLEND_ROUTES = [
    ((2, 1024), (4, 1), (8, 1)),
    ((2, 50176), (4, 49), (8, 25)),
    ((2, 160), (4, 1), (8, 1)),
    ((2, 393216), (4, 384), (8, 192)),
    ((3, 1605632), (4, 1568), (8, 784)),
    ((2, 1572864), (4, 1536), (8, 768)),
    ((3, 35), (1, 1), (1, 1)),
    ((1, 297), (1, 2), (1, 2)),
    ((2, 1), (1, 1), (1, 1)),
    ((5, 3000), (4, 3), (8, 2)),
    ((5, 512), (4, 1), (8, 1)),
    ((2, 4194304), (4, 4096), (8, 2048))]


@pytest.mark.parametrize("kn,f32,bf16", BLEND_ROUTES)
def test_blend_route_pinned(kn, f32, bf16):
    _, n = kn
    assert tuple(kernels.blend_route(n, torch.float32)) == f32
    assert tuple(kernels.blend_route(n, torch.bfloat16)) == bf16


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4),
                                       (torch.bfloat16, 8)])
def test_blend_route_switch_points(dtype, vec):
    """16-byte items while n is a multiple of the vector width, single
    elements one past it; a second block of 256 threads one item past the
    first block's."""
    assert kernels.blend_route(vec * 1000, dtype) == (vec, 4)
    assert kernels.blend_route(vec * 1000 + 1, dtype) == (
        1, -(-(vec * 1000 + 1) // 256))
    assert kernels.blend_route(vec * 256, dtype) == (vec, 1)
    assert kernels.blend_route(vec * 257, dtype) == (vec, 2)
    assert kernels.blend_route(255, dtype) == (1, 1)
    assert kernels.blend_route(257, dtype) == (1, 2)
    for n in (1, 35, vec * 3001, 2 ** 24 + 1):
        width, grid = kernels.blend_route(n, dtype)
        assert n % width == 0 and (grid - 1) * 256 < n // width <= grid * 256


# ------------------------------------------------------------------- matmul
MATMUL_SHAPES = [(64, 32, 48), (130, 784, 2),        # the JAX test's shapes
                 (16, 2, 784), (1, 1, 1), (7, 129, 3), (33, 5, 65)]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_matmul_ref_matches_pallas_f32(interpret_mode, m, k, n):
    """float32 both ways; only the summation order over K differs: the JAX
    test's bar (rtol 1e-4, atol 1e-3)."""
    a, b = _rand(m + k, m, k), _rand(n + k, k, n)
    ref = _np(pk.matmul(jnp.asarray(a), jnp.asarray(b), tile_m=128,
                        tile_n=128, use_pallas=True))
    got = kernels.matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-4, atol=1e-3)
    wrapped = kernels.matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    # a transposed view is taken as it is (the CPU product may then sum in
    # another order)
    bt = torch.from_numpy(np.ascontiguousarray(b.T)).t()
    np.testing.assert_allclose(
        kernels.matmul(torch.from_numpy(a), bt).numpy(), got.numpy(),
        rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES[:3])
def test_matmul_ref_matches_pallas_bf16(interpret_mode, m, k, n):
    """bf16 operands, float32 sum, one rounding to bf16: 1 bf16 ulp of the
    output scale covers an order-of-summation flip of that rounding."""
    a, b = _rand(m, m, k), _rand(n, k, n)
    ref = _np(pk.matmul(jnp.asarray(a, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16), tile_m=128, tile_n=128,
                        use_pallas=True))
    got = kernels.matmul_ref(torch.from_numpy(a).bfloat16(),
                             torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -8 * scale)


@pytest.mark.parametrize("bad", ["inner", "rank", "dtype", "mixed"])
def test_matmul_rejects(bad):
    a, b = torch.zeros(4, 3), torch.zeros(3, 5)
    if bad == "inner":
        b = torch.zeros(4, 5)
    elif bad == "rank":
        a = torch.zeros(2, 4, 3)
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.bfloat16()
    with pytest.raises(ValueError):
        kernels.matmul(a, b)


@pytest.mark.parametrize("dtype,m,k,n,a_strides,b_strides,aligned,route", [
    # the codec: encode (N <= 8 columns) and decode (K = 2), both presets
    (torch.float32, 10000, 4096, 2, (4096, 1), (2, 1), True, "rows"),
    (torch.float32, 512, 2, 4096, (2, 1), (4096, 1), True, "small_k"),
    (torch.float32, 64, 2, 784, (2, 1), (784, 1), True, "small_k"),
    # the small-K limit and one past it, in either dtype
    (torch.float32, 100, 8, 100, (8, 1), (100, 1), True, "small_k"),
    (torch.float32, 100, 9, 100, (9, 1), (100, 1), True, "tiles"),
    (torch.bfloat16, 100, 8, 128, (8, 1), (128, 1), True, "small_k"),
    (torch.bfloat16, 100, 9, 128, (16, 1), (128, 1), True, "tiles"),
    (torch.float32, 3, 1, 20, (1, 1), (20, 1), True, "small_k"),
    # bf16 on the tensor cores from K = 64, either operand in either major
    (torch.bfloat16, 2048, 2048, 2048, (2048, 1), (2048, 1), True, "wgmma"),
    (torch.bfloat16, 2048, 2048, 2048, (1, 2048), (1, 2048), True, "wgmma"),
    (torch.bfloat16, 512, 64, 12288, (64, 1), (12288, 1), True, "wgmma"),
    (torch.bfloat16, 512, 63, 12288, (64, 1), (12288, 1), True, "tiles"),
    (torch.bfloat16, 1, 128, 100, (7, 1), (1, 128), True, "wgmma"),
    # rows not 16 bytes apart, an operand with no unit stride, misalignment
    (torch.bfloat16, 257, 1000, 130, (1000, 1), (130, 1), True, "tiles"),
    (torch.bfloat16, 256, 128, 256, (256, 2), (256, 1), True, "tiles"),
    (torch.bfloat16, 256, 128, 256, (128, 1), (256, 1), False, "tiles"),
    # float32 stays on the CUDA cores; a transposed a is no row stream
    (torch.float32, 2048, 2048, 2048, (2048, 1), (2048, 1), True, "tiles"),
    (torch.float32, 4096, 4096, 2, (1, 4096), (2, 1), True, "tiles"),
])
def test_matmul_route(dtype, m, k, n, a_strides, b_strides, aligned, route):
    assert kernels.matmul_route(dtype, m, k, n, a_strides, b_strides,
                                aligned) == route


# --------------------------------------------------------------------- MLPs
def _perturbed(tree, seed):
    """flax zeroes every bias at init: add N(0, 0.1^2) to every leaf so a
    dropped bias or a transposed kernel shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(
            np.float32), tree)


@pytest.mark.parametrize("t_kind", ["scalar", "vector", "column"])
@pytest.mark.parametrize("hidden,depth,out_dim", [(256, 3, 2), (32, 4, 5)])
def test_score_mlp_matches_jax(t_kind, hidden, depth, out_dim):
    """Four or five float32 Dense layers: 1e-5 (summation order)."""
    jm = JaxScoreMLP(hidden=hidden, depth=depth, out_dim=out_dim)
    tree = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.ones((1, 1)),
                              jnp.zeros((1, out_dim))), seed=hidden)
    x = _rand(3, 6, out_dim)
    t = {"scalar": np.float32(0.37), "vector": _rand(4, 6) * 0.2 + 0.5,
         "column": _rand(5, 6, 1) * 0.2 + 0.5}[t_kind]
    ref = _np(jm.apply(tree, jnp.asarray(t), jnp.asarray(x)))
    tm = ScoreMLP(hidden=hidden, depth=depth, out_dim=out_dim)
    got = tm.apply(convert.from_flax(tree), torch.as_tensor(t),
                   torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (6, out_dim)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the converter's own tree has flax's key paths and shapes
    shapes = {p: s for p, (s, _) in convert.param_shapes(tm).items()}
    flat = {tuple(str(getattr(k, "key", k)) for k in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(
                tree["params"])[0]}
    assert shapes == flat


@pytest.mark.parametrize("null_token", [False, True])
@pytest.mark.parametrize("t_kind", ["scalar", "vector"])
def test_latent_mlp_matches_jax(null_token, t_kind):
    """Sinusoidal embedding (sin/cos of arguments up to ~1) + two label
    tables + 4 Dense layers, float32: 1e-5."""
    kw = dict(latent_dim=6, hidden=48, depth=3, time_emb_dim=16,
              num_classes=(4, 3), null_token=null_token)
    jm = JaxLatentMLP(**kw)
    z = _rand(8, 5, 6)
    labels = [np.array([0, 3, 1, 2, 4 if null_token else 0], np.int32),
              np.array([2, 0, 3 if null_token else 1, 1, 0], np.int32)]
    tree = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.ones((5,)),
                              jnp.asarray(z), *map(jnp.asarray, labels)),
                      seed=9)
    t = np.float32(0.6) if t_kind == "scalar" else _rand(10, 5) * 0.2 + 0.5
    ref = _np(jm.apply(tree, jnp.asarray(t), jnp.asarray(z),
                       *map(jnp.asarray, labels)))
    tm = LatentDiffusionMLP(**kw)
    got = tm.apply(convert.from_flax(tree), torch.as_tensor(t),
                   torch.from_numpy(z),
                   *(torch.from_numpy(v).long() for v in labels)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    shapes = {p: s for p, (s, _) in convert.param_shapes(tm).items()}
    flat = {tuple(str(getattr(k, "key", k)) for k in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(
                tree["params"])[0]}
    assert shapes == flat
    init = convert.init_params(tm, seed=0)["params"]
    assert init["label_emb_0"]["embedding"].shape == (4 + null_token, 16)


# ---------------------------------------------------------------------- PCA
def _low_rank_images(seed, n=96, size=6, rank=3):
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((rank, size * size))
    coef = rng.standard_normal((n, rank)) * np.array([3.0, 2.0, 1.0])[:rank]
    flat = coef @ basis + 0.05 * rng.standard_normal((n, size * size)) + 0.3
    return flat.reshape(n, size, size, 1).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fit_pca_matches_jax(k):
    """Component signs are arbitrary: compare explained variance (rtol
    1e-4: two float32 eigensolvers), reconstructions and |latents| (1e-3
    on images of scale ~10: the eigenvectors of a float32 covariance)."""
    imgs = _low_rank_images(k)
    ref = jpca.fit_pca(jnp.asarray(imgs), k)
    got = pca.fit_pca(torch.from_numpy(imgs), k)
    assert tuple(got.components.shape) == (k, 36)
    np.testing.assert_allclose(got.explained_variance.numpy(),
                               _np(ref.explained_variance), rtol=1e-4)
    np.testing.assert_allclose(got.mean.numpy(), _np(ref.mean), atol=1e-6)
    z_ref, z_got = ref.encode(jnp.asarray(imgs)), got.encode(
        torch.from_numpy(imgs))
    np.testing.assert_allclose(np.abs(z_got.numpy()), np.abs(_np(z_ref)),
                               atol=1e-3)
    rec_ref = _np(ref.decode(z_ref, (6, 6, 1)))
    rec_got = got.decode(z_got, (6, 6, 1)).numpy()
    assert rec_got.shape == imgs.shape
    np.testing.assert_allclose(rec_got, rec_ref, atol=1e-3)
    # unit axes, descending variance
    gram = got.components @ got.components.t()
    np.testing.assert_allclose(gram.numpy(), np.eye(k), atol=1e-5)
    assert bool((got.explained_variance[:-1]
                 >= got.explained_variance[1:]).all())


def test_pca_encode_decode_match_jax():
    """The same codec in both packages (through ``pca_from_numpy``):
    encode and decode are one float32 GEMM each over D = 36: 1e-5."""
    imgs = _low_rank_images(7)
    ref = jpca.fit_pca(jnp.asarray(imgs), 2)
    got = convert.pca_from_numpy(_np(ref.mean), _np(ref.components),
                                 _np(ref.explained_variance))
    z = got.encode(torch.from_numpy(imgs))
    np.testing.assert_allclose(z.numpy(), _np(ref.encode(jnp.asarray(imgs))),
                               rtol=1e-5, atol=1e-5)
    zz = _rand(11, 9, 2)
    np.testing.assert_allclose(
        got.decode(torch.from_numpy(zz)).numpy(),
        _np(ref.decode(jnp.asarray(zz))), rtol=1e-5, atol=1e-5)
    assert got.decode(torch.from_numpy(zz), (6, 6, 1)).shape == (9, 6, 6, 1)
    assert got.components_t.is_contiguous()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_pca_npy_round_trip(tmp_path, direction):
    """One package's ``save_pca`` files load in the other, bit for bit."""
    imgs = _low_rank_images(5)
    prefix = str(tmp_path / "pca")
    if direction == "jax_to_torch":
        src = jpca.fit_pca(jnp.asarray(imgs), 2)
        jpca.save_pca(prefix, src)
        dst = pca.load_pca(prefix)
        pairs = [(_np(getattr(src, n)), getattr(dst, n).numpy())
                 for n in ("mean", "components", "explained_variance")]
    else:
        src = pca.fit_pca(torch.from_numpy(imgs), 2)
        pca.save_pca(prefix, src)
        dst = jpca.load_pca(prefix)
        pairs = [(getattr(src, n).numpy(), _np(getattr(dst, n)))
                 for n in ("mean", "components", "explained_variance")]
    for a, b in pairs:
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- divergence
def _score_pair(seed):
    """One small ScoreMLP as a JAX and as a torch function of x."""
    jm = JaxScoreMLP(hidden=16, depth=2, out_dim=3)
    tree = _perturbed(jm.init(jax.random.PRNGKey(seed), jnp.ones((1, 1)),
                              jnp.zeros((1, 3))), seed)
    tparams = convert.from_flax(tree)
    tm = ScoreMLP(hidden=16, depth=2, out_dim=3)
    return (lambda v: jm.apply(tree, jnp.float32(0.4), v),
            lambda v: tm.apply(tparams, torch.tensor(0.4), v))


@pytest.mark.parametrize("n_probes", [1, 3])
def test_value_and_div_matches_jax(n_probes):
    """The JAX draws fed through ``probes=``: the same jvp's, float32:
    1e-5."""
    jfn, tfn = _score_pair(2)
    x = _rand(12, 7, 3)
    key = jax.random.PRNGKey(5)
    keys = [key] if n_probes == 1 else list(jax.random.split(key, n_probes))
    probes = np.stack([_np(jdiv._probe(k, x.shape, jnp.float32, "rademacher"))
                       for k in keys])
    val_ref, div_ref = jdiv.value_and_div(jfn, jnp.asarray(x), key,
                                          "rademacher", n_probes)
    with torch.no_grad():  # forward-mode AD stays on under no_grad
        val, div = divergence.value_and_div(
            tfn, torch.from_numpy(x), n_probes=n_probes,
            probes=torch.from_numpy(probes[0] if n_probes == 1 else probes))
    assert tuple(div.shape) == (7,)
    np.testing.assert_allclose(val.numpy(), _np(val_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(div.numpy(), _np(div_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["rademacher", "gaussian"])
def test_probes_from_a_generator(kind):
    """Own draws: reproducible from the seed, of the stated distribution,
    and the estimate's mean over many probes approaches the exact
    divergence (3 dims, 4000 probes: standard error ~0.02 here; bar 0.1)."""
    _, tfn = _score_pair(3)
    x = torch.from_numpy(_rand(13, 4, 3))
    g = torch.Generator().manual_seed(0)
    v = divergence.draw_probe(g, (2000, 3), torch.float32, "cpu", kind)
    if kind == "rademacher":
        assert set(np.unique(v.numpy())) == {-1.0, 1.0}
    assert abs(float(v.mean())) < 0.1 and abs(float(v.var()) - 1.0) < 0.1
    _, exact = divergence.exact_div(tfn, x)
    est = [divergence.value_and_div(
        tfn, x, torch.Generator().manual_seed(s), kind, n_probes=4000)[1]
        for s in (1, 1)]
    np.testing.assert_array_equal(est[0].numpy(), est[1].numpy())
    np.testing.assert_allclose(est[0].numpy(), exact.numpy(), atol=0.1)
    with pytest.raises(ValueError, match="generator"):
        divergence.value_and_div(tfn, x)
    with pytest.raises(ValueError, match="unknown probe"):
        divergence.value_and_div(tfn, x, g, "uniform")


def test_exact_div_matches_jax():
    jfn, tfn = _score_pair(4)
    x = _rand(14, 5, 3)
    val_ref, div_ref = jdiv.exact_div(jfn, jnp.asarray(x))
    val, div = divergence.exact_div(tfn, torch.from_numpy(x))
    np.testing.assert_allclose(val.numpy(), _np(val_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(div.numpy(), _np(div_ref), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ compose
def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("clip", [None, (-0.5, 1.5)])
@pytest.mark.parametrize("shape", [(6, 2), (4, 5, 5, 3)])
def test_kappa_ito_matches_jax(clip, shape):
    """Sums over the feature dims and one division, float32: 1e-5."""
    s1, s2 = _rand(1, *shape), _rand(2, *shape)
    d1, d2 = _rand(3, shape[0], 1), _rand(4, shape[0], 1)
    ref = jcompose.kappa_ito(jnp.float32(0.7), (jnp.asarray(d1),
                                                jnp.asarray(d2)),
                             (jnp.asarray(s1), jnp.asarray(s2)), clip)
    ts1, ts2, td1, td2 = _t(s1, s2, d1, d2)
    got = compose.kappa_ito(0.7, (td1, td2), (ts1, ts2), clip)
    assert tuple(got.shape) == (shape[0],)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        compose.combine_kappa(got, ts1, ts2).numpy(),
        _np(jcompose.combine_kappa(ref, jnp.asarray(s1), jnp.asarray(s2))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bias", [0.0, [0.5, -1.0, 0.2], [[0.5], [-1.0], [0.2]]])
def test_or_softmax_matches_jax(bias):
    log_q = _rand(5, 3, 8) * 3
    ref = jcompose.or_softmax(jnp.asarray(log_q), 0.8, jnp.asarray(bias)
                              if bias != 0.0 else 0.0)
    got = compose.or_softmax(torch.from_numpy(log_q), 0.8, bias)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        compose.and_heuristic(torch.from_numpy(log_q)).numpy(),
        _np(jcompose.and_heuristic(jnp.asarray(log_q))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bias", [0.3, torch.tensor(-2.0)])
def test_or_softmax_rejects_a_scalar_bias(bias):
    with pytest.raises(ValueError, match="inert"):
        compose.or_softmax(torch.zeros(2, 3), 1.0, bias)
    with pytest.raises(ValueError, match="inert"):
        jcompose.or_softmax(jnp.zeros((2, 3)), 1.0, float(bias))


@pytest.mark.parametrize("bias", [0.0, 0.25, [0.1, -0.3]])
def test_and_solve_matches_jax(bias):
    """Closed-form 2 x 2 solve, float32: 1e-5. Row 0 is singular
    (det = 0): both give (0.5, 0.5); row 1 clamps to a vertex."""
    a, b = _rand(6, 9, 2, 2), _rand(7, 9, 2)
    a[0] = np.array([[1.0, 2.0], [0.5, 1.5]])            # p - q = 0
    a[1], b[1] = np.array([[1.0, 0.0], [0.0, 0.0]]), np.array([0.0, 50.0])
    ref = jcompose.and_solve(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias))
    got = compose.and_solve(*_t(a, b), bias)
    assert tuple(got.shape) == (9, 2)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0].numpy(), [0.5, 0.5])
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("k,bias", [(2, 0.0), (3, 0.2), (4, None)])
def test_and_solve_k_matches_jax(k, bias):
    """Batched K x K LU solve in float32 on well-conditioned systems
    (diagonally dominated): 1e-4. Row 0 is singular: uniform 1 / K."""
    if bias is None:
        bias = list(np.linspace(-0.2, 0.2, k).astype(np.float32))
    a = _rand(8 + k, 7, k, k) + 4 * np.eye(k, dtype=np.float32)
    b = _rand(9 + k, 7, k)
    a[0] = 1.0
    ref = jcompose.and_solve_k(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(bias))
    got = compose.and_solve_k(*_t(a, b), bias)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), 1.0 / k, atol=1e-6)
    with pytest.raises(ValueError, match="bias must be"):
        compose.and_solve_k(*_t(a, b), [0.0] * (k + 1))


def test_masks_match_jax():
    """resolve_occlusion is clamps and adds, masked one sum: 1e-6."""
    masks = (np.random.default_rng(3).random((3, 6, 6)) > 0.5).astype(
        np.float32)
    masks[1] *= 0.5                                        # a soft mask
    ref = jcompose.resolve_occlusion(jnp.asarray(masks))
    got = compose.resolve_occlusion(torch.from_numpy(masks))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-6)
    np.testing.assert_array_equal(got[-1].numpy(), masks[-1])   # top mask
    assert float(got.sum(0).max()) <= 1.0 + 1e-6
    eps = _rand(4, 3, 2, 6, 6, 3)
    np.testing.assert_allclose(
        compose.masked(torch.from_numpy(eps), got).numpy(),
        _np(jcompose.masked(jnp.asarray(eps), ref)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kappa", [[0.5, 0.5, 1.0],
                                   [[1.0, 0.5], [2.0, 1.0], [0.5, 3.0]]])
def test_fixed_matches_jax(kappa):
    eps = _rand(5, 3, 2, 4, 4, 1)
    np.testing.assert_allclose(
        compose.fixed(torch.from_numpy(eps), kappa).numpy(),
        _np(jcompose.fixed(jnp.asarray(eps), jnp.asarray(kappa))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weight,proj", [(1.0, None), (2.5, (0.2, 0.5, 0.3))])
def test_projected_matches_jax(weight, proj):
    full, sub = _rand(6, 2, 5, 5, 3), _rand(7, 2, 5, 5, 1)
    kw = {} if proj is None else {"proj": proj}
    ref = jcompose.projected(jnp.asarray(full), jnp.asarray(sub), weight, **kw)
    got = compose.projected(*_t(full, sub), weight, **kw)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-5)
    assert compose.LUMA_W == jcompose.LUMA_W
    if weight == 1.0:
        # the projected component is now the subspace expert's
        w = np.asarray(compose.LUMA_W, np.float32)
        w = w / np.sqrt((w * w).sum())
        np.testing.assert_allclose((got.numpy() * w).sum(-1, keepdims=True),
                                   sub, atol=1e-5)


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("name", ["dlog_alpha_dt", "beta", "g2"])
def test_schedule_coefficients_match_jax(name):
    """Closed forms in float32 in the same operation order: 1e-6 relative
    (XLA may contract a multiply-add)."""
    t = np.linspace(1e-3, 1.0, 57).astype(np.float32)
    ref = _np(getattr(JaxVP(), name)(jnp.asarray(t)))
    got = getattr(VPSchedule(), name)(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    one = getattr(VPSchedule(), name)(0.5)
    assert one.dtype == torch.float32 and one.dim() == 0


@pytest.mark.parametrize("name", ["em_table", "ode_table"])
@pytest.mark.parametrize("n_steps,t_max,t_min", [(1000, 1.0, 1e-3),
                                                 (7, 0.9, 0.05)])
def test_schedule_tables_match_jax(name, n_steps, t_max, t_min):
    ref = _np(getattr(JaxVP(), name)(n_steps, t_max, t_min))
    got = getattr(VPSchedule(), name)(n_steps, t_max, t_min)
    assert tuple(got.shape) == (n_steps, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("t_kind", ["scalar", "vector"])
def test_q_t_eps_matches_jax(t_kind):
    x0, eps = _rand(1, 4, 5, 5, 1), _rand(2, 4, 5, 5, 1)
    t = np.float32(0.3) if t_kind == "scalar" else np.linspace(
        0.1, 0.9, 4).astype(np.float32)
    ref = _np(JaxVP().q_t_eps(jnp.asarray(x0), jnp.asarray(t),
                              jnp.asarray(eps)))
    got = VPSchedule().q_t_eps(torch.from_numpy(x0), torch.as_tensor(t),
                               torch.from_numpy(eps)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
