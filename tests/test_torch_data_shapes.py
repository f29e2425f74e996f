"""Port parity for the procedural datasets the UNet experts train on: the
shapes rasterizer and dataset in every grayscale mode, the bbox dataset,
colored MNIST under every colour rule, ``toy2d``, the synthetic CIFAR-10
stand-in (the JAX draws replayed through ``rng.Replay``), the IDX and
CIFAR file readers on files written here, and ``get_dataset``."""

import gzip
import struct

import jax
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import data as jdata
from composable_diffusion_models_tpu_torch import data
from composable_diffusion_models_tpu_torch.rng import Replay

torch.set_num_threads(1)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(got, ref):
    """Bit for bit, labels as int64."""
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_array_equal(_np(g), r.astype(_np(g).dtype))
        assert _np(g).shape == r.shape


# ---------------------------------------------------------------- shapes
@pytest.mark.parametrize("img", [16, 28, 64, 27])
def test_shape_masks_bit_for_bit(img):
    """Every shape's mask at 16, 28 and 64 pixels (and an odd size, where
    the apex sits on a half pixel): the JAX float32 comparisons' bits."""
    got = data.rasterize_shape(torch.arange(3), img).numpy()
    ref = np.stack([np.asarray(jdata.rasterize_shape(s, img))
                    for s in range(3)])
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32 and got.sum() > 0
    np.testing.assert_array_equal(data.rasterize_shape(2, img).numpy(),
                                  ref[2])


@pytest.mark.parametrize("mode", [False, True, "white"])
@pytest.mark.parametrize("background", ["black", "white"])
def test_shapes_dataset_bit_for_bit(mode, background):
    """RGB and white-on-black images, shape and color labels, with a
    holdout and on either background: bit for bit."""
    for holdout in (None, [(0, 1), (2, 2)]):
        ref = jdata.make_shapes_dataset(40, 16, grayscale=mode,
                                        holdout=holdout,
                                        background=background)
        got = data.make_shapes_dataset(40, 16, grayscale=mode,
                                       holdout=holdout,
                                       background=background)
        _same(got, ref)
        assert got[0].shape[-1] == (1 if mode else 3)


@pytest.mark.parametrize("mode", ["luma", "luma_norm"])
def test_shapes_dataset_luma_modes(mode):
    """The luma projections through the port's ``experts.rgb_to_gray``:
    1e-6; labels equal."""
    ref = jdata.make_shapes_dataset(27, 28, grayscale=mode,
                                    holdout=[(1, 0)])
    got = data.make_shapes_dataset(27, 28, grayscale=mode, holdout=[(1, 0)])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
    _same(got[1:], ref[1:])


def test_shapes_dataset_rejects_unknown_mode():
    for lib in (jdata, data):
        with pytest.raises(ValueError, match="unknown grayscale mode"):
            lib.make_shapes_dataset(4, 16, grayscale="luma-norm")


def test_bbox_dataset_bit_for_bit():
    """The outline alone and the three-factor images with a holdout: bit
    for bit, all four outputs."""
    for img in (16, 64):
        np.testing.assert_array_equal(data.rasterize_bbox(img).numpy(),
                                      np.asarray(jdata.rasterize_bbox(img)))
    for holdout in (None, [(2, 0)]):
        ref = jdata.make_shapes_bbox_dataset(30, 64, holdout=holdout)
        got = data.make_shapes_bbox_dataset(30, 64, holdout=holdout)
        _same(got, ref)


# ----------------------------------------------------------- colored MNIST
def _synthetic_draws(key, bucket, n_classes):
    kl, kr = jax.random.split(key)
    pick = jax.random.randint(kl, (bucket,), 0, n_classes)

    def one(k):
        ks, kx, ky = jax.random.split(k, 3)
        return (jax.random.uniform(ks, (), minval=2.2, maxval=3.2),
                jax.random.uniform(kx, (), minval=-2.5, maxval=2.5),
                jax.random.uniform(ky, (), minval=-2.5, maxval=2.5))
    scale, tx, ty = jax.vmap(one)(jax.random.split(kr, bucket))
    return [np.asarray(a) for a in (pick, scale, tx, ty)]


@pytest.mark.parametrize("kw", [
    dict(), dict(color_rule="div4", classes=(3, 4, 5, 8)),
    dict(color_rule="random"), dict(color_override=(0.2, 0.4, 0.9)),
    dict(color_rule="random", holdout=[(1, 2), (7, 0)]),
    dict(holdout=[(3, 3)])])
def test_colored_mnist_replays_jax_draws(kw):
    """Every colour rule, the override and the host-side holdout, on 100
    procedural digits with the JAX draws replayed: images 1e-6, labels
    equal."""
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    classes = kw.get("classes")
    draws = _synthetic_draws(k1, 256, len(classes) if classes else 10)
    if kw.get("color_rule") == "random" and "color_override" not in kw:
        draws.append(np.asarray(jax.random.randint(k2, (100,), 0, 3)))
    ref = jdata.colored_mnist(key, 100, **kw)
    got = data.colored_mnist(Replay(draws), 100, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
    _same(got[1:], ref[1:])
    if kw.get("holdout"):
        assert got[0].shape[0] < 100
    with pytest.raises(ValueError, match="color_rule"):
        data.colored_mnist(0, 8, color_rule="per_color")


def test_colorize_matches_jax():
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (5, 7, 7, 1)).astype(np.float32)
    colors = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        data.colorize(torch.from_numpy(imgs), torch.from_numpy(colors)),
        np.asarray(jdata.colorize(imgs, colors)), rtol=0, atol=1e-6)


# ------------------------------------------------------- toy2d and CIFAR
@pytest.mark.parametrize("up", [True, False])
def test_toy2d_replays_jax_draws(up):
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    lo, hi = ((0, 1), (2, 2)) if up else ((0, 0), (2, 1))
    draws = [np.asarray(jax.random.randint(k1, (64, 2), np.array(lo),
                                           np.array(hi))),
             np.asarray(jax.random.normal(k2, (64, 2)))]
    got = data.toy2d(Replay(draws), 64, up=up)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jdata.toy2d(key, 64, up=up)),
                               rtol=0, atol=1e-6)
    own = data.toy2d(3, 4000, up=up).numpy()
    # the corners of the half: y at 1.5 (up) or -1.5, x at both
    assert abs(own[:, 1].mean() - (1.5 if up else -1.5)) < 0.05
    assert abs(own[:, 0].mean()) < 0.1


def test_synthetic_cifar10_replays_jax_draws():
    """All ten classes (five shapes) at 32 pixels with the JAX draws
    replayed: the uint8 images equal, labels equal."""
    key = jax.random.PRNGKey(9)
    ks = jax.random.split(key, 5)
    n, s = 40, 32
    draws = [jax.random.uniform(ks[0], (n,), minval=-4.0, maxval=4.0),
             jax.random.uniform(ks[1], (n,), minval=-4.0, maxval=4.0),
             jax.random.uniform(ks[2], (n,), minval=0.22 * s,
                                maxval=0.34 * s),
             jax.random.uniform(ks[3], (n, 1, 1, 1), minval=0.75,
                                maxval=1.0),
             jax.random.normal(ks[4], (n, s, s, 3))]
    ref = jdata.synthetic_cifar10(key, n)
    got = data.synthetic_cifar10(Replay([np.asarray(d) for d in draws]), n)
    assert got[0].dtype == torch.uint8
    _same(got, ref)


# ------------------------------------------------------------ file readers
def _write_idx(path, arr, gz):
    arr = np.asarray(arr, np.uint8)
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_read_by_both(tmp_path, gz):
    """IDX files written here (plain and gzip): ``load_mnist`` with and
    without a class filter, and ``get_mnist``'s random subset with the
    JAX permutation replayed, equal to the JAX package's."""
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (50, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 50).astype(np.uint8)
    ext = ".gz" if gz else ""
    _write_idx(tmp_path / f"train-images-idx3-ubyte{ext}", imgs, gz)
    _write_idx(tmp_path / f"train-labels-idx1-ubyte{ext}", labels, gz)
    np.testing.assert_array_equal(
        data._read_idx(str(tmp_path / f"train-images-idx3-ubyte{ext}")), imgs)
    for classes in (None, (1, 4, 7)):
        ref = jdata.load_mnist(str(tmp_path), classes)
        got = data.load_mnist(str(tmp_path), classes)
        _same(got, ref)
    key = jax.random.PRNGKey(2)
    perm = np.asarray(jax.random.permutation(key, 50))
    ref = jdata.get_mnist(key, 20, data_dir=str(tmp_path))
    got = data.get_mnist(Replay([perm]), 20, data_dir=str(tmp_path))
    _same(got, ref)


def test_cifar_binaries_round_trip_between_packages(tmp_path):
    """The port writes the stand-in as binary batches that both packages
    read alike (all classes and a class filter), and reads what the JAX
    package writes."""
    imgs, labels = data.synthetic_cifar10(5, 30)
    data.write_cifar10_binaries(imgs, labels, str(tmp_path / "port"), 3)
    for classes in (None, (0, 5, 9)):
        ref = jdata.load_cifar10(str(tmp_path / "port"), classes)
        got = data.load_cifar10(str(tmp_path / "port"), classes)
        _same(got, ref)
    back = data.load_cifar10(str(tmp_path / "port"))
    np.testing.assert_array_equal(
        np.round((back[0].numpy() + 1.0) / 2.0 * 255.0), imgs.numpy())
    jimgs, jlabels = jdata.synthetic_cifar10(jax.random.PRNGKey(0), 20)
    jdata.write_cifar10_binaries(np.asarray(jimgs), np.asarray(jlabels),
                                 str(tmp_path / "jax"), 2)
    _same(data.load_cifar10(str(tmp_path / "jax")),
          jdata.load_cifar10(str(tmp_path / "jax")))
    with pytest.raises(ValueError):
        data.write_cifar10_binaries(imgs.float(), labels, str(tmp_path))


def test_get_dataset_dispatches_every_name(tmp_path):
    """Every registered name builds what its builder builds (the
    deterministic ones against the JAX registry bit for bit), and an
    unknown name or missing CIFAR files raise as in JAX."""
    for name, kw in (("shapes", dict(img_size=16)),
                     ("shapes_grayscale", dict(img_size=16)),
                     ("shapes_grayscale", dict(img_size=16,
                                               grayscale="white")),
                     ("shapes_bbox", dict(img_size=16))):
        _same(data.get_dataset(name, 0, 18, **kw),
              jdata.get_dataset(name, jax.random.PRNGKey(0), 18, **kw))
    assert data.get_dataset("mnist", 1, 8)[0].shape == (8, 28, 28, 1)
    assert data.get_dataset("grayscale_mnist", 1, 8, classes=(2,))[1]\
        .eq(2).all()
    rgb, _, cl = data.get_dataset("randomly_colored_mnist", 1, 300)
    assert rgb.shape == (300, 28, 28, 3) and set(cl.tolist()) == {0, 1, 2}
    rgb, lab, cl = data.get_dataset("colored_mnist", 1, 8)
    assert torch.equal(lab, cl)
    pts, lab = data.get_dataset("toy2d", 1, 16, up=False)
    assert pts.shape == (16, 2) and not lab.any()
    imgs, labels = data.synthetic_cifar10(0, 12)
    data.write_cifar10_binaries(imgs, labels, str(tmp_path))
    cif = data.get_dataset("cifar10", 0, 5, data_dir=str(tmp_path))
    assert cif[0].shape == (5, 32, 32, 3)
    with pytest.raises(FileNotFoundError):
        data.get_dataset("cifar10", 0, 5, data_dir=str(tmp_path / "none"))
    with pytest.raises(ValueError, match="unknown dataset"):
        data.get_dataset("imagenet", 0, 5)
