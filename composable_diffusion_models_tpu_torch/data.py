"""Data: device-resident procedural datasets, file readers and batch indices.

Port of ``composable_diffusion_models_tpu.data``:

* ``toy2d``, the 4-Gaussian grid halves;
* the shapes rasterizer (``rasterize_shape``: circle, square and triangle
  by coordinate predicates), ``make_shapes_dataset`` in every grayscale
  mode, the three-factor ``make_shapes_bbox_dataset`` (``rasterize_bbox``);
* MNIST: the IDX files where they are found (``load_mnist``), else the
  procedural stand-in (the 5x7 font rendered at a random scale and shift,
  bilinear, 3x3 box blur: ``synthetic_mnist``); ``get_mnist`` picks;
* colored MNIST (``colorize``, ``colored_mnist`` with every colour rule);
* CIFAR-10's binary batches (``load_cifar10``, ``write_cifar10_binaries``)
  and the procedural ten-class stand-in ``synthetic_cifar10``;
* ``get_dataset``, the registry by name; ``epoch_batches`` and
  ``infinite_batches``.

Every builder makes its dataset on ``device`` in one batched pass, without
a loop over images; masks and colours are the JAX package's float32
expressions, so the shapes and bbox images are its bits. The holdout
filter of ``colored_mnist`` runs on the host, as in JAX.

Randomness comes from ``rng`` keys (or a ``rng.Replay`` of recorded
draws), split as the JAX functions split theirs: ``synthetic_mnist`` into
the label draw and the render draws, and draws for its power-of-two
bucket, so the first n images get the draws the JAX function gives them.
Labels are int64.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .rng import as_draws

Holdout = Optional[Sequence[Tuple[int, int]]]
GRAY_MODES = (False, None, True, "white", "luma", "luma_norm")


# ------------------------------------------------------------ 2-D toy data
def toy2d(key, bs: int, up: bool = True, device="cpu") -> torch.Tensor:
    """(bs, 2) float32 points of the 4-Gaussian grid's upper (``up``) or
    lower half: integer corners in {0, 1}^2 restricted to the half, mapped
    by 3 (c - 0.5), plus 0.4 N(0, 1)."""
    k1, k2 = as_draws(key, device).split(2)
    lo, hi = ((0, 1), (1, 1)) if up else ((0, 0), (1, 0))
    corner = k1.randint((bs, 2), 2)  # column 1 is pinned to its half
    corner = torch.stack([corner[:, i].clamp(lo[i], hi[i]) for i in (0, 1)],
                         dim=1).float()
    return 3.0 * (corner - 0.5) + 0.4 * k2.normal((bs, 2))


# ---------------------------------------------------------------- shapes
SHAPES = ("circle", "square", "triangle")
SHAPE_COLORS = ("red", "green", "blue")
BBOX_COLORS = ("red", "green", "blue")
# PIL's named colours: "green" is #008000
_SHAPE_COLOR_RGB = np.array([[1.0, 0.0, 0.0],
                             [0.0, 128.0 / 255.0, 0.0],
                             [0.0, 0.0, 1.0]], np.float32)


def _grid(img_size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ar = torch.arange(img_size, dtype=torch.float32, device=device)
    return torch.meshgrid(ar, ar, indexing="ij")


def _shape_masks(img_size: int, device) -> torch.Tensor:
    """(3, H, W) float32 masks of the circle, the square and the triangle:
    margin m = img_size // 4, each spanning [m, img_size - m] inclusive.
    The edge expressions are the JAX package's; on these grids every
    operand is a small multiple of 1/2, so each product and difference is
    exact and the comparisons give its bits."""
    m = img_size // 4
    hi = img_size - m
    yy, xx = _grid(img_size, device)
    c, r = (m + hi) / 2.0, (hi - m) / 2.0
    circle = ((xx - c) ** 2 + (yy - c) ** 2) <= r ** 2
    square = (xx >= m) & (xx <= hi) & (yy >= m) & (yy <= hi)
    px, py = img_size / 2.0, float(m)  # the apex; the base runs m..hi at hi

    def halfplane(ax, ay, bx, by):
        return (bx - ax) * (yy - ay) - (by - ay) * (xx - ax)

    # apex -> (m, hi) -> (hi, hi) winds clockwise with y down: inside <= 0
    tri = ((halfplane(px, py, m, hi) <= 0) & (halfplane(m, hi, hi, hi) <= 0)
           & (halfplane(hi, hi, px, py) <= 0))
    return torch.stack([circle, square, tri]).float()


def rasterize_shape(shape_idx, img_size: int = 64,
                    device="cpu") -> torch.Tensor:
    """The float32 mask of shape ``shape_idx`` (0 circle, 1 square, 2
    triangle): (H, W) for an int, (N, H, W) for (N,) indices."""
    idx = torch.as_tensor(shape_idx, device=device).long()
    return _shape_masks(img_size, idx.device)[idx]


def _combos(holdout: Holdout) -> list:
    """The (shape, color) pairs in order, the held-out ones removed."""
    held = {tuple(h) for h in holdout} if holdout else set()
    return [(s, c) for s in range(3) for c in range(3) if (s, c) not in held]


def _cycle(size: int, combos: list, device):
    """(idx, shape labels, color labels): pair idx % len(combos) for
    image idx."""
    table = torch.tensor(combos, dtype=torch.long, device=device)
    idx = torch.arange(size, device=device)
    pick = table[idx % len(combos)]
    return idx, pick[:, 0], pick[:, 1]


def make_shapes_dataset(size: int = 5000, img_size: int = 64,
                        grayscale=False, holdout: Holdout = None,
                        background: str = "black", device="cpu"):
    """The shapes dataset on ``device``: (images NHWC in [-1, 1], shape
    labels, color labels). Image i shows pair i % len(pairs) of the nine
    (shape, color) pairs, those in ``holdout`` removed.

    ``grayscale``: False for RGB; True or "white" for white-on-black masks
    (one channel); "luma" for the ITU-601 luma of the RGB images; "luma_norm"
    for the unit-norm luma projection (``experts.rgb_to_gray`` with
    ``normalized=True``). ``background`` "white" puts the shapes on white.
    An unknown mode raises."""
    if grayscale not in GRAY_MODES:
        raise ValueError(f"unknown grayscale mode {grayscale!r}; choose "
                         "False | True | 'white' | 'luma' | 'luma_norm'")
    _, shape_labels, color_labels = _cycle(size, _combos(holdout), device)
    masks = rasterize_shape(shape_labels, img_size, device)[..., None]
    bg = 1.0 if background == "white" else 0.0
    if grayscale in (True, "white"):
        imgs = masks * 1.0 + (1.0 - masks) * bg
        return imgs * 2.0 - 1.0, shape_labels, color_labels
    colors = torch.from_numpy(_SHAPE_COLOR_RGB).to(masks.device)[color_labels]
    imgs = (masks * colors[:, None, None, :] + (1.0 - masks) * bg) * 2.0 - 1.0
    if grayscale in ("luma", "luma_norm"):
        from .experts import rgb_to_gray
        imgs = rgb_to_gray(imgs, normalized=grayscale == "luma_norm")
    return imgs, shape_labels, color_labels


def rasterize_bbox(img_size: int = 64, padding: int = 4, width: int = 2,
                   device="cpu") -> torch.Tensor:
    """(H, W) float32 outline of the box [padding, img_size - padding]
    (inclusive), its stroke ``width`` pixels wide and drawn inward, as
    PIL's ``rectangle(..., width=2)`` draws it."""
    p, s = padding, img_size
    yy, xx = _grid(s, device)
    outer = (xx >= p) & (xx <= s - p) & (yy >= p) & (yy <= s - p)
    inner = ((xx >= p + width) & (xx <= s - p - width)
             & (yy >= p + width) & (yy <= s - p - width))
    return (outer & ~inner).float()


def make_shapes_bbox_dataset(size: int = 5000, img_size: int = 64,
                             holdout: Holdout = None, device="cpu"):
    """Three factors on ``device``: a colored shape on white with a colored
    box outline drawn over it. Returns (images NHWC in [-1, 1], shape
    labels, color labels, bbox labels); the (shape, color) pairs cycle as in
    :func:`make_shapes_dataset`, the box color as i % 3."""
    idx, shape_labels, color_labels = _cycle(size, _combos(holdout), device)
    bbox_labels = idx % 3
    lut = torch.from_numpy(_SHAPE_COLOR_RGB).to(idx.device)
    masks = rasterize_shape(shape_labels, img_size, device)[..., None]
    box = rasterize_bbox(img_size, device=device)[None, :, :, None]
    imgs = torch.where(masks > 0, lut[color_labels][:, None, None, :],
                       torch.ones((), device=idx.device))
    imgs = torch.where(box > 0, lut[bbox_labels][:, None, None, :], imgs)
    return imgs * 2.0 - 1.0, shape_labels, color_labels, bbox_labels


# ----------------------------------------------------------------- MNIST
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _font_array(device="cpu") -> torch.Tensor:
    """(10, 9, 9) float32 glyph bitmaps, the 5x7 font centred in 9x9."""
    glyphs = np.zeros((10, 9, 9), np.float32)
    for d, rows in _FONT.items():
        glyphs[d, 1:8, 2:7] = [[int(ch) for ch in r] for r in rows]
    return torch.from_numpy(glyphs).to(device)


def _bilinear(img: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates(img, [y, x], order=1,
    mode="constant", cval=0)`` per image: img (N, H, W), y and x (N, ...)
    float32 source coordinates. Each of the four neighbours that lies
    outside the image contributes 0; the four weighted terms are summed in
    map_coordinates' order."""
    n, h, w = img.shape
    flat = img.reshape(n, h * w)
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    iy0, ix0 = y0.long(), x0.long()
    out = None
    for iy, wy in ((iy0, 1 - wy1), (iy0 + 1, wy1)):
        for ix, wx in ((ix0, 1 - wx1), (ix0 + 1, wx1)):
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, -1)
            val = torch.gather(flat, 1, idx).reshape(iy.shape)
            term = (wy * wx) * torch.where(valid, val, torch.zeros_like(val))
            out = term if out is None else out + term
    return out


def _render_digit(glyphs: torch.Tensor, scale: torch.Tensor, tx: torch.Tensor,
                  ty: torch.Tensor, out_size: int = 28) -> torch.Tensor:
    """(N, 9, 9) glyphs sampled into (N, out, out) at scale ``scale`` and
    shift (``tx``, ``ty``) (each (N,) float32) about the canvas centre, then
    3x3 box-blurred with zero padding ("same") and clipped: values in
    [0, 1]. The JAX renderer draws scale ~ U(2.2, 3.2) and tx, ty ~
    U(-2.5, 2.5) itself; here the caller does."""
    ar = torch.arange(out_size, dtype=torch.float32, device=glyphs.device)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    c = (out_size - 1) / 2.0
    sc, tx, ty = (v.float()[:, None, None] for v in (scale, tx, ty))
    img = _bilinear(glyphs, (yy - c - ty) / sc + 4.0, (xx - c - tx) / sc + 4.0)
    box = torch.ones((1, 1, 3, 3), device=glyphs.device) / 9.0
    img = F.conv2d(img[:, None], box, padding=1)[:, 0]
    return torch.clamp(img * 1.6, 0.0, 1.0)


def synthetic_mnist(key, n: int, classes: Optional[Sequence[int]] = None,
                    img_size: int = 28,
                    device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Procedural MNIST stand-in: (N, H, W, 1) float32 images in [0, 1] and
    (N,) int64 labels drawn uniformly from ``classes`` (all ten digits by
    default), built on ``device``. Draws and renders a power-of-two bucket
    of at least 256 images and returns the first n, as the JAX function
    does."""
    classes_t = tuple(int(c) for c in (range(10) if classes is None
                                       else classes))
    bucket = 256
    while bucket < n:
        bucket *= 2
    kl, kr = as_draws(key, device).split(2)
    pick = kl.randint((bucket,), len(classes_t))
    labels = torch.tensor(classes_t, device=pick.device)[pick]
    ks, kx, ky = kr.split(3)
    scale = ks.uniform((bucket,), 2.2, 3.2)
    tx = kx.uniform((bucket,), -2.5, 2.5)
    ty = ky.uniform((bucket,), -2.5, 2.5)
    imgs = _render_digit(_font_array(pick.device)[labels], scale, tx, ty,
                         img_size)
    return imgs[:n, ..., None], labels[:n]


def _read_idx(path: str) -> np.ndarray:
    """An IDX file (gzip-compressed where the name ends in .gz) as a uint8
    array of its dimensions."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load_mnist(data_dir: Optional[str] = None,
               classes: Optional[Sequence[int]] = None, split: str = "train",
               device="cpu") -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Real MNIST from {train,t10k}-{images-idx3,labels-idx1}-ubyte[.gz]
    in the first of ``data_dir``, $CDX_MNIST_DIR, data/MNIST/raw and data
    that holds both files: ((N, 28, 28, 1) float32 in [0, 1], labels) on
    ``device``, only ``classes`` where given; None where none does."""
    prefix = "train" if split == "train" else "t10k"
    dirs = [d for d in (data_dir, os.environ.get("CDX_MNIST_DIR"),
                        "data/MNIST/raw", "data") if d]
    for d in dirs:
        for ext in ("", ".gz"):
            img_p = os.path.join(d, f"{prefix}-images-idx3-ubyte{ext}")
            lab_p = os.path.join(d, f"{prefix}-labels-idx1-ubyte{ext}")
            if os.path.exists(img_p) and os.path.exists(lab_p):
                imgs = _read_idx(img_p).astype(np.float32) / 255.0
                labels = _read_idx(lab_p).astype(np.int64)
                if classes is not None:
                    keep = np.isin(labels, list(classes))
                    imgs, labels = imgs[keep], labels[keep]
                return (torch.from_numpy(imgs[..., None]).to(device),
                        torch.from_numpy(labels).to(device))
    return None


def get_mnist(key, n: int = 8192, classes: Optional[Sequence[int]] = None,
              data_dir: Optional[str] = None, normalize: bool = True,
              device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """MNIST-shaped (N, 28, 28, 1) images and labels on ``device``: the IDX
    files where :func:`load_mnist` finds them (n of them in a random order
    drawn with ``key`` when there are more), else the procedural set; in
    [-1, 1] when ``normalize``."""
    real = load_mnist(data_dir, classes, device=device)
    if real is not None:
        imgs, labels = real
        if n and n < imgs.shape[0]:
            sel = as_draws(key, device).permutation(imgs.shape[0])[:n]
            imgs, labels = imgs[sel], labels[sel]
    else:
        imgs, labels = synthetic_mnist(key, n, classes, device=device)
    if normalize:
        imgs = imgs * 2.0 - 1.0
    return imgs, labels


# --------------------------------------------------------- colored MNIST
# the per-digit colours of the reference's colored MNIST
DIGIT_COLORS = np.array([
    [0.5, 0.5, 0.5],   # 0 gray
    [0.0, 0.5, 1.0],   # 1 light blue
    [0.0, 0.8, 0.0],   # 2 green
    [0.0, 0.8, 0.8],   # 3 cyan
    [1.0, 0.5, 0.0],   # 4 orange
    [1.0, 1.0, 0.0],   # 5 yellow
    [1.0, 0.0, 0.0],   # 6 red
    [1.0, 0.0, 1.0],   # 7 magenta
    [0.5, 0.0, 1.0],   # 8 purple
    [0.6, 0.3, 0.1],   # 9 brown
], np.float32)
COLOR_RULES = ("per_digit", "div4", "random")


def colorize(imgs01: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) in [0, 1] times (N, 3) colours -> (N, H, W, 3) in
    [-1, 1]."""
    return imgs01 * colors[:, None, None, :] * 2.0 - 1.0


def colored_mnist(key, n: int = 8192, classes: Optional[Sequence[int]] = None,
                  color_rule: str = "per_digit",
                  color_override: Optional[Sequence[float]] = None,
                  data_dir: Optional[str] = None, holdout: Holdout = None,
                  device="cpu"):
    """Colored digits on ``device``: (images (N, H, W, 3) in [-1, 1], digit
    labels, color labels). ``color_rule``: "per_digit" (``DIGIT_COLORS``
    of the digit, color label = digit), "div4" (the colour of digit // 4)
    or "random" (one of the three shape colours drawn per image).
    ``color_override``: one RGB colour for every image, color label 0.
    ``holdout``: (digit, color label) pairs dropped (a filter on the host,
    then one gather on the device)."""
    if color_rule not in COLOR_RULES:
        raise ValueError(f"unknown color_rule: {color_rule!r}")
    k1, k2 = as_draws(key, device).split(2)
    imgs01, labels = get_mnist(k1, n, classes, data_dir, normalize=False,
                               device=device)
    dev = imgs01.device
    if color_override is not None:
        colors = torch.tensor(color_override, dtype=torch.float32,
                              device=dev).expand(imgs01.shape[0], 3)
        color_labels = torch.zeros_like(labels)
    elif color_rule == "random":
        color_labels = k2.randint((labels.shape[0],), 3)
        colors = torch.from_numpy(_SHAPE_COLOR_RGB).to(dev)[color_labels]
    else:
        color_labels = labels if color_rule == "per_digit" else labels // 4
        colors = torch.from_numpy(DIGIT_COLORS).to(dev)[color_labels]
    rgb = colorize(imgs01, colors)
    if holdout:
        held = np.asarray(list(holdout), np.int64)
        lab, col = labels.cpu().numpy(), color_labels.cpu().numpy()
        hit = np.any((lab[:, None] == held[None, :, 0])
                     & (col[:, None] == held[None, :, 1]), axis=1)
        keep = torch.from_numpy(np.nonzero(~hit)[0]).to(dev)
        rgb, labels, color_labels = (rgb[keep], labels[keep],
                                     color_labels[keep])
    return rgb, labels, color_labels


# -------------------------------------------------------------- CIFAR-10
def load_cifar10(data_dir: Optional[str] = None,
                 classes: Optional[Sequence[int]] = None, device="cpu"
                 ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """CIFAR-10's binary batches data_batch_{1..5}.bin from the first of
    ``data_dir``, $CDX_CIFAR_DIR, data/cifar-10-batches-bin and data that
    holds any: (images (N, 32, 32, 3) float32 in [-1, 1], labels) on
    ``device``, only ``classes`` where given; None where none does."""
    dirs = [d for d in (data_dir, os.environ.get("CDX_CIFAR_DIR"),
                        "data/cifar-10-batches-bin", "data") if d]
    for d in dirs:
        batches = [p for p in (os.path.join(d, f"data_batch_{i}.bin")
                               for i in range(1, 6)) if os.path.exists(p)]
        if not batches:
            continue
        raw = np.concatenate([np.fromfile(p, np.uint8).reshape(-1, 3073)
                              for p in sorted(batches)])
        labels = raw[:, 0].astype(np.int64)
        imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        if classes is not None:
            keep = np.isin(labels, list(classes))
            imgs, labels = imgs[keep], labels[keep]
        imgs = torch.from_numpy(np.ascontiguousarray(imgs)).to(device)
        return (imgs.float() / 255.0 * 2.0 - 1.0,
                torch.from_numpy(labels).to(device))
    return None


# the stand-in's ten class colours: warm hues for classes 0-4, cool for 5-9
_CIFAR_STANDIN_RGB = np.array(
    [[0.90, 0.10, 0.10], [0.95, 0.55, 0.10], [0.85, 0.85, 0.10],
     [0.80, 0.30, 0.55], [0.95, 0.40, 0.35],
     [0.10, 0.35, 0.90], [0.10, 0.80, 0.80], [0.20, 0.70, 0.25],
     [0.45, 0.25, 0.85], [0.55, 0.75, 0.95]], np.float32)


def synthetic_cifar10(key, n: int, img_size: int = 32,
                      device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """A procedural CIFAR-10 stand-in on ``device`` (not natural images):
    class i % 10 for image i, five shapes (circle, square, wedge, ring,
    cross) in the class's colour at a random centre, radius and
    brightness over a clipped noisy dark background. Returns (uint8 images
    (N, S, S, 3), int64 labels), which round-trip through the binary
    format (:func:`write_cifar10_binaries`, :func:`load_cifar10`)."""
    k1, k2, k3, k4, k5 = as_draws(key, device).split(5)
    labels = torch.arange(n, device=device) % 10
    yy, xx = _grid(img_size, labels.device)
    c0 = img_size / 2.0
    cx = c0 + k1.uniform((n,), -4.0, 4.0)
    cy = c0 + k2.uniform((n,), -4.0, 4.0)
    r = k3.uniform((n,), 0.22 * img_size, 0.34 * img_size)[:, None, None]
    dx, dy = xx - cx[:, None, None], yy - cy[:, None, None]
    ax, ay = dx.abs(), dy.abs()
    d2 = dx ** 2 + dy ** 2
    masks = torch.stack([
        d2 <= r ** 2,
        (ax <= r * 0.9) & (ay <= r * 0.9),
        (dy >= -r) & (dy <= r * 0.7) & (ax * 1.6 <= (dy + r) * 0.85),
        (d2 <= r ** 2) & (d2 >= (0.55 * r) ** 2),
        ((ax <= r * 0.35) & (ay <= r)) | ((ay <= r * 0.35) & (ax <= r)),
    ], dim=1)
    mask = masks[torch.arange(n, device=labels.device),
                 labels % 5].float()[..., None]
    fg = torch.from_numpy(_CIFAR_STANDIN_RGB).to(labels.device)[labels]
    bright = k4.uniform((n, 1, 1, 1), 0.75, 1.0)
    bg = 0.18 + 0.12 * k5.normal((n, img_size, img_size, 3))
    img = (mask * fg[:, None, None, :] * bright
           + (1.0 - mask) * bg.clamp(0.0, 0.45))
    return torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8), labels


def write_cifar10_binaries(imgs_uint8, labels, out_dir: str,
                           n_batches: int = 5) -> str:
    """(N, 32, 32, 3) uint8 images and their labels (tensors or arrays) as
    CIFAR-10's binary batches, rows [label, 3072 CHW pixels], in
    ``n_batches`` files data_batch_{1..}.bin under ``out_dir``; returns
    ``out_dir``."""
    imgs = np.asarray(torch.as_tensor(imgs_uint8).cpu())
    labels = np.asarray(torch.as_tensor(labels).cpu()).astype(np.uint8)
    if imgs.dtype != np.uint8 or imgs.shape[1:] != (32, 32, 3):
        raise ValueError(f"expected (N, 32, 32, 3) uint8 images, got "
                         f"{imgs.dtype} {imgs.shape}")
    os.makedirs(out_dir, exist_ok=True)
    rows = np.concatenate(
        [labels[:, None],
         imgs.transpose(0, 3, 1, 2).reshape(imgs.shape[0], 3072)], axis=1)
    for b, chunk in enumerate(np.array_split(rows, n_batches), start=1):
        chunk.tofile(os.path.join(out_dir, f"data_batch_{b}.bin"))
    return out_dir


# ---------------------------------------------------------------- registry
def get_dataset(name: str, key, n: int = 8192, device="cpu", **kw):
    """The dataset ``name`` on ``device``: (images, *label arrays). Names:
    mnist | grayscale_mnist | colored_mnist | randomly_colored_mnist |
    shapes | shapes_grayscale | shapes_bbox | cifar10 | toy2d. Extra
    keywords go to its builder (classes, holdout, img_size, color_rule,
    grayscale, ...); toy2d's label is 0."""
    name = name.lower()
    if name in ("mnist", "grayscale_mnist"):
        return get_mnist(key, n, device=device, **kw)
    if name == "colored_mnist":
        return colored_mnist(key, n, device=device, **kw)
    if name == "randomly_colored_mnist":
        kw.setdefault("color_rule", "random")
        return colored_mnist(key, n, device=device, **kw)
    if name == "shapes":
        return make_shapes_dataset(size=n, device=device, **kw)
    if name == "shapes_grayscale":
        kw.setdefault("grayscale", True)
        return make_shapes_dataset(size=n, device=device, **kw)
    if name == "shapes_bbox":
        return make_shapes_bbox_dataset(size=n, device=device, **kw)
    if name == "cifar10":
        out = load_cifar10(device=device, **kw)
        if out is None:
            raise FileNotFoundError(
                "cifar10 binaries not found (set CDX_CIFAR_DIR)")
        imgs, labels = out
        return (imgs[:n], labels[:n]) if n else (imgs, labels)
    if name == "toy2d":
        pts = toy2d(key, n, device=device, **kw)
        return pts, torch.zeros((n,), dtype=torch.long, device=pts.device)
    raise ValueError(f"unknown dataset {name!r}; see data.get_dataset")


# ---------------------------------------------------------------- batching
def epoch_batches(key, n: int, batch_size: int,
                  device="cpu") -> torch.Tensor:
    """(n // bs, bs) int64 index matrix of one shuffled epoch (the ragged
    tail dropped)."""
    perm = as_draws(key, device).permutation(n)
    n_batches = n // batch_size
    return perm[: n_batches * batch_size].reshape(n_batches, batch_size)


def infinite_batches(key, n: int, batch_size: int,
                     device="cpu") -> Iterator[torch.Tensor]:
    """Shuffled batch indices without end, epoch e shuffled with key
    ``fold_in(key, e)``."""
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}; "
                         "shrink the batch or grow the dataset")
    key = as_draws(key, device)
    epoch = 0
    while True:
        yield from epoch_batches(key.fold_in(epoch), n, batch_size)
        epoch += 1
