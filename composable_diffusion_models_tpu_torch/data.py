"""Data: the procedural MNIST stand-in and shuffled batch indices.

Port of the parts of ``composable_diffusion_models_tpu.data`` that the
flagship's training runs: the 5x7 bitmap font (``_FONT``), the glyph
renderer (random scale and shift, bilinear resampling, a 3x3 box blur),
``synthetic_mnist``, ``get_mnist``, ``epoch_batches`` and
``infinite_batches``. Datasets are built on the device in one batched pass.

``get_mnist`` always builds the procedural set: the JAX package reads the
real MNIST IDX files first where it finds them (``load_mnist``), and that
branch is not ported until such files are in the repository.

Randomness comes from ``rng`` keys (or a ``rng.Replay`` of recorded
draws): ``synthetic_mnist`` splits its key into the label draw and the
render draws, as the JAX package's ``_build_synthetic`` does, and draws
for its power-of-two bucket, so the first n images get the draws the JAX
function gives them.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .rng import as_draws

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


def get_mnist(key, n: int = 8192, classes: Optional[Sequence[int]] = None,
              normalize: bool = True,
              device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """MNIST-shaped (N, 28, 28, 1) images and labels: the procedural set
    (see the module note on real MNIST), in [-1, 1] when ``normalize``."""
    imgs, labels = synthetic_mnist(key, n, classes, device=device)
    if normalize:
        imgs = imgs * 2.0 - 1.0
    return imgs, labels


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
