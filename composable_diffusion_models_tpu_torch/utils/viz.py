"""Host-side visualization: image grids, scatters, loss curves, GIFs.

Port of ``composable_diffusion_models_tpu.utils.viz``. Pure host code on
arrays fetched from the device (a tensor on any device is copied to the
host first).

:func:`_to_numpy_grid` is the JAX package's, line for line: the same
uint8 grid from the same array. :func:`save_grid` differs on purpose: it
writes that grid itself as an 8-bit RGB PNG with ``zlib`` and ``struct``
from the standard library, so the file holds the grid's exact pixels (one
pixel per grid pixel, no title), where the JAX function draws the grid
into a matplotlib figure (axes off, optional title, 100 dpi) and saves
the figure. It needs neither matplotlib nor PIL. :func:`save_gif`,
:func:`scatter2d` and :func:`plot_loss` keep matplotlib, imported inside
the function as in the JAX package: they raise where it is missing.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np


def _host(images) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as a float32 numpy
    array."""
    if hasattr(images, "detach"):
        images = images.detach().float().cpu().numpy()
    return np.asarray(images, np.float32)


def _to_numpy_grid(images: np.ndarray, nrow: int, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) in [-1, 1] or [0, 1] -> one (GH, GW, 3) uint8 grid."""
    images = np.asarray(images, np.float32)
    if images.min() < -0.01:
        images = (images + 1.0) / 2.0
    images = np.clip(images, 0.0, 1.0)
    if images.shape[-1] == 1:
        images = np.repeat(images, 3, axis=-1)
    n, h, w, c = images.shape
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    grid = np.ones((nrows * (h + pad) + pad, ncol * (w + pad) + pad, 3),
                   np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return (grid * 255).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_bytes(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 array as the bytes of an 8-bit RGB PNG (filter 0
    on every row, one zlib stream)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def save_grid(images, path: str, nrow: int = 8, title: Optional[str] = None):
    """Writes ``_to_numpy_grid(images, nrow)`` to ``path`` as an RGB PNG,
    pixel for pixel. ``title`` is accepted for the JAX signature and not
    drawn (the file holds the grid alone). Returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    grid = _to_numpy_grid(_host(images), nrow)
    with open(path, "wb") as f:
        f.write(_png_bytes(grid))
    return path


def save_gif(frames: Sequence, path: str, nrow: int = 8, fps: int = 8):
    """Trajectory animation from a list of (N, H, W, C) snapshots."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    grids = [_to_numpy_grid(_host(f), nrow) for f in frames]
    fig, ax = plt.subplots()
    ax.axis("off")
    im = ax.imshow(grids[0])

    def update(i):
        im.set_data(grids[i])
        return [im]

    ani = animation.FuncAnimation(fig, update, frames=len(grids))
    ani.save(path, writer="pillow", fps=fps)
    plt.close(fig)
    return path


def scatter2d(points, path: str, labels=None, title: Optional[str] = None,
              lim: float = 3.0):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pts = _host(points)
    fig, ax = plt.subplots(figsize=(5, 5))
    if labels is not None:
        labels = np.asarray(labels)
        for lab in np.unique(labels):
            sel = labels == lab
            ax.scatter(pts[sel, 0], pts[sel, 1], s=4, alpha=0.5, label=str(lab))
        ax.legend()
    else:
        ax.scatter(pts[:, 0], pts[:, 1], s=4, alpha=0.5)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.grid(True)
    if title:
        ax.set_title(title)
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return path


def plot_loss(losses, path: str, title: str = "training loss"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots()
    ax.plot(_host(losses))
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.set_title(title)
    ax.grid(True)
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return path
