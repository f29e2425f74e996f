"""PCA latent codec: fit, encode, decode, and the ``.npy`` file contract.

Port of ``composable_diffusion_models_tpu.ops.pca``. Conventions match
sklearn: ``components`` rows are unit principal axes sorted by explained
variance; encode z = (x - mean) @ W^T, decode x = z @ W + mean. The sign of
a component is arbitrary. Both products go through the ``matmul`` kernel
(``ops.kernels.matmul``); the mean subtract and add stay PyTorch ops. The
fit's covariance is a plain large product (``torch.matmul``) followed by
``torch.linalg.eigh``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import kernels


@dataclasses.dataclass(frozen=True, eq=False)
class PCA:
    mean: torch.Tensor                # (D,)
    components: torch.Tensor          # (k, D)
    explained_variance: torch.Tensor  # (k,)
    # W^T (D, k) laid out contiguously once, so that encode's right operand
    # is read along its rows at every call
    components_t: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "components_t",
                           self.components.t().contiguous())

    def to(self, device) -> "PCA":
        return PCA(self.mean.to(device), self.components.to(device),
                   self.explained_variance.to(device))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        return kernels.matmul(flat - self.mean, self.components_t)

    def decode(self, z: torch.Tensor,
               shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        flat = kernels.matmul(z, self.components) + self.mean
        return flat if shape is None else flat.reshape(z.shape[0], *shape)


def fit_pca(x: torch.Tensor, n_components: int) -> PCA:
    """Fit PCA on (N, ...) data flattened to (N, D): eigendecomposition of
    the float32 (D, D) feature covariance, axes in descending order of
    explained variance. The decomposition runs in float64 and its result
    is rounded to float32: the float32 solver fails to converge on a
    covariance with many equal eigenvalues, as the ``shapes_latent``
    preset's data give (three distinct images: rank 2 of 4096)."""
    flat = x.reshape(x.shape[0], -1).float()
    mean = flat.mean(dim=0)
    centered = flat - mean
    cov = (centered.t() @ centered) / (flat.shape[0] - 1)
    evals, evecs = torch.linalg.eigh(cov.double())   # ascending
    order = torch.argsort(evals).flip(0)[:n_components]
    return PCA(mean, evecs[:, order].t().float().contiguous(),
               evals[order].float())


def save_pca(path_prefix: str, pca: PCA) -> None:
    """Persist as raw arrays: ``<prefix>_mean.npy``, ``_components.npy``,
    ``_explained_variance.npy`` (the files the JAX package reads and
    writes)."""
    for name in ("mean", "components", "explained_variance"):
        np.save(f"{path_prefix}_{name}.npy",
                getattr(pca, name).detach().cpu().numpy())


def load_pca(path_prefix: str, device="cpu") -> PCA:
    return PCA(*(torch.from_numpy(np.load(f"{path_prefix}_{name}.npy")).to(
        device) for name in ("mean", "components", "explained_variance")))
