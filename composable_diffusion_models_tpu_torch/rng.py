"""Keys and draws: the port's counterpart of ``jax.random``'s key discipline.

A key is an int in [0, 2^63). :func:`fold_in` derives a new key from a key
and an int, as ``jax.random.fold_in`` does (a splitmix64 mix here), so a
loop that derives each step's key from (key, chunk, step) draws the same
numbers whether it runs straight through or resumes from a checkpoint.

Every randomized function of the port draws through a :class:`Draws`, a
key on a device with ``fold_in`` and ``split`` as in JAX: the n-th draw of
``Draws(key, device)`` comes from a ``torch.Generator`` on the device seeded
with ``fold_in(key, n)``, one generator per draw, as each JAX draw takes a
key of its own. :class:`Replay` hands out recorded tensors in
their place, through the same calls: the two frameworks give different
numbers from one seed, so a test replays the JAX package's draws.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np
import torch

_MASK = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and the int ``data`` (splitmix64's finalizer
    over key * golden ratio + data)."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) >> 1


class Draws:
    """A key on a device, used as a JAX key is: for one purpose, either
    derived from (:meth:`fold_in`, :meth:`split`) or drawn from
    (``uniform``, ``randint``, ``normal``, each draw from a generator of its
    own)."""

    def __init__(self, key: int, device="cpu"):
        self.key, self.device, self.n = int(key), torch.device(device), 0

    def fold_in(self, data: int) -> "Draws":
        return Draws(fold_in(self.key, data), self.device)

    def split(self, num: int) -> list:
        return [self.fold_in(i) for i in range(num)]

    def generator(self) -> torch.Generator:
        """The next draw's generator, seeded with fold_in(key, n)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_in(self.key, self.n))
        self.n += 1
        return gen

    def uniform(self, shape: Sequence[int], low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        """float32 U[low, high)."""
        u = torch.rand(tuple(shape), generator=self.generator(),
                       device=self.device)
        return u * (high - low) + low

    def randint(self, shape: Sequence[int], high: int) -> torch.Tensor:
        """int64 U{0, ..., high - 1}."""
        return torch.randint(high, tuple(shape), generator=self.generator(),
                             device=self.device)

    def normal(self, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """N(0, 1) in ``dtype``."""
        return torch.randn(tuple(shape), generator=self.generator(),
                           device=self.device, dtype=dtype)

    def permutation(self, n: int) -> torch.Tensor:
        """A random int64 permutation of range(n)."""
        return torch.randperm(n, generator=self.generator(),
                              device=self.device)


def as_draws(key: Union[int, "Draws"], device="cpu") -> "Draws":
    """``key`` itself when it is a :class:`Draws` (a :class:`Replay`
    among them), else ``Draws(key, device)``."""
    return key if isinstance(key, Draws) else Draws(key, device)


class Replay(Draws):
    """Recorded draws, handed out in order in place of fresh ones. Each
    call checks the shape of the tensor it hands out; integer draws come
    out as int64 and the rest in the dtype asked for, on ``device``."""

    def __init__(self, tensors: Iterable, device="cpu"):
        self.queue = [torch.as_tensor(np.array(t)) for t in tensors]
        self.device = torch.device(device)

    def fold_in(self, data: int) -> "Replay":
        return self  # the recording is already in the order of the draws

    def split(self, num: int) -> list:
        return [self] * num

    def _take(self, shape, dtype) -> torch.Tensor:
        if not self.queue:
            raise ValueError("no recorded draw left to replay")
        t = self.queue.pop(0)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed draw has shape {tuple(t.shape)}, "
                             f"the code draws {tuple(shape)}")
        return t.to(device=self.device, dtype=dtype)

    def uniform(self, shape, low=0.0, high=1.0) -> torch.Tensor:
        return self._take(shape, torch.float32)

    def randint(self, shape, high) -> torch.Tensor:
        return self._take(shape, torch.int64)

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        return self._take(shape, dtype)

    def permutation(self, n) -> torch.Tensor:
        return self._take((n,), torch.int64)
