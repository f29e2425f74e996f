"""Metrics: a JSONL scalar writer, a wall-clock timer and a timing harness
that waits for the device.

Port of ``composable_diffusion_models_tpu.utils.metrics``. Where the JAX
``time_fn`` calls ``jax.block_until_ready`` on the outputs, this one
synchronises the device of every CUDA tensor among them
(``torch.cuda.synchronize``); CPU tensors need no wait.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import torch


class MetricWriter:
    """Append-only JSONL scalars: {"step": n, "name": ..., "value": ...}."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def write(self, step: int, **scalars: float) -> None:
        with open(self.path, "a") as f:
            for name, value in scalars.items():
                f.write(json.dumps({"step": step, "name": name,
                                    "value": float(value)}) + "\n")


class Timer:
    """Wall-clock time of the enclosed block (``elapsed``, seconds); the
    block itself must wait for the device where that matters."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def block_until_ready(out: Any) -> Any:
    """Waits for the devices of the CUDA tensors in ``out`` (a tensor or a
    list, tuple or dict of them, nested); returns ``out``."""
    devices = set()

    def walk(node):
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(out)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


def time_fn(fn, *args, warmup: int = 2, iters: int = 10,
            **kwargs) -> Dict[str, float]:
    """Run fn with warmup (first-call set-up) excluded; returns
    seconds/iter stats."""
    for _ in range(warmup):
        block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"mean_s": sum(times) / len(times), "min_s": times[0],
            "median_s": times[len(times) // 2], "max_s": times[-1]}
