"""Whether the sampler calls of a run produced the right images.

Every image of a composed-DiT call is an answer of its own: its trajectory
depends on its own noise and on nothing else in the batch. Each call of the
window hands the check ``rows_per_call`` of its images, at indices drawn
from the seed; after the window the plain reference (``reference/``,
through the cell's program) samples the same noise with the same weights
in float32, and the check compares:

* ``rel_err``: |x - x_ref| / |x_ref| over all the checked images together
  (Frobenius norms);
* ``worst_image``: the largest |x_i - x_ref_i| / |x_ref_i| of one image;
* ``nonfinite``: images with a value that is not finite (limit 0).

Each limit sits in ``limits/<workload>.json`` with the readings it was set
from. The reference runs on the card with TF32 off, in blocks of rows.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one use of the run's ``seed``."""
    h = hashlib.blake2b(repr((seed,) + keys).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def draw_x(cell, seed: int, call: int, device) -> torch.Tensor:
    """The float32 noise call ``call`` of the run starts from."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "x", call))
    return torch.randn((cell.traffic["batch"],) + tuple(
        cell.program.image_shape(cell)), generator=gen, device=device,
        dtype=torch.float32)


def check_rows(cell, seed: int, call: int) -> np.ndarray:
    """The sorted indices of the images call ``call`` hands the check."""
    rng = np.random.default_rng(sub_seed(seed, "rows", call))
    return np.sort(rng.choice(cell.traffic["batch"],
                              cell.traffic["rows_per_call"], replace=False))


def reference_images(cell, experts, x: torch.Tensor,
                     fp8: bool = False) -> torch.Tensor:
    """The reference's samples from noise ``x``, in blocks of
    ``ref_block`` images (the control with ``fp8``)."""
    block = cell.traffic["ref_block"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.cat([
            cell.program.reference(cell, experts, x[i:i + block], fp8=fp8)
            for i in range(0, x.shape[0], block)])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def numbers(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """The compared numbers of images ``got`` against ``ref``."""
    got, ref = got.double().flatten(1), ref.double().flatten(1)
    bad = ~torch.isfinite(got).all(dim=1)
    diff = torch.nan_to_num(got - ref, nan=float("inf"))
    per_image = diff.norm(dim=1) / ref.norm(dim=1)
    return {"rel_err": float(diff.norm() / ref.norm()),
            "worst_image": float(per_image.max()),
            "nonfinite": float(bad.sum())}


def judge(cell, values: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": v, "limit": cell.limits[k]["limit"]}
             for k, v in values.items()}
    return all(s["value"] <= s["limit"] for s in shown.values()), shown


def gather(cell, seed: int, kept: List[Tuple[int, torch.Tensor]],
           device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the program's checked images, the noise they came from), from the
    (call, images) pairs the window kept, capped at ``check_images`` drawn
    from the seed."""
    got, xs = [], []
    for call, images in kept:
        rows = torch.as_tensor(check_rows(cell, seed, call), device=device)
        got.append(images)
        xs.append(draw_x(cell, seed, call, device).index_select(0, rows))
    got, xs = torch.cat(got), torch.cat(xs)
    cap = cell.traffic["check_images"]
    if got.shape[0] > cap:
        pick = np.sort(np.random.default_rng(sub_seed(seed, "cap")).choice(
            got.shape[0], cap, replace=False))
        pick = torch.as_tensor(pick, device=device)
        got, xs = got.index_select(0, pick), xs.index_select(0, pick)
    return got, xs
