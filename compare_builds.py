#!/usr/bin/env python3
"""Holds two checkouts' kernels to each other on one CUDA card.

    python3 compare_builds.py run TAG      # from the directory that holds a
                                           # checkout's package
    python3 compare_builds.py compare TAG_A TAG_B [TAG ...]

``run`` builds the package found in the working directory, feeds its
``fused_dit_block`` (the DiT serving shape, both dtypes; in bf16 also its
64-token shape, the frontier's (256, 4, 384) H 8 and (33, 16, 384) H 6 of
the bf16 stream past D = 256 and the ``cluster`` route's four shapes; in
float32 the ``rows`` route at (256, 4, 384) H 8), its
``short_seq_attention`` (the serving, frontier and profile_dit shapes,
both dtypes) and its ``flash_attention`` (path B's three sites, strided
and contiguous, both dtypes) the same seeded inputs as every other run,
and saves a SHA-256 of each output's bytes, three device times a call
(``chip_smoke.device_ms``) and K1's route at each shape to
``builds_TAG.pt`` in the git-ignored build directory of the package
beside this script. ``compare`` prints, for each output, whether TAG_A
and TAG_B give the same bits (and whether runs sharing TAG_A's or TAG_B's
prefix agree among themselves), then the median device time of every run
beside each run's route, in the order given: run parent, change, change,
parent, one process each, and compare them in that order.
"""

from __future__ import annotations

import hashlib
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402

OUT = os.path.join(HERE, "composable_diffusion_models_tpu_torch", "build")
FA_SITES = [cs.FA_MAIN, (3 * cs.B_BATCH, 4, 196, 2, 32),
            (3 * cs.B_BATCH, 4, 49, 2, 64)]
# (B, T, D, heads): fused_dit_block in bf16 past the serving shape (with
# a frontier-width batch that leaves a tile partly empty), in float32 past
# D = 256, and short_seq_attention's shapes
K1_BF16 = [cs.SG_K1, cs.K1_FRONTIER[0], (33, 16, 384, 6), *cs.K1_CLUSTER]
K1_F32 = [cs.K1_FRONTIER[0]]
K2_SHAPES = [cs.MAIN, cs.K2_FRONTIER, cs.K_PROFILE]


def device_ms(fn) -> float:
    """``chip_smoke.device_ms``, or NaN where the trace keeps no device
    records (the first traces of a process now and then come back empty):
    the bits are compared all the same."""
    try:
        return cs.device_ms(fn)
    except SystemExit:
        return float("nan")


def run(tag: str) -> None:
    sys.path.insert(0, os.getcwd())
    from composable_diffusion_models_tpu_torch.ops import attention, kernels
    print(tag, os.path.dirname(kernels.__file__), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    outs, times, routes = {}, {}, {}
    gen = torch.Generator().manual_seed(0)
    b, t, d, h = cs.MAIN
    for dtype in (torch.bfloat16, torch.float32):
        args = cs.block_inputs(b, t, d, dtype, gen)
        key = f"fused_dit_block {str(dtype)[6:]}"
        outs[key] = kernels.fused_dit_block(*args, h)
        times[key] = [device_ms(lambda: kernels.fused_dit_block(*args, h))
                      for _ in range(3)]
    for dtype, shapes in ((torch.bfloat16, K1_BF16), (torch.float32, K1_F32)):
        for b, t, d, h in shapes:
            args = cs.block_inputs(b, t, d, dtype, gen)
            key = f"fused_dit_block {str(dtype)[6:]} {(b, t, d, h)}"
            routes[key] = kernels.block_route(dtype, t, d)
            outs[key] = kernels.fused_dit_block(*args, h)
            times[key] = [device_ms(lambda: kernels.fused_dit_block(
                *args, h)) for _ in range(3)]
    gen = torch.Generator().manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, d, h in K2_SHAPES:
            qkv = torch.randn(b, t, 3 * d, generator=gen).to("cuda", dtype)
            key = f"short_seq_attention {str(dtype)[6:]} {(b, t, 3 * d, h)}"
            outs[key] = kernels.short_seq_attention(qkv, h)
            times[key] = [device_ms(
                lambda: kernels.short_seq_attention(qkv, h))
                for _ in range(3)]
    gen = torch.Generator().manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, nq, nk, d in FA_SITES:
            q, k, v = (torch.randn(b, n, h, d, generator=gen).to("cuda", dtype)
                       .transpose(1, 2) for n in (nq, nk, nk))
            key = f"flash_attention {str(dtype)[6:]} Nq={nq} D={d}"
            outs[key] = attention.flash_attention(q, k, v)
            outs[key + " contiguous"] = attention.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous())
            times[key] = [device_ms(
                lambda: attention.flash_attention(q, k, v)) for _ in range(3)]
    digests = {key: hashlib.sha256(
        o.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()
        for key, o in outs.items()}
    os.makedirs(OUT, exist_ok=True)
    torch.save({"digests": digests, "times": times, "routes": routes},
               os.path.join(OUT, f"builds_{tag}.pt"))


def compare(tags: list) -> None:
    runs = {tag: torch.load(os.path.join(OUT, f"builds_{tag}.pt"))
            for tag in tags}
    a, b = runs[tags[0]]["digests"], runs[tags[1]]["digests"]
    for key in a:
        same = [runs[x]["digests"][key] for x in tags]
        print(f"{key}: {tags[0]} and {tags[1]} the same bits "
              f"{a[key] == b[key]} (every run: {len(set(same))} distinct "
              f"outputs)")
    for key in runs[tags[0]]["times"]:
        print(f"{key} device ms: " + " / ".join(
            f"{x} {sorted(runs[x]['times'][key])[1]:.5f}"
            + (f" ({runs[x]['routes'][key]})" if key in runs[x]["routes"]
               else "") for x in tags))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("compare_builds: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1] == "run":
        run(sys.argv[2])
    else:
        compare(sys.argv[2:])
