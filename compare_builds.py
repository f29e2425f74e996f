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
and contiguous, both dtypes) and its ``blend_eps`` (``K3_SHAPES``, both
dtypes) the same seeded inputs as every other run, and saves a SHA-256 of
each output's bytes, three device times a call (``chip_smoke.device_ms``;
K3 at ``K3_TIMED`` and, in float32, ``K3_SWEEP``; the keys left without a
time are printed) and K1's and K3's route at each shape to
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
# blend_eps: every stack of chip_smoke.py's phase 3 (timed: its timed ones
# and the ragged (3, 7, 5)), those of the card tests past it (both sides of
# the switch to single elements, a partly empty last block, each K past a
# resident wave of blocks and past the L2, an odd plane), and (2, n) at n
# over powers of two (timed in float32)
K3_TIMED = cs.BLEND_TIMED + [(3, 7, 5)]
K3_SWEEP = [(2, 2 ** p) for p in range(10, 25)]
K3_SHAPES = list(dict.fromkeys(
    cs.BLEND_SHAPES + [(2, 4096), (2, 4097), (2, 1572864), (2, 1572872)]
    + [(k, n) for k in range(1, 6) for n in (3000, 1351680, 2 ** 23 + 8)]
    + [(3, 8 * 1001)] + K3_SWEEP))


_TRACES = {"ok": True}


def device_ms(fn) -> float:
    """``chip_smoke.device_ms``, or NaN where the trace keeps no device
    records (the first traces of a process now and then come back empty):
    the bits are compared all the same. Once ten traces in a row have come
    back empty, the process takes no more (NaN for the rest), so that a run
    whose profiler is broken ends in seconds; ``run`` and ``compare`` print
    the keys left without a time: run it again."""
    if not _TRACES["ok"]:
        return float("nan")
    try:
        return cs.device_ms(fn)
    except SystemExit:
        _TRACES["ok"] = False
        return float("nan")


def run(tag: str) -> None:
    sys.path.insert(0, os.getcwd())
    from composable_diffusion_models_tpu_torch.ops import (_build, attention,
                                                           kernels)
    print(tag, os.path.dirname(kernels.__file__), flush=True)
    # every library before the first trace: a process that builds one after
    # it has traced keeps no device records in its later traces
    _build.build(names=("fused_dit_block", "short_seq_attention",
                        "flash_attention", "blend_eps"))
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
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in K3_SHAPES:
            eps = torch.randn(*shape, generator=gen).to("cuda", dtype)
            w = (torch.rand(shape[0], generator=gen) + 0.5).cuda()
            key = f"blend_eps {str(dtype)[6:]} {shape}"
            outs[key] = kernels.blend_eps(eps, w)
            if hasattr(kernels, "blend_route"):
                routes[key] = tuple(kernels.blend_route(eps[0].numel(),
                                                        dtype))
            if shape in K3_TIMED or (shape in K3_SWEEP
                                     and dtype == torch.float32):
                times[key] = [device_ms(lambda: kernels.blend_eps(eps, w))
                              for _ in range(3)]
    blank = [key for key, ts in times.items() if any(t != t for t in ts)]
    if blank:
        print(f"{tag}: no device time (traces without device records) at "
              f"{len(blank)} of {len(times)} keys: {blank}", flush=True)
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
    for x in tags:
        blank = [key for key, ts in runs[x]["times"].items()
                 if any(t != t for t in ts)]
        if blank:
            print(f"{x}: NaN device times at {blank}")
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
