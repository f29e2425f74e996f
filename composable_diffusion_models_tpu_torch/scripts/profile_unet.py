"""Per-op profile of the UNet's composed DDIM step: ``scripts/
profile_unet.py`` on the port. Times each UNet component standalone at the
step's shapes and prints a markdown table (op, ms, dev ms, TF/s, % of the
composed eps step).

    python -m composable_diffusion_models_tpu_torch.scripts.profile_unet \\
        --bs 384 --reps 100

Every component runs as the served UNet runs it, in bf16 with GroupNorm +
SiLU through the ``groupnorm_silu`` kernel (its plain version under
``--cpu``). The parameter trees are one ``convert.init_params`` UNet tree
per expert; the convolutions, the GroupNorm and the residual blocks take
their weights from the matching level of the first one.

Measurement (:func:`timed_scan`): the exact call is warmed once, then
``--reps`` calls are timed between two CUDA events, each call's output fed
into the next call's input through a carry, so that no call can be
skipped. The script's number was one fused TPU program; here every call is
a run of eager launches, so on the card each row also prints ``dev ms``:
the device time of every kernel inside one call, from a ``torch.profiler``
trace (:func:`device_ms`). Where ``ms`` is well above ``dev ms`` the host's
launch rate sets the pace. TF/s is the row's FLOPs over its dev ms, the
device's rate; rows above the H100's dense bf16 peak (989 TF/s) are
flagged IMPLAUSIBLE. Under ``--cpu`` and under ``--profile`` (whose trace
holds the device records) the dev ms and TF/s columns print ``-``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from composable_diffusion_models_tpu_torch import (compose, convert, entry,
                                                   experts, rng, samplers)
from composable_diffusion_models_tpu_torch.frontier import (
    H100_BF16_PEAK_TFLOPS)
from composable_diffusion_models_tpu_torch.models import UNet
from composable_diffusion_models_tpu_torch.models.unet import (
    _conv, _upsample2x, gn_silu, res_block)
from composable_diffusion_models_tpu_torch.schedules import VPSchedule
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)

# traces of device_ms that may come back without a whole set of device
# records before the row is printed without them
TRACE_ATTEMPTS = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_scan(fn, args, reps, dtype=torch.bfloat16):
    """Seconds per call of ``fn(*args)``: the exact call warmed once, then
    ``reps`` calls timed between two CUDA events (the host clock on the
    CPU). A carry perturbs the first input of every call by 1e-30 times the
    previous output's sum, so each call depends on the one before it."""
    x, rest = args[0], tuple(args[1:])

    def body(carry):
        out = fn(x + carry, *rest)
        return carry + out.sum().to(dtype) * 1e-30

    carry = body(torch.zeros((), dtype=dtype, device=x.device))
    _sync(x.device)
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            carry = body(carry)
        float(carry)
        return (time.perf_counter() - t0) / reps
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    start_ev.record()
    for _ in range(reps):
        carry = body(carry)
    end_ev.record()
    end_ev.synchronize()
    return start_ev.elapsed_time(end_ev) / 1e3 / reps


def device_ms(fn, args, calls: int = 5) -> Optional[float]:
    """Device time in ms of every kernel inside one call of ``fn(*args)``:
    ``calls`` calls traced by ``torch.profiler``, their device records
    summed and divided by ``calls``. A trace can come back with records
    missing; one whose record count is no multiple of ``calls`` is taken
    again. None for CPU tensors (no device), and where
    :data:`TRACE_ATTEMPTS` traces in a row keep no whole set of records."""
    if args[0].device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    for _ in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        us = [e.device_time for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if us and len(us) % calls == 0:
            return sum(us) / 1e3 / calls
    return None


def conv_flops(b, h, w, cin, cout, k=3):
    return 2 * b * h * w * k * k * cin * cout


def tflops(flops, dev: Optional[float]) -> str:
    """The TF/s column: FLOPs over device ms, flagged above the peak."""
    if not flops or dev is None:
        return "-"
    tf = flops / (dev / 1e3) / 1e12
    flag = " IMPLAUSIBLE(>peak)" if tf > H100_BF16_PEAK_TFLOPS else ""
    return f"{tf:.1f}{flag}"


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Per-op profile of the UNet's "
                                             "composed DDIM step.")
    ap.add_argument("--bs", type=int, default=384)
    ap.add_argument("--base_dim", type=int, default=64)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--img", type=int, default=28)
    ap.add_argument("--in_ch", type=int, default=1,
                    help="3 + --img 64 profiles the shapes-64 secondary "
                         "bench workload (VERDICT r2 #4)")
    ap.add_argument("--experts", type=int, default=3)
    add_runtime_flags(ap)
    return ap


def unet_trees(model: UNet, n: int, device) -> list:
    """``n`` random UNet trees (``convert.init_params``, seeds 0..n-1) in
    bf16 on ``device``, convolutions in ``F.conv2d``'s layout."""
    trees = [convert.from_flax(convert.init_params(model, seed=i))
             for i in range(n)]
    return entry.load_unets(trees, device, torch.bfloat16)


def main(argv=None) -> int:
    args, _ = build_parser().parse_known_args(argv)
    device = torch.device(start(args) or "cuda")
    with profiled(args), torch.inference_mode():
        run(args, device)
    return 0


def run(args, device: torch.device) -> None:
    bs, bd, img = args.bs, args.base_dim, args.img
    cin0, n_exp = args.in_ch, args.experts
    dt = torch.bfloat16
    draws = rng.Draws(0, device)
    rows = []  # (name, sec, dev ms, flops)

    def row(name, fn, x, flops=None):
        sec = timed_scan(fn, (x,), args.reps)
        dev = None if args.profile else device_ms(fn, (x,))
        rows.append((name, sec, dev, flops))
        return sec

    model = UNet(in_channels=cin0, base_dim=bd, channel_mults=(1, 2, 4),
                 dtype=dt, fused_gn=True)
    params3 = unet_trees(model, n_exp, device)
    params = params3[0]
    p = params["params"]

    # ---- full eps forward (1 expert) + full n-expert blend ---------------
    x = draws.normal((bs, img, img, cin0), dt)
    t = torch.full((1,), 0.5, dtype=dt, device=device)
    row("UNet forward (1 expert)",
        lambda xx: model.apply(params, xx, t), x)
    stack = experts.ExpertStack(model.apply, params3)
    w3 = torch.ones((n_exp,), dtype=torch.float32, device=device)
    sec_3x = row(f"{n_exp}-expert blended eps",
                 lambda xx: compose.weighted(stack(xx, t).float(), w3)
                 .to(dt), x)

    # ---- components at the step's shapes, weights from the tree ----------
    h1 = (img, img, bd)          # level 0

    def rand(shape):
        return draws.normal((bs,) + tuple(shape), dt)

    def conv(q):
        return lambda xx: _conv(xx, q["weight"], q["bias"], dt)

    row(f"init conv {cin0}->{bd} @{img}", conv(p["init_conv"]),
        rand((img, img, cin0)), conv_flops(bs, img, img, cin0, bd))
    for (name, hh, cin, cout, q) in [
        (f"conv {bd}->{bd} @{img}", img, bd, bd, p["down_0"]["Conv_1"]),
        (f"conv {bd}->{2*bd} @{img//2}", img // 2, bd, 2 * bd,
         p["down_1"]["Conv_0"]),
        (f"conv {2*bd}->{4*bd} @{img//4}", img // 4, 2 * bd, 4 * bd,
         p["bottleneck"]["Conv_0"]),
        (f"conv {4*bd}->{4*bd} @{img//4}", img // 4, 4 * bd, 4 * bd,
         p["bottleneck"]["Conv_1"]),
    ]:
        row(name, conv(q), rand((hh, hh, cin)),
            conv_flops(bs, hh, hh, cin, cout))

    # GN+SiLU (the groupnorm_silu kernel) at the widest shape
    gp = p["down_0"]["gn2"]

    def gn(xx):
        return gn_silu(gp, xx, dt, fused_gn=True)

    row(f"GN+SiLU {bd} @{img}", gn, rand(h1))

    # ceiling probes: the dominant conv bare, and with the GroupNorm pass
    # between two of them
    cbare = conv(p["down_0"]["Conv_1"])
    row(f"conv2x bare {bd}->{bd} @{img}", lambda xx: cbare(cbare(xx)),
        rand((img, img, bd)), 2 * conv_flops(bs, img, img, bd, bd))
    row(f"conv2x + GN between @{img}", lambda xx: cbare(gn(cbare(xx))),
        rand((img, img, bd)), 2 * conv_flops(bs, img, img, bd, bd))

    # residual blocks of the down path, their trees the tree's own levels
    t_emb = draws.normal((1, model.time_emb_dim), dt)
    for (name, hh, cin, cout, level) in [
        (f"ResBlock {bd}->{bd} @{img}", img, bd, bd, "down_0"),
        (f"ResBlock {bd}->{2*bd} @{img//2}", img // 2, bd, 2 * bd, "down_1"),
        (f"ResBlock {2*bd}->{4*bd} @{img//4}", img // 4, 2 * bd, 4 * bd,
         "bottleneck"),
    ]:
        row(name, lambda xx, q=p[level]: res_block(q, xx, t_emb, dt, True),
            rand((hh, hh, cin)),
            conv_flops(bs, hh, hh, cin, cout)
            + conv_flops(bs, hh, hh, cout, cout))

    # upsample matmuls
    row(f"upsample {img//4}->{img//2} @{4*bd}", _upsample2x,
        rand((img // 4, img // 4, 4 * bd)))
    row(f"upsample {img//2}->{img} @{2*bd}", _upsample2x,
        rand((img // 2, img // 2, 2 * bd)))

    # full 50-step DDIM sample / image throughput cross-check
    schedule = VPSchedule()

    def eps_fn(xx, tt):
        eps = stack(xx.to(dt), tt.to(dt))
        return compose.weighted(eps.float(), w3)

    def sample(key):
        xi = rng.Draws(key, device).normal((bs, img, img, cin0))
        return samplers.ddim(eps_fn, schedule, xi, 50)

    float(sample(0).reshape(-1)[0])
    t0 = time.perf_counter()
    acc = torch.zeros((), device=device)
    for i in range(3):
        out = finite(args, "samples", sample(rng.fold_in(0, i)))
        acc = acc + out.reshape(-1)[0]
    float(acc)
    sec_sample = (time.perf_counter() - t0) / 3
    rows.append(("full 50-step DDIM batch", sec_sample, None, None))

    # ---- table -----------------------------------------------------------
    step_sec = sec_3x  # one composed eps evaluation = the DDIM step's compute
    print(f"\nbs={bs} base_dim={bd} img={img} in_ch={cin0} "
          f"experts={n_exp} reps={args.reps} device={device_name(device)}")
    print(f"\n| op | ms | dev ms | TF/s | % of {n_exp}-expert eps step |")
    print("|---|---|---|---|---|")
    for name, sec, dev, fl in rows:
        dev_s = "-" if dev is None else f"{dev:.3f}"
        pct = f"{100 * sec / step_sec:.0f}%" if sec <= step_sec * 1.5 else "-"
        print(f"| {name} | {sec * 1e3:.2f} | {dev_s} | {tflops(fl, dev)} "
              f"| {pct} |")
    ips = bs / sec_sample
    print(f"\nfull-sample throughput: {ips:.1f} img/s "
          f"({50 * sec_3x * 1e3:.0f} ms implied eps work vs "
          f"{sec_sample * 1e3:.0f} ms measured batch)")


if __name__ == "__main__":
    sys.exit(main())
