"""The benchmark of the PyTorch + CUDA port: one cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: the program
its configuration (``configs/``) names (``programs/``; today composed-DiT
sampling through ``composable_diffusion_models_tpu_torch.entry.sample``)
under a traffic mix (``traffic/``). Set-up makes the experts' weights on
the card from the seed and makes one warm call at the cell's shapes. The window then issues
calls back to back from one caller (a closed loop), each on fresh noise
drawn from the seed, until ``--seconds`` have passed. The calls are sent
ahead of the card as far as its launch queue lets the host run, and never
more than ``AHEAD_S`` seconds of calls, so that a host that stands still
for a moment does not leave the card idle at once; once the time is up
nothing more is sent, and the window ends when all that was sent has
finished. With ``--trace 1`` the window is followed by a few whole calls
traced on the device (``devtrace``), which the per-layer readers
(``metrics/``) read, and one more traced with the host's ops, which names
the idle gaps of the breakdown.
Once the window has closed, the plain reference (``reference/``) samples
the images the check drew and ``correct`` compares them
(``correct.py``).

The last line of standard output is one JSON object; the numbers compared
are printed beside their limits as the last lines of standard error and
under the result's last key, ``check``. Exits 2 without a result when the
card or the cell's chips are missing, 3 when JAX or the JAX package is
loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
for _p in (str(HERE), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import correct  # noqa: E402
import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "composable_diffusion_models_tpu")
AHEAD_S = 4.0      # the most seconds of calls sent ahead of the card
NAME_CHARS = 120   # of a device op's name in the breakdown


@dataclasses.dataclass
class Run:
    """What a run leaves for the metric readers."""
    cell: spec.Cell
    setup_s: float
    calls: int          # unprofiled calls of the window
    images: int
    seconds: float      # the window's start to the end of the last call sent
    trace: Optional[object] = None   # devtrace.Trace of the traced calls


def forbidden_modules() -> list:
    """Top-level names of JAX or the JAX package among the loaded
    modules, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(cell, seed: int, seconds: float, trace: bool,
            device="cuda") -> dict:
    """One run of ``cell``: set-up, the window, the trace, the check.
    Returns the result's fields; ``device`` "cpu" runs it on the CPU (the
    kernels' plain versions; tests only)."""
    import torch
    torch.set_num_threads(1)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    call, experts, launches = cell.program.load(cell, seed, device)
    batch = cell.traffic["batch"]
    warm = time.perf_counter()
    call(correct.draw_x(cell, seed, -1, device))   # warm: the cell's shapes
    sync()
    ahead = max(1, int(AHEAD_S / (time.perf_counter() - warm)))

    kept, counter = [], itertools.count()

    def next_call():
        i = next(counter)
        return i, call(correct.draw_x(cell, seed, i, device))

    def keep(i, out):
        rows = torch.as_tensor(correct.check_rows(cell, seed, i))
        if on_card:     # a copy that does not wait for the card
            rows = rows.pin_memory().to(device, non_blocking=True)
        kept.append((i, out.index_select(0, rows)))

    start = time.perf_counter()
    setup_s = start - T0
    sent = collections.deque()   # the end of each call still running
    while True:
        keep(*next_call())
        if on_card:
            sent.append(torch.cuda.Event())
            sent[-1].record()
            if len(sent) > ahead:
                sent.popleft().synchronize()
        if time.perf_counter() - start >= seconds:
            break
    sync()
    window_s = time.perf_counter() - start
    run = Run(cell, setup_s, len(kept), len(kept) * batch, window_s)

    if trace:
        import devtrace
        traced = []

        def traced_call():
            i, out = next_call()
            traced.append(i)
            return out
        run.trace, outs = devtrace.capture(
            traced_call, cell.traffic["trace_calls"], launches)
        with_host, more = devtrace.capture(traced_call, 1, launches,
                                           host_ops=True)
        run.trace.gaps = with_host.gaps
        for i, out in zip(traced, outs + more):
            keep(i, out)
        del outs, more
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    attempted = len(kept) * batch
    got, xs = correct.gather(cell, seed, kept, device)
    del kept
    if on_card:
        torch.cuda.empty_cache()
    values = correct.numbers(got, correct.reference_images(cell, experts, xs))
    ok, shown = correct.judge(cell, values)

    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                run)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": attempted,
              "failed": int(values["nonfinite"]), "metrics": metrics,
              "device": dev}
    if run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {
            "device_ops": [[k[:NAME_CHARS], v]
                           for k, v in run.trace.by_name()[:10]],
            "idle_gaps": [[k, v] for k, v in run.trace.gaps[:10]]}
    result["check"] = shown
    return result


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for name, s in result["check"].items():
        print(f"check {name}: {s['value']!r} limit {s['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
