"""Walk the quality / FLOP frontier of the flagship: the counterpart of
``scripts/frontier_sweep.py``.

One flagship gate (``entry.quality_gate_flagship``) per (candidate,
training budget), against a baseline report, with escalating budgets:
every candidate gates at the first budget, and only a candidate that did
not PASS goes on to the next (a FAIL at one budget says nothing of a
larger one). A cell whose report already carries a verdict is read, not
run again, so a sweep that stopped resumes where it stood. The table gives
each candidate's GFLOP per composed image (3 experts, 50 DDIM steps) beside
its verdict and, with a serving MFU measured on the card, the images/s that
GFLOP would allow at the H100's dense bf16 peak.

The script runs each cell in a subprocess under a timeout, to survive a
stalled connection to a remote TPU. Here every cell runs in this process on
the local card: an error ends the sweep, and a relaunch resumes from the
reports written so far.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

from . import entry, gate, resolve_device
from .models.unet import UNet

# the script's candidates, cheapest first: the first PASS at the lowest
# GFLOP decides the headline
DEFAULT_CANDIDATES = (
    "dit_p14_d256_l6",    # 4 tokens: each patch a 14 x 14 quadrant
    "dit_p14_d256_l8",
    "dit_p14_d384_l6",    # heads of 48
    "dit_p7_d192_l6_h6",  # 16 tokens, heads of 32
    "dit_p7_d256_l4",
    "dit_p7_d256_l5",
)
DEFAULT_BASELINE = str(gate.ROOT / "artifacts" / "quality_gate_r4" /
                       "quality_unet64.json")
# NVIDIA H100 SXM, dense bf16 on the tensor cores (data sheet)
H100_BF16_PEAK_TFLOPS = 989.0


def cand_gflop(name: str, n_experts: int = entry.N_EXPERTS,
               n_steps: int = 50) -> float:
    """Analytic GFLOP per composed image of a gate configuration: one
    forward (``entry.dit_gflop_per_image`` or ``entry.unet_gflop_per_image``
    at 28 x 28) per expert per DDIM step."""
    model, _ = gate.build_model(name)
    one = (entry.unet_gflop_per_image(model, 28, 28)
           if isinstance(model, UNet) else entry.dit_gflop_per_image(model))
    return one * n_experts * n_steps


def gate_json(out_dir: str, cand: str, steps: int) -> str:
    """The report a gate of ``cand`` at ``steps`` training steps writes."""
    suffix = "" if steps == 12000 else f"_s{steps}"
    return os.path.join(out_dir, f"quality_{cand}{suffix}.json")


def read_verdict(path: str) -> Optional[str]:
    """The verdict of the report at ``path``; None where there is none."""
    try:
        with open(path) as f:
            return json.load(f).get("verdict")
    except (OSError, ValueError):
        return None


def frontier_sweep(candidates: Sequence[str] = DEFAULT_CANDIDATES,
                   budgets: Sequence[int] = (24000, 48000, 96000),
                   baseline: str = DEFAULT_BASELINE,
                   out: str = "outputs/quality_gate_r5",
                   mfu: Optional[float] = None, device=None,
                   **gate_kw) -> dict:
    """Gates ``candidates`` at escalating training ``budgets`` against the
    ``baseline`` report (a path) and writes ``frontier_table.json`` under
    ``out`` beside the gates' reports and grids. Returns the table:
    ``mfu_assumed``, ``peak_tflops`` and one row per candidate (``config``,
    ``gflop_per_image``, ``best_budget``, ``verdict``: PASS, FAIL or UNRUN,
    ``projected_images_per_sec``).

    ``mfu``: the serving model-FLOP utilisation measured on the card, which
    turns a candidate's GFLOP into projected images/s at
    ``H100_BF16_PEAK_TFLOPS``; None leaves that column null (the script's
    0.36 is a TPU's). ``gate_kw`` go to every
    ``entry.quality_gate_flagship`` call (e.g. ``probe_steps``,
    ``n_samples``). ``device=None`` is the CUDA card (raises without
    one)."""
    dev = resolve_device(device)
    cands = list(candidates)
    os.makedirs(out, exist_ok=True)
    alive, results = list(cands), {}
    for steps in budgets:
        nxt = []
        for cand in alive:
            path = gate_json(out, cand, steps)
            verdict = read_verdict(path)
            if verdict is None:
                entry.quality_gate_flagship(
                    configs=(cand,), train_steps=steps, baseline=baseline,
                    out=out, device=dev, **gate_kw)
                verdict = read_verdict(path)
            results[cand] = (steps, verdict or "UNRUN")
            if verdict != "PASS":
                nxt.append(cand)
        alive = nxt
        if not alive:
            break
    rows = []
    for cand in cands:
        g = cand_gflop(cand)
        steps, verdict = results.get(cand, (None, "UNRUN"))
        proj = (None if mfu is None
                else round(H100_BF16_PEAK_TFLOPS * 1e3 * mfu / g))
        rows.append({"config": cand, "gflop_per_image": round(g, 2),
                     "best_budget": steps, "verdict": verdict,
                     "projected_images_per_sec": proj})
    table = {"mfu_assumed": mfu, "peak_tflops": H100_BF16_PEAK_TFLOPS,
             "rows": rows}
    with open(os.path.join(out, "frontier_table.json"), "w") as f:
        json.dump(table, f, indent=2)
    return table
