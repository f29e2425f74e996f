"""The compositional-generalisation results table: the port of
``scripts/summarize_evals.py``.

Reads the reports that ``eval_composition`` writes
(``compositional_eval_<dataset>_<ops>.json``, the older untagged
``compositional_eval.json`` and the holdout sweeps'
``compositional_sweep_<dataset>_<ops>.json``) and renders one GitHub
markdown table sorted by held-out joint accuracy. Host only: it reads JSON
files and touches no device.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator, Optional, Sequence


def rows_from(path: str) -> Iterator[dict]:
    """The table rows of one report: one per operator setting of ``ops``
    and, for a sweep, one per operator of ``aggregate`` (the mean held-out
    joint accuracy with its min-max range over the cells). ``run`` is the
    path's second component relative to the working directory
    (``artifacts/<run>/...``)."""
    with open(path) as f:
        rep = json.load(f)
    source = os.path.relpath(path)
    run = source.split("/")[1]
    for tag, op in rep.get("ops", {}).items():
        yield {"dataset": rep.get("dataset", "?"), "run": run, "op": tag,
               "weights": op.get("weights"),
               "seen": op.get("seen_joint_acc", float("nan")),
               "held_out": op.get("heldout_joint_acc", float("nan")),
               "cells": "", "source": source}
    for tag, agg in rep.get("aggregate", {}).items():
        yield {"dataset": rep.get("dataset", "?"), "run": run, "op": tag,
               "weights": None, "seen": agg["seen_joint_acc_mean"],
               "held_out": agg["heldout_joint_acc_mean"],
               "cells": (f" ({agg['heldout_joint_acc_min']:.2f}-"
                         f"{agg['heldout_joint_acc_max']:.2f}, "
                         f"n={agg['n_cells']})"),
               "source": source}


def summarize_evals(dirs: Optional[Sequence[str]] = None,
                    dataset: Optional[str] = None, top: int = 0) -> str:
    """The markdown table over the reports in ``dirs`` (glob patterns,
    default ``artifacts/*``), filtered to ``dataset`` if given, sorted by
    held-out then seen joint accuracy (both descending), the first ``top``
    rows if non-zero. Prints the table, as the script does, and returns
    its text."""
    rows = []
    for pat in dirs or ["artifacts/*"]:
        paths = (glob.glob(os.path.join(pat, "compositional_eval_*.json"))
                 + glob.glob(os.path.join(pat, "compositional_eval.json"))
                 + glob.glob(os.path.join(pat,
                                          "compositional_sweep_*.json")))
        for path in sorted(paths):
            rows.extend(rows_from(path))
    if dataset:
        rows = [r for r in rows if r["dataset"] == dataset]
    rows.sort(key=lambda r: (-r["held_out"], -r["seen"]))
    if top:
        rows = rows[:top]
    lines = ["| dataset | run (recipe) | operator | held-out joint | "
             "seen joint | report |", "|---|---|---|---|---|---|"]
    lines += [f"| {r['dataset']} | {r['run']} | {r['op']} "
              f"| {r['held_out']:.3f}{r['cells']} | {r['seen']:.3f} "
              f"| {r['source']} |" for r in rows]
    text = "\n".join(lines)
    print(text)
    return text
