"""What a cell is, read from data: ``BENCHMARK.json`` at the checkout's
root names the cells, the configurations and the metrics; each cell's
configuration, traffic mix and limits, its program, and each metric's
reader, sit in files of their own that this module finds by name:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives it): the
  program it runs and what that program reads (its ``CONFIG_KEYS``);
* ``traffic/<traffic>.json``: the batch, what the check and the trace take
  of a run (``HARNESS_KEYS``), and what the program reads (its
  ``TRAFFIC_KEYS``);
* ``programs/<program>.py``: how the cell's calls are made, what their
  plain reference is, and the model FLOPs of a call;
* ``limits/<workload>.json``: each number the check compares, its limit
  and the readings the limit was set from;
* ``metrics/<metric>.py``: a ``read(run)`` that returns the metric's
  value, or None where the run holds nothing for it to read.

A configuration or traffic file with a key that neither the harness nor
its program reads is refused, so that no file seems to set what the
program does not do.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# what describes a file and is read by no code
DOC_KEYS = {"name", "why", "source", "architecture", "deployment", "assumed"}
HARNESS_KEYS = {"batch", "rows_per_call", "check_images", "ref_block",
                "trace_calls"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    program: ModuleType
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _refuse_unread(what: str, data: dict, keys: set) -> None:
    unread = sorted(set(data) - keys - DOC_KEYS)
    if unread:
        raise ValueError(f"{what}: {unread} are read by nothing")


def load_cell(workload: str, root: Path = ROOT, folder: Path = HERE) -> Cell:
    """The cell named ``workload`` in ``root / BENCHMARK.json``, its
    traffic, program and limits read from ``folder`` (the benchmark's
    own)."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(folder / "traffic" / f"{w['traffic']}.json")
    name = config["program"]
    program = _module(folder / "programs" / f"{name}.py", f"_program_{name}")
    _refuse_unread(w["config"], config, program.CONFIG_KEYS | {"program"})
    _refuse_unread(w["traffic"], traffic, program.TRAFFIC_KEYS | HARNESS_KEYS)
    return Cell(
        name=workload, chips=w["chips"], config=config, traffic=traffic,
        program=program,
        limits=_load_json(folder / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def reader(metric: str, folder: Path = HERE) -> Callable:
    """``read`` of ``metrics/<metric>.py`` in the benchmark's ``folder``,
    loaded from its file."""
    return _module(folder / "metrics" / f"{metric}.py",
                   f"_metric_{metric}").read


def read_metrics(metrics: List[dict], run,
                 folder: Path = HERE) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something in ``run``."""
    out = {}
    for m in metrics:
        value = reader(m["name"], folder)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
