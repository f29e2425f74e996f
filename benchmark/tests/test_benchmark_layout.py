"""The benchmark's shape: what it imports, what ``BENCHMARK.json`` may
hold, that a file key nothing reads is refused, and that a new program,
configuration, traffic mix, limits file and metric are found by name and
run without an edit of the harness."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import spec  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax",
             "composable_diffusion_models_tpu"}
PORT = "composable_diffusion_models_tpu_torch"
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")
UNIT_CHARS = NAME_CHARS | set("/%")


def sources(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports, whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sources(BENCH),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_benchmark(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources(BENCH / "reference"),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & (FORBIDDEN | {PORT})


def test_a_run_loads_no_jax():
    """What the harness, the readers, the reference and the port load in
    one process, checked as ``run.py`` checks it after the window."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from pathlib import Path\n"
        "import run, devtrace, counts, correct, spec\n"
        "from reference import dit, weights\n"
        "for m in Path(%r).glob('*.py'):\n"
        "    spec.reader(m.stem)\n"
        "for w in ('dit_p14_d256_l4.ddim50.b32768',\n"
        "          'dit_p4_d256_l8.ddim50.b256'):\n"
        "    spec.load_cell(w)\n"
        "import composable_diffusion_models_tpu_torch.entry\n"
        "print(run.forbidden_modules())\n"
        % (str(BENCH), str(ROOT), str(BENCH / "metrics")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def bench_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
             + [w[k] for w in b["workloads"] for k in ("config", "traffic")]
             + [k for c in b["configs"] for k in c["reduced"]])
    for name in names:
        assert 1 <= len(name) <= 64 and set(name) <= NAME_CHARS, name
        assert name[0] not in ".-", name
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in b[group]}) == len(b[group])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert 1 <= len(m["unit"]) <= 16 and set(m["unit"]) <= UNIT_CHARS
        assert m["better"] in ("lower", "higher")
    texts = ([c["source"] for c in b["configs"]]
             + [x["why"] for x in b["configs"] + b["workloads"]]
             + [m["layer"] for m in b["per_layer"]] + b["command"])
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_benchmark_json_contract():
    b = bench_json()
    assert b["paths"] == ["benchmark"]
    assert b["command"][1:] == ["benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    cells = 24    # what later PRs may reach: 2 + 14 runs a cell must fit
    assert ((2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 180
            + 1200 <= 43200)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert w["chips"] in (1, 4)
        cell = spec.load_cell(w["name"])
        assert {m["name"] for m in cell.end_to_end} == e2e
        assert cell.per_layer and set(cell.limits) == {
            "rel_err", "worst_image", "nonfinite"}
        for m in cell.end_to_end + cell.per_layer:
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()


TOY_PROGRAM = """
CONFIG_KEYS = {"gain"}
TRAFFIC_KEYS = set()


def load(cell, seed, device):
    g = cell.config["gain"]
    return (lambda x: g * x), g, (lambda: 0)


def image_shape(cell):
    return 2, 2, 1


def reference(cell, gain, x, fp8=False):
    return gain * x


def model_flops(cell):
    return 4.0 * cell.traffic["batch"]
"""


def throwaway_checkout(tmp_path):
    """A checkout with a throwaway program, configuration, traffic mix,
    limits file and per-layer metric added as files beside the others, and
    their cell added to ``BENCHMARK.json``."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    folder = root / "benchmark"
    (folder / "programs" / "toy.py").write_text(TOY_PROGRAM)
    (folder / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "program": "toy", "gain": 0.5}))
    (folder / "traffic" / "b2.json").write_text(json.dumps(
        {"batch": 2, "rows_per_call": 2, "check_images": 4, "ref_block": 2,
         "trace_calls": 1}))
    (folder / "limits" / "toy.b2.json").write_text(json.dumps(
        {k: {"limit": 0} for k in ("rel_err", "worst_image", "nonfinite")}))
    (folder / "metrics" / "calls_traced.py").write_text(
        "def read(run):\n    return run.calls\n")
    b = bench_json()
    b["configs"].append({"name": "toy", "source": "a test",
                         "file": "benchmark/configs/toy.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "toy.b2", "config": "toy",
                           "traffic": "b2", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "calls_traced", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "a test", "moves": "images_per_s",
                           "workloads": ["toy.b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root, folder


def test_a_new_cell_is_found_by_name(tmp_path):
    """A new program's cell loads and runs through the harness (on the
    CPU) from its files alone, and the cells already there are untouched."""
    import run
    root, folder = throwaway_checkout(tmp_path)
    cell = spec.load_cell("toy.b2", root=root, folder=folder)
    assert cell.traffic["batch"] == 2 and cell.config["gain"] == 0.5
    assert "calls_traced" in {m["name"] for m in cell.per_layer}
    r = run.measure(cell, 2 ** 31 + 5, 0.0, False, device="cpu")
    assert r["correct"], r["check"]
    assert r["attempted"] == 2 and set(r["metrics"]) == {"images_per_s",
                                                         "setup_s"}

    class Run:
        calls = 7
    got = spec.read_metrics(cell.per_layer[-1:], Run(), folder)
    assert got == {"calls_traced": {"value": 7, "unit": "calls"}}
    other = spec.load_cell("dit_p14_d256_l4.ddim50.b32768", root=root,
                           folder=folder)
    assert "calls_traced" not in {m["name"] for m in other.per_layer}


@pytest.mark.parametrize("where, key, value", [
    ("traffic", "kind", "em"), ("traffic", "eta", 1.0),
    ("config", "blend_weights", [2.0, 1.0, 1.0]),
    ("config", "state_dtype", "bfloat16")])
def test_a_key_nothing_reads_is_refused(tmp_path, where, key, value):
    """A file that seems to set what the program does not do is refused."""
    root, folder = throwaway_checkout(tmp_path)
    path = (folder / "traffic" / "ddim50.b32768.json" if where == "traffic"
            else folder / "configs" / "dit_p14_d256_l4.json")
    data = json.loads(path.read_text())
    path.write_text(json.dumps({**data, key: value}))
    with pytest.raises(ValueError, match=key):
        spec.load_cell("dit_p14_d256_l4.ddim50.b32768", root=root,
                       folder=folder)
