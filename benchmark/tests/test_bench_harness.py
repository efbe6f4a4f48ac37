"""The benchmark's own tests, on the CPU at tiny sizes through the
program's plain twins (the card's kernels have no CPU mode):

    python -m pytest benchmark/tests -q

Each cell runs through ``run.py`` and prints the contract's line; the
control (the reference one precision below the configuration's, in the
program's place) and each fault planted under the timed path turn
``correct`` false under the cells' own limits; the reference imports
nothing of the program or of JAX, and a run loads neither; and
``BENCHMARK.json`` holds to its contract. The test that needs a card
skips here.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import re
import subprocess
import sys

import pytest
import torch

from benchmark import faults, harness, run
from benchmark.tests.tiny import tiny_spec

ROOT = harness.ROOT
BENCH = harness.BENCH_DIR
CELLS = ("lift.lseg.garden", "lift.dinov2.garden")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2147483711


def run_tiny(cell: str, seed: int = SEED, trace: int = 0) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", str(trace)], spec=tiny_spec(cell), require_chip=False)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def cells_in_bench():
    return [w["name"] for w in bench()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_the_contract_line(cell):
    r = run_tiny(cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    e2e = {m["name"] for m in harness.metrics_for(bench(), cell, "end_to_end")}
    assert set(r["metrics"]) == e2e
    assert {"setup_s", "peak_gb"} <= e2e
    assert set(r["check"]) == set(harness.limits(tiny_spec(cell)["workload"]))
    assert cell in cells_in_bench()


def test_traced_run_reads_its_metrics():
    r = run_tiny("lift.lseg.garden", trace=1)
    assert r["correct"] is True
    assert "breakdown" in r and set(r["device"]) >= {"busy_s", "window_s"}
    assert set(r["metrics"]) <= {m["name"] for m in bench()["per_layer"]}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """The reference one precision below the configuration's, put in the
    program's place, fails at least one of the cell's numbers."""
    spec = tiny_spec(cell)
    path = harness.path_class(spec["workload"]["path"])(spec["workload"], spec["config"], SEED,
                                                        torch.device("cpu"))
    checks = harness.judged(path.control_reading(), harness.limits(spec["workload"]))
    assert not all(c["ok"] for c in checks.values()), checks


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in faults.FAULTS])
def test_fault_under_the_timed_path_is_not_correct(cell, fault):
    with faults.planted(fault):
        assert run_tiny(cell)["correct"] is False


FORBIDDEN_IMPORTS = {"jax", "jaxlib", "flax", "tpugs", "tpugs_torch"}


@pytest.mark.parametrize("source", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program_or_jax(source):
    tree = ast.parse(source.read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN_IMPORTS, f"{source.name} imports {n}"


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests.test_bench_harness import run_tiny\n"
            "from benchmark import harness\n"
            "run_tiny('lift.lseg.garden')\n"
            "assert not harness.forbidden_loaded(), harness.forbidden_loaded()\n") % str(ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, capture_output=True)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cells_in_bench()[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_json_holds_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = harness.load_json(ROOT / c["file"])
        assert sorted(cfg["reduced"]) == sorted(c["reduced"]) and "n_gaussians" in cfg["assumed"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in b["workloads"]:
        work = harness.load_json(BENCH / "workloads" / f"{w['name']}.json")
        assert work["rate_metric"] in e2e and w["chips"] == 1
        assert set(harness.limits(work)) and len(w["why"]) <= 200
        reported = harness.metrics_for(b, w["name"], "per_layer")
        assert reported and len(harness.metrics_for(b, w["name"], "end_to_end")) >= 2
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        reader = harness.load_module(BENCH / "metrics" / f"{m['name']}.py", "r")
        assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])
        assert m["moves"] in e2e


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(cell, card):
    """On the card (``python -m pytest benchmark/tests -q`` there): a tiny
    cell through the CUDA kernels and the profiler runs to its result line,
    each compared number finite. (Its limits hold at the cell's own size;
    a tiny scene is no reading of them.)"""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.5",
                       "--trace", "1"], spec=tiny_spec(cell))
    r = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert all(c["value"] == c["value"] and abs(c["value"]) < 1e30 for c in r["check"].values())
