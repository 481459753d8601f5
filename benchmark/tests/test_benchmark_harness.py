"""The harness end to end on the CPU, at each cell's small shapes, and the
shape of BENCHMARK.json."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BIG_SEED = 2**31 + 12345


def run_cell(args, cwd=harness.REPO, timeout=240):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def last_line(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_cpu(cell, trace):
    out = last_line(run_cell(["--workload", cell, "--seed", str(BIG_SEED), "--seconds", "0.5",
                              "--trace", str(trace), "--device", "cpu"]))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    if not trace:
        e2e = {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])}
        assert set(out["metrics"]) == e2e
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = run_cell(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_alone_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    paths, a run fails and prints no result."""
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    for p in SPEC["paths"]:
        shutil.copytree(harness.REPO / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_cell(["--workload", CELLS[0], "--seed", "1", "--seconds", "0.5", "--trace", "0",
                     "--device", "cpu"], cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert harness.read_json(harness.REPO / c["file"])["name"] == c["name"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert harness.Cell.load(w["name"]).workload["config"] == w["config"]
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").exists()
        assert set(m["workloads"]) <= set(CELLS)
