"""The harness is driven by data: each cell's traffic driver and metric
readers run end to end on the CPU at a tiny size, the result line has the
contract's keys, the metric names are ``BENCHMARK.json``'s, a workload file
dropped into a copy is found by name, and the measured path without a card
fails instead of falling back to the CPU."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark import harness, run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _benchmark_json():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _cell_metrics(bench, cell):
    """(end-to-end, per-layer) metric names BENCHMARK.json gives ``cell``."""
    e2e = [m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    layer = [m["name"] for m in bench["per_layer"] if cell in m.get("workloads", [cell])]
    return e2e, layer


def test_benchmark_json_and_the_files_it_names_agree():
    bench = _benchmark_json()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1:] == ["-m", "benchmark.run"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    e2e_names = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e_names and os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in configs
        cell, _ = run.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (w["config"], w["traffic"], w["chips"], w["why"])
        assert os.path.exists(os.path.join(BENCH, "traffic", f"{cell['kind']}.py"))
        e2e, layer = _cell_metrics(bench, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert tuple([m["name"] for m in ms] for ms in run.cell_metrics(w["name"])) == (e2e, layer)
        for m in bench["per_layer"]:  # a per-layer metric's cells report what it moves
            if w["name"] in m["workloads"]:
                assert m["moves"] in e2e
    assert len(json.dumps(bench)) < 64 * 1024


def _line(result):
    return json.loads(harness.result_line(result["correct"], result["attempted"], result["failed"], result["metrics"],
                                          result["device"], result["trace"], result["checks"]))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["serve-gn4-stream", "serve-detect-only", "train-resident-b256", "serve-lm8-live"])
def test_each_cell_runs_end_to_end_on_the_cpu(tiny_bench, cell, trace):
    tiny, _ = run.load_cell(f"tiny-{cell}")  # dropped into the copy, found by name
    result, lines = run.run_cell(f"tiny-{cell}", 2**33 + 17, 0.5, bool(trace), torch.device("cpu"),
                                 device_type=torch.autograd.DeviceType.CPU)
    line = _line(result)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys  # the checks, each beside its limit, last
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    e2e, layer = _cell_metrics(_benchmark_json(), cell)
    assert list(line["metrics"]) == (layer if trace else e2e)
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(tiny["limits"]) and len(lines) == len(tiny["limits"])
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert 0 < len(line["breakdown"]["device_ops"]) <= 10 and len(line["breakdown"]["idle_gaps"]) <= 10


def test_a_metric_dropped_into_a_copy_is_reported_with_no_file_edited(tiny_bench):
    """A per-layer metric a later PR adds: its reader file and its entry in
    BENCHMARK.json, and no existing file edited."""
    (tiny_bench / "metrics" / "serve.frames_traced.py").write_text(
        "def read(ctx):\n    return ctx['trace'].units\n")
    bench_file = tiny_bench.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    bench["per_layer"].append({"name": "serve.frames_traced", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "device", "moves": "frame_ms_p50"})
    bench_file.write_text(json.dumps(bench))
    result, _ = run.run_cell("tiny-serve-detect-only", 7, 0.3, True, torch.device("cpu"),
                             device_type=torch.autograd.DeviceType.CPU)
    assert result["metrics"]["serve.frames_traced"] == {"value": 2.0, "unit": "frames"}
    result, _ = run.run_cell("tiny-train-resident-b256", 7, 0.3, True, torch.device("cpu"),
                             device_type=torch.autograd.DeviceType.CPU)
    assert "serve.frames_traced" not in result["metrics"]  # the cell reports no frame_ms_p50


def test_a_detector_dropped_into_a_copy_is_found_by_name_with_no_file_edited(tiny_bench):
    """A detector a later PR adds: its plug-in file and a configuration
    that names it. Here a copy of ``resnet18`` under another name, which
    gives the ``resnet18`` cell's readings and counts."""
    plugin = tiny_bench / "detectors" / "resnet18_copy.py"
    plugin.write_text("from benchmark.detectors.resnet18 import *  # noqa: F401,F403\n")
    configs, workloads = tiny_bench / "configs", tiny_bench / "workloads"
    config = json.loads((configs / "tiny-rgbd-stream-gn4.json").read_text())
    (configs / "tiny-copy.json").write_text(json.dumps(dict(config, name="tiny-copy", detector="resnet18_copy")))
    cell = json.loads((workloads / "tiny-serve-gn4-stream.json").read_text())
    (workloads / "tiny-copy-stream.json").write_text(json.dumps(dict(cell, name="tiny-copy-stream", config="tiny-copy")))
    copy = run.detector(run.load_cell("tiny-copy-stream")[1])
    assert copy.__file__ == str(plugin)
    assert copy.forward_flops(config) == run.detector(config).forward_flops(config)
    cpu = torch.device("cpu")
    readings = [run.run_cell(name, 31, 1e9, False, cpu, max_units=4)[0]["checks"]
                for name in ("tiny-serve-gn4-stream", "tiny-copy-stream")]
    assert readings[0] == readings[1] and set(readings[0]) == {"kp_gap_px", "pose_gap_px", "flags_mismatch"}
    with pytest.raises(FileNotFoundError):
        run.detector(dict(config, detector="no_such_detector"))


def test_the_measured_path_without_a_card_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "serve-detect-only", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda):
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "serve-detect-only", "--seed", "5", "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
