"""Runs one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is ``workloads/<cell>.json``: its
configuration (``configs/<config>.json``), its traffic's generator
(``traffic/<kind>.py``) with the traffic's parameters, the chips it needs
and the limits of its check. A camera configuration's detector is
``detectors/<detector>.py`` (the key ``detector``, ``resnet18`` where it is
absent). Its metrics are those that ``BENCHMARK.json`` gives it (a metric's
``workloads``, or every cell that reports what a per-layer metric moves);
each per-layer metric is read by ``metrics/<name>.py``. A later cell,
configuration, detector or metric is a new file and new entries, found by
name.

A run: set-up (weights and data from the seed, the program built and warmed
up on every shape the cell uses; ``setup_s`` runs from the start of this
module), the measured window of ``--seconds``, then with ``--trace 1`` a
traced window and the per-layer metrics, then the check against the plain
reference (after the peak memory is read and the program's state freed).
The last stdout line is the result; the numbers compared, each beside its
limit, are the last lines of stderr and the last key of the result. The run
fails, printing no result, without the card(s) the cell asks for, or when
the JAX package or JAX is loaded in this process.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# build and kernel caches: fixed directories inside the checkout, so that
# only a checkout's first run builds
CACHE = os.path.join(CHECKOUT, ".benchmark_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("USE_FLAX", "0")


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict]:
    cell = load_json("workloads", f"{name}.json")
    return cell, load_json("configs", f"{cell['config']}.json")


def cell_metrics(name: str) -> tuple[list[dict], list[dict]]:
    """The (end-to-end, per-layer) metrics ``BENCHMARK.json`` (beside this
    folder) gives cell ``name``: those that list it under ``workloads``,
    those without the key, and a per-layer metric without it wherever what
    it moves is reported."""
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return e2e, layer


def traffic_module(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def _load(folder: str, name: str):
    """The module ``<folder>/<name>.py`` (names may hold dots, so by path)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", os.path.join(HERE, folder, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return _load("metrics", name).read


def detector(config: dict):
    """The detector plug-in a camera configuration names (``detector``,
    ``resnet18`` where the key is absent): ``detectors/<name>.py``."""
    return _load("detectors", config.get("detector", "resnet18"))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, *, start: float = START,
             device_type=None, control: str | None = None, max_units: int | None = None) -> tuple[dict, list[str]]:
    """One run of cell ``name`` on ``device`` (no look for a card: the
    caller's); returns (result, the checks' stderr lines). ``control``
    puts the reference in the program's place and ``max_units`` ends the
    window after that many frames or steps (the tests' and
    ``benchmark.controls``' use)."""
    import torch

    from benchmark import harness

    cell, config = load_cell(name)
    e2e, per_layer = cell_metrics(name)
    driver = traffic_module(cell["kind"]).Driver(cell, config, seed, device)
    driver.setup()
    if control is not None:
        driver.use_control(control)
    setup_s = time.perf_counter() - start
    harness.log(f"{name}: set-up {setup_s:.3f} s")
    measured = driver.window(seconds, max_units)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = None
    metrics = {}
    if trace:
        with harness.TracedWindow(device) as tw:
            units = driver.traced()
        summary = tw.summary(units, device_type)
        ctx = {"driver": driver, "trace": summary, "window": measured, "config": config, "cell": cell, "device": device}
        for m in per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else measured[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    driver.free()
    t_check = time.perf_counter()
    correct, checks = harness.judge(driver.check(), cell["limits"])
    harness.log(f"{name}: check {time.perf_counter() - t_check:.3f} s")
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    dev = harness.device_record(device, cell["chips"], memory_peak, summary)
    result = {"correct": correct, "attempted": measured["attempted"], "failed": measured["failed"],
              "metrics": metrics, "device": dev, "trace": summary, "checks": checks}
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell, _ = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{args.workload} needs {cell['chips']} CUDA card(s); this host has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    device = torch.device("cuda", 0)
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the run loaded {', '.join(found)}: no result")
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(harness.result_line(result["correct"], result["attempted"], result["failed"], result["metrics"],
                              result["device"], result["trace"], result["checks"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
