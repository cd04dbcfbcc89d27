"""The readings a cell's limits are set from, in one process.

    python3 -m benchmark.controls --workload <cell> --seeds 1,2,3 \
        [--controls fp8:4,5,6 half_batch:7,8,9] [--seconds 3]

Each is one ``run.run_cell`` of the cell, untraced. For each seed of
``--seeds`` a sound run of the program with a window of ``--seconds`` (a
training cell checks set-up's steps, so it runs no window). For each
``fault:seeds`` of ``--controls`` the same with the reference put in the
program's place: ``fp8`` one precision below the configuration's (every
cell), ``half_batch`` the loss over half of each batch (training cells),
``gn4`` the program's smoother cut to GN-4 (smoothed camera cells); a
serving control runs the cell's ``control_frames`` frames. One JSON
line per run on stdout. The benchmark's own runs never run this; it needs
the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import run


def control_run(name: str, seed: int, seconds: float, device, control: str | None = None) -> dict:
    """``run.run_cell`` of cell ``name`` as this module runs it: its result."""
    cell, _ = run.load_cell(name)
    training = cell["kind"] == "resident_train"
    if control is not None and not training:
        seconds, max_units = 1e9, cell["params"]["control_frames"]
    else:
        seconds, max_units = (0.0 if training else seconds), None
    result, _ = run.run_cell(name, seed, seconds, False, device, start=time.perf_counter(),
                             control=control, max_units=max_units)
    gc.collect()
    torch.cuda.empty_cache()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--controls", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: the readings are taken on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    for spec in args.controls:
        fault, seeds = spec.split(":")
        runs += [(int(s), fault) for s in seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        result = control_run(args.workload, seed, args.seconds, device, control)
        readings = {k: v["value"] for k, v in result["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control, "correct": result["correct"],
                          "readings": readings, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
