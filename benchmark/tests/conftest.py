"""Fixtures of the benchmark's tests: a copy of the benchmark's data files
with tiny cells dropped in (found by name, as a later PR's files would
be), and the card when there is one."""

import json
import os
import shutil

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each real cell's tiny stand-in: the same configuration at a CPU size, in
# f32 (the checks' sound readings are then far under these limits)
TINY = {
    "serve-gn4-stream": {"kp_gap_px": 1e-3, "pose_gap_px": 1e-2, "flags_mismatch": 0.0},
    "serve-detect-only": {"kp_gap_px": 1e-3},
    "train-resident-b256": {"loss1_gap": 1e-3, "stats_gap": 1e-3, "grad_gap": 1e-3, "update_gap": 0.03},
    "serve-lm8-live": {"kp_gap_px": 1e-3, "smoother_gap_median_px": 1e-3, "flags_mismatch": 0.0},
}
# a configuration's CPU size: camera configurations (they have frames) and
# training configurations
TINY_STREAM = dict(frame_h=40, frame_w=56, model_h=32, model_w=32, compute_dtype="float32")
TINY_TRAIN = dict(n_train=16, batch_size=4, input_resolution=32, compute_dtype="float32", storage_dtype="float32",
                  learning_rate=1e-5)


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """The benchmark's data files, detectors and ``BENCHMARK.json`` copied
    under ``tmp_path`` with tiny cells ``tiny-<cell>`` on tiny
    configurations ``tiny-<config>``; ``benchmark.run`` reads from the
    copy."""
    from benchmark import run

    root = tmp_path / "benchmark"
    for d in ("configs", "workloads", "metrics", "detectors"):
        shutil.copytree(os.path.join(BENCH, d), root / d)
    small = dict(pool_frames=4, warmup_frames=1, settle_block=2, settle_max_s=1, traced_frames=2,
                 sample_frames=3, control_frames=4, traced_steps=2)
    for name, limits in TINY.items():
        cell = json.loads((root / "workloads" / f"{name}.json").read_text())
        config = json.loads((root / "configs" / f"{cell['config']}.json").read_text())
        config.update(name=f"tiny-{cell['config']}", **(TINY_STREAM if "frame_h" in config else TINY_TRAIN))
        if "smoother" in config:
            config["smoother"]["window"] = 4
        (root / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
        cell.update(name=f"tiny-{name}", config=config["name"], limits=limits)
        cell["params"].update({k: v for k, v in small.items() if k in cell["params"]})
        (root / "workloads" / f"tiny-{name}.json").write_text(json.dumps(cell))
    # the tiny cells take the real cells' metrics in a copy of BENCHMARK.json
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [f"tiny-{w}" for w in m["workloads"] if w in TINY]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    monkeypatch.setattr(run, "HERE", str(root))
    torch.manual_seed(0)
    return root


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
