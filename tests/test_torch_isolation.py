"""The port stands alone: perseus_tpu_torch and chip_smoke.py import neither
jax nor perseus_tpu, and its entry points never fall back to the CPU."""

import ast
import os

import pytest
import torch

from perseus_tpu_torch import bench, graft_entry, resolve_device
from perseus_tpu_torch.eval import parity, validate_real, visualize
from perseus_tpu_torch.models import convert
from perseus_tpu_torch.models.resnet import KeypointCNN
from perseus_tpu_torch.runtime.sources import SyntheticSource
from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline, run_display_loop
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "perseus_tpu", "bench", "__graft_entry__")  # the last two: the JAX root files


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "perseus_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


# the modules of the eval and runtime tools and of the scripts' ports, which the walk below must reach
TOOLS = (
    "eval/parity.py", "eval/torch_oracle.py", "eval/validate_real.py", "eval/visualize.py",
    "runtime/sources.py", "runtime/streaming.py", "native/__init__.py", "native/io.py",
    "tools/__init__.py", "tools/generate_dataset.py", "tools/pretrain_backbone.py",
    "tools/compute_difficulty_weights.py", "tools/train_at_scale.py", "tools/prepare_at_scale.py",
    "tools/eval_pose_multi.py", "tools/eval_sensor_transfer.py", "tools/measure_oof.py", "tools/diag_pose_job.py",
    "tools/pose_backend_check.py", "bench.py", "graft_entry.py",
)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    for rel in TOOLS:
        assert os.path.join(REPO, "perseus_tpu_torch", rel) in files, rel
    bad = [
        f"{os.path.relpath(p, REPO)}: {m}"
        for p in files
        for m in _imported_modules(p)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: KeypointCNN(num_channels=4),
        lambda: StreamingPipeline(StreamingConfig(num_channels=4), {}),
        lambda: convert.from_jax_train_state({}, {}, ()),
        lambda: train.train(TrainConfig()),
        lambda: parity.run_parity(parity.ParityConfig()),
        lambda: validate_real.predict_real({}, [], validate_real.ValConfig()),
        lambda: validate_real.validate(validate_real.ValConfig()),
        lambda: visualize.augment_batch({}, visualize.VisualizeConfig()),
        lambda: visualize.visualize_augmentations(visualize.VisualizeConfig()),
        lambda: run_display_loop(StreamingConfig(), SyntheticSource()),
        lambda: graft_entry.entry(),
        lambda: graft_entry.dryrun_multichip(2),
        lambda: bench.bench_detector(),
        lambda: bench.bench_smoother(),
        lambda: bench.bench_streaming(),
        lambda: bench.bench_train(),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(RuntimeError, match="is_available"):
        bench.preflight()
    assert resolve_device("cpu") == torch.device("cpu")


def test_tools_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """Each tool's entry point takes device="cuda" by default (its config's
    device field too, where the script had a platform) and raises without
    CUDA before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    import inspect

    from perseus_tpu_torch.tools import (
        compute_difficulty_weights as cdw,
        diag_pose_job,
        eval_pose_multi,
        eval_sensor_transfer,
        generate_dataset,
        measure_oof,
        pose_backend_check,
        prepare_at_scale,
        pretrain_backbone,
        train_at_scale,
    )

    entries = [
        (generate_dataset.render_videos, (generate_dataset.GenConfig(), None)),
        (generate_dataset.generate_dataset, (generate_dataset.GenConfig(job_dir=str(tmp_path / "jobs")),)),
        (pretrain_backbone.pretrain, (pretrain_backbone.PretrainConfig(dataset_path=str(tmp_path / "ds")),)),
        (cdw.difficulty_errors, (cdw.DifficultyConfig(),)),
        (cdw.compute_difficulty_weights, (cdw.DifficultyConfig(),)),
        (train_at_scale.train_at_scale, (train_at_scale.ScaleRunConfig(),)),
        (prepare_at_scale.prepare_rendered, (prepare_at_scale.DecodedPrepareConfig(),)),
        (eval_pose_multi.score_jobs, ([], {})),
        (eval_pose_multi.eval_pose_multi, (eval_pose_multi.MultiPoseConfig(),)),
        (eval_sensor_transfer.sensor_transfer, (eval_sensor_transfer.SensorTransferConfig(),)),
        (measure_oof.oof_counts, (measure_oof.OofConfig(),)),
        (measure_oof.measure_oof, (measure_oof.OofConfig(),)),
        (diag_pose_job.diag_rows, ([], {})),
        (pose_backend_check.dump_arrays, (pose_backend_check.CheckConfig(), [], {})),
        (pose_backend_check.run_dump, (pose_backend_check.CheckConfig(job_dir=str(tmp_path / "job")),)),
    ]
    for fn, args in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(*args)
    for cfg in (generate_dataset.GenConfig(), eval_pose_multi.MultiPoseConfig(), diag_pose_job.DiagConfig(),
                pose_backend_check.CheckConfig()):
        assert cfg.device == "cuda"
    assert os.listdir(tmp_path) == []  # nothing was written before the raise
