"""The tools' configs and command lines against the scripts', and the data
tools: tools/generate_dataset.py's resume and start index,
tools/measure_oof.py against a count from the JAX package's ``label_job``.

Tolerances: none. Each config has the script's fields in its order and
defaults (``platform`` becomes ``device``, "cuda" by default; the bisect's
``out`` lies under the repo's outputs/); job ids, skips, failures and
progress lines as the script's; the out-of-frame frame counts equal.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from perseus_tpu.datagen.label_dataset import LabelConfig as JLabelConfig
from perseus_tpu.datagen.label_dataset import label_job as jlabel_job
from perseus_tpu_torch import ROOT
from perseus_tpu_torch.configs.cli import cli
from perseus_tpu_torch.datagen.generate import simulate_video
from perseus_tpu_torch.tools import (
    compute_difficulty_weights,
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [
    (generate_dataset.GenConfig, "generate_dataset", "GenConfig"),
    (pretrain_backbone.PretrainConfig, "pretrain_backbone", "PretrainConfig"),
    (compute_difficulty_weights.DifficultyConfig, "compute_difficulty_weights", "DifficultyConfig"),
    (train_at_scale.ScaleRunConfig, "train_at_scale", "ScaleRunConfig"),
    (eval_pose_multi.MultiPoseConfig, "eval_pose_multi", "MultiPoseConfig"),
    (eval_sensor_transfer.SensorTransferConfig, "eval_sensor_transfer", "SensorTransferConfig"),
    (measure_oof.OofConfig, "measure_oof", "OofConfig"),
    (diag_pose_job.DiagConfig, "diag_pose_job", "DiagConfig"),
    (pose_backend_check.CheckConfig, "pose_backend_check", "CheckConfig"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("port_cls, script, name", CONFIGS, ids=[c[1] for c in CONFIGS])
def test_config_matches_the_script(port_cls, script, name):
    ref = getattr(_script(script), name)()
    port = port_cls()
    names = [("device" if f.name == "platform" else f.name) for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(port)] == names
    for f in dataclasses.fields(ref):
        if f.name == "platform":
            assert port.device == "cuda" and getattr(ref, f.name) in ("cpu", "default")
        elif (script, f.name) == ("pose_backend_check", "out"):
            assert port.out == os.path.join(ROOT, "outputs", "pose_backend.npz")
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_command_lines_parse():
    assert cli(generate_dataset.GenConfig, ["--n-videos", "3", "--device", "cpu"]).device == "cpu"
    assert cli(pose_backend_check.CheckConfig, ["--compare", "a.npz,b.npz"]).compare == ("a.npz", "b.npz")
    cfg = cli(prepare_at_scale.DecodedPrepareConfig,
              ["--scale.data-root", "d", "--videos.n-videos", "3", "--holdout-videos.n-videos", "2"])
    assert (cfg.scale.data_root, cfg.videos.n_videos, cfg.holdout_videos.n_videos) == ("d", 3, 2)
    assert (cfg.holdout_videos.style, cfg.holdout_videos.seed, cfg.videos.style) == ("holdout", 1, "train")
    for mod in (generate_dataset, pretrain_backbone, compute_difficulty_weights, train_at_scale, prepare_at_scale,
                eval_pose_multi, eval_sensor_transfer, measure_oof, diag_pose_job, pose_backend_check):
        assert callable(mod.main)


def test_generate_dataset_resume_start_index_and_failures(tmp_path, monkeypatch, capsys):
    """Jobs 5-7 (hex, from start_index): 6 is done already (its
    metadata.json exists) and is not rendered again, 7 fails and is printed
    and skipped, 5 is written; the script's job-id arithmetic (:58-59)."""
    cfg = generate_dataset.GenConfig(job_dir=str(tmp_path), n_videos=3, start_index=5, resolution=32, frames=2)
    assert generate_dataset.job_ids(cfg) == [f"{i:08x}" for i in range(5, 8)]
    os.makedirs(tmp_path / "00000006")
    with open(tmp_path / "00000006" / "metadata.json", "w") as f:
        f.write("{}")
    render = generate_dataset.render_video
    rendered = []

    def fake(vcfg, job_id, device):
        rendered.append(job_id)
        if job_id == "00000007":
            raise RuntimeError("boom")
        return render(vcfg, job_id, device)

    monkeypatch.setattr(generate_dataset, "render_video", fake)
    summary = generate_dataset.generate_dataset(cfg, device="cpu")
    out = capsys.readouterr().out
    assert rendered == ["00000005", "00000007"]
    assert summary["done"] == 2 and summary["failed"] == ["00000007"]
    assert "video 00000007 failed: boom" in out and "[gen] done: 2 videos in" in out
    assert sorted(os.listdir(tmp_path)) == ["00000005", "00000006"]
    assert os.listdir(tmp_path / "00000006") == ["metadata.json"]
    names = set(os.listdir(tmp_path / "00000005"))
    assert {"metadata.json", "rgba_00001.png", "depth_00001.tiff", "segmentation_00001.png"} <= names
    with open(tmp_path / "00000005" / "metadata.json") as f:
        assert json.load(f) == json.loads(json.dumps(simulate_video(generate_dataset.video_config(cfg),
                                                                    "00000005")["metadata"]))


def test_generate_dataset_progress_every_50(monkeypatch, capsys):
    cfg = generate_dataset.GenConfig(n_videos=101)
    monkeypatch.setattr(generate_dataset, "render_video", lambda vcfg, job_id, device: (None, None, None, {}))
    summary = generate_dataset.render_videos(cfg, lambda *video: None, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[gen] ")]
    assert summary["done"] == 101 and [ln.split()[1] for ln in lines[:-1]] == ["50/101", "100/101"]


def test_measure_oof_counts_match_jax_label_job(tmp_path):
    """The compute half's counts (the simulation's metadata labelled in
    memory) against JAX's label_job on the same jobs' metadata.json, at the
    default resolution 64 and a seed whose trajectories leave the frame."""
    cfg = measure_oof.OofConfig(n_videos=3, seed=3, resolution=64)
    oof, total = measure_oof.oof_counts(cfg, device="cpu")
    vcfg = measure_oof.video_config(cfg)
    want_oof = want_total = 0
    for i in range(cfg.n_videos):
        job_id = f"oof{i:05x}"
        os.makedirs(tmp_path / job_id)
        with open(tmp_path / job_id / "metadata.json", "w") as f:
            json.dump(simulate_video(vcfg, job_id)["metadata"], f)
        px = np.asarray(jlabel_job(JLabelConfig(job_dir=str(tmp_path), lazy_images=True), job_id)["pixel_coordinates"])
        out = (px[..., 0] < 0) | (px[..., 0] >= 64) | (px[..., 1] < 0) | (px[..., 1] >= 64)  # :70-75
        want_oof += int(out.any(axis=-1).sum())
        want_total += px.shape[0]
    assert (oof, total) == (want_oof, want_total) and total == 3 * 24 and oof > 0
    rec = measure_oof.measure_oof(cfg, device="cpu")
    assert rec == {"oof_frame_rate": want_oof / want_total, "frames": total, "videos": 3, "collisions": True,
                   "style": "train"}


def test_measure_oof_writer_path_equals_the_compute_half(tmp_path):
    """With job_dir the videos are rendered and written, then labelled from
    their files, as the script does; the record is the compute half's."""
    cfg = measure_oof.OofConfig(n_videos=1, seed=3, resolution=32)
    rec = measure_oof.measure_oof(dataclasses.replace(cfg, job_dir=str(tmp_path)), device="cpu")
    assert os.path.isfile(tmp_path / "oof00000" / "rgba_00023.png")
    assert rec == measure_oof.measure_oof(cfg, device="cpu")
