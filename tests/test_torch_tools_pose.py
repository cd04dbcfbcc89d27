"""Port parity: the pose tools (tools/eval_pose_multi.py,
tools/diag_pose_job.py, tools/pose_backend_check.py) against their
scripts, each script's ``main()`` (or module function) run in this
process.

Tolerances: ``eval_pose_multi``'s pooling exact (both scripts' pose
evaluation patched to return the same per-job results; the output file
and the updated metrics.json equal, the single-video ``pose_rmse_*`` keys
kept). ``diag_pose_job``'s columns with the perfect-detector stub on one
simulated trajectory (64x64, 12 frames, window 6): within
tests/test_torch_eval.py's POSE_ATOL of 0.05 (px, deg, mm) plus half the
script's last printed digit (0.005; 0.05 for trans_mm); ``valid`` equal.
``run_compare``'s printed lines equal on the same two ``.npz``. The port's
``run_dump`` on the CPU writes the script's keys, and a replay of its own
keypoints reproduces its poses exactly.
"""

import dataclasses
import importlib.util
import io
import json
import os
import runpy
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perseus_tpu.eval.pose_eval as jpose_eval
import perseus_tpu.runtime.streaming as jstreaming
from perseus_tpu.datagen.labeling import label_trajectory as jlabel_trajectory
from perseus_tpu_torch.datagen.generate import VideoConfig, generate_one_video, simulate_video
from perseus_tpu_torch.eval import pose_eval
from perseus_tpu_torch.models.resnet import KeypointCNN
from perseus_tpu_torch.tools import diag_pose_job as dpj
from perseus_tpu_torch.tools import eval_pose_multi as epm
from perseus_tpu_torch.tools import pose_backend_check as pbc
from perseus_tpu_torch.train import checkpoint as ckpt
from perseus_tpu_torch.train import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_ATOL = 0.05  # mm and deg (tests/test_torch_eval.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run_script(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    out = io.StringIO()
    with redirect_stdout(out):
        runpy.run_path(os.path.join(REPO, "scripts", f"{name}.py"), run_name="__main__")
    return out.getvalue()


def test_eval_pose_multi_pooling_matches_the_script(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    results = {}
    for i, n in enumerate((5, 7, 6)):
        job = f"{i:08x}"
        os.makedirs(tmp_path / "jobs" / job)
        with open(tmp_path / "jobs" / job / "metadata.json", "w") as f:
            f.write("{}")
        rot, trans = rng.gamma(2.0, 3.0, n), rng.gamma(2.0, 20.0, n)
        results[job] = {"per_frame_rot_deg": rot.tolist(), "per_frame_trans_mm": trans.tolist(),
                        "pose_rmse_deg": float(np.sqrt(np.mean(rot**2))),
                        "pose_rmse_mm": float(np.sqrt(np.mean(trans**2))), "n_scored": n}
    os.makedirs(tmp_path / "jobs" / "not_a_job")  # no metadata.json: skipped by both
    fake = lambda job, **kw: results[os.path.basename(job)]  # noqa: E731
    monkeypatch.setattr(jpose_eval, "evaluate_pose_tracking", fake)
    monkeypatch.setattr(pose_eval, "evaluate_pose_tracking", fake)
    single = {"pose_rmse_mm": 1.5, "pose_rmse_deg": 2.5, "val_rmse_px": 3.0}
    outs = {}
    for who in ("jax", "port"):
        metrics = tmp_path / f"metrics_{who}.json"
        with open(metrics, "w") as f:
            json.dump(single, f)
        argv = ["--job-root", str(tmp_path / "jobs"), "--output", str(tmp_path / f"pose_multi_{who}.json"),
                "--update-metrics", str(metrics)]
        if who == "jax":
            _run_script("eval_pose_multi", argv, monkeypatch)
        else:
            from perseus_tpu_torch.configs.cli import cli

            epm.eval_pose_multi(cli(epm.MultiPoseConfig, argv), device="cpu")
        with open(tmp_path / f"pose_multi_{who}.json") as f, open(metrics) as g:
            outs[who] = json.load(f), json.load(g)
    assert outs["port"] == outs["jax"]
    pooled, updated = outs["port"]
    assert pooled["pose_multi_n_frames"] == 18 and pooled["pose_multi_n_videos"] == 3
    assert {k: updated[k] for k in single} == single and "per_job" not in updated


@pytest.fixture(scope="module")
def trajectory():
    """tests/test_torch_eval.py's scene, 12 frames: its metadata (the
    simulation alone: the stub needs no pixels) and the JAX labeler's GT
    keypoints."""
    cfg = VideoConfig(resolution=64, frames=12, n_static_range=(2, 3), n_dynamic_range=(1, 1), max_objects=5, seed=11)
    meta = simulate_video(cfg, "poseeval")["metadata"]
    cube = meta["instances"][0]
    obj7 = np.concatenate([cube["positions"], cube["quaternions"]], -1)
    cam7 = np.concatenate([meta["camera"]["positions"], meta["camera"]["quaternions"]], -1)
    kps = np.asarray(jlabel_trajectory(jnp.asarray(obj7, jnp.float32), jnp.asarray(cam7, jnp.float32),
                                       cube["abs_scale"], meta["camera"]["field_of_view"], 64, 64), np.float32)
    return json.loads(json.dumps(meta)), kps


def test_diag_pose_job_columns_match_the_script(trajectory, tmp_path, monkeypatch):
    """The script with its frames and its pipeline patched: the frames are
    frame indices, the pipeline the perfect-detector stub of its own
    pose_eval (fed those indices), as the port's detector_fn path."""
    meta, kps = trajectory
    t, window = len(kps), 6
    monkeypatch.setattr(jpose_eval, "load_job_frames", lambda job_dir: (np.arange(t), meta))
    monkeypatch.setattr(jstreaming, "StreamingPipeline",
                        lambda scfg, **kw: jpose_eval._stub_detector(scfg, kps))
    lines = _run_script("diag_pose_job", ["--job-dir", str(tmp_path), "--window", str(window)], monkeypatch)
    rows = [ln.split() for ln in lines.strip().splitlines()[1:-1]]
    want = np.asarray(rows, np.float64)
    assert want.shape == (t, 6)
    got = dpj.diag_rows(np.zeros(t), meta, detector_fn=lambda frames: kps, window=window, device="cpu")
    for j, (col, digit) in enumerate(zip(dpj.COLUMNS, (0.005, 0.005, 0.0, 0.005, 0.05)), start=1):
        if col == "valid":
            np.testing.assert_array_equal(got[col], want[:, j])
        else:
            np.testing.assert_allclose(got[col], want[:, j], atol=POSE_ATOL + digit, rtol=0, err_msg=col)
    assert dpj.format_rows(got)[0] == lines.splitlines()[0]
    assert json.loads(lines.strip().splitlines()[-1])["abs_scale"] == got["abs_scale"]
    assert np.max(got["det_px"]) < 1e-3  # a perfect detector: GT keypoints, f32 against f64


def _dump(rng, t, fixed_src):
    rot = np.linalg.qr(rng.normal(size=(t, 3, 3)))[0]
    return {"keypoints": rng.uniform(0, 64, (t, 8, 2)).astype(np.float32), "rot": rot.astype(np.float32),
            "trans": rng.normal(size=(t, 3)).astype(np.float32),
            "rot_fixedkp": rot.astype(np.float32), "trans_fixedkp": rng.normal(size=(t, 3)).astype(np.float32),
            "rot_gt": rot, "trans_gt": rng.normal(size=(t, 3)),
            "metrics": json.dumps({"backend": "cpu", "pose_rmse_deg": 1.25, "pose_rmse_mm": 3.5}),
            "fixed_src": str(fixed_src)}


def test_run_compare_prints_the_scripts_lines(tmp_path):
    spec = importlib.util.spec_from_file_location("_script_pose_backend_check",
                                                  os.path.join(REPO, "scripts", "pose_backend_check.py"))
    jcheck = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = jcheck
    spec.loader.exec_module(jcheck)
    rng = np.random.default_rng(1)
    a = _dump(rng, 10, None)
    for fixed in (None, str(tmp_path / "a.npz")):
        b = {k: (v + rng.normal(0, 1e-3, v.shape).astype(v.dtype) if isinstance(v, np.ndarray) else v)
             for k, v in _dump(np.random.default_rng(1), 10, fixed).items()}
        np.savez(tmp_path / "a.npz", **a)
        np.savez(tmp_path / "b.npz", **b)
        out = {}
        for who, fn in (("jax", jcheck.run_compare), ("port", pbc.run_compare)):
            buf = io.StringIO()
            with redirect_stdout(buf):
                fn(str(tmp_path / "a.npz"), str(tmp_path / "b.npz"))
            out[who] = buf.getvalue()
        assert out["port"] == out["jax"]
        assert len(out["port"].splitlines()) == (5 if fixed is None else 7)


def test_run_dump_on_the_cpu(tmp_path):
    """A job written by the port (32x32, 6 frames), a seeded model: the
    dump has the script's keys; a second dump replaying the first's
    keypoints gets the same poses from the smoother, bit for bit."""
    vcfg = VideoConfig(job_dir=str(tmp_path / "jobs"), resolution=32, frames=6, seed=4)
    job = generate_one_video(vcfg, "00000000", device="cpu")
    sd = KeypointCNN(8, 4, device="cpu", generator=torch.Generator().manual_seed(2)).state_dict()
    model = str(tmp_path / "model.pth")
    ckpt.export_reference_pth(model, {k: v for k, v in sd.items() if not train._is_stat(k)},
                              {k: v for k, v in sd.items() if train._is_stat(k)})
    cfg = pbc.CheckConfig(job_dir=job, model_path=model, window=3, amp=False, out=str(tmp_path / "a.npz"))
    first = pbc.run_dump(cfg, device="cpu")
    second = pbc.run_dump(dataclasses.replace(cfg, out=str(tmp_path / "b.npz"), fixed_keypoints=cfg.out),
                          device="cpu")
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    assert set(a.files) == {"keypoints", "rot", "trans", "rot_fixedkp", "trans_fixedkp", "rot_gt", "trans_gt",
                            "metrics", "fixed_src"}
    assert a["keypoints"].shape == (6, 8, 2) and json.loads(str(a["metrics"])) == first == second
    assert first["backend"] == "cpu" and str(a["fixed_src"]) == "None" and str(b["fixed_src"]) == cfg.out
    np.testing.assert_array_equal(b["rot_fixedkp"], a["rot_fixedkp"])
    np.testing.assert_array_equal(a["rot_fixedkp"], a["rot"])  # its own keypoints replayed: the same smoother run
    lines = pbc.compare_lines(a, b)
    assert "keypoint delta px: max 0.0000 mean 0.00000" in lines and len(lines) == 7
