"""Port parity: evaluation (perseus_tpu_torch/eval: validate.py, pose_eval.py)
against the JAX package, and the port's offline pipeline end to end.

Tolerances:

  * ``validate_stats`` against JAX ``validate``, f32, the same ``.pth``
    (random init, BN statistics perturbed so that the fold is not the
    identity): per-example losses, statistics and pixel RMSE within rel
    1e-4 (measured ~1e-6: the convolutions sum in another order);
  * ``rotation_angle``: 1e-9 (the same float64 numpy);
  * ``evaluate_pose_tracking`` with the stub detector on one JAX-rendered
    job (64x64, 16 frames, window 8): the GT poses within 1e-5, every
    per-frame error and so every RMSE and median within 0.05 mm / 0.05 deg
    (1% of tests/test_pose_eval.py's 5 mm / 6 deg bounds). The smoother's
    f32 LM window solve (accept/reject, robust kernel) amplifies the two
    frameworks' last-bit differences frame by frame: measured per-frame
    differences up to 0.028 mm / deg over eight trajectories, which is up to
    rel 4.3e-3 on a median of 0.02 deg; rel 1e-3 holds on this file's
    perfect-detector trajectory (measured 9e-5) but not on every one.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu import ROOT as JROOT
from perseus_tpu.data.dataset import KeypointDatasetConfig as JDataConfig
from perseus_tpu.data.synthetic import generate_synthetic_pruned_dataset as jsynthetic
from perseus_tpu.datagen import generate as jgenerate
from perseus_tpu.datagen.labeling import label_trajectory as jlabel_trajectory
from perseus_tpu.eval import pose_eval as jpose_eval
from perseus_tpu.eval import validate as jvalidate
from perseus_tpu.models import resnet as jresnet
from perseus_tpu.train import checkpoint as jckpt
from perseus_tpu_torch import ROOT
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig
from perseus_tpu_torch.eval import pose_eval, validate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_ATOL = 0.05  # mm and deg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    the suite runs several test processes side by side on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize(
    "degrees", [[1e-3, 5e-3, 0.02, 0.1, 10.0], [90.0, 120.0, 179.5, 180.0], [0.0, 45.0, 170.0]],
    ids=["small", "large", "batched"],
)
def test_rotation_angle_matches_jax(degrees):
    axis = np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rel = np.stack([np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * (k @ k) for a in np.radians(degrees)])
    for r in (rel, rel.astype(np.float32)):
        got = pose_eval.rotation_angle(r)
        np.testing.assert_allclose(got, jpose_eval.rotation_angle(r), atol=1e-9)
        np.testing.assert_allclose(np.degrees(got), degrees, atol=1e-3)


@pytest.fixture(scope="module")
def val_setup(tmp_path_factory):
    """A 32x32 pruned dataset (6 val rows: batches of 4 and 2) and a
    reference-layout .pth of a random-init RGBD model with perturbed BN
    statistics, which both packages load."""
    root = tmp_path_factory.mktemp("val")
    dataset = jsynthetic(str(root / "ds"), n_train=8, n_test=6, h=32, w=32)
    params, stats = jresnet.init_keypoint_cnn(jax.random.key(0), 8, 4)
    rng = np.random.default_rng(0)
    stats = {
        k: (np.asarray(v) * rng.uniform(0.5, 1.5, v.shape) if k.endswith("var")
            else np.asarray(v) + rng.normal(0, 0.1, v.shape)).astype(np.float32)
        for k, v in stats.items()
    }
    name = f"torch_eval_parity_{os.getpid()}"
    pth = str(root / f"{name}.pth")
    jckpt.export_reference_pth(pth, params, stats)
    yield dataset, pth, name
    shutil.rmtree(os.path.join(JROOT, "outputs", "figures", name), ignore_errors=True)


def test_validate_stats_matches_jax_validate(val_setup):
    dataset, pth, _ = val_setup
    jcfg = jvalidate.ValConfig(model_path=pth, batch_size=4, amp=False, max_plots=0,
                               dataset_config=JDataConfig(dataset_path=dataset))
    want = jvalidate.validate(jcfg)
    cfg = validate.ValConfig(model_path=pth, batch_size=4, amp=False, max_plots=0,
                             dataset_config=KeypointDatasetConfig(dataset_path=dataset))
    got = validate.validate_stats(cfg, device="cpu")
    assert got["losses"].shape == want["losses"].shape == (6,)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["rmse_px"], want["rmse_px"], rtol=1e-4)
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=1e-4, err_msg=k)
    assert got["plots"] == [] and got["n_keypoints"] == 8


def test_validate_writes_histogram_and_overlays(val_setup):
    """The port's validate(): validate_stats printed, the histogram and
    max_plots overlays (RGB + depth panes) written."""
    dataset, pth, name = val_setup
    cfg = validate.ValConfig(model_path=pth, batch_size=4, amp=False, max_plots=5,
                             dataset_config=KeypointDatasetConfig(dataset_path=dataset))
    out = validate.validate(cfg, device="cpu")
    assert out["output_dir"] == os.path.join(ROOT, "outputs", "figures", name, "sim")
    written = sorted(os.listdir(out["output_dir"]))
    assert "loss_histogram.png" in written and [f"val_{i}.png" in written for i in range(5)] == [True] * 5
    assert "val_5.png" not in written
    stats = validate.validate_stats(cfg, device="cpu")
    assert len(stats["plots"]) == 5 and stats["plots"][0][0].shape == (32, 32, 4)
    np.testing.assert_array_equal(stats["losses"], out["losses"])


@pytest.fixture(scope="module")
def pose_job(tmp_path_factory):
    """A JAX-rendered trajectory (64x64, 16 frames, tests/test_pose_eval.py's
    scene) and its GT keypoints by the JAX labeler."""
    root = tmp_path_factory.mktemp("pose")
    cfg = jgenerate.VideoConfig(job_dir=str(root), resolution=64, frames=16, n_static_range=(2, 3),
                                n_dynamic_range=(1, 1), max_objects=5, seed=11)
    job = jgenerate.generate_one_video(cfg, job_id="poseeval")
    with open(os.path.join(job, "metadata.json")) as f:
        meta = json.load(f)
    cube = meta["instances"][0]
    obj7 = np.concatenate([cube["positions"], cube["quaternions"]], -1)
    cam7 = np.concatenate([meta["camera"]["positions"], meta["camera"]["quaternions"]], -1)
    kps = np.asarray(jlabel_trajectory(jnp.asarray(obj7, jnp.float32), jnp.asarray(cam7, jnp.float32),
                                       cube["abs_scale"], meta["camera"]["field_of_view"], 64, 64))
    return job, meta, kps


def test_gt_pose_and_job_frames_match_jax(pose_job):
    job, meta, _ = pose_job
    for a, b in zip(pose_eval._gt_pose_in_camera(meta), jpose_eval._gt_pose_in_camera(meta)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    frames, meta_t = pose_eval.load_job_frames(job)
    frames_j, _ = jpose_eval.load_job_frames(job)
    assert frames.shape == (16, 64, 64, 4) and meta_t == meta
    np.testing.assert_array_equal(frames, frames_j)


@pytest.mark.parametrize("detector", ["perfect", "noisy"])
def test_pose_tracking_with_stub_detector_matches_jax(pose_job, detector):
    job, _, kps = pose_job
    if detector == "noisy":
        kps = kps + np.random.default_rng(3).normal(0, 1.0, kps.shape).astype(np.float32)
    want = jpose_eval.evaluate_pose_tracking(job, detector_fn=lambda frames: kps, window=8)
    got = pose_eval.evaluate_pose_tracking(job, detector_fn=lambda frames: kps, window=8, device="cpu")
    assert got.keys() == want.keys()
    for k in ("n_scored", "n_frames", "abs_scale", "window"):
        assert got[k] == want[k], k
    for k in ("per_frame_rot_deg", "per_frame_trans_mm", "pose_rmse_mm", "pose_rmse_deg", "pose_median_mm",
              "pose_median_deg"):
        np.testing.assert_allclose(got[k], want[k], atol=POSE_ATOL, rtol=0, err_msg=k)
    if detector == "perfect":
        assert got["pose_rmse_mm"] < 5.0 and got["pose_rmse_deg"] < 6.0


def test_full_pipeline_port_only(tmp_path):
    """generate -> label -> merge -> prune -> train() -> validate with the
    port alone at 32x32 (tests/test_full_pipeline.py's sizes)."""
    from perseus_tpu_torch.augment.pipeline import AugmentationConfig
    from perseus_tpu_torch.data.merge import merge
    from perseus_tpu_torch.data.prune import prune_dataset
    from perseus_tpu_torch.datagen.generate import VideoConfig, generate_one_video
    from perseus_tpu_torch.datagen.label_dataset import LabelConfig, label_dataset
    from perseus_tpu_torch.train import train as train_mod
    from perseus_tpu_torch.train.config import TrainConfig

    data_root = tmp_path / "data"
    job_dir = data_root / "run0"
    os.makedirs(job_dir)
    vcfg = VideoConfig(job_dir=str(job_dir), resolution=32, frames=4, n_static_range=(1, 2), n_dynamic_range=(1, 1),
                       cube_scale_range=(1.0, 1.4), gravity=-0.5, seed=11)
    for i in range(3):
        generate_one_video(vcfg, job_id=f"{i:08x}", device="cpu")
    raw = label_dataset(LabelConfig(job_dir=str(job_dir), frames=4, train_frac=0.67, lazy_images=True))
    merged = merge([raw], str(data_root / "merged"), new_train_frac=0.67)
    pruned = prune_dataset(merged, str(data_root / "pruned" / "pruned.hdf5"), str(data_root / "pruned"), lb=0.0, ub=1.0)

    cfg = TrainConfig(
        batch_size=4, n_epochs=1, amp=False, save_epochs=1, in_channels=4,
        dataset_config=KeypointDatasetConfig(dataset_path=pruned),
        augmentation_config=AugmentationConfig(planckian_jitter=False, blur=False, random_plasma_shadow=False,
                                               color_jiggle=False),
    )
    result = train_mod.train(cfg, device="cpu")
    run_dir = os.path.join(ROOT, "outputs", "models", result["run_id"])
    try:
        assert np.isfinite(result["final_train_loss"])
        out = validate.validate(validate.ValConfig(model_path=run_dir, batch_size=4, amp=False, max_plots=1,
                                                   dataset_config=KeypointDatasetConfig(dataset_path=pruned)),
                                device="cpu")
        assert np.isfinite(out["stats"]["mean"]) and out["rmse_px"] > 0
        assert out["losses"].shape == (4,)  # the one test video's 4 frames
    finally:
        for kind in ("models", "runs", "figures"):
            shutil.rmtree(os.path.join(ROOT, "outputs", kind, result["run_id"]), ignore_errors=True)


def test_compute_path_without_h5py_pil_and_matplotlib(tmp_path):
    """As on the card's machine: with h5py, PIL and matplotlib blocked,
    render_video, label_trajectory, the in-memory pose scorer (perfect
    detector and the ResNet-18) and validate_stats over a decoded split
    from a port checkpoint all run on the CPU."""
    script = textwrap.dedent(
        f"""
        import sys
        for name in ("h5py", "PIL", "matplotlib"):
            sys.modules[name] = None
        import numpy as np, torch
        from perseus_tpu_torch.data.dataset import KeypointDatasetConfig
        from perseus_tpu_torch.data.synthetic import generate_synthetic_decoded_split
        from perseus_tpu_torch.datagen.generate import VideoConfig, render_video
        from perseus_tpu_torch.datagen.labeling import label_trajectory
        from perseus_tpu_torch.eval.pose_eval import score_pose_tracking
        from perseus_tpu_torch.eval.validate import ValConfig, validate_stats
        from perseus_tpu_torch.models.resnet import KeypointCNN
        from perseus_tpu_torch.train import checkpoint

        rgb, depth, seg, meta = render_video(VideoConfig(resolution=32, frames=6, max_objects=8), "0", device="cpu")
        assert rgb.shape == (6, 32, 32, 3) and (seg == 1).any()
        cube = meta["instances"][0]
        kp = label_trajectory(np.concatenate([cube["positions"], cube["quaternions"]], -1),
                              np.concatenate([meta["camera"]["positions"], meta["camera"]["quaternions"]], -1),
                              cube["abs_scale"], meta["camera"]["field_of_view"], 32, 32, device="cpu")
        frames = torch.cat([rgb, depth[..., None]], dim=-1)
        perfect = score_pose_tracking(frames, meta, detector_fn=lambda f: kp, window=3, device="cpu")
        sd = KeypointCNN(n_keypoints=8, num_channels=4, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
        detected = score_pose_tracking(frames, meta, state_dict=sd, window=3, amp=False, device="cpu")
        assert np.isfinite(perfect["pose_rmse_mm"]) and np.isfinite(detected["pose_rmse_mm"])

        split = generate_synthetic_decoded_split({str(tmp_path / "split")!r}, 4, 6, 32, 32)
        checkpoint.save_train_state({str(tmp_path / "model")!r}, {{
            "params": {{k: v for k, v in sd.items() if not k.endswith(("running_mean", "running_var"))}},
            "batch_stats": {{k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}},
        }})
        out = validate_stats(ValConfig(model_path={str(tmp_path / "model")!r}, batch_size=4, amp=False,
                                       dataset_config=KeypointDatasetConfig(dataset_path=split)), device="cpu")
        assert out["losses"].shape == (6,) and len(out["plots"]) == 6 and np.isfinite(out["rmse_px"])
        assert all(sys.modules[name] is None for name in ("h5py", "PIL", "matplotlib"))
        print("computed", perfect["pose_rmse_mm"], out["rmse_px"])
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0 and "computed" in out.stdout, out.stderr[-3000:]
