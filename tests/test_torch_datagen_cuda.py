"""The synthetic-data path and its evaluation on the card against the CPU:
cuda-marked tests, which skip on a host without one. No JAX here (the
card's machine has none, nor h5py, PIL or matplotlib: only the compute
halves run); run there with
``python -m pytest tests/test_torch_datagen_cuda.py -m cuda --noconftest``.

Tolerances, as chip_smoke.py's phase 7 holds them: seg equal on 99.5% of
each frame's pixels and, where it agrees, rgb within 1e-4 and depth within
rel 1e-5 on 99.5% of them; labels within 1e-3 px; the pose scorer's
per-frame errors within 0.05 mm / 0.05 deg (the f32 LM solve on two
devices); validate's f32 losses and RMSE within rel 1e-3 (cuDNN's and the
CPU's convolutions sum in other orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

from perseus_tpu_torch.data.dataset import KeypointDatasetConfig
from perseus_tpu_torch.data.synthetic import generate_synthetic_decoded_split
from perseus_tpu_torch.datagen import generate
from perseus_tpu_torch.datagen.labeling import label_trajectory
from perseus_tpu_torch.eval import pose_eval, validate
from perseus_tpu_torch.models import pool
from perseus_tpu_torch.models.resnet import KeypointCNN
from perseus_tpu_torch.train import checkpoint

CFG = generate.VideoConfig(resolution=64, frames=12, max_objects=12)


@pytest.fixture(scope="module")
def rendered():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sim = generate.simulate_video(CFG, "cuda0001")
    return sim, generate.render_simulated(CFG, sim, "cuda"), generate.render_simulated(CFG, sim, "cpu")


def _labels(meta, device):
    cube = meta["instances"][0]
    return label_trajectory(
        np.concatenate([cube["positions"], cube["quaternions"]], -1),
        np.concatenate([meta["camera"]["positions"], meta["camera"]["quaternions"]], -1),
        cube["abs_scale"], meta["camera"]["field_of_view"], CFG.resolution, CFG.resolution, device=device,
    )


@pytest.mark.cuda
def test_cuda_render_matches_cpu(rendered):
    _, card, cpu = rendered
    assert all(x.is_cuda for x in card)
    (rgb_a, depth_a, seg_a), (rgb_b, depth_b, seg_b) = [[x.cpu().numpy() for x in r] for r in (card, cpu)]
    same = seg_a == seg_b
    assert same.mean(axis=(1, 2)).min() >= 0.995
    ok = same & (np.abs(rgb_a - rgb_b).max(axis=-1) <= 1e-4) & (np.abs(depth_a - depth_b) <= 1e-5 * np.abs(depth_b))
    assert (ok.sum(axis=(1, 2)) / same.sum(axis=(1, 2))).min() >= 0.995


@pytest.mark.cuda
def test_cuda_labels_and_pose_scorer_match_cpu(rendered):
    sim, card, _ = rendered
    meta = sim["metadata"]
    kp = _labels(meta, "cuda")
    assert kp.is_cuda
    np.testing.assert_allclose(kp.cpu().numpy(), _labels(meta, "cpu").numpy(), atol=1e-3)
    frames = torch.cat([card[0], card[1][..., None]], dim=-1)
    got = pose_eval.score_pose_tracking(frames, meta, detector_fn=lambda f: kp, window=4, device="cuda")
    want = pose_eval.score_pose_tracking(frames.cpu(), meta, detector_fn=lambda f: kp.cpu(), window=4, device="cpu")
    for k in ("per_frame_rot_deg", "per_frame_trans_mm", "pose_rmse_mm", "pose_rmse_deg"):
        np.testing.assert_allclose(got[k], want[k], atol=0.05, rtol=0, err_msg=k)
    sd = KeypointCNN(n_keypoints=8, num_channels=4, device="cuda", generator=torch.Generator().manual_seed(0)).state_dict()
    pool.max_pool_3x3_s2.launches = 0
    detected = pose_eval.score_pose_tracking(frames, meta, state_dict=sd, window=4, device="cuda")
    assert pool.max_pool_3x3_s2.launches == CFG.frames + 1  # a frame each and the cold start's
    assert np.isfinite(detected["per_frame_trans_mm"]).all()


@pytest.mark.cuda
def test_cuda_validate_stats_matches_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sd = KeypointCNN(n_keypoints=8, num_channels=4, device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()
    stat = lambda k: k.endswith(("running_mean", "running_var"))  # noqa: E731
    checkpoint.save_train_state(str(tmp_path / "model"), {
        "params": {k: v for k, v in sd.items() if not stat(k)}, "batch_stats": {k: v for k, v in sd.items() if stat(k)},
    })
    split = generate_synthetic_decoded_split(str(tmp_path / "split"), 4, 10, 64, 64)
    cfg = validate.ValConfig(model_path=str(tmp_path / "model"), batch_size=4, amp=False,
                             dataset_config=KeypointDatasetConfig(dataset_path=split))
    pool.max_pool_3x3_s2.launches = 0
    got = validate.validate_stats(cfg, device="cuda")
    assert pool.max_pool_3x3_s2.launches == 3  # one per val batch
    want = validate.validate_stats(cfg, device="cpu")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
    np.testing.assert_allclose(got["rmse_px"], want["rmse_px"], rtol=1e-3)
    bf16 = validate.validate_stats(dataclasses.replace(cfg, amp=True), device="cuda")
    assert np.isfinite(bf16["losses"]).all()
