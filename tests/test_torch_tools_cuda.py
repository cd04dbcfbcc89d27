"""The scripts' ports (perseus_tpu_torch/tools/) on the card: cuda-marked
tests, which skip on a host without one. No JAX here (the card's machine
has none) and no h5py or PIL: the data is rendered in memory and written
as decoded splits. Run there with
``python -m pytest tests/test_torch_tools_cuda.py -m cuda --noconftest``.

Tolerances, card against CPU in f32 (TF32 off) on the same inputs: the
pretrain step's loss within rel 1e-4 and its accuracy equal, with the
maxpool's forward and gradient kernels launched once each; the val RMSE
in pixels within rel 1e-4 (the convolutions sum in another order).
"""

import numpy as np
import pytest
import torch

from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.models import pool
from perseus_tpu_torch.tools import generate_dataset as gd
from perseus_tpu_torch.tools import pretrain_backbone as pb
from perseus_tpu_torch.tools import train_at_scale as tas
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A decoded split of 6 videos (64x64, 8 frames) rendered on the card."""
    _need_cuda()
    cfg = tas.ScaleRunConfig(data_root=str(tmp_path_factory.mktemp("tools_cuda")), frames=8, seg_lb=0.0, seg_ub=1.0)
    writer = tas.DecodedSplitWriter(cfg)
    summary = gd.render_videos(gd.GenConfig(n_videos=6, resolution=64, frames=8), writer.add, "cuda")
    assert not summary["failed"]
    return writer.write()


def _on(state, dev):
    return train.TrainState({k: v.to(dev) for k, v in state.params.items()},
                            {k: v.to(dev) for k, v in state.batch_stats.items()},
                            train.ClipAdamW(1.0, 1e-3, 1e-2).init({k: v.to(dev) for k, v in state.params.items()}))


@pytest.mark.cuda
def test_pretrain_step_on_the_card_matches_the_cpu(split):
    _need_cuda()
    ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=split), train=True)
    cfg = pb.PretrainConfig(dataset_path=split, batch_size=8)
    rows = pb.draw_rows(len(ds), cfg.max_rows, cfg.seed)
    opt = train.ClipAdamW(1.0, cfg.learning_rate, cfg.weight_decay)
    state = pb.init_pretrain_state(cfg, opt, "cpu")
    step = pb.make_pretrain_step(opt, compute_dtype=torch.float32)
    perm = torch.randperm(8, generator=torch.Generator().manual_seed(0))
    idx = torch.arange(8)
    out = {}
    for dev in ("cpu", "cuda"):
        images = pb.load_rows(ds, rows, cfg.in_channels, torch.float32, torch.device(dev))
        before = (pool.max_pool_3x3_s2.launches, pool.max_pool_3x3_s2_backward.launches)
        _, loss, acc = step(_on(state, dev), images, idx.to(dev), perm=perm.to(dev))
        after = (pool.max_pool_3x3_s2.launches, pool.max_pool_3x3_s2_backward.launches)
        out[dev] = loss.item(), acc.item(), (after[0] - before[0], after[1] - before[1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    assert out["cuda"][1] == out["cpu"][1] and out["cuda"][2] == (1, 1) and out["cpu"][2] == (0, 0)


@pytest.mark.cuda
def test_val_rmse_px_on_the_card_matches_the_cpu(split):
    _need_cuda()
    tcfg = TrainConfig(batch_size=8, device_data_dtype="bfloat16",
                       dataset_config=KeypointDatasetConfig(dataset_path=split))
    ds = PrunedKeypointDataset(tcfg.dataset_config, train=False)
    state = train.init_state(tcfg, train.make_optimizer(tcfg), "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        dd = train._device_dataset(ds, tcfg, dev, use_transplant=False)
        out[dev] = tas.val_rmse_px(_on(state, dev), tcfg, dd, compute_dtype=torch.float32)
    np.testing.assert_array_equal(out["cuda"]["_per_example_rows"], np.arange(len(ds)))
    for k in ("val_rmse_px", "val_median_corner_err_px", "val_p90_corner_err_px"):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], rtol=1e-4, err_msg=k)
