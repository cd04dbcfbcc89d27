"""The port's trainer loop on the card: cuda-marked tests, which skip on a
host without one. No JAX here (the card's machine has none), and the
dataset is a decoded split (nor h5py and PIL); run there with
``python -m pytest tests/test_torch_train_loop_cuda.py -m cuda --noconftest``.

Both compare runs under cuDNN's deterministic algorithms, bit for bit: the
loop's own arithmetic is deterministic (per-step generators from (seed,
step), epoch orders from (seed, epoch)), and cuDNN's backward is the one
part that is not promised to be otherwise.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from perseus_tpu_torch import ROOT
from perseus_tpu_torch.augment.pipeline import AugmentationConfig
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig
from perseus_tpu_torch.data.synthetic import generate_synthetic_decoded_split
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    """tests/test_torch_train_loop.py's tiny_cfg, on the same rows as a
    decoded split; the runs' directories are removed after the file."""
    path = generate_synthetic_decoded_split(str(tmp_path_factory.mktemp("cuda_split")), 16, 8, 32, 32)
    aug = AugmentationConfig(planckian_jitter=False, blur=False, random_plasma_shadow=False, color_jiggle=False)
    cfg = TrainConfig(
        batch_size=8, learning_rate=1e-3, n_epochs=2, dataset_config=KeypointDatasetConfig(dataset_path=path),
        augmentation_config=aug, in_channels=4, amp=False, save_epochs=1000, ema_decay=0.5,
    )
    runs = []
    yield cfg, runs
    for run_id in runs:
        for kind in ("models", "runs"):
            shutil.rmtree(os.path.join(ROOT, "outputs", kind, run_id), ignore_errors=True)


def _deterministic_runs(cfgs, runs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        results = []
        for cfg in cfgs:
            results.append(train.train(cfg if not callable(cfg) else cfg(results)))
            runs.append(results[-1]["run_id"])
    finally:
        torch.backends.cudnn.deterministic = old
    return results


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
def test_cuda_train_loop_and_resume(tiny_cfg):
    """The host-loader loop end to end on the card, and two epochs straight
    against one epoch, a checkpoint and a resumed second epoch."""
    cfg, runs = tiny_cfg
    straight, first, resumed = _deterministic_runs([
        cfg,
        dataclasses.replace(cfg, n_epochs=1, save_epochs=1),
        lambda done: dataclasses.replace(cfg, resume=os.path.join(ROOT, "outputs", "models", done[1]["run_id"])),
    ], runs)
    assert all(v.is_cuda for v in straight["state"].params.values())
    assert np.isfinite(straight["final_train_loss"]) and np.isfinite(straight["final_val_loss"])
    assert resumed["run_id"] == first["run_id"] and resumed["state"].opt_state.step == 4
    assert resumed["train_loss_history"] == straight["train_loss_history"][1:]
    assert _equal(resumed["state"].params, straight["state"].params)
    assert _equal(resumed["ema"]["params"], straight["ema"]["params"])


@pytest.mark.cuda
def test_cuda_device_data_train_loop(tiny_cfg):
    """The device-resident split on the card: its epoch in one call and
    step by step take the host loader's steps."""
    cfg, runs = tiny_cfg
    scan, per_step, host = _deterministic_runs([
        dataclasses.replace(cfg, data_on_device=True),
        dataclasses.replace(cfg, data_on_device=True, device_data_epoch_scan=False),
        cfg,
    ], runs)
    assert np.isfinite(scan["final_val_loss"])
    for other in (per_step, host):
        assert other["train_loss_history"] == scan["train_loss_history"]
        assert _equal(other["state"].params, scan["state"].params)
