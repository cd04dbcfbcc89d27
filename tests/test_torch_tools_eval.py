"""Port parity: tools/compute_difficulty_weights.py and
tools/eval_sensor_transfer.py against their scripts, each script's
``main()`` run in this process on the 16-row 32x32 synthetic fixture with
one ``.pth`` (a seeded ResNet-18, BN statistics perturbed so that the
eval-mode BN and its fold are not the identity), batch 8.

Tolerances: in f32 (the script's forward patched to f32, the port's
computed in f32) the difficulty errors and weights within rel 1e-5 and
both sensor-probe RMSEs within rel 1e-5 (the convolutions sum in another
order; measured under 4e-7); in bf16, the scripts' own dtype, within rel
1e-2 (measured: weights 2.7e-3, the normalized errors 4.3e-3, RMSEs
1.5e-5 and 2.8e-4: bf16 activations round at each conv output, where the
frameworks' f32 sums part by ulps). The camera-effect draws exact (the
same numpy stream on the same pixels), the frame counts equal. The port's
``train()`` takes the weights it wrote.
"""

import json
import os
import runpy
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu.data.dataset import KeypointDatasetConfig as JDataConfig
from perseus_tpu.data.dataset import PrunedKeypointDataset as JDataset
from perseus_tpu.data.synthetic import generate_synthetic_pruned_dataset as jsynthetic
from perseus_tpu.datagen import generate as jgenerate
from perseus_tpu.models import resnet as jresnet
from perseus_tpu_torch import ROOT
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig
from perseus_tpu_torch.models.resnet import KeypointCNN
from perseus_tpu_torch.tools import compute_difficulty_weights as cdw
from perseus_tpu_torch.tools import eval_sensor_transfer as est
from perseus_tpu_torch.train import checkpoint as ckpt
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools_eval")
    path = jsynthetic(str(root / "ds"), n_train=16, n_test=8, h=32, w=32)
    sd = KeypointCNN(8, 4, device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    gen = torch.Generator().manual_seed(6)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=gen)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + 1.5 * torch.rand(sd[k].shape, generator=gen)
    pth = str(root / "model.pth")
    ckpt.export_reference_pth(pth, {k: v for k, v in sd.items() if not train._is_stat(k)},
                              {k: v for k, v in sd.items() if train._is_stat(k)})
    return root, path, pth


def _run_script(name, argv, monkeypatch, f32=False):
    if f32:
        apply = jresnet.keypoint_cnn_apply
        monkeypatch.setattr(jresnet, "keypoint_cnn_apply",
                            lambda *a, **k: apply(*a, **{**k, "compute_dtype": jnp.float32}))
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(REPO, "scripts", f"{name}.py"), run_name="__main__")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_difficulty_weights_match_the_script(fixture, dtype, monkeypatch, capsys):
    root, path, pth = fixture
    want_path = str(root / f"weights_{dtype}_jax.npy")
    _run_script("compute_difficulty_weights", ["--dataset-path", path, "--checkpoint", pth, "--output", want_path,
                                               "--batch-size", str(B)], monkeypatch, f32=dtype == "f32")
    want_stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = np.load(want_path)
    cfg = cdw.DifficultyConfig(dataset_path=path, checkpoint=pth, output=str(root / f"weights_{dtype}.npy"),
                               batch_size=B)
    rel = 1e-5 if dtype == "f32" else 1e-2
    if dtype == "f32":
        errs = cdw.difficulty_errors(cfg, device="cpu", compute_dtype=torch.float32)
        got = cdw.difficulty_weights(errs, cfg.gain, cfg.w_max)
        np.testing.assert_allclose(errs.mean(), want_stats["err_mean"], rtol=rel)
    else:
        stats = cdw.compute_difficulty_weights(cfg, device="cpu")
        got = np.load(cfg.output)
        assert stats.keys() == want_stats.keys() and stats["rows"] == want_stats["rows"] == 16
        for k in ("err_mean", "err_p95", "w_mean"):
            np.testing.assert_allclose(stats[k], want_stats[k], rtol=rel, err_msg=k)
    assert got.dtype == want.dtype and got.shape == want.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=rel)
    assert got.min() >= 1.0 and got.max() <= cfg.w_max and np.ptp(got) > 0.1  # the rows weigh differently


def test_train_takes_the_weights(fixture):
    """The port's train() samples its epoch by the port's .npy."""
    root, path, pth = fixture
    cfg = cdw.DifficultyConfig(dataset_path=path, checkpoint=pth, batch_size=B)
    stats = cdw.compute_difficulty_weights(cfg, device="cpu")
    assert stats["output"] == str(root / "difficulty_weights.npy")  # beside the checkpoint
    tcfg = TrainConfig(batch_size=B, n_epochs=1, in_channels=4, amp=False, input_resolution=32, wandb_project="",
                       dataset_config=KeypointDatasetConfig(dataset_path=path), sample_weights_path=stats["output"])
    result = train.train(tcfg, device="cpu")
    try:
        assert np.isfinite(result["final_train_loss"]) and len(result["train_loss_history"]) == 1
    finally:
        for kind in ("models", "runs"):
            shutil.rmtree(os.path.join(ROOT, "outputs", kind, result["run_id"]), ignore_errors=True)


def test_camera_effect_draws_match_the_script(fixture):
    _, path, _ = fixture
    images = JDataset(JDataConfig(dataset_path=path), train=False).batch(np.arange(B))["image"]
    rng_j, rng_p = np.random.default_rng(0), np.random.default_rng(0)
    want = np.stack([jgenerate._apply_camera_effects(im[None], rng_j)[0] for im in images.astype(np.float32)])
    np.testing.assert_array_equal(est.sensor_images(images, rng_p), want)
    assert rng_j.random() == rng_p.random()  # the streams stay aligned


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sensor_transfer_matches_the_script(fixture, dtype, monkeypatch):
    root, path, pth = fixture
    out = str(root / f"sensor_{dtype}.json")
    amp = ["--amp", "false"] if dtype == "f32" else []
    _run_script("eval_sensor_transfer", ["--checkpoint", pth, "--dataset-path", path, "--batch-size", str(B),
                                         "--output", out] + amp, monkeypatch)
    with open(out) as f:
        want = json.loads(f.read())
    got = est.sensor_transfer(est.SensorTransferConfig(checkpoint=pth, dataset_path=path, batch_size=B,
                                                       amp=dtype == "bf16"), device="cpu")
    assert got.keys() == want.keys() and got["n_frames"] == want["n_frames"] == 8
    rel = 1e-5 if dtype == "f32" else 1e-2
    for k in ("clean_rmse_px", "sensor_rmse_px"):
        np.testing.assert_allclose(got[k], want[k], rtol=rel, err_msg=k)
    assert got["clean_rmse_px"] != got["sensor_rmse_px"]  # the sensor model moved the pixels
