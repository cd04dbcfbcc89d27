"""Port parity: the evaluation tools (perseus_tpu_torch/eval/{parity,
torch_oracle,validate_real,visualize}.py and models/convert.py's
to_reference_sd) against the JAX package's, on the CPU, at the 32x32 fixture
shapes of tests/test_parity_training.py and tests/test_pipeline_eval.py.

Tolerances:
  * run_parity: the oracle half is the same torch code from the same init on
    the same batches, so its val RMSE and losses agree to rel 1e-5 (they are
    equal at one thread count). The port's model against JAX's: two
    free-running AdamW trajectories from fresh moments, which part after the
    first step (the first update is +-lr by each gradient's sign; ROADMAP.md
    Queue C). Measured on the fixture (2 epochs, batch 8): val RMSE ratio
    port / JAX 1.0148, final losses 9.3% apart; held to a ratio of
    0.95-1.05 and to the JAX test's own 20% on the loss. The port alone, as
    the JAX test holds JAX: a ratio of 0.8-1.25 against the oracle, 20% on
    the loss, round-trip logits 1e-5;
  * predict_real against jax.image.resize + center_crop_hw +
    keypoint_cnn_apply_folded + denormalize in f32: the resized crop 1e-5,
    the keypoints 1e-3 px, on an image that grows and one that shrinks;
  * the augmentation grid's computation: exact against JAX's val-mode
    pipeline. In train mode on shared draws (tests/test_torch_augment.py):
    RGB, segmentation and keypoints within 1e-5, depth within 5e-5. Each
    framework builds the affine matrices from the draws, ulps apart, which
    moves a sample by ~1e-6 px; across the fixture's depth steps (up to ~14
    units between neighbours: depth 3.6-14 beside erased or out-of-frame
    zeros) that moved depth by up to 3.2e-5 in the measured draws. The
    kernels alone, on the same matrices, agree to 2.9e-6 on that depth.
"""

import dataclasses
import functools
import os
import shutil
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu import camera as jcam
from perseus_tpu.augment.pipeline import AugmentationConfig as JAugConfig
from perseus_tpu.augment.pipeline import KeypointAugmentation as JAug
from perseus_tpu.data.dataset import KeypointDatasetConfig as JDatasetConfig
from perseus_tpu.data.synthetic import generate_synthetic_pruned_dataset
from perseus_tpu.eval import parity as jparity
from perseus_tpu.eval import torch_oracle as jtorch_oracle
from perseus_tpu.eval import validate_real as jvalidate_real
from perseus_tpu.eval import visualize as jvisualize
from perseus_tpu.models import convert as jconvert
from perseus_tpu.models import resnet as jresnet
from perseus_tpu_torch import ROOT
from perseus_tpu_torch.augment.pipeline import AugmentationConfig
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.eval import parity, torch_oracle, validate_real, visualize
from perseus_tpu_torch.models import convert, resnet
from tests.test_torch_augment import _jax_draws

LIGHT = dict(planckian_jitter=False, blur=False, random_plasma_shadow=False, color_jiggle=False)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_tools")
    generate_synthetic_pruned_dataset(str(root), n_train=24, n_test=8, h=32, w=32)
    return str(root)


@pytest.fixture(scope="module")
def hdf5(synth_root):
    return os.path.join(synth_root, "data", "synth", "pruned.hdf5")


@pytest.fixture(scope="module")
def jax_parity(hdf5):
    """JAX's run_parity, its maxpool gradient routed to every tie as the
    port's (XLA's CPU select-and-scatter picks one argmax)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jresnet, "MAXPOOL_CMP_VJP", True)
        return jparity.run_parity(jparity.ParityConfig(dataset_path=hdf5, batch_size=8, epochs=2))


@functools.lru_cache(maxsize=None)
def _port_parity(hdf5: str, augmented: bool) -> dict:
    return parity.run_parity(parity.ParityConfig(dataset_path=hdf5, batch_size=8, epochs=2, augmented=augmented),
                             device="cpu")


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_parity_matches_jax_run_parity(hdf5, jax_parity):
    port = _port_parity(hdf5, False)
    assert set(port) == (set(jax_parity) - {"jax_val_rmse_px"}) | {"port_val_rmse_px"}
    # the oracle half: the same torch code, init and batches
    assert _rel(port["torch_val_rmse_px"], jax_parity["torch_val_rmse_px"]) <= 1e-5
    assert _rel(port["final_losses"][0], jax_parity["final_losses"][0]) <= 1e-5
    # the port's model against JAX's model
    assert 0.95 < port["port_val_rmse_px"] / jax_parity["jax_val_rmse_px"] < 1.05, (port, jax_parity)
    assert _rel(port["final_losses"][1], jax_parity["final_losses"][1]) < 0.2, (port, jax_parity)
    assert port["roundtrip_logits_max_abs_diff"] < 1e-5
    assert (port["n_train"], port["n_val"], port["epochs"]) == (24, 8, 2)


@pytest.mark.parametrize("augmented", [False, True])
def test_parity_alone_tracks_the_oracle(hdf5, augmented):
    """The JAX test's bounds (tests/test_parity_training.py), with and
    without the augmentation in the loop; the global RNG and the TF32 flags
    are as they were."""
    if augmented:  # the run below must leave these as it found them
        rng_before = torch.get_rng_state()
        old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    try:
        result = _port_parity(hdf5, augmented)
        if augmented:
            assert torch.equal(torch.get_rng_state(), rng_before)
            assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        if augmented:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    assert result["augmented"] is augmented
    assert 0.8 < result["rmse_ratio"] < 1.25, result
    t_loss, p_loss = result["final_losses"]
    assert abs(t_loss - p_loss) < 0.2 * max(t_loss, 1e-6), result
    assert result["roundtrip_logits_max_abs_diff"] < 1e-5, result


def test_torch_oracle_is_the_jax_packages():
    """Same module tree, state-dict keys and init for a seed, same logits."""
    torch.manual_seed(5)
    ours = torch_oracle.TorchKeypointCNN(n_keypoints=8, num_channels=4)
    torch.manual_seed(5)
    theirs = jtorch_oracle.TorchKeypointCNN(n_keypoints=8, num_channels=4)
    a, b = ours.state_dict(), theirs.state_dict()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    x = torch.rand((2, 4, 32, 32), generator=torch.Generator().manual_seed(1))
    ours.eval(), theirs.eval()
    with torch.no_grad():
        assert torch.equal(ours(x), theirs(x))


def _perturbed_sd(num_channels: int, seed: int) -> dict:
    """A random-init port state dict with BN statistics moved off 0 / 1."""
    gen = torch.Generator().manual_seed(seed)
    sd = resnet.KeypointCNN(n_keypoints=8, num_channels=num_channels, device="cpu", generator=gen).state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=gen)
    return sd


def test_to_reference_sd_matches_jax_export_and_round_trips():
    sd = _perturbed_sd(4, seed=2)
    ref = convert.to_reference_sd(sd)
    params, stats = jconvert.from_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    jref = jconvert.to_torch_state_dict(params, stats)
    assert set(ref) == set(jref)
    for k, v in jref.items():
        assert ref[k].dtype == (torch.int64 if k.endswith("num_batches_tracked") else torch.float32), k
        np.testing.assert_array_equal(ref[k].numpy(), v, err_msg=k)
    back = convert.normalize_reference_sd(ref)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    # into the stock model: equal logits within 1e-5
    oracle = torch_oracle.TorchKeypointCNN(n_keypoints=8, num_channels=4)
    oracle.load_state_dict(ref)
    oracle.eval()
    x = torch.rand((3, 4, 32, 32), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        port, _ = resnet.keypoint_cnn_apply(sd, x)
        assert (oracle(x) - port).abs().max().item() < 1e-5


_jax_folded_forward = jax.jit(lambda f, x: jresnet.keypoint_cnn_apply_folded(f, x, compute_dtype=jnp.float32))


@pytest.mark.parametrize("hw", [(24, 40), (90, 160)], ids=["grows", "shrinks"])
def test_predict_real_matches_jax(hw):
    """57 rows (1.8 x 32): 24x40 grows to 57x95, 90x160 shrinks to 57x101."""
    h, w = hw
    image = np.random.default_rng(h).uniform(0, 1, (h, w, 3)).astype(np.float32)
    params, stats = jresnet.init_keypoint_cnn(jax.random.key(3), 8, 3)
    stats = {k: (v + 0.1 if "mean" in k else v * 1.5).astype(jnp.float32) for k, v in stats.items()}
    params = {k: v.astype(jnp.float32) for k, v in params.items()}
    jfolded = jresnet.fold_batchnorm(params, stats)
    rows = int(1.8 * 32)
    cols = max(int(round(w * rows / h)), rows)
    jcrop = jcam.center_crop_hw(jax.image.resize(jnp.asarray(image), (rows, cols, 3), method="bilinear"), 32, 32)
    jpred = _jax_folded_forward(jfolded, jcrop[None])
    jkp = np.asarray(jcam.denormalize_pixel_coordinates(jpred.reshape(-1, 2), 32, 32))

    cfg = validate_real.ValConfig(amp=False, model_h=32, model_w=32)
    folded = resnet.fold_batchnorm(convert.from_jax_params(params, stats))
    crops, kps = validate_real.predict_real(folded, [image, image], cfg, device="cpu")
    assert crops.shape == (2, 32, 32, 3) and kps.shape == (2, 8, 2)
    np.testing.assert_allclose(crops[0].numpy(), np.asarray(jcrop, np.float32), atol=1e-5, rtol=0)
    np.testing.assert_allclose(kps[0].numpy(), jkp, atol=1e-3, rtol=0)
    assert torch.equal(kps[0], kps[1])
    # a model-sized image is taken as it is
    square = np.random.default_rng(0).uniform(0, 1, (32, 32, 3)).astype(np.float32)
    same, _ = validate_real.predict_real(folded, [square], cfg, device="cpu")
    assert torch.equal(same[0], torch.from_numpy(square))


def test_validate_writes_the_jax_file_names(synth_root, tmp_path):
    """Both writers on the same PNG directory, every 4th image, from one
    .pth: the same overlay names and the GIF."""
    img_dir = os.path.join(synth_root, "data", "synth", "train")
    tag = uuid.uuid4().hex[:8]
    paths = {side: str(tmp_path / f"vr_{side}_{tag}.pth") for side in ("port", "jax")}
    sd = convert.to_reference_sd(_perturbed_sd(3, seed=4))
    for p in paths.values():
        torch.save(sd, p)
    common = dict(in_channels=3, save_every=4, amp=False, model_h=32, model_w=32)
    try:
        ours = validate_real.validate(
            validate_real.ValConfig(model_path=paths["port"], dataset_cfg=KeypointDatasetConfig(dataset_path=img_dir),
                                    **common), device="cpu")
        theirs = jvalidate_real.validate(
            jvalidate_real.ValConfig(model_path=paths["jax"], dataset_cfg=JDatasetConfig(dataset_path=img_dir),
                                     **common))
        assert len(ours) >= 2
        assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
        for p in ours:
            assert os.path.isfile(p)
        assert os.path.isfile(os.path.join(os.path.dirname(ours[0]), "real", "val.gif"))
    finally:
        for side in paths:
            shutil.rmtree(os.path.join(ROOT, "outputs", "figures", f"vr_{side}_{tag}"), ignore_errors=True)


def test_visualize_tools_write_their_files(hdf5, tmp_path):
    cfg = visualize.VisualizeConfig(
        dataset_config=KeypointDatasetConfig(dataset_path=hdf5),
        augmentation_config=AugmentationConfig(**LIGHT),
        num_images=4,
        output_dir=str(tmp_path / "viz"),
    )
    for out in (visualize.visualize_data(cfg), visualize.visualize_augmentations(cfg, device="cpu"),
                visualize.visualize_segmentation_ratios(cfg)):
        assert os.path.isfile(out)
    assert os.path.isfile(tmp_path / "viz" / "segmentation_ratio_buckets.png")
    assert sorted(os.listdir(tmp_path / "viz")) == sorted(
        ["data_grid.png", "augmentations_grid.png", "segmentation_ratios.png", "segmentation_ratio_buckets.png"]
    )
    # the JAX package's fields and scalar defaults
    ours, theirs = visualize.VisualizeConfig(), jvisualize.VisualizeConfig()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert (ours.train, ours.num_images, ours.seed, ours.output_dir) == (
        theirs.train, theirs.num_images, theirs.seed, theirs.output_dir)


def _batch(hdf5, n=4):
    ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=hdf5), train=True)
    return ds.batch(np.arange(n))


def _jax_grid(batch, cfg, train, key):
    """What the JAX package's visualize_augmentations computes for its plot."""
    images = np.concatenate(
        [batch["image"], batch["depth_image"][..., None], batch["segmentation_image"][..., None]], axis=-1
    ).astype(np.float32)
    coords = np.asarray(batch["pixel_coordinates"], np.float32)
    out, crd = JAug(cfg, train=train, fused=True)(key, jnp.asarray(images), jnp.asarray(coords))
    h, w = images.shape[1:3]
    return np.asarray(out, np.float32), np.asarray(jcam.denormalize_pixel_coordinates(
        np.asarray(crd, np.float32).reshape(len(images), -1, 2), h, w))


def test_augment_batch_val_mode_matches_jax(hdf5):
    batch = _batch(hdf5)
    cfg = visualize.VisualizeConfig(train=False)
    images, coords = visualize.augment_batch(batch, cfg, device="cpu")
    ref_images, ref_coords = _jax_grid(batch, JAugConfig(), False, jax.random.key(0))
    assert images.shape == (4, 32, 32, 5)
    np.testing.assert_array_equal(images.numpy(), ref_images)
    np.testing.assert_array_equal(coords.numpy(), ref_coords)


def test_augment_batch_train_mode_matches_jax_on_shared_draws(hdf5):
    """The default config's train mode on a 5-channel square batch: the
    fused ultra branch (the CUDA kernel on the card, its plain version here)."""
    batch = _batch(hdf5)
    key = jax.random.key(7)
    with jax.enable_x64(False):  # JAX's own draws in f32, as the port's
        ref_images, ref_coords = _jax_grid(batch, JAugConfig(), True, key)
        draws = _jax_draws(key, JAugConfig(), 4, 32, 32, 5)
    images, coords = visualize.augment_batch(batch, visualize.VisualizeConfig(), device="cpu", draws=draws)
    rgb_seg = [0, 1, 2, 4]
    np.testing.assert_allclose(images.numpy()[..., rgb_seg], ref_images[..., rgb_seg], atol=1e-5, rtol=0)
    np.testing.assert_allclose(images.numpy()[..., 3], ref_images[..., 3], atol=5e-5, rtol=0)
    np.testing.assert_allclose(coords.numpy(), ref_coords, atol=1e-5, rtol=0)
    # drawn from cfg.seed when no draws are given: reproducible
    a, _ = visualize.augment_batch(batch, visualize.VisualizeConfig(), device="cpu")
    b, _ = visualize.augment_batch(batch, visualize.VisualizeConfig(), device="cpu")
    assert torch.equal(a, b) and torch.isfinite(a).all()
