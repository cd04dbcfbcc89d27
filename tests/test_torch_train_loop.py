"""Port parity: the trainer's loop (perseus_tpu_torch/train/train.py::train,
train/checkpoint.py, init_state from a checkpoint, the EMA) against the
JAX package's, and its own contracts, mirroring tests/test_train.py and
the train-loop tests of tests/test_round4_features.py at their sizes
(32x32 frames, batch 8, 16 train and 8 test rows of
generate_synthetic_pruned_dataset).

Tolerances: resume, the epoch call against its steps and the host loader
against the device-resident split are bit for bit (the same arithmetic on
the CPU); the .pth round trips atol 0; the sample weights and row layout
are equal arrays.

The loop-level parity with JAX's train() (both from one .pth, every random
augmentation stage off, f32, lr 1e-5) holds the first step's loss to rel
1e-5 and the params to atol 1e-4, as test_torch_train_device_data.py
holds the epoch call; the later losses to rel 1e-3, the batch stats to
atol 1e-3 and the parameter updates by the share that parts by more than
lr. The loop needs more than the epoch test there because both trainers
start with fresh AdamW moments, whose first update of a parameter is
+-lr, the sign of its gradient, however small: on this fixture's flat
squares the two frameworks' gradient sums disagree in sign on 23,468 of
11.2M elements at the first step (118 on random pixels), and from the
second step the trajectories part: losses by 8e-5 relative after one step,
up to 3.5e-4 (the val loss) after four; the deepest BN layers (a 1x1 map,
8 values per batch) move their running stats by up to 4.9e-4; 0.23% of
the parameters' updates differ by more than lr (measured on the CPU).
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from perseus_tpu.augment.pipeline import AugmentationConfig as JAugConfig
from perseus_tpu.data.dataset import KeypointDatasetConfig as JDataConfig
from perseus_tpu.data.dataset import PrunedKeypointDataset as JDataset
from perseus_tpu.data.synthetic import generate_synthetic_pruned_dataset
from perseus_tpu.models import resnet as jresnet
from perseus_tpu.train import checkpoint as jckpt
from perseus_tpu.train import train as jtrain
from perseus_tpu.train.config import TrainConfig as JTrainConfig
from perseus_tpu_torch import ROOT
from perseus_tpu_torch.augment.pipeline import AugmentationConfig
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.models import convert
from perseus_tpu_torch.train import checkpoint as ckpt
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig

LR = 1e-5
LIGHT = dict(planckian_jitter=False, blur=False, random_plasma_shadow=False, color_jiggle=False)
OFF = dict(
    random_transplantation_with_depth=False, random_affine=False, random_erasing=False,
    planckian_jitter=False, color_jiggle=False, blur=False, random_plasma_shadow=False,
    random_bias=False, depth_gaussian_noise=False, random_near_plane=False, random_far_plane=False,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs several test
    processes side by side on the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    """Run ids whose checkpoint and log directories are removed after the file."""
    ids = []
    yield ids
    for run_id in ids:
        for kind in ("models", "runs"):
            shutil.rmtree(os.path.join(ROOT, "outputs", kind, run_id), ignore_errors=True)


@pytest.fixture(scope="module")
def dataset_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_root")
    return generate_synthetic_pruned_dataset(str(root), n_train=16, n_test=8, h=32, w=32)


@pytest.fixture(scope="module")
def tiny_cfg(dataset_path):
    """tests/test_train.py's tiny_cfg, in the port's config."""
    return TrainConfig(
        batch_size=8, learning_rate=1e-3, n_epochs=2,
        dataset_config=KeypointDatasetConfig(dataset_path=dataset_path),
        augmentation_config=AugmentationConfig(**LIGHT),
        in_channels=4, amp=False, save_epochs=1000, cache_dataset=True,
    )


def _train(cfg, runs):
    result = train.train(cfg, device="cpu")
    runs.append(result["run_id"])
    return result


def _run_dir(result):
    return os.path.join(ROOT, "outputs", "models", result["run_id"])


def _finite(tensors) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in tensors.values())


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_train_loop_end_to_end(tiny_cfg, runs):
    result = _train(tiny_cfg, runs)
    assert len(result["train_loss_history"]) == 2
    assert np.isfinite(result["final_train_loss"]) and np.isfinite(result["final_val_loss"])
    assert _finite(result["state"].params) and result["state"].opt_state.step == 4
    assert result["ema"] is None
    with open(os.path.join(ROOT, "outputs", "runs", result["run_id"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert sum("loss" in r for r in records) == 4 and sum("val_loss" in r for r in records) == 2


def test_checkpoint_roundtrip(tmp_path, tiny_cfg):
    opt = train.make_optimizer(tiny_cfg)
    state = train.init_state(tiny_cfg, opt, device="cpu")
    directory = str(tmp_path / "ckpt")
    ckpt.save_train_state(
        directory,
        {"params": state.params, "batch_stats": state.batch_stats, "opt_state": state.opt_state, "epoch": 3, "lr": 1e-4},
    )
    restored = ckpt.restore_train_state(directory)
    assert restored["epoch"] == 3 and restored["lr"] == 1e-4
    assert torch.equal(restored["params"]["conv1.weight"], state.params["conv1.weight"])
    assert isinstance(restored["opt_state"], train.AdamWState) and restored["opt_state"].step == 0
    assert _equal(restored["opt_state"].exp_avg, state.opt_state.exp_avg)
    assert os.listdir(directory) == [ckpt.STATE_FILE]  # the temporary name is gone
    loaded = ckpt.load_model(directory)
    assert "bn1.running_mean" in loaded and _equal(loaded, {**state.params, **state.batch_stats})


def test_pth_interop_roundtrip(tmp_path, tiny_cfg):
    """The port's export loads in JAX's load_model equal, and JAX's export
    in the port's, atol 0 both ways."""
    state = train.init_state(tiny_cfg, train.make_optimizer(tiny_cfg), device="cpu")
    path = str(tmp_path / "port.pth")
    ckpt.export_reference_pth(path, state.params, state.batch_stats)
    assert _equal(ckpt.load_model(path), {**state.params, **state.batch_stats})
    jparams, jstats = jckpt.load_model(path)
    assert _equal(convert.from_jax_params(jparams, jstats), {**state.params, **state.batch_stats})

    jcfg = JTrainConfig(in_channels=4)
    jstate = jtrain.init_state(jcfg, jtrain.make_optimizer(jcfg), jtrain.make_mesh(n_devices=1))
    jpath = str(tmp_path / "jax.pth")
    jckpt.export_reference_pth(jpath, jstate.params, jstate.batch_stats)
    host = jax.tree.map(np.asarray, (jstate.params, jstate.batch_stats))
    assert _equal(ckpt.load_model(jpath), convert.from_jax_params(*host))


def test_train_resume_continues(tiny_cfg, runs):
    first = _train(dataclasses.replace(tiny_cfg, n_epochs=1, save_epochs=1), runs)
    assert os.path.isfile(os.path.join(_run_dir(first), ckpt.STATE_FILE))
    resumed = _train(dataclasses.replace(tiny_cfg, n_epochs=2, resume=_run_dir(first)), runs)
    assert resumed["run_id"] == first["run_id"]  # the same run continues
    assert len(resumed["train_loss_history"]) == 1 and np.isfinite(resumed["final_train_loss"])
    diff = sum((a - first["state"].params[k]).abs().sum().item() for k, a in resumed["state"].params.items())
    assert diff > 0  # epoch 1 trained
    saved = ckpt.restore_train_state(_run_dir(first))
    assert saved["epoch"] == 0 and saved["opt_state"].step == 2
    assert saved["sched_best"] == first["final_val_loss"] and saved["sched_num_bad"] == 0


def test_train_resume_bit_identical(tiny_cfg, runs):
    """Two epochs straight, or one epoch, a checkpoint and a resumed second
    epoch: bit for bit the same params, batch stats, AdamW state, EMA and
    second-epoch losses (per-step generators from (seed, step), epoch
    orders from (seed, epoch), the scheduler's memory in the checkpoint)."""
    cfg = dataclasses.replace(tiny_cfg, ema_decay=0.5)
    straight = _train(cfg, runs)
    first = _train(dataclasses.replace(cfg, n_epochs=1, save_epochs=1), runs)
    resumed = _train(dataclasses.replace(cfg, resume=_run_dir(first)), runs)
    assert resumed["train_loss_history"] == straight["train_loss_history"][1:]
    assert resumed["final_val_loss"] == straight["final_val_loss"]
    a, b = straight["state"], resumed["state"]
    assert _equal(a.params, b.params) and _equal(a.batch_stats, b.batch_stats)
    assert a.opt_state.step == b.opt_state.step == 4 and a.opt_state.learning_rate == b.opt_state.learning_rate
    assert _equal(a.opt_state.exp_avg, b.opt_state.exp_avg) and _equal(a.opt_state.exp_avg_sq, b.opt_state.exp_avg_sq)
    for part in ("params", "batch_stats"):
        assert _equal(straight["ema"][part], resumed["ema"][part])


def test_profiler_trace_written_on_resume(tiny_cfg, runs, tmp_path):
    """profile_dir produces a trace on a resumed run too (the trace starts
    at this run's second step, not a global one)."""
    first = _train(dataclasses.replace(tiny_cfg, n_epochs=1, save_epochs=1), runs)
    prof_dir = str(tmp_path / "prof")
    _train(dataclasses.replace(tiny_cfg, resume=_run_dir(first), profile_dir=prof_dir, profile_steps=1), runs)
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
    assert traces, f"no profiler trace written under {prof_dir}"


def test_device_data_subset_refresh(tiny_cfg, runs, monkeypatch):
    """device_data_rows + device_data_refresh_epochs hold a rotating subset
    on the device: training runs end to end, the subset is redrawn at each
    window (freeing the old one first) and differs between windows."""
    uploads = []
    real = train._device_dataset
    monkeypatch.setattr(train, "_device_dataset", lambda ds, *a, **kw: uploads.append(kw.get("subset")) or real(ds, *a, **kw))
    cfg = dataclasses.replace(
        tiny_cfg, data_on_device=True, n_epochs=4, device_data_rows=8, device_data_refresh_epochs=2
    )
    result = _train(cfg, runs)
    assert np.isfinite(result["final_train_loss"]) and np.isfinite(result["final_val_loss"])
    train_subsets = [s for s in uploads if s is not None]  # the val split is uploaded whole
    assert len(train_subsets) == 2 and all(len(s) == 8 for s in train_subsets)
    assert not np.array_equal(*train_subsets)
    uploads.clear()
    _train(dataclasses.replace(cfg, n_epochs=2), runs)  # the same window draws the same subset
    assert np.array_equal(uploads[0], train_subsets[0])


def test_data_on_device_train_loop(tiny_cfg, runs):
    """The device-resident split trains end to end; its epoch in one call
    equals its steps one by one bit for bit, and on one card both take the
    host loader's steps (the epoch order of shard 0 is the loader's)."""
    cfg = dataclasses.replace(tiny_cfg, data_on_device=True)
    scan = _train(cfg, runs)
    assert np.isfinite(scan["final_train_loss"]) and np.isfinite(scan["final_val_loss"])
    per_step = _train(dataclasses.replace(cfg, device_data_epoch_scan=False), runs)
    host = _train(tiny_cfg, runs)
    for other in (per_step, host):
        assert other["train_loss_history"] == scan["train_loss_history"]
        assert other["final_val_loss"] == scan["final_val_loss"]
        assert _equal(other["state"].params, scan["state"].params)


def test_device_dataset_val_counts_each_row_once(tiny_cfg):
    """_device_dataset holds every row once, in order, in the port's layout;
    the val plan counts each real row exactly once."""
    ds = PrunedKeypointDataset(tiny_cfg.dataset_config, train=False, cache=True)
    d_imgs, d_crds, d_w, valid, n_local = train._device_dataset(ds, tiny_cfg, "cpu", use_transplant=False)
    assert d_imgs.shape == (len(ds), 4, 32, 32) and n_local == len(ds) and valid.sum() == len(ds)
    batch = ds.batch(np.arange(len(ds)))
    assert torch.equal(d_imgs, torch.from_numpy(train._prepare_aug_batch(batch, 4, False)))
    assert torch.equal(d_crds, torch.from_numpy(batch["pixel_coordinates"]))
    assert torch.equal(d_w, torch.from_numpy(batch["weight"]))
    counted = sum(float((mask * valid[idx]).sum()) for idx, mask in train.eval_index_batches(n_local, 3))
    assert counted == len(ds)
    bf16 = train._device_dataset(ds, dataclasses.replace(tiny_cfg, device_data_dtype="bfloat16"), "cpu", False)[0]
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, d_imgs.to(torch.bfloat16))


def test_init_backbone_head_copy(tiny_cfg, tmp_path):
    """init_backbone copies everything but fc.*; init_head=True extends the
    copy to the matching fc head; init_checkpoint takes the whole model; a
    backbone of another shape raises."""
    opt = train.make_optimizer(tiny_cfg)
    src = train.init_state(tiny_cfg, opt, device="cpu")
    ckpt_dir = str(tmp_path / "warm_src")
    ckpt.save_train_state(ckpt_dir, {"params": src.params, "batch_stats": src.batch_stats})
    fc_keys = [k for k in src.params if k.startswith("fc.")]
    assert fc_keys
    for init_head in (False, True):
        cfg = dataclasses.replace(tiny_cfg, random_seed=tiny_cfg.random_seed + 1, init_backbone=ckpt_dir, init_head=init_head)
        state = train.init_state(cfg, opt, device="cpu")
        assert torch.equal(state.params["conv1.weight"], src.params["conv1.weight"])
        assert _equal(state.batch_stats, src.batch_stats)
        assert all(torch.equal(state.params[k], src.params[k]) for k in fc_keys) == init_head
    whole = train.init_state(dataclasses.replace(tiny_cfg, random_seed=7, init_checkpoint=ckpt_dir), opt, device="cpu")
    assert _equal(whole.params, src.params) and whole.opt_state.step == 0
    with pytest.raises(ValueError, match="init_backbone shape mismatch at conv1.weight"):
        train.init_state(dataclasses.replace(tiny_cfg, in_channels=3, init_backbone=ckpt_dir), opt, device="cpu")


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(oversample_close=2.0, oversample_outframe=1.0, close_seg_threshold=0.2),
        dict(oversample_close=1.0, close_seg_threshold=0.05),
        dict(oversample_outframe=3.0, difficulty=True),
    ],
    ids=["uniform", "close_and_outframe", "close_low_threshold", "outframe_and_difficulty"],
)
def test_sample_weights_match_jax(dataset_path, tmp_path, kw):
    """make_sample_weights equals the JAX package's on the same dataset."""
    kw = dict(kw)
    if kw.pop("difficulty", False):
        dw = np.random.default_rng(0).uniform(0.5, 4.0, 16)
        kw["sample_weights_path"] = str(tmp_path / "w.npy")
        np.save(kw["sample_weights_path"], dw)
    port = train.make_sample_weights(
        PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=dataset_path)), TrainConfig(**kw)
    )
    ref = jtrain.make_sample_weights(JDataset(JDataConfig(dataset_path=dataset_path)), JTrainConfig(**kw))
    if ref is None:
        assert port is None
    else:
        assert port.dtype == ref.dtype and np.array_equal(port, ref)


@pytest.mark.parametrize(
    "n_dev, n_local, n_dataset, subset",
    [(1, 16, 16, None), (1, 10, 16, [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]), (8, 2, 16, None), (8, 2, 10, None),
     (8, 2, 16, [3, 1, 4, 1, 5, 9, 2, 6, 5, 3])],
)
def test_device_local_rows_match_jax(n_dev, n_local, n_dataset, subset):
    sub = None if subset is None else np.asarray(subset)
    assert np.array_equal(
        train._device_local_rows(n_dev, n_local, n_dataset, sub), jtrain._device_local_rows(n_dev, n_local, n_dataset, sub)
    )


def test_device_local_rows_layout(tiny_cfg):
    """_device_local_rows matches _device_dataset's layout on one card: the
    coords held at each position are the predicted row's, for the whole
    split and for a subset with repeats."""
    ds = PrunedKeypointDataset(tiny_cfg.dataset_config, train=True, cache=True)
    for subset in (None, np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3])):
        _, d_crds, _, _, n_local = train._device_dataset(ds, tiny_cfg, "cpu", use_transplant=False, subset=subset)
        rows = train._device_local_rows(1, n_local, len(ds), subset)[0]
        assert np.array_equal(d_crds.numpy(), ds.batch(rows)["pixel_coordinates"])


def test_ema_checkpoint_roundtrip(tiny_cfg, runs):
    cfg = dataclasses.replace(tiny_cfg, ema_decay=0.5, save_epochs=1)
    result = _train(cfg, runs)
    ema, state = result["ema"], result["state"]
    assert max((ema["params"][k] - v).abs().max().item() for k, v in state.params.items()) > 0  # the EMA lags
    assert _finite(ema["params"]) and _finite(ema["batch_stats"])
    saved = ckpt.restore_train_state(_run_dir(result))
    assert _equal(saved["ema_params"], ema["params"]) and _equal(saved["ema_batch_stats"], ema["batch_stats"])
    assert saved["epoch"] == 1


def test_distributed_is_refused(tiny_cfg):
    for kw in (dict(distributed=True), dict(coordinator_address="localhost:1234")):
        with pytest.raises(NotImplementedError, match="Queue A item 1.5"):
            train.train(dataclasses.replace(tiny_cfg, **kw), device="cpu")


def _logged(run_id: str, key: str) -> list[float]:
    with open(os.path.join(ROOT, "outputs", "runs", run_id, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def test_train_loop_matches_jax_from_one_pth(dataset_path, runs, tmp_path, monkeypatch):
    """JAX's init_state params through one .pth, both train()s from it
    (init_checkpoint), every random augmentation stage off, f32, 2 epochs of
    the same HDF5: the per-step and per-epoch train losses, the val losses,
    the final params, their updates and the batch stats (tolerances: the
    module's docstring)."""
    monkeypatch.setattr(jresnet, "MAXPOOL_CMP_VJP", True)  # g to every tie, as the port (flat squares tie)
    kw = dict(batch_size=8, learning_rate=LR, n_epochs=2, in_channels=4, amp=False, cache_dataset=True, multigpu=False)
    jcfg = JTrainConfig(dataset_config=JDataConfig(dataset_path=dataset_path), augmentation_config=JAugConfig(**OFF), **kw)
    init = jtrain.init_state(jcfg, jtrain.make_optimizer(jcfg), jtrain.make_mesh(n_devices=1))
    pth = str(tmp_path / "init.pth")
    jckpt.export_reference_pth(pth, init.params, init.batch_stats)

    ref = jtrain.train(dataclasses.replace(jcfg, init_checkpoint=pth))
    runs.append(ref["run_id"])
    cfg = TrainConfig(
        dataset_config=KeypointDatasetConfig(dataset_path=dataset_path),
        augmentation_config=AugmentationConfig(**OFF), init_checkpoint=pth, **kw,
    )
    got = _train(cfg, runs)

    steps, ref_steps = _logged(got["run_id"], "loss"), _logged(ref["run_id"], "loss")
    assert len(steps) == len(ref_steps) == 4
    np.testing.assert_allclose(steps[0], ref_steps[0], rtol=1e-5)  # the same first batch and init
    np.testing.assert_allclose(steps, ref_steps, rtol=1e-3)
    np.testing.assert_allclose(got["train_loss_history"], ref["train_loss_history"], rtol=1e-3)
    np.testing.assert_allclose(_logged(got["run_id"], "val_loss"), _logged(ref["run_id"], "val_loss"), rtol=1e-3)
    np.testing.assert_allclose(got["final_val_loss"], ref["final_val_loss"], rtol=1e-3)
    host = jax.tree.map(np.asarray, ref["state"])
    want = convert.from_jax_params(host.params, host.batch_stats)
    start = ckpt.load_model(pth)
    for k, v in got["state"].params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
    for k, v in got["state"].batch_stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-3, err_msg=k)
    n = parted = moved = 0
    for k, v in got["state"].params.items():
        update = v - start[k]
        n += update.numel()
        parted += int(((update - (want[k] - start[k])).abs() > LR).sum())
        moved += int((update.abs() > LR).sum())
    assert parted < 0.01 * n  # 0.23% measured
    assert moved > 0.1 * n  # four steps moved the params: the comparison is not vacuous (28% measured)
