"""Port parity: tools/train_at_scale.py's ``val_rmse_px``,
``failure_breakdown`` and ``main`` against scripts/train_at_scale.py.

The script's module-level functions are imported from it; its
``val_rmse_px`` runs on a one-device mesh, the port's on one device, both
over the val split of the 16-row 32x32 synthetic fixture stored
device-resident in bf16 (the script's ``data_dtype``), from one seeded
state with perturbed BN statistics. On the tests' 8-device mesh the
script's ``val_rmse_px`` scores the wrong rows: it gathers shard-local
indices (``s * local_bs + i``, the same on every device) from the global
array with ``jnp.take`` under ``jit``, so each device scores the split's
first rows again, under other rows' ids. The port does not copy that; a
test pins the script's behaviour there against the port's rows.

Tolerances: in f32 (both forwards patched to f32) the RMSE, median and
p90 within rel 1e-5 and the per-example RMSEs, matched by row id, within
rel 1e-4 (the convolutions sum in another order); in bf16, the scripts'
own dtype, within rel 2e-2 (measured: the RMSE 2.4e-4, the median
2.0e-3, the p90 5.3e-4, per example up to 3.3e-3; in f32 all under
1.1e-6: bf16 activations round at each conv output, where the two
frameworks' f32 sums part by ulps); the row ids equal.
``failure_breakdown`` exact on the same inputs. ``main`` end to end on
the CPU (batch 8, 1 epoch, EMA, holdout and pose jobs, the HDF5 route on
port-rendered 32x32 jobs): the JAX script's metrics keys and no error
key.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu.data.dataset import KeypointDatasetConfig as JDataConfig
from perseus_tpu.data.dataset import PrunedKeypointDataset as JDataset
from perseus_tpu.data.synthetic import generate_synthetic_pruned_dataset as jsynthetic
from perseus_tpu.models import resnet as jresnet
from perseus_tpu.train import train as jtrain
from perseus_tpu.train.config import TrainConfig as JTrainConfig
from perseus_tpu_torch import ROOT
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.datagen.generate import VideoConfig, generate_one_video
from perseus_tpu_torch.models import convert
from perseus_tpu_torch.tools import train_at_scale as tas
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
# scripts/train_at_scale.py:284-388: metrics.json with the EMA, holdout and pose parts
SCALE_KEYS = {
    "val_rmse_px", "val_median_corner_err_px", "val_p90_corner_err_px", "other_variant_rmse_px",
    "val_rmse_in_frame_px", "val_oof_frame_rate", "val_loss", "train_loss", "epochs", "n_train", "n_val",
    "train_wall_s", "image_hw", "failure_breakdown", "holdout_style_rmse_px", "holdout_style_median_corner_err_px",
    "holdout_style_n_frames", "pose_rmse_mm", "pose_rmse_deg", "pose_median_mm", "pose_median_deg",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jscale():
    spec = importlib.util.spec_from_file_location("_script_train_at_scale",
                                                  os.path.join(REPO, "scripts", "train_at_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The fixture split, a JAX state with perturbed BN statistics and its
    port conversion."""
    path = jsynthetic(str(tmp_path_factory.mktemp("scale_val")), n_train=16, n_test=8, h=32, w=32)
    params, stats = jresnet.init_keypoint_cnn(jax.random.key(7), 8, 4)
    rng = np.random.default_rng(7)
    stats = {k: (rng.uniform(0.5, 2.0, v.shape) if k.endswith("var") else rng.normal(0, 0.1, v.shape))
             for k, v in stats.items()}
    params, stats = ({k: np.asarray(v, np.float32) for k, v in t.items()} for t in (params, stats))
    sd = convert.from_jax_params(params, stats)
    state = train.TrainState({k: sd[k] for k in params}, {k: sd[k] for k in stats}, None)
    return path, (params, stats), state


def _f32_forward(monkeypatch):
    apply = jresnet.keypoint_cnn_apply
    monkeypatch.setattr(jresnet, "keypoint_cnn_apply",
                        lambda *a, **k: apply(*a, **{**k, "compute_dtype": jnp.float32}))


def _script_val(jscale, path, params, stats, dtype, n_devices):
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "f32":
            _f32_forward(mp)
        jcfg = JTrainConfig(batch_size=B, in_channels=4, device_data_dtype="bfloat16",
                            dataset_config=JDataConfig(dataset_path=path))
        mesh = jtrain.make_mesh(True, n_devices=n_devices)
        jds = JDataset(jcfg.dataset_config, train=False, cache=False)
        dd = jtrain._device_dataset(jds, jcfg, mesh, use_transplant=False)
        state = jtrain.TrainState({k: jnp.asarray(v) for k, v in params.items()},
                                  {k: jnp.asarray(v) for k, v in stats.items()}, None)
        return jscale.val_rmse_px(state, jcfg, mesh, dd), jds


@pytest.fixture(scope="module")
def runs(setup, jscale):
    """{dtype: (the script's val_rmse_px on one device, the port's, (the
    script's dataset, the port's))} on the same split and state."""
    path, (params, stats), state = setup
    tcfg = TrainConfig(batch_size=B, in_channels=4, device_data_dtype="bfloat16",
                       dataset_config=KeypointDatasetConfig(dataset_path=path))
    ds = PrunedKeypointDataset(tcfg.dataset_config, train=False)
    dd = train._device_dataset(ds, tcfg, "cpu", use_transplant=False)
    out = {}
    for dtype, tdtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        want, jds = _script_val(jscale, path, params, stats, dtype, 1)
        out[dtype] = want, tas.val_rmse_px(state, tcfg, dd, compute_dtype=tdtype), (jds, ds)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_val_rmse_px_matches_the_script(runs, dtype):
    want, got, _ = runs[dtype]
    rel, rel_row = (1e-5, 1e-4) if dtype == "f32" else (2e-2, 2e-2)
    assert got.keys() == want.keys()
    for k in ("val_rmse_px", "val_median_corner_err_px", "val_p90_corner_err_px"):
        np.testing.assert_allclose(got[k], want[k], rtol=rel, err_msg=k)
    order_got, order_want = np.argsort(got["_per_example_rows"]), np.argsort(want["_per_example_rows"])
    np.testing.assert_array_equal(got["_per_example_rows"][order_got], np.arange(8))
    np.testing.assert_array_equal(want["_per_example_rows"][order_want], np.arange(8))
    np.testing.assert_allclose(got["_per_example_rmse"][order_got], want["_per_example_rmse"][order_want],
                               rtol=rel_row)


def test_script_scores_the_first_rows_again_on_the_8_device_mesh(setup, jscale, runs):
    """The script's fault on a mesh of several devices, which the port does
    not copy: with a batch of 8 over 8 devices (one row a device), every
    device scores row 0, labelled as rows 0-7 (f32)."""
    path, (params, stats), _ = setup
    want_one_device, got, _ = runs["f32"]
    eight, _ = _script_val(jscale, path, params, stats, "f32", 8)
    np.testing.assert_array_equal(np.sort(eight["_per_example_rows"]), np.arange(8))
    row0 = want_one_device["_per_example_rmse"][want_one_device["_per_example_rows"] == 0][0]
    np.testing.assert_allclose(eight["_per_example_rmse"], np.full(8, row0), rtol=1e-5)
    assert np.ptp(got["_per_example_rmse"]) > 1e-3 * row0  # the port scores eight different rows


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_failure_breakdown_matches_the_script(runs, jscale, dtype):
    """The same inputs through both: the script's per-example stats and
    each package's dataset object of the split."""
    want, _, (jds, ds) = runs[dtype]
    got = tas.failure_breakdown(ds, want, ds.H, ds.W)
    assert got == jscale.failure_breakdown(jds, want, jds.H, jds.W)
    assert sum(v["n"] for k, v in got.items() if k.startswith("corners_")) == 8


def test_main_end_to_end_on_the_cpu(tmp_path):
    """The script's body over job directories (the HDF5 route: label, merge,
    prune), batch 8, 1 epoch, the EMA promoted or not, the holdout-style
    jobs and a pose job of 13 frames (the script's window 12 scores one):
    metrics.json with the JAX script's keys, no error key, and the final
    checkpoint written."""
    vcfg = VideoConfig(resolution=32, frames=8)
    for kind, n, style in (("jobs", 5, "train"), ("holdout", 2, "holdout")):
        for i in range(n):
            generate_one_video(dataclasses.replace(vcfg, job_dir=str(tmp_path / kind), style=style), f"{i:08x}",
                               device="cpu")
    pose_job = generate_one_video(dataclasses.replace(vcfg, job_dir=str(tmp_path / "pose"), frames=13, seed=3),
                                  "00000000", device="cpu")
    cfg = tas.ScaleRunConfig(
        job_dir=str(tmp_path / "jobs"), data_root=str(tmp_path / "data"), output_dir=str(tmp_path / "model"),
        frames=8, epochs=1, batch_size=B, ema_decay=0.5, holdout_job_dir=str(tmp_path / "holdout"),
        pose_eval_job=pose_job,
    )
    out = tas.train_at_scale(cfg, device="cpu")
    try:
        m = out["metrics"]
        assert not [k for k in m if k.endswith("_error")], m
        assert set(m) == SCALE_KEYS
        with open(tmp_path / "model" / "metrics.json") as f:
            assert json.load(f).keys() == m.keys()
        assert m["epochs"] == 1 and m["image_hw"] == [32, 32] and m["n_train"] >= B
        assert np.isfinite(m["val_rmse_px"]) and np.isfinite(m["holdout_style_rmse_px"])
        assert os.path.isfile(tmp_path / "model" / "final" / "train_state.pt")
        assert os.path.isfile(tmp_path / "data" / "holdout" / "pruned" / "pruned.hdf5")
    finally:
        for kind in ("models", "runs"):
            shutil.rmtree(os.path.join(ROOT, "outputs", kind, out["run_id"]), ignore_errors=True)
