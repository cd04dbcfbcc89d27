"""Port parity: the dataset reader (perseus_tpu_torch/data: schema,
dataset, synthetic) against the JAX package's, mirroring tests/test_data.py
at its sizes (24x24 frames, 12 train and 6 test rows of
generate_synthetic_pruned_dataset).

Tolerance: none. The port's fixture writer writes the JAX fixture's files
byte for byte; on the same HDF5 the two readers give equal metadata and
bit-equal rows, and so do the port's compact cache, its decoded split
written straight from the same draws, and the decoded split converted
from the HDF5; epoch orders are equal arrays.
"""

import filecmp
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from perseus_tpu.data import schema as jschema
from perseus_tpu.data.dataset import KeypointDatasetConfig as JDataConfig
from perseus_tpu.data.dataset import PrefetchingLoader as JLoader
from perseus_tpu.data.dataset import PrunedKeypointDataset as JDataset
from perseus_tpu.data.synthetic import generate_synthetic_pruned_dataset as jgenerate
from perseus_tpu_torch.data import schema
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrefetchingLoader, PrunedKeypointDataset
from perseus_tpu_torch.data.synthetic import generate_synthetic_decoded_split, generate_synthetic_pruned_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META_KEYS = ("pixel_coordinates", "asset_ids", "segmentation_ratios", "weights")
NAME_KEYS = ("image_filenames", "depth_filenames", "segmentation_filenames")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    jpath = jgenerate(str(root / "jax"), n_train=12, n_test=6, h=24, w=24)
    return {
        "jax": jpath,
        "port": generate_synthetic_pruned_dataset(str(root / "port"), n_train=12, n_test=6, h=24, w=24),
        "decoded": generate_synthetic_decoded_split(str(root / "decoded"), n_train=12, n_test=6, h=24, w=24),
        "converted": schema.decode_pruned_dataset(jpath, str(root / "converted")),
    }


def test_fixture_writer_matches_jax_byte_for_byte(paths):
    jdir, pdir = (os.path.dirname(paths[k]) for k in ("jax", "port"))
    names = sorted(os.path.relpath(os.path.join(d, f), jdir) for d, _, fs in os.walk(jdir) for f in fs)
    assert len(names) == 3 * 18 + 1
    for name in names:
        if not name.endswith(".hdf5"):
            assert filecmp.cmp(os.path.join(jdir, name), os.path.join(pdir, name), shallow=False), name
    for train in (True, False):
        (js, ja), (ps, pa) = (jschema.read_pruned_split(paths[k], train=train) for k in ("jax", "port"))
        assert ja == pa
        for k in NAME_KEYS:
            assert getattr(js, k) == getattr(ps, k)
        for k in META_KEYS:
            a, b = getattr(js, k), getattr(ps, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("source", ["hdf5", "hdf5_cached", "decoded", "converted"])
def test_rows_and_metadata_match_jax_reader(paths, source, train):
    """The JAX reader on the HDF5 against the port's reader on each of its
    sources: the same attrs, metadata and rows, bit for bit, row by row and
    as batches."""
    ref = JDataset(JDataConfig(dataset_path=paths["jax"]), train=train)
    path = paths["jax"] if source.startswith("hdf5") else paths[source]
    ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=path), train=train, cache=source == "hdf5_cached")
    assert (len(ds), ds.H, ds.W, ds.num_keypoints) == (len(ref), ref.H, ref.W, ref.num_keypoints) == (
        12 if train else 6, 24, 24, 8)
    for k in NAME_KEYS:
        assert getattr(ds.split, k) == getattr(ref.split, k)
    for k in META_KEYS:
        a, b = getattr(ds.split, k), getattr(ref.split, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    idx = np.random.default_rng(1).permutation(len(ref))
    for got, want in [(ds.batch(idx), ref.batch(idx)), (ds[3], ref[3])]:
        assert got.keys() == want.keys()
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype and np.array_equal(got[k], want[k]), k
    item = ds[0]  # the segmentation is binarized by asset id; a keypoint corner lies on the square
    assert set(np.unique(item["segmentation_image"])) == {0.0, 1.0}
    kp = item["pixel_coordinates"][0]
    assert item["segmentation_image"][int(kp[1]), int(kp[0])] == 1.0


class _FakeLen:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize(
    "n, kw",
    [
        (12, dict(batch_size=4, seed=0)),
        (10, dict(batch_size=4, seed=3)),
        (10, dict(batch_size=2, seed=0, shard_index=1, num_shards=2)),
        (10, dict(batch_size=4, seed=0, shuffle=False, drop_last=False)),
        (16, dict(batch_size=4, seed=5, sample_weights="hot")),
        (10, dict(batch_size=2, seed=5, shard_index=0, num_shards=3, sample_weights="hot")),
    ],
    ids=["permutation", "wrap_padded", "two_shards", "eval_order", "weighted", "weighted_three_shards"],
)
def test_epoch_indices_match_jax(n, kw):
    """The same epoch orders and batch counts as the JAX loader, for seeds,
    shards, wrap-padding, the eval order and weighted draws."""
    kw = dict(kw)
    if kw.get("sample_weights") == "hot":
        w = np.ones(n)
        w[:2] = 50.0
        kw["sample_weights"] = w
    port, ref = PrefetchingLoader(_FakeLen(n), **kw), JLoader(_FakeLen(n), **kw)
    assert port.num_batches() == ref.num_batches()
    for epoch in range(4):
        a, b = port.epoch_indices(epoch), ref.epoch_indices(epoch)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_loader_epoch_batches_match_jax(paths):
    """A prefetched epoch of the port's loader on the decoded split equals
    the JAX loader's on the HDF5, batch for batch."""
    port = PrefetchingLoader(PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=paths["decoded"])), 5, seed=2)
    ref = JLoader(JDataset(JDataConfig(dataset_path=paths["jax"])), 5, seed=2)
    got, want = list(port.epoch(1)), list(ref.epoch(1))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert all(np.array_equal(g[k], w[k]) for k in w)


def test_depth_tiff_roundtrip(tmp_path):
    depth = np.random.default_rng(0).uniform(0, 20, size=(16, 16)).astype(np.float32)
    path = str(tmp_path / "d.tiff")
    schema.save_depth_tiff(path, depth)
    np.testing.assert_array_equal(schema.load_depth_tiff(path), depth)
    np.testing.assert_array_equal(jschema.load_depth_tiff(path), depth)


def test_decoded_split_without_h5py_and_pil(paths):
    """As on the card's machine: with h5py and PIL unavailable the port's
    dataset and train modules import, read a decoded split and train an
    epoch from it on the CPU; the HDF5 layout is refused by the import."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["h5py"] = None
        sys.modules["PIL"] = None
        import dataclasses, os, shutil
        import numpy as np
        from perseus_tpu_torch import ROOT
        from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
        from perseus_tpu_torch.train import train
        from perseus_tpu_torch.train.config import TrainConfig
        ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path={paths["decoded"]!r}))
        assert len(ds) == 12 and ds.batch(np.arange(4))["image"].shape == (4, 24, 24, 3)
        try:
            PrunedKeypointDataset(KeypointDatasetConfig(dataset_path={paths["jax"]!r}))
            raise SystemExit("the HDF5 layout read without h5py")
        except ImportError:
            pass
        cfg = TrainConfig(batch_size=4, n_epochs=1, in_channels=4, amp=False, input_resolution=24,
                          dataset_config=KeypointDatasetConfig(dataset_path={paths["decoded"]!r}))
        result = train.train(cfg, device="cpu")
        for kind in ("models", "runs"):
            shutil.rmtree(os.path.join(ROOT, "outputs", kind, result["run_id"]))
        assert np.isfinite(result["final_val_loss"])
        assert sys.modules["h5py"] is None and sys.modules["PIL"] is None
        print("trained", result["train_loss_history"])
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0 and "trained" in out.stdout, out.stderr[-3000:]
