"""Port parity: the native batch decoder (perseus_tpu_torch/native/) against
the JAX package's (perseus_tpu/native/), on the same PNG, float-TIFF and
segmentation files, in the style of tests/test_native_io.py: the decodes
are exact (equal arrays), and the port's dataset rows with the decoder are
bit-identical to its PIL rows. Skipped where the port's decoder cannot be
built (no g++ or libpng).
"""

import os
import threading

import numpy as np
import pytest

from perseus_tpu.data import schema as jschema
from perseus_tpu.data.synthetic import generate_synthetic_pruned_dataset
from perseus_tpu.native import io as jnio
from perseus_tpu_torch.data import schema
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.native import io as nio

pytestmark = pytest.mark.skipif(not nio.available(), reason="no C++ toolchain or libpng for the native decoder")

RNG = np.random.default_rng(4)


@pytest.fixture(scope="module", autouse=True)
def jax_decoder(tmp_path_factory):
    """The JAX package's decoder, built for this module in a directory of
    its own. That package's ``_compile`` runs ``g++ -o`` straight onto a
    library path that every process shares, and its ``_load`` tries once
    per process: under pytest-xdist another worker's ``test_native_io.py``
    may be writing the shared file when this one loads it, and a
    half-written library would leave the decoder missing here for the
    whole run."""
    if jnio._LIB is None:
        build_dir = str(tmp_path_factory.mktemp("jax_nio_build"))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnio, "_build_dir", lambda: build_dir)
            mp.setattr(jnio, "_TRIED", False)
            assert jnio.available(), "the JAX package's native decoder did not build"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_nio")
    h, w = 40, 56
    rgb = RNG.uniform(0, 1, (h, w, 3)).astype(np.float32)
    depth = RNG.uniform(0.05, 12.0, (h, w)).astype(np.float32)
    seg = RNG.integers(0, 6, (h, w)).astype(np.uint8)
    jschema.save_rgb_png(str(d / "x.png"), rgb)
    jschema.save_depth_tiff(str(d / "x.tiff"), depth)
    jschema.save_segmentation_png(str(d / "x_seg.png"), seg)
    return d, h, w, depth, seg


def test_decode_example_matches_jax_and_pil(files):
    d, h, w, depth, seg = files
    args = (str(d / "x.png"), str(d / "x.tiff"), str(d / "x_seg.png"), 2, h, w)
    ours, theirs = nio.decode_example(*args), jnio.decode_example(*args)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[0], schema.load_rgb_png(str(d / "x.png")))
    np.testing.assert_array_equal(ours[1], depth)
    np.testing.assert_array_equal(ours[2], (seg == 3).astype(np.float32))
    rgb_only = nio.decode_example(str(d / "x.png"), None, None, 0, h, w)
    assert rgb_only[1] is None and rgb_only[2] is None


def test_decode_batch_matches_jax(files):
    d, h, w, depth, seg = files
    n = 12
    args = ([str(d / "x.png")] * n, [str(d / "x.tiff")] * n, [str(d / "x_seg.png")] * n, np.arange(n) % 5, h, w)
    ours, theirs = nio.decode_batch(*args, threads=4), jnio.decode_batch(*args, threads=4)
    assert ours[3] == theirs[3] == 0
    for a, b in zip(ours[:3], theirs[:3]):
        assert a.dtype == np.float32 and a.shape[:3] == (n, h, w)
        np.testing.assert_array_equal(a, b)
    for i in range(n):
        np.testing.assert_array_equal(ours[2][i], (seg == i % 5 + 1).astype(np.float32))


def test_decode_failures_are_reported(files):
    d, h, w, *_ = files
    missing = str(d / "missing.png")
    rgb, _, _, fails = nio.decode_batch([str(d / "x.png"), missing], None, None, None, h, w)
    assert fails == jnio.decode_batch([str(d / "x.png"), missing], None, None, None, h, w)[3] == 1
    assert rgb[0].any() and not rgb[1].any()  # the failed item zero-filled
    with pytest.raises(RuntimeError, match="decode failed"):
        nio.decode_example(missing, None, None, 0, h, w)
    with pytest.raises(RuntimeError, match="decode failed"):  # wrong size
        nio.decode_example(str(d / "x.png"), None, None, 0, h + 1, w)


@pytest.fixture(scope="module")
def hdf5(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_nio_ds")
    generate_synthetic_pruned_dataset(str(root), n_train=6, n_test=2, h=32, w=32)
    return str(root / "data" / "synth" / "pruned.hdf5")


@pytest.mark.parametrize("cache", [False, True])
def test_dataset_native_rows_bit_identical_to_pil(hdf5, cache):
    native = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=hdf5, decode_threads=3), cache=cache)
    pil = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=hdf5, native_decode=False), cache=cache)
    assert (native.decoder, pil.decoder) == ("native", "pil")
    idx = np.arange(len(native))
    a, b = native.batch(idx), pil.batch(idx)
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dataset_decodes_item_by_item_on_a_reported_failure(hdf5, tmp_path):
    """A batch the decoder reports a failure in is decoded again through
    PIL, which raises the failing file's own error."""
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(os.path.dirname(os.path.dirname(os.path.dirname(hdf5))), root)
    path = str(root / "data" / "synth" / "pruned.hdf5")
    ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=path))
    os.remove(ds._resolve(ds.split.image_filenames[1]))
    np.testing.assert_array_equal(ds.batch(np.array([0]))["image"][0], ds[0]["image"])
    with pytest.raises(FileNotFoundError):
        ds.batch(np.array([0, 1]))


def test_dataset_without_the_decoder_takes_pil(hdf5, monkeypatch):
    monkeypatch.setattr(nio, "available", lambda: False)
    ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=hdf5))
    assert ds.decoder == "pil" and ds.batch(np.arange(2))["image"].shape == (2, 32, 32, 3)


def test_concurrent_builds_rename_one_complete_library(monkeypatch, tmp_path):
    """Builds that run at once each compile to a temporary name and rename
    it into place: every caller gets the complete library, no temporary
    file is left."""
    monkeypatch.setattr(nio, "_BUILD_DIR", str(tmp_path))
    out, errors = [], []

    def build():
        try:
            out.append(nio._compile())
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(out)) == 1
    assert os.listdir(tmp_path) == [os.path.basename(out[0])]
    import ctypes

    assert hasattr(ctypes.CDLL(out[0]), "pio_decode_batch")
