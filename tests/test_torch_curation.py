"""Port parity: dataset curation (perseus_tpu_torch/datagen/label_dataset.py,
data/merge.py, data/prune.py) against the JAX package, on the same inputs:
job directories rendered by the JAX package's generate_one_video (32x32, 4
frames, tests/test_full_pipeline.py's video config), tests/test_labeler.py's
fixture jobs, and raw HDF5 files written as tests/test_data.py's
test_merge_and_prune_roundtrip writes them.

Tolerances: the labels to 1e-4 px (both labelers project in float64 and
store float32; measured: equal), every other array and attribute exact, the
stored filenames equal up to the output directory's own name, the files
they name equal byte for byte.
"""

import filecmp
import os
import shutil

import h5py
import numpy as np
import pytest

from perseus_tpu.data.merge import merge as jmerge
from perseus_tpu.data.prune import prune_dataset as jprune
from perseus_tpu.datagen import generate as jgenerate
from perseus_tpu.datagen.label_dataset import LabelConfig as JLabelConfig
from perseus_tpu.datagen.label_dataset import label_dataset as jlabel_dataset
from perseus_tpu_torch.data import schema
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.data.merge import merge
from perseus_tpu_torch.data.prune import prune_dataset
from perseus_tpu_torch.datagen.label_dataset import LabelConfig, label_dataset
from tests.test_labeler import _make_job


def _read(path: str, rename: tuple[str, str] | None = None) -> dict:
    """Every dataset and attribute of an HDF5 file, names decoded (and the
    output directory's name swapped for a common one)."""
    out = {}
    with h5py.File(path, "r") as f:
        out["attrs"] = {k: np.asarray(v) for k, v in f.attrs.items()}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                value = obj[()]
                if value.dtype.kind == "S":
                    value = np.char.decode(value, "utf-8")
                    if rename:
                        value = np.char.replace(value, *rename)
                out[name] = value

        f.visititems(visit)
    return out


def _assert_same_h5(got: dict, want: dict, coords_atol: float = 0.0):
    assert got.keys() == want.keys()
    assert got["attrs"].keys() == want["attrs"].keys()
    for k, v in want["attrs"].items():
        np.testing.assert_array_equal(got["attrs"][k], v)
    for k, v in want.items():
        if k == "attrs":
            continue
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k.endswith("pixel_coordinates") and coords_atol:
            np.testing.assert_allclose(got[k], v, atol=coords_atol)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Three JAX-rendered job directories, copied once per labeler."""
    root = tmp_path_factory.mktemp("curation")
    cfg = jgenerate.VideoConfig(
        job_dir=str(root / "jobs"), resolution=32, frames=4, n_static_range=(1, 2), n_dynamic_range=(1, 1),
        cube_scale_range=(1.0, 1.4), gravity=-0.5, seed=11,
    )
    for i in range(3):
        jgenerate.generate_one_video(cfg, job_id=f"{i:08x}")
    return root


@pytest.mark.parametrize("lazy", [False, True], ids=["images", "lazy"])
def test_label_dataset_matches_jax_on_rendered_jobs(jobs, lazy):
    out = {}
    for name, fn, cfg_cls in (("jax", jlabel_dataset, JLabelConfig), ("torch", label_dataset, LabelConfig)):
        job_dir = jobs / f"label_{name}_{lazy}"
        shutil.copytree(jobs / "jobs", job_dir)
        out[name] = fn(cfg_cls(job_dir=str(job_dir), frames=4, train_frac=0.67, lazy_images=lazy))
        assert os.path.basename(out[name]) == "mjc_data.hdf5"
    got, want = _read(out["torch"]), _read(out["jax"])
    assert ("train/images" in want) != lazy
    _assert_same_h5(got, want, coords_atol=1e-4)


def test_label_merge_prune_chain_matches_jax_on_rendered_jobs(jobs):
    """The production chain on the rendered jobs, each package on its own
    copy: lazy labels -> merge -> prune, the merged and pruned HDF5s equal
    (tests/test_full_pipeline.py's steps 2-4)."""
    out = {}
    for name, label_fn, cfg_cls, merge_fn, prune_fn in (
        ("jax", jlabel_dataset, JLabelConfig, jmerge, jprune),
        ("torch", label_dataset, LabelConfig, merge, prune_dataset),
    ):
        root = jobs / f"chain_{name}"
        shutil.copytree(jobs / "jobs", root / "run0")
        raw = label_fn(cfg_cls(job_dir=str(root / "run0"), frames=4, train_frac=0.67, lazy_images=True))
        merged = merge_fn([raw], str(root / "merged"), new_train_frac=0.67)
        out[name] = (merged, prune_fn(merged, str(root / "pruned" / "pruned.hdf5"), str(root / "pruned"), lb=0.0, ub=1.0))
    for i in range(2):
        got, want = _read(out["torch"][i]), _read(out["jax"][i])
        _assert_same_h5(got, want, coords_atol=1e-4)
    assert len(want["train/image_filenames"]) + len(want["test/image_filenames"]) == 12


def test_label_dataset_matches_jax_on_fixture_jobs(tmp_path):
    """tests/test_labeler.py's jobs (the cube at instance index 1), plus a
    broken job that both labelers skip."""
    out = {}
    for name, fn, cfg_cls in (("jax", jlabel_dataset, JLabelConfig), ("torch", label_dataset, LabelConfig)):
        rng = np.random.default_rng(5)
        job_dir = str(tmp_path / name)
        for jid in ("aaa", "bbb", "ccc"):
            _make_job(os.path.join(job_dir, jid), rng)
        os.makedirs(os.path.join(job_dir, "broken"))  # no metadata.json
        out[name] = fn(cfg_cls(job_dir=job_dir, train_frac=0.67, frames=4, num_keypoints=8))
    got, want = _read(out["torch"]), _read(out["jax"])
    _assert_same_h5(got, want, coords_atol=1e-4)
    assert got["train/pixel_coordinates"].shape == (2, 4, 8, 2) and int(got["train/asset_ids"][0, 0]) == 1
    np.testing.assert_allclose(got["train/pixel_coordinates"][0, 0].mean(axis=0), [16.0, 16.0], atol=0.5)


def test_label_dataset_raises_without_a_labelable_job(tmp_path):
    os.makedirs(tmp_path / "broken")
    with pytest.raises(RuntimeError, match="no jobs labeled"):
        label_dataset(LabelConfig(job_dir=str(tmp_path), frames=4))


def _write_raw(path: str, n_traj: int, start: int, rng, h=16, w=16, t_frames=3):
    """A raw per-batch HDF5 and its image files (test_data.py's writer)."""
    base = os.path.dirname(path)
    with h5py.File(path, "w") as f:
        f.attrs.update({"num_keypoints": 8, "train_frac": 0.67, "H": h, "W": w})
        for split, count in [("train", n_traj), ("test", 1)]:
            g = f.create_group(split)
            names = {"i": [], "d": [], "s": []}
            for ti in range(count):
                row = {"i": [], "d": [], "s": []}
                for fi in range(t_frames):
                    tag = f"{split}_{start}_{ti}_{fi}"
                    seg = np.zeros((h, w), np.uint8)
                    seg[4 : 4 + ti + fi + 3, 4:10] = 1  # seg ratios vary by row
                    schema.save_rgb_png(os.path.join(base, f"rgba_{tag}.png"), rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
                    schema.save_depth_tiff(os.path.join(base, f"depth_{tag}.tiff"), rng.uniform(1, 20, (h, w)).astype(np.float32))
                    schema.save_segmentation_png(os.path.join(base, f"seg_{tag}.png"), seg)
                    row["i"].append(f"rgba_{tag}.png")
                    row["d"].append(f"depth_{tag}.tiff")
                    row["s"].append(f"seg_{tag}.png")
                for k in names:
                    names[k].append(row[k])
            g.create_dataset("image_filenames", data=np.asarray(names["i"], dtype="S"))
            g.create_dataset("depth_filenames", data=np.asarray(names["d"], dtype="S"))
            g.create_dataset("segmentation_filenames", data=np.asarray(names["s"], dtype="S"))
            g.create_dataset("asset_ids", data=np.zeros((count, t_frames), np.int64))
            g.create_dataset("pixel_coordinates", data=rng.uniform(0, w, (count, t_frames, 8, 2)).astype(np.float32))
            g.create_dataset("object_poses", data=rng.normal(size=(count, t_frames, 7)))
            g.create_dataset("object_scales", data=np.ones((count, t_frames)))
            g.create_dataset("camera_poses", data=rng.normal(size=(count, t_frames, 7)))
            g.create_dataset("camera_intrinsics", data=np.tile(np.eye(3), (count, t_frames, 1, 1)))


@pytest.fixture(scope="module")
def raw_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(1)
    paths = []
    for name, n_traj, start in (("batch1", 2, 0), ("batch2", 1, 10)):
        (root / name).mkdir()
        paths.append(str(root / name / "mjc_data.hdf5"))
        _write_raw(paths[-1], n_traj, start, rng)
    return root, paths


@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
def test_merge_and_prune_match_jax(raw_files, shuffle):
    """merge (optionally reshuffled and re-split) then prune, by each
    package into its own directory: equal HDF5s, equal linked files, and
    the port's reader gives equal rows from both pruned datasets."""
    root, paths = raw_files
    tag = "shuf" if shuffle else "ord"
    pruned = {}
    for name, merge_fn, prune_fn in (("jax", jmerge, jprune), ("torch", merge, prune_dataset)):
        merged = merge_fn(paths, str(root / f"merged_{name}_{tag}"), new_train_frac=0.5, shuffle=shuffle, workers=2,
                          seed=3)
        out_dir = root / f"pruned_{name}_{tag}"
        pruned[name] = prune_fn(merged, str(out_dir / "pruned.hdf5"), str(out_dir), lb=0.1, ub=0.3, workers=2)
    merged_j = _read(str(root / f"merged_jax_{tag}" / "merged.hdf5"), (f"merged_jax_{tag}", "merged"))
    merged_t = _read(str(root / f"merged_torch_{tag}" / "merged.hdf5"), (f"merged_torch_{tag}", "merged"))
    _assert_same_h5(merged_t, merged_j)
    assert np.isfinite(merged_t["train/segmentation_ratios"]).all()
    got = _read(pruned["torch"], (f"pruned_torch_{tag}", "pruned"))
    want = _read(pruned["jax"], (f"pruned_jax_{tag}", "pruned"))
    _assert_same_h5(got, want)
    assert 0 < len(want["train/image_filenames"]) + len(want["test/image_filenames"]) < 15  # the band cut rows

    datasets = {n: PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=p), train=True) for n, p in pruned.items()}
    assert len(datasets["jax"]) == len(datasets["torch"]) > 0
    for i in range(len(datasets["jax"])):
        for key in ("image_filenames", "depth_filenames", "segmentation_filenames"):
            a = datasets["torch"]._resolve(getattr(datasets["torch"].split, key)[i])
            b = datasets["jax"]._resolve(getattr(datasets["jax"].split, key)[i])
            assert filecmp.cmp(a, b, shallow=False)
        a, b = datasets["torch"][i], datasets["jax"][i]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_merge_refuses_an_existing_output_directory(raw_files, tmp_path):
    with pytest.raises(ValueError, match="already exists"):
        merge(raw_files[1], str(tmp_path))
