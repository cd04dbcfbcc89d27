"""Synthetic keypoint examples and pruned datasets (test fixtures, chip runs).

The port's copy of ``perseus_tpu/data/synthetic.py``: ``_make_example``
draws a noise background with random depth, one filled square "cube face"
nearer the camera, its exact segmentation, and its 4 corners (plus the
same corners nudged, as a fake back face) as keypoints.

  * :func:`make_batch` stacks examples into a host batch, for driving the
    train step without a dataset;
  * :func:`generate_synthetic_pruned_dataset` writes the JAX package's
    fixture, byte for byte: image files and the pruned HDF5 (needs ``h5py``
    and ``PIL``);
  * :func:`generate_synthetic_decoded_split` writes the same rows (same
    seed, same draws in the same order) straight into a decoded split
    (numpy alone), for hosts without ``h5py`` and ``PIL``.
"""

from __future__ import annotations

import os

import numpy as np

from perseus_tpu_torch.data import schema

__all__ = ["make_batch", "generate_synthetic_pruned_dataset", "generate_synthetic_decoded_split"]


def _make_example(rng: np.random.Generator, h: int, w: int, n_keypoints: int, asset_id: int):
    rgb = rng.uniform(0, 1, size=(h, w, 3)).astype(np.float32) * 0.3
    depth = rng.uniform(8.0, 14.0, size=(h, w)).astype(np.float32)
    seg = np.zeros((h, w), dtype=np.uint8)

    # square "cube face"
    size = int(rng.integers(h // 6, h // 3))
    top = int(rng.integers(0, h - size))
    left = int(rng.integers(0, w - size))
    color = rng.uniform(0.5, 1.0, size=3).astype(np.float32)
    rgb[top : top + size, left : left + size] = color
    cube_depth = float(rng.uniform(3.0, 6.0))
    depth[top : top + size, left : left + size] = cube_depth
    seg[top : top + size, left : left + size] = asset_id + 1

    # keypoints: the 4 corners of the face (u, v), then the same corners
    # nudged as a fake "back face"; pad/truncate to n_keypoints
    corners = np.array(
        [
            [left, top],
            [left + size - 1, top],
            [left, top + size - 1],
            [left + size - 1, top + size - 1],
        ],
        dtype=np.float32,
    )
    back = corners + np.float32(size * 0.15)
    kps = np.concatenate([corners, back], axis=0)[:n_keypoints]
    if len(kps) < n_keypoints:
        kps = np.concatenate([kps, np.tile(kps[-1:], (n_keypoints - len(kps), 1))])
    seg_ratio = float((seg == asset_id + 1).mean())
    return rgb, depth, seg, kps, seg_ratio


def make_batch(n: int, h: int, w: int, n_keypoints: int = 8, seed: int = 0) -> dict[str, np.ndarray]:
    """``n`` examples from ``seed`` as a host batch: ``image`` (N, H, W, 3)
    f32 in [0, 1], ``depth_image`` (N, H, W) f32, ``segmentation_image``
    (N, H, W) f32 in {0, 1}, ``pixel_coordinates`` (N, K, 2) f32 (u, v)."""
    rng = np.random.default_rng(seed)
    rgbs, depths, segs, kps = [], [], [], []
    for _ in range(n):
        rgb, depth, seg, kp, _ = _make_example(rng, h, w, n_keypoints, int(rng.integers(0, 5)))
        rgbs.append(rgb)
        depths.append(depth)
        segs.append((seg > 0).astype(np.float32))
        kps.append(kp)
    return {
        "image": np.stack(rgbs),
        "depth_image": np.stack(depths),
        "segmentation_image": np.stack(segs),
        "pixel_coordinates": np.stack(kps),
    }


def _splits(n_train: int, n_test: int, h: int, w: int, n_keypoints: int, seed: int):
    """(split name, row index, asset id, rgb, depth, seg, keypoints, seg
    ratio) of every row, both splits, in the JAX fixture's draw order."""
    rng = np.random.default_rng(seed)
    for split_name, count in [("train", n_train), ("test", n_test)]:
        for i in range(count):
            asset_id = int(rng.integers(0, 5))
            yield (split_name, i, asset_id, *_make_example(rng, h, w, n_keypoints, asset_id))


def _split_meta(names: list[str], coords: list, assets: list, ratios: list) -> schema.PrunedSplit:
    ratios = np.asarray(ratios)
    return schema.PrunedSplit(
        image_filenames=[n[0] for n in names],
        depth_filenames=[n[1] for n in names],
        segmentation_filenames=[n[2] for n in names],
        pixel_coordinates=np.asarray(coords, dtype=np.float32),
        asset_ids=np.asarray(assets),
        segmentation_ratios=ratios,
        weights=schema.compute_weights(ratios),
    )


def _file_names(split_name: str, i: int) -> tuple[str, str, str]:
    return (f"synth/{split_name}/rgba_{i:08d}.png", f"synth/{split_name}/depth_{i:08d}.tiff",
            f"synth/{split_name}/segmentation_{i:08d}.png")


def _attrs(n_train: int, n_test: int, h: int, w: int, n_keypoints: int) -> dict:
    return {"H": h, "W": w, "num_keypoints": n_keypoints, "train_frac": n_train / (n_train + n_test),
            "seg_ratio_lb": 0.02, "seg_ratio_ub": 0.7}


def generate_synthetic_pruned_dataset(
    out_dir: str, n_train: int = 16, n_test: int = 8, h: int = 32, w: int = 32, n_keypoints: int = 8, seed: int = 0
) -> str:
    """Writes images under ``out_dir/data/synth/{train,test}`` and the
    pruned HDF5 at ``out_dir/data/synth/pruned.hdf5`` (filenames relative
    to ``out_dir/data``). Returns the HDF5 path. Needs ``h5py`` and ``PIL``."""
    data_dir = os.path.join(out_dir, "data")
    rows: dict = {"train": ([], [], [], []), "test": ([], [], [], [])}
    for split_name, i, asset_id, rgb, depth, seg, kps, ratio in _splits(n_train, n_test, h, w, n_keypoints, seed):
        names = _file_names(split_name, i)
        os.makedirs(os.path.join(data_dir, "synth", split_name), exist_ok=True)
        schema.save_rgb_png(os.path.join(data_dir, names[0]), rgb)
        schema.save_depth_tiff(os.path.join(data_dir, names[1]), depth)
        schema.save_segmentation_png(os.path.join(data_dir, names[2]), seg)
        for col, v in zip(rows[split_name], (names, kps, asset_id, ratio)):
            col.append(v)
    hdf5_path = os.path.join(data_dir, "synth", "pruned.hdf5")
    schema.write_pruned_dataset(
        hdf5_path, _split_meta(*rows["train"]), _split_meta(*rows["test"]), _attrs(n_train, n_test, h, w, n_keypoints)
    )
    return hdf5_path


def generate_synthetic_decoded_split(
    out_dir: str, n_train: int = 16, n_test: int = 8, h: int = 32, w: int = 32, n_keypoints: int = 8, seed: int = 0
) -> str:
    """Writes :func:`generate_synthetic_pruned_dataset`'s rows as a decoded
    split at ``out_dir`` (numpy alone: each row straight into the
    memory-mapped arrays, as the image files would decode). Returns
    ``out_dir``."""
    counts = {"train": n_train, "test": n_test}
    arrays = {name: schema.open_decoded_arrays(out_dir, name, n, h, w) for name, n in counts.items()}
    rows: dict = {"train": ([], [], [], []), "test": ([], [], [], [])}
    for split_name, i, asset_id, rgb, depth, seg, kps, ratio in _splits(n_train, n_test, h, w, n_keypoints, seed):
        a = arrays[split_name]
        a["image_u8"][i] = schema.rgb_to_u8(rgb)
        a["depth_image"][i] = depth
        a["seg_b"][i] = seg == asset_id + 1
        for col, v in zip(rows[split_name], (_file_names(split_name, i), kps, asset_id, ratio)):
            col.append(v)
    for name in counts:
        for a in arrays[name].values():
            a.flush()
        schema.write_decoded_split(out_dir, name, _split_meta(*rows[name]))
    del arrays
    schema.write_decoded_attrs(out_dir, _attrs(n_train, n_test, h, w, n_keypoints))
    return out_dir
