"""Merge per-batch raw HDF5 datasets into one merged dataset.

Port of ``perseus_tpu/data/merge.py``, host code; ``h5py`` is imported
inside the functions.

Capability equivalent of the reference's merge tool (reference:
data/merge_hdf5.py:193-506): concatenates trajectory-shaped label arrays
from multiple raw files, optionally reshuffles and re-splits train/test,
copies image files into the canonical
``images/{split}/{image|depth|segmentation}/traj_%08d/...`` tree, computes
per-image segmentation ratios and inverse-bin-frequency weights, and writes
``merged.hdf5``.

Differences from the reference (intentional fixes, not behavior changes):
  * output paths are handled with absolute directories instead of relying on
    the caller's CWD (the reference requires CWD == ROOT/data for the stored
    relative names to line up; SURVEY.md section 5 quirks),
  * thread-pool fan-out is a parameter (the reference hardcodes executors).
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from perseus_tpu_torch.data import schema

__all__ = ["merge"]

_LABEL_KEYS = (
    "asset_ids",
    "pixel_coordinates",
    "object_poses",
    "object_scales",
    "camera_poses",
    "camera_intrinsics",
)
_NAME_KEYS = ("image_filenames", "depth_filenames", "segmentation_filenames")
_TYPE_FOR_NAME = {"image_filenames": "image", "depth_filenames": "depth", "segmentation_filenames": "segmentation"}
_PREFIX_FOR_TYPE = {"image": "rgba", "depth": "depth", "segmentation": "segmentation"}
_EXT_FOR_TYPE = {"image": "png", "depth": "tiff", "segmentation": "png"}


def _copy_trajectories(
    src_paths: list[list[str]],
    output_dir: str,
    data_root: str,
    mode: str,
    img_type: str,
    workers: int,
) -> list[list[str]]:
    """Copies per-trajectory image files into the canonical tree; returns
    data_root-relative filenames, trajectory-shaped."""
    jobs = []
    filenames = []
    prefix = _PREFIX_FOR_TYPE[img_type]
    ext = _EXT_FOR_TYPE[img_type]
    rel_base = os.path.relpath(output_dir, data_root)
    for traj_idx, traj in enumerate(src_paths):
        traj_rel = f"{rel_base}/images/{mode}/{img_type}/traj_{traj_idx:08d}"
        traj_dir = os.path.join(data_root, traj_rel)
        os.makedirs(traj_dir, exist_ok=True)
        traj_names = []
        for j, src in enumerate(traj):
            name = f"{prefix}_{j:08d}.{ext}"
            jobs.append((src, os.path.join(traj_dir, name)))
            traj_names.append(f"{traj_rel}/{name}")
        filenames.append(traj_names)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(lambda job: _link_or_copy(*job), jobs))
    return filenames


def _link_or_copy(src: str, dst: str) -> None:
    """Hard-link when source and destination share a filesystem (the images
    are immutable renders, and a full copy of a 2,500-video dataset is tens
    of GB); falls back to a real copy across filesystems.

    Immutability contract: a hard link shares the source inode, so an
    in-place overwrite of a source render would silently mutate every merged/
    pruned dataset linking it. The datagen writers honor this by always
    writing a NEW inode and os.replace()-ing it over the name
    (data/schema.py::_atomic_save) — regenerating a job dir re-points names
    without touching bytes reachable through existing links."""
    if os.path.exists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _segmentation_ratios(
    seg_paths: list[list[str]], asset_ids: np.ndarray, data_root: str, workers: int
) -> np.ndarray:
    """Per-image cube-pixel fraction (reference: merge_hdf5.py:131-172);
    NaN on unreadable images."""

    def one(args):
        path, asset_id = args
        try:
            seg = schema.load_segmentation_png(os.path.join(data_root, path) if not os.path.isabs(path) else path)
            return float(np.mean(seg == asset_id + 1))
        except Exception:
            return float("nan")

    n_traj = len(seg_paths)
    n_per = len(seg_paths[0]) if n_traj else 0
    jobs = [(seg_paths[i][j], asset_ids[i][j]) for i in range(n_traj) for j in range(n_per)]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        flat = list(pool.map(one, jobs))
    return np.asarray(flat, dtype=np.float64).reshape(n_traj, n_per)


def _decode_traj_names(arr) -> list[list[str]]:
    return [[x.decode("utf-8") if isinstance(x, bytes) else str(x) for x in traj] for traj in arr]


def merge(
    hdf5_list: list[str],
    output_dir: str,
    new_train_frac: float = 0.95,
    shuffle: bool = False,
    workers: int = 8,
    seed: int = 0,
) -> str:
    """Merges raw per-batch HDF5 files; returns the merged.hdf5 path."""
    import h5py

    if os.path.exists(output_dir):
        raise ValueError(f"Directory {output_dir} already exists; remove it or pick a new one.")
    os.makedirs(output_dir)
    data_root = os.path.dirname(os.path.abspath(output_dir))

    per_split: dict[str, dict[str, list]] = {
        s: {k: [] for k in (*_LABEL_KEYS, *_NAME_KEYS)} for s in ("train", "test")
    }
    attrs: dict = {}
    for path in hdf5_list:
        src_dir = os.path.dirname(os.path.abspath(path))
        with h5py.File(path, "r") as f:
            for a in ("num_keypoints", "train_frac", "H", "W"):
                attrs.setdefault(a, f.attrs[a])
            for split in ("train", "test"):
                g = f[split]
                for k in _LABEL_KEYS:
                    per_split[split][k].append(np.asarray(g[k][()]))
                for k in _NAME_KEYS:
                    names = _decode_traj_names(g[k][()])
                    # resolve names relative to the source file's directory
                    resolved = [
                        [n if os.path.isabs(n) else os.path.join(src_dir, n) for n in traj]
                        for traj in names
                    ]
                    per_split[split][k].append(resolved)

    merged: dict[str, dict[str, np.ndarray | list]] = {}
    for split in ("train", "test"):
        merged[split] = {k: np.concatenate(v, axis=0) for k, v in per_split[split].items() if k in _LABEL_KEYS}
        for k in _NAME_KEYS:
            merged[split][k] = [traj for chunk in per_split[split][k] for traj in chunk]

    if shuffle:
        all_data: dict[str, list | np.ndarray] = {}
        for k in _LABEL_KEYS:
            all_data[k] = np.concatenate([merged["train"][k], merged["test"][k]], axis=0)
        for k in _NAME_KEYS:
            all_data[k] = merged["train"][k] + merged["test"][k]
        n_total = len(all_data["asset_ids"])
        n_train = int(new_train_frac * n_total)
        perm = np.random.default_rng(seed).permutation(n_total)
        for split, idx in [("train", perm[:n_train]), ("test", perm[n_train:])]:
            for k in _LABEL_KEYS:
                merged[split][k] = all_data[k][idx]
            for k in _NAME_KEYS:
                merged[split][k] = [all_data[k][i] for i in idx]

    out_path = os.path.join(output_dir, "merged.hdf5")
    with h5py.File(out_path, "w") as f:
        for a, v in attrs.items():
            f.attrs[a] = v
        for split in ("train", "test"):
            g = f.create_group(split)
            new_names = {}
            for k in _NAME_KEYS:
                new_names[k] = _copy_trajectories(
                    merged[split][k], output_dir, data_root, split, _TYPE_FOR_NAME[k], workers
                )
            ratios = _segmentation_ratios(
                new_names["segmentation_filenames"], merged[split]["asset_ids"], data_root, workers
            )
            weights = schema.compute_weights(ratios)
            for k in _LABEL_KEYS:
                g.create_dataset(k, data=merged[split][k])
            for k in _NAME_KEYS:
                g.create_dataset(k, data=np.asarray(new_names[k], dtype="S"))
            g.create_dataset("segmentation_ratios", data=ratios)
            g.create_dataset("weights", data=weights)
    return out_path
