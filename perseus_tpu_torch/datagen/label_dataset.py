"""Offline labeler: job directories -> raw per-batch HDF5 (``mjc_data.hdf5``).

Port of ``perseus_tpu/datagen/label_dataset.py``: for every job directory
holding a kubric ``metadata.json`` and rendered ``rgba_/depth_/segmentation_*``
frames, project the 8 scaled cube corners through the per-frame object /
camera poses (``labeling.py``, in float64 on the host) and gather the
trajectories into the raw HDF5 schema (train/test groups keyed by
trajectory with images, poses, intrinsics, filenames; attrs
num_keypoints / train_frac / H / W). A job that fails to label is skipped.
``h5py`` (and ``PIL``, for the images) are imported inside the functions.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from perseus_tpu_torch.data import schema
from perseus_tpu_torch.datagen.labeling import cube_corners, get_pixel_coordinates

__all__ = ["LabelConfig", "label_job", "label_metadata", "label_dataset", "main"]


@dataclass(frozen=True)
class LabelConfig:
    job_dir: str = "data/job"
    job_id: str = ""  # empty: process every subdirectory
    asset_id: str = "mjc"
    num_keypoints: int = 8
    train_frac: float = 0.95
    frames: int = 24
    lazy_images: bool = False  # skip embedding raw pixel arrays in the HDF5


def _reorder_wxyz_to_xyzw(q: np.ndarray) -> np.ndarray:
    return np.concatenate([q[..., 1:], q[..., :1]], axis=-1)


def label_job(cfg: LabelConfig, job_id: str) -> dict:
    """Labels one job directory; returns per-trajectory arrays."""
    with open(os.path.join(cfg.job_dir, job_id, "metadata.json")) as f:
        metadata = json.load(f)
    out = label_metadata(cfg, metadata, job_id)
    if not cfg.lazy_images:
        rp = lambda p: os.path.join(cfg.job_dir, p)
        out["images"] = np.stack(
            [(schema.load_rgb_png(rp(p)) * 255).astype(np.uint8) for p in out["image_filenames"]]
        )
        out["depth_images"] = np.stack([schema.load_depth_tiff(rp(p)) for p in out["depth_filenames"]])
        out["segmentation_images"] = np.stack(
            [schema.load_segmentation_png(rp(p)) for p in out["segmentation_filenames"]]
        )
    return out


def label_metadata(cfg: LabelConfig, metadata: dict, job_id: str) -> dict:
    """:func:`label_job`'s labels (the arrays and file names, no images)
    from a job's ``metadata.json`` dict already in memory; reads no file."""
    job_path = os.path.join(cfg.job_dir, job_id)
    asset_index = None
    for i, instance in enumerate(metadata["instances"]):
        if instance["asset_id"] == cfg.asset_id:
            asset_index = i
            break
    if asset_index is None:
        raise ValueError(f"asset {cfg.asset_id} not in {job_path}")

    fov = metadata["camera"]["field_of_view"]
    h = w = metadata["flags"]["resolution"]
    cam_pos = np.asarray(metadata["camera"]["positions"], dtype=np.float64)
    cam_quat = _reorder_wxyz_to_xyzw(np.asarray(metadata["camera"]["quaternions"], dtype=np.float64))
    obj = metadata["instances"][asset_index]
    obj_pos = np.asarray(obj["positions"], dtype=np.float64)
    obj_quat = _reorder_wxyz_to_xyzw(np.asarray(obj["quaternions"], dtype=np.float64))
    abs_scale = float(obj["abs_scale"])

    corners = cube_corners(abs_scale, dtype=torch.float64)
    pixel_coords = (
        get_pixel_coordinates(
            corners,
            torch.from_numpy(np.concatenate([obj_pos, obj_quat], axis=-1)),
            torch.from_numpy(np.concatenate([cam_pos, cam_quat], axis=-1)),
            fov,
            h,
            w,
        )
        .numpy()
        .astype(np.float32)
    )

    t = cfg.frames
    # stored names are relative to the job_dir (where the raw HDF5 lands):
    # merge resolves them against the raw file's own directory, so the
    # dataset stays portable and relative job_dir paths don't double up
    rgb_names = [os.path.join(job_id, f"rgba_{i:05d}.png") for i in range(t)]
    depth_names = [os.path.join(job_id, f"depth_{i:05d}.tiff") for i in range(t)]
    seg_names = [os.path.join(job_id, f"segmentation_{i:05d}.png") for i in range(t)]

    out = {
        "pixel_coordinates": pixel_coords[:t],
        "object_poses": np.concatenate([obj_pos, obj_quat], axis=-1)[:t].astype(np.float32),
        "object_scales": np.full((t,), abs_scale, dtype=np.float32),
        "camera_poses": np.concatenate([cam_pos, cam_quat], axis=-1)[:t].astype(np.float32),
        "camera_intrinsics": np.tile(
            np.asarray(
                [[w / (2 * np.tan(fov / 2)), 0, w / 2], [0, h / (2 * np.tan(fov / 2)), h / 2], [0, 0, 1]],
                dtype=np.float32,
            ),
            (t, 1, 1),
        ),
        "image_filenames": rgb_names,
        "depth_filenames": depth_names,
        "segmentation_filenames": seg_names,
        "asset_ids": np.full((t,), asset_index, dtype=np.int64),
        "H": h,
        "W": w,
    }
    return out


def label_dataset(cfg: LabelConfig) -> str:
    """Labels all jobs and writes ``<job_dir>/<asset_id>_data.hdf5``."""
    import h5py

    job_ids = (
        [cfg.job_id]
        if cfg.job_id
        else sorted(
            d for d in os.listdir(cfg.job_dir) if os.path.isdir(os.path.join(cfg.job_dir, d))
        )
    )
    trajs = []
    for job_id in job_ids:
        try:
            trajs.append(label_job(cfg, job_id))
        except Exception as exc:  # tolerate per-job failures, like the reference
            print(f"Failed to label job {job_id}: {exc}")
            continue
    if not trajs:
        raise RuntimeError("no jobs labeled")

    split_idx = int(cfg.train_frac * len(trajs))
    out_path = os.path.join(cfg.job_dir, f"{cfg.asset_id}_data.hdf5")
    array_keys = [
        "pixel_coordinates",
        "object_poses",
        "object_scales",
        "camera_poses",
        "camera_intrinsics",
        "asset_ids",
    ]
    if not cfg.lazy_images:
        array_keys = ["images", "depth_images", "segmentation_images", *array_keys]
    name_keys = ["image_filenames", "depth_filenames", "segmentation_filenames"]

    with h5py.File(out_path, "w") as f:
        for split, chunk in [("train", trajs[:split_idx]), ("test", trajs[split_idx:])]:
            g = f.create_group(split)
            for key in array_keys:
                g.create_dataset(key, data=np.stack([t[key] for t in chunk]) if chunk else np.zeros((0,)))
            for key in name_keys:
                g.create_dataset(key, data=np.asarray([t[key] for t in chunk], dtype="S"))
        f.attrs["num_keypoints"] = cfg.num_keypoints
        f.attrs["train_frac"] = cfg.train_frac
        f.attrs["H"] = trajs[0]["H"]
        f.attrs["W"] = trajs[0]["W"]
    return out_path


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    print(label_dataset(cli(LabelConfig)))


if __name__ == "__main__":
    main()
