"""Prune a merged dataset by segmentation ratio into the flat training layout.

Port of ``perseus_tpu/data/prune.py``, host code; ``h5py`` is imported
inside the functions.

Capability equivalent of the reference's prune tool (reference:
data/prune_dataset.py:101-154): keeps images whose seg-ratio lies in
[lb, ub], flattens the trajectory structure to per-image rows, copies the
kept files into ``output_data_dir/{split}``, and writes ``pruned.hdf5``
with per-image filenames/labels plus ``seg_ratio_lb/ub`` attrs.

Fixes (not replicated from the reference): the per-image weight lookup uses
the true cumulative flat index, which the reference got wrong for
non-uniform trajectory lengths (reference: prune_dataset.py:38 indexes
``traj_idx * len(image_filenames) + img_idx``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

from perseus_tpu_torch.data import schema

__all__ = ["prune_dataset"]


def prune_dataset(
    input_hdf5_path: str,
    output_hdf5_path: str,
    output_data_dir: str,
    lb: float = 0.02,
    ub: float = 0.7,
    workers: int = 8,
) -> str:
    """Keeps the rows of a merged dataset whose segmentation ratio lies in
    [lb, ub], copies their files into ``output_data_dir/{split}`` and writes
    the pruned HDF5 at ``output_hdf5_path``; returns its path."""
    import h5py

    data_root = os.path.dirname(os.path.abspath(input_hdf5_path))
    data_root = os.path.dirname(data_root)  # merged dir's parent == data root
    os.makedirs(output_data_dir, exist_ok=True)
    out_root = os.path.dirname(os.path.dirname(os.path.abspath(output_hdf5_path)))

    with h5py.File(input_hdf5_path, "r") as f_in:
        attrs = dict(f_in.attrs)
        splits = {}
        for split in ("train", "test"):
            g = f_in[split]
            image_names = g["image_filenames"][()]
            depth_names = g["depth_filenames"][()]
            seg_names = g["segmentation_filenames"][()]
            coords = g["pixel_coordinates"][()]
            asset_ids = g["asset_ids"][()]
            ratios = g["segmentation_ratios"][()]
            weights = g["weights"][()]

            split_dir = os.path.join(output_data_dir, split)
            os.makedirs(split_dir, exist_ok=True)

            kept = {k: [] for k in schema.PRUNED_DATASET_KEYS}
            copy_jobs = []
            new_idx = 0
            flat_idx = 0
            n_traj = len(image_names)
            for ti in range(n_traj):
                traj_len = len(image_names[ti])
                for ii in range(traj_len):
                    ratio = float(ratios[ti][ii])
                    if lb <= ratio <= ub:
                        names_new = (
                            f"rgba_{new_idx:08d}.png",
                            f"depth_{new_idx:08d}.tiff",
                            f"segmentation_{new_idx:08d}.png",
                        )
                        for src_key, dst_name, out_key in zip(
                            (image_names, depth_names, seg_names),
                            names_new,
                            ("image_filenames", "depth_filenames", "segmentation_filenames"),
                        ):
                            src = src_key[ti][ii]
                            src = src.decode("utf-8") if isinstance(src, bytes) else str(src)
                            if not os.path.isabs(src):
                                src = os.path.join(data_root, src)
                            copy_jobs.append((src, os.path.join(split_dir, dst_name)))
                            rel = os.path.relpath(os.path.join(split_dir, dst_name), out_root)
                            kept[out_key].append(rel)
                        kept["pixel_coordinates"].append(coords[ti][ii])
                        kept["asset_ids"].append(asset_ids[ti][ii])
                        kept["segmentation_ratios"].append(ratio)
                        kept["weights"].append(weights[flat_idx])
                        new_idx += 1
                    flat_idx += 1

            from perseus_tpu_torch.data.merge import _link_or_copy

            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(lambda job: _link_or_copy(*job), copy_jobs))

            splits[split] = schema.split_from_rows(kept)

    attrs["seg_ratio_lb"] = lb
    attrs["seg_ratio_ub"] = ub
    schema.write_pruned_dataset(output_hdf5_path, splits["train"], splits["test"], attrs)
    return output_hdf5_path
