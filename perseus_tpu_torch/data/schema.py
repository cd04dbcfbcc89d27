"""The pruned dataset's layouts: the HDF5 + image files of the JAX package,
and the port's decoded split.

The port's copy of ``perseus_tpu/data/schema.py``: the pruned per-image
HDF5 (``PRUNED_DATASET_KEYS`` per split, attrs ``H``, ``W``,
``num_keypoints`` ...) with RGB PNGs, float32 depth TIFFs and byte
segmentation PNGs on disk, and the inverse-bin-frequency ``weights``.
``h5py`` and ``PIL`` are imported inside the functions that need them, so
the module imports where they are missing.

The decoded split (:func:`write_decoded_split`, :func:`read_decoded_split`,
:func:`decode_pruned_dataset`) adds no training capability: it is the JAX
reader's compact cache (``perseus_tpu/data/dataset.py``'s ``cache=True``:
RGB ``uint8``, depth ``f32``, segmentation ``bool``) written to disk, so
that a host without ``h5py`` and ``PIL`` (the card's) reads a split. A
directory holding ``attrs.json`` (``H``, ``W``, ``num_keypoints`` and the
rest of the HDF5 attrs) and ``train/`` and ``test/``, each one ``.npy`` per
array: the images :data:`IMAGE_KEYS` (``image_u8`` (N, H, W, 3),
``depth_image`` (N, H, W), ``seg_b`` (N, H, W)) and the metadata rows
:data:`PRUNED_DATASET_KEYS`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "PRUNED_DATASET_KEYS",
    "IMAGE_KEYS",
    "PrunedSplit",
    "split_from_rows",
    "read_pruned_split",
    "write_pruned_dataset",
    "save_rgb_png",
    "load_rgb_png",
    "save_depth_tiff",
    "load_depth_tiff",
    "save_segmentation_png",
    "load_segmentation_png",
    "compute_weights",
    "is_decoded_split",
    "open_decoded_arrays",
    "write_decoded_split",
    "write_decoded_attrs",
    "read_decoded_split",
    "decode_pruned_dataset",
]

# per-image flat rows of the pruned layout
PRUNED_DATASET_KEYS = (
    "image_filenames",
    "depth_filenames",
    "segmentation_filenames",
    "pixel_coordinates",
    "asset_ids",
    "segmentation_ratios",
    "weights",
)

# the decoded images of a decoded split, as the JAX reader's compact cache
IMAGE_KEYS = ("image_u8", "depth_image", "seg_b")


@dataclass
class PrunedSplit:
    """In-memory metadata for one split of a pruned dataset."""

    image_filenames: list[str]
    depth_filenames: list[str]
    segmentation_filenames: list[str]
    pixel_coordinates: np.ndarray  # (N, K, 2) float32
    asset_ids: np.ndarray  # (N,) int
    segmentation_ratios: np.ndarray = field(default_factory=lambda: np.zeros(0))
    weights: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def __len__(self) -> int:
        return len(self.image_filenames)


def split_from_rows(rows: dict) -> PrunedSplit:
    """A split from per-row lists under :data:`PRUNED_DATASET_KEYS` (names
    as strings, each row's keypoints, asset id, ratio and weight), in the
    dtypes ``data/prune.py`` writes: keypoints f32, the rest as numpy infers
    them (so an empty split's arrays are (0,) f64, as prune's)."""
    return PrunedSplit(
        image_filenames=list(rows["image_filenames"]),
        depth_filenames=list(rows["depth_filenames"]),
        segmentation_filenames=list(rows["segmentation_filenames"]),
        pixel_coordinates=np.asarray(rows["pixel_coordinates"], dtype=np.float32),
        asset_ids=np.asarray(rows["asset_ids"]),
        segmentation_ratios=np.asarray(rows["segmentation_ratios"]),
        weights=np.asarray(rows["weights"]),
    )


def _decode_names(arr) -> list[str]:
    return [x.decode("utf-8") if isinstance(x, bytes) else str(x) for x in arr[()]]


def read_pruned_split(path: str, train: bool = True) -> tuple[PrunedSplit, dict]:
    """Reads one split of a pruned HDF5 plus the file attrs (H, W,
    num_keypoints, ...). Needs ``h5py``."""
    import h5py

    with h5py.File(path, "r") as f:
        g = f["train" if train else "test"]
        split = PrunedSplit(
            image_filenames=_decode_names(g["image_filenames"]),
            depth_filenames=_decode_names(g["depth_filenames"]),
            segmentation_filenames=_decode_names(g["segmentation_filenames"]),
            pixel_coordinates=np.asarray(g["pixel_coordinates"][()], dtype=np.float32),
            asset_ids=np.asarray(g["asset_ids"][()]),
            segmentation_ratios=np.asarray(g.get("segmentation_ratios", np.zeros(0))[()]),
            weights=np.asarray(g.get("weights", np.zeros(0))[()]),
        )
        attrs = dict(f.attrs)
    return split, attrs


def write_pruned_dataset(path: str, train: PrunedSplit, test: PrunedSplit, attrs: dict) -> None:
    """Writes a pruned HDF5 with both splits and ``attrs``. Needs ``h5py``."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        for name, split in [("train", train), ("test", test)]:
            g = f.create_group(name)
            for key in ("image_filenames", "depth_filenames", "segmentation_filenames"):
                g.create_dataset(key, data=np.asarray(getattr(split, key), dtype="S"))
            for key in ("pixel_coordinates", "asset_ids", "segmentation_ratios", "weights"):
                g.create_dataset(key, data=getattr(split, key))
        for key, value in attrs.items():
            f.attrs[key] = value


# ----------------------------- image files --------------------------------


def _atomic_save(img, path: str) -> None:
    """Write-to-temp + os.replace: a dataset may hard-link another's image
    files, and a new inode leaves the linked copies' bytes alone."""
    from PIL import Image

    tmp = path + ".tmp"
    img.save(tmp, format=Image.registered_extensions().get(os.path.splitext(path)[1]))
    os.replace(tmp, path)


def rgb_to_u8(rgb01: np.ndarray) -> np.ndarray:
    """(H, W, 3) float [0, 1] -> the uint8 bytes :func:`save_rgb_png`
    stores (scaled, clipped, truncated); uint8 passes through."""
    if rgb01.dtype == np.uint8:
        return rgb01
    return np.clip(rgb01 * 255.0, 0, 255).astype(np.uint8)


def save_rgb_png(path: str, rgb01: np.ndarray) -> None:
    """Saves an (H, W, 3) float [0,1] or uint8 array as PNG."""
    from PIL import Image

    _atomic_save(Image.fromarray(rgb_to_u8(rgb01)), path)


def _load_rgb_u8(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_rgb_png(path: str) -> np.ndarray:
    """Loads a PNG as (H, W, 3) float32 in [0, 1]."""
    return np.asarray(_load_rgb_u8(path), dtype=np.float32) / 255.0


def save_depth_tiff(path: str, depth: np.ndarray) -> None:
    """Saves (H, W) float32 depth as a 32-bit float TIFF."""
    from PIL import Image

    _atomic_save(Image.fromarray(depth.astype(np.float32), mode="F"), path)


def load_depth_tiff(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im, dtype=np.float32)


def save_segmentation_png(path: str, seg: np.ndarray) -> None:
    """Saves (H, W) small-int segmentation indices as 8-bit PNG."""
    from PIL import Image

    _atomic_save(Image.fromarray(seg.astype(np.uint8)), path)


def load_segmentation_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


# ------------------------------- weights ----------------------------------


def compute_weights(segmentation_ratios: np.ndarray, num_bins: int = 100) -> np.ndarray:
    """Inverse-bin-frequency weights over seg-ratio bins (100 bins over
    [0, 1])."""
    bin_edges = np.linspace(0, 1, num_bins)
    flat = segmentation_ratios.reshape(-1)
    bin_indices = np.digitize(flat, bins=bin_edges, right=True)
    weights = np.zeros(len(flat))
    for bin_idx in np.unique(bin_indices):
        mask = bin_indices == bin_idx
        weights[mask] = 1.0 / mask.sum()
    return weights


# ------------------------------ decoded split ------------------------------


def is_decoded_split(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "attrs.json"))


def open_decoded_arrays(out_dir: str, split_name: str, n: int, h: int, w: int) -> dict:
    """Fresh ``.npy`` files of a decoded split's three image arrays for
    ``n`` rows, opened for writing (memory-mapped): a writer fills them row
    by row without holding the split in RAM."""
    split_dir = os.path.join(out_dir, split_name)
    os.makedirs(split_dir, exist_ok=True)
    shapes = {"image_u8": ((n, h, w, 3), np.uint8), "depth_image": ((n, h, w), np.float32),
              "seg_b": ((n, h, w), np.bool_)}
    return {
        k: np.lib.format.open_memmap(os.path.join(split_dir, f"{k}.npy"), mode="w+", dtype=dt, shape=shape)
        for k, (shape, dt) in shapes.items()
    }


def write_decoded_split(out_dir: str, split_name: str, split: PrunedSplit) -> None:
    """Writes ``split``'s metadata rows under ``out_dir/split_name`` (the
    images go through :func:`open_decoded_arrays`)."""
    split_dir = os.path.join(out_dir, split_name)
    os.makedirs(split_dir, exist_ok=True)
    for key in PRUNED_DATASET_KEYS:
        value = getattr(split, key)
        if key.endswith("filenames"):
            value = np.asarray(value, dtype=str)
        np.save(os.path.join(split_dir, f"{key}.npy"), np.asarray(value))


def write_decoded_attrs(out_dir: str, attrs: dict) -> None:
    """``attrs.json``, written last (it marks the directory as a decoded
    split), through a temporary name."""
    tmp = os.path.join(out_dir, "attrs.json.tmp")
    with open(tmp, "w") as f:
        json.dump({k: np.asarray(v).tolist() for k, v in attrs.items()}, f, indent=1)
    os.replace(tmp, os.path.join(out_dir, "attrs.json"))


def read_decoded_split(path: str, train: bool = True) -> tuple[PrunedSplit, dict, dict]:
    """One split of a decoded split: (metadata, attrs, images), the images
    :data:`IMAGE_KEYS` -> read-only memory-mapped arrays."""
    with open(os.path.join(path, "attrs.json")) as f:
        attrs = json.load(f)
    split_dir = os.path.join(path, "train" if train else "test")
    load = lambda k, **kw: np.load(os.path.join(split_dir, f"{k}.npy"), **kw)  # noqa: E731
    split = PrunedSplit(
        image_filenames=load("image_filenames").tolist(),
        depth_filenames=load("depth_filenames").tolist(),
        segmentation_filenames=load("segmentation_filenames").tolist(),
        pixel_coordinates=np.asarray(load("pixel_coordinates"), dtype=np.float32),
        asset_ids=load("asset_ids"),
        segmentation_ratios=load("segmentation_ratios"),
        weights=load("weights"),
    )
    images = {k: load(k, mmap_mode="r") for k in IMAGE_KEYS}
    return split, attrs, images


def decode_pruned_dataset(hdf5_path: str, out_dir: str) -> str:
    """Decodes a pruned HDF5 and its image files into a decoded split at
    ``out_dir`` (needs ``h5py`` and ``PIL``; run it where they exist and
    copy the directory). Rows are decoded one at a time straight into the
    memory-mapped arrays. Returns ``out_dir``."""
    import h5py

    data_root = os.path.dirname(os.path.dirname(os.path.abspath(hdf5_path)))
    resolve = lambda name: os.path.join(data_root, name)  # noqa: E731
    with h5py.File(hdf5_path, "r") as f:
        attrs = dict(f.attrs)
    h, w = int(attrs["H"]), int(attrs["W"])
    for train in (True, False):
        name = "train" if train else "test"
        split, _ = read_pruned_split(hdf5_path, train=train)
        arrays = open_decoded_arrays(out_dir, name, len(split), h, w)
        for i in range(len(split)):
            arrays["image_u8"][i] = _load_rgb_u8(resolve(split.image_filenames[i]))
            arrays["depth_image"][i] = load_depth_tiff(resolve(split.depth_filenames[i]))
            seg = load_segmentation_png(resolve(split.segmentation_filenames[i]))
            arrays["seg_b"][i] = seg == split.asset_ids[i] + 1
        for a in arrays.values():
            a.flush()
        write_decoded_split(out_dir, name, split)
    write_decoded_attrs(out_dir, attrs)
    return out_dir
