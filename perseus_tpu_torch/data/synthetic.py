"""Synthetic keypoint examples, made in memory.

The port's copy of ``perseus_tpu/data/synthetic.py::_make_example``: a noise
background with random depth, one filled square "cube face" nearer the
camera, its exact segmentation, and its 4 corners (plus the same corners
nudged, as a fake back face) as keypoints. :func:`make_batch` stacks
examples into the host batch layout of the JAX package's dataset, for
driving the train step without the HDF5 dataset.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_batch"]


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
