"""Frame sources for the streaming runtime (numpy only).

A copy of ``perseus_tpu/runtime/sources.py``'s ``DatasetReplaySource`` and
``SyntheticSource``; the ZED camera source comes with a later slice. Sources
emit (H, W, 3 or 4) float32 frames: RGB in [0, 1] and raw metric depth.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

__all__ = ["FrameSource", "DatasetReplaySource", "SyntheticSource"]


class FrameSource(Protocol):
    def get_frame(self) -> np.ndarray | None: ...

    def close(self) -> None: ...


class DatasetReplaySource:
    """Replays frames from a pruned dataset split (depth is re-scaled back
    to metric so the pipeline's /cube_scale matches the camera path)."""

    def __init__(self, dataset, cube_scale: float = 0.035, loop: bool = True, depth: bool = True):
        self.dataset = dataset
        self.cube_scale = cube_scale
        self.loop = loop
        self.depth = depth
        self._i = 0

    def get_frame(self) -> np.ndarray | None:
        if self._i >= len(self.dataset):
            if not self.loop:
                return None
            self._i = 0
        item = self.dataset[self._i]
        self._i += 1
        frame = item["image"]
        if self.depth:
            metric_depth = item["depth_image"] * self.cube_scale
            frame = np.concatenate([frame, metric_depth[..., None]], axis=-1)
        return frame.astype(np.float32)

    def close(self) -> None:
        pass


class SyntheticSource:
    """Procedural frames at a configurable resolution (benchmarks/tests)."""

    def __init__(self, height: int = 376, width: int = 672, depth: bool = True, seed: int = 0):
        self.h, self.w, self.depth = height, width, depth
        self._rng = np.random.default_rng(seed)

    def get_frame(self) -> np.ndarray:
        c = 4 if self.depth else 3
        frame = self._rng.uniform(0, 1, size=(self.h, self.w, c)).astype(np.float32)
        if self.depth:
            frame[..., 3] = self._rng.uniform(0.1, 0.5, size=(self.h, self.w))
        return frame

    def close(self) -> None:
        pass
