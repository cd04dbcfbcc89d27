"""Frame sources for the streaming runtime (numpy only).

A copy of ``perseus_tpu/runtime/sources.py``: the ZED stereo camera through
``pyzed`` (imported when a camera is opened: a hardware-only dependency), a
replay of a pruned dataset split, and procedural frames. Sources emit
(H, W, 3 or 4) float32 frames: RGB in [0, 1] and raw metric depth.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

__all__ = ["FrameSource", "ZEDSource", "DatasetReplaySource", "SyntheticSource"]


class FrameSource(Protocol):
    def get_frame(self) -> np.ndarray | None: ...

    def close(self) -> None: ...


class ZEDSource:
    """ZED stereo camera via pyzed, with the reference rig's settings
    (VGA at 100 fps, NEURAL depth, fill mode, a [0.1, 0.5] m depth range).
    Emits full-resolution frames; the pipeline crops and scales them."""

    def __init__(self, serial_number: int, depth: bool = True, side: str = "left") -> None:
        from pyzed import sl  # hardware-only dependency

        self._sl = sl
        self.depth = depth
        self.rgb_view = sl.VIEW.LEFT if side == "left" else sl.VIEW.RIGHT
        if depth:
            self.depth_measure = sl.MEASURE.DEPTH if side == "left" else sl.MEASURE.DEPTH_RIGHT

        self.camera = sl.Camera()
        self.rgb_buffer = sl.Mat()
        self.runtime_parameters = sl.RuntimeParameters()

        init_params = sl.InitParameters()
        init_params.camera_image_flip = sl.FLIP_MODE.OFF
        init_params.camera_resolution = sl.RESOLUTION.VGA
        init_params.camera_fps = 100
        init_params.depth_mode = sl.DEPTH_MODE.NEURAL if depth else sl.DEPTH_MODE.NONE
        init_params.depth_stabilization = 100
        init_params.coordinate_units = sl.UNIT.METER
        if depth:
            init_params.depth_minimum_distance = 0.1
            init_params.depth_maximum_distance = 0.5
            self.depth_buffer = sl.Mat()
        else:
            init_params.depth_minimum_distance = 0.3
            init_params.depth_maximum_distance = 1.0
        init_params.set_from_serial_number(serial_number)

        self.runtime_parameters.enable_depth = depth
        if depth:
            self.runtime_parameters.enable_fill_mode = True

        err = self.camera.open(init_params)
        if err != sl.ERROR_CODE.SUCCESS:
            raise RuntimeError(f"ZED camera failed to open: {err}")

    def get_frame(self) -> np.ndarray | None:
        sl = self._sl
        if self.camera.grab(self.runtime_parameters) != sl.ERROR_CODE.SUCCESS:
            return None
        self.camera.retrieve_image(self.rgb_buffer, self.rgb_view)
        bgr = self.rgb_buffer.get_data()[..., :3]
        frame = (bgr[..., ::-1] / 255.0).astype(np.float32)
        if self.depth:
            self.camera.retrieve_measure(self.depth_buffer, self.depth_measure)
            depth = self.depth_buffer.get_data().astype(np.float32)
            frame = np.concatenate([frame, depth[..., None]], axis=-1)
        return frame

    def close(self) -> None:
        self.camera.close()


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
