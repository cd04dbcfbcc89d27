"""Streaming runtime: camera frame -> keypoints -> pose, one CUDA graph a frame.

Port of ``perseus_tpu/runtime/streaming.py``. One call per frame runs

  preprocess (NaN/Inf depth -> 0, depth / cube_scale, deterministic near/far
  clamp, center crop)
  -> the detector (bf16 with ``amp``) that ``StreamingConfig.detector``
     names: the folded-BN ResNet-18, whose stem maxpool is the CUDA kernel
     of ``models/pool.py``, or SwinV2-T (``models/swinv2.py``), whose window
     attention is kernel #8
  -> keypoint denormalization
  -> fixed-lag smoother update

with the same ``__call__(frame, carry) -> (keypoints, image, carry, pose)``
as the JAX pipeline. Nothing in the step reads back to the host, so on the
card the step is captured into a CUDA graph on the first call and replayed
after (``utils/graphed.py``: the JAX package's ``jax.jit`` of the step),
one graph launch a frame; the frame's copy to the card stays outside the
graph. :meth:`StreamingPipeline.step_eager` runs the same step eagerly
(for checks and debugging); on the CPU the call is that eager step.

:func:`stream_frames` is the live loop without a display: frames from a
source through the pipeline, keypoints and image read back once per frame.
:func:`run_display_loop` draws them with ``cv2`` (imported inside it: the
card's machine has none), and :func:`main` runs it on a ZED camera.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from perseus_tpu_torch import ROOT, resolve_device
from perseus_tpu_torch.augment.ops import depth_plane_clamp
from perseus_tpu_torch.camera import center_crop_hw, denormalize_pixel_coordinates, intrinsics_from_fov
from perseus_tpu_torch.datagen.labeling import cube_corners
from perseus_tpu_torch.lie import SE3, se3_identity
from perseus_tpu_torch.models import resnet, swinv2
from perseus_tpu_torch.smoother.fixed_lag import FixedLagSmoother, SmootherCarry
from perseus_tpu_torch.smoother.lm import SmootherConfig
from perseus_tpu_torch.train import checkpoint as ckpt
from perseus_tpu_torch.utils.graphed import Graphed
from perseus_tpu_torch.utils.spans import span

__all__ = ["StreamingConfig", "StreamingPipeline", "stream_frames", "run_display_loop", "main"]


def _prepare_swinv2_t(sd: dict, cfg: "StreamingConfig", compute_dtype: torch.dtype) -> dict:
    arch = swinv2.swinv2_tiny_patch4_window8_256(cfg.num_channels, 2 * cfg.smoother.n_keypoints)
    return swinv2.prepare(sd, arch, compute_dtype)


# StreamingConfig.detector -> (prepare(state_dict, cfg, compute_dtype),
# apply(prepared, x NCHW, compute_dtype) -> (B, 2K) normalized keypoints)
DETECTORS = {
    "resnet18": (lambda sd, cfg, dtype: resnet.fold_batchnorm(sd),
                 lambda folded, x, dtype: resnet.keypoint_cnn_apply_folded(folded, x, compute_dtype=dtype)),
    "swinv2_t": (_prepare_swinv2_t, swinv2.swinv2_apply),
}


@dataclass(frozen=True)
class StreamingConfig:
    """Streaming pipeline configuration: the JAX package's field for field,
    and ``detector``, which it lacks (the JAX package serves ResNet-18
    alone): ``"resnet18"``, the ResNet-18 ``KeypointCNN``, or
    ``"swinv2_t"``, SwinV2-T (``models/swinv2.py``'s published preset with
    ``num_channels`` inputs and 2 x ``smoother.n_keypoints`` outputs)."""

    model_path: str = f"{ROOT}/outputs/models/latest"
    num_channels: int = 3  # 3 -> RGB model, 4 -> RGBD model
    model_h: int = 256
    model_w: int = 256
    cube_scale: float = 0.035
    apply_depth_clamp: bool = True
    amp: bool = True
    # smoother
    smooth: bool = True
    smoother: SmootherConfig = field(default_factory=lambda: SmootherConfig(window=24))
    camera_fov: float = 1.0  # rad; used to build intrinsics for the smoother
    # simulation replay: rendered depth already in cube units, and a
    # smoother corner scale that may differ from cube_scale (0 -> cube_scale)
    depth_in_cube_units: bool = False
    corner_scale: float = 0.0
    detector: str = "resnet18"


class StreamingPipeline:
    """Frame -> (keypoints, image, carry, pose) on ``device``.

    ``state_dict`` is the detector's parameters: for ResNet-18 its parameters
    and BN statistics in the port's layout (``convert.from_jax_params``,
    ``KeypointCNN.state_dict()``), folded here; for SwinV2-T the official
    repository's names, prepared here (``swinv2.prepare``); either is kept
    as ``folded``, the weights as served. When None it is loaded from ``cfg.model_path``: a port checkpoint directory (what
    ``train()`` writes) or a ``.pth``.
    """

    def __init__(
        self,
        cfg: StreamingConfig,
        state_dict: dict[str, torch.Tensor] | None = None,
        device: str | torch.device | None = "cuda",
    ):
        self.cfg = cfg
        if cfg.detector not in DETECTORS:
            raise ValueError(f"StreamingConfig.detector {cfg.detector!r}: one of {tuple(DETECTORS)}")
        prepare, self._detect = DETECTORS[cfg.detector]
        self.device = resolve_device(device)
        if state_dict is None:
            state_dict = ckpt.load_model(cfg.model_path)
        sd = {k: v.detach().to(self.device, torch.float32) for k, v in state_dict.items()}
        self.compute_dtype = torch.bfloat16 if cfg.amp else torch.float32
        self.folded = prepare(sd, cfg, self.compute_dtype)

        self.smoother = None
        if cfg.smooth:
            fov = torch.tensor(cfg.camera_fov, dtype=torch.float32, device=self.device)
            intr = intrinsics_from_fov(fov, cfg.model_h, cfg.model_w)
            corners = cube_corners(cfg.corner_scale or cfg.cube_scale, device=self.device)
            self.smoother = FixedLagSmoother(cfg.smoother, intr, corners)
        self._step = Graphed(self.step_eager, self.device)

    def init_carry(self, initial_pose: SE3 | None = None) -> SmootherCarry | None:
        """Fresh smoother carry; pass `initial_pose` (e.g. from
        FixedLagSmoother.coarse_pose_from_keypoints on the first detection)
        to cold-start near the true pose."""
        return self.smoother.init(initial_pose) if self.smoother is not None else None

    def preprocess(self, frame: torch.Tensor) -> torch.Tensor:
        """(H, W, 3|4) float32 -> (h, w, C) model input."""
        cfg = self.cfg
        rgb = frame[..., :3]
        if cfg.num_channels >= 4:
            depth = frame[..., 3]
            depth = torch.where(torch.isfinite(depth), depth, 0.0)
            if not cfg.depth_in_cube_units:  # metric camera depth
                depth = depth / cfg.cube_scale
            if cfg.apply_depth_clamp:
                depth = depth_plane_clamp(depth, cube_scale=cfg.cube_scale)
            frame = torch.cat([rgb, depth[..., None]], dim=-1)
        else:
            frame = rgb
        return center_crop_hw(frame, cfg.model_h, cfg.model_w)

    def __call__(self, frame: np.ndarray | torch.Tensor, carry: SmootherCarry | None):
        """One frame in; (keypoints_px (K, 2), model_image, carry, pose) out.
        On the card, a replay of the captured step (captured on the first
        call for the frame's shape); a host frame is copied into the
        graph's frame buffer. The span ``serve.frame`` starts the frame's
        id."""
        with span("serve.frame"):
            return self._step(torch.as_tensor(frame, dtype=torch.float32), carry)

    @torch.no_grad()
    def step_eager(self, frame: np.ndarray | torch.Tensor, carry: SmootherCarry | None):
        """The step of :meth:`__call__`, run eagerly on the pipeline's device
        (a frame elsewhere is copied there first)."""
        cfg = self.cfg
        image = self.preprocess(torch.as_tensor(frame, dtype=torch.float32, device=self.device))
        x = image.permute(2, 0, 1)[None].contiguous()  # NCHW
        with span("serve.detector", self.device):
            pred = self._detect(self.folded, x, self.compute_dtype)
        keypoints = denormalize_pixel_coordinates(pred.reshape(-1, 2), cfg.model_h, cfg.model_w)
        if self.smoother is not None:
            with span("smoother.update", self.device):
                carry, pose = self.smoother.update(carry, keypoints)
            return keypoints, image, carry, pose
        return keypoints, image, carry, se3_identity(torch.float32, self.device)


def stream_frames(
    pipeline: StreamingPipeline,
    source,
    n_frames: int | None = None,
    on_frame: Callable[[np.ndarray, np.ndarray, SE3], bool | None] | None = None,
) -> int:
    """The live loop without a display: grabs frames from ``source``
    (a failed grab, ``None``, is skipped), runs each through ``pipeline``
    from a fresh carry, and hands (keypoints (K, 2), model image (h, w, C),
    pose) to ``on_frame``, keypoints and image read back to the host once
    per frame (the pose stays on the pipeline's device). Stops after
    ``n_frames`` frames (None: no limit) or when ``on_frame`` returns True;
    returns the frames run."""
    carry = pipeline.init_carry()
    done = 0
    while n_frames is None or done < n_frames:
        frame = source.get_frame()
        if frame is None:
            continue
        keypoints, image, carry, pose = pipeline(frame, carry)
        done += 1
        if on_frame is not None and on_frame(keypoints.cpu().numpy(), image.cpu().numpy(), pose):
            break
    return done


def run_display_loop(
    cfg: StreamingConfig,
    source,
    device: str | torch.device | None = "cuda",
    window_name: str = "perseus-tpu stream",
) -> None:
    """Live overlay display (needs ``cv2`` and a display): the model image
    in BGR order, beside it a depth pane (``cv2.normalize`` to 0-255, jet
    colour map) for RGBD models, the keypoints as filled circles of radius
    5 (blue on the image, green on depth); ``q`` quits. The model is loaded
    from ``cfg.model_path``; the source is closed on exit."""
    import cv2

    pipeline = StreamingPipeline(cfg, device=device)
    cv2.namedWindow(window_name, cv2.WINDOW_NORMAL)

    def show(keypoints: np.ndarray, image: np.ndarray, pose: SE3) -> bool:
        rgb = (np.clip(image[..., :3], 0, 1) * 255).astype(np.uint8)
        panes = [rgb[..., ::-1].copy()]
        if image.shape[-1] > 3:
            depth_norm = cv2.normalize(image[..., 3], None, 0, 255, cv2.NORM_MINMAX)
            panes.append(cv2.applyColorMap(depth_norm.astype(np.uint8), cv2.COLORMAP_JET))
        for pane, color in zip(panes, ((255, 0, 0), (0, 255, 0))):
            for kp in keypoints:
                cv2.circle(pane, (int(kp[0]), int(kp[1])), 5, color, -1)
        cv2.imshow(window_name, np.hstack(panes))
        return cv2.waitKey(1) & 0xFF == ord("q")

    try:
        stream_frames(pipeline, source, on_frame=show)
    finally:
        source.close()
        cv2.destroyAllWindows()


def main() -> None:
    """The live display on the ZED camera of the reference's rig, on the card."""
    from perseus_tpu_torch.configs.cli import cli
    from perseus_tpu_torch.runtime.sources import ZEDSource

    cfg = cli(StreamingConfig)
    device = resolve_device("cuda")  # before the camera opens
    source = ZEDSource(serial_number=19798856, depth=True)
    run_display_loop(cfg, source, device)


if __name__ == "__main__":
    main()
