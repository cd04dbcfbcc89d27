"""Port parity: the runtime's live loop and camera source
(perseus_tpu_torch/runtime/{streaming,sources}.py) against the JAX
package's, on the CPU.

  * StreamingPipeline loads the directory the port's trainer writes (and a
    ``.pth``): outputs equal to a pipeline built from the same state dict;
  * stream_frames: the same keypoints, images and poses as frame-by-frame
    calls, failed grabs skipped;
  * ZEDSource: with a stand-in ``pyzed.sl`` module (the SDK is not
    installed), the same init and runtime parameters and equal frames as the
    JAX package's ZEDSource; without it, ModuleNotFoundError;
  * run_display_loop, with cv2's window calls patched (``waitKey`` answers
    "q" at the third frame), against the JAX loop from the same ``.pth``, in
    f32: equal panes, circle pixels compared only where both packages'
    keypoints truncate to the same integer pixel;
  * main() raises the port's "CUDA is not available" error here.
"""

import sys
import types

import cv2
import numpy as np
import pytest
import torch

from perseus_tpu.runtime import sources as jsources
from perseus_tpu.runtime import streaming as jstreaming
from perseus_tpu_torch.models import convert, resnet
from perseus_tpu_torch.runtime import sources, streaming
from perseus_tpu_torch.runtime.sources import SyntheticSource
from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline, stream_frames
from perseus_tpu_torch.smoother.lm import SmootherConfig
from perseus_tpu_torch.train import checkpoint as ckpt

SMALL = dict(num_channels=4, model_h=32, model_w=32, amp=False)


def _is_stat(key):
    return key.endswith(("running_mean", "running_var"))


def _state_dict(seed: int) -> dict:
    """A random-init port state dict, BN statistics moved off 0 / 1."""
    gen = torch.Generator().manual_seed(seed)
    sd = resnet.KeypointCNN(n_keypoints=8, num_channels=4, device="cpu", generator=gen).state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=gen)
    return sd


def _frames(n, seed=3):
    source = SyntheticSource(height=48, width=64, depth=True, seed=seed)
    return [source.get_frame() for _ in range(n)]


def _outputs(pipeline, frames):
    carry = pipeline.init_carry()
    out = []
    for f in frames:
        kp, image, carry, pose = pipeline(f, carry)
        out.append((kp, image, pose.rot, pose.trans))
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert torch.equal(torch.as_tensor(u), torch.as_tensor(v))


def test_pipeline_loads_a_port_checkpoint_directory(tmp_path):
    """The directory save_train_state writes (as train() does) and a .pth
    give what the state dict itself gives, smoother included."""
    sd = _state_dict(6)
    run_dir = str(tmp_path / "run")
    ckpt.save_train_state(run_dir, {
        "params": {k: v for k, v in sd.items() if not _is_stat(k)},
        "batch_stats": {k: v for k, v in sd.items() if _is_stat(k)},
        "epoch": 3,
    })
    pth = str(tmp_path / "model.pth")
    torch.save(convert.to_reference_sd(sd), pth)
    cfg = StreamingConfig(smoother=SmootherConfig(window=4, max_iterations=1), **SMALL)
    frames = _frames(2)
    want = _outputs(StreamingPipeline(cfg, sd, device="cpu"), frames)
    for path in (run_dir, pth):
        cfg_path = StreamingConfig(model_path=path, smoother=SmootherConfig(window=4, max_iterations=1), **SMALL)
        _assert_same(_outputs(StreamingPipeline(cfg_path, device="cpu"), frames), want)


class _Flaky:
    """A source whose every other grab fails (None)."""

    def __init__(self, frames):
        self.frames, self.grabs, self.closed = list(frames), 0, False

    def get_frame(self):
        self.grabs += 1
        return None if self.grabs % 2 == 0 else self.frames.pop(0)

    def close(self):
        self.closed = True


def test_stream_frames_matches_frame_by_frame_calls():
    cfg = StreamingConfig(smooth=False, **SMALL)
    pipeline = StreamingPipeline(cfg, _state_dict(7), device="cpu")
    frames = _frames(4, seed=5)
    want = _outputs(pipeline, frames[:3])
    got = []

    def keep(kp, image, pose):
        assert isinstance(kp, np.ndarray) and isinstance(image, np.ndarray)
        got.append((kp, image, pose.rot, pose.trans))

    source = _Flaky(frames)
    assert stream_frames(pipeline, source, n_frames=3, on_frame=keep) == 3
    assert source.grabs == 5  # two failed grabs skipped
    _assert_same(got, want)
    # on_frame's True stops the loop
    assert stream_frames(pipeline, _Flaky(frames), on_frame=lambda *a: True) == 1


def _stand_in_pyzed(open_ok: bool = True):
    """A stand-in for the ZED SDK's ``pyzed.sl``: records every parameter
    set, serves seeded BGRA images and depth maps."""
    sl = types.ModuleType("pyzed.sl")
    ns = types.SimpleNamespace
    sl.VIEW = ns(LEFT="VIEW.LEFT", RIGHT="VIEW.RIGHT")
    sl.MEASURE = ns(DEPTH="MEASURE.DEPTH", DEPTH_RIGHT="MEASURE.DEPTH_RIGHT")
    sl.FLIP_MODE = ns(OFF="FLIP_MODE.OFF")
    sl.RESOLUTION = ns(VGA="RESOLUTION.VGA")
    sl.DEPTH_MODE = ns(NEURAL="DEPTH_MODE.NEURAL", NONE="DEPTH_MODE.NONE")
    sl.UNIT = ns(METER="UNIT.METER")
    sl.ERROR_CODE = ns(SUCCESS="SUCCESS", FAILURE="FAILURE")

    class InitParameters:
        def set_from_serial_number(self, serial):
            self.serial_number = serial

    class RuntimeParameters:
        pass

    class Mat:
        def get_data(self):
            return self.data

    class Camera:
        opened = []

        def __init__(self):
            self.rng = np.random.default_rng(0)
            self.grabs, self.retrieved = 0, []
            Camera.opened.append(self)

        def open(self, params):
            self.init_params = dict(vars(params))
            return sl.ERROR_CODE.SUCCESS if open_ok else sl.ERROR_CODE.FAILURE

        def grab(self, runtime):
            self.runtime = dict(vars(runtime))
            self.grabs += 1
            return sl.ERROR_CODE.FAILURE if self.grabs == 2 else sl.ERROR_CODE.SUCCESS

        def retrieve_image(self, mat, view):
            mat.data = self.rng.integers(0, 256, (6, 8, 4), dtype=np.uint8)
            self.retrieved.append(view)

        def retrieve_measure(self, mat, measure):
            mat.data = self.rng.uniform(0.1, 0.5, (6, 8)).astype(np.float32)
            self.retrieved.append(measure)

        def close(self):
            self.closed = True

    sl.InitParameters, sl.RuntimeParameters, sl.Mat, sl.Camera = InitParameters, RuntimeParameters, Mat, Camera
    pkg = types.ModuleType("pyzed")
    pkg.sl = sl
    return pkg, sl


def test_zed_source_needs_pyzed(monkeypatch):
    monkeypatch.delitem(sys.modules, "pyzed", raising=False)
    monkeypatch.delitem(sys.modules, "pyzed.sl", raising=False)
    with pytest.raises(ModuleNotFoundError):
        sources.ZEDSource(serial_number=1)


@pytest.mark.parametrize("depth, side", [(True, "left"), (False, "right")])
def test_zed_source_matches_jax_with_a_stand_in_sdk(monkeypatch, depth, side):
    pkg, sl = _stand_in_pyzed()
    monkeypatch.setitem(sys.modules, "pyzed", pkg)
    monkeypatch.setitem(sys.modules, "pyzed.sl", sl)
    cams = []
    for cls in (sources.ZEDSource, jsources.ZEDSource):
        src = cls(serial_number=19798856, depth=depth, side=side)
        frames = [src.get_frame() for _ in range(3)]
        src.close()
        cams.append((sl.Camera.opened[-1], frames))
    (ours, ours_frames), (theirs, theirs_frames) = cams
    assert ours.init_params == theirs.init_params and ours.init_params["serial_number"] == 19798856
    assert ours.init_params["camera_fps"] == 100 and ours.init_params["camera_resolution"] == "RESOLUTION.VGA"
    assert ours.runtime == theirs.runtime and ours.retrieved == theirs.retrieved
    assert ours.closed and theirs.closed
    assert ours_frames[1] is None and theirs_frames[1] is None  # the failed grab
    for a, b in zip(ours_frames[::2], theirs_frames[::2]):
        assert a.dtype == b.dtype == np.float32 and a.shape == (6, 8, 4 if depth else 3)
        np.testing.assert_array_equal(a, b)

    pkg, sl = _stand_in_pyzed(open_ok=False)
    monkeypatch.setitem(sys.modules, "pyzed", pkg)
    monkeypatch.setitem(sys.modules, "pyzed.sl", sl)
    with pytest.raises(RuntimeError, match="failed to open"):
        sources.ZEDSource(serial_number=1, depth=depth, side=side)


class _Recorded(SyntheticSource):
    closed = False

    def close(self):
        self.closed = True


def _patched_cv2(monkeypatch, shown, centers):
    """cv2's window calls patched: imshow records, waitKey answers "q" at
    the third frame, circle records its centre and draws."""
    real_circle = cv2.circle
    waits = {"n": 0}

    def wait_key(delay):
        waits["n"] += 1
        return ord("q") if waits["n"] == 3 else -1

    def circle(pane, center, radius, color, thickness):
        centers.append(center)
        return real_circle(pane, center, radius, color, thickness)

    monkeypatch.setattr(cv2, "namedWindow", lambda *a, **k: None)
    monkeypatch.setattr(cv2, "imshow", lambda name, image: shown.append(image.copy()))
    monkeypatch.setattr(cv2, "waitKey", wait_key)
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
    monkeypatch.setattr(cv2, "circle", circle)


def test_display_loop_matches_jax(monkeypatch, tmp_path):
    pth = str(tmp_path / "display.pth")
    torch.save(convert.to_reference_sd(_state_dict(8)), pth)
    runs = {}
    for name, module, cfg_cls, kw in (
        ("port", streaming, StreamingConfig, dict(device="cpu")),
        ("jax", jstreaming, jstreaming.StreamingConfig, {}),
    ):
        shown, centers = [], []
        with monkeypatch.context() as mp:
            _patched_cv2(mp, shown, centers)
            source = _Recorded(height=48, width=64, depth=True, seed=4)
            module.run_display_loop(cfg_cls(model_path=pth, smooth=False, **SMALL), source, **kw)
        assert source.closed
        runs[name] = (shown, centers)
    (ours, our_centers), (theirs, their_centers) = runs["port"], runs["jax"]
    assert len(ours) == len(theirs) == 3
    assert len(our_centers) == len(their_centers) == 3 * 2 * 8  # 8 keypoints on 2 panes, 3 frames
    assert sum(0 <= x < 32 and 0 <= y < 32 for x, y in our_centers) >= 6  # circles drawn in the panes
    # circles whose centres differ (a keypoint within rounding of an integer)
    # are left out of the comparison: a disk of radius 6 around both centres
    yy, xx = np.mgrid[:32, :32]
    n_differ = 0
    for f, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape == (32, 64, 3) and a.dtype == np.uint8
        keep = np.ones(a.shape[:2], bool)
        for j in range(16):
            p, q = our_centers[16 * f + j], their_centers[16 * f + j]
            if p != q:
                n_differ += 1
                offset = 32 * (j // 8)  # the depth pane lies right of the RGB pane
                for cx, cy in (p, q):
                    near = (xx - cx) ** 2 + (yy - cy) ** 2 <= 36
                    keep[:, offset : offset + 32] &= ~near
        np.testing.assert_array_equal(a[keep], b[keep])
    assert n_differ <= 4, (our_centers, their_centers)


def test_main_runs_on_the_card_with_no_fallback(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    monkeypatch.setattr(sys, "argv", ["streaming"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        streaming.main()
