"""Camera traffic: one camera, one caller, closed loop.

Each host frame (a pageable (H, W, 4) f32 array) goes to
``StreamingPipeline.__call__`` when the previous frame's keypoints and pose
are back on the host; a frame's latency runs from the hand-over to that
read-back. The frames cycle through a pool drawn from the seed; each is
first written into one reused host buffer, as a camera SDK writes every
grab into the same image (ZED's ``retrieve_image`` into one ``sl.Mat``),
outside the latency. The detector is the plug-in the configuration names
(``detectors/<name>.py``, ``run.detector``). Its weights are seeded; its
head is calibrated so that its output is the projection of a cube at a
seeded pose plus a frame-dependent jitter of ``jitter_px`` (random weights
alone give keypoints the smoother cannot fit), and the smoother's carry
starts at that pose, as a controller's cold start would.

Parameters (the workload file's ``params``): ``pool_frames``, ``nan_share``
(depth holes), ``jitter_px``, ``warmup_frames`` (after the capture's own
warm-up), ``settle_block`` and ``settle_max_s`` (``Driver._settle``),
``traced_frames``, ``sample_frames`` (frames checked against the
reference), ``smooth`` (false: the detector alone, the reference's live
loop), ``control_frames`` (frames of a control run).

The check: for a seeded sample of the window's frames, the first and the
last among them, the reference runs preprocess, the plug-in's f32 detector
on weights it prepared itself and denormalize on the same host frame
(``kp_gap_px``, the widest keypoint gap), and, with the smoother, one
update from the program's carry before that frame: on the reference's own
keypoints where the cell's limits name ``pose_gap_px`` (the detector and
the smoother together: the widest gap over the sampled frames), on the
program's keypoints where they name ``smoother_gap_median_px`` (the
smoother alone: the median frame's gap, as an accept / reject step that
changes the cost by a few parts in ten million is decided either way by
sound float32 and float64 solves alike). A gap is the widest between the
cube corners projected under the program's and the reference's newest
pose; ``flags_mismatch`` counts the gate's validity flags, frame count and
reject count that differ after that update.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import harness, inputs, run
from benchmark.reference import pipeline as ref_pipe
from benchmark.reference import smoother as ref_smo


def _carry_dict(carry, dtype) -> dict:
    """A carry in the reference's form, in ``dtype`` (the program's
    ``SmootherCarry`` or a control's dict)."""
    if isinstance(carry, dict):
        src = carry
    else:
        w = carry.window
        src = {
            "rot": w.rot, "trans": w.trans, "ang_vel": w.ang_vel, "vel": w.vel,
            "measurements": carry.measurements, "valid": carry.valid,
            "prior_rot": carry.prior_rot, "prior_trans": carry.prior_trans,
            "prior_ang_vel": carry.prior_ang_vel, "prior_vel": carry.prior_vel,
            "frames_seen": carry.frames_seen, "consec_rejects": carry.consec_rejects,
        }
    out = {}
    for k, v in src.items():
        if k in ("frames_seen", "consec_rejects"):
            out[k] = int(v)
        else:
            out[k] = v.to(dtype)
    return out


def init_carry(rot, trans, window: int, n_kp: int) -> dict:
    """A fresh carry at pose (rot, trans), in the reference's form."""
    z = lambda *s: torch.zeros(s, dtype=rot.dtype, device=rot.device)  # noqa: E731
    return {
        "rot": rot.expand(window, 3, 3).clone(), "trans": trans.expand(window, 3).clone(),
        "ang_vel": z(window, 3), "vel": z(window, 3), "measurements": z(window, n_kp, 2), "valid": z(window),
        "prior_rot": rot.clone(), "prior_trans": trans.clone(), "prior_ang_vel": z(3), "prior_vel": z(3),
        "frames_seen": 0, "consec_rejects": 0,
    }


class _ControlPipeline:
    """The reference in the program's place, one precision lower than the
    configuration states: the detector's ``quantize`` (for ResNet-18
    float8 convolutions; bf16 stated), the smoother in f32 with TF32 (f32
    with TF32 off stated)."""

    def __init__(self, driver):
        self.d = driver

    def __call__(self, frame, carry):
        d = self.d
        x = d.preprocess(torch.as_tensor(frame, device=d.device))
        kp = ref_pipe.denormalize(d.detector.detect(d.prepared_ref, x, quantize=True), d.h, d.w)[0]
        if not d.smooth:
            return kp, x, carry, d.identity
        carry, (rot, trans) = ref_smo.update(d.smoother_cfg, carry, kp, d.corners.float(), d.k, tf32=True)
        return kp, x, carry, _Pose(rot, trans)


class _Pose:
    def __init__(self, rot, trans):
        self.rot, self.trans = rot, trans


class Driver:
    """One camera's closed loop on the served pipeline: ``setup``, the
    measured ``window``, ``traced`` frames, ``free`` and ``check``."""

    def __init__(self, cell: dict, config: dict, seed: int, device: torch.device):
        self.cell, self.config, self.seed, self.device = cell, config, seed, device
        self.p = cell["params"]
        self.smooth = bool(self.p["smooth"])
        self.h, self.w = config["model_h"], config["model_w"]
        self.fh, self.fw = config["frame_h"], config["frame_w"]
        self.smoother_cfg = config["smoother"]
        self.detector = run.detector(config)
        self.k = ref_smo.intrinsics(config["camera_fov"], self.h, self.w)
        self.corners = torch.tensor(inputs.CORNER_SIGNS * config["cube_scale"], dtype=torch.float64, device=device)
        self.identity = _Pose(torch.eye(3, device=device), torch.zeros(3, device=device))

    def preprocess(self, frame: torch.Tensor) -> torch.Tensor:
        c = self.config
        return ref_pipe.preprocess(frame, c["cube_scale"], c["depth_near_m"], c["depth_far_m"], self.h, self.w)

    def _weights(self) -> dict:
        """Seeded weights with the calibrated head (f32, on the device)."""
        c = self.config
        sd = self.detector.weights(self.seed, c, self.device)
        prepared = self.detector.prepare(sd)
        x = torch.cat([self.preprocess(torch.as_tensor(f, device=self.device)) for f in self.frames])
        with torch.no_grad():
            feats = self.detector.features(prepared, x).double()
        mu = feats.mean(0)
        g = torch.as_tensor(inputs.head_draw(self.seed, 2 * c["n_keypoints"], feats.shape[1]), device=self.device)
        spread = ((feats - mu) @ g.T).std()
        weight = g * (2.0 * self.p["jitter_px"] / (self.w - 1) / spread)
        rot, trans = inputs.cube_pose(self.seed)
        target = inputs.project_corners(rot, trans, c["cube_scale"], c["camera_fov"], self.h, self.w)
        target = np.stack([target[:, 0] * 2 / (self.w - 1) - 1, target[:, 1] * 2 / (self.h - 1) - 1], -1).reshape(-1)
        head_w, head_b = self.detector.HEAD
        sd[head_w] = weight.float()
        sd[head_b] = (torch.as_tensor(target, device=self.device) - weight @ mu).float()
        self.pose0 = (rot, trans)
        return sd

    def setup(self, smoother: dict | None = None) -> None:
        """``smoother``: the program's smoother settings where they are not
        the configuration's (a fault)."""
        from perseus_tpu_torch.lie import SE3
        from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline
        from perseus_tpu_torch.smoother.lm import SmootherConfig

        c = self.config
        t0 = time.perf_counter()
        self.frames = inputs.camera_frames(self.seed, self.p["pool_frames"], self.fh, self.fw, self.p["nan_share"])
        self.buffer = np.empty_like(self.frames[0])
        self.sd = self._weights()
        t1 = time.perf_counter()
        cfg = StreamingConfig(
            num_channels=c["num_channels"], model_h=self.h, model_w=self.w, cube_scale=c["cube_scale"],
            apply_depth_clamp=True, amp=c["compute_dtype"] == "bfloat16", smooth=self.smooth,
            smoother=SmootherConfig(**(smoother or self.smoother_cfg)), camera_fov=c["camera_fov"],
            **self.detector.streaming_fields(c),
        )
        self.pipeline = StreamingPipeline(cfg, state_dict=self.sd, device=self.device)
        rot, trans = (torch.as_tensor(a, dtype=torch.float32, device=self.device) for a in self.pose0)
        self.carry0 = self.pipeline.init_carry(SE3(rot, trans)) if self.smooth else None
        carry = self.carry0
        t2 = time.perf_counter()
        for i in range(self.p["warmup_frames"]):  # the first call captures the graph
            carry = self.step(self.grab(i), carry)[2]
        harness.synchronize(self.device)
        t3 = time.perf_counter()
        settled = self._settle(carry)
        harness.log(f"set-up: frames and weights {t1 - t0:.3f} s, pipeline {t2 - t1:.3f} s, "
                    f"capture and warm-up {t3 - t2:.3f} s, settling {time.perf_counter() - t3:.3f} s ({settled})")

    def _settle(self, carry) -> str:
        """Replays until the card runs the step at its kernels' speed.

        On the H100 every new process replays the long GN-4 graph (7,737
        small kernels) about a fifth slower at first: the same kernels'
        time, longer gaps between them, the same clocks and host launch
        time; after 0 to over 35 s it switches to its kernels' speed, as a
        long-running serving process runs (``PERF.md``). So the kernels'
        time a frame is read from two traced replays (the larger, since the
        trace can drop events), and blocks of ``settle_block`` replays of a
        frame already on the card run until a block takes at most 1.08 x
        that (the slow state reads about 1.18 x), or for ``settle_max_s``
        seconds."""
        limit = self.p["settle_max_s"]
        if limit <= 0 or self.device.type != "cuda":
            return "off"
        frame = torch.as_tensor(self.frames[0], device=self.device)
        state = [carry]

        def replay():
            state[0] = self.pipeline(frame, state[0])[2]

        kernels_ms = 0.0
        for _ in range(2):
            with harness.TracedWindow(self.device) as tw:
                replay()
            kernels_ms = max(kernels_ms, tw.summary(1).busy_s * 1e3)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < limit:
            ms = harness.time_ms(replay, self.device, self.p["settle_block"], warmup=0)
            if ms <= 1.08 * kernels_ms:
                return f"{ms:.3f} ms a replay at {kernels_ms:.3f} ms of kernels"
        return f"not settled: {ms:.3f} ms a replay at {kernels_ms:.3f} ms of kernels"

    def use_control(self, fault: str = "fp8") -> None:
        """Put the reference, one precision lower, in the program's place
        (``fp8``, the control), or plant a fault in the program: ``gn4``,
        its smoother cut to 4 iterations without accept / reject (a faster
        smoother than the configuration states), checked against the
        configuration's."""
        if fault == "gn4" and self.smooth:
            self.free()
            self.setup(dict(self.smoother_cfg, max_iterations=4, accept_reject=False))
            return
        if fault != "fp8":
            raise ValueError(f"a camera cell has no control {fault!r}")
        self.prepared_ref = self.detector.prepare(self.sd)
        self.pipeline = _ControlPipeline(self)
        rot, trans = (torch.as_tensor(a, dtype=torch.float32, device=self.device) for a in self.pose0)
        n_kp = self.config["n_keypoints"]
        self.carry0 = init_carry(rot, trans, self.smoother_cfg["window"], n_kp) if self.smooth else None

    def grab(self, i: int) -> np.ndarray:
        """Frame ``i`` written into the camera's reused buffer."""
        np.copyto(self.buffer, self.frames[i % len(self.frames)])
        return self.buffer

    def step(self, frame, carry):
        """One frame through the system, outputs on the host."""
        kp, _, carry, pose = self.pipeline(frame, carry)
        return kp.cpu().numpy(), (pose.rot.cpu().numpy(), pose.trans.cpu().numpy()), carry

    def window(self, seconds: float, max_units: int | None = None) -> dict:
        """Frames for ``seconds`` (or ``max_units`` frames): their latencies'
        percentiles, and the frames (``units``) over the window's wall."""
        carry = self.carry0
        self.carries, self.outputs, lat = [carry], [], []
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while time.perf_counter() < t_end and (max_units is None or len(lat) < max_units):
            frame = self.grab(len(lat))
            t0 = time.perf_counter()
            kp, pose, carry = self.step(frame, carry)
            lat.append(time.perf_counter() - t0)
            self.outputs.append((kp, pose))
            self.carries.append(carry)
        wall = time.perf_counter() - t_start
        failed = sum(not (np.isfinite(kp).all() and np.isfinite(p[0]).all() and np.isfinite(p[1]).all()) for kp, p in self.outputs)
        ms = np.asarray(lat) * 1e3
        return {
            "attempted": len(lat), "failed": int(failed), "units": len(lat), "window_s": wall,
            "frame_ms_p50": harness.percentile(ms, 50), "frame_ms_p95": harness.percentile(ms, 95),
        }

    def traced(self) -> int:
        """Runs ``traced_frames`` more frames (inside the caller's trace)."""
        carry = self.carries[-1]
        for i in range(self.p["traced_frames"]):
            carry = self.step(self.grab(i), carry)[2]
        return self.p["traced_frames"]

    def free(self) -> None:
        self.pipeline = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The readings compared with the reference (see the module's doc)."""
        n = len(self.outputs)
        sample = inputs.sample_indices(self.seed, n, self.p["sample_frames"], always=(0, -1))
        x = torch.cat([self.preprocess(torch.as_tensor(self.frames[i % len(self.frames)], device=self.device)) for i in sample])
        with torch.no_grad():
            ref_kp = ref_pipe.denormalize(self.detector.detect(self.detector.prepare(self.sd), x), self.h, self.w).double()
        prog_kp = torch.as_tensor(np.stack([self.outputs[i][0] for i in sample]), device=self.device).double()
        readings = {"kp_gap_px": float((prog_kp - ref_kp).abs().max())}
        if not self.smooth:
            return readings
        alone = "smoother_gap_median_px" in self.cell["limits"]
        kps = prog_kp if alone else ref_kp
        gaps, flags = [], 0
        for j, i in enumerate(sample):
            carry = _carry_dict(self.carries[i], torch.float64)
            new, (rot, trans) = ref_smo.update(self.smoother_cfg, carry, kps[j], self.corners, self.k)
            p_rot, p_trans = (torch.as_tensor(a, device=self.device).double() for a in self.outputs[i][1])
            gap = ref_smo.project(p_rot, p_trans, self.corners, self.k) - ref_smo.project(rot, trans, self.corners, self.k)
            gaps.append(float(torch.linalg.vector_norm(gap, dim=-1).max()))
            after = _carry_dict(self.carries[i + 1], torch.float64)
            flags += int((after["valid"] != new["valid"]).sum())
            flags += int(after["frames_seen"] != new["frames_seen"]) + int(after["consec_rejects"] != new["consec_rejects"])
        if alone:
            readings["smoother_gap_median_px"] = float(np.median(gaps))
        else:
            readings["pose_gap_px"] = max(gaps)
        readings["flags_mismatch"] = float(flags)
        return readings
