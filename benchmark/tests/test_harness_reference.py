"""Each plain reference of the benchmark held against the port at a tiny
size on the CPU (the port in f32 there, the reference in f32 or f64), and
the counts against the figures they are quoted by. The tests import the
port; the references do not."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import counts, inputs
from benchmark.reference import augment as ref_aug
from benchmark.reference import detector as ref_det
from benchmark.reference import pipeline as ref_pipe
from benchmark.reference import smoother as ref_smo
from benchmark.reference import train as ref_train

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def weights():
    return inputs.resnet18_weights(11, 4, 8, CPU, random_bn=True)


def test_counts():
    assert counts.resnet18_forward_flops(1, 4, 256, 256) == pytest.approx(4.84e9, rel=1e-3)
    assert counts.resnet18_train_flops(256, 4, 256, 256) == pytest.approx(3.72e12, rel=1e-3)
    # PERF.md's kernel table: 805 MB of an f32 (256, 5, 256, 256) batch in and out, 0.2404 ms at 3.35 TB/s
    assert counts.augment_apply_bytes(256, 5, 5, 256, 256, 4) / counts.PEAK_HBM_BYTES_S == pytest.approx(0.2404e-3, rel=1e-3)
    assert counts.roofline_seconds(989e12, 0) == pytest.approx(1.0)


def test_the_resnet18_plugin_is_what_the_camera_cells_ran_before_it():
    """The plug-in's weights are ``inputs.resnet18_weights``' bit for bit,
    its count is ``counts``' (4,840,243,200 a 4x256x256 frame), and its
    reference calls are the ResNet reference's."""
    from benchmark import run

    c = _config("rgbd-stream-gn4")
    plugin = run.detector(c)
    assert "detector" not in c and plugin.__file__ == os.path.join(BENCH, "detectors", "resnet18.py")
    assert plugin.forward_flops(c) == 4_840_243_200 == counts.resnet18_forward_flops(1, 4, 256, 256, 16)
    assert plugin.streaming_fields(c) == {} and plugin.HEAD == ("fc.weight", "fc.bias")
    tiny = dict(c, model_h=32, model_w=32)
    a, b = plugin.weights(77, tiny, CPU), inputs.resnet18_weights(77, 4, 8, CPU, random_bn=True)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    x = torch.rand(1, 4, 32, 32, generator=torch.Generator().manual_seed(3))
    prepared = plugin.prepare(a)
    assert all(torch.equal(prepared[k], v) for k, v in ref_det.fold(b).items())
    assert torch.equal(plugin.features(prepared, x), ref_det.features(ref_det.fold(b), x))
    assert torch.equal(plugin.detect(prepared, x, quantize=True), ref_det.detect(ref_det.fold(b), x, quantize=True))


def test_folded_detector_matches_the_port(weights):
    from perseus_tpu_torch.models import resnet

    x = torch.rand(2, 4, 64, 64, generator=torch.Generator().manual_seed(0))
    port = resnet.keypoint_cnn_apply_folded(resnet.fold_batchnorm(weights), x, compute_dtype=torch.float32)
    ref = ref_det.detect(ref_det.fold(weights), x)
    torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-5)
    # the control's float8 convolutions are farther by orders of magnitude
    fp8 = ref_det.detect(ref_det.fold(weights), x, quantize=True)
    assert (fp8 - ref).abs().max() > 100 * (port - ref).abs().max()


def test_preprocess_and_denormalize_match_the_pipeline(weights):
    from perseus_tpu_torch.runtime.streaming import StreamingConfig, StreamingPipeline

    c = _config("rgbd-stream-gn4")
    frames = inputs.camera_frames(5, 2, 40, 56, 0.05)
    pipe = StreamingPipeline(
        StreamingConfig(num_channels=4, model_h=32, model_w=32, amp=False, smooth=False), state_dict=weights, device="cpu"
    )
    for f in frames:
        x = ref_pipe.preprocess(torch.as_tensor(f), c["cube_scale"], c["depth_near_m"], c["depth_far_m"], 32, 32)
        torch.testing.assert_close(x[0].permute(1, 2, 0), pipe.preprocess(torch.as_tensor(f)), rtol=1e-6, atol=1e-5)
        kp, *_ = pipe(f, None)
        ref = ref_pipe.denormalize(ref_det.detect(ref_det.fold(weights), x), 32, 32)[0]
        torch.testing.assert_close(ref, kp, rtol=1e-4, atol=1e-3)


def test_train_forward_and_gradients_match_the_port():
    from perseus_tpu_torch.models import resnet
    from perseus_tpu_torch.train import train as tm

    sd = inputs.resnet18_weights(12, 4, 8, CPU, random_bn=False)
    params = {k: v for k, v in sd.items() if not k.endswith(("running_mean", "running_var"))}
    stats = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    x = torch.rand(4, 4, 64, 64, generator=torch.Generator().manual_seed(1))
    target = torch.rand(4, 16, generator=torch.Generator().manual_seed(2))
    a = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss_a = tm.smooth_l1_loss(resnet.keypoint_cnn_apply({**a, **stats}, x, train=True)[0], target)
    grads_a = torch.autograd.grad(loss_a, list(a.values()))
    b = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss_b = ref_train.huber(ref_det.forward_train(b, x), target).mean()
    grads_b = torch.autograd.grad(loss_b, list(b.values()))
    assert float(loss_a) == pytest.approx(float(loss_b), rel=1e-5)
    for k, ga, gb in zip(a, grads_a, grads_b):
        assert float((ga - gb).norm()) <= 1e-4 * float(gb.norm()) + 1e-7, k


def test_all_ties_pool_gradient_matches_the_port():
    from perseus_tpu_torch.models import pool

    x = torch.randint(0, 3, (2, 3, 9, 10)).float()  # many ties
    g = torch.rand(2, 3, 5, 5)
    y = pool.max_pool_3x3_s2_reference(x)
    port = pool.max_pool_3x3_s2_backward_reference(x, y, g)
    xr = x.clone().requires_grad_()
    (ref,) = torch.autograd.grad(ref_det._MaxPoolAllTies.apply(xr), xr, g)
    torch.testing.assert_close(ref, port)


def test_augmentation_draws_and_apply_match_the_port():
    from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation
    from perseus_tpu_torch.train import train as tm

    aug_cfg = _config("rgbd-train-b256")["augmentation"]
    aug = KeypointAugmentation(AugmentationConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in aug_cfg.items()}))
    images, coords = inputs.train_split(3, 6, 32, 32, 8, CPU, torch.float32)
    for step in (0, 5):
        d_port = aug.sample(tm.step_generator(99, step, CPU), 6, 32, 32, 5)
        d_ref = ref_aug.sample(torch.Generator().manual_seed(ref_aug.step_seed(99, step)), aug_cfg, 6, 32, 32)
        with torch.no_grad():
            out_port, kp_port = aug.apply(images, coords, d_port)
        out_ref, kp_ref = ref_aug.apply(images, coords, d_ref)
        torch.testing.assert_close(out_ref, out_port, rtol=0, atol=0)
        torch.testing.assert_close(kp_ref, kp_port, rtol=0, atol=0)


def test_clip_adamw_matches_the_port():
    from perseus_tpu_torch.train import train as tm

    gen = torch.Generator().manual_seed(4)
    params = {"a": torch.randn(5, 3, generator=gen), "b": torch.randn(7, generator=gen)}
    opt = tm.ClipAdamW(1.0, 1e-3, 1e-2)
    p_state, r_state = opt.init(params), ref_train.init(params)
    p_params = params
    cfg = {"grad_clip_norm": 1.0, "weight_decay": 1e-2, "learning_rate": 1e-3}
    for scale in (3.0, 0.1):  # clipped, then not
        grads = {k: scale * torch.randn(v.shape, generator=gen) for k, v in params.items()}
        p_params, p_state = opt.update(grads, p_state, p_params)
        r_state, _ = ref_train.clip_adamw(r_state, grads, cfg)
        for k in params:
            torch.testing.assert_close(r_state["params"][k], p_params[k], rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(r_state["m"][k], p_state.exp_avg[k], rtol=1e-6, atol=1e-9)


def _smoother_pair(window, gate_px, accept_reject):
    from perseus_tpu_torch.camera import intrinsics_from_fov
    from perseus_tpu_torch.datagen.labeling import cube_corners
    from perseus_tpu_torch.smoother.fixed_lag import FixedLagSmoother
    from perseus_tpu_torch.smoother.lm import SmootherConfig

    cfg = dict(_config("rgbd-stream-gn4")["smoother"], window=window, gate_px=gate_px, accept_reject=accept_reject)
    port = FixedLagSmoother(SmootherConfig(**cfg), intrinsics_from_fov(torch.tensor(1.0), 256, 256), cube_corners(0.035))
    return cfg, port


@pytest.mark.parametrize("gate_px,accept_reject", [(30.0, False), (30.0, True), (0.0, False)])
def test_smoother_update_matches_the_port(gate_px, accept_reject):
    """Eight frames from a cold start at the cube's pose, f32 port against
    the f64 reference from the port's carry; frames 5-7 are a detector
    failure (corners moved 60 px), which the gate rejects and then resets on."""
    from perseus_tpu_torch.lie import SE3
    from benchmark.traffic.camera import _carry_dict

    cfg, port = _smoother_pair(6, gate_px, accept_reject)
    rot, trans = inputs.cube_pose(21)
    base = inputs.project_corners(rot, trans, 0.035, 1.0, 256, 256)
    rng = np.random.default_rng(0)
    carry = port.init(SE3(torch.as_tensor(rot, dtype=torch.float32), torch.as_tensor(trans, dtype=torch.float32)))
    corners = torch.as_tensor(inputs.CORNER_SIGNS * 0.035)
    k = ref_smo.intrinsics(1.0, 256, 256)
    rejected = 0
    for i in range(8):
        kp = base + rng.normal(0, 2.0, base.shape) + (60.0 if i >= 5 else 0.0)
        kp32 = torch.as_tensor(kp, dtype=torch.float32)
        before = _carry_dict(carry, torch.float64)
        carry, pose = port.update(carry, kp32)
        new, (r, t) = ref_smo.update(cfg, before, kp32.double(), corners, k)
        after = _carry_dict(carry, torch.float64)
        gap = ref_smo.project(pose.rot.double(), pose.trans.double(), corners, k) - ref_smo.project(r, t, corners, k)
        assert float(gap.abs().max()) < 1e-2, i
        assert torch.equal(after["valid"], new["valid"]), i
        assert (after["frames_seen"], after["consec_rejects"]) == (new["frames_seen"], new["consec_rejects"]), i
        rejected += int(float(new["valid"][-1]) == 0.0)
    if gate_px > 0:
        assert rejected >= 1  # the gate was exercised


def test_train_split_and_frames_are_seeded():
    a = inputs.train_split(7, 5, 16, 16, 8, CPU, torch.bfloat16, chunk=2)
    b = inputs.train_split(7, 5, 16, 16, 8, CPU, torch.bfloat16, chunk=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    seg = a[0][:, 4].float()
    assert set(torch.unique(seg).tolist()) <= {0.0, 1.0}
    assert np.array_equal(inputs.camera_frames(3, 2, 8, 8, 0.1), inputs.camera_frames(3, 2, 8, 8, 0.1), equal_nan=True)
    assert inputs.subseed(2**33 + 5, 1) != inputs.subseed(5, 1)
    order = inputs.epoch_order(9, 0, 10, 4)
    assert order.shape == (2, 4) and len(set(order.ravel())) == 8
