"""Port parity: the whole streaming step (perseus_tpu_torch/runtime/).

The JAX ``StreamingPipeline`` and the port's, built from the same random-init
weights (carried across with ``from_jax_params``), take the same synthetic
RGBD frames. The preprocessed image agrees to 1 ulp (XLA may divide by the
cube scale as a multiply by its reciprocal). In f32 the keypoints agree to
1e-3 px (measured 1.1e-4: the detector's f32 convolutions sum in another
order), the smoothed translations to 1e-5 (measured 2.8e-7) and rotations to
5e-5 (measured 1.2e-5 on the fourth frame: random weights give keypoints no
cube fits, and the f32 window solve amplifies the differences frame by
frame).
"""

import jax
import numpy as np
import pytest
import torch

from perseus_tpu.models import resnet as jax_resnet
from perseus_tpu.runtime import streaming as jax_streaming
from perseus_tpu.runtime import sources as jax_sources
from perseus_tpu.smoother.lm import SmootherConfig as JaxSmootherConfig
from perseus_tpu_torch.models import convert
from perseus_tpu_torch.runtime import streaming
from perseus_tpu_torch.runtime import sources
from perseus_tpu_torch.runtime.sources import SyntheticSource
from perseus_tpu_torch.smoother.lm import SmootherConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    the suite runs several test processes side by side on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    params, stats = jax_resnet.init_keypoint_cnn(jax.random.key(0), 8, 4)
    return params, stats, convert.from_jax_params(params, stats)


def _pipelines(weights, **kw):
    params, stats, sd = weights
    smoother = kw.pop("smoother", None)
    jcfg = jax_streaming.StreamingConfig(
        num_channels=4, model_h=64, model_w=64, amp=False,
        **kw, **({"smoother": JaxSmootherConfig(**smoother)} if smoother else {}),
    )
    tcfg = streaming.StreamingConfig(
        num_channels=4, model_h=64, model_w=64, amp=False,
        **kw, **({"smoother": SmootherConfig(**smoother)} if smoother else {}),
    )
    return (
        jax_streaming.StreamingPipeline(jcfg, params=params, batch_stats=stats),
        streaming.StreamingPipeline(tcfg, sd, device="cpu"),
    )


@pytest.mark.parametrize("accept_reject", [False, True], ids=["gn", "lm"])
def test_streaming_step_matches_jax_f32(weights, accept_reject):
    jp, tp = _pipelines(
        weights, smoother=dict(window=4, max_iterations=2, accept_reject=accept_reject)
    )
    cj, ct = jp.init_carry(), tp.init_carry()
    source = SyntheticSource(height=96, width=128, seed=1)
    for i in range(4):
        frame = source.get_frame()
        kj, ij, cj, pj = jp(frame, cj)
        kt, it, ct, pt = tp(frame, ct)
        assert kt.shape == (8, 2) and it.shape == (64, 64, 4)
        np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=2.5e-7, atol=0)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-3, err_msg=f"frame {i}")
        np.testing.assert_allclose(pt.trans.numpy(), np.asarray(pj.trans), atol=1e-5, err_msg=f"frame {i}")
        np.testing.assert_allclose(pt.rot.numpy(), np.asarray(pj.rot), atol=5e-5, err_msg=f"frame {i}")
        assert int(ct.frames_seen) == int(cj.frames_seen) == i + 1


@pytest.mark.parametrize("name", ["SyntheticSource", "DatasetReplaySource"])
def test_sources_are_copies(name):
    rng = np.random.default_rng(4)
    items = [
        {"image": rng.uniform(0, 1, (6, 5, 3)), "depth_image": rng.uniform(2, 14, (6, 5))}
        for _ in range(3)
    ]
    args = {"SyntheticSource": (40, 50, True, 3), "DatasetReplaySource": (items,)}[name]
    a, b = getattr(sources, name)(*args), getattr(jax_sources, name)(*args)
    for _ in range(4):  # the replay loops around
        np.testing.assert_array_equal(a.get_frame(), b.get_frame())


def test_nan_and_inf_depth_cleaned_like_jax(weights):
    jp, tp = _pipelines(weights, smooth=False)
    frame = np.random.default_rng(21).uniform(0, 1, (96, 96, 4)).astype(np.float32)
    frame[::3, ::3, 3] = np.nan
    frame[1::3, 1::3, 3] = np.inf
    frame[2::3, ::5, 3] = 0.6  # beyond the far plane
    kj, ij, _, _ = jp(frame, None)
    kt, it, carry, pose = tp(frame, None)
    assert carry is None
    assert torch.equal(pose.rot, torch.eye(3)) and torch.equal(pose.trans, torch.zeros(3))
    assert np.isfinite(it.numpy()).all() and np.isfinite(kt.numpy()).all()
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-3)
