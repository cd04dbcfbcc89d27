"""Port parity: the keypoint ResNet-18 (perseus_tpu_torch/models/resnet.py)
and the weight converter (models/convert.py).

JAX parameters (random init, with randomized BN affine parameters and running
statistics so folding is not the identity) are carried across with
``from_jax_params``; both sides run the same numpy images. Tolerances: f32
logits and running stats to 1e-4 (measured 1.8e-5 in train mode, 1.3e-6 in
eval mode: XLA and PyTorch sum the convolutions in another order); bf16
logits to 0.05 (measured 5.1e-3 on logits of magnitude ~2): both frameworks
round every conv output to bf16, after f32 sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu.models import convert as jax_convert
from perseus_tpu.models import resnet as jr
from perseus_tpu_torch.models import convert, resnet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    the suite runs several test processes side by side on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

RNG = np.random.default_rng(7)


def _jax_model(head="avgpool", feat_hw=2):
    params, stats = jr.init_keypoint_cnn(jax.random.key(0), 8, 4, head=head, feat_hw=feat_hw)
    params = {k: np.asarray(v) for k, v in params.items()}
    stats = {k: np.asarray(v) for k, v in stats.items()}
    for k in params:
        if k.endswith(".weight") and params[k].ndim == 1:  # BN gamma / beta
            params[k] = RNG.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
            params[k.replace(".weight", ".bias")] = RNG.normal(0, 0.1, params[k].shape).astype(np.float32)
    for k in stats:
        if k.endswith("running_mean"):
            stats[k] = RNG.normal(0, 0.1, stats[k].shape).astype(np.float32)
        else:
            stats[k] = RNG.uniform(0.5, 1.5, stats[k].shape).astype(np.float32)
    return params, stats


IMAGES = RNG.uniform(0, 1, (2, 64, 64, 4)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("s2d_stem", [False, True], ids=["stem", "s2d"])
def test_apply_matches_jax_f32(train, s2d_stem):
    params, stats = _jax_model()
    lj, sj = jr.keypoint_cnn_apply(
        params, stats, jnp.asarray(IMAGES), train=train, compute_dtype=jnp.float32, s2d_stem=s2d_stem
    )
    lt, st = resnet.keypoint_cnn_apply(
        convert.from_jax_params(params, stats), _nchw(IMAGES), train=train, s2d_stem=s2d_stem
    )
    assert lt.dtype == torch.float32 and lt.shape == (2, 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    assert set(st) == set(sj)
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), atol=1e-4, err_msg=k)


def test_fold_batchnorm_matches_jax():
    params, stats = _jax_model()
    folded_j = convert.from_jax_folded(jr.fold_batchnorm(params, stats))
    folded_t = resnet.fold_batchnorm(convert.from_jax_params(params, stats))
    assert set(folded_t) == set(folded_j)
    for k in folded_j:
        np.testing.assert_allclose(folded_t[k].numpy(), folded_j[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("head", ["avgpool", "spatial"])
@pytest.mark.parametrize("s2d_stem", [False, True], ids=["stem", "s2d"])
def test_folded_apply_matches_jax_f32(head, s2d_stem):
    params, stats = _jax_model(head)
    lj = jr.keypoint_cnn_apply_folded(
        jr.fold_batchnorm(params, stats), jnp.asarray(IMAGES), compute_dtype=jnp.float32, s2d_stem=s2d_stem
    )
    folded = resnet.fold_batchnorm(convert.from_jax_params(params, stats))
    lt = resnet.keypoint_cnn_apply_folded(folded, _nchw(IMAGES), torch.float32, s2d_stem=s2d_stem)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    # the folded forward is eval mode with BN folded in
    le, _ = resnet.keypoint_cnn_apply(convert.from_jax_params(params, stats), _nchw(IMAGES))
    np.testing.assert_allclose(lt.numpy(), le.numpy(), atol=1e-4)


def test_folded_apply_matches_jax_bf16():
    params, stats = _jax_model()
    lj = jr.keypoint_cnn_apply_folded(jr.fold_batchnorm(params, stats), jnp.asarray(IMAGES))
    folded = resnet.fold_batchnorm(convert.from_jax_params(params, stats))
    lt = resnet.keypoint_cnn_apply_folded(folded, _nchw(IMAGES))  # bf16 compute by default
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=0.05)


def test_module_state_dict_keys_and_train_step_match_functional():
    params, stats = _jax_model()
    model = resnet.KeypointCNN(n_keypoints=8, num_channels=4, device="cpu")
    assert set(model.state_dict()) == set(params) | set(stats)
    sd = convert.from_jax_params(params, stats)
    model.load_state_dict(sd)
    model.train()
    logits = model(_nchw(IMAGES))
    lt, st = resnet.keypoint_cnn_apply(sd, _nchw(IMAGES), train=True)
    assert torch.equal(logits, lt)
    for k, v in st.items():
        assert torch.equal(model.state_dict()[k], v), k
    logits.sum().backward()  # the CPU path is differentiable
    assert model.conv1.weight.grad is not None


def test_module_init_seeded_and_device_independent():
    a = resnet.KeypointCNN(num_channels=4, device="cpu", generator=torch.Generator().manual_seed(5))
    b = resnet.KeypointCNN(num_channels=4, device="cpu", generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    std = a.conv1.weight.std().item()
    assert abs(std - np.sqrt(2.0 / (64 * 49))) < 0.1 * std


def test_reference_pth_round_trip(tmp_path):
    """A reference-layout .pth (keys under resnet., exported by the JAX
    package) loads to the same state dict as the direct conversion."""
    params, stats = _jax_model()
    sd = jax_convert.to_torch_state_dict(params, stats)
    path = str(tmp_path / "model.pth")
    torch.save({k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()}, path)
    loaded = convert.load_model(path)
    direct = convert.from_jax_params(params, stats)
    assert set(loaded) == set(direct)
    for k in direct:
        assert torch.equal(loaded[k], direct[k]), k
    with pytest.raises(ValueError, match="orbax"):
        convert.load_model(str(tmp_path))
