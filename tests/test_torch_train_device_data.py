"""Port parity: the trainer's device-resident-data configuration
(perseus_tpu_torch/train/train.py: make_device_data_train_step,
make_device_data_epoch_fn, make_device_data_eval_step) against the JAX
package's, and its own contracts.

Tolerances, as tests/test_torch_train.py: the per-step losses to rel 1e-5,
params and batch stats to atol 1e-4 (XLA and PyTorch sum the convolutions
and their gradients in another order); the epoch's parameter updates to
atol lr. Both epochs run free for three steps, so two things are held off:
the epoch starts from a JAX state whose AdamW moments are not near zero
(one update on made-up gradients; from zero moments AdamW's first step is
+-lr per parameter, its sign a coin flip for a gradient near zero), and lr
is 1e-5. At 2e-4 a single step from the same state already moves some
weights 0.4 lr apart (a 4-image batch, gradient elements the two
frameworks' sums disagree on), and after two more steps the losses part
by 1.4e-3; at 1e-5 by 2.5e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perseus_tpu.augment.pipeline import AugmentationConfig as JAugConfig
from perseus_tpu.augment.pipeline import KeypointAugmentation as JAug
from perseus_tpu.models import resnet as jresnet
from perseus_tpu.train import train as jtrain
from perseus_tpu.train.config import TrainConfig as JTrainConfig
from perseus_tpu_torch.augment import warp
from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation
from perseus_tpu_torch.models import convert
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig

B, S, N = 4, 64, 6
LR = 1e-5
OFF = dict(
    random_transplantation_with_depth=False, random_affine=False, random_erasing=False,
    planckian_jitter=False, color_jiggle=False, blur=False, random_plasma_shadow=False,
    random_bias=False, depth_gaussian_noise=False, random_near_plane=False, random_far_plane=False,
)
IDX_EPOCH = np.asarray([[0, 1, 2, 3], [4, 5, 0, 1], [2, 3, 4, 5]], np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs several test
    processes side by side on the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split(c, seed=0):
    """A device-resident split of N random-pixel rows (NHWC for JAX, NCHW
    for the port) and pixel keypoints. Random pixels: no flat regions, so
    no maxpool ties (see tests/test_torch_train.py::_batch)."""
    rng = np.random.default_rng(seed)
    nhwc = rng.uniform(0, 1, (N, S, S, c)).astype(np.float32)
    nhwc[..., 3] = rng.uniform(3.0, 14.0, (N, S, S))
    if c > 4:
        nhwc[..., 4] = rng.uniform(0, 1, (N, S, S)) < 0.3
    coords = rng.uniform(2, S - 3, (N, 8, 2)).astype(np.float32)
    return nhwc, torch.from_numpy(np.ascontiguousarray(np.moveaxis(nhwc, -1, 1))), coords


def _fake_grad(rng, shape):
    """Made-up gradients of magnitude 0.5-1.5 x 1e-2, random signs: one
    AdamW update on them leaves no moment near zero (a moment within
    rounding of zero makes the next update's sign a coin flip)."""
    mag = rng.uniform(0.5, 1.5, shape) * 1e-2
    return (np.where(rng.uniform(size=shape) < 0.5, -mag, mag)).astype(np.float32)


def _cfgs(aug_kwargs):
    kw = dict(batch_size=B, in_channels=4, amp=False, learning_rate=LR, input_resolution=S)
    return (
        JTrainConfig(augmentation_config=JAugConfig(**aug_kwargs), **kw),
        TrainConfig(augmentation_config=AugmentationConfig(**aug_kwargs), **kw),
    )


def test_epoch_fn_matches_jax_with_random_stages_off(monkeypatch):
    """Three steps of one epoch call on both sides, every random stage off:
    the (steps,) losses and the final params and batch stats."""
    monkeypatch.setattr(jresnet, "MAXPOOL_CMP_VJP", True)  # g to every tie, as the port (test_torch_train.py)
    jcfg, cfg = _cfgs(OFF)
    opt = jtrain.make_optimizer(jcfg)
    params, stats = jresnet.init_keypoint_cnn(jax.random.key(3), 8, 4)
    opt_state = opt.init(params)
    rng = np.random.default_rng(5)
    fake = {k: jnp.asarray(_fake_grad(rng, v.shape)) for k, v in params.items()}
    upd, opt_state = opt.update(fake, opt_state, params)
    state = jtrain.TrainState(optax.apply_updates(params, upd), stats, opt_state)
    nhwc, nchw, coords = _split(4)

    epoch_fn = jax.jit(jtrain.make_device_data_epoch_fn(jcfg, opt, JAug(jcfg.augmentation_config, train=True)))
    jstate, jlosses = epoch_fn(state, jnp.asarray(nhwc), jnp.asarray(coords), jnp.asarray(IDX_EPOCH, jnp.int32),
                               jax.random.key(0), 0)

    host = jax.tree.map(np.asarray, state)
    tstate = convert.from_jax_train_state(host.params, host.batch_stats, host.opt_state, device="cpu")
    port_epoch = train.make_device_data_epoch_fn(cfg, train.make_optimizer(cfg), KeypointAugmentation(cfg.augmentation_config))
    tstate, losses = port_epoch(tstate, nchw, torch.from_numpy(coords), torch.from_numpy(IDX_EPOCH), 0, 0)
    assert losses.shape == (3,) and tstate.opt_state.step == 4
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    ref = jax.tree.map(np.asarray, jstate)
    ref = convert.from_jax_train_state(ref.params, ref.batch_stats, ref.opt_state, device="cpu")
    for part in ("params", "batch_stats"):
        for k, v in getattr(ref, part).items():
            np.testing.assert_allclose(getattr(tstate, part)[k].numpy(), v.numpy(), atol=1e-4, err_msg=k)
    start = convert.from_jax_params(host.params, {})
    for k, v in ref.params.items():  # the updates themselves, to a tenth of the params' tolerance
        np.testing.assert_allclose((tstate.params[k] - start[k]).numpy(), (v - start[k]).numpy(), atol=LR, err_msg=k)
    moved = (tstate.params["layer1.0.conv1.weight"] - start["layer1.0.conv1.weight"]).abs()
    assert moved.max().item() > LR  # three steps moved the params: the comparison is not vacuous


def test_epoch_call_equals_its_steps_called_alone(monkeypatch):
    """With the unfused augmentation on (transplant, two-pass warp, every
    stage), an epoch call makes the same draws and takes the same steps as
    the device-data step called alone with step_generator(seed, base + s):
    bit for bit. The warp goes through the two-pass route on every step."""
    calls = []
    real = warp.warp_affine_two_pass
    monkeypatch.setattr(warp, "warp_affine_two_pass", lambda *a: calls.append(1) or real(*a))
    _, cfg = _cfgs({})
    opt = train.make_optimizer(cfg)
    state = train.init_state(cfg, opt, device="cpu")
    aug = KeypointAugmentation(cfg.augmentation_config, fused=False)
    _, ds, coords = _split(5, seed=1)
    ds_coords = torch.from_numpy(coords)
    idx = torch.from_numpy(IDX_EPOCH[:2])

    e_state, losses = train.make_device_data_epoch_fn(cfg, opt, aug)(state, ds, ds_coords, idx, 7, 10)
    step = train.make_device_data_train_step(cfg, opt, aug)
    s_state, s_losses = state, []
    for s in range(2):
        s_state, loss = step(s_state, ds, ds_coords, idx[s], train.step_generator(7, 10 + s, "cpu"))
        s_losses.append(loss)
    assert calls == [1] * 4
    assert torch.isfinite(losses).all() and torch.equal(losses, torch.stack(s_losses))
    assert all(torch.equal(e_state.params[k], v) for k, v in s_state.params.items())
    assert all(torch.equal(e_state.batch_stats[k], v) for k, v in s_state.batch_stats.items())
    # the generator depends on (seed, step) alone, and differs between steps
    draw = lambda seed, st: torch.rand(4, generator=train.step_generator(seed, st, "cpu"))  # noqa: E731
    assert torch.equal(draw(7, 10), draw(7, 10)) and not torch.equal(draw(7, 10), draw(7, 11))
    assert not torch.equal(draw(7, 10), draw(8, 10))


def test_device_data_eval_counts_every_row_once():
    """A val split of N = 6 rows in batches of 4: the last batch is filled
    up with row 0 at mask 0, and the sums over the batches equal the eval
    step over all rows at once."""
    _, cfg = _cfgs({})
    state = train.init_state(cfg, train.make_optimizer(cfg), device="cpu")
    val_aug = KeypointAugmentation(cfg.augmentation_config, train=False)
    _, ds, coords = _split(4, seed=2)
    ds_coords = torch.from_numpy(coords)
    batches = list(train.eval_index_batches(N, B))
    assert [m.tolist() for _, m in batches] == [[1, 1, 1, 1], [1, 1, 0, 0]]
    assert [i.tolist() for i, _ in batches] == [[0, 1, 2, 3], [4, 5, 0, 0]]
    dd_eval = train.make_device_data_eval_step(cfg, val_aug)
    total, count = 0.0, 0.0
    for idx, mask in batches:
        s, n = dd_eval(state, ds, ds_coords, idx, mask)
        total, count = total + s.item(), count + n.item()
    whole, n_all = train.make_eval_step(cfg, val_aug)(state, ds, ds_coords, torch.ones(N))
    assert count == n_all.item() == N
    np.testing.assert_allclose(total, whole.item(), rtol=1e-6)
