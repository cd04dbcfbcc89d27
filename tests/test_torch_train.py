"""Port parity: the detector train step (perseus_tpu_torch/train/) against
the JAX package's, on the same numpy inputs and converted state.

Tolerances: the configs field by field exactly; one clip + AdamW update to
rtol 1e-6 against optax (both f32; the global norm is summed in another
order); three f32 train steps, augmentation flags all off, to rel 1e-5 in
the loss and atol 1e-4 in params and batch stats (XLA and PyTorch sum the
convolutions and their gradients in another order); one step with the full
augmentation on shared draws to rel 1e-4 in the loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu.augment import fused as jfused
from perseus_tpu.augment import ops as jops
from perseus_tpu.augment.pipeline import AugmentationConfig as JAugConfig
from perseus_tpu.augment.pipeline import KeypointAugmentation as JAug
from perseus_tpu.camera import denormalize_pixel_coordinates
from perseus_tpu.data.dataset import KeypointDatasetConfig as JDataConfig
from perseus_tpu.models import resnet as jresnet
from perseus_tpu.train import train as jtrain
from perseus_tpu.train.config import TrainConfig as JTrainConfig
from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation
from perseus_tpu_torch.data.synthetic import make_batch
from perseus_tpu_torch.models import convert, pool, resnet
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import KeypointDatasetConfig, TrainConfig

B, H, W = 4, 64, 64
# small enough that AdamW's sensitivity to a near-zero moment (an update of
# up to lr for a rounding-level gradient) stays inside atol 1e-4
LR = 2e-4
OFF = dict(
    random_transplantation_with_depth=False, random_affine=False, random_erasing=False,
    planckian_jitter=False, color_jiggle=False, blur=False, random_plasma_shadow=False,
    random_bias=False, depth_gaussian_noise=False, random_near_plane=False, random_far_plane=False,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs several test
    processes side by side on the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize(
    "port_cls, jax_cls",
    [(TrainConfig, JTrainConfig), (AugmentationConfig, JAugConfig), (KeypointDatasetConfig, JDataConfig)],
    ids=["train", "augmentation", "dataset"],
)
def test_config_defaults_match_jax(port_cls, jax_cls):
    port, ref = port_cls(), jax_cls()
    names = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(port)] == names
    for name in names:
        a, b = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        else:
            assert a == b and type(a) is type(b), name


def test_smooth_l1_loss_matches_jax():
    rng = np.random.default_rng(0)
    pred = (rng.normal(size=(4, 16)) * 3).astype(np.float32)
    target = rng.normal(size=(4, 16)).astype(np.float32)
    ours = train.smooth_l1_loss(torch.from_numpy(pred), torch.from_numpy(target))
    ref = jtrain.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)


def test_plateau_scheduler_matches_jax():
    ours = train.PlateauScheduler(1e-3, patience=2, factor=0.5, min_lr=1e-5)
    ref = jtrain.PlateauScheduler(1e-3, patience=2, factor=0.5, min_lr=1e-5)
    for v in [1.0, 1.0, 0.99995, 1.0, 0.5, 0.5, 0.6, 0.5, 0.5, 0.5, 0.4] + [0.4] * 30:
        assert ours.step(v) == ref.step(v)
        assert (ours.best, ours.num_bad) == (ref.best, ref.num_bad)
    assert ours.lr == 1e-5


@pytest.mark.parametrize("scale", [1.0, 1e-3], ids=["clipped", "unclipped"])
def test_clip_adamw_update_matches_optax(scale):
    rng = np.random.default_rng(1)
    shapes = {"a.weight": (3, 3, 2, 4), "b.bias": (4,), "fc.weight": (5, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = JTrainConfig(learning_rate=3e-3)
    opt = jtrain.make_optimizer(cfg)
    jstate = opt.init({k: jnp.asarray(v) for k, v in params.items()})
    ours = train.make_optimizer(TrainConfig(learning_rate=3e-3))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = ours.init(tparams)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for _ in range(2):  # the second step has non-zero moments
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        tparams, tstate = ours.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate, tparams)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-9, err_msg=k)
    conv = convert.convert_opt_state(jax.tree.map(np.asarray, jstate))
    assert conv.step == tstate.step == 2
    assert conv.learning_rate == pytest.approx(3e-3) and conv.weight_decay == pytest.approx(1e-2)
    for k in shapes:  # the port's state was kept in JAX layouts here; the converter moves to torch's
        for ours_m, conv_m in ((tstate.exp_avg, conv.exp_avg), (tstate.exp_avg_sq, conv.exp_avg_sq)):
            expect = convert._to_torch_layout(k, ours_m[k].numpy()).numpy()
            # atol: the clip's global norm is summed in another order
            np.testing.assert_allclose(conv_m[k].numpy(), expect, rtol=1e-6, atol=1e-8, err_msg=k)


def _batch(seed=0):
    """A random 5-channel batch (RGB, metric depth, binary seg): NHWC for
    JAX, NCHW for the port, and pixel keypoints. Random pixels, not the flat
    synthetic cube faces: a flat face makes exact positive ties in the stem
    maxpool and near-degenerate sums, where the two frameworks' summation
    orders part by more than rounding."""
    rng = np.random.default_rng(seed)
    nhwc = rng.uniform(0, 1, (B, H, W, 5)).astype(np.float32)
    nhwc[..., 3] = rng.uniform(3.0, 14.0, (B, H, W))
    nhwc[..., 4] = rng.uniform(0, 1, (B, H, W)) < 0.3
    coords = rng.uniform(2, H - 3, (B, 8, 2)).astype(np.float32)
    return nhwc, np.ascontiguousarray(np.moveaxis(nhwc, -1, 1)), coords


def _t(x):
    """A JAX draw as a torch tensor: floats as f32 (the tests run JAX with
    x64 on, so its default-dtype draws are f64), bools and ints as they are."""
    x = np.asarray(x)
    return torch.from_numpy(np.array(x, np.float32) if x.dtype.kind == "f" else np.array(x))


def _cfgs(aug_kwargs):
    kw = dict(batch_size=B, in_channels=4, amp=False, learning_rate=LR)
    return (
        JTrainConfig(augmentation_config=JAugConfig(**aug_kwargs), **kw),
        TrainConfig(augmentation_config=AugmentationConfig(**aug_kwargs), **kw),
    )


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side: an initial state and three jitted f32 steps with every
    random augmentation off (one compile, reused by the tests below). The
    stem maxpool's gradient is the comparison VJP, which routes g to every
    tied input as the Pallas kernel and the port do (XLA's CPU default,
    select-and-scatter, picks one)."""
    jcfg, _ = _cfgs(OFF)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jresnet, "MAXPOOL_CMP_VJP", True)
        return _jax_steps(jcfg)


def _jax_steps(jcfg):
    opt = jtrain.make_optimizer(jcfg)
    params, stats = jresnet.init_keypoint_cnn(jax.random.key(3), 8, 4)
    state0 = jtrain.TrainState(params, stats, opt.init(params))
    step = jax.jit(jtrain.make_train_step(jcfg, opt, JAug(jcfg.augmentation_config, train=True)))
    nhwc, _, coords = _batch()
    states, losses = [state0], []
    for i in range(4):
        s, loss = step(states[-1], jnp.asarray(nhwc), jnp.asarray(coords), jax.random.key(i))
        states.append(s)
        losses.append(float(loss))
    return step, states, losses


def _to_port(jstate):
    host = jax.tree.map(np.asarray, jstate)
    return convert.from_jax_train_state(host.params, host.batch_stats, host.opt_state, device="cpu")


def _assert_state_close(tstate, jstate, atol=1e-4):
    ref = _to_port(jstate)
    for part in ("params", "batch_stats"):
        for k, v in getattr(ref, part).items():
            np.testing.assert_allclose(getattr(tstate, part)[k].numpy(), v.numpy(), atol=atol, err_msg=k)


def _port_step(state, seed=0):
    _, cfg = _cfgs(OFF)
    step = train.make_train_step(cfg, train.make_optimizer(cfg), KeypointAugmentation(cfg.augmentation_config))
    _, nchw, coords = _batch()
    return step(state, torch.from_numpy(nchw), torch.from_numpy(coords), torch.Generator().manual_seed(seed))


def test_three_train_steps_match_jax(jax_run):
    """Steps 1-3, each from the converted JAX state before it (non-zero
    AdamW moments, count >= 1): the loss to rel 1e-5, the new params and
    batch stats to atol 1e-4. Each step starts from JAX's state because
    free-running trajectories part: at lr 1e-3 on a batch of 4 the loss
    swings from step to step, and f32 summation-order differences grow
    with it. The update is not vacuous: AdamW moves parameters by ~lr."""
    _, states, losses = jax_run
    for i in range(1, 4):
        state, loss = _port_step(_to_port(states[i]), seed=i)
        assert state.opt_state.step == i + 1
        np.testing.assert_allclose(loss.item(), losses[i], rtol=1e-5, err_msg=f"step {i}")
        _assert_state_close(state, states[i + 1])
    moved = (state.params["layer1.0.conv1.weight"] - _to_port(states[3]).params["layer1.0.conv1.weight"]).abs()
    assert moved.max().item() > 0.5 * LR


def test_first_step_from_init_matches_jax_up_to_adamw_sign_flips(jax_run):
    """The first step from the initial state. AdamW's first update is
    lr * g / (|g| + eps), i.e. +-lr for every gradient that clears eps, so
    a gradient whose sign the two frameworks' f32 sums disagree on (one
    that is near zero) moves its parameter by up to 2 lr the other way.
    The loss and the batch stats (forward only) agree to rel 1e-5 / atol
    1e-4; every parameter agrees to atol 1e-4 or is such a flip, and flips
    are under 1% of the parameters."""
    _, states, losses = jax_run
    state, loss = _port_step(_to_port(states[0]))
    np.testing.assert_allclose(loss.item(), losses[0], rtol=1e-5)
    ref = _to_port(states[1])
    for k, v in ref.batch_stats.items():
        np.testing.assert_allclose(state.batch_stats[k].numpy(), v.numpy(), atol=1e-4, err_msg=k)
    diff = torch.cat([(state.params[k] - v).abs().flatten() for k, v in ref.params.items()])
    assert diff.max().item() <= 2 * LR + 1e-4
    assert (diff > 1e-4).float().mean().item() < 0.01


def test_full_augmentation_step_matches_jax(jax_run):
    """The default (ultra) augmentation with the draws JAX's pipeline makes
    from one key: the JAX augmentation (Pallas kernels interpreted) feeds the
    JAX step, the port applies the same draws inside its step."""
    jstep, states, _ = jax_run
    jcfg, cfg = _cfgs({})
    nhwc, nchw, coords = _batch(seed=1)
    key = jax.random.key(11)
    jimages, jcoords = JAug(jcfg.augmentation_config, train=True, fused=True)(
        key, jnp.asarray(nhwc), jnp.asarray(coords)
    )
    # the shared step has its augmentation off: it sees the augmented batch
    _, jloss = jstep(states[0], jimages, denormalize_pixel_coordinates(jcoords, H, W), key)

    keys = jax.random.split(key, 10)
    fp = jfused.sample_fused_params(keys[2], jcfg.augmentation_config, B, H, W, 5)
    aff = jops.sample_affine_params(keys[1], B, H, W, degrees=90.0, translate=(0.1, 0.1), scale=(0.9, 1.5), shear=0.1)
    draws = {
        "donor_idx": _t(jops.sample_donor_indices(keys[0], B)),
        "affine": {k: _t(v) for k, v in aff.items()},
        "fused": {
            "scalars": _t(fp["scalars"]),
            "fields": _t(fp["fields"].astype(jnp.float32)).to(torch.bfloat16),
            "plasma": _t(fp["plasma"].astype(jnp.float32)).to(torch.bfloat16),
        },
    }
    step = train.make_train_step(cfg, train.make_optimizer(cfg), KeypointAugmentation(cfg.augmentation_config))
    _, loss = step(_to_port(states[0]), torch.from_numpy(nchw), torch.from_numpy(coords), draws=draws)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)


@pytest.mark.parametrize(
    "option",
    [
        dict(outframe_corner_weight=0.25),
        dict(outframe_clamp_px=2.0),
        dict(spread_loss_weight=0.5),
        dict(use_example_weights=True, example_weight_clip=1.5),
    ],
    ids=["corner_weight", "clamp", "spread", "example_weights"],
)
def test_loss_options_match_jax(option):
    """Each loss option of step_core, one step from the same state, on
    keypoints of which some lie out of frame: the losses to rel 1e-5 (both
    steps eager; the augmentation is off, so both see the same batch)."""
    jcfg, cfg = (dataclasses.replace(c, **option) for c in _cfgs(OFF))
    nhwc, nchw, _ = _batch(seed=2)
    coords = np.random.default_rng(2).uniform(-12, W + 12, (B, 8, 2)).astype(np.float32)
    weights = np.asarray([0.1, 1.0, 4.0, 0.5], np.float32)
    params, stats = jresnet.init_keypoint_cnn(jax.random.key(3), 8, 4)
    opt = jtrain.make_optimizer(jcfg)
    jstate = jtrain.TrainState(params, stats, opt.init(params))
    jstep = jtrain.make_train_step(jcfg, opt, JAug(jcfg.augmentation_config, train=True))
    extra = (jnp.asarray(weights),) if jcfg.use_example_weights else ()
    _, jloss = jstep(jstate, jnp.asarray(nhwc), jnp.asarray(coords), jax.random.key(5), *extra)

    step = train.make_train_step(cfg, train.make_optimizer(cfg), KeypointAugmentation(cfg.augmentation_config))
    tw = torch.from_numpy(weights) if cfg.use_example_weights else None
    args = (_to_port(jstate), torch.from_numpy(nchw), torch.from_numpy(coords), torch.Generator())
    _, loss = step(*args, weights=tw)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    if cfg.use_example_weights:
        with pytest.raises(ValueError, match="weights"):
            step(*args)


def test_eval_step_matches_jax(jax_run):
    _, states, _ = jax_run
    jcfg, cfg = _cfgs({})
    nhwc, nchw, coords = _batch(seed=3)
    weights = np.asarray([1, 1, 1, 0], np.float32)
    js, jn = jtrain.make_eval_step(jcfg, JAug(jcfg.augmentation_config, train=False))(
        states[1], jnp.asarray(nhwc), jnp.asarray(coords), jnp.asarray(weights)
    )
    ts, tn = train.make_eval_step(cfg, KeypointAugmentation(cfg.augmentation_config, train=False))(
        _to_port(states[1]), torch.from_numpy(nchw), torch.from_numpy(coords), torch.from_numpy(weights)
    )
    np.testing.assert_allclose(ts.item(), float(js), rtol=1e-5)
    assert tn.item() == float(jn) == 3.0


def test_train_step_backward_runs_through_the_pool_gradient(monkeypatch):
    """The model's gradient reaches the stem maxpool's backward (the CUDA
    kernel on the card), and the BN running stats move in train mode."""
    calls = []
    real = pool.max_pool_3x3_s2_backward
    monkeypatch.setattr(pool, "max_pool_3x3_s2_backward", lambda *a: calls.append(1) or real(*a))
    _, cfg = _cfgs(OFF)
    opt = train.make_optimizer(cfg)
    state = train.init_state(cfg, opt, device="cpu")
    _, nchw, coords = _batch()
    step = train.make_train_step(cfg, opt, KeypointAugmentation(cfg.augmentation_config))
    new, loss = step(state, torch.from_numpy(nchw), torch.from_numpy(coords), torch.Generator())
    assert calls == [1] and torch.isfinite(loss)
    assert not torch.equal(new.batch_stats["bn1.running_mean"], state.batch_stats["bn1.running_mean"])
    assert not torch.equal(new.params["conv1.weight"], state.params["conv1.weight"])
    # init is seeded: the same cfg gives the same state
    again = train.init_state(cfg, opt, device="cpu")
    assert all(torch.equal(again.params[k], v) for k, v in state.params.items())
    assert set(state.params) | set(state.batch_stats) == set(resnet.KeypointCNN(num_channels=4, device="cpu").state_dict())


def test_set_learning_rate_and_prepare_batch():
    cfg = TrainConfig()
    opt = train.make_optimizer(cfg)
    st = train.set_learning_rate(opt.init({"w": torch.zeros(2)}), 2.5e-4)
    assert st.learning_rate == 2.5e-4 and st.weight_decay == cfg.weight_decay
    batch = make_batch(2, 16, 20, seed=4)
    for in_ch, transplant, expect in [(3, False, 3), (4, False, 4), (4, True, 5), (3, True, 5)]:
        port = train._prepare_aug_batch(batch, in_ch, transplant)
        ref = jtrain._prepare_aug_batch(batch, in_ch, transplant)
        assert port.shape == (2, expect, 16, 20) and port.dtype == np.float32
        np.testing.assert_array_equal(np.moveaxis(port, 1, -1), ref)


@pytest.mark.parametrize("field", ["init_checkpoint", "init_backbone"])
def test_init_state_refuses_checkpoint_loading(field):
    """Checkpoint loading is not ported: a config that asks for it is refused,
    not quietly given a random init."""
    cfg = dataclasses.replace(TrainConfig(), **{field: "model.pth"})
    with pytest.raises(NotImplementedError):
        train.init_state(cfg, train.make_optimizer(cfg), device="cpu")


def test_train_step_is_loss_and_grads_then_the_optimizer():
    """make_train_step is make_loss_and_grads followed by clip + AdamW, bit
    for bit (chip_smoke.py compares the gradients of the two devices)."""
    _, cfg = _cfgs(OFF)
    opt = train.make_optimizer(cfg)
    state = train.init_state(cfg, opt, device="cpu")
    aug = KeypointAugmentation(cfg.augmentation_config)
    _, nchw, coords = _batch()
    args = (state, torch.from_numpy(nchw), torch.from_numpy(coords), torch.Generator().manual_seed(0))
    new, loss = train.make_train_step(cfg, opt, aug)(*args)
    loss2, grads, stats = train.make_loss_and_grads(cfg, aug)(*args)
    params, _ = opt.update(grads, state.opt_state, state.params)
    assert torch.equal(loss, loss2) and set(grads) == set(state.params)
    assert all(torch.equal(new.params[k], v) for k, v in params.items())
    assert all(torch.equal(new.batch_stats[k], v) for k, v in stats.items())
