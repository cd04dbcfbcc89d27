"""Port parity: tools/pretrain_backbone.py against scripts/pretrain_backbone.py.

The script's step, rotation and draws are closures inside its ``main()``;
they are rebuilt here from perseus_tpu parts, line for line
(``rot_batch`` :88-97, ``train_step`` :102-120 with the in-batch
permutation passed in, the row draw :67, the epoch orders :124-128).

Tolerances: ``rot_batch`` exact (a batch of 8 and one of 10, whose two
remainder rows are dropped); the row draw and the epoch orders equal
arrays; one f32 pretrain step from JAX's converted state on shared rows
and a shared permutation, as tests/test_torch_train.py holds the train
step: the loss to rel 1e-5, the accuracy exactly, params and batch stats
to atol 1e-4 (XLA and PyTorch sum the convolutions in another order),
the second step from JAX's state after the first; the first step from
the initial state has AdamW's +-lr first update, so there a parameter
agrees to 1e-4 or is a sign flip (|diff| <= 2 lr + 1e-4), flips under 1%.
Both steps at 64x64 and lr 5e-5 (see LR).
The stem maxpool's gradient is JAX's comparison VJP (all ties, as the
port's kernel). The port's checkpoint then feeds ``init_backbone``, and
``init_head`` raises on the 4-logit head.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perseus_tpu.models import resnet as jresnet
from perseus_tpu_torch.data.synthetic import generate_synthetic_pruned_dataset
from perseus_tpu_torch.models import convert
from perseus_tpu_torch.tools import pretrain_backbone as pb
from perseus_tpu_torch.train import checkpoint as ckpt
from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig

B, H, C, N_ROWS = 8, 32, 4, 12
S = 64  # the step tests' size, as tests/test_torch_train.py's: at 32 the last BN normalizes 8 values
# AdamW moves a parameter by up to 2 lr where the two frameworks' sums of a
# rounding-level gradient differ in sign (measured here at lr 2e-4: bn1.bias
# 1.1e-4 apart after the second step, a ReLU input within rounding of 0), so
# lr is set to keep 2 lr within the atol of 1e-4
LR, WD = 5e-5, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_rot_batch(img):
    """scripts/pretrain_backbone.py:88-97."""
    b = img.shape[0]
    q = b // 4
    parts, labels = [], []
    for k in range(4):
        parts.append(jnp.rot90(img[k * q : (k + 1) * q], k=k, axes=(1, 2)))
        labels.append(jnp.full((q,), k, jnp.int32))
    return jnp.concatenate(parts), jnp.concatenate(labels)


@pytest.mark.parametrize("b", [8, 10])
def test_rot_batch_matches_jnp_rot90_quarters(b):
    x = np.random.default_rng(b).normal(size=(b, 6, 6, 3)).astype(np.float32)
    jimg, jlab = _jax_rot_batch(jnp.asarray(x))
    img, lab = pb.rot_batch(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    assert img.shape[0] == 4 * (b // 4)
    np.testing.assert_array_equal(np.moveaxis(img.numpy(), 1, -1), np.asarray(jimg))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    q = b // 4  # and the direction is numpy's: quarter 1 is np.rot90 of its rows over (H, W)
    np.testing.assert_array_equal(np.asarray(jimg[q : 2 * q]), np.rot90(x[q : 2 * q], 1, axes=(1, 2)))


def test_row_draw_and_epoch_orders_match_the_script(tmp_path, monkeypatch):
    """pretrain() draws its pool rows and walks its epochs as the script's
    :66-67 and :124-128 do (checked on what pretrain() passes on)."""
    path = generate_synthetic_pruned_dataset(str(tmp_path / "ds"), n_train=16, n_test=8, h=H, w=H)
    cfg = pb.PretrainConfig(dataset_path=path, output_dir=str(tmp_path / "out"), epochs=2, batch_size=B,
                            max_rows=13, seed=5)
    seen = {"rows": None, "idx": []}
    load_rows, make_step = pb.load_rows, pb.make_pretrain_step
    monkeypatch.setattr(pb, "load_rows",
                        lambda ds, rows, *a, **k: seen.update(rows=rows) or load_rows(ds, rows, *a, **k))

    def recording_step(optimizer, compute_dtype=torch.bfloat16):
        step = make_step(optimizer, torch.float32)
        return lambda state, images, idx, gen=None, perm=None: (seen["idx"].append(np.asarray(idx)), step(
            state, images, idx, gen, perm))[1]

    monkeypatch.setattr(pb, "make_pretrain_step", recording_step)
    out = pb.pretrain(cfg, device="cpu")
    n = min(16, cfg.max_rows)
    np.testing.assert_array_equal(seen["rows"], np.random.default_rng(cfg.seed).choice(16, n, replace=False))
    rng = np.random.default_rng(cfg.seed)
    want = []
    for _ in range(cfg.epochs):
        order = rng.permutation(n)
        want += [order[s * B : (s + 1) * B] for s in range(n // B)]
    assert len(seen["idx"]) == len(want) == 2
    for got, ref in zip(seen["idx"], want):
        np.testing.assert_array_equal(got, ref)
    assert out["n_rows"] == n and out["steps_per_epoch"] == 1
    with open(tmp_path / "out" / "metrics.json") as f:
        assert json.load(f) == {"rot_acc": out["rot_acc"], "epochs": 2, "n_rows": n}


@pytest.fixture(scope="module")
def jax_steps():
    """Two jitted f32 JAX steps (scripts/pretrain_backbone.py:102-120, the
    key's permutation replaced by a given one) from a seeded init on a pool
    of random-pixel rows (no exact pool ties); the states before and after
    each, the losses and accuracies."""
    rng = np.random.default_rng(0)
    pool = rng.uniform(0, 1, (N_ROWS, S, S, C)).astype(np.float32)
    pool[..., 3] = rng.uniform(3.0, 14.0, (N_ROWS, S, S))
    idx = [rng.permutation(N_ROWS)[:B] for _ in range(2)]
    perms = [rng.permutation(B) for _ in range(2)]
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR, weight_decay=WD))
    params, stats = jresnet.init_keypoint_cnn(jax.random.key(0), n_keypoints=2, num_channels=C)
    params, stats = (jax.tree.map(lambda x: x.astype(jnp.float32), t) for t in (params, stats))

    @jax.jit
    def train_step(images, params, stats, opt_state, idx, perm):
        img = jnp.take(images, idx, axis=0).astype(jnp.float32)
        img, labels = _jax_rot_batch(img)
        img, labels = img[perm], labels[perm]

        def loss_fn(p):
            logits, new_stats = jresnet.keypoint_cnn_apply(p, stats, img, train=True, compute_dtype=jnp.float32)
            loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, labels))
            acc = jnp.mean((jnp.argmax(logits, -1) == labels).astype(jnp.float32))
            return loss, (new_stats, acc)

        (loss, (new_stats, acc)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss, acc

    states = [(params, stats, optimizer.init(params))]
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jresnet, "MAXPOOL_CMP_VJP", True)
        for i in range(2):
            p, s, o, loss, acc = train_step(jnp.asarray(pool), *states[-1], jnp.asarray(idx[i]),
                                            jnp.asarray(perms[i]))
            states.append((p, s, o))
            out.append((float(loss), float(acc)))
    return pool, idx, perms, states, out


def _port_state(jstate):
    """A JAX (params, stats, optax state) as the port's TrainState. The
    script's optax.adamw carries its hyperparameters as Python floats (no
    inject_hyperparams, which convert.convert_opt_state reads): lr and wd
    are the test's."""
    params, stats, opt = jax.tree.map(np.asarray, jstate)
    sd = convert.from_jax_params(params, stats)
    adam = convert._find(opt, lambda n: all(hasattr(n, a) for a in ("mu", "nu", "count")))
    layout = lambda d: {k: convert._to_torch_layout(k, v) for k, v in d.items()}  # noqa: E731
    return train.TrainState({k: sd[k] for k in params}, {k: sd[k] for k in stats},
                            train.AdamWState(int(adam.count), layout(adam.mu), layout(adam.nu), LR, WD))


def _port_step(pool, state, idx, perm):
    step = pb.make_pretrain_step(train.ClipAdamW(1.0, LR, WD), compute_dtype=torch.float32)
    images = torch.from_numpy(np.ascontiguousarray(np.moveaxis(pool, -1, 1)))
    return step(state, images, torch.from_numpy(idx), perm=torch.from_numpy(perm))


def test_second_f32_step_matches_jax(jax_steps):
    pool, idx, perms, states, out = jax_steps
    state, loss, acc = _port_step(pool, _port_state(states[1]), idx[1], perms[1])
    np.testing.assert_allclose(loss.item(), out[1][0], rtol=1e-5)
    assert acc.item() == out[1][1]
    ref = _port_state(states[2])
    for part in ("params", "batch_stats"):
        for k, v in getattr(ref, part).items():
            np.testing.assert_allclose(getattr(state, part)[k].numpy(), v.numpy(), atol=1e-4, err_msg=k)
    moved = (state.params["layer1.0.conv1.weight"] - _port_state(states[1]).params["layer1.0.conv1.weight"]).abs()
    assert moved.max().item() > 0.5 * LR  # the update is not vacuous


def test_first_f32_step_matches_jax_up_to_adamw_sign_flips(jax_steps):
    pool, idx, perms, states, out = jax_steps
    state, loss, acc = _port_step(pool, _port_state(states[0]), idx[0], perms[0])
    np.testing.assert_allclose(loss.item(), out[0][0], rtol=1e-5)
    assert acc.item() == out[0][1]
    ref = _port_state(states[1])
    for k, v in ref.batch_stats.items():
        np.testing.assert_allclose(state.batch_stats[k].numpy(), v.numpy(), atol=1e-4, err_msg=k)
    diff = torch.cat([(state.params[k] - v).abs().flatten() for k, v in ref.params.items()])
    assert diff.max().item() <= 2 * LR + 1e-4
    assert (diff > 1e-4).float().mean().item() < 0.01


def test_checkpoint_feeds_init_backbone_and_init_head_raises(tmp_path):
    """The port's pretrain (bf16 step, the script's defaults but batch 8,
    1 epoch) writes <output_dir>/final; TrainConfig.init_backbone takes its
    backbone and BN statistics and keeps the keypoint head's random init;
    init_head raises on the 4-against-16-logit head."""
    path = generate_synthetic_pruned_dataset(str(tmp_path / "ds"), n_train=16, n_test=8, h=H, w=H)
    cfg = pb.PretrainConfig(dataset_path=path, output_dir=str(tmp_path / "pre"), epochs=1, batch_size=B)
    out = pb.pretrain(cfg, device="cpu")
    assert np.isfinite(out["loss"]) and 0.0 <= out["rot_acc"] <= 1.0
    final = os.path.join(cfg.output_dir, "final")
    saved = ckpt.restore_train_state(final)
    assert saved["epoch"] == 0 and saved["lr"] == 0.0 and saved["opt_state"].step == 2
    assert tuple(saved["params"]["fc.weight"].shape) == (4, 512)
    pre = ckpt.load_model(final)
    tcfg = TrainConfig(in_channels=4, init_backbone=final)
    state = train.init_state(tcfg, train.make_optimizer(tcfg), "cpu")
    fresh = train.init_state(TrainConfig(in_channels=4), train.make_optimizer(tcfg), "cpu")
    for k, v in state.params.items():
        want = fresh.params[k] if k.startswith("fc.") else pre[k]
        assert torch.equal(v, want), k
    for k, v in state.batch_stats.items():
        assert torch.equal(v, pre[k]), k
    with pytest.raises(ValueError, match="init_backbone shape mismatch at fc"):
        train.init_state(TrainConfig(in_channels=4, init_backbone=final, init_head=True), train.make_optimizer(tcfg),
                         "cpu")
