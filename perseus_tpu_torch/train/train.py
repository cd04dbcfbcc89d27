"""The detector's train step in PyTorch.

Port of the step of ``perseus_tpu/train/train.py``: augmentation
(:class:`~perseus_tpu_torch.augment.pipeline.KeypointAugmentation`, the
fused CUDA kernels on the card) -> ResNet-18 in train mode
(``models/resnet.py::keypoint_cnn_apply``, bf16 convs under ``cfg.amp``, the
stem maxpool's forward and gradient kernels) -> SmoothL1 with the
out-of-frame, spread and example-weight options of ``step_core`` ->
global-norm clip -> AdamW, as optax's ``clip_by_global_norm`` + ``adamw``.

Entry points: :func:`init_state`, :func:`make_optimizer`,
:func:`make_train_step` (:func:`make_loss_and_grads` and the optimizer),
:func:`make_eval_step`; and the trainer's device-resident-data
configuration (``cfg.data_on_device``), one card: a split held on the
device, each step gathering its batch by an index tensor
(:func:`make_device_data_train_step`), a whole epoch in one call
(:func:`make_device_data_epoch_fn`) and the eval step over a val split
(:func:`make_device_data_eval_step`, batches from
:func:`eval_index_batches`). The state is functional, as in JAX: a step
returns a new :class:`TrainState` and leaves its input unchanged. The
``train()`` loop over the HDF5 dataset (and filling the split from it),
checkpoints, EMA and data parallelism are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
from perseus_tpu_torch.models import resnet
from perseus_tpu_torch.train.config import TrainConfig

__all__ = [
    "AdamWState",
    "ClipAdamW",
    "TrainState",
    "PlateauScheduler",
    "smooth_l1_loss",
    "make_optimizer",
    "set_learning_rate",
    "init_state",
    "make_loss_and_grads",
    "make_train_step",
    "make_eval_step",
    "step_generator",
    "make_device_data_train_step",
    "make_device_data_epoch_fn",
    "make_device_data_eval_step",
    "eval_index_batches",
]


def _is_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


@dataclasses.dataclass(frozen=True)
class AdamWState:
    """AdamW's state under torch's names: ``step`` (optax's ``count``),
    ``exp_avg`` (``mu``) and ``exp_avg_sq`` (``nu``) per parameter, and the
    two hyperparameters optax injects (``learning_rate``, ``weight_decay``)."""

    step: int
    exp_avg: dict
    exp_avg_sq: dict
    learning_rate: float
    weight_decay: float


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    opt_state: AdamWState


class PlateauScheduler:
    """torch ReduceLROnPlateau(min) semantics: rel threshold 1e-4, reduce by
    ``factor`` after ``patience`` bad epochs, floor at ``min_lr``."""

    def __init__(self, base_lr: float, patience: int = 5, factor: float = 0.25, min_lr: float = 1e-6):
        self.lr = base_lr
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, value: float) -> float:
        if value < self.best * (1.0 - 1e-4):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


def _huber(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """optax.huber_loss, elementwise: 0.5 q^2 + delta (|e| - q), q = min(|e|, delta)."""
    abs_err = torch.abs(pred - target)
    quad = torch.clamp_max(abs_err, delta)
    return 0.5 * (quad * quad) + delta * (abs_err - quad)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """SmoothL1(beta=1.0) == Huber(delta=1.0), mean reduction."""
    return torch.mean(_huber(pred, target))


class ClipAdamW:
    """Global-norm clip, then AdamW, with optax's arithmetic:

      * clip (``optax.clip_by_global_norm``): g -> g if ||g|| < max_norm,
        else (g / ||g||) * max_norm; no epsilon (``clip_grad_norm_`` would
        divide by ||g|| + 1e-6);
      * AdamW (``optax.adamw``): m, v moments; u = m_hat / (sqrt(v_hat) +
        eps); u += weight_decay * p (every parameter, BN included); p += -lr
        * u. ``torch.optim.AdamW`` decays p before the Adam step, equal up
        to rounding; this keeps optax's order.

    Updates run as ``torch._foreach_*`` over the parameter list.
    """

    def __init__(self, max_norm: float, learning_rate: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.max_norm = max_norm
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
        return AdamWState(0, zeros(), zeros(), self.learning_rate, self.weight_decay)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict) -> tuple[dict, AdamWState]:
        keys = list(params)
        g = [grads[k] for k in keys]
        p = [params[k] for k in keys]
        norm = torch.sqrt(torch.stack([torch.sum(x * x) for x in g]).sum())
        keep = norm < self.max_norm
        g = [torch.where(keep, x, (x / norm) * self.max_norm) for x in g]
        # optax injects every hyperparameter as an f32 array, so 1 - b1 and
        # the bias corrections 1 - b1**step are f32 arithmetic: the same here
        f32 = np.float32
        b1, b2 = f32(self.b1), f32(self.b2)
        step = state.step + 1
        m = torch._foreach_add(
            torch._foreach_mul(g, float(f32(1) - b1)),
            torch._foreach_mul([state.exp_avg[k] for k in keys], float(b1)),
        )
        v = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), float(f32(1) - b2)),
            torch._foreach_mul([state.exp_avg_sq[k] for k in keys], float(b2)),
        )
        m_hat = torch._foreach_div(m, float(f32(1) - b1 ** f32(step)))
        v_hat = torch._foreach_div(v, float(f32(1) - b2 ** f32(step)))
        denom = torch._foreach_add(torch._foreach_sqrt(v_hat), self.eps)
        u = torch._foreach_div(m_hat, denom)
        u = torch._foreach_add(u, torch._foreach_mul(p, state.weight_decay))
        u = torch._foreach_mul(u, -state.learning_rate)
        new_p = torch._foreach_add(p, u)
        new_state = dataclasses.replace(
            state, step=step, exp_avg=dict(zip(keys, m)), exp_avg_sq=dict(zip(keys, v))
        )
        return dict(zip(keys, new_p)), new_state


def make_optimizer(cfg: TrainConfig) -> ClipAdamW:
    """clip(cfg.grad_clip_norm) -> AdamW(cfg.learning_rate, cfg.weight_decay)."""
    return ClipAdamW(cfg.grad_clip_norm, cfg.learning_rate, cfg.weight_decay)


def set_learning_rate(opt_state: AdamWState, lr: float) -> AdamWState:
    """The state with a new learning rate (the plateau schedule's hook)."""
    return dataclasses.replace(opt_state, learning_rate=float(lr))


def _prepare_aug_batch(batch: dict, in_channels: int, use_transplant: bool) -> np.ndarray:
    """Stacks RGB (+ depth) (+ seg) of a host batch (NHWC ``image``, (B, H,
    W) ``depth_image`` and ``segmentation_image``) into the (B, C, H, W)
    f32 augmentation input: the channels of the JAX package's
    ``_prepare_aug_batch``, in the port's layout."""
    parts = [np.moveaxis(np.asarray(batch["image"]), -1, 1)]
    if in_channels >= 4:
        parts.append(np.asarray(batch["depth_image"])[:, None])
    if use_transplant and in_channels < 5:
        if in_channels == 3:
            parts.append(np.asarray(batch["depth_image"])[:, None])
        parts.append(np.asarray(batch["segmentation_image"])[:, None])
    return np.ascontiguousarray(np.concatenate(parts, axis=1, dtype=np.float32))


def init_state(
    cfg: TrainConfig,
    optimizer: ClipAdamW,
    device: str | torch.device | None = "cuda",
    state_dict: dict[str, torch.Tensor] | None = None,
) -> TrainState:
    """The initial train state on ``device``: from ``state_dict`` (e.g.
    ``convert.from_jax_params`` of JAX parameters) when given, else a random
    init drawn from ``cfg.random_seed`` by an explicit generator. A fresh
    optimizer state. Loading ``cfg.init_checkpoint`` / ``cfg.init_backbone``
    is not ported yet, and a config that sets either is refused."""
    if cfg.init_checkpoint or cfg.init_backbone:
        raise NotImplementedError("init_state: init_checkpoint / init_backbone loading is not ported yet")
    dev = resolve_device(device)
    if state_dict is None:
        model = resnet.KeypointCNN(
            cfg.n_keypoints, cfg.in_channels, head=cfg.head, feat_hw=cfg.input_resolution // 32,
            device="cpu", generator=torch.Generator().manual_seed(cfg.random_seed),
        )
        state_dict = {k: v.detach() for k, v in model.state_dict().items()}
    params = {k: v.to(dev, torch.float32).clone() for k, v in state_dict.items() if not _is_stat(k)}
    stats = {k: v.to(dev, torch.float32).clone() for k, v in state_dict.items() if _is_stat(k)}
    return TrainState(params, stats, optimizer.init(params))


def make_loss_and_grads(cfg: TrainConfig, train_augment: KeypointAugmentation):
    """The train step up to the optimizer: ``loss_and_grads(state,
    images_aug, coords, gen=None, weights=None, draws=None) -> (loss, grads,
    new_batch_stats)``, ``grads`` a dict over ``state.params``' keys.

    ``images_aug`` (B, C, H, W) on the state's device, ``coords`` (B, K, 2)
    pixels, ``gen`` the augmentation's generator, ``weights`` (B,) the
    example weights (required with ``cfg.use_example_weights``). ``draws``
    replaces sampling from ``gen`` by given draws (``train_augment.sample``'s
    dict), so a test can apply the JAX pipeline's draws.
    """
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32

    def loss_and_grads(state: TrainState, images_aug, coords, gen=None, weights=None, draws=None):
        if cfg.use_example_weights and weights is None:
            raise ValueError("cfg.use_example_weights: the step needs the batch's weights")
        b, c, h, w = images_aug.shape
        if draws is None:
            draws = train_augment.sample(gen, b, h, w, c)
        with torch.no_grad():
            images, target = train_augment.apply(images_aug, coords, draws)
        images = images[:, : cfg.in_channels]
        h_img, w_img = images.shape[2], images.shape[3]

        # out-of-frame corners: post-augmentation targets are normalized, so
        # a corner is out of frame where |coord| > 1
        corner_w = None
        if cfg.outframe_corner_weight != 1.0:
            out = torch.any(torch.abs(target) > 1.0, dim=-1)  # (B, K)
            cw = torch.where(out, cfg.outframe_corner_weight, 1.0).to(target.dtype)
            corner_w = torch.repeat_interleave(cw, 2, dim=-1)
            corner_w = corner_w / torch.clamp_min(torch.mean(corner_w), 1e-12)
        if cfg.outframe_clamp_px >= 0:
            mm = torch.tensor(
                [2.0 * cfg.outframe_clamp_px / (w_img - 1.0), 2.0 * cfg.outframe_clamp_px / (h_img - 1.0)],
                dtype=target.dtype, device=target.device,
            )
            target = torch.clamp(target, -1.0 - mm, 1.0 + mm)
        target = target.reshape(target.shape[0], -1)

        def spread_loss(pred):
            p = pred.reshape(pred.shape[0], -1, 2)
            t = target.reshape(target.shape[0], -1, 2)
            dp = torch.linalg.norm(p - torch.mean(p, dim=1, keepdim=True), dim=-1)
            dt = torch.linalg.norm(t - torch.mean(t, dim=1, keepdim=True), dim=-1)
            return torch.mean(_huber(dp, dt))

        def loss_fn(pred):
            aux = cfg.spread_loss_weight * spread_loss(pred) if cfg.spread_loss_weight else 0.0
            if weights is None:
                if corner_w is None:
                    return smooth_l1_loss(pred, target) + aux
                return torch.mean(_huber(pred, target) * corner_w) + aux
            per_coord = _huber(pred, target)
            if corner_w is not None:
                per_coord = per_coord * corner_w
            per_example = torch.mean(per_coord, dim=-1)
            wnorm = weights / torch.clamp_min(torch.mean(weights), 1e-12)
            wnorm = torch.clamp_max(wnorm, cfg.example_weight_clip)
            wnorm = wnorm / torch.clamp_min(torch.mean(wnorm), 1e-12)
            return torch.mean(per_example * wnorm) + aux

        keys = list(state.params)
        params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
        # the backward's f32 convs too must not run in TF32
        with torch.enable_grad(), resnet._full_f32():
            pred, new_stats = resnet.keypoint_cnn_apply(
                {**params, **state.batch_stats}, images, train=True,
                compute_dtype=compute_dtype, s2d_stem=cfg.s2d_stem,
            )
            loss = loss_fn(pred)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
        return loss.detach(), dict(zip(keys, grads)), new_stats

    return loss_and_grads


def make_train_step(cfg: TrainConfig, optimizer: ClipAdamW, train_augment: KeypointAugmentation):
    """The train step ``step(state, images_aug, coords, gen=None,
    weights=None, draws=None) -> (new_state, loss)``: :func:`make_loss_and_grads`'s
    arguments, then clip + AdamW."""
    loss_and_grads = make_loss_and_grads(cfg, train_augment)

    def step(state: TrainState, images_aug, coords, gen=None, weights=None, draws=None):
        loss, grads, new_stats = loss_and_grads(state, images_aug, coords, gen, weights, draws)
        new_params, new_opt = optimizer.update(grads, state.opt_state, state.params)
        return TrainState(new_params, new_stats, new_opt), loss

    return step


def make_eval_step(cfg: TrainConfig, val_augment: KeypointAugmentation):
    """``step(state, images, coords, weights) -> (loss_sum, count)``:
    per-example SmoothL1 means weighted by ``weights`` (0 marks padding
    rows), the model in eval mode after the val augmentation."""
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32

    @torch.no_grad()
    def step(state: TrainState, images, coords, weights):
        images, target = val_augment(None, images, coords)
        images = images[:, : cfg.in_channels]
        target = target.reshape(target.shape[0], -1)
        pred, _ = resnet.keypoint_cnn_apply(
            {**state.params, **state.batch_stats}, images, train=False,
            compute_dtype=compute_dtype, s2d_stem=cfg.s2d_stem,
        )
        per_elem = torch.mean(_huber(pred, target), dim=-1)
        return torch.sum(per_elem * weights), torch.sum(weights)

    return step


def step_generator(run_seed: int, step: int, device) -> torch.Generator:
    """The augmentation's generator of global step ``step`` on ``device``,
    seeded from (run seed, step) alone: the counterpart of JAX's
    ``fold_in(run_key, step)``, so a step makes the same draws whether it
    runs inside an epoch call or on its own."""
    seed = int(np.random.SeedSequence([run_seed, step]).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def _gather(ds: torch.Tensor, idx) -> torch.Tensor:
    return ds.index_select(0, torch.as_tensor(idx, device=ds.device).long())


def make_device_data_train_step(cfg: TrainConfig, optimizer: ClipAdamW, train_augment: KeypointAugmentation):
    """Train step over a device-resident split: ``step(state, ds_images,
    ds_coords, idx, gen, ds_weights=None) -> (new_state, loss)`` gathers rows
    ``idx`` (B,) of ``ds_images`` (N, C, H, W), ``ds_coords`` (N, K, 2) and,
    with ``cfg.use_example_weights``, ``ds_weights`` (N,) on their device,
    then takes :func:`make_train_step`'s step (one card: JAX's ``mesh=None``)."""
    base_step = make_train_step(cfg, optimizer, train_augment)

    def step(state: TrainState, ds_images, ds_coords, idx, gen, ds_weights=None):
        weights = None if ds_weights is None else _gather(ds_weights, idx)
        return base_step(state, _gather(ds_images, idx), _gather(ds_coords, idx), gen, weights=weights)

    return step


def make_device_data_epoch_fn(cfg: TrainConfig, optimizer: ClipAdamW, train_augment: KeypointAugmentation):
    """A whole epoch over a device-resident split in one call:
    ``epoch_fn(state, ds_images, ds_coords, idx_epoch, run_seed, base_step,
    ds_weights=None) -> (state, losses)``. Step ``s`` takes rows
    ``idx_epoch[s]`` of the (steps, B) index tensor with the generator
    :func:`step_generator` (run_seed, base_step + s) on the split's device,
    the same draws and data order as calling the step alone. ``losses`` is
    one (steps,) tensor on the device (one read-back per epoch)."""
    dd_step = make_device_data_train_step(cfg, optimizer, train_augment)

    def epoch_fn(state: TrainState, ds_images, ds_coords, idx_epoch, run_seed: int, base_step: int, ds_weights=None):
        losses = []
        for s in range(idx_epoch.shape[0]):
            gen = step_generator(run_seed, base_step + s, ds_images.device)
            state, loss = dd_step(state, ds_images, ds_coords, idx_epoch[s], gen, ds_weights)
            losses.append(loss)
        return state, torch.stack(losses)

    return epoch_fn


def make_device_data_eval_step(cfg: TrainConfig, val_augment: KeypointAugmentation):
    """Eval step over a device-resident val split: ``step(state, ds_images,
    ds_coords, idx, mask) -> (loss_sum, count)``, :func:`make_eval_step`
    on rows ``idx`` with ``mask`` (B,) as the weights: 0 for the filler
    rows of a last, partial batch, so every real row counts once."""
    base_step = make_eval_step(cfg, val_augment)

    def step(state: TrainState, ds_images, ds_coords, idx, mask):
        mask = torch.as_tensor(mask, dtype=torch.float32, device=ds_images.device)
        return base_step(state, _gather(ds_images, idx), _gather(ds_coords, idx), mask)

    return step


def eval_index_batches(n_rows: int, batch_size: int):
    """(idx, mask) pairs, numpy int64 and f32 of length ``batch_size``,
    covering rows 0..n_rows-1 once in order; the last batch is filled up
    with row 0 at mask 0 (the JAX trainer's val loop on one device)."""
    for start in range(0, n_rows, batch_size):
        length = min(batch_size, n_rows - start)
        idx = np.zeros(batch_size, np.int64)
        mask = np.zeros(batch_size, np.float32)
        idx[:length] = np.arange(start, start + length)
        mask[:length] = 1.0
        yield idx, mask
