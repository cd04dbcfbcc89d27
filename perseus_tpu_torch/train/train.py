"""The detector's trainer in PyTorch.

Port of ``perseus_tpu/train/train.py``. The step: augmentation
(:class:`~perseus_tpu_torch.augment.pipeline.KeypointAugmentation`, the
fused CUDA kernels on the card) -> ResNet-18 in train mode
(``models/resnet.py::keypoint_cnn_apply``, bf16 convs under ``cfg.amp``, the
stem maxpool's forward and gradient kernels) -> SmoothL1 with the
out-of-frame, spread and example-weight options of ``step_core`` ->
global-norm clip -> AdamW, as optax's ``clip_by_global_norm`` + ``adamw``.

Entry points: :func:`train` (and :func:`main`, its command line), the loop
over a pruned dataset (``data/dataset.py``: the HDF5 + image files, or a
decoded split) with eval feeding the :class:`PlateauScheduler`, an epoch
EMA, checkpoints every ``save_epochs`` and exact ``resume``
(``train/checkpoint.py``); its parts :func:`init_state` (random, or from
``init_checkpoint`` / ``init_backbone``), :func:`make_optimizer`,
:func:`make_train_step` (:func:`make_loss_and_grads` and the optimizer),
:func:`make_eval_step`; and the device-resident-data configuration
(``cfg.data_on_device``), one card: the split decoded onto the device
(:func:`_device_dataset`), each step gathering its batch by an index tensor
(:func:`make_device_data_train_step`), a whole epoch in one call
(:func:`make_device_data_epoch_fn`) and the eval step over a val split
(:func:`make_device_data_eval_step`, batches from
:func:`eval_index_batches`). The state is functional, as in JAX: a step
returns a new :class:`TrainState` and leaves its input unchanged.

Data parallelism (``cfg.distributed`` / ``cfg.coordinator_address``): one
process per rank, ``torch.distributed`` brought up by
:func:`maybe_initialize_distributed`, with the JAX mesh's semantics. Each
rank augments its own block of the global batch (its generator keyed on
(seed, step, rank), transplant donors from its own rows); batch norm takes
the global batch's statistics (``models/resnet.py``); the loss, the
example and corner weights' means and the val sums are global; the
gradients are all-reduced in one flat bucket before the global-norm clip,
so every rank takes the same update. The host loader and the
device-resident split are sharded per rank; rank 0 alone logs and saves.
Only ``all_reduce`` and ``broadcast`` are used, so gloo can carry CUDA
tensors (two ranks sharing one card) as well as NCCL.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from perseus_tpu_torch import ROOT, resolve_device
from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
from perseus_tpu_torch.data.dataset import PrefetchingLoader, PrunedKeypointDataset
from perseus_tpu_torch.models import resnet
from perseus_tpu_torch.train import checkpoint as ckpt
from perseus_tpu_torch.train.config import TrainConfig
from perseus_tpu_torch.utils import logging as ptlog

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
    "make_sample_weights",
    "maybe_initialize_distributed",
    "train",
    "main",
]


def _is_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


def _rank_world() -> tuple[int, int]:
    """(rank, world size) of the active process group; (0, 1) without one."""
    world = resnet._world_size()
    return (dist.get_rank() if world > 1 else 0), world


def _global_mean(t: torch.Tensor, world: int) -> torch.Tensor:
    """The mean of a data tensor (no gradient) over the global batch, whose
    rank blocks are all of ``t``'s shape."""
    if world == 1:
        return torch.mean(t)
    total = torch.sum(t).reshape(1)
    dist.all_reduce(total)
    return total[0] / (t.numel() * world)


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


def _aug_channels(in_channels: int, use_transplant: bool) -> int:
    """The channel count :func:`_prepare_aug_batch` stacks."""
    extra = (in_channels == 3) + 1 if use_transplant and in_channels < 5 else 0
    return 3 + (in_channels >= 4) + extra


def _prepare_aug_batch(batch: dict, in_channels: int, use_transplant: bool, out: np.ndarray | None = None) -> np.ndarray:
    """Stacks RGB (+ depth) (+ seg) of a host batch (NHWC ``image``, (B, H,
    W) ``depth_image`` and ``segmentation_image``) into the (B, C, H, W)
    f32 augmentation input: the channels of the JAX package's
    ``_prepare_aug_batch``, in the port's layout. With ``out`` (f32, C =
    :func:`_aug_channels`), written there."""
    parts = [np.moveaxis(np.asarray(batch["image"]), -1, 1)]
    if in_channels >= 4:
        parts.append(np.asarray(batch["depth_image"])[:, None])
    if use_transplant and in_channels < 5:
        if in_channels == 3:
            parts.append(np.asarray(batch["depth_image"])[:, None])
        parts.append(np.asarray(batch["segmentation_image"])[:, None])
    if out is not None:
        return np.concatenate(parts, axis=1, out=out)
    return np.ascontiguousarray(np.concatenate(parts, axis=1, dtype=np.float32))


def init_state(
    cfg: TrainConfig,
    optimizer: ClipAdamW,
    device: str | torch.device | None = "cuda",
    state_dict: dict[str, torch.Tensor] | None = None,
) -> TrainState:
    """The initial train state on ``device``, with a fresh optimizer state.
    The model comes from ``state_dict`` (e.g. ``convert.from_jax_params`` of
    JAX parameters) when given; else from ``cfg.init_checkpoint`` (a port
    checkpoint directory or a ``.pth``: params and batch stats); else a
    random init drawn from ``cfg.random_seed`` by an explicit generator,
    over which ``cfg.init_backbone``'s checkpoint copies its params (all but
    the ``fc.`` head, which ``cfg.init_head`` adds; a shape mismatch
    raises) and its batch stats."""
    dev = resolve_device(device)
    if state_dict is None and cfg.init_checkpoint:
        state_dict = ckpt.load_model(cfg.init_checkpoint)
    if state_dict is None:
        model = resnet.KeypointCNN(
            cfg.n_keypoints, cfg.in_channels, head=cfg.head, feat_hw=cfg.input_resolution // 32,
            device="cpu", generator=torch.Generator().manual_seed(cfg.random_seed),
        )
        state_dict = {k: v.detach() for k, v in model.state_dict().items()}
        if cfg.init_backbone:
            for k, v in ckpt.load_model(cfg.init_backbone).items():
                if k not in state_dict or not (_is_stat(k) or cfg.init_head or not k.startswith("fc.")):
                    continue
                if not _is_stat(k) and state_dict[k].shape != v.shape:
                    raise ValueError(f"init_backbone shape mismatch at {k}: {tuple(v.shape)} vs {tuple(state_dict[k].shape)}")
                state_dict[k] = v
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

    In a process group of W > 1 ranks the arguments are this rank's block
    of the global batch (all blocks of one size), and the results are the
    global batch's, the same on every rank: the weights' means are global,
    each rank back-propagates its share (its batch means / W) through the
    global batch norm, and the loss and the gradients are summed over the
    ranks in one all-reduce.
    """
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32

    def loss_and_grads(state: TrainState, images_aug, coords, gen=None, weights=None, draws=None):
        if cfg.use_example_weights and weights is None:
            raise ValueError("cfg.use_example_weights: the step needs the batch's weights")
        world = resnet._world_size()
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
            corner_w = corner_w / torch.clamp_min(_global_mean(corner_w, world), 1e-12)
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
            wnorm = weights / torch.clamp_min(_global_mean(weights, world), 1e-12)
            wnorm = torch.clamp_max(wnorm, cfg.example_weight_clip)
            wnorm = wnorm / torch.clamp_min(_global_mean(wnorm, world), 1e-12)
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
            if world > 1:
                loss = loss / world  # this rank's share of the global batch's means
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
        loss = loss.detach()
        if world > 1:
            # one bucket: the loss and every gradient, summed over the ranks
            flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            loss = flat[0]
            parts = torch.split(flat[1:], [g.numel() for g in grads])
            grads = [p.view_as(g) for p, g in zip(parts, grads)]
        return loss, dict(zip(keys, grads)), new_stats

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
    rows), the model in eval mode after the val augmentation. In a process
    group of W > 1 ranks, each passes its block of the batch and gets the
    global batch's sum and count."""
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
        loss_sum, count = torch.sum(per_elem * weights), torch.sum(weights)
        if resnet._world_size() > 1:
            pair = torch.stack([loss_sum, count])
            dist.all_reduce(pair)
            loss_sum, count = pair[0], pair[1]
        return loss_sum, count

    return step


def step_generator(run_seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The augmentation's generator of global step ``step`` on ``device``,
    seeded from (run seed, step) alone: the counterpart of JAX's
    ``fold_in(run_key, step)``, so a step makes the same draws whether it
    runs inside an epoch call or on its own. Rank ``r`` > 0 of a
    data-parallel run draws from (run seed, step, r), the counterpart of
    ``make_sharded_augment``'s ``fold_in(key, shard)``: an independent
    stream per rank, rank 0's (and one rank's) unchanged."""
    key = [run_seed, step] if rank == 0 else [run_seed, step, rank]
    seed = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0]) >> 1
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
    :func:`step_generator` (run_seed, base_step + s, this rank) on the
    split's device, the same draws and data order as calling the step
    alone. ``losses`` is one (steps,) tensor on the device (one read-back
    per epoch)."""
    dd_step = make_device_data_train_step(cfg, optimizer, train_augment)

    def epoch_fn(state: TrainState, ds_images, ds_coords, idx_epoch, run_seed: int, base_step: int, ds_weights=None):
        rank, _ = _rank_world()
        losses = []
        for s in range(idx_epoch.shape[0]):
            gen = step_generator(run_seed, base_step + s, ds_images.device, rank)
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


@torch.no_grad()
def _ema_apply(ema, snap, decay: float):
    """``decay * ema + (1 - decay) * snap`` over nested dicts of tensors,
    as fresh tensors."""
    if isinstance(ema, dict):
        return {k: _ema_apply(ema[k], snap[k], decay) for k in ema}
    return decay * ema + (1.0 - decay) * snap


def make_sample_weights(dataset: PrunedKeypointDataset, cfg: TrainConfig) -> np.ndarray | None:
    """Per-row epoch-sampling weights targeting the measured failure regimes
    (``cfg.oversample_close`` / ``oversample_outframe``) and/or a per-row
    difficulty file (``cfg.sample_weights_path``); None = uniform."""
    if not (cfg.oversample_close or cfg.oversample_outframe or cfg.sample_weights_path):
        return None
    seg = np.asarray(dataset.split.segmentation_ratios, np.float64)
    pc = np.asarray(dataset.pixel_coordinates)
    any_out = (
        (pc[..., 0] < 0) | (pc[..., 0] > dataset.W - 1) | (pc[..., 1] < 0) | (pc[..., 1] > dataset.H - 1)
    ).any(axis=-1)
    w = 1.0 + cfg.oversample_close * (seg > cfg.close_seg_threshold) + cfg.oversample_outframe * any_out
    w = np.asarray(w, np.float64)
    if cfg.sample_weights_path:
        dw = np.load(cfg.sample_weights_path).astype(np.float64)
        if dw.shape != (len(dataset),):
            raise ValueError(
                f"sample_weights_path rows {dw.shape} != dataset rows {len(dataset)} "
                "— weights were computed against a different train split"
            )
        if dw.min() <= 0:
            raise ValueError("difficulty weights must be positive")
        w = w * dw
    return w


def _device_local_rows(n_dev: int, n_local: int, n_dataset: int, subset: np.ndarray | None) -> np.ndarray:
    """Dataset row held at shard-local position (d, i) of a device-resident
    split laid out as ``order[d * n_local + i]``, ``order = arange(n_dev *
    n_local) % n_resident`` (wrap-pad), mapped through ``subset`` when
    given: the weighted epoch draw looks up each row's probability here.
    One card: ``n_dev`` 1, ``n_local`` the resident rows."""
    n_res = len(subset) if subset is not None else n_dataset
    rows = (np.arange(n_dev)[:, None] * n_local + np.arange(n_local)[None, :]) % n_res
    if subset is not None:
        rows = np.asarray(subset)[rows]
    return rows


def _device_dataset(
    dataset: PrunedKeypointDataset,
    cfg: TrainConfig,
    device,
    use_transplant: bool,
    chunk: int = 128,
    subset: np.ndarray | None = None,
    rank: int = 0,
    world: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, np.ndarray, int]:
    """Decodes rank ``rank``'s shard of a split (or of its rows ``subset``)
    onto ``device``: the (N, C, H, W) augmentation input in
    ``cfg.device_data_dtype``, (N, K, 2) f32 keypoints and (N,) f32 example
    weights. The resident rows are wrap-padded to ``world`` shards of
    ``n_local`` rows and this rank decodes only its own, laid out as
    :func:`_device_local_rows` ``[rank]`` (the JAX package's sharded
    split); one rank holds them all. The images are decoded and uploaded
    ``chunk`` rows at a time into a buffer allocated on the device first
    (~170 MB a chunk at 256x256x5 f32), so the host never holds the split.
    Returns (images, coords, weights, valid, n_local): ``valid`` (a host
    array) flags real rows (0 for the wrap-padding), and ``n_local`` is the
    rows held."""
    dev = resolve_device(device)
    n_res = len(dataset) if subset is None else len(subset)
    n_local = -(-n_res // world)
    order = _device_local_rows(world, n_local, len(dataset), subset)[rank]
    n = len(order)
    c = _aug_channels(cfg.in_channels, use_transplant)
    images = torch.empty((n, c, dataset.H, dataset.W), dtype=getattr(torch, cfg.device_data_dtype), device=dev)
    coords = []
    for s in range(0, n, chunk):
        batch = dataset.batch(order[s : s + chunk])
        images[s : s + chunk].copy_(torch.from_numpy(_prepare_aug_batch(batch, cfg.in_channels, use_transplant)))
        coords.append(np.asarray(batch["pixel_coordinates"], np.float32))
    d_coords = torch.from_numpy(np.concatenate(coords)).to(dev)
    d_weights = torch.from_numpy(np.asarray(dataset.weights[order], np.float32)).to(dev)
    valid = (rank * n_local + np.arange(n_local) < n_res).astype(np.float32)
    return images, d_coords, d_weights, valid, n_local


class _HostFeed:
    """The host loader's device put: each array is written into a pinned
    staging buffer and copied to the card without blocking the host. Two
    buffers per name take turns, so the host fills one while the other's
    copy may still be in flight; an event per buffer says when its copy is
    done. On the CPU, the arrays are the step's inputs themselves."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rings: dict = {}

    def put(self, name: str, shape: tuple, fill) -> torch.Tensor:
        """``fill(out)`` writes an f32 array of ``shape`` into ``out``;
        returns it as a tensor on the device."""
        if self.device.type != "cuda":
            out = torch.empty(shape)
            fill(out.numpy())
            return out
        ring = self.rings.setdefault(name, [None, None, 0])
        k = ring[2]
        ring[2] = 1 - k
        if ring[k] is None or tuple(ring[k][0].shape) != tuple(shape):
            # a buffer freed while its copy is in flight stays reserved: the
            # caching host allocator waits for the copy's stream
            ring[k] = (torch.empty(shape, pin_memory=True), torch.cuda.Event())
        buf, done = ring[k]
        done.synchronize()
        fill(buf.numpy())
        out = buf.to(self.device, non_blocking=True)
        done.record()
        return out


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A small host tensor on ``dev``, without waiting for the device."""
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def maybe_initialize_distributed(
    cfg: TrainConfig, device: str | torch.device | None = "cuda", backend: str | None = None
) -> torch.device:
    """Brings up the data-parallel process group and returns this rank's
    device (the JAX package's ``maybe_initialize_distributed``). Without
    ``cfg.distributed`` or ``cfg.coordinator_address`` it only resolves
    ``device``. With ``coordinator_address`` (host:port) the group meets
    there (``tcp://``), ``cfg.num_processes`` ranks of which this is
    ``cfg.process_id``; with bare ``distributed=True`` it takes torchrun's
    environment (``env://``: ``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE`` ...).

    The backend follows the device, NCCL for CUDA and gloo for the CPU,
    unless ``backend`` names another: gloo also carries CUDA tensors, so
    ranks may share one card (``device="cuda:0"``, ``backend="gloo"``).
    A card given with its index is taken as given; bare ``"cuda"`` is card
    ``LOCAL_RANK`` (else ``cfg.process_id``), and a host with more local
    ranks than cards raises, so two ranks never share a card unasked.
    Re-entrant: an existing group is kept."""
    dev = resolve_device(device)
    if not (cfg.distributed or cfg.coordinator_address):
        return dev
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", max(cfg.process_id, 0)))
            n_local = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
            if max(local + 1, n_local) > torch.cuda.device_count():
                raise ValueError(
                    f"{max(local + 1, n_local)} ranks on this host but {torch.cuda.device_count()} CUDA card(s): "
                    "bare 'cuda' gives each local rank a card of its own; pass device='cuda:<i>' (and "
                    "backend='gloo') to put ranks on one card on purpose"
                )
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if cfg.coordinator_address:
        dist.init_process_group(
            backend, init_method=f"tcp://{cfg.coordinator_address}",
            world_size=cfg.num_processes, rank=cfg.process_id,
        )
    else:
        dist.init_process_group(backend, init_method="env://")
    return dev


def _check_replicas(state: TrainState) -> None:
    """Raises on every rank unless every rank holds rank 0's params and
    batch stats bit for bit (one broadcast, one all-reduce of the verdict,
    so no rank is left waiting in a collective)."""
    flat = torch.cat([v.reshape(-1) for part in (state.params, state.batch_stats) for v in part.values()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    differ = (ref != flat).any().to(flat.dtype).reshape(1)
    dist.all_reduce(differ)
    if differ.item():
        raise RuntimeError(
            "the ranks' initial states differ: give every rank the same config "
            "(random_seed, init_checkpoint, init_backbone, resume)"
        )


def _broadcast_run_id(run_id: str, dev: torch.device) -> str:
    """Rank 0's run id on every rank: every rank must name the same run."""
    buf = torch.tensor(list(run_id.encode().ljust(32)[:32]), dtype=torch.uint8, device=dev)
    dist.broadcast(buf, src=0)
    return bytes(buf.tolist()).decode().strip()


def train(cfg: TrainConfig, device: str | torch.device | None = "cuda") -> dict:
    """Runs the full training loop on ``device`` (the card unless the caller
    passes ``device="cpu"``); returns the JAX trainer's summary dict:
    ``run_id``, ``final_train_loss``, ``train_loss_history`` (per-epoch
    mean), ``final_val_loss``, ``state`` and ``ema`` ({"params",
    "batch_stats"}, or None without ``cfg.ema_decay``).

    As the JAX trainer: epochs from the host loader (a batch prepared on
    the host and put on the card each step) or, with ``cfg.data_on_device``,
    from the split decoded onto the card (a step per call, or the epoch in
    one call with ``device_data_epoch_scan``; a ``device_data_rows`` subset
    redrawn every ``device_data_refresh_epochs``); step ``s``'s
    augmentation draws from :func:`step_generator` (seed, s) and epoch
    ``e``'s order from (seed, e), so a resumed run takes the same steps as
    an uninterrupted one. Eval every ``val_epochs`` drives the plateau LR;
    the EMA updates once an epoch; the whole state is saved every
    ``save_epochs`` under ``outputs/models/<run_id>``, and ``resume``
    restores it with the scheduler's memory. Per-step losses are read back
    once an epoch and logged (``outputs/runs/<run_id>/metrics.jsonl``) with
    each epoch's time, img/s, val loss and LR. ``profile_dir``: a
    torch.profiler trace of ``profile_steps`` steps after this run's first.

    Data parallel (``cfg.distributed`` / ``cfg.coordinator_address``, see
    :func:`maybe_initialize_distributed`, which ``train`` calls first with
    ``device``): each of the W ranks runs this loop on ``batch_size // W``
    rows of every global batch (a batch not divisible by W raises): the
    host loader's shard ``rank`` of each global batch, or rank ``rank``'s
    shard of the device-resident split in its own epoch order from (seed,
    epoch, rank); the val rows likewise, each real row counted once. The
    run id is rank 0's, the initial state is checked equal on every rank,
    rank 0 alone logs, prints, traces and saves (the others wait for each
    save), and img/s counts each global image once.
    """
    dev = maybe_initialize_distributed(cfg, device)
    rank, world = _rank_world()
    if cfg.batch_size % world:
        raise ValueError(f"batch_size ({cfg.batch_size}) must be divisible by the number of ranks ({world})")
    bs = cfg.batch_size // world  # this rank's rows of every global batch
    np.random.seed(cfg.random_seed)

    train_dataset = PrunedKeypointDataset(cfg.dataset_config, train=True, cache=cfg.cache_dataset)
    val_dataset = PrunedKeypointDataset(cfg.dataset_config, train=False, cache=cfg.cache_dataset)
    sample_w = make_sample_weights(train_dataset, cfg)
    train_loader = PrefetchingLoader(
        train_dataset, bs, shuffle=True, seed=cfg.random_seed, sample_weights=sample_w,
        shard_index=rank, num_shards=world,
    )
    val_loader = PrefetchingLoader(
        val_dataset, bs, shuffle=False, drop_last=False, shard_index=rank, num_shards=world
    )

    optimizer = make_optimizer(cfg)
    state = init_state(cfg, optimizer, dev)
    train_augment = KeypointAugmentation(cfg.augmentation_config, train=True)
    val_augment = KeypointAugmentation(cfg.augmentation_config, train=False)
    use_transplant = cfg.augmentation_config.random_transplantation_with_depth
    train_step = make_train_step(cfg, optimizer, train_augment)
    eval_step = make_eval_step(cfg, val_augment)
    if cfg.data_on_device:
        dd_train_step = make_device_data_train_step(cfg, optimizer, train_augment)
        dd_epoch_fn = make_device_data_epoch_fn(cfg, optimizer, train_augment)
        dd_eval_step = make_device_data_eval_step(cfg, val_augment)

    scheduler = PlateauScheduler(cfg.learning_rate, cfg.plateau_patience, cfg.plateau_factor, cfg.min_learning_rate)
    ema = None  # epoch-scale Polyak average (cfg.ema_decay); an eval artifact
    start_epoch = 0
    if cfg.resume:
        saved = ckpt.restore_train_state(cfg.resume, device=dev)
        state = TrainState(saved["params"], saved["batch_stats"], saved["opt_state"])
        start_epoch = int(saved.get("epoch", -1)) + 1
        scheduler.lr = float(saved.get("lr", cfg.learning_rate))
        # the plateau memory must survive the restart, or the LR trajectory
        # parts from an uninterrupted run's whenever a plateau spans it
        scheduler.best = float(saved.get("sched_best", float("inf")))
        scheduler.num_bad = int(saved.get("sched_num_bad", 0))
        if "ema_params" in saved:
            ema = {"params": saved["ema_params"], "batch_stats": saved["ema_batch_stats"]}
        state = state._replace(opt_state=set_learning_rate(state.opt_state, scheduler.lr))
        run_id = os.path.basename(os.path.normpath(cfg.resume))
    else:
        run_id = ptlog.generate_id()
    if world > 1:
        _check_replicas(state)
        if not cfg.resume:
            run_id = _broadcast_run_id(run_id, dev)
    run = ptlog.init(cfg.wandb_project, config=cfg, run_id=run_id) if rank == 0 else None

    def _dd_subset_for(epoch: int) -> np.ndarray | None:
        """The device-resident row subset of this epoch (None: the whole
        split), keyed by its refresh window, so a resumed run rebuilds the
        subset an uninterrupted run would hold."""
        if not (cfg.device_data_rows and cfg.device_data_rows < len(train_dataset)):
            return None
        r = cfg.device_data_refresh_epochs
        window = (epoch // r) * r if r else 0
        rng = np.random.default_rng((cfg.random_seed, 7771, window))
        return np.sort(rng.choice(len(train_dataset), cfg.device_data_rows, replace=False))

    dd_sub_window = dd_cur_sub = dd_train = dd_val = None
    if cfg.data_on_device:
        dd_cur_sub = _dd_subset_for(start_epoch)
        r = cfg.device_data_refresh_epochs
        dd_sub_window = (start_epoch // r) * r if (r and dd_cur_sub is not None) else 0
        dd_train = _device_dataset(train_dataset, cfg, dev, use_transplant, subset=dd_cur_sub, rank=rank, world=world)
        dd_val = _device_dataset(val_dataset, cfg, dev, use_transplant=False, rank=rank, world=world)
        steps_per_epoch = dd_train[4] // bs
    else:
        steps_per_epoch = train_loader.num_batches()
    if steps_per_epoch == 0:
        where = f"device-resident, {dd_train[4]} rows" if cfg.data_on_device else "host loader"
        raise ValueError(
            f"zero train steps per epoch: dataset ({len(train_dataset)} rows, {where}) "
            f"is smaller than the batch ({bs} rows a rank, {world} rank(s))"
        )
    feed = _HostFeed(dev)
    c_train = _aug_channels(cfg.in_channels, use_transplant)
    c_val = _aug_channels(cfg.in_channels, False)
    h, w = train_dataset.H, train_dataset.W
    global_step = start_epoch * steps_per_epoch
    last_val_loss = float("nan")
    loss_history: list = []  # per-epoch mean train loss
    epoch_losses: list = []
    prof = None
    profile_done = False
    profile_stop = 0
    steps_this_run = 0

    def stop_profile():
        nonlocal prof, profile_done
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        os.makedirs(cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(cfg.profile_dir, f"{run_id}.step{profile_stop}.pt.trace.json"))
        prof, profile_done = None, True

    def maybe_profile(after_step: bool):
        """Starts the trace before this run's second step (the first warms
        up; resume-safe) and stops it ``profile_steps`` steps later."""
        nonlocal prof, profile_stop
        if cfg.profile_dir and rank == 0 and prof is None and not profile_done and steps_this_run >= 1:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.start()
            profile_stop = steps_this_run + cfg.profile_steps
        if prof is not None and after_step and steps_this_run >= profile_stop:
            stop_profile()

    for epoch in range(start_epoch, cfg.n_epochs):
        epoch_losses = []
        n_images = 0
        t0 = time.time()
        if cfg.data_on_device:
            r = cfg.device_data_refresh_epochs
            if (
                r
                and cfg.device_data_rows
                and cfg.device_data_rows < len(train_dataset)
                and (epoch // r) * r != dd_sub_window
            ):
                # re-draw the resident subset: free the old split FIRST so the
                # peak device memory stays one split, then decode + upload
                dd_train = None
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                dd_sub_window = (epoch // r) * r
                dd_cur_sub = _dd_subset_for(epoch)
                dd_train = _device_dataset(
                    train_dataset, cfg, dev, use_transplant, subset=dd_cur_sub, rank=rank, world=world
                )
                # hand the decode temporaries' pages back to the OS (glibc
                # keeps freed arenas: host memory creeps with each refresh)
                try:
                    import ctypes

                    ctypes.CDLL("libc.so.6").malloc_trim(0)
                except OSError:  # not glibc
                    pass
                try:
                    with open("/proc/self/status") as f:
                        rss = next(ln for ln in f if ln.startswith("VmRSS")).split()[1]
                    print(f"[refresh epoch {epoch}, rank {rank}] host RSS {int(rss) >> 20} GB", flush=True)
                except (OSError, StopIteration):
                    pass
            n_local = dd_train[4]
            d_w = dd_train[2] if cfg.use_example_weights else None
            # this rank's order over its shard (the JAX trainer's shard ``rank``)
            rng = np.random.default_rng((cfg.random_seed, epoch, rank))
            if sample_w is not None:
                probs = sample_w[_device_local_rows(world, n_local, len(train_dataset), dd_cur_sub)[rank]]
                perm = rng.choice(n_local, size=n_local, replace=True, p=probs / probs.sum())
            else:
                perm = rng.permutation(n_local)
            idx_ep = torch.from_numpy(perm[: steps_per_epoch * bs].reshape(steps_per_epoch, bs).astype(np.int64))
            if cfg.device_data_epoch_scan and not cfg.profile_dir:
                # the whole epoch in one call: the same draws and order as per step
                state, losses = dd_epoch_fn(
                    state, dd_train[0], dd_train[1], _to_device(idx_ep, dev), cfg.random_seed, global_step, d_w
                )
                epoch_losses.append(losses)
                n_images += cfg.batch_size * steps_per_epoch
                global_step += steps_per_epoch
                steps_this_run += steps_per_epoch
            else:
                for s in range(steps_per_epoch):
                    maybe_profile(False)
                    gen = step_generator(cfg.random_seed, global_step, dev, rank)
                    state, loss = dd_train_step(
                        state, dd_train[0], dd_train[1], _to_device(idx_ep[s], dev), gen, d_w
                    )
                    epoch_losses.append(loss)
                    n_images += cfg.batch_size
                    global_step += 1
                    steps_this_run += 1
                    maybe_profile(True)
        else:
            for batch in train_loader.epoch(epoch):
                maybe_profile(False)
                b = len(batch["pixel_coordinates"])
                images = feed.put(
                    "images", (b, c_train, h, w),
                    lambda out: _prepare_aug_batch(batch, cfg.in_channels, use_transplant, out=out),
                )
                coords = feed.put("coords", batch["pixel_coordinates"].shape,
                                  lambda out: np.copyto(out, batch["pixel_coordinates"]))
                weights = None
                if cfg.use_example_weights:
                    weights = feed.put("weight", (b,), lambda out: np.copyto(out, batch["weight"]))
                gen = step_generator(cfg.random_seed, global_step, dev, rank)
                state, loss = train_step(state, images, coords, gen, weights=weights)
                epoch_losses.append(loss)
                n_images += b * world
                global_step += 1
                steps_this_run += 1
                maybe_profile(True)
        # the per-step losses (scalars, or the epoch call's (steps,)) in one
        # read-back, which waits for the epoch's last step
        epoch_losses = torch.cat([x.reshape(-1) for x in epoch_losses]).tolist() if epoch_losses else []
        if run is not None:
            for loss_val in epoch_losses:
                run.log({"loss": loss_val})
        if cfg.ema_decay > 0:
            snap = {"params": state.params, "batch_stats": state.batch_stats}
            ema = _ema_apply(ema if ema is not None else snap, snap, cfg.ema_decay)
        epoch_time = time.time() - t0
        throughput = n_images / max(epoch_time, 1e-9)
        if epoch_losses:
            loss_history.append(float(np.mean(epoch_losses)))
        if run is not None:
            if epoch % cfg.print_epochs == 0:
                print(
                    f"[epoch {epoch}] avg loss {np.mean(epoch_losses):.5f} ({epoch_time:.1f}s, {throughput:,.0f} img/s)",
                    flush=True,
                )
            run.log({"epoch_time_s": epoch_time, "train_images_per_sec": throughput})

        if epoch % cfg.val_epochs == 0:
            sums = []  # (loss sum, count) per batch, on the device
            if cfg.data_on_device:
                v_imgs, v_crds, _, v_valid, v_n = dd_val
                for idx, mask in eval_index_batches(v_n, bs):
                    sums.append(dd_eval_step(state, v_imgs, v_crds, idx, mask * v_valid[idx]))
            else:
                for i, batch in enumerate(val_loader.epoch(0)):
                    b = len(batch["pixel_coordinates"])
                    images = feed.put(
                        "val_images", (b, c_val, h, w),
                        lambda out: _prepare_aug_batch(batch, cfg.in_channels, False, out=out),
                    )
                    coords = feed.put("val_coords", batch["pixel_coordinates"].shape,
                                      lambda out: np.copyto(out, batch["pixel_coordinates"]))
                    # the sharded loader wrap-pads the last global batch: its
                    # repeated rows weigh 0, so every row counts once
                    first = i * bs * world + rank * bs
                    real = torch.from_numpy((first + np.arange(b) < len(val_dataset)).astype(np.float32))
                    sums.append(eval_step(state, images, coords, _to_device(real, dev)))
            pairs = torch.stack([torch.stack(p) for p in sums]).tolist() if sums else []
            loss_sum = sum(p[0] for p in pairs)
            count = sum(p[1] for p in pairs)
            last_val_loss = loss_sum / count if count else float("nan")
            if run is not None:
                run.log({"val_loss": last_val_loss, "lr": scheduler.lr})
                print(f"[epoch {epoch}] val loss {last_val_loss:.5f} (lr {scheduler.lr:.2e})", flush=True)
            state = state._replace(opt_state=set_learning_rate(state.opt_state, scheduler.step(last_val_loss)))

        if epoch % cfg.save_epochs == 0:
            to_save = {
                "params": state.params,
                "batch_stats": state.batch_stats,
                "opt_state": state.opt_state,
                "epoch": epoch,
                "lr": scheduler.lr,
                "sched_best": scheduler.best,
                "sched_num_bad": scheduler.num_bad,
            }
            if ema is not None:
                to_save["ema_params"] = ema["params"]
                to_save["ema_batch_stats"] = ema["batch_stats"]
            if rank == 0:
                ckpt.save_train_state(os.path.join(ROOT, "outputs", "models", run_id), to_save)
            if world > 1:
                dist.barrier()  # no rank runs ahead of the checkpoint (a later resume reads it)

    if prof is not None:  # a run shorter than profile_steps: flush the trace anyway
        stop_profile()
    if run is not None:
        run.finish()
    return {
        "run_id": run_id,
        "final_train_loss": float(np.mean(epoch_losses)) if epoch_losses else float("nan"),
        "train_loss_history": loss_history,
        "final_val_loss": last_val_loss,
        "state": state,
        "ema": ema,
    }


def main() -> None:
    """``python -m perseus_tpu_torch.train.train [--flags]``: :func:`train`
    of the ``TrainConfig`` the flags give (``configs/cli.py``), on the card.
    Data parallel: ``torchrun --nproc-per-node <cards> -m
    perseus_tpu_torch.train.train --distributed ...`` (a rank per card), or
    one process per rank with ``--coordinator-address host:port
    --num-processes W --process-id r``."""
    from perseus_tpu_torch.configs.cli import cli

    try:
        train(cli(TrainConfig))
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
