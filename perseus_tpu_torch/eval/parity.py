"""Training-recipe parity: the port's ResNet-18 against a stock PyTorch one.

Port of ``perseus_tpu/eval/parity.py``, with the port's model in place of
the JAX one. One loop trains

  * the port's model: ``keypoint_cnn_apply(train=True)`` in f32, whose stem
    maxpool and its gradient are the CUDA kernels of ``models/pool.py``,
    mean Huber (delta 1) and ``ClipAdamW`` (optax's global-norm clip +
    AdamW), and
  * the oracle of ``eval/torch_oracle.py``: stock PyTorch modules (cuDNN
    convolutions, ``nn.MaxPool2d``), ``torch.optim.AdamW`` and
    ``clip_grad_norm_``,

from the SAME initial weights (the oracle's, drawn on the CPU from
``cfg.seed``; the port's model loads them through ``normalize_reference_sd``),
on the SAME batches in the SAME order, with the SAME recipe. With
``augmented`` each batch goes once through the unfused train-mode
augmentation (whose two-pass warp is a CUDA kernel on the card) and the
same augmented tensors feed both models. Then it compares the pixel RMSE on
the val split and round-trips the port's trained weights into a fresh
oracle (``to_reference_sd``) to compare logits.

Everything computes in f32: inside :func:`run_parity` TF32 is off for
cuDNN convolutions and matmuls (PyTorch's default lets cuDNN use it), and
the previous settings come back on exit.

Run: python -m perseus_tpu_torch.eval.parity --dataset-path <pruned.hdf5 or decoded split>
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.eval.torch_oracle import TorchKeypointCNN
from perseus_tpu_torch.models import convert, resnet
from perseus_tpu_torch.train.train import ClipAdamW, smooth_l1_loss

__all__ = ["ParityConfig", "run_parity", "port_train_step", "oracle_train_step", "main"]


@dataclass(frozen=True)
class ParityConfig:
    """The JAX package's fields and defaults. ``dataset_path``: a pruned
    HDF5 or a decoded split directory."""

    dataset_path: str = "data/pruned_dataset/pruned.hdf5"
    in_channels: int = 4
    n_keypoints: int = 8
    batch_size: int = 32
    epochs: int = 15
    learning_rate: float = 1e-3
    weight_decay: float = 1e-2
    grad_clip_norm: float = 1.0
    seed: int = 0
    output_json: str = ""  # optional path for the result artifact
    # train both models on the SAME augmented tensors: one train-mode draw
    # of the unfused pipeline per batch
    augmented: bool = False


def _assemble(batch: dict, in_channels: int) -> np.ndarray:
    parts = [batch["image"]]
    if in_channels >= 4:
        parts.append(batch["depth_image"][..., None])
    return np.concatenate(parts, axis=-1, dtype=np.float32)


def _normalize_coords(coords: np.ndarray, h: int, w: int) -> np.ndarray:
    out = coords.astype(np.float32).copy()
    out[..., 0] = out[..., 0] / (w - 1) * 2 - 1
    out[..., 1] = out[..., 1] / (h - 1) * 2 - 1
    return out.reshape(coords.shape[0], -1)


def _px_rmse(pred: np.ndarray, target: np.ndarray, h: int, w: int) -> float:
    dp = (pred - target).reshape(pred.shape[0], -1, 2)
    dp = dp * np.array([(w - 1) / 2.0, (h - 1) / 2.0], np.float32)
    return float(np.sqrt(np.mean(np.sum(dp**2, axis=-1))))


def _oracle(cfg: ParityConfig) -> TorchKeypointCNN:
    """The oracle built on the CPU, its init drawn from ``cfg.seed`` (the
    global RNG's state outside is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        return TorchKeypointCNN(n_keypoints=cfg.n_keypoints, num_channels=cfg.in_channels)


def port_train_step(optimizer: ClipAdamW, params: dict, stats: dict, opt_state, xb: torch.Tensor, yb: torch.Tensor):
    """One step of the port's model on NCHW ``xb`` and (B, 2K) targets
    ``yb``: the train-mode forward in f32, mean Huber (delta 1), gradients,
    clip + AdamW. Returns (params, stats, opt_state, loss)."""
    keys = list(params)
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        pred, new_stats = resnet.keypoint_cnn_apply({**p, **stats}, xb, train=True, compute_dtype=torch.float32)
        loss = smooth_l1_loss(pred, yb)
        grads = torch.autograd.grad(loss, [p[k] for k in keys])
    new_params, opt_state = optimizer.update(dict(zip(keys, grads)), opt_state, params)
    return new_params, new_stats, opt_state, loss.detach()


def oracle_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, xb: torch.Tensor, yb: torch.Tensor,
                      grad_clip_norm: float) -> torch.Tensor:
    """One step of the oracle: SmoothL1 (beta 1), backward,
    ``clip_grad_norm_``, ``torch.optim.AdamW``. Returns the loss."""
    opt.zero_grad()
    loss = torch.nn.SmoothL1Loss(beta=1.0)(model(xb), yb)
    loss.backward()
    torch.nn.utils.clip_grad_norm_(model.parameters(), grad_clip_norm)
    opt.step()
    return loss.detach()


def _aug_generator(seed: int, epoch: int, step: int, device: torch.device) -> torch.Generator:
    """The augmentation's generator of (seed, epoch, step)."""
    state = int(np.random.SeedSequence([seed, epoch, step]).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(state)


def run_parity(cfg: ParityConfig, device: str | torch.device | None = "cuda") -> dict:
    """Trains both models on ``device`` and returns the JAX package's
    result dict, with ``jax_val_rmse_px`` renamed ``port_val_rmse_px``:
    {torch_val_rmse_px, port_val_rmse_px, rmse_ratio (port / oracle),
    roundtrip_logits_max_abs_diff, final_losses (oracle, port) of the last
    step, augmented, epochs, n_train, n_val}."""
    dev = resolve_device(device)
    with resnet._full_f32():
        return _run_parity(cfg, dev)


def _run_parity(cfg: ParityConfig, dev: torch.device) -> dict:
    ds_cfg = KeypointDatasetConfig(dataset_path=cfg.dataset_path)
    train_ds = PrunedKeypointDataset(ds_cfg, train=True, cache=True)
    val_ds = PrunedKeypointDataset(ds_cfg, train=False, cache=True)
    h, w = train_ds.H, train_ds.W
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    train_batch = train_ds.batch(np.arange(len(train_ds)))
    val_batch = val_ds.batch(np.arange(len(val_ds)))
    c_train = np.asarray(train_batch["pixel_coordinates"], np.float32)
    c_val = np.asarray(val_batch["pixel_coordinates"], np.float32)
    # NHWC on the device; the oracle takes the NCHW view of it (channels-last
    # strides), as the JAX package's oracle takes its numpy transpose
    x_train, x_val = on(_assemble(train_batch, cfg.in_channels)), on(_assemble(val_batch, cfg.in_channels))
    y_train, y_val = on(_normalize_coords(c_train, h, w)), _normalize_coords(c_val, h, w)

    augment = None
    if cfg.augmented:
        augment = KeypointAugmentation(AugmentationConfig(), train=True, fused=False)
        x_train5 = on(np.concatenate(
            [train_batch["image"], train_batch["depth_image"][..., None], train_batch["segmentation_image"][..., None]],
            axis=-1, dtype=np.float32,
        ))
        c_train_dev = on(c_train)
    del train_batch, val_batch

    # ---- identical initialization ----
    oracle = _oracle(cfg).to(dev)
    sd = {k: v.to(dev) for k, v in convert.normalize_reference_sd(oracle.state_dict()).items()}
    params = {k: v.clone() for k, v in sd.items() if not k.endswith(("running_mean", "running_var"))}
    stats = {k: v.clone() for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}

    # ---- matched optimizers ----
    oracle_opt = torch.optim.AdamW(oracle.parameters(), lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
    optimizer = ClipAdamW(cfg.grad_clip_norm, cfg.learning_rate, cfg.weight_decay)
    opt_state = optimizer.init(params)

    # ---- one loop drives both trainings on the same batches ----
    rng = np.random.default_rng(cfg.seed)
    n = len(x_train)
    history = []
    for epoch in range(cfg.epochs):
        order = rng.permutation(n)
        for s in range(n // cfg.batch_size):
            idx = torch.from_numpy(order[s * cfg.batch_size : (s + 1) * cfg.batch_size]).to(dev)
            if augment is not None:
                # one augmentation draw feeds BOTH models identically
                gen = _aug_generator(cfg.seed, epoch, s, dev)
                x5 = x_train5[idx].permute(0, 3, 1, 2).contiguous()
                with torch.no_grad():
                    images, coords = augment(gen, x5, c_train_dev[idx])
                xb_oracle = images[:, : cfg.in_channels]
                yb = coords.reshape(len(idx), -1)
            else:
                xb_oracle = x_train[idx].permute(0, 3, 1, 2)
                yb = y_train[idx]
            o_loss = oracle_train_step(oracle, oracle_opt, xb_oracle, yb, cfg.grad_clip_norm)
            params, stats, opt_state, p_loss = port_train_step(
                optimizer, params, stats, opt_state, xb_oracle.contiguous(), yb
            )
        history.append((float(o_loss), float(p_loss)))
        print(f"[parity epoch {epoch}] torch {history[-1][0]:.5f}  port {history[-1][1]:.5f}")

    # ---- val RMSE in pixels ----
    oracle.eval()
    x_val_nchw = x_val.permute(0, 3, 1, 2)
    with torch.no_grad():
        rmse_t = _px_rmse(oracle(x_val_nchw).cpu().numpy(), y_val, h, w)
        pred, _ = resnet.keypoint_cnn_apply({**params, **stats}, x_val_nchw.contiguous(), train=False)
        rmse_p = _px_rmse(pred.cpu().numpy(), y_val, h, w)

    # ---- round trip: the port's trained weights -> a fresh oracle -> equal logits ----
    rt_model = _oracle(cfg)
    rt_model.load_state_dict(convert.to_reference_sd({**params, **stats}))
    rt_model.to(dev).eval()
    xb = x_val_nchw[:8]
    with torch.no_grad():
        rt_logits = rt_model(xb)
        port_logits, _ = resnet.keypoint_cnn_apply({**params, **stats}, xb.contiguous(), train=False)
    roundtrip_max_abs = float((rt_logits - port_logits).abs().max())

    result = {
        "torch_val_rmse_px": rmse_t,
        "port_val_rmse_px": rmse_p,
        "rmse_ratio": rmse_p / max(rmse_t, 1e-9),
        "roundtrip_logits_max_abs_diff": roundtrip_max_abs,
        "final_losses": history[-1],
        "augmented": cfg.augmented,
        "epochs": cfg.epochs,
        "n_train": int(n),
        "n_val": int(len(x_val)),
    }
    print(json.dumps(result))
    if cfg.output_json:
        os.makedirs(os.path.dirname(cfg.output_json) or ".", exist_ok=True)
        with open(cfg.output_json, "w") as f:
            json.dump(result, f, indent=2)
    return result


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    run_parity(cli(ParityConfig))


if __name__ == "__main__":
    main()
