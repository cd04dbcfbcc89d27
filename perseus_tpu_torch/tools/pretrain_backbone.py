"""Self-supervised backbone pretraining, the 4-way rotation pretext task:
the port of ``scripts/pretrain_backbone.py``.

The backbone learns which of {0, 90, 180, 270} degrees each row of a batch
was rotated by (Gidaris et al., ICLR 2018) over the rendered corpus; the
keypoint run then starts from it through ``TrainConfig.init_backbone``
(which skips the 4-logit head, or raises on it with ``init_head``).

A pool of rows, drawn once with ``default_rng(seed).choice(n, max_rows,
replace=False)``, is kept on the card in ``data_dtype``. Each step gathers
its rows, rotates quarter k of the batch by k * 90 degrees
(:func:`rot_batch`), shuffles the batch (so that BN does not see
label-sorted quarters), runs ``keypoint_cnn_apply(train=True)`` with a
4-logit head (``n_keypoints=2``) in bf16 convs, softmax cross-entropy on
the integer labels, then the global-norm clip + AdamW of
``train.ClipAdamW``; the stem maxpool's forward and gradient are the CUDA
kernels of ``models/pool.py``. Epoch orders come from
``default_rng(seed).permutation(n)`` as in the JAX script; the in-batch
shuffle from a generator keyed on (seed, global step). Writes
``<output_dir>/final`` (``save_train_state``: params, batch stats, AdamW
state, epoch, lr 0) and ``<output_dir>/metrics.json`` (rot_acc, epochs,
n_rows).

    python -m perseus_tpu_torch.tools.pretrain_backbone \\
        --dataset-path outputs/scale_run3/data_full/decoded --epochs 30 --output-dir outputs/models/pretrain_rot
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.models import resnet
from perseus_tpu_torch.train import checkpoint as ckpt
from perseus_tpu_torch.train import train as tm

__all__ = [
    "PretrainConfig",
    "draw_rows",
    "load_rows",
    "rot_batch",
    "init_pretrain_state",
    "make_pretrain_step",
    "pretrain",
    "main",
]


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    dataset_path: str = "outputs/scale_run3/data_full/pruned/pruned.hdf5"
    output_dir: str = "outputs/models/pretrain_rot"
    epochs: int = 30
    batch_size: int = 256
    learning_rate: float = 1e-3
    weight_decay: float = 1e-2
    in_channels: int = 4
    # cap of the device-resident row pool (rows drawn uniformly once): the
    # rotation pretext saturates long before it needs every frame; 8k rows
    # of bf16 RGBD at 256x256 take 4.2 GB
    max_rows: int = 8000
    data_dtype: str = "bfloat16"
    seed: int = 0


def draw_rows(n_dataset: int, max_rows: int, seed: int) -> np.ndarray:
    """The pool's dataset rows: ``default_rng(seed).choice`` without
    replacement, the JAX script's draw."""
    return np.random.default_rng(seed).choice(n_dataset, min(n_dataset, max_rows), replace=False)


def load_rows(ds: PrunedKeypointDataset, rows: np.ndarray, in_channels: int, dtype: torch.dtype,
              device: torch.device, chunk: int = 512) -> torch.Tensor:
    """Rows ``rows`` of ``ds`` as one (N, C, H, W) tensor on ``device`` in
    ``dtype``: RGB (and depth with ``in_channels`` >= 4), decoded and
    uploaded ``chunk`` rows at a time into a buffer allocated first."""
    c = 3 + (in_channels >= 4)
    out = torch.empty((len(rows), c, ds.H, ds.W), dtype=dtype, device=device)
    for s in range(0, len(rows), chunk):
        batch = ds.batch(rows[s : s + chunk])
        out[s : s + chunk].copy_(torch.from_numpy(tm._prepare_aug_batch(batch, in_channels, False)))
    return out


def rot_batch(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quarter k of an NCHW batch rotated by k * 90 degrees (``torch.rot90``
    over (H, W), the direction of ``jnp.rot90`` over NHWC's (1, 2)), with
    int64 labels k; a remainder of ``B % 4`` rows is dropped, as in JAX."""
    q = img.shape[0] // 4
    parts = [torch.rot90(img[k * q : (k + 1) * q], k, dims=(2, 3)) for k in range(4)]
    labels = torch.arange(4, device=img.device).repeat_interleave(q)
    return torch.cat(parts), labels


def init_pretrain_state(cfg: PretrainConfig, optimizer: tm.ClipAdamW, device) -> tm.TrainState:
    """A random ResNet-18 with a 4-logit head (``n_keypoints=2``) drawn from
    ``cfg.seed``, and a fresh AdamW state, on ``device``."""
    model = resnet.KeypointCNN(2, cfg.in_channels, device="cpu", generator=torch.Generator().manual_seed(cfg.seed))
    sd = {k: v.detach().to(device) for k, v in model.state_dict().items()}
    params = {k: v for k, v in sd.items() if not tm._is_stat(k)}
    stats = {k: v for k, v in sd.items() if tm._is_stat(k)}
    return tm.TrainState(params, stats, optimizer.init(params))


def make_pretrain_step(optimizer: tm.ClipAdamW, compute_dtype: torch.dtype = torch.bfloat16):
    """``step(state, images, idx, gen=None, perm=None) -> (state, loss,
    acc)``: rows ``idx`` of the pool ``images`` (N, C, H, W), as f32,
    rotated by :func:`rot_batch` and shuffled by ``perm`` (a permutation of
    the rotated batch; else drawn from ``gen``), the model in train mode
    with convs in ``compute_dtype``, softmax cross-entropy and the rotation
    accuracy, then clip + AdamW. ``loss`` and ``acc`` stay on the device."""

    def step(state: tm.TrainState, images: torch.Tensor, idx, gen=None, perm=None):
        img = images.index_select(0, torch.as_tensor(idx, device=images.device).long()).float()
        img, labels = rot_batch(img)
        if perm is None:
            perm = torch.randperm(img.shape[0], generator=gen, device=gen.device)
        perm = torch.as_tensor(perm, device=img.device).long()
        img, labels = img[perm], labels[perm]
        keys = list(state.params)
        params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
        with torch.enable_grad(), resnet._full_f32():
            logits, new_stats = resnet.keypoint_cnn_apply(
                {**params, **state.batch_stats}, img, train=True, compute_dtype=compute_dtype
            )
            loss = F.cross_entropy(logits, labels)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
        acc = torch.mean((torch.argmax(logits.detach(), dim=-1) == labels).float())
        new_params, new_opt = optimizer.update(dict(zip(keys, grads)), state.opt_state, state.params)
        return tm.TrainState(new_params, new_stats, new_opt), loss.detach(), acc

    return step


def pretrain(cfg: PretrainConfig, device: str | torch.device | None = "cuda",
             compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Runs the pretext task on ``device`` and writes its checkpoint and
    metrics. Returns {"state", "rot_acc", "loss" (the last epoch's means),
    "epochs", "n_rows", "steps_per_epoch", "epoch_s" (wall per epoch)}."""
    dev = resolve_device(device)
    ds = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=cfg.dataset_path), train=True)
    rows = draw_rows(len(ds), cfg.max_rows, cfg.seed)
    n = len(rows)
    steps_per_epoch = n // cfg.batch_size
    if steps_per_epoch == 0:
        raise ValueError(f"{n} rows are fewer than one batch of {cfg.batch_size}")
    images = load_rows(ds, rows, cfg.in_channels, getattr(torch, cfg.data_dtype), dev)
    print(f"[pretrain] {n} rows resident ({images.numel() * images.element_size() / 1e9:.1f} GB)", flush=True)

    optimizer = tm.ClipAdamW(1.0, cfg.learning_rate, cfg.weight_decay)
    state = init_pretrain_state(cfg, optimizer, dev)
    step = make_pretrain_step(optimizer, compute_dtype)
    rng = np.random.default_rng(cfg.seed)
    t0 = time.time()
    loss_v = acc_v = float("nan")
    epoch_s = []
    for epoch in range(cfg.epochs):
        t_epoch = time.time()
        order = rng.permutation(n)
        losses, accs = [], []
        for s in range(steps_per_epoch):
            idx = torch.from_numpy(order[s * cfg.batch_size : (s + 1) * cfg.batch_size])
            gen = tm.step_generator(cfg.seed, epoch * steps_per_epoch + s, dev)
            state, loss, acc = step(state, images, idx, gen)
            losses.append(loss)
            accs.append(acc)
        loss_v, acc_v = torch.stack([torch.stack(losses).mean(), torch.stack(accs).mean()]).tolist()
        epoch_s.append(time.time() - t_epoch)
        print(f"[pretrain epoch {epoch}] loss {loss_v:.4f} rot-acc {acc_v:.3f} ({time.time() - t0:.0f}s)",
              flush=True)

    os.makedirs(cfg.output_dir, exist_ok=True)
    ckpt.save_train_state(os.path.join(cfg.output_dir, "final"), {
        "params": state.params, "batch_stats": state.batch_stats, "opt_state": state.opt_state,
        "epoch": cfg.epochs - 1, "lr": 0.0,
    })
    with open(os.path.join(cfg.output_dir, "metrics.json"), "w") as f:
        json.dump({"rot_acc": acc_v, "epochs": cfg.epochs, "n_rows": n}, f)
    print(f"[pretrain] saved -> {cfg.output_dir}/final (rot-acc {acc_v:.3f})", flush=True)
    return {"state": state, "rot_acc": acc_v, "loss": loss_v, "epochs": cfg.epochs, "n_rows": n,
            "steps_per_epoch": steps_per_epoch, "epoch_s": epoch_s}


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    pretrain(cli(PretrainConfig))


if __name__ == "__main__":
    main()
