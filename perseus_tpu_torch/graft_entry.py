"""Entry points: the flagship forward with an example batch, and a
data-parallel dry run of the full train step.

The counterpart of the repository's root ``__graft_entry__.py``:

  * :func:`entry` returns ``(forward, (example,))``: the keypoint ResNet-18
    on 4 channels in folded-BN bf16 inference form, and an (8, 4, 256, 256)
    batch of ``uniform(0, 1)`` from ``default_rng(0)`` (the JAX example,
    NCHW); the output is (8, 16);
  * :func:`dryrun_multichip` runs ``n_devices`` ranks, one process each,
    over ``torch.distributed`` (gloo, through ``train.maybe_initialize_distributed``):
    one step of the full train step (every augmentation stage, forward and
    backward, clip + AdamW) on a global batch of ``2 * n_devices`` 32x32
    5-channel rows in f32, then a device-resident epoch over ``4 *
    n_devices`` rows in 2 steps with per-rank permutations from
    ``default_rng((0, rank))``. On the card every rank shares ``cuda:0``
    (gloo carries CUDA tensors); with ``device="cpu"`` they run on the CPU.

    python -c 'from perseus_tpu_torch import graft_entry as g; f, (x,) = g.entry(); print(f(x).shape)'
    python -c 'from perseus_tpu_torch import graft_entry as g; g.dryrun_multichip(2)'
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from perseus_tpu_torch import ROOT, resolve_device

__all__ = ["entry", "dryrun_multichip"]

DRYRUN_HW = 32
DRYRUN_TIMEOUT_S = 600.0  # a rank group still running then is killed and the dry run fails


def entry(device="cuda", state_dict: dict | None = None):
    """``(forward, (example,))`` on ``device``: ``forward`` is the folded
    bf16 forward of ``state_dict`` (the port's layout, e.g.
    ``convert.from_jax_params`` of JAX weights), by default the random init
    ``KeypointCNN(n_keypoints=8, num_channels=4)`` draws from seed 0 on the
    CPU."""
    import torch

    from perseus_tpu_torch.models import resnet

    dev = resolve_device(device)
    if state_dict is None:
        state_dict = resnet.KeypointCNN(n_keypoints=8, num_channels=4, device="cpu").state_dict()
    folded = resnet.fold_batchnorm({k: v.detach().to(dev, torch.float32) for k, v in state_dict.items()})

    def forward(images):
        return resnet.keypoint_cnn_apply_folded(folded, images, compute_dtype=torch.bfloat16)

    example = np.random.default_rng(0).uniform(0, 1, size=(8, 256, 256, 4)).astype(np.float32)
    return forward, (torch.from_numpy(example).to(dev).permute(0, 3, 1, 2).contiguous(),)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Runs the dry run on ``n_devices`` ranks (module docstring), each a
    process of ``python -m perseus_tpu_torch.graft_entry --dryrun-rank``;
    prints the step's and the epoch's lines and returns the global batch's
    ``loss`` and the epoch's ``losses`` (every rank's, equal) with each
    kernel's ``launches`` summed over the ranks. Raises when a rank fails,
    a loss is not finite, the ranks disagree, or the group outlives
    ``DRYRUN_TIMEOUT_S``."""
    dev = resolve_device(device)
    rank_device = "cuda:0" if dev.type == "cuda" else "cpu"
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="perseus_dryrun_") as work:
        procs, logs = [], []
        try:
            for r in range(n_devices):
                logs.append(open(os.path.join(work, f"rank{r}.log"), "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "perseus_tpu_torch.graft_entry", "--dryrun-rank", str(r),
                     str(n_devices), str(port), rank_device, work],
                    cwd=ROOT, stdout=logs[-1], stderr=subprocess.STDOUT,
                ))
            deadline = time.monotonic() + DRYRUN_TIMEOUT_S
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        if any(p.returncode != 0 for p in procs):
            tails = []
            for r, p in enumerate(procs):
                with open(os.path.join(work, f"rank{r}.log")) as f:
                    tails.append(f"--- rank {r} (exit {p.returncode}):\n" + "".join(f.readlines()[-25:]))
            raise RuntimeError(f"dryrun_multichip({n_devices}): a rank failed or timed out\n" + "\n".join(tails))
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    result = ranks[0]
    if any((r["loss"], r["losses"]) != (result["loss"], result["losses"]) for r in ranks):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks' global losses differ: {ranks}")
    result["launches"] = {k: sum(r["launches"][k] for r in ranks) for k in result["launches"]}
    print(f"dryrun_multichip({n_devices}): ok, loss={result['loss']:.5f}")
    print(f"dryrun_multichip({n_devices}): device-data epoch ok, losses={np.round(result['losses'], 5).tolist()}")
    return result


def _dryrun_rank(rank: int, world: int, port: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`: its block of each global batch,
    the global loss (the same on every rank)."""
    import torch
    import torch.distributed as dist

    from perseus_tpu_torch.augment.pipeline import AugmentationConfig, KeypointAugmentation
    from perseus_tpu_torch.bench import launch_counts
    from perseus_tpu_torch.train import train
    from perseus_tpu_torch.train.config import TrainConfig

    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    cfg = TrainConfig(
        batch_size=2 * world, in_channels=4, amp=False,
        augmentation_config=AugmentationConfig(),  # every augmentation stage
        coordinator_address=f"localhost:{port}", num_processes=world, process_id=rank,
    )
    dev = train.maybe_initialize_distributed(cfg, device=device, backend="gloo")
    try:
        optimizer = train.make_optimizer(cfg)
        state = train.init_state(cfg, optimizer, dev)
        augment = KeypointAugmentation(cfg.augmentation_config, train=True)
        step = train.make_train_step(cfg, optimizer, augment)
        nchw = lambda x: torch.from_numpy(x).to(dev).permute(0, 3, 1, 2).contiguous()  # noqa: E731
        rng = np.random.default_rng(0)
        b, s = cfg.batch_size, DRYRUN_HW
        local = b // world
        mine = slice(rank * local, (rank + 1) * local)
        # 5-channel augmentation input: RGB + depth + segmentation (the transplant path)
        images = rng.uniform(0, 1, size=(b, s, s, 5)).astype(np.float32)
        coords = rng.uniform(0, s - 1, size=(b, 8, 2)).astype(np.float32)
        state, loss = step(state, nchw(images[mine]), torch.from_numpy(coords[mine]).to(dev),
                           train.step_generator(0, 0, dev, rank))
        loss = float(loss)
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss: {loss}")

        # the device-resident epoch: this rank's shard of the split, shard-local permutations
        n_rows = 4 * world  # 2 steps of the global batch
        ds_images = rng.uniform(0, 1, size=(n_rows, s, s, 5)).astype(np.float32)
        ds_coords = rng.uniform(0, s - 1, size=(n_rows, 8, 2)).astype(np.float32)
        n_local = n_rows // world
        shard = slice(rank * n_local, (rank + 1) * n_local)
        steps = n_local // local
        idx_ep = np.random.default_rng((0, rank)).permutation(n_local)[: steps * local].reshape(steps, local)
        epoch_fn = train.make_device_data_epoch_fn(cfg, optimizer, augment)
        state, losses = epoch_fn(state, nchw(ds_images[shard]), torch.from_numpy(ds_coords[shard]).to(dev),
                                 torch.from_numpy(idx_ep).to(dev), 1, 0)
        losses = losses.cpu().tolist()
        if not all(math.isfinite(v) for v in losses):
            raise FloatingPointError(f"non-finite epoch losses: {losses}")
        return {"loss": loss, "losses": losses, "launches": launch_counts()}
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] != ["--dryrun-rank"] or len(sys.argv) != 7:
        sys.exit("usage: python -m perseus_tpu_torch.graft_entry --dryrun-rank <rank> <world> <port> <device> <dir>")
    rank_, world_, port_, device_, work_ = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6]
    out_ = _dryrun_rank(rank_, world_, port_, device_)
    with open(os.path.join(work_, f"rank{rank_}.json"), "w") as f_:
        json.dump(out_, f_)
