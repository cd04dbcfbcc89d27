"""A rank of tests/test_torch_distributed.py: one process of a two-rank gloo
group on the CPU, which runs the port's data-parallel step and train() and
saves what it saw for the test process to compare.

    python tests/torch_dp_worker.py <rank> <world> <port> <work dir> tcp|env

``env``: torchrun's variables and bare ``distributed=True``; a rendezvous,
an all-reduce and the host loader's shards. ``tcp``: the config's
coordinator address (``<work dir>/spec.pt`` holds the configs and the
batch); then also three train steps per loss option from
:func:`start_state`, a refused batch size and train() on both data paths.
Rank 0 saves full states, rank 1 their digests (the replicas' equality).
Imports torch, numpy and the port only.
"""

import dataclasses
import hashlib
import os
import sys

import numpy as np
import torch

from perseus_tpu_torch.train import train
from perseus_tpu_torch.train.config import TrainConfig

START_STEP = 10  # AdamW's count in start_state: moments well away from zero


def start_state(cfg: TrainConfig) -> train.TrainState:
    """The seeded initial params and batch stats with AdamW moments drawn
    from a numpy seed (mu ~ N(0, 1e-3), nu ~ U(1e-6, 1e-4), count 10): a
    state from which a rounding-level gradient cannot flip an update's
    sign, which AdamW's first step from zero moments does."""
    opt = train.make_optimizer(cfg)
    state = train.init_state(cfg, opt, "cpu")
    rng = np.random.default_rng(11)
    draw = lambda f: {k: torch.from_numpy(f(v.shape).astype(np.float32)) for k, v in state.params.items()}  # noqa: E731
    mu = draw(lambda s: rng.normal(0.0, 1e-3, s))
    nu = draw(lambda s: rng.uniform(1e-6, 1e-4, s))
    return state._replace(opt_state=dataclasses.replace(state.opt_state, step=START_STEP, exp_avg=mu, exp_avg_sq=nu))


def digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].numpy().tobytes())
    return h.hexdigest()


def _keep(rank: int, tensors: dict):
    """Rank 0 keeps the tensors, rank 1 their digest."""
    return dict(tensors) if rank == 0 else digest(tensors)


class _Rows:
    """A 12-row dataset whose rows are their indices."""

    def __len__(self):
        return 12

    def batch(self, indices):
        return {"idx": np.asarray(indices)}


def main() -> None:
    rank, world, port, work, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    import torch.distributed as dist

    from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
    from perseus_tpu_torch.data.dataset import PrefetchingLoader
    from perseus_tpu_torch.train import checkpoint as ckpt
    from perseus_tpu_torch.utils import logging as ptlog

    torch.set_num_threads(1)
    out = {}
    if init == "env":
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=str(rank), WORLD_SIZE=str(world))
        base = TrainConfig(distributed=True)
    else:
        spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
        base = dataclasses.replace(spec["loop_cfg"], coordinator_address=f"localhost:{port}",
                                   num_processes=world, process_id=rank)
    dev = train.maybe_initialize_distributed(base, "cpu")
    assert train.maybe_initialize_distributed(base, "cpu") == dev  # re-entrant
    out["group"] = (dist.get_rank(), dist.get_world_size(), dist.get_backend(), str(dev))
    total = torch.full((3,), float(rank + 1))
    dist.all_reduce(total)
    out["all_reduce"] = total.tolist()
    loader = PrefetchingLoader(_Rows(), batch_size=2, shuffle=True, seed=0, shard_index=rank, num_shards=world)
    out["shard"] = np.concatenate([b["idx"] for b in loader.epoch(0)]).tolist()

    if init == "tcp":
        # three steps from start_state per loss option, on this rank's rows
        b = spec["images"].shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
        out["steps"] = {}
        for case, cfg in spec["step_cfgs"].items():
            step = train.make_train_step(cfg, train.make_optimizer(cfg), KeypointAugmentation(cfg.augmentation_config))
            w = spec["weights"][case]
            state, losses = start_state(cfg), []
            for _ in range(3):
                state, loss = step(state, spec["images"][rows], spec["coords"][case][rows], torch.Generator(),
                                   weights=None if w is None else w[rows])
                losses.append(loss.item())
            out["steps"][case] = dict(losses=losses, state=_keep(rank, {**state.params, **state.batch_stats}))

        try:
            train.train(dataclasses.replace(base, batch_size=7), device="cpu")
        except ValueError as exc:
            out["refused"] = str(exc)

        # train() on both data paths: what it logs and saves, and its first
        # step's batch and loss
        calls, first = {}, {}
        real_init, real_save, real_make = ptlog.init, ckpt.save_train_state, train.make_train_step

        def counting(kind, fn):
            def wrapped(*a, **kw):
                calls[kind] += 1
                return fn(*a, **kw)
            return wrapped

        def make_recording(*a, **kw):
            step = real_make(*a, **kw)

            def recorded(state, images_aug, coords, *rest, **kw2):
                new, loss = step(state, images_aug, coords, *rest, **kw2)
                first.setdefault("images", images_aug.clone())
                first.setdefault("coords", coords.clone())
                first.setdefault("loss", loss.item())
                return new, loss
            return recorded

        ptlog.init, ckpt.save_train_state = counting("init", real_init), counting("save", real_save)
        train.make_train_step = make_recording
        out["train"] = {}
        for mode in ("loader", "dd"):
            first.clear()
            calls.update(init=0, save=0)
            res = train.train(dataclasses.replace(base, data_on_device=mode == "dd"), device="cpu")
            st = res["state"]
            out["train"][mode] = dict(
                run_id=res["run_id"], history=res["train_loss_history"], final=res["final_train_loss"],
                val=res["final_val_loss"], first=dict(first), calls=dict(calls),
                state=_keep(rank, {**st.params, **st.batch_stats}),
            )
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    print(f"OK {rank}", flush=True)


if __name__ == "__main__":
    main()
