"""Training traffic: the device-resident split, step by step.

The split (``inputs.train_split``, the configuration's ``n_train`` rows in
its storage dtype) lives on the card; each epoch walks a seeded
permutation of it in whole batches, and each global step ``s`` takes its
batch's rows through ``make_device_data_train_step`` with the generator
``step_generator(seed, s)``: ``train()``'s device-resident path, one step a
call. Set-up builds the step and the state once, runs the first
``checked_steps`` steps through that same call (they are the warm-up and
the steps the check compares), and hands step and state to the window,
which runs on from there and ends in a synchronize.

The check works the first steps out again with the plain reference (f32,
TF32 off), from the same seeded weights, rows and generator seeds:

  loss1_gap   the first step's loss, as a share of the reference's;
  stats_gap   each BN layer's batch variance of the first step, as the
              program's running variance holds it ((v1 - (1 - m) v0) / m),
              the worst layer's gap as a share of the reference's norm;
  grad_gap    the first clipped gradient, as AdamW's first moment holds it
              (m1 = (1 - b1) g), by the median parameter tensor: the gap
              between the program's norm and the reference's, over the
              larger of that tensor's reference norm and the median's;
  update_gap  each tensor's change over the checked steps, the same
              measure by the worst tensor, leaving out tensors whose
              reference gradient is under a thousandth of the median
              tensor's (moved by round-off alone).

Why these and not every step's loss and the worst tensor's gradient:
``PERF.md`` (the readings they were chosen from).

Parameters: ``checked_steps``, ``traced_steps``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.reference import train as ref_train


class Driver:
    """The resident split's train steps: ``setup`` (with the checked steps),
    the measured ``window``, ``traced`` steps, ``free`` and ``check``."""

    def __init__(self, cell: dict, config: dict, seed: int, device: torch.device):
        self.cell, self.config, self.seed, self.device = cell, config, seed, device
        self.p = cell["params"]
        self.batch = config["batch_size"]
        self.res = config["input_resolution"]
        self.rows = config["n_train"]
        self.control = None

    def _train_config(self):
        from perseus_tpu_torch.augment.pipeline import AugmentationConfig
        from perseus_tpu_torch.train.config import TrainConfig

        c = self.config
        aug = {k: tuple(v) if isinstance(v, list) else v for k, v in c["augmentation"].items()}
        return TrainConfig(
            batch_size=self.batch, learning_rate=c["learning_rate"], in_channels=c["in_channels"],
            n_keypoints=c["n_keypoints"], input_resolution=self.res, amp=c["compute_dtype"] == "bfloat16",
            grad_clip_norm=c["grad_clip_norm"], weight_decay=c["weight_decay"], head=c["head"],
            augmentation_config=AugmentationConfig(**aug), data_on_device=True, device_data_dtype=c["storage_dtype"],
        )

    def setup(self) -> None:
        from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
        from perseus_tpu_torch.train import train as tm

        c = self.config
        t0 = time.perf_counter()
        self.cfg = self._train_config()
        self.sd = inputs.resnet18_weights(self.seed, c["in_channels"], c["n_keypoints"], self.device, random_bn=False)
        self.images, self.coords = inputs.train_split(
            self.seed, self.rows, self.res, self.res, c["n_keypoints"], self.device, getattr(torch, c["storage_dtype"])
        )
        harness.synchronize(self.device)
        t1 = time.perf_counter()
        self.optimizer = tm.make_optimizer(self.cfg)
        self.aug = KeypointAugmentation(self.cfg.augmentation_config, train=True)
        self.state = tm.init_state(self.cfg, self.optimizer, self.device, state_dict=self.sd)
        self.step_fn = tm.make_device_data_train_step(self.cfg, self.optimizer, self.aug)
        self.step_generator = tm.step_generator
        self.global_step, self.epoch, self.order = 0, 0, inputs.epoch_order(self.seed, 0, self.rows, self.batch)
        params0 = {k: v.clone() for k, v in self.state.params.items()}
        losses, after = [], {}
        for s in range(self.p["checked_steps"]):
            losses.append(self.run_step())
            after[s + 1] = self.state
        harness.synchronize(self.device)
        harness.log(f"set-up: weights and split {t1 - t0:.3f} s, state and checked steps {time.perf_counter() - t1:.3f} s")
        first, m = after[1], c["bn_momentum"]
        self.first = {
            "losses": [float(x) for x in losses], "params0": params0,
            # the clipped gradient of step 1 from AdamW's first moment: m1 = (1 - b1) g
            "grad1": {k: v / float(np.float32(1) - np.float32(0.9)) for k, v in first.opt_state.exp_avg.items()},
            "params_n": dict(self.state.params),
            # step 1's batch variances from the running variances it stored
            "stats1": {
                k[: -len(".running_var")]: (v - (1 - m) * self.sd[k]) / m
                for k, v in first.batch_stats.items() if k.endswith(".running_var")
            },
        }

    def run_step(self):
        """One global step through the program's step call; returns its loss."""
        steps = len(self.order)
        if self.global_step // steps != self.epoch:
            self.epoch = self.global_step // steps
            self.order = inputs.epoch_order(self.seed, self.epoch, self.rows, self.batch)
        idx = torch.from_numpy(self.order[self.global_step % steps])
        gen = self.step_generator(self.seed, self.global_step, self.device)
        self.state, loss = self.step_fn(self.state, self.images, self.coords, idx, gen)
        self.global_step += 1
        return loss

    def window(self, seconds: float, max_units: int | None = None) -> dict:
        """Steps for ``seconds`` (or ``max_units`` steps), ended by a
        synchronize: the images trained (and the steps, ``units``) over the
        window's wall."""
        losses = []
        harness.synchronize(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and (max_units is None or len(losses) < max_units):
            losses.append(self.run_step())
        harness.synchronize(self.device)
        wall = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
        return {"attempted": len(losses), "failed": failed, "units": len(losses), "window_s": wall,
                "train_img_s": len(losses) * self.batch / wall}

    def traced(self) -> int:
        for _ in range(self.p["traced_steps"]):
            self.run_step()
        return self.p["traced_steps"]

    def free(self) -> None:
        """Drops the split and the state; keeps the checked steps' rows."""
        rows = [self.order_rows(s) for s in range(self.p["checked_steps"])]
        self.checked_rows = [(self.images.index_select(0, r), self.coords.index_select(0, r)) for r in rows]
        self.images = self.coords = self.state = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def order_rows(self, step: int) -> torch.Tensor:
        steps = self.rows // self.batch
        order = inputs.epoch_order(self.seed, step // steps, self.rows, self.batch)
        return torch.from_numpy(order[step % steps]).to(self.device)

    def reference_steps(self, quantize: bool = False, half_batch: bool = False) -> dict:
        """The checked steps by the plain reference: the same record as
        ``self.first``."""
        c = self.config
        cfg = {k: c[k] for k in ("grad_clip_norm", "weight_decay", "learning_rate", "in_channels")}
        state = ref_train.init({k: v for k, v in self.sd.items() if not k.endswith(("running_mean", "running_var"))})
        params0 = state["params"]
        losses, grad1, stats1 = [], None, None
        for s, (images, coords) in enumerate(self.checked_rows):
            state, loss, clipped, stats = ref_train.step(
                state, images, coords, self.seed, s, cfg, c["augmentation"], quantize, half_batch
            )
            losses.append(float(loss))
            grad1, stats1 = (clipped, stats) if grad1 is None else (grad1, stats1)
        return {"losses": losses, "params0": params0, "grad1": grad1, "params_n": state["params"], "stats1": stats1}

    def use_control(self, fault: str = "fp8") -> None:
        """Put the reference in the program's place: one precision lower
        (``fp8``: float8 convolutions, bf16 stated) or with half of each
        batch left out (``half_batch``)."""
        self.control = fault

    def check(self) -> dict:
        ref = self.reference_steps()
        prog = self.first if self.control is None else self.reference_steps(
            quantize=self.control == "fp8", half_batch=self.control == "half_batch"
        )
        return compare(prog, ref)


def _leaf_gaps(prog: dict, ref: dict, keys) -> list[float]:
    """Per tensor: |norm(prog) - norm(ref)| / max(norm(ref), median norm(ref))."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = float(np.median(list(norms.values())))
    return [abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k]) / max(norms[k], med, 1e-30) for k in keys]


def compare(prog: dict, ref: dict) -> dict:
    """The training cell's readings of a run ``prog`` against ``ref``."""
    keys = list(ref["grad1"])
    gnorm = {k: float(torch.linalg.vector_norm(ref["grad1"][k].double())) for k in keys}
    gmed = float(np.median(list(gnorm.values())))
    moved = [k for k in keys if gnorm[k] >= 1e-3 * gmed]
    delta_p = {k: prog["params_n"][k].double() - prog["params0"][k].double() for k in moved}
    delta_r = {k: ref["params_n"][k].double() - ref["params0"][k].double() for k in moved}
    stats = max(
        float(torch.linalg.vector_norm(prog["stats1"][k].double() - v.double()) / torch.linalg.vector_norm(v.double()))
        for k, v in ref["stats1"].items()
    )
    return {
        "loss1_gap": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
        "stats_gap": stats,
        "grad_gap": float(np.median(_leaf_gaps(prog["grad1"], ref["grad1"], keys))),
        "update_gap": max(_leaf_gaps(delta_p, delta_r, moved)),
    }
