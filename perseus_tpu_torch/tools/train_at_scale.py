"""At-scale accuracy run: the port of ``scripts/train_at_scale.py``.

label -> merge -> prune the rendered jobs, ``train()`` on the
device-resident split, the val RMSE in pixels of the final state and of
the EMA (the better one is promoted), the failure breakdown, a checkpoint
at ``<output_dir>/final``, the holdout-style and closed-loop pose
evaluations, and ``<output_dir>/metrics.json`` with the JAX script's keys.

Two routes to the pruned split, the same rows:

  * :func:`prepare_dataset`, the JAX script's: the port's ``label_dataset``
    (labels only), ``merge`` and ``prune_dataset`` over job directories,
    into ``<data_root>/pruned/pruned.hdf5`` (needs ``h5py`` and ``PIL``);
  * :func:`prepare_decoded`, the card's: rendered videos in memory (e.g.
    ``tools/generate_dataset.py::render_videos``'s), labelled with the
    labeler's float64 arithmetic (``label_metadata``), split and pruned as
    merge and prune do, written as a decoded split (``data/schema.py``)
    into ``<data_root>/decoded``: numpy alone, no PNG, TIFF or HDF5.

:func:`train_at_scale` is the script's body on a device (``main`` is it on
the card); with ``skip_prepare`` it reuses a pruned HDF5 or a decoded split
already under ``data_root``. As in the JAX script a failure of either
post-train evaluation becomes ``holdout_eval_error`` / ``pose_eval_error``
in ``metrics.json``. In a run with several ranks, rank 0 scores, saves and
writes; the other ranks wait at a barrier.

    python -m perseus_tpu_torch.tools.train_at_scale --job-dir outputs/scale_run/jobs \\
        --epochs 60 --batch-size 256
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.augment.pipeline import KeypointAugmentation
from perseus_tpu_torch.camera import denormalize_pixel_coordinates
from perseus_tpu_torch.data import schema
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig, PrunedKeypointDataset
from perseus_tpu_torch.datagen.label_dataset import LabelConfig, label_metadata
from perseus_tpu_torch.models import resnet
from perseus_tpu_torch.train import checkpoint as ckpt
from perseus_tpu_torch.train import train as tm
from perseus_tpu_torch.train.config import TrainConfig

__all__ = [
    "ScaleRunConfig",
    "pruned_path",
    "decoded_path",
    "prepare_dataset",
    "prepare_decoded",
    "DecodedSplitWriter",
    "prepared_split",
    "holdout_config",
    "val_rmse_px",
    "failure_breakdown",
    "train_config",
    "train_at_scale",
    "main",
]


@dataclasses.dataclass(frozen=True)
class ScaleRunConfig:
    job_dir: str = "outputs/scale_run/jobs"
    data_root: str = "outputs/scale_run/data"
    output_dir: str = "outputs/models/scale_run"
    frames: int = 24
    train_frac: float = 0.85
    epochs: int = 60
    batch_size: int = 256
    learning_rate: float = 1e-3
    seg_lb: float = 0.02
    seg_ub: float = 0.7
    skip_prepare: bool = False  # reuse an existing pruned split under data_root
    # bf16 halves the device-resident dataset (TrainConfig.device_data_dtype)
    data_dtype: str = "bfloat16"
    # datasets beyond device memory: a rotating subset of this many rows
    # device-resident, re-drawn every refresh epochs (0 = whole split)
    device_data_rows: int = 0
    device_data_refresh_epochs: int = 0
    use_example_weights: bool = False
    # accuracy levers (see TrainConfig for their semantics)
    head: str = "avgpool"
    oversample_close: float = 0.0
    oversample_outframe: float = 0.0
    outframe_corner_weight: float = 1.0
    outframe_clamp_px: float = -1.0
    # per-row difficulty weights .npy (tools/compute_difficulty_weights.py)
    sample_weights_path: str = ""
    spread_loss_weight: float = 0.0
    ema_decay: float = 0.0
    # backbone-only init from a pretrained checkpoint (tools/pretrain_backbone.py)
    init_backbone: str = ""
    # with init_backbone: also copy the fc head (TrainConfig.init_head)
    init_head: bool = False
    # LR plateau schedule: patient and gentle (the JAX script's finding)
    plateau_patience: int = 20
    plateau_factor: float = 0.5
    # keep the decoded split in host RAM (TrainConfig.cache_dataset)
    host_cache: bool = False
    resume: str = ""  # checkpoint directory to continue from
    # held-out style videos (datagen style="holdout"), scored after training
    holdout_job_dir: str = ""
    # rendered trajectory for the closed-loop pose metric; empty = skip
    pose_eval_job: str = ""


def pruned_path(cfg: ScaleRunConfig) -> str:
    """The HDF5 route's output: ``<data_root>/pruned/pruned.hdf5``."""
    return os.path.join(cfg.data_root, "pruned", "pruned.hdf5")


def decoded_path(cfg: ScaleRunConfig) -> str:
    """The decoded route's output: ``<data_root>/decoded``."""
    return os.path.join(cfg.data_root, "decoded")


def prepare_dataset(cfg: ScaleRunConfig) -> str:
    """label -> merge -> prune the job directories of ``cfg.job_dir`` into
    ``<data_root>/pruned/pruned.hdf5`` (the JAX script's ``prepare_dataset``;
    ``h5py`` and ``PIL``); with ``skip_prepare``, an existing one is
    returned as it is."""
    from perseus_tpu_torch.data.merge import merge
    from perseus_tpu_torch.data.prune import prune_dataset
    from perseus_tpu_torch.datagen.label_dataset import label_dataset

    pruned = pruned_path(cfg)
    if cfg.skip_prepare and os.path.exists(pruned):
        return pruned
    t0 = time.time()
    # labels only: merge, prune and training read pixels from the rendered files
    raw = label_dataset(LabelConfig(job_dir=cfg.job_dir, frames=cfg.frames, train_frac=cfg.train_frac,
                                    lazy_images=True))
    print(f"[scale] labeled -> {raw} ({time.time() - t0:.0f}s)", flush=True)
    merged = merge([raw], os.path.join(cfg.data_root, "merged"), new_train_frac=cfg.train_frac)
    print(f"[scale] merged -> {merged}", flush=True)
    pruned = prune_dataset(merged, pruned, os.path.join(cfg.data_root, "pruned"), lb=cfg.seg_lb, ub=cfg.seg_ub)
    print(f"[scale] pruned -> {pruned}", flush=True)
    return pruned


def _host(a) -> np.ndarray:
    return np.asarray(torch.as_tensor(a).cpu())


def prepare_decoded(cfg: ScaleRunConfig, videos) -> str:
    """The rows :func:`prepare_dataset` would write, as a decoded split at
    ``<data_root>/decoded``, from rendered videos in memory: ``videos``
    yields (job_id, rgb (T, H, W, 3) in [0, 1], depth (T, H, W), seg (T, H,
    W), metadata), tensors or arrays (:class:`DecodedSplitWriter`). Reads
    and writes no PNG, TIFF or HDF5, so it needs neither ``h5py`` nor
    ``PIL``. With ``skip_prepare`` an existing decoded split is returned as
    it is; an existing directory otherwise raises, as merge does."""
    out_dir = decoded_path(cfg)
    if cfg.skip_prepare and schema.is_decoded_split(out_dir):
        return out_dir
    writer = DecodedSplitWriter(cfg)
    for video in videos:
        writer.add(*video)
    return writer.write()


class DecodedSplitWriter:
    """:func:`prepare_decoded` one video at a time (``add``), then
    ``write``: a renderer can hand each video over as it finishes.

    The same arithmetic as the HDF5 route: the labeler's float64
    projection (``label_metadata``), trajectories in job-id order split at
    ``int(train_frac * n)`` (label_dataset; merge keeps that split), each
    frame's segmentation ratio ``mean(seg == asset + 1)`` of the uint8
    segmentation and the inverse-bin-frequency weights over each split's
    ratios (merge), the frames with ratio in ``[seg_lb, seg_ub]`` kept in
    order, with prune's file names (prune), and the pixels quantized as the
    PNG stores them (``schema.rgb_to_u8``). Frames outside the bounds are
    dropped as each video arrives, so the host holds the kept frames only,
    compactly (RGB uint8, depth f32, the cube's mask)."""

    def __init__(self, cfg: ScaleRunConfig):
        self.cfg = cfg
        self.out_dir = decoded_path(cfg)
        if os.path.exists(self.out_dir):
            raise ValueError(f"Directory {self.out_dir} already exists; remove it or pick a new one.")
        self.lcfg = LabelConfig(job_dir=cfg.job_dir, frames=cfg.frames, train_frac=cfg.train_frac, lazy_images=True)
        self.trajs: list[dict] = []
        self.t0 = time.time()

    def add(self, job_id: str, rgb, depth, seg, metadata: dict) -> None:
        cfg = self.cfg
        try:
            lab = label_metadata(self.lcfg, metadata, job_id)
        except Exception as exc:  # tolerate per-job failures, as label_dataset
            print(f"Failed to label job {job_id}: {exc}")
            return
        t = len(lab["image_filenames"])
        seg_u8 = _host(seg)[:t].astype(np.uint8)  # what the segmentation PNG holds
        masks = seg_u8 == lab["asset_ids"][:, None, None] + 1
        ratios = [float(np.mean(m)) for m in masks]
        keep = [i for i, r in enumerate(ratios) if cfg.seg_lb <= r <= cfg.seg_ub]
        rgb_h, depth_h = _host(rgb), _host(depth)
        self.trajs.append({
            "job_id": job_id, "label": lab, "ratios": ratios, "keep": keep,
            "image_u8": np.stack([schema.rgb_to_u8(rgb_h[i]) for i in keep]) if keep else None,
            "depth_image": np.stack([np.asarray(depth_h[i], np.float32) for i in keep]) if keep else None,
            "seg_b": masks[keep],
        })

    def write(self) -> str:
        """Writes both splits and ``attrs.json`` (last); returns the directory."""
        cfg, out_dir = self.cfg, self.out_dir
        if not self.trajs:
            raise RuntimeError("no jobs labeled")
        trajs = sorted(self.trajs, key=lambda tr: tr["job_id"])  # label_dataset's order
        h = w = int(trajs[0]["label"]["H"])
        split_idx = int(cfg.train_frac * len(trajs))
        for name, chunk in (("train", trajs[:split_idx]), ("test", trajs[split_idx:])):
            weights = schema.compute_weights(np.asarray([r for tr in chunk for r in tr["ratios"]], np.float64))
            rows = {k: [] for k in schema.PRUNED_DATASET_KEYS}
            flat = 0
            for tr in chunk:
                lab, keep = tr["label"], set(tr["keep"])
                for i, r in enumerate(tr["ratios"]):
                    if i in keep:
                        n = len(rows["pixel_coordinates"])
                        for key, fname in (("image_filenames", f"rgba_{n:08d}.png"),
                                           ("depth_filenames", f"depth_{n:08d}.tiff"),
                                           ("segmentation_filenames", f"segmentation_{n:08d}.png")):
                            rows[key].append(os.path.join("pruned", name, fname))
                        rows["pixel_coordinates"].append(lab["pixel_coordinates"][i])
                        rows["asset_ids"].append(lab["asset_ids"][i])
                        rows["segmentation_ratios"].append(r)
                        rows["weights"].append(weights[flat])
                    flat += 1
            split = schema.split_from_rows(rows)
            arrays = schema.open_decoded_arrays(out_dir, name, len(split), h, w)
            filled = [tr for tr in chunk if tr["keep"]]
            for key in schema.IMAGE_KEYS:
                if filled:
                    arrays[key][:] = np.concatenate([tr[key] for tr in filled])
                arrays[key].flush()
            schema.write_decoded_split(out_dir, name, split)
            print(f"[scale] decoded {name}: {len(split)} of {flat} frames kept", flush=True)
        schema.write_decoded_attrs(out_dir, {
            "num_keypoints": self.lcfg.num_keypoints, "train_frac": cfg.train_frac, "H": h, "W": w,
            "seg_ratio_lb": cfg.seg_lb, "seg_ratio_ub": cfg.seg_ub,
        })
        print(f"[scale] decoded -> {out_dir} ({time.time() - self.t0:.0f}s)", flush=True)
        return out_dir


def _existing_split(cfg: ScaleRunConfig) -> str | None:
    """With ``skip_prepare``, the pruned HDF5 under ``data_root`` or, where
    there is none, its decoded split; else None."""
    if cfg.skip_prepare:
        for path in (pruned_path(cfg), decoded_path(cfg)):
            if os.path.exists(path):
                return path
    return None


def prepared_split(cfg: ScaleRunConfig) -> str:
    """The split a run trains on: :func:`_existing_split`, otherwise
    :func:`prepare_dataset`."""
    return _existing_split(cfg) or prepare_dataset(cfg)


def holdout_config(cfg: ScaleRunConfig) -> ScaleRunConfig:
    """The holdout split's config: its jobs, ``<data_root>/holdout``, train_frac
    0.05 (nearly every frame in the test split)."""
    return dataclasses.replace(cfg, job_dir=cfg.holdout_job_dir, data_root=os.path.join(cfg.data_root, "holdout"),
                               train_frac=0.05)


@torch.no_grad()
def val_rmse_px(state: tm.TrainState, cfg_train: TrainConfig, dd_val, compute_dtype=torch.bfloat16) -> dict:
    """Pixel keypoint error of ``state`` over a device-resident val split
    (``train._device_dataset(..., use_transplant=False)`` of one rank: all
    rows), without re-uploading images: the val-mode augmentation (the
    depth clamp the model was evaluated with in training), the forward in
    ``compute_dtype``, the predictions denormalized to pixels against the
    split's pixel keypoints. Returns {val_rmse_px (the RMSE over rows of
    each row's mean squared corner error), val_median_corner_err_px,
    val_p90_corner_err_px, _per_example_rmse (N,), _per_example_rows (N,)},
    the JAX script's ``val_rmse_px``."""
    v_imgs, v_crds, _, v_valid, v_n = dd_val
    dev = v_imgs.device
    h, w = v_imgs.shape[2], v_imgs.shape[3]
    val_aug = KeypointAugmentation(cfg_train.augmentation_config, train=False)
    sd = {**state.params, **state.batch_stats}
    sums, corner_errs, row_ids = [], [], []
    for idx, mask in tm.eval_index_batches(v_n, cfg_train.batch_size):
        mask = mask * v_valid[idx]
        idx_t = torch.from_numpy(idx).to(dev)
        crds = v_crds.index_select(0, idx_t)
        imgs, _ = val_aug(None, v_imgs.index_select(0, idx_t), crds)
        pred, _ = resnet.keypoint_cnn_apply(sd, imgs[:, : cfg_train.in_channels], train=False,
                                            compute_dtype=compute_dtype)
        pred_px = denormalize_pixel_coordinates(pred.reshape(pred.shape[0], -1, 2), h, w)
        d2 = torch.sum((pred_px - crds) ** 2, dim=-1)  # (B, K)
        m = torch.from_numpy(mask).to(dev)
        sums.append(torch.stack([torch.sum(torch.mean(d2, dim=-1) * m), torch.sum(m)]))
        keep = mask > 0
        corner_errs.append(torch.sqrt(d2)[torch.from_numpy(keep).to(dev)])
        row_ids.append(idx[keep])
    total, count = np.sum(torch.stack(sums).double().cpu().numpy(), axis=0)
    errs = torch.cat(corner_errs).cpu().numpy()  # (N, K) per-corner pixel errors
    per_example = np.sqrt(np.mean(errs**2, axis=-1))
    return {
        "val_rmse_px": float(np.sqrt(total / max(count, 1.0))),
        "val_median_corner_err_px": float(np.median(errs)),
        "val_p90_corner_err_px": float(np.percentile(errs, 90)),
        "_per_example_rmse": per_example,
        "_per_example_rows": np.concatenate(row_ids),
    }


def failure_breakdown(dataset, rmse_stats: dict, h: int, w: int) -> dict:
    """Per-example RMSE bucketed by segmentation ratio (the cube's apparent
    size / occlusion) and by whether every GT corner projects inside the
    frame: {"seg_<lo>_<hi>" | "corners_in_frame" | "corners_out_of_frame":
    {n, rmse_px, median_px}} (the JAX script's, a numpy copy)."""
    per = rmse_stats["_per_example_rmse"]
    rows = rmse_stats["_per_example_rows"]
    seg = np.asarray(dataset.split.segmentation_ratios)[rows]
    coords = np.asarray(dataset.pixel_coordinates)[rows]  # (N, K, 2)
    in_frame = (
        (coords[..., 0] >= 0) & (coords[..., 0] <= w - 1) & (coords[..., 1] >= 0) & (coords[..., 1] <= h - 1)
    ).all(axis=-1)

    def bucket(m):
        return {"n": int(m.sum()), "rmse_px": float(np.sqrt(np.mean(per[m] ** 2))),
                "median_px": float(np.median(per[m]))}

    out = {}
    edges = [0.02, 0.05, 0.1, 0.2, 0.4, 0.7]
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (seg >= lo) & (seg < hi)
        if m.any():
            out[f"seg_{lo:g}_{hi:g}"] = bucket(m)
    for name, m in (("corners_in_frame", in_frame), ("corners_out_of_frame", ~in_frame)):
        if m.any():
            out[name] = bucket(m)
    return out


def train_config(cfg: ScaleRunConfig, dataset_path: str, input_resolution: int) -> TrainConfig:
    """The script's ``TrainConfig``, field by field (the JAX script's)."""
    return TrainConfig(
        input_resolution=input_resolution,
        batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate,
        n_epochs=cfg.epochs,
        dataset_config=KeypointDatasetConfig(dataset_path=dataset_path),
        data_on_device=True,
        device_data_dtype=cfg.data_dtype,
        device_data_rows=cfg.device_data_rows,
        device_data_refresh_epochs=cfg.device_data_refresh_epochs,
        use_example_weights=cfg.use_example_weights,
        head=cfg.head,
        oversample_close=cfg.oversample_close,
        oversample_outframe=cfg.oversample_outframe,
        outframe_corner_weight=cfg.outframe_corner_weight,
        outframe_clamp_px=cfg.outframe_clamp_px,
        sample_weights_path=cfg.sample_weights_path,
        spread_loss_weight=cfg.spread_loss_weight,
        ema_decay=cfg.ema_decay,
        init_backbone=cfg.init_backbone,
        init_head=cfg.init_head,
        plateau_patience=cfg.plateau_patience,
        plateau_factor=cfg.plateau_factor,
        resume=cfg.resume,
        save_epochs=max(1, cfg.epochs // 8),
        wandb_project="",
        cache_dataset=cfg.host_cache,
    )


def _free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def train_at_scale(cfg: ScaleRunConfig, device: str | torch.device | None = "cuda", pose_job=None) -> dict:
    """The script's body on ``device``: the split (:func:`prepared_split`),
    ``train()``, the val RMSE of the final state and of the EMA (the better
    promoted), the failure breakdown, the checkpoint
    ``<output_dir>/final``, the holdout-style evaluation (``holdout_job_dir``
    a directory of jobs, its split prepared into ``<data_root>/holdout`` with
    train_frac 0.05, or, with ``skip_prepare``, a split already prepared
    there, e.g. by the decoded route, where there are no job directories)
    and the pose evaluation (window 12) of ``pose_eval_job`` or, when given,
    of ``pose_job`` = (frames (T, H, W, 4), metadata) in memory; writes
    ``<output_dir>/metrics.json``. Returns {"metrics", "run_id" (train()'s
    run, whose checkpoints lie under outputs/models), "state"}; metrics is
    None on ranks other than 0."""
    dev = resolve_device(device)
    dataset_path = prepared_split(cfg)
    # the spatial head's fc fan-in depends on the resolution: take it from the data
    res_probe = PrunedKeypointDataset(KeypointDatasetConfig(dataset_path=dataset_path), train=True, cache=False)
    tcfg = train_config(cfg, dataset_path, int(res_probe.H))
    del res_probe
    t0 = time.time()
    result = tm.train(tcfg, device=dev)
    train_s = time.time() - t0
    state = result["state"]
    rank, world = tm._rank_world()
    metrics = None
    if rank == 0:
        metrics, state = _score_and_save(cfg, tcfg, result, state, train_s, dev, pose_job)
    if world > 1:
        dist.barrier()  # the other ranks wait for rank 0's evaluations and files
    return {"metrics": metrics, "run_id": result["run_id"], "state": state}


def _score_and_save(cfg, tcfg, result, state, train_s, dev, pose_job):
    """Rank 0's part of :func:`train_at_scale`: (metrics, the promoted state)."""
    val_ds = PrunedKeypointDataset(tcfg.dataset_config, train=False, cache=False)
    train_ds = PrunedKeypointDataset(tcfg.dataset_config, train=True, cache=False)
    dd_val = tm._device_dataset(val_ds, tcfg, dev, use_transplant=False)
    rmse_stats = val_rmse_px(state, tcfg, dd_val)
    ema_rmse = None
    if result.get("ema") is not None:
        # score the Polyak average; promote it to "the model" if it wins
        ema_state = state._replace(params=result["ema"]["params"], batch_stats=result["ema"]["batch_stats"])
        ema_stats = val_rmse_px(ema_state, tcfg, dd_val)
        ema_rmse = ema_stats["val_rmse_px"]
        if ema_rmse < rmse_stats["val_rmse_px"]:
            state = ema_state
            rmse_stats, ema_rmse = ema_stats, rmse_stats["val_rmse_px"]
    breakdown = failure_breakdown(val_ds, rmse_stats, val_ds.H, val_ds.W)
    rmse_stats = {k: v for k, v in rmse_stats.items() if not k.startswith("_")}
    if ema_rmse is not None:
        rmse_stats["other_variant_rmse_px"] = float(ema_rmse)
    del dd_val  # free the device before the holdout upload
    _free(dev)

    os.makedirs(cfg.output_dir, exist_ok=True)
    ckpt.save_train_state(os.path.join(cfg.output_dir, "final"), {
        "params": state.params, "batch_stats": state.batch_stats, "opt_state": state.opt_state,
        "epoch": cfg.epochs - 1, "lr": 0.0,
    })
    if "corners_in_frame" in breakdown:
        # the in-frame RMSE is the detector-quality headline; the raw one
        # mixes in extrapolation to corners far outside the image
        rmse_stats["val_rmse_in_frame_px"] = breakdown["corners_in_frame"]["rmse_px"]
        n_in = breakdown["corners_in_frame"]["n"]
        n_out = breakdown.get("corners_out_of_frame", {}).get("n", 0)
        # split health: the share of val frames with a GT corner out of frame
        rmse_stats["val_oof_frame_rate"] = n_out / max(n_in + n_out, 1)
    metrics = {
        **rmse_stats,
        "val_loss": result["final_val_loss"],
        "train_loss": result["final_train_loss"],
        "epochs": cfg.epochs,
        "n_train": len(train_ds),
        "n_val": len(val_ds),
        "train_wall_s": round(train_s, 1),
        "image_hw": [train_ds.H, train_ds.W],
        "failure_breakdown": breakdown,
    }

    # the checkpoint is on disk: a failure in either evaluation must not
    # void the run's record, so it becomes an error note in metrics.json
    ho_cfg = holdout_config(cfg)
    if cfg.holdout_job_dir and (os.path.isdir(cfg.holdout_job_dir) or _existing_split(ho_cfg)):
        try:
            ho_tcfg = dataclasses.replace(tcfg, dataset_config=KeypointDatasetConfig(
                dataset_path=prepared_split(ho_cfg)))
            ho_ds = PrunedKeypointDataset(ho_tcfg.dataset_config, train=False, cache=False)
            dd_ho = tm._device_dataset(ho_ds, ho_tcfg, dev, use_transplant=False)
            ho_stats = val_rmse_px(state, ho_tcfg, dd_ho)
            del dd_ho
            _free(dev)
            metrics["holdout_style_rmse_px"] = ho_stats["val_rmse_px"]
            metrics["holdout_style_median_corner_err_px"] = ho_stats["val_median_corner_err_px"]
            metrics["holdout_style_n_frames"] = len(ho_ds)
        except Exception as e:  # noqa: BLE001
            metrics["holdout_eval_error"] = repr(e)

    if pose_job is not None or (cfg.pose_eval_job and os.path.isdir(cfg.pose_eval_job)):
        try:
            from perseus_tpu_torch.eval import pose_eval

            sd = {**state.params, **state.batch_stats}
            if pose_job is not None:
                pose = pose_eval.score_pose_tracking(*pose_job, state_dict=sd, window=12, device=dev)
            else:
                pose = pose_eval.evaluate_pose_tracking(cfg.pose_eval_job, state_dict=sd, window=12, device=dev)
            for k in ("pose_rmse_mm", "pose_rmse_deg", "pose_median_mm", "pose_median_deg"):
                metrics[k] = pose[k]
        except Exception as e:  # noqa: BLE001
            metrics["pose_eval_error"] = repr(e)

    with open(os.path.join(cfg.output_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics), flush=True)
    return metrics, state


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    train_at_scale(cli(ScaleRunConfig))


if __name__ == "__main__":
    main()
