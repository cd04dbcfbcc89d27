"""Training configuration: the JAX package's ``TrainConfig``, every field
with the same default, so a config (or a command line) moves between the two
packages unchanged; ``KeypointDatasetConfig`` is
:mod:`perseus_tpu_torch.data.dataset`'s.

``train/train.py::train`` reads every field but these, which the port takes
and does not read: ``multigpu`` (a process drives one card; data
parallelism is one process per rank, brought up from ``distributed``,
``coordinator_address``, ``num_processes`` and ``process_id``),
``rng_impl`` (the port's per-step generators are
``step_generator(random_seed, step, rank)``) and
``dataset_config.native_decode`` / ``decode_threads`` / ``lazy``. The
comments below are the JAX package's, and name its hardware where it had
one, except the data-parallel fields', which say what the port does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from perseus_tpu_torch.augment.pipeline import AugmentationConfig
from perseus_tpu_torch.data.dataset import KeypointDatasetConfig

__all__ = ["KeypointDatasetConfig", "TrainConfig"]


@dataclass(frozen=True)
class TrainConfig:
    """Configuration for training."""

    # The global batch size (sharded over the data-parallel mesh axis).
    batch_size: int = 256

    # The (initial) learning rate set in the optimizer.
    learning_rate: float = 1e-3

    # The number of epochs to train for.
    n_epochs: int = 100

    # Training schedule.
    val_epochs: int = 1
    print_epochs: int = 1
    save_epochs: int = 5

    # Dataset parameters.
    dataset_config: KeypointDatasetConfig = field(default_factory=KeypointDatasetConfig)

    # Data augmentation parameters.
    augmentation_config: AugmentationConfig = field(default_factory=AugmentationConfig)

    # Model parameters.
    n_keypoints: int = 8
    in_channels: int = 4  # 3 for RGB, 4 for RGBD

    # Regression head: "avgpool" is the reference KeypointCNN head
    # (AdaptiveAvgPool -> fc, models.py:31-32); "spatial" reads the
    # flattened final feature map instead (models/resnet.py:init_keypoint_cnn
    # docstring) — global pooling discards WHERE features fire, which for
    # coordinate regression is precision lost by construction.
    head: str = "avgpool"
    # Input resolution the spatial head is built for (feature map = /32).
    input_resolution: int = 256

    # Whether to shard the batch over all local devices (the TPU equivalent
    # of the reference's multigpu DDP switch).
    multigpu: bool = True

    # bf16 conv compute with f32 params (the reference's amp, without a
    # GradScaler: bf16 has f32's exponent range).
    amp: bool = True

    # Run the stem as the equivalent 4x4 stride-1 conv over space-to-depth(2)
    # input (models/resnet.py::space_to_depth_stem_kernel) in the TRAIN and
    # VAL steps. Numerically equivalent reparametrization; checkpoints are
    # unchanged (the 7x7 kernel stays the stored parameter).
    s2d_stem: bool = False

    # Random seed.
    random_seed: int = 42

    # Wandb-style project for metric logging.
    wandb_project: str = "perseus-detector"

    # Optional checkpoint to initialize from: an orbax run dir or a
    # reference-format .pth (the reference fine-tunes pretrained torchvision
    # weights; models.py:20 — supply them via this converter path).
    init_checkpoint: str = ""

    # Initialize only the BACKBONE (everything but the fc head) from this
    # checkpoint; the head re-initializes for the keypoint task. This is how
    # a proxy-pretrained backbone (scripts/pretrain_backbone.py — the
    # fine-tune-from-pretrained recipe of the reference, models.py:20,
    # measured without torchvision weights in the image) feeds fine-tuning.
    init_backbone: str = ""

    # With init_backbone: ALSO copy the fc head when its shapes match —
    # a full warm start (params + BN stats, fresh optimizer/LR/epoch) for
    # continued training of the SAME architecture on a grown corpus. Unlike
    # --resume this does not restore the finished run's floored LR or epoch
    # counter, so the plateau schedule re-anneals on the new data.
    init_head: bool = False

    # Resume a previous run exactly (params, optimizer state, epoch, LR
    # schedule) from its orbax checkpoint dir. The reference has no resume
    # path (SURVEY.md section 5); here restart-from-checkpoint is the
    # failure-recovery story.
    resume: str = ""

    # When set, write a jax.profiler trace of a few steady-state steps to
    # this directory (viewable in TensorBoard / xprof).
    profile_dir: str = ""
    profile_steps: int = 5

    # Cache decoded images in host RAM (skips per-epoch PNG/TIFF decode).
    cache_dataset: bool = False

    # PRNG implementation for the training/augmentation key stream.
    # "rbg" uses the TPU's hardware random-bit generator — several times
    # cheaper than threefry for the per-pixel augmentation fields, which are
    # a measurable slice of the step. Deterministic for a fixed key on a
    # fixed backend (jax documents possible draw changes across
    # backends/jaxlib versions — acceptable for augmentation). Set
    # "threefry2x32" for jax's default portable stream.
    rng_impl: str = "rbg"

    # Keep the ENTIRE decoded dataset resident in device HBM, sharded over
    # the data mesh axis, and gather each batch on-device (shard-local
    # permutations). Removes the per-step host->device image upload — the
    # TPU-native answer to the reference's pin_memory/num_workers loader
    # tuning (reference: train.py:236-247), and the difference between
    # being PCIe/DCN-bound and MXU-bound when the dataset fits in HBM.
    data_on_device: bool = False

    # Storage dtype for the device-resident dataset. "bfloat16" halves HBM
    # and upload cost (a ~9k-frame 256x256 split drops 12 GB -> 6 GB); the
    # augmentation kernel computes in f32 regardless, and the depth
    # channel's bf16 quantization (~2 mm at cube scale) is below the 5 mm
    # depth-noise augmentation. RGB/seg are unaffected ([0,1] values).
    device_data_dtype: str = "float32"

    # Cap the device-resident TRAIN split at this many rows (0 = all rows).
    # When the decoded dataset exceeds HBM, a uniformly-drawn subset lives
    # on-device instead and — with device_data_refresh_epochs > 0 — is
    # re-drawn from the full dataset every that-many epochs, so training
    # still sees the entire dataset over time at device-resident step cost
    # (host decode + upload amortized over many epochs).
    device_data_rows: int = 0
    device_data_refresh_epochs: int = 0

    # Run each device-resident epoch as ONE jitted lax.scan over its steps
    # (single dispatch + single loss readback per epoch) instead of one
    # dispatch per step. Identical math and PRNG stream; disabled
    # automatically when profile_dir is set (the profiler wants per-step
    # dispatch boundaries).
    device_data_epoch_scan: bool = True

    # LR plateau schedule (reference: train.py:200).
    plateau_patience: int = 5
    plateau_factor: float = 0.25
    min_learning_rate: float = 1e-6

    # Gradient clipping max-norm (reference: train.py:302).
    grad_clip_norm: float = 1.0

    # AdamW decoupled weight decay. torch.optim.AdamW's default is 1e-2
    # (the reference uses it implicitly, train.py:199); optax's default is
    # 1e-4, so this is passed explicitly to keep the recipes equivalent.
    weight_decay: float = 1e-2

    # Data-parallel wiring — the role of the reference's TCP rendezvous /
    # torch.distributed init (reference: train.py:122-152). train() calls
    # ``maybe_initialize_distributed`` before touching any card: with
    # ``coordinator_address`` set (host:port), ``init_process_group`` meets
    # at ``tcp://coordinator_address`` with ``num_processes`` ranks, this
    # one ``process_id``; with bare ``distributed=True`` it reads torchrun's
    # environment (``env://``). Each rank then loads its shard of every
    # global batch, batch norm takes the global batch's statistics, and the
    # gradients are all-reduced (NCCL between cards, gloo on the CPU).
    distributed: bool = False
    coordinator_address: str = ""
    num_processes: int = -1
    process_id: int = -1

    # Per-example loss weighting by the dataset's inverse-frequency
    # ``weights`` column (computed by data/merge.py). The reference computes
    # and stores these weights but never consumes them
    # (data/merge_hdf5.py:175-190 — a known dead feature); enabling this
    # actually applies them as per-example multipliers on the SmoothL1 loss.
    use_example_weights: bool = False

    # Targeted oversampling of the measured failure regimes (round-3 val
    # breakdown: seg-ratio 0.2-0.4 at 24.0 px RMSE, frames with out-of-frame
    # corners at 21.8 px vs 14.2 in-frame). Each epoch's indices are drawn
    # with replacement with per-row probability proportional to
    # 1 + oversample_close * [seg_ratio > close_seg_threshold]
    #   + oversample_outframe * [any GT corner outside the frame].
    # 0.0 disables (uniform permutation, the reference's sampler semantics).
    # Sampling reweights which frames gradient descent SEES; unlike loss
    # weighting it leaves per-example gradient scale untouched.
    oversample_close: float = 0.0
    close_seg_threshold: float = 0.2
    oversample_outframe: float = 0.0

    # Measured-difficulty oversampling: a .npy of per-TRAIN-row weights
    # produced by scripts/compute_difficulty_weights.py (per-frame keypoint
    # error of a previous checkpoint, normalized to mean 1). Round-3 val
    # analysis: the worst 5% of frames carry ~80% of the squared error and
    # are CENTROID COLLAPSE (the head hedges corners toward the cube center
    # when orientation evidence is weak) — a regime seg-ratio buckets don't
    # isolate, but a first-pass model's own errors do. Multiplies with the
    # regime terms above when both are set.
    sample_weights_path: str = ""

    # Out-of-frame corner loss handling, evaluated on POST-augmentation
    # targets (round-3 breakdown: any-corner-out frames at 21.8 px RMSE vs
    # 14.2 in-frame; the reference regresses invisible corners blindly,
    # reference train.py:119). outframe_corner_weight scales the Huber loss
    # of coords whose target lies outside the image (1.0 = reference
    # parity; 0.0 masks them entirely); outframe_clamp_px >= 0 clamps
    # training targets to [-m, size-1+m] so the head never chases a corner
    # hundreds of px off-screen (negative disables). Both renormalize /
    # leave eval untouched — val RMSE still scores true corners.
    outframe_corner_weight: float = 1.0
    outframe_clamp_px: float = -1.0

    # Anti-hedging auxiliary loss. The measured catastrophic-tail failure is
    # centroid collapse: under orientation uncertainty the Huber-optimal
    # prediction shrinks every corner toward the centroid (pred/GT spread
    # ratio 0.36 on bad frames vs 1.00 on good). This term penalizes the
    # spread deficit directly — Huber on (per-corner distance from the
    # predicted centroid) vs the same for GT, in normalized coords — which
    # the plain coordinate loss under-weights by construction. 0 disables
    # (reference parity, reference train.py:119 is coordinate Huber only).
    spread_loss_weight: float = 0.0

    # Exponential moving average of params/batch_stats, updated once per
    # EPOCH (Polyak averaging at the epoch scale: decay^k windows the last
    # ~1/(1-decay) epochs). 0 disables. The EMA snapshot rides along in the
    # checkpoint under "ema_params"/"ema_batch_stats"; validation and the LR
    # schedule keep using the raw params (the EMA is an eval-time artifact).
    ema_decay: float = 0.0
    # Cap on the mean-normalized example weight. The inverse-bin-frequency
    # weights are unbounded (a singleton seg-ratio bin gets weight 1.0 vs a
    # ~5e-4 median — ~600x the batch mean after normalization), and training
    # with them uncapped collapses the detector to predicting the keypoint
    # centroid: the handful of extreme-occlusion frames that land in rare
    # bins dominate every batch they appear in (measured round 3: val loss
    # stuck at 0.057 weighted vs 0.007 unweighted, same data/LR). A 10x cap
    # keeps the mild rebalancing without letting outliers run the gradient.
    example_weight_clip: float = 10.0
