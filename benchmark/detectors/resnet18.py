"""The ResNet-18 keypoint regressor as a camera cell's detector.

A detector plug-in is one module here, named by a camera configuration's
``detector`` key (``resnet18`` where the key is absent) and loaded by path
(``run.detector``). It gives the camera traffic, and the readers of
``serve.mfu`` and ``detector.b1_ms``, all that depends on the architecture:

- ``weights(seed, config, device)``: seeded f32 weights on the device, in
  the names the program's ``StreamingPipeline`` takes as ``state_dict``;
- ``HEAD``: the keys of the head's weight (2K, F) and bias (2K,), which the
  traffic calibrates on ``features``;
- ``prepare(sd)``: the reference's own prepared weights, worked out from
  ``sd`` and nothing the program made;
- ``features(prepared, x)``: the (B, F) features the head reads, and
  ``detect(prepared, x, quantize=False)``: (B, 2K) normalized keypoints of
  NCHW model inputs, in f32 with TF32 off, or with ``quantize`` one
  precision below the configuration's (the control);
- ``forward_flops(config)``: the forward's operations on one frame;
- ``streaming_fields(config)``: ``StreamingConfig`` fields beyond those
  every camera cell sets;
- ``program_b1(pipeline, config)``: the program's batch-1 detector call on
  one model input, as the served frame makes it.

This one wraps the seeded weights of ``inputs``, the plain reference of
``reference/detector.py`` and the count of ``counts`` where they stand.
"""

from __future__ import annotations

import torch

from benchmark import counts, inputs
from benchmark.reference import detector as ref_det

HEAD = ("fc.weight", "fc.bias")


def weights(seed: int, config: dict, device) -> dict:
    """torchvision's names, BN statistics drawn so that folding them
    changes every convolution."""
    return inputs.resnet18_weights(seed, config["num_channels"], config["n_keypoints"], device, random_bn=True)


def prepare(sd: dict) -> dict:
    """BN folded into the convolutions, by the reference itself."""
    return ref_det.fold(sd)


features = ref_det.features
detect = ref_det.detect


def forward_flops(config: dict) -> int:
    return counts.resnet18_forward_flops(1, config["num_channels"], config["model_h"], config["model_w"],
                                         2 * config["n_keypoints"])


def streaming_fields(config: dict) -> dict:
    return {}


def program_b1(pipeline, config: dict):
    """``keypoint_cnn_apply_folded`` on the served pipeline's folded
    weights, in the configuration's compute dtype."""
    from perseus_tpu_torch.models import resnet

    folded = pipeline.folded
    dtype = getattr(torch, config["compute_dtype"])
    return lambda image: resnet.keypoint_cnn_apply_folded(folded, image, compute_dtype=dtype)
