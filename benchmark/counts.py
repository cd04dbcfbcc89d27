"""Operation and byte counts from shapes, and the card's published peaks.

The yardstick of every share the benchmark reports: a share of the chip's
peak (``*.mfu``) divides operations counted here by a measured time and by
``PEAK_BF16_FLOPS``; a roofline share divides the least time the bytes
counted here take at ``PEAK_HBM_BYTES_S`` by a measured time. The counts
depend on shapes and dtypes only, never on which code computes them.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12

RESNET18_STAGES = ((2, 64), (2, 128), (2, 256), (2, 512))


def _out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def resnet18_forward_flops(batch: int, channels: int, height: int, width: int, n_outputs: int = 16) -> int:
    """Multiply-adds x 2 of the ResNet-18 keypoint regressor's convolutions
    and its fully connected head, at batch ``batch`` of (channels, height,
    width) images. Bias adds, batch norm, ReLU, pooling and residual adds
    are not counted (a few per cent of a tensor-core step, and not what a
    peak rate measures)."""
    macs = 0

    def conv(c_in, c_out, k, stride, pad, h, w):
        nonlocal macs
        ho, wo = _out(h, k, stride, pad), _out(w, k, stride, pad)
        macs += c_out * c_in * k * k * ho * wo
        return ho, wo

    h, w = conv(channels, 64, 7, 2, 3, height, width)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # stem maxpool
    c_in = 64
    for stage, (blocks, c_out) in enumerate(RESNET18_STAGES):
        for block in range(blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            h2, w2 = conv(c_in, c_out, 3, stride, 1, h, w)
            conv(c_out, c_out, 3, 1, 1, h2, w2)
            if stride != 1 or c_in != c_out:
                conv(c_in, c_out, 1, stride, 0, h, w)
            h, w, c_in = h2, w2, c_out
    macs += c_in * n_outputs
    return 2 * macs * batch


def resnet18_train_flops(batch: int, channels: int, height: int, width: int, n_outputs: int = 16) -> int:
    """A train step's operations: the forward and its backward (grads of
    inputs and of weights), 3 x the forward."""
    return 3 * resnet18_forward_flops(batch, channels, height, width, n_outputs)


def augment_apply_bytes(batch: int, c_in: int, c_model: int, height: int, width: int, storage_bytes: int) -> int:
    """The least bytes the train augmentation's apply moves: each input
    read once (the stored images, ``c_in`` planes; the draws' three bf16
    noise fields and bf16 plasma field; 29 f32 scalars, a donor index and
    six warp parameters per image) and the model input written once
    (``c_model`` planes in the storage dtype)."""
    plane = batch * height * width
    images_in = plane * c_in * storage_bytes
    draws = plane * 3 * 2 + plane * 2 + batch * (29 * 4 + 8 + 6 * 4)
    model_in = plane * c_model * storage_bytes
    return images_in + draws + model_in


def roofline_seconds(flops: float, bytes_moved: float) -> float:
    """The least time: the larger of operations at the bf16 peak and bytes
    at the memory's peak."""
    return max(flops / PEAK_BF16_FLOPS, bytes_moved / PEAK_HBM_BYTES_S)
