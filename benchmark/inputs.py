"""What the benchmark hands to both sides, made from ``--seed``: detector
weights, camera frames and the cube pose they show, and the resident
training split. Nothing here imports the program or the reference: both
take these tensors as they are.

Each kind of input draws from its own stream, ``subseed(seed, tag)``, so
that one seed gives the same weights whatever else a cell draws. Weights
and the split are made on the device by a ``torch.Generator`` there, in a
few large calls; camera frames are host arrays (pageable, as a camera SDK
hands them over), drawn in bulk with numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.counts import RESNET18_STAGES

TAG_WEIGHTS, TAG_FRAMES, TAG_POSE, TAG_HEAD, TAG_SPLIT, TAG_ORDER, TAG_SAMPLE = range(1, 8)

# the cube's corners, +/-1 per axis, in the program's corner order
CORNER_SIGNS = np.array(
    [[-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1], [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1]],
    dtype=np.float64,
)


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed of the stream ``tags`` of run ``seed`` (any whole number
    that numpy's ``SeedSequence`` takes)."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *tags]).generate_state(1, np.uint64)[0]) >> 1


def device_generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(subseed(seed, tag))


def resnet18_shapes(in_channels: int, n_keypoints: int) -> list[tuple[str, tuple]]:
    """(name, shape) of every tensor of the ResNet-18 keypoint regressor, in
    torchvision's names: conv weights OIHW, each BN's weight, bias,
    running_mean and running_var, ``fc.weight`` (2K, 512) and ``fc.bias``."""

    def bn(name, c):
        return [(f"{name}.{k}", (c,)) for k in ("weight", "bias", "running_mean", "running_var")]

    shapes = [("conv1.weight", (64, in_channels, 7, 7))] + bn("bn1", 64)
    c_in = 64
    for stage, (blocks, c_out) in enumerate(RESNET18_STAGES):
        for block in range(blocks):
            p = f"layer{stage + 1}.{block}"
            first = c_in if block == 0 else c_out
            shapes += [(f"{p}.conv1.weight", (c_out, first, 3, 3))] + bn(f"{p}.bn1", c_out)
            shapes += [(f"{p}.conv2.weight", (c_out, c_out, 3, 3))] + bn(f"{p}.bn2", c_out)
            if stage > 0 and block == 0:
                shapes += [(f"{p}.downsample.0.weight", (c_out, first, 1, 1))] + bn(f"{p}.downsample.1", c_out)
        c_in = c_out
    return shapes + [("fc.weight", (2 * n_keypoints, 512)), ("fc.bias", (2 * n_keypoints,))]


def resnet18_weights(seed: int, in_channels: int, n_keypoints: int, device, random_bn: bool) -> dict:
    """Seeded weights on ``device``, f32: convs He-normal by fan-out (one
    ``randn`` for all of them), the head uniform in +-1/sqrt(512) (one
    ``rand``). BN as initialised (weight 1, bias 0, mean 0, var 1), or with
    ``random_bn`` drawn (weight in [0.8, 1.2), bias and mean in +-0.05, var
    in [0.5, 1.5): one ``rand``), so that folding them changes every conv."""
    shapes = resnet18_shapes(in_channels, n_keypoints)
    gen = device_generator(seed, TAG_WEIGHTS, device)
    convs = [(n, s) for n, s in shapes if len(s) == 4]
    bns = [(n, s) for n, s in shapes if len(s) == 1 and not n.startswith("fc.")]
    fcs = [(n, s) for n, s in shapes if n.startswith("fc.")]
    sd = {}
    z = torch.randn(sum(math.prod(s) for _, s in convs), generator=gen, device=device)
    for (name, s), part in zip(convs, torch.split(z, [math.prod(s) for _, s in convs])):
        sd[name] = part.reshape(s) * math.sqrt(2.0 / (s[0] * s[2] * s[3]))
    u = torch.rand(sum(math.prod(s) for _, s in bns), generator=gen, device=device)
    for (name, s), part in zip(bns, torch.split(u, [math.prod(s) for _, s in bns])):
        kind = name.rsplit(".", 1)[1]
        if not random_bn:
            sd[name] = torch.full(s, 1.0 if kind in ("weight", "running_var") else 0.0, device=device)
        elif kind == "weight":
            sd[name] = 0.8 + 0.4 * part
        elif kind == "running_var":
            sd[name] = 0.5 + part
        else:
            sd[name] = 0.1 * (part - 0.5)
    bound = 1.0 / math.sqrt(512)
    u = torch.rand(sum(math.prod(s) for _, s in fcs), generator=gen, device=device)
    for (name, s), part in zip(fcs, torch.split(u, [math.prod(s) for _, s in fcs])):
        sd[name] = ((2.0 * part - 1.0) * bound).reshape(s)
    return sd


def cube_pose(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The pose (rotation (3, 3), translation (3,), metres) of the cube the
    camera sees: a uniform random rotation, 0.26-0.34 m in front of the
    camera and up to 2 cm off its axis."""
    rng = np.random.default_rng(subseed(seed, TAG_POSE))
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    trans = np.array([rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02), rng.uniform(0.26, 0.34)])
    return rot, trans


def project_corners(rot: np.ndarray, trans: np.ndarray, half_side: float, fov: float, h: int, w: int) -> np.ndarray:
    """(8, 2) pixel coordinates (u, v) of the cube's corners under a pinhole
    camera of field of view ``fov`` (f = size / (2 tan(fov / 2)), principal
    point at the image centre)."""
    p = CORNER_SIGNS * half_side @ rot.T + trans
    fx, fy = w / (2.0 * math.tan(fov / 2.0)), h / (2.0 * math.tan(fov / 2.0))
    return np.stack([fx * p[:, 0] / p[:, 2] + w / 2.0, fy * p[:, 1] / p[:, 2] + h / 2.0], axis=-1)


def head_draw(seed: int, n_outputs: int, n_features: int) -> np.ndarray:
    """(n_outputs, n_features) standard normal draws for the calibrated head."""
    return np.random.default_rng(subseed(seed, TAG_HEAD)).standard_normal((n_outputs, n_features))


def camera_frames(seed: int, n: int, h: int, w: int, nan_share: float) -> np.ndarray:
    """(n, h, w, 4) f32 RGBD frames: RGB a + b U with a per-frame offset a in
    [0, 0.3) and gain b in [0.3, 0.7) (so frames differ in more than their
    noise), depth in metres, a per-frame base in [0.15, 0.35) plus U(0, 0.1)
    (inside the serving clamp's 0.1-0.5 m, away from both planes),
    with ``nan_share`` of the depth pixels NaN (holes of a stereo camera)."""
    rng = np.random.default_rng(subseed(seed, TAG_FRAMES))
    frames = rng.random((n, h, w, 4), dtype=np.float32)
    a = rng.uniform(0.0, 0.3, (n, 1, 1, 1)).astype(np.float32)
    b = rng.uniform(0.3, 0.7, (n, 1, 1, 1)).astype(np.float32)
    frames[..., :3] = a + b * frames[..., :3]
    base = rng.uniform(0.15, 0.35, (n, 1, 1)).astype(np.float32)
    frames[..., 3] = base + 0.1 * frames[..., 3]
    holes = rng.random((n, h, w)) < nan_share
    frames[..., 3][holes] = np.nan
    return frames


def train_split(seed: int, n_rows: int, h: int, w: int, n_keypoints: int, device, dtype, chunk: int = 2048):
    """The device-resident split: (n_rows, 5, h, w) images in ``dtype``
    (RGB in [0, 1), depth in cube units, binary cube segmentation) and
    (n_rows, K, 2) f32 pixel keypoints. Each row holds one cube: a
    rectangle of side 24-120 px, its depth 0.15-0.3 m / 0.035 over a
    background of 0.3-0.6 m / 0.035, its keypoints spread over the
    rectangle. Drawn on the device, ``chunk`` rows a call."""
    gen = device_generator(seed, TAG_SPLIT, device)
    images = torch.empty((n_rows, 5, h, w), dtype=dtype, device=device)
    coords = torch.empty((n_rows, n_keypoints, 2), dtype=torch.float32, device=device)
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    for s in range(0, n_rows, chunk):
        b = min(chunk, n_rows - s)
        u = torch.rand((b, 8), generator=gen, device=device)
        side_y, side_x = 24 + 96 * u[:, 0], 24 + 96 * u[:, 1]
        top, left = (h - side_y) * u[:, 2], (w - side_x) * u[:, 3]
        near, far = (0.15 + 0.15 * u[:, 4]) / 0.035, (0.3 + 0.3 * u[:, 5]) / 0.035
        inside = (
            (ys >= top[:, None, None]) & (ys < (top + side_y)[:, None, None])
            & (xs >= left[:, None, None]) & (xs < (left + side_x)[:, None, None])
        )
        noise = torch.rand((b, 4, h, w), generator=gen, device=device)
        depth = torch.where(inside, near[:, None, None], far[:, None, None]) + 0.2 * noise[:, 3]
        block = torch.cat([noise[:, :3], depth[:, None], inside[:, None].float()], dim=1)
        images[s : s + b].copy_(block)
        k = torch.rand((b, n_keypoints, 2), generator=gen, device=device)
        coords[s : s + b, :, 0] = left[:, None] + side_x[:, None] * k[..., 0]
        coords[s : s + b, :, 1] = top[:, None] + side_y[:, None] * k[..., 1]
    return images, coords


def epoch_order(seed: int, epoch: int, n_rows: int, batch: int) -> np.ndarray:
    """(steps, batch) int64 row indices of epoch ``epoch``: a permutation of
    the split cut into whole batches (the last partial batch dropped)."""
    perm = np.random.default_rng(subseed(seed, TAG_ORDER, epoch)).permutation(n_rows)
    steps = n_rows // batch
    return perm[: steps * batch].reshape(steps, batch).astype(np.int64)


def sample_indices(seed: int, n: int, k: int, always: tuple = ()) -> list[int]:
    """``k`` of ``range(n)`` drawn from the seed, those in ``always`` (which
    may be negative, counted from the end) among them, sorted."""
    chosen = {i % n for i in always if n}
    rng = np.random.default_rng(subseed(seed, TAG_SAMPLE))
    rest = [int(i) for i in rng.permutation(n) if int(i) not in chosen]
    return sorted(chosen | set(rest[: max(0, k - len(chosen))]))
