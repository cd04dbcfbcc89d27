"""Synthetic video generation: simulate box scenes, render, write job dirs.

Port of ``perseus_tpu/datagen/generate.py``. Per video it randomises a
scene (the "mjc" cube with random scale, velocity and spin, static floor
distractors, a few tossed dynamic distractors, a fixed-random or linearly
moving camera), simulates the rigid bodies with ground contact and
object-object collisions in numpy, renders RGB / depth / segmentation with
``datagen/render.py`` on the card, and writes ``rgba_*.png``,
``depth_*.tiff``, ``segmentation_*.png`` and a kubric-compatible
``metadata.json`` per job directory, which ``datagen/label_dataset.py`` ->
``data/merge.py`` -> ``data/prune.py`` -> training consume.

The simulation is the JAX module's numpy code, copied: for one seed and job
id, the scene, ``metadata.json``, the labels and the segmentation agree
with the JAX package's. The textures and the background noise draw from a
``torch.Generator`` seeded by the one integer the JAX module draws to seed
its key, so the numpy stream stays aligned; their pixels differ.

:func:`render_video` is the compute (no file is written, no ``PIL``);
:func:`generate_one_video` writes its result (``PIL`` for the images).
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from perseus_tpu_torch import resolve_device
from perseus_tpu_torch.data import schema
from perseus_tpu_torch.datagen import render

__all__ = [
    "CUBE_FACE_PALETTE",
    "VideoConfig",
    "simulate_video",
    "render_simulated",
    "render_video",
    "write_video",
    "generate_one_video",
    "generate_all_videos",
]

# Fixed six-face cube albedos in BOX_FACES face order (-x, +x, -y, +y, -z,
# +z): six distinct hues, constant across the dataset so face identity is a
# stable, learnable signal (the mjc.mtl role).
CUBE_FACE_PALETTE = np.array(
    [
        [0.85, 0.15, 0.15],  # -x red
        [0.15, 0.70, 0.20],  # +x green
        [0.15, 0.25, 0.85],  # -y blue
        [0.90, 0.80, 0.15],  # +y yellow
        [0.80, 0.20, 0.75],  # -z magenta
        [0.10, 0.75, 0.75],  # +z cyan
    ],
    dtype=np.float32,
)


@dataclass(frozen=True)
class VideoConfig:
    """Scene randomization ranges (mirrors generate_one_video.py FLAGS)."""

    job_dir: str = "data/job"
    resolution: int = 256
    frames: int = 24
    fps: float = 12.0
    fov: float = 0.8575560548920328  # kubric's 49.1 degree default

    asset_id: str = "mjc"
    cube_scale_range: tuple[float, float] = (0.8, 1.2)
    cube_spawn_region: tuple[float, float] = (-1.0, 1.0)  # xy extent
    cube_spawn_height: tuple[float, float] = (1.5, 3.0)
    max_linear_velocity: float = 1.0
    max_angular_velocity: float = 6.0

    n_static_range: tuple[int, int] = (10, 20)
    n_dynamic_range: tuple[int, int] = (1, 3)
    distractor_scale_range: tuple[float, float] = (0.3, 1.0)
    # Per-vertex jitter (fraction of half-extent) applied to every DISTRACTOR
    # mesh, making each one a unique irregular hexahedron. This is the shape
    # half of the reference's GSO mesh diversity (generate_one_video.py:
    # 229-245): with exact boxes/wedges only, a detector can shortcut on
    # "any axis-regular box is the cube". The cube itself is never jittered.
    distractor_vertex_jitter: float = 0.25

    camera_movement: str = "fixed_random"  # or "linear"
    camera_radius_range: tuple[float, float] = (6.0, 9.0)
    camera_height_range: tuple[float, float] = (2.0, 5.0)
    gravity: float = -2.0  # soft gravity keeps the cube in view for 2 s
    # ground-plane contact for tossed bodies (the PyBullet-dynamics role);
    # False reverts to pure ballistics
    ground_contact: bool = True
    # pairwise object-object contact impulses (bounding-sphere model; see
    # _simulate_bodies) — tossed distractors can't interpenetrate the cube
    object_collisions: bool = True

    # Camera-sensor realism post-process (_apply_camera_effects): per-video
    # randomized white balance, gamma, exposure, vignette, and shot-noise —
    # the optical/sensor part of the reference's Cycles-vs-real gap (its
    # renders pass through Blender's filmic tonemap + real-camera capture at
    # deploy time). Label-safe (no pixel is displaced). Default OFF so the
    # round-3/4 at-scale operating point stays bit-comparable.
    camera_effects: bool = False

    # Domain-randomization style family. "train" draws materials / lighting /
    # background textures from the training ranges; "holdout" draws from
    # DISJOINT ranges (rougher->shinier materials, low sun, striped darker
    # textures) so validation on holdout-style videos measures whether the
    # randomization transfers to unseen appearance — the purpose of the
    # reference's HDRI/material randomization (generate_one_video.py:229-317).
    style: str = "train"
    # objects are padded (inactive) to this count: the renderer's inputs
    # keep one shape whatever the scene's object count
    max_objects: int = 24

    seed: int = 0



def _np_so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues' formula in plain numpy: (3,) axis-angle -> (3, 3) rotation.
    The sim loop calls this hundreds of times per video, on the host."""
    theta = float(np.linalg.norm(w))
    if theta < 1e-9:
        return np.eye(3)
    k = w / theta
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
    )
    return (np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)).astype(
        w.dtype if w.dtype.kind == "f" else np.float64
    )


def _np_rot_to_quat_wxyz(r: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> (4,) quaternion wxyz (Shepperd's method), numpy."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(r)))
    if i == 0:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        return np.array(
            [(r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s]
        )
    if i == 1:
        s = np.sqrt(1.0 - r[0, 0] + r[1, 1] - r[2, 2]) * 2
        return np.array(
            [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s, (r[1, 2] + r[2, 1]) / s]
        )
    s = np.sqrt(1.0 - r[0, 0] - r[1, 1] + r[2, 2]) * 2
    return np.array(
        [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s, (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    )


def _look_at_blender(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Rotation of a Blender camera (-Z forward, +Y up) at `position` looking
    at `target` (matches kubric's camera.look_at)."""
    fwd = target - position
    fwd = fwd / np.linalg.norm(fwd)
    z_cam = -fwd
    world_up = np.array([0.0, 0.0, 1.0])
    x_cam = np.cross(world_up, z_cam)
    n = np.linalg.norm(x_cam)
    if n < 1e-6:  # looking straight up/down
        x_cam = np.array([1.0, 0.0, 0.0])
    else:
        x_cam = x_cam / n
    y_cam = np.cross(z_cam, x_cam)
    return np.stack([x_cam, y_cam, z_cam], axis=-1)


def _support_height(rot: np.ndarray, half_extents: np.ndarray) -> float:
    """Distance from a box's center to its lowest point under rotation
    `rot` (world-from-body): sum_k he_k * |e_z . rot[:, k]|."""
    return float(np.sum(half_extents * np.abs(rot[2, :])))


def _dist_to_segment(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> float:
    """Distance from 2-D point `p` to the segment [a, b]."""
    ab = b - a
    denom = float(ab @ ab)
    s = 0.0 if denom < 1e-12 else float(np.clip((p - a) @ ab / denom, 0.0, 1.0))
    return float(np.linalg.norm(p - (a + s * ab)))


def _integrate_pose(
    pos0: np.ndarray, rot0: np.ndarray, vel: np.ndarray, ang_vel: np.ndarray,
    frames: int, dt: float, gravity: float,
    half_extents: np.ndarray | None = None,
    restitution: float = 0.35,
    friction: float = 0.25,
) -> tuple[np.ndarray, np.ndarray]:
    """Rigid-body integration: ballistic translation + constant body angular
    velocity, with ground-plane contact when `half_extents` is given.

    The contact model plays the role of the reference's PyBullet simulation
    (generate_one_video.py:248,328 — contact dynamics + settle): when the
    box's support point would penetrate z=0, the position is projected out,
    the vertical velocity reflects with `restitution`, and an impulse
    friction damps the tangential velocity and spin; slow bounces settle.
    A substantial fidelity upgrade over pure ballistics — tossed objects
    land and tumble instead of falling through the floor.
    """
    positions, rotations = [], []
    pos, rot, v, w = pos0.copy(), rot0.copy(), vel.copy(), ang_vel.copy()
    for _ in range(frames):
        positions.append(pos.copy())
        rotations.append(rot.copy())
        pos = pos + v * dt
        v = v + np.array([0.0, 0.0, gravity]) * dt
        rot = rot @ _np_so3_exp(w * dt)
        if half_extents is not None:
            supp = _support_height(rot, half_extents)
            if pos[2] < supp:
                pos[2] = supp
                if v[2] < 0.0:
                    v[2] = -restitution * v[2]
                    if v[2] < 0.15:  # settle slow bounces
                        v[2] = 0.0
                v[:2] *= 1.0 - friction
                w *= 1.0 - friction
    return np.stack(positions), np.stack(rotations)


def _style_params(style: str, rng: np.random.Generator) -> dict:
    """Per-video appearance draw: materials, lighting, background textures.

    "train" and "holdout" ranges are DISJOINT on every axis — shininess
    (8-64 vs 90-160), specular (0-0.45 vs 0.5-0.7), shadow strength (0.3-0.7
    vs 0.72-0.9), sun elevation (35-75 vs 15-33 deg), light intensity
    (0.85-1.15 vs 1.25-1.45), material gain (0.7-1.1 vs 0.5-0.68), palette
    and stripes — so a model trained on train-style videos has never seen a
    holdout-style appearance; evaluating on holdout measures
    domain-randomization transfer."""
    if style == "train":
        p = dict(
            shininess=float(rng.uniform(8.0, 64.0)),
            spec_strength=float(rng.uniform(0.0, 0.45)),
            shadow_strength=float(rng.uniform(0.3, 0.7)),
            light_elevation=float(rng.uniform(np.deg2rad(35), np.deg2rad(75))),
            light_intensity=float(rng.uniform(0.85, 1.15)),
            stripes=0.0,
            material_gain=float(rng.uniform(0.7, 1.1)),
        )
        p["sky_colors"] = rng.uniform(0.1, 0.9, size=(2, 3))
        p["ground_colors"] = rng.uniform(0.1, 0.9, size=(2, 3))
        # background texture FAMILY pool (the HDRI-dome diversity role,
        # reference generate_one_video.py:119-134 — every scene gets a
        # random environment image): fbm tiles, equirect sky panoramas
        # (gradient + clouds + sun), Voronoi cell floors
        p["sky_family"] = ("fbm", "pan", "pan")[int(rng.integers(3))]
        p["ground_family"] = ("fbm", "cells")[int(rng.integers(2))]
    elif style == "holdout":
        p = dict(
            shininess=float(rng.uniform(90.0, 160.0)),
            spec_strength=float(rng.uniform(0.5, 0.7)),
            shadow_strength=float(rng.uniform(0.72, 0.9)),
            light_elevation=float(rng.uniform(np.deg2rad(15), np.deg2rad(33))),
            light_intensity=float(rng.uniform(1.25, 1.45)),
            stripes=0.7,
            material_gain=float(rng.uniform(0.5, 0.68)),
        )
        # high-contrast dark/light palettes never drawn at train time
        p["sky_colors"] = np.stack([rng.uniform(0.0, 0.08, 3), rng.uniform(0.92, 1.0, 3)])
        p["ground_colors"] = np.stack([rng.uniform(0.0, 0.08, 3), rng.uniform(0.92, 1.0, 3)])
        # striped fbm only — keeps every holdout appearance axis disjoint
        # from the train draw (train never sees stripes=0.7 textures)
        p["sky_family"] = "fbm"
        p["ground_family"] = "fbm"
    else:
        raise ValueError(f"unknown style {style!r}")
    az = rng.uniform(0.0, 2 * np.pi)
    el = p.pop("light_elevation")
    p["light_dir"] = np.array(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], dtype=np.float32
    )
    return p


def _simulate_bodies(
    bodies: list[dict],
    frames: int,
    dt: float,
    gravity: float,
    restitution: float = 0.35,
    friction: float = 0.25,
    substeps: int = 4,
    ground: bool = True,
    collisions: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Joint rigid-body integration with ground contact AND pairwise
    object-object collisions (the PyBullet contact-dynamics role, reference:
    generate_one_video.py:298-328 — tossed distractors there collide with
    the settled scene; round-3's independent per-body ballistics let
    distractors interpenetrate the cube, a label-noise source the reference
    doesn't have).

    Each body is a dict {pos, rot, vel, ang, he, movable}. Collision model:
    contact distance along the center line is the sum of the two boxes'
    SUPPORT RADII on that axis (``_support_radius``: h(n) = Σ_k he_k·|n·R_k|,
    the exact projected half-width of the oriented box), with the bounding
    sphere ``|he|_2`` only as a cheap prefilter. An earlier version used the
    bounding sphere as the contact distance itself; that phantom-contacted
    anything inside the circumscribed ball and measurably shoved the cube
    off-camera (fraction of frames with out-of-frame GT corners: 0.85
    sphere-contact vs 0.15 collisions-off vs ~0.17 support-radius — the
    round-4 "82% of val frames have OOF corners" regression). Mass is
    proportional to volume, statics have infinite mass. Contacts resolve by
    positional projection split by inverse mass plus a restitution impulse
    along the contact normal and tangential friction damping; momentum is
    conserved for movable-movable impacts (tested in
    tests/test_datagen_render.py::test_object_collisions_*).

    Returns (positions (T, O, 3), rotations (T, O, 3, 3)).
    """
    o = len(bodies)
    pos = np.stack([b["pos"].astype(np.float64) for b in bodies])
    rot = np.stack([b["rot"].astype(np.float64) for b in bodies])
    vel = np.stack([b["vel"].astype(np.float64) for b in bodies])
    ang = np.stack([b["ang"].astype(np.float64) for b in bodies])
    he = np.stack([b["he"].astype(np.float64) for b in bodies])
    movable = np.array([bool(b["movable"]) for b in bodies])
    radius = np.linalg.norm(he, axis=-1)
    inv_mass = np.where(movable, 1.0 / np.prod(he, axis=-1), 0.0)

    def _contact_overlap(i: int, j: int):
        """(overlap, n) of the pair along the center line, or (None, None).

        Overlap uses each box's support radius on the center axis — the
        single-axis SAT distance. Separation on this axis PROVES the boxes
        are disjoint (it is a separating axis), so interpenetration is never
        missed; overlap on this one axis alone cannot prove intersection, so
        near-corner disjoint pairs can still report phantom contacts — a far
        milder artifact than the bounding-sphere test this replaced."""
        d = pos[i] - pos[j]
        dist = float(np.linalg.norm(d))
        if dist >= radius[i] + radius[j] or dist < 1e-9:  # sphere prefilter
            return None, None
        n = d / dist
        r_i = float(np.abs(n @ rot[i]) @ he[i])
        r_j = float(np.abs(n @ rot[j]) @ he[j])
        overlap = r_i + r_j - dist
        if overlap <= 0.0:
            return None, None
        return overlap, n

    positions = np.empty((frames, o, 3))
    rotations = np.empty((frames, o, 3, 3))
    h = dt / substeps

    def _project_overlaps() -> bool:
        """One sweep of positional projection; True if any pair overlapped."""
        any_overlap = False
        for i in range(o):
            for j in range(i + 1, o):
                if not (movable[i] or movable[j]):
                    continue
                overlap, n = _contact_overlap(i, j)
                if overlap is None:
                    continue
                any_overlap = True
                w_sum = inv_mass[i] + inv_mass[j]
                pos[i] += n * (overlap * inv_mass[i] / w_sum)
                pos[j] -= n * (overlap * inv_mass[j] / w_sum)
        return any_overlap

    # Resolve spawn overlaps BEFORE frame 0 is recorded (random placement can
    # drop a tossed body inside another; frame 0 must already be
    # penetration-free — the reference gets this by settling spawns through
    # PyBullet before recording). Projection moves movables only.
    if collisions:
        for _ in range(32):
            if not _project_overlaps():
                break
            if ground:  # projection must not push a body under the floor
                for i in range(o):
                    if movable[i]:
                        pos[i, 2] = max(pos[i, 2], _support_height(rot[i], he[i]))

    for f in range(frames):
        positions[f] = pos
        rotations[f] = rot
        for _ in range(substeps):
            # integrate movables
            for i in range(o):
                if not movable[i]:
                    continue
                pos[i] = pos[i] + vel[i] * h
                vel[i, 2] += gravity * h
                rot[i] = rot[i] @ _np_so3_exp(ang[i] * h)
                supp = _support_height(rot[i], he[i])
                if ground and pos[i, 2] < supp:
                    pos[i, 2] = supp
                    if vel[i, 2] < 0.0:
                        vel[i, 2] = -restitution * vel[i, 2]
                        if vel[i, 2] < 0.15:  # settle slow bounces
                            vel[i, 2] = 0.0
                    vel[i, :2] *= 1.0 - friction * h / dt
                    ang[i] *= 1.0 - friction * h / dt
            # pairwise sphere contacts (o <= ~25: the n^2 loop is trivial)
            if not collisions:
                continue
            for i in range(o):
                for j in range(i + 1, o):
                    if not (movable[i] or movable[j]):
                        continue
                    overlap, n = _contact_overlap(i, j)
                    if overlap is None:
                        continue
                    w_sum = inv_mass[i] + inv_mass[j]
                    # positional projection split by inverse mass
                    pos[i] += n * (overlap * inv_mass[i] / w_sum)
                    pos[j] -= n * (overlap * inv_mass[j] / w_sum)
                    v_rel = float(np.dot(vel[i] - vel[j], n))
                    if v_rel < 0.0:  # approaching: restitution impulse
                        imp = -(1.0 + restitution) * v_rel / w_sum
                        vel[i] += imp * inv_mass[i] * n
                        vel[j] -= imp * inv_mass[j] * n
                        # graze: trade a bit of spin across the contact
                        ang[i] *= 1.0 - 0.2 * friction
                        ang[j] *= 1.0 - 0.2 * friction
            if ground:
                # the pairwise projection can push a movable below the floor
                # (the integrator's clamp already ran earlier this substep);
                # re-apply it so no recorded frame shows a sunken body
                for i in range(o):
                    if movable[i]:
                        pos[i, 2] = max(pos[i, 2], _support_height(rot[i], he[i]))
                # ...and the clamp can re-open a pairwise overlap: a couple
                # of projection-only Gauss-Seidel sweeps settle both
                # constraints (impulses applied once above, not re-applied)
                for _ in range(2):
                    if not _project_overlaps():
                        break
                    for i in range(o):
                        if movable[i]:
                            pos[i, 2] = max(pos[i, 2], _support_height(rot[i], he[i]))
    return positions, rotations


def _apply_camera_effects(rgb: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-video camera/sensor model over (T, H, W, 3) renders in [0, 1]:
    white-balance gains, gamma (film response), exposure, radial vignette,
    and per-frame Gaussian shot noise. Every effect is photometric only —
    no pixel moves, so labels/segmentation/depth stay exact. Ranges are
    mild: the goal is the optics/sensor texture real captures have and the
    rasterizer's clean output lacks (the reference leans on Cycles' filmic
    tonemap for the same effect, custom_renderer.py:8-29)."""
    t, h, w, _ = rgb.shape
    wb = rng.uniform(0.92, 1.08, size=3)
    gamma = rng.uniform(0.85, 1.2)
    exposure = rng.uniform(0.85, 1.2)
    vig = rng.uniform(0.0, 0.35)
    noise_sigma = rng.uniform(0.003, 0.015)

    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    r2 = (xx * xx + yy * yy) / 2.0  # 0 center -> 1 corner
    vignette = (1.0 - vig * r2).astype(np.float32)[None, :, :, None]

    out = np.clip(rgb * wb[None, None, None, :], 0.0, 1.0) ** gamma
    out = out * exposure * vignette
    out = out + rng.normal(0.0, noise_sigma, size=out.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def _simulate(cfg: VideoConfig, rng: np.random.Generator):
    t, dt = cfg.frames, 1.0 / cfg.fps

    # the cube (instance 0 — the labeler finds it by asset_id)
    abs_scale = float(rng.uniform(*cfg.cube_scale_range))
    lo, hi = cfg.cube_spawn_region
    cube_pos0 = np.array(
        [rng.uniform(lo, hi), rng.uniform(lo, hi), rng.uniform(*cfg.cube_spawn_height)]
    )
    cube_rot0 = _np_so3_exp(rng.normal(size=3))
    # center-biased velocity, exactly the reference's recipe
    # (generate_one_video.py:266-270: velocity = uniform(range) - [x0, y0, 0])
    # — the draw is pulled back toward the camera's look-at point so the cube
    # tends to stay in frame over the trajectory
    cube_vel = rng.uniform(-cfg.max_linear_velocity, cfg.max_linear_velocity, 3)
    cube_vel[:2] -= cube_pos0[:2]
    cube_ang = rng.uniform(-cfg.max_angular_velocity, cfg.max_angular_velocity, 3)

    # distractors: static on the floor + dynamic tossed. All bodies integrate
    # JOINTLY with object-object contacts (the PyBullet role) — tossed
    # distractors bounce off the cube and the settled statics instead of
    # passing through them.
    n_static = int(rng.integers(cfg.n_static_range[0], cfg.n_static_range[1] + 1))
    n_dynamic = int(rng.integers(cfg.n_dynamic_range[0], cfg.n_dynamic_range[1] + 1))
    shape_families = ("box", "wedge", "pyramid")  # non-box GSO-distractor role

    def distractor_verts(he: np.ndarray) -> np.ndarray:
        """A unique irregular hexahedron: random base family + per-vertex
        jitter scaled by the half-extents. Collapsed wedge/pyramid vertices
        jitter independently, re-opening into slanted slivers — more shape
        variety, same 12-triangle topology."""
        v = render.shape_vertices(he, shape_families[int(rng.integers(3))])
        j = cfg.distractor_vertex_jitter
        if j > 0.0:
            v = v + rng.uniform(-j, j, size=(8, 3)) * he[None, :]
        return v
    half_extents = [np.full(3, abs_scale)]
    verts_local = [render.shape_vertices(half_extents[0], "box")]  # cube IS a box
    bodies = [
        dict(pos=cube_pos0, rot=cube_rot0, vel=cube_vel, ang=cube_ang,
             he=half_extents[0], movable=True)
    ]
    # Keep statics clear of the cube's spawn/landing zone: the reference
    # spawns via move_until_no_overlap (re-SAMPLE until free,
    # generate_one_video.py:296) so the cube never starts in contact. With a
    # static inside the landing zone, the per-substep contact projection
    # against an infinite-mass body acts as a conveyor that walks the cube
    # off-camera (measured: OOF-corner frame rate 0.59 statics-only vs 0.15
    # collisions-off).
    cube_clear = float(np.linalg.norm(half_extents[0])) + 1.0
    # Clear not just the spawn disk but the corridor the cube actually
    # travels: project the ballistic landing point (center-biased velocity
    # moves the cube up to a few units toward the origin before it lands)
    # and keep statics off the spawn->landing SEGMENT. With only the spawn
    # disk cleared, a static in the landing zone still conveyor-walks the
    # cube (residual OOF rate 0.110 vs the 0.097 collisions-off control).
    g_mag = abs(cfg.gravity)
    drop = max(float(cube_pos0[2]) - abs_scale, 0.0)
    vz = float(cube_vel[2])
    t_land = (vz + np.sqrt(vz * vz + 2.0 * g_mag * drop)) / g_mag if g_mag > 1e-9 else 0.0
    t_land = float(np.clip(t_land, 0.0, cfg.frames / cfg.fps))
    cube_land_xy = cube_pos0[:2] + cube_vel[:2] * t_land
    static_xy: list[tuple[np.ndarray, float]] = []
    for _ in range(n_static):
        he = rng.uniform(*cfg.distractor_scale_range, size=3)
        r_xy = float(np.linalg.norm(he))
        # rejection-sample so statics don't spawn interpenetrating each other
        # (the reference settles them through PyBullet instead)
        # ±7 xy field, the reference's STATIC_SPAWN_REGION
        # (generate_one_video.py:29) — a ±4 field is 4x its density, and the
        # cube then lands ON static piles (measured resting z ~3 vs ~1.7),
        # pushing its top corners out of frame
        placed = False
        for _attempt in range(50):
            xy = np.array([rng.uniform(-7, 7), rng.uniform(-7, 7)])
            if _dist_to_segment(xy, cube_pos0[:2], cube_land_xy) <= r_xy + cube_clear:
                continue
            if all(np.linalg.norm(xy - oxy) > r_xy + orad for oxy, orad in static_xy):
                placed = True
                break
        if not placed:
            # on exhaustion SKIP the distractor rather than silently keep a
            # sample that violates the clear zone (the reference's
            # move_until_no_overlap re-samples until free, max_trials=1000)
            continue
        static_xy.append((xy, r_xy))
        rot = _np_so3_exp(np.array([0.0, 0.0, rng.uniform(0, np.pi)]))
        verts = distractor_verts(he)
        # rest exactly on the floor: lift by the lowest rotated vertex (the
        # analytic box support height is wrong once vertices are jittered)
        rest_z = -float(np.min((rot @ verts.T)[2]))
        pos = np.array([xy[0], xy[1], rest_z])
        half_extents.append(he)
        verts_local.append(verts)
        bodies.append(dict(pos=pos, rot=rot, vel=np.zeros(3), ang=np.zeros(3),
                           he=he, movable=False))
    for _ in range(n_dynamic):
        he = rng.uniform(*cfg.distractor_scale_range, size=3)
        # Rejection-sample the toss origin clear of every body already placed
        # (the reference's kb.move_until_no_overlap, generate_one_video.py:310,
        # over its wider DYNAMIC_SPAWN_REGION). Spawning these inside the
        # cube's ±1 spawn box made frame-0 overlap with the cube near-certain,
        # and the pre-frame-0 projection loop then played pinball: the cube
        # was measured starting at z=5.0 / |xy|=1.9 (outside its configured
        # spawn ranges) before the video even began.
        r_dyn = float(np.linalg.norm(he))
        placed = False
        for _attempt in range(100):
            pos0 = np.array(
                [rng.uniform(-3.0, 3.0), rng.uniform(-3.0, 3.0), rng.uniform(1.0, 4.0)]
            )
            if all(
                np.linalg.norm(pos0 - b["pos"]) > r_dyn + np.linalg.norm(b["he"])
                for b in bodies
            ):
                placed = True
                break
        if not placed:
            # skip rather than spawn overlapping an existing body — a frame-0
            # overlap re-triggers the pre-frame-0 projection pinball this
            # rejection sampling exists to prevent
            continue
        rot0 = _np_so3_exp(rng.normal(size=3))
        # center-biased toss — the reference's recipe
        # (generate_one_video.py:311-315) ADAPTED to this scene's scale: the
        # reference subtracts the full xy over a ±5/z 1-5 region with ±4
        # velocities; here a half-strength pull-back over ±3/z 1-4 with this
        # config's ±1 velocity range keeps distractors flying THROUGH the
        # scene (occlusion events) instead of drifting out of it
        vel = rng.uniform(-cfg.max_linear_velocity, cfg.max_linear_velocity, 3)
        vel[:2] -= 0.5 * pos0[:2]
        ang = rng.uniform(-cfg.max_angular_velocity, cfg.max_angular_velocity, 3)
        half_extents.append(he)
        verts_local.append(distractor_verts(he))
        bodies.append(dict(pos=pos0, rot=rot0, vel=vel, ang=ang, he=he, movable=True))

    all_pos, all_rot = _simulate_bodies(
        bodies, t, dt, cfg.gravity,
        ground=cfg.ground_contact, collisions=cfg.object_collisions,
    )
    positions = [all_pos[:, i] for i in range(len(bodies))]
    rotations = [all_rot[:, i] for i in range(len(bodies))]

    # Per-face albedos (O, 6, 3). The cube's six faces get a FIXED distinct
    # palette — the analog of the reference mjc asset's six face textures
    # (data_generation/assets/mjc.mtl), which is what makes corner identity
    # learnable — modulated per video like the reference's randomized
    # Principled-BSDF material (generate_one_video.py:281-295). Distractors
    # get random independent face colors.
    style = _style_params(cfg.style, rng)
    colors = rng.uniform(0.15, 0.95, size=(len(half_extents), 6, 3))
    colors[0] = np.clip(CUBE_FACE_PALETTE * style["material_gain"], 0.05, 1.0)

    # camera: on a shell around the scene, looking at the cube spawn region
    target = np.array([0.0, 0.0, 1.0])
    radius = rng.uniform(*cfg.camera_radius_range)
    theta0 = rng.uniform(0, 2 * np.pi)
    h0 = rng.uniform(*cfg.camera_height_range)
    if cfg.camera_movement == "linear":
        theta1 = theta0 + rng.uniform(-0.8, 0.8)
        h1 = rng.uniform(*cfg.camera_height_range)
        thetas = np.linspace(theta0, theta1, t)
        hs = np.linspace(h0, h1, t)
    else:
        thetas = np.full(t, theta0)
        hs = np.full(t, h0)
    cam_pos = np.stack(
        [radius * np.cos(thetas), radius * np.sin(thetas), hs], axis=-1
    )
    cam_rot = np.stack([_look_at_blender(p, target) for p in cam_pos])

    return {
        "half_extents": np.stack(half_extents),
        "verts_local": np.stack(verts_local),  # (O, 8, 3)
        "positions": np.stack(positions, axis=1),  # (T, O, 3)
        "rotations": np.stack(rotations, axis=1),  # (T, O, 3, 3)
        "colors": colors,
        "abs_scale": abs_scale,
        "cam_pos": cam_pos,
        "cam_rot": cam_rot,
        "style": style,
    }



TEXTURE_SIZE = 128


def _make_texture(family: str, gen: torch.Generator, colors: np.ndarray, stripes: float, device) -> torch.Tensor:
    """One background texture draw from the per-style family pool, on
    ``device`` (the draws come from ``gen``, on the host)."""
    c = torch.as_tensor(colors, dtype=torch.float32).to(device)
    if family == "pan":
        return render.panorama_texture(render.sample_panorama(gen, device=device), TEXTURE_SIZE, c)
    if family == "cells":
        return render.cells_texture(render.sample_cells(gen, device=device), TEXTURE_SIZE, c)
    return render.fbm_texture(render.sample_fbm(gen, 3, stripes, device), TEXTURE_SIZE, c, stripes=stripes)


def _metadata(cfg: VideoConfig, scene: dict, cam_quat_wxyz: np.ndarray) -> dict:
    """The kubric-compatible ``metadata.json`` of a simulated scene."""
    t = cfg.frames
    instances = []
    for o in range(scene["half_extents"].shape[0]):
        quats = np.stack([_np_rot_to_quat_wxyz(scene["rotations"][i, o]) for i in range(t)])
        instances.append(
            {
                "asset_id": cfg.asset_id if o == 0 else f"distractor_{o}",
                "abs_scale": float(scene["half_extents"][o, 0]) if o == 0 else float(
                    scene["half_extents"][o].max()
                ),
                "half_extents": scene["half_extents"][o].tolist(),
                "positions": scene["positions"][:, o].tolist(),
                "quaternions": quats.tolist(),
            }
        )
    return {
        "flags": {"resolution": cfg.resolution, "frame_end": t, "frame_rate": cfg.fps},
        "camera": {
            "field_of_view": cfg.fov,
            "positions": scene["cam_pos"].tolist(),
            "quaternions": cam_quat_wxyz.tolist(),
        },
        "instances": instances,
    }


def simulate_video(cfg: VideoConfig, job_id: str) -> dict:
    """The host half of one video: the scene of (cfg.seed, job_id)
    simulated, the renderer's inputs padded to ``cfg.max_objects`` (inactive
    rows), the metadata, the seed of the texture / background draws, and
    the numpy generator (the camera effects draw from it after rendering)."""
    rng = np.random.default_rng([cfg.seed, zlib.crc32(job_id.encode())])
    scene = _simulate(cfg, rng)
    t = cfg.frames
    cam_quat_wxyz = np.stack([_np_rot_to_quat_wxyz(r) for r in scene["cam_rot"]])

    n_obj = scene["half_extents"].shape[0]
    pad = max(cfg.max_objects, n_obj) - n_obj
    inputs = {
        "obj_rot": np.concatenate(
            [scene["rotations"], np.tile(np.eye(3, dtype=np.float32), (t, pad, 1, 1))], axis=1
        ),
        "obj_trans": np.concatenate([scene["positions"], np.full((t, pad, 3), -100.0, np.float32)], axis=1),
        "half_extents": np.concatenate([scene["half_extents"], np.full((pad, 3), 0.1, np.float32)]),
        "colors": np.concatenate([scene["colors"], np.full((pad, 6, 3), 0.5, np.float32)]),
        "active": np.concatenate([np.ones(n_obj, np.float32), np.zeros(pad, np.float32)]),
        "cam_pose7_wxyz": np.concatenate([scene["cam_pos"], cam_quat_wxyz], axis=-1),
        "verts_local": np.concatenate(
            [scene["verts_local"], np.tile(render.shape_vertices(np.full(3, 0.1), "box"), (pad, 1, 1))]
        ),
    }
    # the one draw with which the JAX package seeds its key: drawn here too,
    # so that the numpy stream after it (the camera effects) stays aligned
    draw_seed = int(rng.integers(0, 2**31))
    return {
        "scene": scene,
        "inputs": inputs,
        "metadata": _metadata(cfg, scene, cam_quat_wxyz),
        "draw_seed": draw_seed,
        "rng": rng,
    }


def render_simulated(cfg: VideoConfig, sim: dict, device: str | torch.device | None = "cuda"):
    """The device half of one video: textures and frames of a
    :func:`simulate_video` result on ``device``. Returns (rgb (T, H, W, 3)
    f32 in [0, 1], depth (T, H, W) f32, seg (T, H, W) int32), tensors on
    ``device``. The draws come from a CPU generator seeded by
    ``sim["draw_seed"]``, so every device renders the same scene."""
    dev = resolve_device(device)
    style = sim["scene"]["style"]
    gen = torch.Generator().manual_seed(sim["draw_seed"])
    draws = render.sample_render(gen, dev)
    sky_tex = _make_texture(style["sky_family"], gen, style["sky_colors"], style["stripes"], dev)
    ground_tex = _make_texture(style["ground_family"], gen, style["ground_colors"], style["stripes"], dev)
    x = {k: torch.as_tensor(v, dtype=torch.float32).to(dev) for k, v in sim["inputs"].items()}
    rgb, depth, seg = render.render_frames(
        draws,
        x["obj_rot"],
        x["obj_trans"],
        x["half_extents"],
        x["colors"],
        x["active"],
        x["cam_pose7_wxyz"],
        cfg.fov,
        cfg.resolution,
        cfg.resolution,
        light_dir=torch.as_tensor(style["light_dir"], dtype=torch.float32).to(dev),
        verts_local=x["verts_local"],
        spec_strength=style["spec_strength"],
        shininess=style["shininess"],
        light_intensity=style["light_intensity"],
        ground=True,
        shadow_strength=style["shadow_strength"],
        sky_texture=sky_tex,
        ground_texture=ground_tex,
        sky_mode="pan" if style["sky_family"] == "pan" else "tile",
    )
    if cfg.camera_effects:
        rgb = torch.from_numpy(_apply_camera_effects(rgb.cpu().numpy(), sim["rng"])).to(dev)
    return rgb, depth, seg


def render_video(cfg: VideoConfig, job_id: str, device: str | torch.device | None = "cuda"):
    """Simulates and renders one video in memory: (rgb, depth, seg,
    metadata), the frames as tensors on ``device`` (:func:`render_simulated`)
    and the ``metadata.json`` dict. Writes nothing."""
    sim = simulate_video(cfg, job_id)
    rgb, depth, seg = render_simulated(cfg, sim, device)
    return rgb, depth, seg, sim["metadata"]


def write_video(job_path: str, rgb, depth, seg, metadata: dict) -> None:
    """Writes one rendered video as a job directory (needs ``PIL``)."""
    rgb, depth, seg = (np.asarray(torch.as_tensor(a).cpu()) for a in (rgb, depth, seg))
    for i in range(rgb.shape[0]):
        schema.save_rgb_png(os.path.join(job_path, f"rgba_{i:05d}.png"), rgb[i])
        schema.save_depth_tiff(os.path.join(job_path, f"depth_{i:05d}.tiff"), depth[i])
        schema.save_segmentation_png(os.path.join(job_path, f"segmentation_{i:05d}.png"), seg[i].astype(np.uint8))
    with open(os.path.join(job_path, "metadata.json"), "w") as f:
        json.dump(metadata, f)


def generate_one_video(
    cfg: VideoConfig, job_id: str | None = None, device: str | torch.device | None = "cuda"
) -> str:
    """Simulates, renders and writes one job directory; returns its path.
    A failure deletes the directory and re-raises."""
    job_id = job_id or uuid.uuid4().hex[:8]
    job_path = os.path.join(cfg.job_dir, job_id)
    os.makedirs(job_path, exist_ok=True)
    try:
        write_video(job_path, *render_video(cfg, job_id, device))
        return job_path
    except Exception:
        shutil.rmtree(job_path, ignore_errors=True)
        raise


def generate_all_videos(
    cfg: VideoConfig, n_videos: int = 2500, workers: int = 8, device: str | torch.device | None = "cuda"
) -> list[str]:
    """Generates n_videos job dirs in a process pool (``spawn``: a forked
    worker cannot use CUDA); per-video failures are skipped."""
    import multiprocessing as mp

    os.makedirs(cfg.job_dir, exist_ok=True)
    args = [(cfg, f"{i:08x}", device) for i in range(n_videos)]
    if workers <= 1:
        return [r for r in (_safe_generate(*a) for a in args) if r]
    with mp.get_context("spawn").Pool(workers) as pool:
        results = pool.starmap(_safe_generate, args)
    return [r for r in results if r]


def _safe_generate(cfg: VideoConfig, job_id: str, device: str | torch.device | None = "cuda") -> str | None:
    try:
        return generate_one_video(cfg, job_id, device)
    except Exception as exc:
        print(f"video {job_id} failed: {exc}")
        return None


def main() -> None:
    from perseus_tpu_torch.configs.cli import cli

    print(generate_one_video(cli(VideoConfig)))


if __name__ == "__main__":
    main()
