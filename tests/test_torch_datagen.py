"""Port parity: the synthetic-data path (perseus_tpu_torch/datagen, with the
lie.py and camera.py functions it reaches) against the JAX package.

Random draws are shared: the JAX side draws them with ``jax.random`` in the
JAX module's split order (as f32, under ``jax.enable_x64(False)``, so that
the JAX function's own draws equal them) and feeds them to the port's
functions. Tolerances:

  * lie / camera / labels: 1e-6 abs on f32 rotations and poses, 1e-3 px on
    projected pixels (measured ~2e-5 px: f32 products of ~8-unit distances);
  * textures: 5e-6 abs on [0, 1] values (measured up to 1.8e-6: the
    stripes' sin of arguments up to ~75 rad, the cells' sqrt differences
    / 0.04, and XLA's fused bilinear sums, each rounded by another library);
  * render_frames: seg equal on at least 99.5% of each frame's pixels, and
    where seg agrees rgb within 1e-4 and depth within rel 1e-5 on at least
    99.5% of them (measured: every pixel equal in seg, rgb within 9e-7,
    depth within rel 3e-7);
  * the numpy simulation and metadata.json: exact (the same numpy code on
    the same seed); segmentation of a generated video: as render_frames.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perseus_tpu import camera as jcamera
from perseus_tpu import lie as jlie
from perseus_tpu.datagen import generate as jgenerate
from perseus_tpu.datagen import labeling as jlabeling
from perseus_tpu.datagen import render as jrender
from perseus_tpu_torch import camera, lie
from perseus_tpu_torch.data import schema
from perseus_tpu_torch.datagen import generate, labeling, render

TEX_ATOL = 5e-6
SHARE = 0.995


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    the suite runs several test processes side by side on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    """Numpy / JAX arrays (nested in dicts and lists) -> f32 CPU tensors."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_t(v) for v in x]
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _uniform(key, shape, lo=0.0, hi=1.0):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi, dtype=jnp.float32)


def _octaves(key, octaves):
    keys = jax.random.split(key, octaves)
    return [_uniform(keys[i], (4 * 2**i + 1, 4 * 2**i + 1)) for i in range(octaves)]


def jax_fbm_draws(key, octaves=3, stripes=0.0):
    """fbm_texture's draws in its split order: split(key, octaves + 2)."""
    keys = jax.random.split(key, octaves + 2)
    draws = {"grids": [_uniform(keys[i], (4 * 2**i + 1, 4 * 2**i + 1)) for i in range(octaves)]}
    if stripes > 0.0:
        draws["angle"] = _uniform(keys[-2], (), 0.0, np.pi)
        draws["freq"] = _uniform(keys[-1], (), 4.0, 12.0)
    return draws


def jax_cells_draws(key, n_cells=24):
    k1, k2 = jax.random.split(key)
    return {"points": _uniform(k1, (n_cells, 2)), "shades": _uniform(k2, (n_cells,))}


def jax_panorama_draws(key, octaves=3):
    kc, ks, kh, kg = jax.random.split(key, 4)
    return {
        "grids": _octaves(kc, octaves),
        "cloud_amt": _uniform(kh, (), 0.15, 0.6),
        "cloud_gray": _uniform(kg, (), 0.7, 1.0),
        "sun": _uniform(ks, (2,)),
    }


def jax_render_draws(key):
    kb, kc, kd = jax.random.split(key, 3)
    return {"bg_tint": _uniform(kc, (3,), 0.2, 0.8), "noise": _uniform(kb, (9, 9)), "depth_noise": _uniform(kd, (9, 9))}


PALETTE = np.array([[0.1, 0.2, 0.3], [0.8, 0.7, 0.9]], np.float32)


def _rotations(rng, n):
    return np.stack([jgenerate._np_so3_exp(rng.normal(size=3)) for _ in range(n)]).astype(np.float32)


def test_lie_quaternion_euler_and_pose7_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    r = _rotations(rng, 6)
    euler = rng.uniform(-np.pi, np.pi, (6, 3)).astype(np.float32)
    p7 = np.concatenate([rng.normal(size=(6, 3)), q], -1).astype(np.float32)
    pairs = [
        (jlie.quat_wxyz_to_rot(jnp.asarray(q)), lie.quat_wxyz_to_rot(_t(q))),
        (jlie.quat_xyzw_to_rot(jnp.asarray(q)), lie.quat_xyzw_to_rot(_t(q))),
        (jlie.rot_to_quat_xyzw(jnp.asarray(r)), lie.rot_to_quat_xyzw(_t(r))),
        (jlie.euler_xyz_to_rot(jnp.asarray(euler)), lie.euler_xyz_to_rot(_t(euler))),
        (jlie.se3_to_pose7_wxyz(jlie.SE3(jnp.asarray(r), jnp.asarray(p7[:, :3]))),
         lie.se3_to_pose7_wxyz(lie.SE3(_t(r), _t(p7[:, :3])))),
    ]
    for fn in ("pose7_wxyz_to_se3", "pose7_xyzw_to_se3"):
        a, b = getattr(jlie, fn)(jnp.asarray(p7)), getattr(lie, fn)(_t(p7))
        pairs += [(a.rot, b.rot), (a.trans, b.trans)]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_camera_extensions_match_jax():
    rng = np.random.default_rng(1)
    r, t = _rotations(rng, 4), rng.normal(size=(4, 3)).astype(np.float32)
    pts = (rng.normal(size=(4, 3)) + [0, 0, 8]).astype(np.float32)
    jk = jcamera.intrinsics_from_fov(jnp.float32(0.9), 48, 64)
    tk = camera.intrinsics_from_fov(torch.tensor(0.9), 48, 64)
    np.testing.assert_allclose(camera.intrinsics_matrix(tk).numpy(), np.asarray(jcamera.intrinsics_matrix(jk)), atol=1e-6)
    ja = jcamera.blender_to_opencv_pose(jlie.SE3(jnp.asarray(r), jnp.asarray(t)))
    ta = camera.blender_to_opencv_pose(lie.SE3(_t(r), _t(t)))
    np.testing.assert_allclose(ta.rot.numpy(), np.asarray(ja.rot), atol=1e-6)
    np.testing.assert_allclose(ta.trans.numpy(), np.asarray(ja.trans), atol=1e-6)
    jp = jcamera.project_world_point(jk, ja, jnp.asarray(pts))
    tp = camera.project_world_point(tk, ta, _t(pts))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-3)


@pytest.mark.parametrize("kind", ["value_noise", "fbm", "fbm_stripes", "cells", "panorama"])
@pytest.mark.parametrize("seed", [0, 1])
def test_textures_match_jax_from_shared_draws(kind, seed):
    key = jax.random.key(seed)
    colors = jnp.asarray(PALETTE)
    with jax.enable_x64(False):
        if kind == "value_noise":
            want = jrender.value_noise(key, 40, 56, cells=8)
            got = render.value_noise(_t(_uniform(key, (9, 9))), 40, 56)
        elif kind.startswith("fbm"):
            stripes = 0.7 if kind == "fbm_stripes" else 0.0
            want = jrender.fbm_texture(key, 64, colors, octaves=3, stripes=stripes)
            got = render.fbm_texture(_t(jax_fbm_draws(key, 3, stripes)), 64, _t(PALETTE), stripes=stripes)
        elif kind == "cells":
            want = jrender.cells_texture(key, 64, colors)
            got = render.cells_texture(_t(jax_cells_draws(key)), 64, _t(PALETTE))
        else:
            want = jrender.panorama_texture(key, 64, colors)
            got = render.panorama_texture(_t(jax_panorama_draws(key)), 64, _t(PALETTE))
        want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TEX_ATOL)


def test_texture_samplers_match_jax():
    """_sample_pan / _sample_tile at coordinates of either sign and beyond
    one period (floor-mods, the clamp of the panorama's elevation)."""
    rng = np.random.default_rng(2)
    tex = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    u = rng.uniform(-3.0, 3.0, (20, 24)).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, (20, 24)).astype(np.float32)
    for name in ("_sample_pan", "_sample_tile"):
        want = np.asarray(getattr(jrender, name)(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v)))
        got = getattr(render, name)(_t(tex), _t(u), _t(v)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


def _scene(t=3, o=5, seed=0):
    """A 3-frame, 5-object scene (one inactive): random poses above the
    ground, jittered vertices, per-face colours, a Blender camera circling
    the origin."""
    rng = np.random.default_rng(seed)
    rots = np.stack([_rotations(rng, o) for _ in range(t)])
    trans = rng.uniform(-1.5, 1.5, (t, o, 3)).astype(np.float32)
    trans[..., 2] = np.abs(trans[..., 2]) + 0.5
    he = rng.uniform(0.3, 0.8, (o, 3)).astype(np.float32)
    verts = np.stack([jrender.shape_vertices(he[i], ("box", "wedge", "pyramid")[i % 3]) for i in range(o)])
    verts = (verts + rng.uniform(-0.1, 0.1, (o, 8, 3)) * he[:, None]).astype(np.float32)
    cam_pos = np.stack([[6 * np.cos(0.3 * i), 6 * np.sin(0.3 * i), 3.0] for i in range(t)])
    cam_rot = np.stack([jgenerate._look_at_blender(p, np.array([0, 0, 1.0])) for p in cam_pos])
    quat = np.stack([jgenerate._np_rot_to_quat_wxyz(r) for r in cam_rot])
    return {
        "obj_rot": rots, "obj_trans": trans, "half_extents": he,
        "colors": rng.uniform(0.1, 0.9, (o, 6, 3)).astype(np.float32),
        "active": np.array([1, 1, 1, 1, 0], np.float32)[:o],
        "cam_pose7_wxyz": np.concatenate([cam_pos, quat], -1).astype(np.float32),
        "verts_local": verts,
    }


def assert_renders_agree(got, want):
    """Seg equal on SHARE of each frame's pixels; where it agrees, rgb
    within 1e-4 and depth within rel 1e-5 on SHARE of those."""
    (rgb_a, depth_a, seg_a), (rgb_b, depth_b, seg_b) = got, want
    same = seg_a == seg_b
    assert same.mean(axis=(1, 2)).min() >= SHARE
    ok = same & (np.abs(rgb_a - rgb_b).max(axis=-1) <= 1e-4) & (np.abs(depth_a - depth_b) <= 1e-5 * np.abs(depth_b))
    assert (ok.sum(axis=(1, 2)) / same.sum(axis=(1, 2))).min() >= SHARE


@pytest.mark.parametrize(
    "mode", ["pan", "tile", "flat"],
    ids=["ground_pan_sky", "ground_tile_sky", "no_ground_flat_background"],
)
def test_render_frames_matches_jax_from_shared_draws(mode):
    """48x48, 3 frames, 5 objects: per-face colours, jittered vertices, the
    checker, Blinn-Phong; with the ground, its shadows and both sky modes,
    and without them (the value-noise background)."""
    key = jax.random.key(4)
    s = _scene()
    kw = dict(fov=0.857, height=48, width=48, spec_strength=0.3, shininess=20.0, light_intensity=1.1, checker=0.3)
    if mode != "flat":
        with jax.enable_x64(False):
            sky = np.asarray(jrender.panorama_texture(jax.random.key(5), 32, jnp.asarray(PALETTE)))
            ground = np.asarray(jrender.cells_texture(jax.random.key(6), 32, jnp.asarray(PALETTE)))
        kw.update(ground=True, shadow_strength=0.5, sky_texture=sky, ground_texture=ground, sky_mode=mode)
    light = np.array([0.3, 0.2, 0.9], np.float32)
    with jax.enable_x64(False):
        want = jrender.render_frames(
            key, *(jnp.asarray(s[k]) for k in ("obj_rot", "obj_trans", "half_extents", "colors", "active",
                                               "cam_pose7_wxyz")),
            light_dir=jnp.asarray(light), verts_local=jnp.asarray(s["verts_local"]),
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()},
        )
        want = [np.asarray(x) for x in want]
    got = render.render_frames(
        _t(jax_render_draws(key)),
        *(_t(s[k]) for k in ("obj_rot", "obj_trans", "half_extents", "colors", "active", "cam_pose7_wxyz")),
        light_dir=_t(light), verts_local=_t(s["verts_local"]),
        **{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()},
    )
    got = [x.numpy() for x in got]
    assert got[2].dtype == np.int32 and set(np.unique(want[2])) >= {0, 1}
    assert_renders_agree(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_matches_jax_exactly(seed):
    """The numpy simulation (contact and collisions on) on one seed: every
    array and the style draw equal, and the generators left in one state."""
    cfg_j = jgenerate.VideoConfig(frames=12, seed=seed)
    cfg_t = generate.VideoConfig(frames=12, seed=seed)
    assert cfg_t.ground_contact and cfg_t.object_collisions
    rng_j, rng_t = np.random.default_rng([seed, 5]), np.random.default_rng([seed, 5])
    want, got = jgenerate._simulate(cfg_j, rng_j), generate._simulate(cfg_t, rng_t)
    assert want.keys() == got.keys() and want["style"].keys() == got["style"].keys()
    for k in want:
        if k == "style":
            for sk, v in want["style"].items():
                np.testing.assert_array_equal(got["style"][sk], v)
        else:
            np.testing.assert_array_equal(got[k], want[k])
    assert rng_j.bit_generator.state == rng_t.bit_generator.state


@pytest.fixture(scope="module")
def video_pair(tmp_path_factory):
    """One job, seed and id rendered by both packages at 32x32, 4 frames
    (tests/test_full_pipeline.py's video config), with the camera effects
    on; the numpy generator's state recorded where they draw."""
    root = tmp_path_factory.mktemp("video_pair")
    kw = dict(resolution=32, frames=4, n_static_range=(1, 2), n_dynamic_range=(1, 1), cube_scale_range=(1.0, 1.4),
              gravity=-0.5, seed=11, camera_effects=True)
    states = {}

    def recording(name, real):
        def effects(rgb, rng):
            states[name] = rng.bit_generator.state
            return real(rgb, rng)
        return effects

    from unittest import mock

    with mock.patch.object(jgenerate, "_apply_camera_effects", recording("jax", jgenerate._apply_camera_effects)), \
            mock.patch.object(generate, "_apply_camera_effects", recording("torch", generate._apply_camera_effects)):
        jpath = jgenerate.generate_one_video(jgenerate.VideoConfig(job_dir=str(root / "jax"), **kw), "0000abcd")
        tpath = generate.generate_one_video(generate.VideoConfig(job_dir=str(root / "torch"), **kw), "0000abcd",
                                            device="cpu")
    return jpath, tpath, states


def test_generate_one_video_matches_jax(video_pair):
    """metadata.json equal, the numpy stream at the camera effects in one
    state (the one integer drawn at the same point), segmentation equal on
    the stated share, and every file of the job written."""
    jpath, tpath, states = video_pair
    assert sorted(os.listdir(jpath)) == sorted(os.listdir(tpath))
    with open(os.path.join(jpath, "metadata.json")) as f, open(os.path.join(tpath, "metadata.json")) as g:
        assert json.load(f) == json.load(g)
    assert states["jax"] == states["torch"]
    for i in range(4):
        a = schema.load_segmentation_png(os.path.join(tpath, f"segmentation_{i:05d}.png"))
        b = schema.load_segmentation_png(os.path.join(jpath, f"segmentation_{i:05d}.png"))
        assert (a == b).mean() >= SHARE
        assert schema.load_rgb_png(os.path.join(tpath, f"rgba_{i:05d}.png")).shape == (32, 32, 3)


def test_pixel_coordinates_and_labels_match_jax(video_pair):
    """label_trajectory (f32) and get_pixel_coordinates (f64, the labeler's
    precision) on the generated video's metadata, within 1e-3 px."""
    with open(os.path.join(video_pair[1], "metadata.json")) as f:
        meta = json.load(f)
    cube = meta["instances"][0]
    obj7 = np.concatenate([cube["positions"], cube["quaternions"]], -1)
    cam7 = np.concatenate([meta["camera"]["positions"], meta["camera"]["quaternions"]], -1)
    args = (cube["abs_scale"], meta["camera"]["field_of_view"], 32, 32)
    want = np.asarray(jlabeling.label_trajectory(jnp.asarray(obj7, jnp.float32), jnp.asarray(cam7, jnp.float32), *args))
    got = labeling.label_trajectory(obj7, cam7, *args, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (4, 8, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)

    xyzw = lambda p: np.concatenate([p[..., :3], p[..., 4:7], p[..., 3:4]], -1)  # noqa: E731
    corners = np.asarray(jlabeling.cube_corners(cube["abs_scale"]), np.float64)
    want = np.asarray(jlabeling.get_pixel_coordinates(jnp.asarray(corners), jnp.asarray(xyzw(obj7)),
                                                      jnp.asarray(xyzw(cam7)), args[1], 32, 32))
    got = labeling.get_pixel_coordinates(torch.from_numpy(corners), torch.from_numpy(xyzw(obj7)),
                                         torch.from_numpy(xyzw(cam7)), args[1], 32, 32)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_render_video_is_what_generate_one_video_writes(video_pair):
    """render_video, the compute half, gives the frames and metadata that
    generate_one_video wrote (PNG RGB to 1/255), and its draws depend on
    the seed and job id alone."""
    cfg = generate.VideoConfig(resolution=32, frames=4, n_static_range=(1, 2), n_dynamic_range=(1, 1),
                               cube_scale_range=(1.0, 1.4), gravity=-0.5, seed=11, camera_effects=True)
    rgb, depth, seg, meta = generate.render_video(cfg, "0000abcd", device="cpu")
    again = generate.render_video(cfg, "0000abcd", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip((rgb, depth, seg), again[:3]))
    tpath = video_pair[1]
    with open(os.path.join(tpath, "metadata.json")) as f:
        assert json.load(f) == json.loads(json.dumps(meta))
    for i in range(4):
        np.testing.assert_array_equal(schema.load_segmentation_png(os.path.join(tpath, f"segmentation_{i:05d}.png")),
                                      seg[i].numpy())
        np.testing.assert_array_equal(schema.load_depth_tiff(os.path.join(tpath, f"depth_{i:05d}.tiff")),
                                      depth[i].numpy())
        np.testing.assert_allclose(schema.load_rgb_png(os.path.join(tpath, f"rgba_{i:05d}.png")), rgb[i].numpy(),
                                   atol=1.0 / 255)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    from perseus_tpu_torch.eval import pose_eval, validate

    cfg = generate.VideoConfig(resolution=16, frames=2)
    meta = {"instances": [{"quaternions": [[1, 0, 0, 0]] * 2, "positions": [[0, 0, 0]] * 2, "abs_scale": 1.0}],
            "camera": {"quaternions": [[1, 0, 0, 0]] * 2, "positions": [[0, 0, 5]] * 2, "field_of_view": 0.8},
            "flags": {"resolution": 16, "frame_rate": 12.0}}
    for call in (
        lambda: generate.render_video(cfg, "x"),
        lambda: labeling.label_trajectory(np.zeros((2, 7)), np.zeros((2, 7)), 1.0, 0.8, 16, 16),
        lambda: pose_eval.score_pose_tracking(np.zeros((2, 16, 16, 4)), meta, detector_fn=lambda f: np.zeros((2, 8, 2))),
        lambda: validate.validate_stats(validate.ValConfig(), state_dict={}),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_generate_all_videos_skips_a_failed_video(tmp_path):
    """generate_all_videos in one process: each video written, a video
    that fails removed and skipped (the reference's per-video tolerance)."""
    from unittest import mock

    cfg = generate.VideoConfig(job_dir=str(tmp_path), resolution=16, frames=2, max_objects=4, n_static_range=(1, 1))
    real = generate.write_video

    def flaky(job_path, *args):
        if job_path.endswith("00000001"):
            raise OSError("disk full")
        return real(job_path, *args)

    with mock.patch.object(generate, "write_video", flaky):
        paths = generate.generate_all_videos(cfg, n_videos=3, workers=1, device="cpu")
    assert [os.path.basename(p) for p in paths] == ["00000000", "00000002"]
    assert sorted(os.listdir(tmp_path)) == ["00000000", "00000002"]
    assert len(os.listdir(paths[0])) == 3 * 2 + 1
