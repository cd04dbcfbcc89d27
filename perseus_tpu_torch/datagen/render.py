"""Box-scene rasterizer for synthetic data generation, in PyTorch.

Port of ``perseus_tpu/datagen/render.py``: a z-buffer rasterizer of posed
8-vertex solids (the cube and its distractors) with Blinn-Phong shading, a
perspective-correct face checker, a ray-cast z = 0 ground plane with cast
shadows, and procedural sky / ground textures. It renders RGB, metric depth
and an exact instance segmentation with the labeler's camera math, so
projected keypoints land on the rendered pixels.

The JAX module maps over frames and scans over objects; here every frame
is rendered at once and the objects are looped over on the host (inactive
padding objects are skipped: they never win the depth test). Random draws
are explicit: each textured function takes a dict of its draws, which the
``sample_*`` helpers draw from a ``torch.Generator`` (the tests draw the
same values with ``jax.random`` in the JAX module's split order).
"""

from __future__ import annotations

import numpy as np
import torch

from perseus_tpu_torch import camera, lie

__all__ = [
    "BOX_FACES",
    "box_vertices",
    "shape_vertices",
    "sample_value_noise",
    "sample_fbm",
    "sample_cells",
    "sample_panorama",
    "sample_render",
    "value_noise",
    "fbm_texture",
    "cells_texture",
    "panorama_texture",
    "render_frames",
]

# Triangles over the 8 corners in cube_corners() ordering: index bit layout
# 4*(x>0) + 2*(y>0) + (z>0). Two triangles per face.
BOX_FACES = np.array(
    [
        [0, 1, 3], [0, 3, 2],  # -x
        [4, 6, 7], [4, 7, 5],  # +x
        [0, 4, 5], [0, 5, 1],  # -y
        [2, 3, 7], [2, 7, 6],  # +y
        [0, 2, 6], [0, 6, 4],  # -z
        [1, 5, 7], [1, 7, 3],  # +z
    ],
    dtype=np.int64,
)

_CORNER_SIGNS = np.array(
    [
        [-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
        [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1],
    ],
    dtype=np.float32,
)

# face index of each triangle (two triangles per face, in BOX_FACES order)
_TRI_FACE = np.arange(12, dtype=np.int64) // 2

# per-triangle corner UVs inside the face's unit square: every face's quad
# is listed cyclically [a, b, c, d] as triangles [a, b, c], [a, c, d], so
# a=(0,0), b=(1,0), c=(1,1), d=(0,1) for all of them
_TRI_UV = np.array(
    [[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]] * 6,
    dtype=np.float32,
)  # (12, 3, 2)


def box_vertices(half_extents: torch.Tensor) -> torch.Tensor:
    """(..., 3) half extents -> (..., 8, 3) corners, cube_corners ordering."""
    signs = torch.as_tensor(_CORNER_SIGNS, device=half_extents.device)
    return half_extents[..., None, :] * signs


def shape_vertices(half_extents, shape: str) -> np.ndarray:
    """(3,) half extents -> (8, 3) numpy vertices for 'box' | 'wedge' |
    'pyramid': 8-vertex deformations of the box (collapsed faces become
    degenerate triangles, which the rasterizer culls by area). Odd indices
    are the +z (top) corners."""
    v = _CORNER_SIGNS * np.asarray(half_extents)[None, :]
    if shape == "box":
        return v
    if shape == "wedge":  # triangular prism: top corners pinch to a y=0 ridge
        v[[1, 3, 5, 7], 1] = 0.0
        return v
    if shape == "pyramid":  # top face collapses to the apex point
        v[[1, 3, 5, 7], 0] = 0.0
        v[[1, 3, 5, 7], 1] = 0.0
        return v
    raise ValueError(f"unknown shape {shape!r}")


# ------------------------------- random draws -------------------------------


# Each helper draws on ``gen``'s device and returns its draws on ``device``
# (default: the same), so that a CPU generator gives every device one scene.


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0, device=None) -> torch.Tensor:
    return (lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)).to(device or gen.device)


def sample_value_noise(gen: torch.Generator, cells: int = 8, device=None) -> torch.Tensor:
    """:func:`value_noise`'s coarse (cells + 1, cells + 1) grid in [0, 1)."""
    return _uniform(gen, (cells + 1, cells + 1), device=device)


def _octave_grids(gen: torch.Generator, octaves: int, device) -> list[torch.Tensor]:
    return [sample_value_noise(gen, 4 * (2**i), device) for i in range(octaves)]


def sample_fbm(gen: torch.Generator, octaves: int = 3, stripes: float = 0.0, device=None) -> dict:
    """:func:`fbm_texture`'s draws: one grid per octave, and with stripes the
    stripe angle in [0, pi) and frequency in [4, 12)."""
    draws = {"grids": _octave_grids(gen, octaves, device)}
    if stripes > 0.0:
        draws["angle"] = _uniform(gen, (), 0.0, np.pi, device)
        draws["freq"] = _uniform(gen, (), 4.0, 12.0, device)
    return draws


def sample_cells(gen: torch.Generator, n_cells: int = 24, device=None) -> dict:
    """:func:`cells_texture`'s draws: (n_cells, 2) seed points and (n_cells,)
    shades in [0, 1)."""
    return {"points": _uniform(gen, (n_cells, 2), device=device), "shades": _uniform(gen, (n_cells,), device=device)}


def sample_panorama(gen: torch.Generator, octaves: int = 3, device=None) -> dict:
    """:func:`panorama_texture`'s draws: the cloud grids, the cloud amount in
    [0.15, 0.6), the cloud grey in [0.7, 1.0) and the sun's (2,) position
    draw in [0, 1)."""
    return {
        "grids": _octave_grids(gen, octaves, device),
        "cloud_amt": _uniform(gen, (), 0.15, 0.6, device),
        "cloud_gray": _uniform(gen, (), 0.7, 1.0, device),
        "sun": _uniform(gen, (2,), device=device),
    }


def sample_render(gen: torch.Generator, device=None) -> dict:
    """:func:`render_frames`' draws for its untextured background: the tint
    in [0.2, 0.8)^3 and the colour and depth noise grids."""
    return {
        "bg_tint": _uniform(gen, (3,), 0.2, 0.8, device),
        "noise": sample_value_noise(gen, device=device),
        "depth_noise": sample_value_noise(gen, device=device),
    }


# --------------------------------- textures ---------------------------------


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """f32 ``jnp.linspace``'s arithmetic: start (1 - s) + stop s with s =
    i / (num - 1), the endpoint exact."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32, device=device)])


def value_noise(grid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Smooth [0, 1] noise: bilinear upsample of the coarse ``grid``
    ((cells + 1, cells + 1), :func:`sample_value_noise`) to (h, w)."""
    cells = grid.shape[0] - 1
    ys = _linspace(0.0, cells, h, grid.device)
    xs = _linspace(0.0, cells, w, grid.device)
    y0 = torch.clamp(torch.floor(ys).long(), 0, cells - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, cells - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    g00 = grid[y0[:, None], x0[None, :]]
    g01 = grid[y0[:, None], x0[None, :] + 1]
    g10 = grid[y0[:, None] + 1, x0[None, :]]
    g11 = grid[y0[:, None] + 1, x0[None, :] + 1]
    return (1 - fy) * ((1 - fx) * g00 + fx * g01) + fy * ((1 - fx) * g10 + fx * g11)


def _fbm_field(grids: list[torch.Tensor], size: int) -> torch.Tensor:
    field = torch.zeros((size, size), device=grids[0].device)
    amp, total = 1.0, 0.0
    for grid in grids:
        field = field + amp * value_noise(grid, size, size)
        total += amp
        amp *= 0.5
    return field / total


def _lerp_palette(colors: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    return colors[0] * (1.0 - field[..., None]) + colors[1] * field[..., None]


def fbm_texture(draws: dict, size: int, colors: torch.Tensor, stripes: float = 0.0) -> torch.Tensor:
    """Procedural (size, size, 3) image texture: multi-octave value noise
    (one octave per grid of ``draws``, :func:`sample_fbm`) through the (2,
    3) palette ``colors``, optionally modulated by diagonal stripes."""
    field = _fbm_field(draws["grids"], size)
    if stripes > 0.0:
        ang, freq = draws["angle"], draws["freq"]
        xs = _linspace(0.0, 1.0, size, field.device)
        phase = torch.cos(ang) * xs[None, :] + torch.sin(ang) * xs[:, None]
        field = field * (1.0 - stripes / 2 + stripes / 2 * torch.sin(2 * np.pi * freq * phase))
    return _lerp_palette(colors, torch.clamp(field, 0.0, 1.0))


def cells_texture(draws: dict, size: int, colors: torch.Tensor) -> torch.Tensor:
    """Voronoi-style cellular (size, size, 3) tile from the seed points and
    shades of ``draws`` (:func:`sample_cells`): toroidal distances (the tile
    is seamless), a shade per cell, darkened cell borders."""
    pts, shades = draws["points"], draws["shades"]
    ys = _linspace(0.0, 1.0, size, pts.device)
    yy, xx = torch.meshgrid(ys, ys, indexing="ij")
    dy = torch.abs(yy[..., None] - pts[None, None, :, 0])
    dy = torch.minimum(dy, 1.0 - dy)
    dx = torch.abs(xx[..., None] - pts[None, None, :, 1])
    dx = torch.minimum(dx, 1.0 - dx)
    d2 = dy * dy + dx * dx
    field = shades[torch.argmin(d2, dim=-1)]
    d_sorted = torch.sort(d2, dim=-1).values
    edge = torch.clamp((torch.sqrt(d_sorted[..., 1]) - torch.sqrt(d_sorted[..., 0])) / 0.04, 0.0, 1.0)
    field = torch.clamp(field * (0.55 + 0.45 * edge), 0.0, 1.0)
    return _lerp_palette(colors, field)


def panorama_texture(draws: dict, size: int, colors: torch.Tensor) -> torch.Tensor:
    """Procedural equirect sky panorama from ``draws``
    (:func:`sample_panorama`): a zenith -> nadir gradient between the palette
    endpoints, clouds, a bright horizon band at v = 0.5 and a sun disk with
    glow. Rows are elevation (0 = zenith), columns azimuth."""
    dev = colors.device
    v = _linspace(0.0, 1.0, size, dev)[:, None]
    base = colors[0][None, None] * (1.0 - v)[..., None] + colors[1][None, None] * v[..., None]
    field = _fbm_field(draws["grids"], size)
    cloud_col = torch.ones(3, device=dev) * draws["cloud_gray"]
    w = torch.clamp((field - 0.55) / 0.25, 0.0, 1.0) * draws["cloud_amt"]
    img = base * (1.0 - w[..., None]) + cloud_col[None, None] * w[..., None]
    img = img + 0.25 * torch.exp(-(((v - 0.5) / 0.08) ** 2))[..., None]
    su = draws["sun"]
    sun_u, sun_v = su[0], 0.1 + 0.35 * su[1]  # sun in the upper half
    u = _linspace(0.0, 1.0, size, dev)[None, :]
    du = torch.abs(u - sun_u)
    du = torch.minimum(du, 1.0 - du)  # azimuth wraps
    d2 = du * du + (v - sun_v) ** 2
    img = img + (1.5 * torch.exp(-d2 / 4e-4) + 0.3 * torch.exp(-d2 / 0.02))[..., None]
    return torch.clamp(img, 0.0, 1.0)


def _bilinear(tex: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    s = tex.shape[0]
    x0 = torch.clamp(torch.floor(x).long(), 0, s - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, s - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    t00 = tex[y0, x0]
    t01 = tex[y0, x0 + 1]
    t10 = tex[y0 + 1, x0]
    t11 = tex[y0 + 1, x0 + 1]
    return (1 - fy) * ((1 - fx) * t00 + fx * t01) + fy * ((1 - fx) * t10 + fx * t11)


def _sample_pan(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an equirect panorama: u (azimuth) wraps (a floor
    mod: u may be negative), v (elevation) clamps to [0, 1]."""
    s = tex.shape[0]
    return _bilinear(tex, torch.remainder(u, 1.0) * (s - 1), torch.clamp(v, 0.0, 1.0) * (s - 1))


def _sample_tile(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear wrap-sample of a (S, S, 3) tile at texture coords u, v (any
    real scale; 1.0 spans the tile)."""
    s = tex.shape[0]
    return _bilinear(tex, torch.remainder(u, 1.0) * (s - 1), torch.remainder(v, 1.0) * (s - 1))


def _shade(normals, base_color, light_dir, view_dir, spec_strength, shininess, light_intensity):
    """Two-sided Blinn-Phong: (..., 3) normals, albedo and unit vectors from
    the surface toward the camera."""
    lam = torch.abs(normals @ light_dir)
    out = base_color * light_intensity * (0.35 + 0.65 * lam[..., None])
    half = light_dir + view_dir
    half = half / (torch.linalg.vector_norm(half, dim=-1, keepdim=True) + 1e-9)
    spec = torch.abs(torch.sum(normals * half, dim=-1)) ** shininess
    out = out + spec_strength * light_intensity * spec[..., None]
    return torch.clamp(out, 0.0, 1.0)


def _gather_tri(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """x (T, 12, H, W) at the triangle index best (T, H, W)."""
    return torch.gather(x, 1, best[:, None]).squeeze(1)


def render_frames(
    draws: dict,
    obj_rot: torch.Tensor,  # (T, O, 3, 3) object-to-world rotations
    obj_trans: torch.Tensor,  # (T, O, 3)
    half_extents: torch.Tensor,  # (O, 3)
    colors: torch.Tensor,  # (O, 3) per-object OR (O, 6, 3) per-face albedo
    active: torch.Tensor,  # (O,) 0/1 padding mask
    cam_pose7_wxyz: torch.Tensor,  # (T, 7) Blender camera-to-world
    fov: float,
    height: int,
    width: int,
    light_dir: torch.Tensor | None = None,
    far: float = 20.0,
    checker: float = 0.3,
    verts_local: torch.Tensor | None = None,
    spec_strength: float = 0.0,
    shininess: float = 32.0,
    light_intensity: float = 1.0,
    ground: bool = False,
    shadow_strength: float = 0.0,
    sky_texture: torch.Tensor | None = None,
    ground_texture: torch.Tensor | None = None,
    ground_tex_scale: float = 4.0,
    sky_mode: str = "tile",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Renders T frames of O convex 8-vertex solids, on the inputs' device.

    ``draws``: :func:`sample_render`'s dict. Returns (rgb (T, H, W, 3) in
    [0, 1], depth (T, H, W) camera-frame z, seg (T, H, W) int32 with
    instance index + 1, background 0). Options as the JAX function's:
    per-face ``colors``, the ``checker`` amplitude (0 disables),
    ``verts_local`` (O, 8, 3) in place of the box corners, Blinn-Phong
    ``spec_strength`` / ``shininess``, the ray-cast ``ground`` plane with
    box shadows of strength ``shadow_strength``, and the ``sky_texture`` /
    ``ground_texture`` tiles (``sky_mode`` "pan" samples the sky as an
    equirect panorama).
    """
    t, o = obj_rot.shape[:2]
    dev, dtype = obj_trans.device, obj_trans.dtype
    if colors.dim() == 2:  # per-object albedo -> same albedo on all six faces
        colors = colors[:, None, :].expand(colors.shape[0], 6, 3)
    if light_dir is None:
        light_dir = torch.tensor([0.3, -0.5, 0.8], dtype=dtype, device=dev)
    light_dir = light_dir / torch.linalg.vector_norm(light_dir)

    k = camera.intrinsics_from_fov(torch.tensor(fov, dtype=dtype, device=dev), height, width)
    faces = torch.as_tensor(BOX_FACES, device=dev)
    if verts_local is None:
        verts_local = box_vertices(half_extents)  # (O, 8, 3)
    active_host = [bool(a) for a in (active.cpu() > 0.5)]

    # static fallback background (no textures): smooth coloured noise
    noise = value_noise(draws["noise"], height, width)
    flat_bg_rgb = torch.clamp(draws["bg_tint"][None, None, :] * (0.5 + 0.7 * noise[..., None]), 0.0, 1.0)
    bg_depth = far * (0.9 + 0.2 * value_noise(draws["depth_noise"], height, width))

    cam_cv = camera.blender_to_opencv_pose(lie.pose7_wxyz_to_se3(cam_pose7_wxyz))
    cam_rot, cam_trans = cam_cv.rot, cam_cv.trans  # (T, 3, 3), (T, 3)

    ys = torch.arange(height, dtype=dtype, device=dev)
    xs = torch.arange(width, dtype=dtype, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W) pixel v, u
    # unnormalised camera-frame ray directions with z = 1: the ray parameter
    # is the camera z-depth
    dirs_cam = torch.stack([(px - k.cx) / k.fx, (py - k.cy) / k.fy, torch.ones_like(px)], dim=-1)

    def background():
        """Ray-cast background of every frame: the sky dome and the z = 0
        ground plane with cast shadows. Returns (rgb, depth)."""
        d_world = torch.einsum("tij,hwj->thwi", cam_rot, dirs_cam)
        dz = d_world[..., 2]
        t_g = -cam_trans[:, 2, None, None] / torch.where(dz < -1e-6, dz, -1e-6)
        hits_ground = (dz < -1e-6) & (t_g > 0.0) & (t_g < far)

        d_norm = d_world / (torch.linalg.vector_norm(d_world, dim=-1, keepdim=True) + 1e-9)
        az = torch.atan2(d_norm[..., 1], d_norm[..., 0]) / (2 * np.pi) + 0.5
        el = 0.5 - torch.asin(torch.clamp(d_norm[..., 2], -1.0, 1.0)) / np.pi
        if sky_texture is None:
            sky_rgb = flat_bg_rgb
        elif sky_mode == "pan":
            sky_rgb = _sample_pan(sky_texture, az, el)
        else:
            sky_rgb = _sample_tile(sky_texture, az * 2.0, el * 2.0)

        p = cam_trans[:, None, None, :] + t_g[..., None] * d_world  # (T, H, W, 3)
        if ground_texture is not None:
            g_tex = _sample_tile(ground_texture, p[..., 0] / ground_tex_scale, p[..., 1] / ground_tex_scale)
        else:
            g_tex = flat_bg_rgb
        g_rgb = g_tex * light_intensity * (0.45 + 0.55 * torch.abs(light_dir[2]))

        # cast shadows: from each ground point toward the light, slab-test
        # every active object's box
        shadowed = torch.zeros(p.shape[:-1], dtype=torch.bool, device=dev)
        for i in range(o):
            if not active_host[i]:
                continue
            rot_o, he_o = obj_rot[:, i], half_extents[i]  # (T, 3, 3), (3,)
            q = torch.einsum("tji,thwj->thwi", rot_o, p - obj_trans[:, i, None, None, :])
            d = torch.einsum("tji,j->ti", rot_o, light_dir)
            inv = 1.0 / torch.where(torch.abs(d) > 1e-6, d, torch.where(d >= 0, 1e-6, -1e-6))
            inv = inv[:, None, None, :]
            t1 = (-he_o - q) * inv
            t2 = (he_o - q) * inv
            tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
            tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
            shadowed |= tmax >= torch.clamp_min(tmin, 1e-3)
        g_rgb = g_rgb * (1.0 - shadow_strength * shadowed[..., None])

        rgb = torch.where(hits_ground[..., None], g_rgb, sky_rgb)
        depth = torch.where(hits_ground, t_g, bg_depth)
        return torch.clamp(rgb, 0.0, 1.0), depth

    verts_world = torch.einsum("toij,ovj->tovi", obj_rot, verts_local) + obj_trans[:, :, None, :]
    verts_cam = torch.einsum("tji,tovj->tovi", cam_rot, verts_world - cam_trans[:, None, None, :])
    z = verts_cam[..., 2]  # (T, O, 8)
    uv = camera.project(k, verts_cam)  # (T, O, 8, 2)

    # per-triangle world normals and shaded colours
    tri_w = verts_world[:, :, faces]  # (T, O, 12, 3, 3)
    n = torch.linalg.cross(tri_w[..., 1, :] - tri_w[..., 0, :], tri_w[..., 2, :] - tri_w[..., 0, :])
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)
    tri_albedo = colors[:, torch.as_tensor(_TRI_FACE, device=dev)]  # (O, 12, 3)
    view = cam_trans[:, None, None, :] - torch.mean(tri_w, dim=-2)
    view = view / (torch.linalg.vector_norm(view, dim=-1, keepdim=True) + 1e-9)
    face_colors = _shade(n, tri_albedo, light_dir, view, spec_strength, shininess, light_intensity)

    if ground or sky_texture is not None:
        cbuf, zbuf = background()
    else:
        cbuf = flat_bg_rgb.expand(t, height, width, 3).clone()
        zbuf = bg_depth.expand(t, height, width).clone()
    sbuf = torch.zeros((t, height, width), dtype=torch.int32, device=dev)
    uv_tri = torch.as_tensor(_TRI_UV, device=dev)
    gx, gy = px[None, None], py[None, None]  # (1, 1, H, W)

    for i in range(o):
        if not active_host[i]:
            continue  # never inside any triangle: loses every depth test
        o_uv, o_z = uv[:, i], z[:, i]  # (T, 8, 2), (T, 8)
        a, b, c = (o_uv[:, faces[:, j]][..., None, None] for j in range(3))  # (T, 12, 2, 1, 1)
        za, zb, zc = (o_z[:, faces[:, j]] for j in range(3))  # (T, 12)

        def edge(p, q):
            # (T, 12, H, W): cross(q - p, px - p)
            d = q - p
            return d[:, :, 0] * (gy - p[:, :, 1]) - d[:, :, 1] * (gx - p[:, :, 0])

        e_ab = edge(a, b)
        e_bc = edge(b, c)
        e_ca = edge(c, a)
        area = e_ab + e_bc + e_ca  # signed 2x area, constant per triangle
        valid_tri = (torch.abs(area[..., 0, 0]) > 1e-8) & (za > 1e-3) & (zb > 1e-3) & (zc > 1e-3)
        s = torch.sign(area[..., 0:1, 0:1])
        inside = (e_ab * s >= 0) & (e_bc * s >= 0) & (e_ca * s >= 0) & valid_tri[..., None, None]

        # perspective-correct depth: interpolate 1/z with screen barycentrics
        inv_area = 1.0 / torch.where(torch.abs(area) > 1e-8, area, 1.0)
        lam_a = e_bc * inv_area
        lam_b = e_ca * inv_area
        lam_c = e_ab * inv_area
        inv_z = (
            lam_a * (1.0 / za)[..., None, None]
            + lam_b * (1.0 / zb)[..., None, None]
            + lam_c * (1.0 / zc)[..., None, None]
        )
        tri_z = torch.where(inside, 1.0 / torch.clamp_min(inv_z, 1e-6), torch.inf)

        # nearest triangle of this object per pixel (first index on ties)
        best = torch.argmin(tri_z, dim=1)  # (T, H, W)
        best_z = _gather_tri(tri_z, best)
        best_rgb = torch.gather(
            face_colors[:, i], 1, best.reshape(t, -1, 1).expand(-1, -1, 3)
        ).reshape(t, height, width, 3)

        if checker > 0.0:
            # perspective-correct face UVs: interpolate uv/z, divide by 1/z
            inv_zc = torch.clamp_min(inv_z, 1e-6)
            cell = 0.0
            for j in range(2):
                uq = (
                    lam_a * (uv_tri[:, 0, j] / za)[..., None, None]
                    + lam_b * (uv_tri[:, 1, j] / zb)[..., None, None]
                    + lam_c * (uv_tri[:, 2, j] / zc)[..., None, None]
                )
                cell = cell + torch.floor(_gather_tri(uq / inv_zc, best) * 2)
            cell = torch.remainder(cell, 2.0)
            best_rgb = torch.clamp(best_rgb * (1.0 - checker / 2 + checker * cell)[..., None], 0.0, 1.0)

        win = best_z < zbuf
        zbuf = torch.where(win, best_z, zbuf)
        cbuf = torch.where(win[..., None], best_rgb, cbuf)
        sbuf = torch.where(win, i + 1, sbuf)
    return cbuf, zbuf, sbuf
