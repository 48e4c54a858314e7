"""Synthetic Blender-format scene generator (a copy of
``keras_nerf_tpu/data/synthetic.py``, kept here so the port never imports
the JAX package: numpy ray tracing, PIL imported only to write PNGs, and
:func:`random_ray_batch` drawn from a ``torch.Generator``).

Produces a tiny ray-traced scene in the exact directory layout of
`nerf_synthetic` (``transforms_{train,val,test}.json`` + RGBA PNGs), so the
full pipeline — loader, training, inference, monitors — runs hermetically with
no dataset download (the reference's tests require the real lego scene on
disk; SURVEY.md §4 calls for synthetic fixtures instead).

The scene is a fixed arrangement of colored Lambertian spheres inside the
standard Blender camera orbit (near=2, far=6, cameras at radius ~4). Sphere
geometry is analytic, so ground truth is exact and view-consistent — a NeRF
trained on it must reproduce it, which gives tests and benchmarks a real
signal (PSNR climbing) rather than noise fitting.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from keras_nerf_tpu_torch.data.utils import get_focal_from_fov, pose_spherical

# (center xyz, radius, albedo rgb)
_SPHERES = (
    ((0.0, 0.0, 0.0), 0.9, (0.85, 0.25, 0.2)),
    ((0.8, 0.8, 0.3), 0.45, (0.2, 0.7, 0.9)),
    ((-0.8, -0.5, 0.5), 0.35, (0.95, 0.85, 0.2)),
)
_LIGHT_DIR = np.array([0.5, 0.6, 0.62])
_BLENDER_FOV = 0.6911112070083618  # camera_angle_x used by nerf_synthetic

# ---------------------------------------------------------------------------
# The "hard" scene (VERDICT r3 #2): built to BREAK conclusions drawn on the
# easy sphere scene. Thin rods are SUB-VOXEL at a 128^3 occupancy grid over
# the default [-2, 2]^3 AABB (voxel 0.03125 > rod thickness 0.024), the
# checkerboard ground plane is high-frequency radiance (~4-6 px per square
# at 128^2 with hard cast shadows on top), the sphere pair + rod fence give
# heavy mutual occlusion, and the big sphere carries a Blinn-Phong specular
# lobe so radiance is view-DEPENDENT (exercises the direction head). All
# geometry stays analytic, so ground truth is exact and view-consistent.

_HARD_SPHERES = (
    # (center, radius, albedo, specular strength)
    ((0.15, 0.10, -0.05), 0.55, (0.80, 0.30, 0.25), 0.35),
    ((-0.75, 0.55, -0.30), 0.30, (0.25, 0.55, 0.90), 0.0),
)
# Axis-aligned thin boxes: (lo xyz, hi xyz). A fence of 5 vertical rods, 2
# horizontal cross-bars, and one long rod crossing over the big sphere.
_HARD_ROD_HALF = 0.012  # half-thickness: 0.024 < one 128^3 voxel (0.03125)


def _hard_rods():
    h = _HARD_ROD_HALF
    rods = []
    for x in (-1.0, -0.5, 0.0, 0.5, 1.0):  # vertical fence at y = -0.85
        rods.append(((x - h, -0.85 - h, -0.60), (x + h, -0.85 + h, 0.55)))
    for z in (0.0, 0.40):  # horizontal cross-bars through the fence
        rods.append(((-1.05, -0.85 - h, z - h), (1.05, -0.85 + h, z + h)))
    # one rod along y, passing just above the big sphere
    rods.append(((0.70 - h, -1.00, 0.55 - h), (0.70 + h, 1.00, 0.55 + h)))
    return tuple(rods)


_HARD_RODS = _hard_rods()
_HARD_ROD_ALBEDO = np.array([0.95, 0.80, 0.15])
_HARD_PLANE_Z = -0.60        # ground plane height
_HARD_PLANE_HALF = 1.40      # |x|,|y| extent
_HARD_CHECKER = 0.175        # checker square size (world units)
_HARD_CHECKER_ALBEDO = (np.array([0.92, 0.92, 0.92]),
                        np.array([0.10, 0.10, 0.12]))


def _trace(origin: np.ndarray, direction: np.ndarray) -> np.ndarray:
    """Ray-trace the sphere scene -> ``[H, W, 4]`` float RGBA in [0, 1]."""
    h, w, _ = direction.shape
    best_t = np.full((h, w), np.inf, dtype=np.float64)
    color = np.zeros((h, w, 3), dtype=np.float64)
    alpha = np.zeros((h, w), dtype=np.float64)
    light = _LIGHT_DIR / np.linalg.norm(_LIGHT_DIR)

    for center, radius, albedo in _SPHERES:
        oc = origin - np.asarray(center)
        b = np.sum(oc * direction, axis=-1)
        c = np.sum(oc * oc, axis=-1) - radius ** 2
        disc = b * b - c
        hit = disc > 0
        sqrt_disc = np.sqrt(np.where(hit, disc, 0.0))
        t = -b - sqrt_disc
        hit &= (t > 1e-6) & (t < best_t)
        point = origin + direction * t[..., None]
        normal = (point - np.asarray(center)) / radius
        lambert = 0.35 + 0.65 * np.clip(np.sum(normal * light, axis=-1), 0, 1)
        shaded = lambert[..., None] * np.asarray(albedo)
        best_t = np.where(hit, t, best_t)
        color = np.where(hit[..., None], shaded, color)
        alpha = np.where(hit, 1.0, alpha)

    return np.concatenate(
        [np.clip(color, 0, 1), alpha[..., None]], axis=-1).astype(np.float32)


def _hit_spheres_t(origin, direction, spheres):
    """Nearest sphere-hit distance per ray; inf where missed."""
    best = np.full(direction.shape[:-1], np.inf, dtype=np.float64)
    for center, radius, *_ in spheres:
        oc = origin - np.asarray(center)
        b = np.sum(oc * direction, axis=-1)
        c = np.sum(oc * oc, axis=-1) - radius ** 2
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.where(hit, disc, 0.0))
        hit &= t > 1e-6
        best = np.where(hit, np.minimum(best, t), best)
    return best


def _hit_box_t(origin, direction, lo, hi):
    """Slab-method AABB entry distance per ray; inf where missed."""
    inv = 1.0 / np.where(np.abs(direction) < 1e-12,
                         np.copysign(1e-12, direction), direction)
    t0 = (np.asarray(lo) - origin) * inv
    t1 = (np.asarray(hi) - origin) * inv
    t_near = np.max(np.minimum(t0, t1), axis=-1)
    t_far = np.min(np.maximum(t0, t1), axis=-1)
    hit = (t_near <= t_far) & (t_far > 1e-6) & (t_near > 1e-6)
    return np.where(hit, t_near, np.inf)


def _shadowed(points):
    """Binary directional-light visibility over the hard scene's occluders."""
    light = _LIGHT_DIR / np.linalg.norm(_LIGHT_DIR)
    o = points + 1e-4 * light
    d = np.broadcast_to(light, o.shape)
    t = _hit_spheres_t(o, d, _HARD_SPHERES)
    for lo, hi in _HARD_RODS:
        t = np.minimum(t, _hit_box_t(o, d, lo, hi))
    return np.isfinite(t)


def _trace_hard(origin: np.ndarray, direction: np.ndarray) -> np.ndarray:
    """Ray-trace the adversarial scene -> ``[H, W, 4]`` float RGBA in [0, 1].

    Nearest-hit over spheres + thin rods + checkerboard plane, Lambertian
    shading with hard cast shadows, plus a view-dependent Blinn-Phong lobe
    on the big sphere."""
    shape = direction.shape[:-1]
    light = _LIGHT_DIR / np.linalg.norm(_LIGHT_DIR)
    best_t = np.full(shape, np.inf, dtype=np.float64)
    normal = np.zeros(shape + (3,), dtype=np.float64)
    albedo = np.zeros(shape + (3,), dtype=np.float64)
    spec = np.zeros(shape, dtype=np.float64)

    for center, radius, alb, spec_k in _HARD_SPHERES:
        oc = origin - np.asarray(center)
        b = np.sum(oc * direction, axis=-1)
        c = np.sum(oc * oc, axis=-1) - radius ** 2
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.where(hit, disc, 0.0))
        hit &= (t > 1e-6) & (t < best_t)
        point = origin + direction * t[..., None]
        n = (point - np.asarray(center)) / radius
        best_t = np.where(hit, t, best_t)
        normal = np.where(hit[..., None], n, normal)
        albedo = np.where(hit[..., None], np.asarray(alb), albedo)
        spec = np.where(hit, spec_k, spec)

    for lo, hi in _HARD_RODS:
        t = _hit_box_t(origin, direction, lo, hi)
        hit = t < best_t
        point = origin + direction * t[..., None]
        # face normal: the axis whose slab the entry point sits on
        mid = (np.asarray(lo) + np.asarray(hi)) * 0.5
        half = (np.asarray(hi) - np.asarray(lo)) * 0.5
        rel = (point - mid) / half
        axis = np.argmax(np.abs(rel), axis=-1)
        n = np.sign(np.take_along_axis(rel, axis[..., None], -1)) * np.eye(
            3, dtype=np.float64)[axis]
        best_t = np.where(hit, t, best_t)
        normal = np.where(hit[..., None], n, normal)
        albedo = np.where(hit[..., None], _HARD_ROD_ALBEDO, albedo)
        spec = np.where(hit, 0.0, spec)

    # Checkerboard ground plane z = _HARD_PLANE_Z, |x|,|y| <= half.
    dz = direction[..., 2]
    t = np.where(np.abs(dz) > 1e-12,
                 (_HARD_PLANE_Z - origin[..., 2]) / dz, np.inf)
    point = origin + direction * t[..., None]
    hit = ((t > 1e-6) & (t < best_t)
           & (np.abs(point[..., 0]) <= _HARD_PLANE_HALF)
           & (np.abs(point[..., 1]) <= _HARD_PLANE_HALF))
    checker = (np.floor(point[..., 0] / _HARD_CHECKER)
               + np.floor(point[..., 1] / _HARD_CHECKER)).astype(np.int64) % 2
    plane_alb = np.where(checker[..., None] == 0,
                         _HARD_CHECKER_ALBEDO[0], _HARD_CHECKER_ALBEDO[1])
    best_t = np.where(hit, t, best_t)
    normal = np.where(hit[..., None], np.array([0.0, 0.0, 1.0]), normal)
    albedo = np.where(hit[..., None], plane_alb, albedo)
    spec = np.where(hit, 0.0, spec)

    alpha = np.isfinite(best_t)
    point = origin + direction * np.where(alpha, best_t, 0.0)[..., None]
    lit = ~_shadowed(point) & alpha
    lambert = np.clip(np.sum(normal * light, axis=-1), 0.0, 1.0)
    shade = 0.30 + 0.70 * lambert * lit
    color = shade[..., None] * albedo
    # Blinn-Phong specular (view-dependent), shadow-masked like the diffuse.
    halfway = light - direction
    halfway /= np.maximum(np.linalg.norm(halfway, axis=-1, keepdims=True),
                          1e-12)
    spec_term = spec * lit * np.clip(
        np.sum(normal * halfway, axis=-1), 0.0, 1.0) ** 32
    color = color + spec_term[..., None]

    return np.concatenate(
        [np.clip(color, 0, 1) * alpha[..., None],
         alpha[..., None].astype(np.float64)], axis=-1).astype(np.float32)


_TRACERS = {"spheres": _trace, "hard": _trace_hard}


def _camera_rays(c2w: np.ndarray, h: int, w: int, focal: float,
                 offset: float = 0.0):
    """Host-side pinhole rays matching :mod:`keras_nerf_tpu_torch.data.rays`.

    ``offset`` shifts every pixel coordinate (used by supersampling so the
    box-filter footprint is CENTERED on the base pixel's ray)."""
    x, y = np.meshgrid(np.arange(w, dtype=np.float64) - offset,
                       np.arange(h, dtype=np.float64) - offset,
                       indexing="xy")
    x_c = (x - w * 0.5) / focal
    y_c = (y - h * 0.5) / focal
    cam = np.stack([x_c, -y_c, -np.ones_like(x_c)], axis=-1)
    direction = np.einsum("ij,hwj->hwi", c2w[:3, :3].astype(np.float64), cam)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    origin = np.broadcast_to(c2w[:3, -1].astype(np.float64), direction.shape)
    return origin, direction


def render_pose(c2w: np.ndarray, image_wh: int,
                supersample: int = 1, scene: str = "spheres",
                scale: float = 1.0) -> np.ndarray:
    """Render one ground-truth RGBA frame for a camera-to-world matrix.

    ``supersample > 1`` traces at that multiple and box-downsamples —
    antialiased, view-CONSISTENT edges like Blender's renders of
    `nerf_synthetic` (point-sampled hard silhouettes are not representable
    by any radiance field and cap the scene's reachable PSNR at ~29 dB).

    ``scene`` picks the fixture: ``"spheres"`` (easy Lambertian default) or
    ``"hard"`` (thin sub-voxel rods, checkerboard plane, cast shadows,
    specular — the adversarial fixture).

    ``scale`` uniformly scales the WORLD (geometry and camera orbit
    together: ``c2w``'s translation must already carry the scaled orbit
    radius). Images are identical at every scale — only the world
    coordinates the NeRF trains in change — which makes scaled scenes the
    clean fixture for `--occupancy_aabb` (scale 2 pushes the outer spheres
    past the default [-2, 2]^3 grid box; inference.py's help: the flag
    exists for 'scenes outside Blender scale'). Implemented by tracing in
    unit scale from the down-scaled camera (a uniform world scale leaves
    unit ray directions unchanged)."""
    ss = max(int(supersample), 1)
    focal = get_focal_from_fov(_BLENDER_FOV, image_wh * ss)
    if scale != 1.0:
        c2w = np.array(c2w, dtype=np.float64)
        c2w[:3, -1] = c2w[:3, -1] / scale
    # Sub-sample k of base pixel i sits at fine coordinate ss*i + k; the
    # box filter's mean is ss*i + (ss-1)/2, i.e. HALF A PIXEL past the
    # base ray at coordinate i (data/rays.py uses no half-pixel offset).
    # Shifting the fine grid by (ss-1)/2 centers every footprint exactly
    # on its base pixel's training/eval ray.
    origin, direction = _camera_rays(c2w, image_wh * ss, image_wh * ss,
                                     focal, offset=(ss - 1) / 2.0)
    rgba = _TRACERS[scene](origin, direction)
    if ss == 1:
        return rgba
    return rgba.reshape(image_wh, ss, image_wh, ss, 4).mean(
        axis=(1, 3)).astype(np.float32)


def random_ray_batch(batch: int, height: int, width: int, n_coarse: int,
                     generator: torch.Generator, near: float = 2.0,
                     far: float = 6.0):
    """A random ``(images, (origin, direction, points))`` training batch on
    the generator's device: uniform RGBA pixels, the origin (0, 0, 4), unit
    normal directions and sorted uniform depths in ``[near, far]``."""
    kw = dict(generator=generator, device=generator.device)
    images = torch.rand((batch, height, width, 4), **kw)
    origin = torch.tensor([0.0, 0.0, 4.0], device=generator.device).expand(
        batch, height, width, 3).contiguous()
    d = torch.randn((batch, height, width, 3), **kw)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    t = torch.sort(near + (far - near) * torch.rand(
        (batch, height, width, n_coarse), **kw), dim=-1).values
    return images, (origin, d, t)


def write_synthetic_scene(
    out_dir: str,
    image_wh: int = 64,
    n_train: int = 20,
    n_val: int = 4,
    n_test: int = 4,
    seed: int = 0,
    supersample: int = 1,
    scene: str = "spheres",
    scale: float = 1.0,
) -> str:
    """Write a Blender-format scene directory and return its path.

    ``scale`` scales the world uniformly (orbit radius ``4 * scale``,
    geometry to match — see :func:`render_pose`); train with
    ``--near 2*scale --far 6*scale`` and, for the occupancy tiers, an
    ``--occupancy_aabb`` covering ``scale * [-2, 2]^3``."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    counts = {"train": n_train, "val": n_val, "test": n_test}

    for split, n in counts.items():
        split_dir = os.path.join(out_dir, split)
        os.makedirs(split_dir, exist_ok=True)
        frames = []
        for i in range(n):
            theta = float(rng.uniform(0.0, 360.0))
            phi = float(rng.uniform(-60.0, -10.0))
            c2w = pose_spherical(theta, phi, 4.0 * scale)
            rgba = render_pose(c2w, image_wh, supersample, scene=scene,
                               scale=scale)
            # Round to the nearest 8-bit code (truncation would bias every
            # mid-tone ~0.5 LSB dark, capping the scene's reachable PSNR).
            from PIL import Image

            img = Image.fromarray(
                np.clip(np.round(rgba * 255), 0, 255).astype(np.uint8),
                mode="RGBA")
            img.save(os.path.join(split_dir, f"r_{i}.png"))
            frames.append({
                "file_path": f"./{split}/r_{i}",
                "transform_matrix": c2w.tolist(),
            })
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": _BLENDER_FOV, "frames": frames}, f)

    return out_dir
