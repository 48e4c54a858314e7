"""The training scene and the camera orbit, in numpy.

A fixed arrangement of three Lambertian spheres inside the Blender camera
orbit (near 2, far 6, cameras at radius 4, ``camera_angle_x`` 0.6911),
ray traced analytically: every view agrees with every other, as a
``nerf_synthetic`` scene's do. The views' poses are drawn from the seed as
the scene writer of the program draws them (theta uniform over [0, 360),
phi over [-60, -10) degrees). Pixels are rounded to 8-bit codes, as a PNG
holds them, and composited on white.
"""

from __future__ import annotations

import math

import numpy as np

BLENDER_FOV = 0.6911112070083618
# (centre xyz, radius, albedo rgb)
SPHERES = (
    ((0.0, 0.0, 0.0), 0.9, (0.85, 0.25, 0.2)),
    ((0.8, 0.8, 0.3), 0.45, (0.2, 0.7, 0.9)),
    ((-0.8, -0.5, 0.5), 0.35, (0.95, 0.85, 0.2)),
)
LIGHT_DIR = np.array([0.5, 0.6, 0.62])


def focal_from_fov(fov: float, width: int) -> float:
    return 0.5 * float(width) / math.tan(0.5 * float(fov))


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world ``[4, 4]`` of the orbit (degrees), keras_nerf's
    ``pose_spherical``: translate along z, tilt by phi about x, turn by
    theta about y, then swap the Blender axes."""
    t = np.eye(4)
    t[2, 3] = radius
    p, th = math.radians(phi), math.radians(theta)
    rot_phi = np.array([[1, 0, 0, 0], [0, math.cos(p), -math.sin(p), 0],
                        [0, math.sin(p), math.cos(p), 0], [0, 0, 0, 1]])
    rot_theta = np.array([[math.cos(th), 0, -math.sin(th), 0], [0, 1, 0, 0],
                          [math.sin(th), 0, math.cos(th), 0], [0, 0, 0, 1]])
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]])
    return (flip @ rot_theta @ rot_phi @ t).astype(np.float32)


def camera_rays(c2w: np.ndarray, h: int, w: int, focal: float):
    """Pinhole rays in float64, pixel ``(x, y)`` at camera coordinates
    ``((x - W/2) / f, -(y - H/2) / f, -1)``, unit directions."""
    x, y = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64), indexing="xy")
    cam = np.stack([(x - w * 0.5) / focal, -(y - h * 0.5) / focal,
                    -np.ones_like(x)], axis=-1)
    direction = cam @ np.asarray(c2w[:3, :3], np.float64).T
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    origin = np.broadcast_to(np.asarray(c2w[:3, 3], np.float64),
                             direction.shape)
    return origin, direction


def trace_spheres(origin: np.ndarray, direction: np.ndarray) -> np.ndarray:
    """``[..., 4]`` RGBA in [0, 1]: the nearest sphere's shaded albedo and
    alpha 1, or alpha 0 where a ray misses every sphere."""
    best = np.full(direction.shape[:-1], np.inf)
    color = np.zeros(direction.shape[:-1] + (3,))
    light = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)
    for centre, radius, albedo in SPHERES:
        oc = origin - np.asarray(centre)
        b = np.sum(oc * direction, axis=-1)
        disc = b * b - (np.sum(oc * oc, axis=-1) - radius ** 2)
        hit = disc > 0
        t = -b - np.sqrt(np.where(hit, disc, 0.0))
        hit &= (t > 1e-6) & (t < best)
        normal = (origin + direction * t[..., None] - np.asarray(centre))
        normal /= radius
        lambert = 0.35 + 0.65 * np.clip(np.sum(normal * light, axis=-1),
                                        0.0, 1.0)
        best = np.where(hit, t, best)
        color = np.where(hit[..., None], lambert[..., None]
                         * np.asarray(albedo), color)
    alpha = np.isfinite(best).astype(np.float64)
    return np.concatenate([np.clip(color, 0.0, 1.0), alpha[..., None]], -1)


def training_views(seed: int, n_views: int, wh: int):
    """``(images [N, wh, wh, 4] float32, poses [N, 4, 4] float32, focal)``:
    ``n_views`` views of the spheres, RGB composited on white, alpha
    kept."""
    rng = np.random.default_rng(seed)
    poses = np.stack([pose_spherical(rng.uniform(0.0, 360.0),
                                     rng.uniform(-60.0, -10.0), 4.0)
                      for _ in range(n_views)])
    focal = focal_from_fov(BLENDER_FOV, wh)
    images = np.empty((n_views, wh, wh, 4), np.float32)
    for i, c2w in enumerate(poses):
        rgba = trace_spheres(*camera_rays(c2w, wh, wh, focal))
        rgba = np.round(rgba * 255.0) / 255.0
        alpha = rgba[..., 3:]
        images[i] = np.concatenate([rgba[..., :3] * alpha + (1.0 - alpha),
                                    alpha], -1)
    return images, poses, focal


def orbit_poses(traffic: dict) -> np.ndarray:
    """The orbit of the inference CLI: one pose every ``360 / frames``
    degrees of theta at the traffic's phi and radius."""
    n = traffic["frames"]
    return np.stack([pose_spherical(360.0 * i / n, traffic["phi"],
                                    traffic["radius"]) for i in range(n)])
