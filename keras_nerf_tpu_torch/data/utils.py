"""Camera / pose math in numpy (a copy of ``keras_nerf_tpu/data/utils.py``,
kept here so the port never imports the JAX package)."""

from __future__ import annotations

import math

import numpy as np


def get_focal_from_fov(field_of_view: float, width: int) -> float:
    """``0.5 * width / tan(0.5 * fov)`` (reference `data/utils.py:6-16`)."""
    return 0.5 * float(width) / math.tan(0.5 * float(field_of_view))


def get_translation_t(t: float) -> np.ndarray:
    """4x4 translation along +z (reference `data/utils.py:19-27`)."""
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def get_rotation_phi(phi: float) -> np.ndarray:
    """4x4 rotation about x by ``phi`` radians."""
    c, s = math.cos(phi), math.sin(phi)
    return np.array([
        [1, 0, 0, 0],
        [0, c, -s, 0],
        [0, s, c, 0],
        [0, 0, 0, 1],
    ], dtype=np.float32)


def get_rotation_theta(theta: float) -> np.ndarray:
    """4x4 rotation about y by ``theta`` radians."""
    c, s = math.cos(theta), math.sin(theta)
    return np.array([
        [c, 0, -s, 0],
        [0, 1, 0, 0],
        [s, 0, c, 0],
        [0, 0, 0, 1],
    ], dtype=np.float32)


_AXIS_FLIP = np.array([
    [-1, 0, 0, 0],
    [0, 0, 1, 0],
    [0, 1, 0, 0],
    [0, 0, 0, 1],
], dtype=np.float32)


def pose_spherical(theta: float, phi: float, t: float) -> np.ndarray:
    """Camera-to-world matrix of the 360-degree orbit (``theta``/``phi`` in
    degrees, ``t`` the z-translation; reference `data/utils.py:52-63`)."""
    c2w = get_translation_t(t)
    c2w = get_rotation_phi(phi / 180.0 * math.pi) @ c2w
    c2w = get_rotation_theta(theta / 180.0 * math.pi) @ c2w
    return _AXIS_FLIP @ c2w
