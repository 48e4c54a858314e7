"""Per-pixel pinhole rays (port of ``keras_nerf_tpu/data/rays.py``).

Camera coords ``x_c = (x - W/2) / f``, ``y_c = (y - H/2) / f`` (no
half-pixel offset), camera vector ``[x_c, -y_c, -1]``, world direction
``R v`` normalized, origin the camera position; stratified depths from a
``torch.Generator`` (`keras_nerf/data/rays.py:69-130`). The rotation is
applied elementwise in float32, never through a TF32 matmul.
"""

from __future__ import annotations

import torch

from keras_nerf_tpu_torch.ops.sampling import stratified_sample_points


def camera_plane_directions(image_height: int, image_width: int,
                            focal: float, device: torch.device | str,
                            dtype=torch.float32) -> torch.Tensor:
    """``[H, W, 3]`` per-pixel camera-space vectors ``[x_c, -y_c, -1]`` on
    the caller's ``device``."""
    x = torch.arange(image_width, dtype=dtype, device=device)
    y = torch.arange(image_height, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    x_c = (xx - image_width * 0.5) / focal
    y_c = (yy - image_height * 0.5) / focal
    return torch.stack([x_c, -y_c, -torch.ones_like(x_c)], dim=-1)


def generate_rays(camera2world: torch.Tensor, image_height: int,
                  image_width: int, focal: float):
    """``[4, 4] -> (origin [H, W, 3], direction [H, W, 3])``, unit
    directions."""
    cam = camera_plane_directions(image_height, image_width, focal,
                                  camera2world.device, camera2world.dtype)
    rotation = camera2world[:3, :3]
    direction = (cam[..., None, :] * rotation).sum(dim=-1)
    direction = direction / torch.linalg.vector_norm(direction, dim=-1,
                                                     keepdim=True)
    origin = camera2world[:3, -1].expand(direction.shape)
    return origin, direction


def generate_ray_batch(camera2world: torch.Tensor, generator: torch.Generator,
                       *, image_height: int, image_width: int, focal: float,
                       near: float, far: float, n_samples: int):
    """``[B, 4, 4]`` poses -> ``(origin, direction [B, H, W, 3],
    points [B, H, W, N])`` on the generator's device."""
    c2w = torch.as_tensor(camera2world, dtype=torch.float32,
                          device=generator.device)
    rays = [generate_rays(m, image_height, image_width, focal) for m in c2w]
    origin = torch.stack([r[0] for r in rays])
    direction = torch.stack([r[1] for r in rays])
    points = stratified_sample_points(
        generator, (c2w.shape[0], image_height, image_width), n_samples,
        near, far)
    return origin, direction, points
