"""Per-pixel pinhole rays (port of ``keras_nerf_tpu/data/rays.py``).

Camera coords ``x_c = (x - W/2) / f``, ``y_c = (y - H/2) / f`` (no
half-pixel offset), camera vector ``[x_c, -y_c, -1]``, world direction
``R v`` normalized, origin the camera position; stratified depths from a
``torch.Generator`` (`keras_nerf/data/rays.py:69-130`). The rotation and the
norm are float32 multiply-add chains in the order XLA compiles the JAX
package's ``einsum`` and ``linalg.norm`` to, one rounding per step, so the
rays are the JAX package's bit for bit (never a TF32 matmul).

:func:`sample_random_ray_batch` is the pixel-sampling mode's batch: rays
at random (image, pixel) pairs across a whole split.
"""

from __future__ import annotations

import torch

from keras_nerf_tpu_torch.ops.sampling import (fma_f32,
                                               stratified_sample_points)


def _rotate_and_normalize(rotation: torch.Tensor,
                          cam: torch.Tensor) -> torch.Tensor:
    """Unit ``R v`` for rotations ``[..., 3, 3]`` and camera vectors
    ``[..., 3]``: ``fma(v2, R[:, 2], fma(v1, R[:, 1], v0 R[:, 0]))``, the
    squared norm ``fma(d2, d2, fma(d1, d1, d0 d0))``, its square root
    rounded once (taken in float64: ``torch.sqrt`` on float32 CPU tensors
    is not always correctly rounded) and one division."""
    v = [cam[..., j, None] for j in range(3)]
    col = [rotation[..., :, j] for j in range(3)]
    d = fma_f32(v[2], col[2], fma_f32(v[1], col[1], v[0] * col[0]))
    sq = fma_f32(d[..., 2], d[..., 2],
                 fma_f32(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
    norm = torch.sqrt(sq.to(torch.float64)).to(torch.float32)
    return d / norm[..., None]


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
    directions, float32 (as the JAX package computes them)."""
    camera2world = torch.as_tensor(camera2world, dtype=torch.float32)
    cam = camera_plane_directions(image_height, image_width, focal,
                                  camera2world.device)
    direction = _rotate_and_normalize(camera2world[:3, :3], cam)
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


def sample_random_ray_batch(images: torch.Tensor, poses: torch.Tensor,
                            generator: torch.Generator | None = None, *,
                            batch: int, image_height: int, image_width: int,
                            focal: float, near: float, far: float,
                            n_samples: int, flat: torch.Tensor | None = None,
                            points: torch.Tensor | None = None,
                            rotate=_rotate_and_normalize):
    """A training batch of ``batch * H * W`` rays at random (image, pixel)
    pairs across the whole split: the pixel-sampling mode
    (`keras_nerf_tpu/data/rays.py:105-155`), whose every step sees rays of
    every view.

    Args:
      images: ``[N, H, W, C]`` and poses ``[N, 4, 4]``, on one device; the
        batch is made there.
      generator: draws the flat pixel indices (uniform over ``N H W``) and
        then the stratified depths, on the images' device.
      flat: the flat indices ``[batch H W]`` (``image H W + y W + x``)
        instead of drawing them; ``points`` the depths ``[batch H W,
        n_samples]`` likewise (a test feeds the JAX package's draws).
      rotate: ``(rotations [R, 3, 3], camera vectors [R, 3]) -> unit
        directions [R, 3]``; ROADMAP C15's diagnostic passes the TPU's
        bf16-operand form (``tpu_rays``).

    Returns ``(pixels [batch, H, W, C], (origin, direction [batch, H, W,
    3], points [batch, H, W, n_samples]))``: a batch of "virtual images"
    with the shapes of a whole-image batch. Pixel-wise losses and PSNR are
    exact; SSIM over scrambled pixels is not meaningful.
    """
    h, w = image_height, image_width
    n = images.shape[0]
    r = batch * h * w
    device = images.device
    if flat is None:
        flat = torch.randint(0, n * h * w, (r,), generator=generator,
                             device=device)
    flat = torch.as_tensor(flat, dtype=torch.int64, device=device)
    img_idx = flat // (h * w)
    py = (flat // w) % h
    px = flat % w
    pixels = images[img_idx, py, px]
    c2w = torch.as_tensor(poses, dtype=torch.float32, device=device)[img_idx]
    x_c = (px.to(torch.float32) - w * 0.5) / focal
    y_c = (py.to(torch.float32) - h * 0.5) / focal
    cam = torch.stack([x_c, -y_c, -torch.ones_like(x_c)], dim=-1)
    direction = rotate(c2w[:, :3, :3], cam)
    origin = c2w[:, :3, -1]
    if points is None:
        points = stratified_sample_points(generator, (r,), n_samples, near,
                                          far)
    points = torch.as_tensor(points, dtype=torch.float32, device=device)
    shape = (batch, h, w)
    return (pixels.reshape(*shape, images.shape[-1]),
            (origin.reshape(*shape, 3), direction.reshape(*shape, 3),
             points.reshape(*shape, n_samples)))
