"""The rays a TPU computes at DEFAULT matmul precision (ROADMAP C15): a
diagnostic, not an option of any CLI.

The JAX package forms each ray direction ``R v`` with a ``jnp.einsum``
that names no ``precision=`` (`keras_nerf_tpu/data/rays.py:59`, ``:147``).
On a TPU a DEFAULT-precision float32 dot rounds both operands to bfloat16
(one pass, round to nearest even) and multiplies and sums them in float32.
:func:`tpu_default_rays` computes the rays so; the port's own
:func:`~keras_nerf_tpu_torch.data.rays.generate_rays` computes them at
float32 (JAX's on the CPU, bit for bit).

    python -m keras_nerf_tpu_torch.tpu_rays -- <train_single flags>

runs :func:`keras_nerf_tpu_torch.train_single.main` with the loader's
``generate_ray_batch`` swapped for :func:`tpu_ray_batch` for the whole run
(train, val and test rays; the depths are the default path's draws), then
prints the run's wall clock and, on the card, its peak allocated memory.
"""

from __future__ import annotations

import sys
import time

import torch

from keras_nerf_tpu_torch.data.rays import camera_plane_directions
from keras_nerf_tpu_torch.ops.sampling import (fma_f32,
                                               stratified_sample_points)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bfloat16 (ties to even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def tpu_default_rays(c2w: torch.Tensor, h: int, w: int, focal: float):
    """``[4, 4] -> (origin [H, W, 3], direction [H, W, 3])`` as a TPU's
    DEFAULT-precision einsum gives them: the rotation and the camera-plane
    vectors rounded to bfloat16, the products (exact in float32) summed in
    float32; then the port's norm (`data/rays.py:_rotate_and_normalize`):
    the squared norm as float32 multiply-adds, its square root rounded
    once, one division."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    r = bf16_round(c2w[:3, :3])
    v = bf16_round(camera_plane_directions(h, w, focal, c2w.device))
    d = (v[..., 0, None] * r[:, 0] + v[..., 1, None] * r[:, 1]
         + v[..., 2, None] * r[:, 2])
    sq = fma_f32(d[..., 2], d[..., 2],
                 fma_f32(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
    norm = torch.sqrt(sq.to(torch.float64)).to(torch.float32)
    direction = d / norm[..., None]
    return c2w[:3, -1].expand(direction.shape), direction


def tpu_ray_batch(camera2world, generator: torch.Generator, *,
                  image_height: int, image_width: int, focal: float,
                  near: float, far: float, n_samples: int):
    """:func:`~keras_nerf_tpu_torch.data.rays.generate_ray_batch` with
    :func:`tpu_default_rays`' directions; the same depth draws."""
    c2w = torch.as_tensor(camera2world, dtype=torch.float32,
                          device=generator.device)
    rays = [tpu_default_rays(m, image_height, image_width, focal)
            for m in c2w]
    points = stratified_sample_points(
        generator, (c2w.shape[0], image_height, image_width), n_samples,
        near, far)
    return (torch.stack([r[0] for r in rays]),
            torch.stack([r[1] for r in rays]), points)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--"]:
        argv = argv[1:]
    if "--pixel_sampling" in argv:
        raise SystemExit("tpu_rays: --pixel_sampling draws its rays in "
                         "sample_random_ray_batch, which this diagnostic "
                         "does not swap")
    from keras_nerf_tpu_torch import train_single
    from keras_nerf_tpu_torch.data import loader

    default = loader.generate_ray_batch
    loader.generate_ray_batch = tpu_ray_batch
    t0 = time.perf_counter()
    try:
        train_single.main(argv)
    finally:
        loader.generate_ray_batch = default
    line = f"tpu_rays: wall {time.perf_counter() - t0:.1f} s"
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        line += (f", peak allocated "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(line, flush=True)


if __name__ == "__main__":
    main()
