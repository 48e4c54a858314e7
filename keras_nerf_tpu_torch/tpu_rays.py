"""The rays a TPU computes at DEFAULT matmul precision (ROADMAP C15): a
diagnostic, not an option of any CLI.

The JAX package forms each ray direction ``R v`` with a ``jnp.einsum``
that names no ``precision=`` (`keras_nerf_tpu/data/rays.py:59`, ``:147``).
On a TPU a DEFAULT-precision float32 dot rounds both operands to bfloat16
(one pass, round to nearest even) and multiplies and sums them in float32.
:func:`tpu_default_rays` (whole images) and :func:`tpu_random_ray_batch`
(the pixel sampler) compute the rays so; the port's own
:func:`~keras_nerf_tpu_torch.data.rays.generate_rays` computes them at
float32 (JAX's on the CPU, bit for bit).

    python -m keras_nerf_tpu_torch.tpu_rays [train_single] -- <flags>
    python -m keras_nerf_tpu_torch.tpu_rays aabb_demo -- <flags>

runs :func:`keras_nerf_tpu_torch.train_single.main` (the default) or
:func:`keras_nerf_tpu_torch.aabb_demo.main` inside :func:`swapped`, which
gives every ray of the run these directions: the loader's whole-image
batches (train, val, test), its pixel-sampled batches (``--pixel_sampling``)
and the occupancy tier's cached probe rows
(``ops/occupancy.py:probe_rows_for_poses``, as JAX's are made from its
``generate_rays``); the depths are the default path's draws. Then it prints
the run's wall clock and, on the card, its peak allocated memory.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from keras_nerf_tpu_torch.data import rays as rays_module
from keras_nerf_tpu_torch.data.rays import camera_plane_directions
from keras_nerf_tpu_torch.ops.sampling import (fma_f32,
                                               stratified_sample_points)

TARGETS = ("train_single", "aabb_demo")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bfloat16 (ties to even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def tpu_rotate_and_normalize(rotation: torch.Tensor,
                             cam: torch.Tensor) -> torch.Tensor:
    """Unit ``R v`` for rotations ``[..., 3, 3]`` and camera vectors
    ``[..., 3]`` as a TPU's DEFAULT-precision einsum gives them: both
    rounded to bfloat16, the products (exact in float32) summed in float32;
    then the port's norm (`data/rays.py:_rotate_and_normalize`): the
    squared norm as float32 multiply-adds, its square root rounded once,
    one division."""
    r = bf16_round(rotation)
    v = bf16_round(cam)
    d = (v[..., 0, None] * r[..., :, 0] + v[..., 1, None] * r[..., :, 1]
         + v[..., 2, None] * r[..., :, 2])
    sq = fma_f32(d[..., 2], d[..., 2],
                 fma_f32(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
    norm = torch.sqrt(sq.to(torch.float64)).to(torch.float32)
    return d / norm[..., None]


def tpu_default_rays(c2w: torch.Tensor, h: int, w: int, focal: float):
    """``[4, 4] -> (origin [H, W, 3], direction [H, W, 3])``:
    :func:`~keras_nerf_tpu_torch.data.rays.generate_rays` with
    :func:`tpu_rotate_and_normalize`."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    direction = tpu_rotate_and_normalize(
        c2w[:3, :3], camera_plane_directions(h, w, focal, c2w.device))
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


def tpu_random_ray_batch(*args, **kwargs):
    """:func:`~keras_nerf_tpu_torch.data.rays.sample_random_ray_batch` with
    :func:`tpu_rotate_and_normalize`'s directions (JAX's ``rij,rj->ri``
    einsum, `keras_nerf_tpu/data/rays.py:147`); the same pixel and depth
    draws."""
    return rays_module.sample_random_ray_batch(
        *args, rotate=tpu_rotate_and_normalize, **kwargs)


@contextlib.contextmanager
def swapped():
    """Every ray the loader and the occupancy probe-row cache make inside
    the block has the TPU's directions; the defaults are put back after,
    whatever happens."""
    from keras_nerf_tpu_torch.data import loader

    swaps = [(loader, "generate_ray_batch", tpu_ray_batch),
             (loader, "sample_random_ray_batch", tpu_random_ray_batch),
             (rays_module, "generate_rays", tpu_default_rays)]
    defaults = [getattr(m, name) for m, name, _ in swaps]
    for m, name, fn in swaps:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for (m, name, _), fn in zip(swaps, defaults):
            setattr(m, name, fn)


def main(argv=None):
    """Runs the target inside :func:`swapped`; returns what it returns."""
    argv = list(sys.argv[1:] if argv is None else argv)
    target = argv.pop(0) if argv[:1] and argv[0] in TARGETS else TARGETS[0]
    if argv[:1] == ["--"]:
        argv = argv[1:]
    if target == "aabb_demo":
        from keras_nerf_tpu_torch.aabb_demo import main as run
    else:
        from keras_nerf_tpu_torch.train_single import main as run

    t0 = time.perf_counter()
    with swapped():
        result = run(argv)
    line = f"tpu_rays: {target} wall {time.perf_counter() - t0:.1f} s"
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        line += (f", peak allocated "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
