"""360-degree orbit rendering (port of the root ``inference.py``).

    python -m keras_nerf_tpu_torch.inference --model_dirs model/lego_128 \\
        --img_wh 128 --white_bg --output_dir output

Loads a checkpoint written by ``keras_nerf_tpu`` (``--model_dirs``; a
directory holding only a reference ``.h5`` artifact is converted in place
first, which needs ``h5py``), builds
``pose_spherical`` cameras for theta in ``0..350`` step ``--output_freq``,
renders each frame's fine image and depth through the kernel path and
writes ``{name}.gif`` and ``{name}_depth.gif`` at 20 fps. Runs on ``cuda``
unless ``--device cpu`` is given; ``--quantized_render`` renders through the
int8 tier; ``--fast_render K`` renders the fine pass on K importance samples
alone (it composes with ``--quantized_render``); ``--occupancy_grid G`` bakes a G^3 occupancy grid once and renders
every frame with the fine model alone, ``--occupancy_samples`` points per
ray inside occupied space (the two compose). ``--num_gpus N`` renders
each frame in N horizontal bands, one process a card
(``keras_nerf_tpu_torch.parallel``); rank 0 writes the GIFs.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

# The reference CLI's camera defaults (root ``inference.py:19-57``).
ORBIT = dict(fov=0.6911112070083618, phi=-30.0, z_translate=4.0, near=2.0,
             far=6.0)


def render_orbit(nerf, thetas, *, img_wh: int, fov: float, phi: float,
                 z_translate: float, near: float, far: float,
                 frame_batch: int = 1, seed: int = 42,
                 occupancy_samples: int = 0):
    """Render orbit frames with a compiled :class:`NeRF`: one
    ``predict_and_render_images(with_weights=False, coarse_image=False)``
    call per group of ``frame_batch`` poses (the last group padded by
    repeating its pose), or with ``occupancy_samples > 0`` one
    ``render_occupancy(n_samples=occupancy_samples)`` call over the grid
    :meth:`NeRF.bake_occupancy` baked. Returns float32 numpy ``(images
    [N, H, W, 3], depths [N, H, W])``, one per theta."""
    from keras_nerf_tpu_torch.data import (
        generate_ray_batch,
        get_focal_from_fov,
        pose_spherical,
    )

    focal = get_focal_from_fov(fov, img_wh)
    thetas = list(thetas)
    generator = torch.Generator(device=nerf.device)
    generator.manual_seed(seed)
    images, depths = [], []
    for i in range(0, len(thetas), frame_batch):
        group = thetas[i:i + frame_batch]
        padded = group + [group[-1]] * (frame_batch - len(group))
        c2w = np.stack([pose_spherical(float(t), phi, z_translate)
                        for t in padded])
        rays = generate_ray_batch(
            c2w, generator, image_height=img_wh, image_width=img_wh,
            focal=focal, near=near, far=far,
            n_samples=nerf.config.n_coarse)
        if occupancy_samples > 0:
            fine = nerf.render_occupancy(rays, near=near, far=far,
                                         n_samples=occupancy_samples)
        else:
            _, fine = nerf.predict_and_render_images(
                rays, with_weights=False, coarse_image=False)
        images.append(fine["image"][:len(group)].cpu().numpy())
        depths.append(fine["depth"][:len(group)].cpu().numpy())
    return np.concatenate(images), np.concatenate(depths)


def gif_frames(images: np.ndarray, depths: np.ndarray):
    """uint8 colour frames and min-max normalized depth frames."""
    frames = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in images]
    depth_frames = []
    for depth in depths:
        d = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-6)
        depth_frames.append((d * 255).astype(np.uint8))
    return frames, depth_frames


def write_gifs(frames, depth_frames, output_dir: str, name: str) -> str:
    """``{name}.gif`` and ``{name}_depth.gif`` at 20 fps (50 ms a frame),
    looping, written with PIL (as ``imageio``'s GIF writer does)."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    gif_path = os.path.join(output_dir, f"{name}.gif")
    for path, seq in ((gif_path, frames),
                      (os.path.join(output_dir, f"{name}_depth.gif"),
                       depth_frames)):
        images = [Image.fromarray(np.asarray(f)) for f in seq]
        images[0].save(path, save_all=True, append_images=images[1:],
                       duration=50, loop=0)
    return gif_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--name", type=str, default="",
                        help="output name (default: the model directory's)")
    parser.add_argument("--model_dirs", type=str, required=True)
    parser.add_argument("--ray_chunks", type=int, default=4096)
    parser.add_argument("--img_wh", type=int, default=128)
    parser.add_argument("--near", type=float, default=ORBIT["near"])
    parser.add_argument("--far", type=float, default=ORBIT["far"])
    parser.add_argument("--fov", type=float, default=ORBIT["fov"])
    parser.add_argument("--eagerly", action="store_true",
                        help="accepted for the root CLI's sake: the port "
                             "has no jit and always runs eagerly")
    parser.add_argument("--white_bg", action="store_true")
    parser.add_argument("--mixed_precision", action="store_true",
                        help="bfloat16 MLP compute on the reference path "
                             "(the kernels' precision is their own)")
    parser.add_argument("--use_pallas", action="store_true",
                        help="force the fused kernels on (default: auto — "
                             "on for the card)")
    parser.add_argument("--no_pallas", action="store_true",
                        help="force the reference path (end-to-end float32 "
                             "matmuls when --mixed_precision is off; the "
                             "fused kernels are bf16-operand/f32-accumulate "
                             "by design)")
    parser.add_argument("--phi", type=float, default=ORBIT["phi"])
    parser.add_argument("--z_translate", type=float,
                        default=ORBIT["z_translate"])
    parser.add_argument("--output_dir", type=str, default="output")
    parser.add_argument("--output_freq", type=int, default=10)
    parser.add_argument("--frame_batch", type=int, default=1,
                        help="orbit frames rendered per call")
    parser.add_argument("--num_gpus", type=int, default=1,
                        help="render over this many cards (0 = all), one "
                             "process each: each frame is split into "
                             "horizontal image bands (an extension: the "
                             "reference inference is single-device). "
                             "img_wh must divide by the card count. "
                             "Composes with --fast_render, "
                             "--quantized_render and --occupancy_grid")
    parser.add_argument("--fast_render", type=int, default=0,
                        help="opt-in approximation: the fine pass renders "
                             "this many importance samples of the coarse "
                             "weights alone, without the coarse depths "
                             "merged in (0 = the exact math). Its PSNR cost "
                             "depends on the checkpoint and the scene: "
                             "-2.34 dB at 96 and -2.47 dB at 64 on the "
                             "spheres test views of a 39.33 dB checkpoint "
                             "(keras_nerf_tpu_torch.render_frontier, NVIDIA "
                             "H100 80GB HBM3, 700 W); measure it on a "
                             "held-out split of your own scene. "
                             "Composes with --quantized_render; the "
                             "occupancy render ignores it")
    parser.add_argument("--quantized_render", action="store_true",
                        help="opt-in int8 render tier: W8A8 int8 tensor-core "
                             "products (the ray_march_mlp_int8 kernel) with "
                             "static scales calibrated once on the first "
                             "frame's rays; sampling and quadrature are "
                             "unchanged")
    parser.add_argument("--occupancy_grid", type=int, default=0,
                        help="opt-in: bake a G^3 occupancy grid from the "
                             "model's density once, then render every "
                             "frame with the fine model alone at "
                             "--occupancy_samples points per ray inside "
                             "occupied space (0 = off). It changes the math: "
                             "its PSNR cost depends on the scene and on "
                             "--occupancy_dilate (measured in "
                             "docs/QUALITY.md); check it on a held-out split "
                             "before trusting it. Composes with "
                             "--quantized_render")
    parser.add_argument("--occupancy_samples", type=int, default=64)
    parser.add_argument("--occupancy_aabb", type=float, nargs=6,
                        default=None,
                        metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                        help="bounds of the occupancy grid (xyz min, then "
                             "xyz max); default [-2, 2]^3, Blender scale. "
                             "Geometry outside the box renders as "
                             "background")
    parser.add_argument("--sigma_threshold", type=float, default=1.0,
                        help="density above which a voxel counts as "
                             "occupied when the grid is baked")
    parser.add_argument("--occupancy_dilate", type=int, default=1,
                        help="binary dilation steps of the baked grid "
                             "(6-neighbourhood); raise to 2-3 for thin, "
                             "sub-voxel geometry")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    if args.name == "":
        args.name = os.path.basename(os.path.normpath(args.model_dirs))
    logging.info(args)
    if args.eagerly:
        logging.info("--eagerly: the port has no jit; it always runs "
                     "eagerly")

    from keras_nerf_tpu_torch.device import resolve_device
    from keras_nerf_tpu_torch.parallel import run_ranks, world_size
    from keras_nerf_tpu_torch.utils import checkpoint as ckpt

    # A reference .h5 artifact is converted in place first
    # (`inference.py:145-147`, utils/import_h5.py).
    ckpt.maybe_import_reference(args.model_dirs)
    if not ckpt.has_weights(args.model_dirs):
        raise FileNotFoundError(
            f"Model weights not found in {args.model_dirs} (need "
            f"{ckpt.COARSE_WEIGHTS} and {ckpt.FINE_WEIGHTS})")
    device = resolve_device(args.device)
    n = world_size(args.num_gpus, device)
    if n == 1:
        render_and_write(args)
        return
    if args.img_wh % n:
        raise SystemExit(f"--img_wh {args.img_wh} must divide by the {n} "
                         f"mesh devices (height bands)")
    logging.info("Rendering over %d ranks (height bands)", n)
    run_ranks(render_and_write, args, n, device.type)


def render_and_write(args, group=None):
    """Load ``--model_dirs``, render the orbit (in height bands under a
    ``parallel.Group``) and write both GIFs (rank 0 alone under a
    group)."""
    from keras_nerf_tpu_torch.models import NeRF
    from keras_nerf_tpu_torch.train_single import use_kernels_flag

    frame_batch = max(1, args.frame_batch)
    nerf = NeRF(model_path=args.model_dirs,
                compute_dtype=("bfloat16" if args.mixed_precision
                               else "float32"))
    nerf.compile(batch_size=frame_batch, image_height=args.img_wh,
                 image_width=args.img_wh, ray_chunks=args.ray_chunks,
                 white_background=args.white_bg, is_training=False,
                 device=args.device if group is None else group.device,
                 use_kernels=use_kernels_flag(args),
                 fast_render=args.fast_render,
                 quantized_render=args.quantized_render, group=group)
    if args.occupancy_grid > 0:
        aabb = None
        if args.occupancy_aabb is not None:
            aabb = (tuple(args.occupancy_aabb[:3]),
                    tuple(args.occupancy_aabb[3:]))
        else:
            logging.info("occupancy grid uses the default [-2, 2]^3 box; "
                         "pass --occupancy_aabb for scenes outside Blender "
                         "scale (geometry outside the box renders as "
                         "background)")
        nerf.bake_occupancy(args.occupancy_grid,
                            sigma_threshold=args.sigma_threshold,
                            dilate=args.occupancy_dilate, aabb=aabb)
    images, depths = render_orbit(
        nerf, range(0, 360, args.output_freq), img_wh=args.img_wh,
        fov=args.fov, phi=args.phi, z_translate=args.z_translate,
        near=args.near, far=args.far, frame_batch=frame_batch,
        occupancy_samples=(args.occupancy_samples if args.occupancy_grid > 0
                           else 0))
    if not nerf.is_chief:
        return
    frames, depth_frames = gif_frames(images, depths)
    gif_path = write_gifs(frames, depth_frames, args.output_dir, args.name)
    logging.info("Wrote %s (%d frames)", gif_path, len(frames))


if __name__ == "__main__":
    main()
