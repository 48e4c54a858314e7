"""The occupancy render's box on a scene that needs it (port of
``scripts/aabb_demo.py``): the default box culls the scene, a box that
covers it restores the occupancy render's quality.

    python -m keras_nerf_tpu_torch.aabb_demo --model_path DIR --data_dir DIR
        --aabb X0 Y0 Z0 X1 Y1 Z1 [--img_wh 64] [--near 4] [--far 12]
        [--white_bg] [--ray_chunks 4096] [--occ_grid 64] [--occ_samples 64]
        [--occ_dilate 1] [--seed 42] [--device cuda]

The scene is the scale-2 spheres fixture
(``data.synthetic.write_synthetic_scene(scale=2.0)``: orbit radius 8, near
4, far 12), whose outer spheres reach past the default ``[-2, 2]^3`` box.
On a checkpoint trained on it, prints one JSON line with the test split's
mean fine PSNR three ways: the exact render
(``NeRF.predict_and_render_images``), the occupancy render
(``NeRF.render_occupancy``) through a grid baked over the default box
(``NeRF.bake_occupancy``), and through one baked over ``--aabb``; with
both grids' occupied shares. Every render draws from a generator seeded
``--seed``, fresh for each image, as the JAX script passes the same key.

    python -c "from keras_nerf_tpu_torch.data.synthetic import \\
        write_synthetic_scene as w; w('data/scaled2_64', image_wh=64, \\
        n_train=50, n_val=8, n_test=8, supersample=4, scale=2.0)"
    python -m keras_nerf_tpu_torch.train_single --name scaled2 \\
        --data_dir data/scaled2_64 --img_wh 64 --white_bg --near 4 \\
        --far 12 --num_epochs 40 --ray_chunks 4096 --learning_rate 1e-3 \\
        --log_freq 10
    python -m keras_nerf_tpu_torch.aabb_demo --model_path model/scaled2 \\
        --data_dir data/scaled2_64 --img_wh 64 --white_bg \\
        --aabb -4 -4 -4 4 4 4

Prints the card's line first and the JSON line last.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def split_psnr(dataset, render) -> float:
    """Mean fine PSNR of ``render(rays) -> {"image"}`` over a split's
    ``(images, rays)`` batches."""
    from keras_nerf_tpu_torch.ops.metrics import psnr

    vals = []
    for images, rays in dataset:
        out = render(rays)
        vals.append(float(psnr(out["image"], images[..., :3]).mean()))
    return float(np.mean(vals))


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--img_wh", type=int, default=64)
    p.add_argument("--near", type=float, default=4.0)
    p.add_argument("--far", type=float, default=12.0)
    p.add_argument("--white_bg", action="store_true")
    p.add_argument("--ray_chunks", type=int, default=4096)
    p.add_argument("--occ_grid", type=int, default=64)
    p.add_argument("--occ_samples", type=int, default=64)
    p.add_argument("--occ_dilate", type=int, default=1)
    p.add_argument("--aabb", type=float, nargs=6, required=True,
                   metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                   help="the box that covers the scene (xyz min, xyz max)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    from keras_nerf_tpu_torch import timing
    from keras_nerf_tpu_torch.data import DatasetLoader
    from keras_nerf_tpu_torch.models import NeRF

    args = build_arg_parser().parse_args(argv)
    device, _ = timing.start(args.device)
    nerf = NeRF(model_path=args.model_path)
    _, _, test = DatasetLoader(args.data_dir, args.white_bg,
                               device=device).load_dataset(
        batch_size=1, image_width=args.img_wh, image_height=args.img_wh,
        near=args.near, far=args.far, n_sample=nerf.config.n_coarse,
        seed=args.seed)
    test = test.take(len(test))
    nerf.compile(loss="mse", batch_size=1, image_height=args.img_wh,
                 image_width=args.img_wh, ray_chunks=args.ray_chunks,
                 white_background=args.white_bg, is_training=False,
                 seed=args.seed, device=device)

    def draws():
        return torch.Generator(device=device).manual_seed(args.seed)

    exact = split_psnr(test, lambda r: nerf.predict_and_render_images(
        r, with_weights=False, coarse_image=False, fine_draws=draws())[1])

    def occ_render(r):
        return nerf.render_occupancy(r, draws(), near=args.near,
                                     far=args.far, n_samples=args.occ_samples)

    nerf.bake_occupancy(args.occ_grid, dilate=args.occ_dilate)
    default_frac = float(nerf.occ_grid.mean())
    occ_default = split_psnr(test, occ_render)
    aabb = (tuple(args.aabb[:3]), tuple(args.aabb[3:]))
    nerf.bake_occupancy(args.occ_grid, dilate=args.occ_dilate, aabb=aabb)
    fixed_frac = float(nerf.occ_grid.mean())
    occ_fixed = split_psnr(test, occ_render)
    out = {"exact_psnr": round(exact, 2),
           "occ_default_aabb_psnr": round(occ_default, 2),
           "occ_correct_aabb_psnr": round(occ_fixed, 2),
           "default_grid_occupied_frac": round(default_frac, 4),
           "correct_grid_occupied_frac": round(fixed_frac, 4),
           "aabb": args.aabb}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
