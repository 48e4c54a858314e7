"""Measure the render tiers' speed and quality on one checkpoint (port of
``scripts/render_frontier.py``).

Every opt-in render tier, one trained model, the same held-out images:

  * bf16 exact          (the inference CLI's default math; the JAX
    package names it "f32")
  * int8 exact-sampling (``--quantized_render``)
  * bf16 / int8 ``--fast_render {96,64}`` (importance-only fine pass)
  * occupancy grid K={64,32} (``--occupancy_grid``, fine model only), bf16
    and int8

For each tier: the test split's fine PSNR (the exact eval math of each
tier, the same fine draws for every image) and the ms a frame at
``--bench_wh``² on random rays (``--iters`` frames after one warm-up,
host clock ending in ``torch.cuda.synchronize()``; the card only, null on
the CPU). One int8 calibration serves every int8 tier. Writes a table to
stdout, a JSON record (``--out_json``; the JAX script's keys, ``backend``
the card's name and power limit) and, where matplotlib imports, the
fps-against-PSNR plot (``--out_png``).

    python -m keras_nerf_tpu_torch.render_frontier \\
        --model model/quality128_r5best --data data/synthetic_128

Runs on ``cuda`` unless ``--device cpu`` is given. The default outputs are
``assets/render_frontier_torch.{json,png}``, beside (never over) the JAX
package's records.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from keras_nerf_tpu_torch.timing import card_line

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAWS_SEED = 17      # the fine draws of every PSNR render (JAX's key 17)
BENCH_SEED = 1       # the bench's random rays


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model",
                    default=os.path.join(_REPO, "model", "quality128"))
    ap.add_argument("--data",
                    default=os.path.join(_REPO, "data", "synthetic_128"))
    ap.add_argument("--img_wh", type=int, default=128)
    ap.add_argument("--ray_chunks", type=int, default=16384)
    ap.add_argument("--bench_wh", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--occ_grid", type=int, default=128)
    ap.add_argument("--occ_dilate", type=int, default=1,
                    help="occupancy-grid dilation iterations (the inference "
                         "CLI's --occupancy_dilate)")
    ap.add_argument("--tiers", default="",
                    help="substring filter: measure only tiers whose name "
                         "contains this (e.g. 'occ'); default all")
    ap.add_argument("--out_json",
                    default=os.path.join(_REPO, "assets",
                                         "render_frontier_torch.json"))
    ap.add_argument("--out_png",
                    default=os.path.join(_REPO, "assets",
                                         "render_frontier_torch.png"))
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default) or 'cpu' (no timing on the CPU)")
    return ap


def load(args, device):
    """``(config, coarse params, fine params, test batches)``: the
    checkpoint on ``device`` and every batch of its test split (one image
    each)."""
    from keras_nerf_tpu_torch.data import DatasetLoader
    from keras_nerf_tpu_torch.utils import checkpoint

    base = checkpoint.load_model_config(args.model, white_background=True)
    pc, pf = checkpoint.load_params(args.model, device)
    loader = DatasetLoader(args.data, white_background=True, device=device)
    _, _, test = loader.load_dataset(
        batch_size=1, image_width=args.img_wh, image_height=args.img_wh,
        near=2.0, far=6.0, n_sample=base.n_coarse)
    return base, pc, pf, test.take(len(test))


def measure_tiers(args, base, pc, pf, test_batches, device,
                  draws=None) -> tuple[list, dict]:
    """Each tier's row (the JAX script's keys) and the set-up it made
    (``occ_frac``, the grid, the int8 dicts); prints the table.
    ``draws(n_samples, num_rays, ray_chunks)`` gives the fine draws of
    every PSNR render and of the calibration (``ray_chunks`` None): by
    default a generator of seed ``DRAWS_SEED``, made anew for each render
    (the same draws for every image)."""
    from keras_nerf_tpu_torch.data.synthetic import random_ray_batch
    from keras_nerf_tpu_torch.models import engine
    from keras_nerf_tpu_torch.ops import occupancy as occ_mod
    from keras_nerf_tpu_torch.ops.metrics import psnr

    def generator(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    if draws is None:
        def draws(n_samples, num_rays, ray_chunks):
            return generator(DRAWS_SEED)

    def mean_psnr(render) -> float:
        return float(np.mean([float(psnr(render(rays), images[..., :3])[0])
                              for images, rays in test_batches]))

    def time_frames(render) -> float | None:
        """ms a frame over ``--iters`` renders of one random ray batch, after
        one warm-up; None off the card."""
        if device.type != "cuda":
            return None
        _, rays = random_ray_batch(1, args.bench_wh, args.bench_wh,
                                   base.n_coarse, generator(BENCH_SEED))
        render(rays, generator(DRAWS_SEED))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.iters):
            render(rays, generator(DRAWS_SEED + 1 + i))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / args.iters

    bench_chunks = min(8192, args.bench_wh * args.bench_wh)

    def num_rays(rays) -> int:
        return rays[0][..., 0].numel()

    # --- standard tiers (render_image_batch) ------------------------------
    def std_render(config, packed_q, chunks, rays, fine_draws):
        return engine.render_image_batch(
            pc, pf, rays, fine_draws, config, chunks, with_weights=False,
            coarse_image=False, packed_q=packed_q)[1]["image"]

    def eval_psnr(config, packed_q):
        n = config.fast_render or config.n_fine
        return mean_psnr(lambda rays: std_render(
            config, packed_q, args.ray_chunks, rays,
            draws(n, num_rays(rays), args.ray_chunks)))

    def std_ms(config, packed_q):
        return time_frames(lambda rays, g: std_render(
            config, packed_q, bench_chunks, rays, g))

    # --- occupancy tiers (the grid baked once, on first use) --------------
    setup = {}

    def get_occ_grid():
        if "occ_grid" not in setup:
            density = occ_mod.model_density_fn(pf, base)
            grid = occ_mod.bake_occupancy_grid(
                density, args.occ_grid, occ_mod.DEFAULT_AABB,
                sigma_threshold=1.0, dilate=args.occ_dilate, device=device)
            setup["occ_frac"] = 100.0 * float(grid.mean())
            print(f"occupancy grid {args.occ_grid}^3 "
                  f"(dilate={args.occ_dilate}): "
                  f"{setup['occ_frac']:.1f}% occupied")
            setup["occ_grid"] = grid
        return setup["occ_grid"]

    def occ_render(k, fine_q, chunks, rays, fine_draws):
        return occ_mod.render_image_batch_occ(
            pf, rays, get_occ_grid(), fine_draws, base, n_samples=k,
            ray_chunks=chunks, packed_q=fine_q)["image"]

    def occ_psnr(k, fine_q=None):
        return mean_psnr(lambda rays: occ_render(
            k, fine_q, args.ray_chunks, rays,
            draws(k, num_rays(rays), args.ray_chunks)))

    def occ_ms(k, fine_q=None):
        get_occ_grid()
        return time_frames(lambda rays, g: occ_render(
            k, fine_q, bench_chunks, rays, g))

    # One calibration for every int8 tier, on the first test image (the
    # exact coarse and merged fine distributions; fast_render does not
    # change them).
    def get_pq():
        if "pq" not in setup:
            rays0 = test_batches[0][1]
            setup["pq"] = engine.quantize_render_params(
                pc, pf, rays0, draws(base.n_fine, num_rays(rays0), None),
                base)
        return setup["pq"]

    def cfg(fast):
        return dataclasses.replace(base, fast_render=fast)

    # (name, family, measure_psnr, measure_ms): the JAX script's tiers,
    # with its names.
    tiers = [
        ("f32 exact", "f32",
         lambda: eval_psnr(cfg(0), None), lambda: std_ms(cfg(0), None)),
        ("int8 exact-sampling", "int8",
         lambda: eval_psnr(cfg(0), get_pq()),
         lambda: std_ms(cfg(0), get_pq())),
        ("f32 fast_render=96", "f32",
         lambda: eval_psnr(cfg(96), None), lambda: std_ms(cfg(96), None)),
        ("int8 fast_render=96", "int8",
         lambda: eval_psnr(cfg(96), get_pq()),
         lambda: std_ms(cfg(96), get_pq())),
        ("f32 fast_render=64", "f32",
         lambda: eval_psnr(cfg(64), None), lambda: std_ms(cfg(64), None)),
        ("int8 fast_render=64", "int8",
         lambda: eval_psnr(cfg(64), get_pq()),
         lambda: std_ms(cfg(64), get_pq())),
        ("occupancy K=64", "occupancy",
         lambda: occ_psnr(64), lambda: occ_ms(64)),
        ("occupancy K=32", "occupancy",
         lambda: occ_psnr(32), lambda: occ_ms(32)),
        ("int8 occ K=64", "int8+occ",
         lambda: occ_psnr(64, get_pq()[1]),
         lambda: occ_ms(64, get_pq()[1])),
        ("int8 occ K=32", "int8+occ",
         lambda: occ_psnr(32, get_pq()[1]),
         lambda: occ_ms(32, get_pq()[1])),
    ]
    if args.tiers:
        tiers = [t for t in tiers if args.tiers in t[0]]
        if not tiers:
            raise SystemExit(f"--tiers {args.tiers!r} matches no tier")

    print(f"{'tier':24s} {'test PSNR (dB)':>16s} "
          f"{'ms @' + str(args.bench_wh) + '^2':>12s} {'fps':>8s}")
    # The delta is always against the exact math, also when the filter
    # leaves the exact tier out.
    base_psnr = None
    if args.tiers and not any(n == "f32 exact" for n, *_ in tiers):
        base_psnr = eval_psnr(cfg(0), None)
        print(f"{'f32 exact (ref only)':24s} {base_psnr:11.3f} ({0.0:+.3f})")
    rows = []
    for name, family, f_psnr, f_ms in tiers:
        p = f_psnr()
        ms = f_ms()
        if base_psnr is None:
            base_psnr = p
        fps = None if ms is None else 1e3 / ms
        timing = ("not timed" if ms is None
                  else f"{ms:10.3f} {fps:8.2f}")
        print(f"{name:24s} {p:11.3f} ({p - base_psnr:+.3f}) {timing}")
        rows.append({"tier": name, "family": family, "psnr_db": round(p, 3),
                     "delta_db": round(p - base_psnr, 3),
                     "fps": None if fps is None else round(fps, 2)})
    return rows, setup


def main(argv=None) -> dict:
    ap = build_arg_parser()
    args = ap.parse_args(argv)
    if args.tiers or args.occ_dilate != 1:
        # A filtered or non-default sweep must not overwrite the full
        # record at the default paths.
        suffix = f"_{args.tiers or 'all'}_d{args.occ_dilate}"
        for attr in ("out_json", "out_png"):
            path = getattr(args, attr)
            if path == ap.get_default(attr):
                stem, ext = os.path.splitext(path)
                setattr(args, attr, stem + suffix + ext)
    for p in (args.out_json, args.out_png):
        os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)

    from keras_nerf_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    base, pc, pf, test_batches = load(args, device)
    backend = card_line(device)
    print(f"backend: {backend}")
    rows, setup = measure_tiers(args, base, pc, pf, test_batches, device)
    record = {
        "model": args.model, "img_wh": args.img_wh,
        "bench_wh": args.bench_wh, "iters": args.iters,
        "occ_grid": args.occ_grid,
        # None when a --tiers filter skipped every occupancy tier.
        "occ_occupied_pct": (round(setup["occ_frac"], 1)
                             if "occ_frac" in setup else None),
        "backend": backend, "rows": rows,
    }
    with open(args.out_json, "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"wrote {args.out_json}")
    plot_frontier(rows, args.out_png, args.bench_wh, backend)
    return record


def plot_frontier(rows, out_png, bench_wh, backend):
    """The fps-against-PSNR scatter, where matplotlib imports and every row
    was timed; otherwise one line saying why it was skipped."""
    if any(r["fps"] is None for r in rows):
        print(f"plot skipped: the tiers were not timed ({backend})")
        return
    try:
        import matplotlib
    except ImportError:
        print("plot skipped: matplotlib is not installed")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # CVD-safe blue/orange, okabe-ito green third; identity also carried by
    # marker shape and direct labels, never colour alone.
    families = [("f32", "#1f77b4", "o"), ("int8", "#ff7f0e", "s"),
                ("occupancy", "#009e73", "D"), ("int8+occ", "#cc79a7", "^")]
    fig, ax = plt.subplots(figsize=(8, 4.5), dpi=150)
    for fam, color, marker in families:
        pts = [r for r in rows if r["family"] == fam]
        ax.scatter([r["fps"] for r in pts], [r["psnr_db"] for r in pts],
                   s=55, color=color, marker=marker, label=fam, zorder=3)
        for r in pts:
            short = (r["tier"].replace(f"{fam} ", "")
                     .replace("fast_render=", "fast ")
                     .replace("occupancy ", ""))
            ax.annotate(short, (r["fps"], r["psnr_db"]),
                        textcoords="offset points", xytext=(6, 5),
                        fontsize=8, color="#444444")
    ax.set_xlabel(f"render fps @{bench_wh}² ({backend})")
    ax.set_ylabel("held-out test fine PSNR (dB)")
    ax.set_title("Render tiers: speed/quality frontier (one checkpoint)")
    ax.spines[["top", "right"]].set_visible(False)
    ax.grid(axis="both", alpha=0.25)
    ax.legend(frameon=False, loc="lower left", title=None)
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    print(f"wrote {out_png}")


if __name__ == "__main__":
    main()
