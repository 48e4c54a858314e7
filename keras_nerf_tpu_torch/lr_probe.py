"""Rank learning-rate recipes with short exact-math runs before a long one
(port of ``scripts/lr_probe.py``).

Each arm trains the same model, seed and data order through
``NeRF.compile`` / ``NeRF.fit`` (on the card, the fused training kernels)
for ``--epochs`` short epochs of ``--steps_per_epoch`` steps, with its
recipe's decay COMPRESSED into the probe (``lr_decay_steps = epochs *
steps_per_epoch``), so a decaying arm runs its whole anneal in miniature;
after each epoch it evaluates the val split. The arms are then ranked by
their last val PSNR.

What the probe can rank (`docs/QUALITY.md`, `assets/lr_probe_*.log`): the
BASE learning rate, as the full-length runs do. It cannot rank constant
against decay at one base: the compressed anneal strangles the rate while
the scene is still underfit, so a decay arm loses the probe where it may
win at full length.

    python -m keras_nerf_tpu_torch.lr_probe --data_dir data/synthetic_128 \\
        --img_wh 128 --white_bg
    python -m keras_nerf_tpu_torch.lr_probe ... --recipes 5e-4:5e-6 1e-3:0

A recipe is ``lr:lr_final`` (``lr_final`` 0: a constant rate). The
defaults are 3 arms x 10 epochs x 50 steps at 128^2, 8 x 256, 64 + 128
samples. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time


def parse_recipe(text: str):
    lr, _, final = text.partition(":")
    return float(lr), float(final or 0.0)


def recipe_label(lr: float, lr_final: float) -> str:
    return f"{lr:g} -> {lr_final:g}" if lr_final > 0 else f"constant {lr:g}"


class _FirstSteps:
    """The first ``steps`` batches of each pass over ``dataset``."""

    def __init__(self, dataset, steps: int):
        self.dataset, self.steps = dataset, steps

    def __len__(self) -> int:
        return self.steps

    def __iter__(self):
        for _, batch in zip(range(self.steps), self.dataset):
            yield batch


def run_arm(lr: float, lr_final: float, datasets, args) -> list[float]:
    """Train one arm from the seed's weights; its val fine PSNR after each
    epoch (the mean over the val images)."""
    from keras_nerf_tpu_torch.models import NeRF

    train_ds, val_batches = datasets
    steps = args.steps_per_epoch or len(train_ds)
    model = NeRF(n_coarse=args.num_coarse_samples,
                 n_fine=args.num_fine_samples, n_layers=args.num_layers,
                 dense_units=args.num_units, skip_layer=args.skip_layer)
    model.compile(optimizer=args.optimizer, batch_size=1,
                  image_height=args.img_wh, image_width=args.img_wh,
                  ray_chunks=args.ray_chunks, white_background=args.white_bg,
                  learning_rate=lr, lr_final=lr_final,
                  lr_decay_steps=args.epochs * steps, seed=args.seed,
                  device=args.device)
    # The same data order in every arm: the loader's epoch counter reset.
    train_ds._epoch = 0
    history = model.fit(_FirstSteps(train_ds, steps),
                        validation_data=val_batches, epochs=args.epochs,
                        verbose=False)
    return [h["val_fine_psnr"] for h in history]


def ranking(results: list) -> list:
    """``(label, curve, seconds, lr)`` rows, best last val PSNR first."""
    return sorted(results, key=lambda r: r[1][-1], reverse=True)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="rank lr recipes with short exact-math probe runs")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--img_wh", type=int, default=128)
    p.add_argument("--white_bg", action="store_true")
    p.add_argument("--near", type=float, default=2.0)
    p.add_argument("--far", type=float, default=6.0)
    p.add_argument("--num_coarse_samples", type=int, default=64)
    p.add_argument("--num_fine_samples", type=int, default=128)
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--num_units", type=int, default=256)
    p.add_argument("--skip_layer", type=int, default=4)
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--ray_chunks", type=int, default=16384)
    p.add_argument("--epochs", type=int, default=10,
                   help="probe epochs per arm (each arm's decay schedule "
                        "is compressed to exactly this budget)")
    p.add_argument("--steps_per_epoch", type=int, default=50,
                   help="train batches per probe epoch (0 = the full "
                        "split)")
    p.add_argument("--recipes", nargs="*",
                   default=["5e-4:5e-6", "1e-3:0", "1e-3:1e-5"],
                   help="lr:lr_final per arm (lr_final 0 = constant)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> list:
    """Runs the arms and prints their curves, the ranking and the
    recommendation; returns the ranked rows."""
    args = build_arg_parser().parse_args(argv)
    from keras_nerf_tpu_torch.data import DatasetLoader

    loader = DatasetLoader(args.data_dir, args.white_bg, device=args.device)
    train_ds, val_ds, _ = loader.load_dataset(
        batch_size=1, image_width=args.img_wh, image_height=args.img_wh,
        near=args.near, far=args.far, n_sample=args.num_coarse_samples,
        seed=args.seed)
    val_batches = list(val_ds)
    print(f"device: {args.device}  scene: {args.data_dir}  "
          f"{args.img_wh}^2, {len(train_ds)} train / {len(val_batches)} "
          f"val images", flush=True)

    results = []
    for text in args.recipes:
        lr, lr_final = parse_recipe(text)
        label = recipe_label(lr, lr_final)
        t0 = time.perf_counter()
        curve = run_arm(lr, lr_final, (train_ds, val_batches), args)
        dt = time.perf_counter() - t0
        results.append((label, curve, dt, lr))
        print(f"arm [{label}]: " + " ".join(f"{v:.2f}" for v in curve)
              + f"  ({dt:.0f} s)", flush=True)

    ranked = ranking(results)
    print(f"\n=== probe ranking (final val PSNR after {args.epochs} "
          f"compressed epochs x {args.steps_per_epoch or len(train_ds)} "
          f"steps) ===")
    for rank, (label, curve, _, _) in enumerate(ranked, 1):
        tail = curve[-1] - curve[-2] if len(curve) > 1 else 0.0
        print(f"{rank}. {label:>18}  val {curve[-1]:6.2f} dB  "
              f"(last-epoch slope {tail:+.2f})")
    best_label, _, _, best_lr = ranked[0]
    print(f"\nrecommendation: base lr {best_lr:g} (probe winner: "
          f"[{best_label}]). The probe ranks the BASE lr; it cannot see "
          f"the full-length benefit of a decay schedule (the compressed "
          f"anneal bites while the scene is still underfit). For the long "
          f"run, compare constant {best_lr:g} against a decay FROM "
          f"{best_lr:g}; the measured winners at full length are in "
          f"docs/QUALITY.md ('lr recipes are scene-dependent').",
          flush=True)
    return ranked


if __name__ == "__main__":
    main()
