"""Real-scene readiness drill (port of ``scripts/real_scene_drill.py``).

The real ``nerf_synthetic`` dataset is not in the repository, so the drill
runs the documented real-data recipe unchanged on a drop-in
``nerf_synthetic/lego``-shaped directory:

* a Blender-format scene of 800 x 800 RGBA PNGs (the real dataset's size,
  laid out per ``transforms_{split}.json`` as `keras_nerf/data/loader.py:
  35-53` reads it), written by the port's ``write_synthetic_scene``;
* the 800 -> 128 resize through ``--resize_method antialias-bilinear``
  (the reference's ``tf.image.resize``, `image.py:22-23`) and
  white-background compositing (`image.py:25-31`);
* the quality recipe's flags (`docs/QUALITY.md`) for a few epochs:
  ``--img_wh 128 --white_bg --ray_chunks 16384 --learning_rate 5e-4
  --lr_final 5e-6``.

    python -m keras_nerf_tpu_torch.real_scene_drill [--epochs 3]
        [--out build/real_scene_drill] [--device cuda] [-- <train flags>]

Flags after ``--`` go to the training CLI after the drill's own (a later
flag wins). Checks, each printed with its reading: the loss decreases (the
val split's fine loss of the trained model below that of the seed's
weights, on the same draws, and, over two epochs or more, the last epoch's
train fine loss below the first's, as the JAX drill checks), ``log.csv``
holds a row an epoch, the checkpoint is written, and,
where matplotlib imports, the monitor's panels are written (the drill says
when it skips that check). Raises :class:`DrillFailed` on a failed check.
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import logging
import os
import shutil

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class DrillFailed(Exception):
    """A check of the drill failed."""


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise DrillFailed(msg)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--out", default=os.path.join(_REPO, "build",
                                                 "real_scene_drill"))
    p.add_argument("--n_train", type=int, default=12)
    p.add_argument("--source_wh", type=int, default=800,
                   help="the scene's PNG size (the real dataset's: 800)")
    p.add_argument("--img_wh", type=int, default=128)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def train_flags(args, scene: str, logs: str, models: str) -> list[str]:
    """The training CLI's flags for the drill."""
    return ["--name", "lego", "--data_dir", scene,
            "--img_wh", str(args.img_wh), "--white_bg",
            "--num_epochs", str(args.epochs), "--batch_size", "1",
            "--ray_chunks", "16384",
            "--learning_rate", "5e-4", "--lr_final", "5e-6",
            "--log_freq", "1",
            "--resize_method", "antialias-bilinear",
            "--log_dir", logs, "--model_dirs", models,
            "--device", args.device]


def _val_fine_loss(model, train_args) -> tuple[float, float]:
    """The val split's fine loss at the seed's weights (the state
    ``NeRF.compile`` drew) and at the trained weights, on the same depth
    draws."""
    from keras_nerf_tpu_torch.data import DatasetLoader
    from keras_nerf_tpu_torch.models import engine

    _, val, _ = DatasetLoader(
        train_args.data_dir, train_args.white_bg,
        resize_method=train_args.resize_method,
        device=model.device).load_dataset(
        batch_size=1, image_width=train_args.img_wh,
        image_height=train_args.img_wh, near=train_args.near,
        far=train_args.far, n_sample=train_args.num_coarse_samples,
        seed=train_args.seed)
    trained = model.state
    seed = torch.Generator(device=model.device).manual_seed(train_args.seed)
    losses = []
    for state in (engine.init_train_state(seed, model.config,
                                          model.optimizer), trained):
        model.state, val._epoch = state, 0
        losses.append(model.evaluate(val)["fine_loss"])
    model.state = trained
    return losses[0], losses[1]


def main(argv=None) -> dict:
    """Writes the scene, trains, checks; returns ``{"checks": {name:
    reading}, "skipped": [...], "model": trained NeRF}``."""
    argv = list(argv or [])
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    from keras_nerf_tpu_torch import train_single
    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

    scene = os.path.join(args.out, "nerf_synthetic", "lego")
    logs = os.path.join(args.out, "logs")
    models = os.path.join(args.out, "models")
    shutil.rmtree(args.out, ignore_errors=True)
    logging.info("writing a %dx%d Blender-format scene to %s",
                 args.source_wh, args.source_wh, scene)
    write_synthetic_scene(scene, image_wh=args.source_wh,
                          n_train=args.n_train, n_val=2, n_test=2)

    flags = train_flags(args, scene, logs, models) + extra
    logging.info("drill command: python -m keras_nerf_tpu_torch.train_single "
                 "%s", " ".join(flags))
    train_args = train_single.build_arg_parser().parse_args(flags)
    model = train_single.run_training(train_args)

    with open(os.path.join(logs, "lego", "log.csv")) as f:
        rows = list(csv.DictReader(f))
    checks, skipped = {}, []
    _require(len(rows) == args.epochs,
             f"log.csv holds {len(rows)} rows for {args.epochs} epochs")
    checks["log.csv rows"] = len(rows)
    before, after = _val_fine_loss(model, train_args)
    _require(after < before, f"val fine loss did not decrease: {before} "
             f"at the seed's weights, {after} trained")
    checks["val fine loss: seed's weights -> trained"] = (before, after)
    if len(rows) >= 2:
        first, last = (float(rows[i]["fine_loss"]) for i in (0, -1))
        _require(last < first, f"train fine loss did not decrease: {rows}")
        checks["train fine loss: first -> last epoch"] = (first, last)
    from keras_nerf_tpu_torch.utils import checkpoint

    saved = os.path.join(models, "lego")
    _require(checkpoint.has_weights(saved) and os.path.exists(
        os.path.join(saved, checkpoint.MODEL_CONFIG)), "no checkpoint")
    checks["checkpoint"] = saved
    if importlib.util.find_spec("matplotlib") is None:
        skipped.append("panels (matplotlib is not installed)")
    else:
        panels = [f for f in os.listdir(os.path.join(logs, "lego"))
                  if f.endswith(".png")]
        _require(bool(panels), "no monitor panels written")
        checks["panels"] = len(panels)
    for name, reading in checks.items():
        logging.info("drill check %s: %s", name, reading)
    for name in skipped:
        logging.info("drill check skipped: %s", name)
    logging.info("DRILL PASSED: %d checks, %d skipped", len(checks),
                 len(skipped))
    return {"checks": checks, "skipped": skipped, "model": model}


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
