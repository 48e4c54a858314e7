"""Single-device training (port of the root ``train_single.py``).

    python -m keras_nerf_tpu_torch.train_single --data_dir data/lego \\
        --name lego_128 --img_wh 128 --ray_chunks 2048 --white_bg

Loads a Blender scene (``--data_dir``), trains the coarse and fine MLPs
with two optimizers, logs every epoch to ``{log_dir}/{name}/log.csv`` with
a checkpoint in ``{log_dir}/{name}/model`` (resumed from there when it
holds weights), evaluates the test split and saves the final model to
``{model_dirs}/{name}`` in the JAX package's checkpoint format. Runs on
``cuda`` unless ``--device cpu`` is given. Two opt-in tiers:
``--pixel_sampling`` (each batch's rays drawn across every train view) and
``--occupancy_train G`` with its ``--occupancy_train_*`` flags (the fine
pass on depths inside a G^3 grid baked from the live fine model).

Flags of the root CLI not ported yet (ROADMAP.md): ``--eagerly``,
``--mixed_precision``, ``--debug_nans``, ``--debug_grads``,
``--profile_dir`` and ``--use_pallas``/``--no_pallas``.
"""

from __future__ import annotations

import argparse
import logging
import os


def build_arg_parser() -> argparse.ArgumentParser:
    """The root CLI's flags that this port supports, with its defaults and
    help (`train_single.py:19-175`), plus ``--device``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--name", type=str, default="lego",
                        help="name of the nerf model")
    parser.add_argument("--data_dir", type=str,
                        default="data/nerf_synthetic/lego")
    parser.add_argument("--num_coarse_samples", type=int, default=64)
    parser.add_argument("--num_fine_samples", type=int, default=128)
    parser.add_argument("--pos_emb_xyz", type=int, default=10)
    parser.add_argument("--pos_emb_dir", type=int, default=4)
    parser.add_argument("--num_layers", type=int, default=8)
    parser.add_argument("--num_units", type=int, default=256)
    parser.add_argument("--skip_layer", type=int, default=4)
    parser.add_argument("--img_wh", type=int, default=128)
    parser.add_argument("--near", type=float, default=2.0)
    parser.add_argument("--far", type=float, default=6.0)
    parser.add_argument("--white_bg", action="store_true")
    parser.add_argument("--num_epochs", type=int, default=250)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--ray_chunks", type=int, default=2048)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--lr_final", type=float, default=0.0,
                        help="exponential lr decay target over the whole "
                             "run (0 = constant lr)")
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["adam", "sgd"])
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--resize_method", type=str, default="lanczos",
                        choices=["lanczos", "antialias-bilinear"])
    parser.add_argument("--pixel_sampling", action="store_true",
                        help="train on random rays drawn across ALL images "
                             "per step instead of whole-image batches (the "
                             "original NeRF paper trains this way). "
                             "Val/test metrics stay whole-image")
    parser.add_argument("--occupancy_train", type=int, default=0,
                        help="OPT-IN: after --occupancy_train_warmup "
                             "epochs, bake a G^3 occupancy grid from the "
                             "live fine model (re-baked every "
                             "--occupancy_train_update epochs) and train "
                             "the fine pass on --occupancy_train_samples "
                             "grid-placed depths instead of the 64+128 "
                             "coarse/importance merge (NerfAcc-style "
                             "empty-space skipping; the coarse pass and "
                             "all eval metrics keep exact reference math). "
                             "0 = off; 128 recommended. The quality cost "
                             "is scene- and lr-recipe-dependent "
                             "(docs/QUALITY.md): compare exact val PSNR "
                             "before committing a long run")
    parser.add_argument("--occupancy_train_samples", type=int, default=64)
    parser.add_argument("--occupancy_train_warmup", type=int, default=2)
    parser.add_argument("--occupancy_train_probe", type=int, default=64,
                        help="probe bins per ray for the occupancy CDF; "
                             "fewer bins probe faster at a coarser bin "
                             "resolution (grid dilation absorbs the "
                             "placement error)")
    parser.add_argument("--occupancy_train_update", type=int, default=1,
                        help="re-bake the training occupancy grid every N "
                             "epochs (NerfAcc-style periodic update); 1 = "
                             "every epoch. The grid goes stale between "
                             "bakes, so measure quality before raising it "
                             "on thin-geometry scenes")
    parser.add_argument("--occupancy_train_until", type=int, default=0,
                        help="hybrid schedule: occupancy-placed fine "
                             "samples until this epoch, exact reference "
                             "math afterwards (the lr-decay tail). 0 = "
                             "occupancy for the whole run")
    parser.add_argument("--occupancy_train_dilate", type=int, default=1,
                        help="binary dilation iterations applied to the "
                             "baked training grid (6-neighbourhood). Raise "
                             "to 2-3 on scenes with thin/sub-voxel "
                             "geometry, at the cost of sampling more empty "
                             "space")
    parser.add_argument("--occupancy_train_cache", action="store_true",
                        help="cache per-image probe rows against each "
                             "baked grid instead of re-probing every step "
                             "(rays are pose-deterministic, so the rows are "
                             "constant between re-bakes; bit-identical "
                             "sampling). Whole-image batches only; pays "
                             "off with --occupancy_train_update >= 2 (the "
                             "rebuild costs about one epoch of probe "
                             "savings)")
    parser.add_argument("--occupancy_train_no_merge", action="store_true",
                        help="do NOT rank-merge the stratified coarse "
                             "depths into the occupancy fine pass (fewer "
                             "samples; free space then stays supervised "
                             "only by the coarse model, so exact-math "
                             "renders of the fine model may float)")
    parser.add_argument("--model_dirs", type=str, default="model")
    parser.add_argument("--log_dir", type=str, default="logs")
    parser.add_argument("--log_freq", type=int, default=1)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser


def run_training(args):
    """Load the scene, train, evaluate and save (`train_single.py:179-327`)."""
    from keras_nerf_tpu_torch.data import DatasetLoader
    from keras_nerf_tpu_torch.models import NeRF
    from keras_nerf_tpu_torch.utils import checkpoint as ckpt
    from keras_nerf_tpu_torch.utils.monitor import NeRFTrainMonitor

    logging.info(args)
    loader = DatasetLoader(args.data_dir, args.white_bg,
                           resize_method=args.resize_method,
                           device=args.device)
    train_dataset, val_dataset, test_dataset = loader.load_dataset(
        batch_size=args.batch_size, image_width=args.img_wh,
        image_height=args.img_wh, near=args.near, far=args.far,
        n_sample=args.num_coarse_samples, seed=args.seed,
        pixel_sampling=args.pixel_sampling)

    model_log_dir = os.path.join(args.log_dir, args.name, "model")
    model_path = model_log_dir if ckpt.has_weights(model_log_dir) else None
    if model_path:
        logging.info("Continuing training from %s", model_path)
    nerf = NeRF(n_coarse=args.num_coarse_samples,
                n_fine=args.num_fine_samples, pos_emb_xyz=args.pos_emb_xyz,
                pos_emb_dir=args.pos_emb_dir, n_layers=args.num_layers,
                dense_units=args.num_units, skip_layer=args.skip_layer,
                model_path=model_path)
    monitor = NeRFTrainMonitor(
        dataset=test_dataset, log_dir=os.path.join(args.log_dir, args.name),
        batch_size=args.batch_size, update_freq=args.log_freq,
        verbose=args.verbose)
    nerf.compile(optimizer=args.optimizer, loss="mse",
                 batch_size=args.batch_size, image_height=args.img_wh,
                 image_width=args.img_wh, ray_chunks=args.ray_chunks,
                 white_background=args.white_bg,
                 learning_rate=args.learning_rate, lr_final=args.lr_final,
                 lr_decay_steps=args.num_epochs * max(len(train_dataset), 1),
                 seed=args.seed, device=args.device,
                 occupancy_train=args.occupancy_train,
                 occupancy_train_samples=args.occupancy_train_samples,
                 occupancy_train_warmup=args.occupancy_train_warmup,
                 occupancy_train_probe=args.occupancy_train_probe,
                 occupancy_train_merge=not args.occupancy_train_no_merge,
                 occupancy_train_update=args.occupancy_train_update,
                 occupancy_train_cache=args.occupancy_train_cache,
                 occupancy_train_until=args.occupancy_train_until,
                 occupancy_train_dilate=args.occupancy_train_dilate,
                 pixel_sampling=args.pixel_sampling, near=args.near,
                 far=args.far)
    nerf.fit(train_dataset, validation_data=val_dataset,
             epochs=args.num_epochs, initial_epoch=monitor.last_epoch,
             callbacks=[monitor])
    test_metrics = nerf.evaluate(test_dataset)
    logging.info("Final test metrics: %s", " ".join(
        f"{k}={v:.4f}" for k, v in test_metrics.items()))
    save_path = os.path.join(args.model_dirs, args.name)
    nerf.save_model(save_path)
    logging.info("Saved final model to %s", save_path)
    if nerf.device.type == "cuda":
        import torch

        logging.info("Peak device memory allocated: %.2f GiB",
                     torch.cuda.max_memory_allocated(nerf.device) / 2**30)
    return nerf


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    run_training(args)


if __name__ == "__main__":
    main()
