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
Debugging and precision: ``--mixed_precision`` (bf16 products on the
reference path), ``--debug_nans``, ``--debug_grads``, ``--profile_dir``,
``--use_pallas``/``--no_pallas`` (the kernel path forced on or off) and
``--eagerly`` (accepted; the port runs eagerly always).
:func:`run_training` is also the per-rank body of the data-parallel CLI,
``keras_nerf_tpu_torch.train``.
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
    parser.add_argument("--eagerly", action="store_true",
                        help="disable jit (debug mode); the port has no jit "
                             "and always runs eagerly, so this only logs")
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--lr_final", type=float, default=0.0,
                        help="exponential lr decay target over the whole "
                             "run (0 = constant lr)")
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["adam", "sgd"])
    parser.add_argument("--mixed_precision", action="store_true",
                        help="bfloat16 MLP compute on the reference path "
                             "(the kernels' precision is their own: bf16 "
                             "operands, float32 accumulation)")
    parser.add_argument("--seed", type=int, default=42,
                        help="global RNG seed (the reference hardcodes 42, "
                             "train_single.py:10)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="raise at once when a step's loss or gradients "
                             "are not finite (the reference's per-gradient "
                             "assert_all_finite, nerf.py:380-382); waits "
                             "for every step")
    parser.add_argument("--debug_grads", action="store_true",
                        help="log one gradient norm per parameter tensor "
                             "each step and warn naming any dead/non-finite "
                             "layer (the reference eager-mode per-variable "
                             "zero-grad counters, nerf.py:429-451); adds "
                             "per-step metric traffic — debug only")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of the first "
                             "training epoch to this directory")
    parser.add_argument("--use_pallas", action="store_true",
                        help="force the fused kernels on (default: auto — "
                             "on for the card)")
    parser.add_argument("--no_pallas", action="store_true",
                        help="force the reference path (end-to-end float32 "
                             "matmuls when --mixed_precision is off; the "
                             "fused kernels are bf16-operand/f32-accumulate "
                             "by design)")
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


class ProfileFirstEpoch:
    """A ``NeRF.fit`` callback: a ``torch.profiler`` trace of the first
    epoch, written as ``trace_rank{r}.json`` (Chrome trace format) to
    ``profile_dir`` (``--profile_dir``)."""

    verbose = False

    def __init__(self, profile_dir: str, rank: int = 0):
        self.path = os.path.join(profile_dir, f"trace_rank{rank}.json")
        self._prof = None

    def set_model(self, model):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if model.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        logging.info("Profiling to %s (stops after the first epoch)",
                     self.path)

    def on_epoch_end(self, epoch, logs):
        if self._prof is None:
            return
        self._prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        logging.info("Profiler trace written to %s", self.path)


def use_kernels_flag(args) -> bool | None:
    """``--use_pallas`` / ``--no_pallas`` as ``use_kernels``: True, False
    or None (auto); ``--use_pallas`` wins, as in the root CLI."""
    return True if args.use_pallas else (False if args.no_pallas else None)


def run_training(args, group=None):
    """Load the scene, train, evaluate and save (`train_single.py:179-327`).
    With a ``parallel.Group`` this is one rank of the data-parallel run:
    the global batch is ``batch_size`` times the ranks (``batch_size`` with
    ``--shard_rays``), every rank loads every global batch and the model
    trains on the rank's share, and rank 0 alone logs its metrics and
    writes files."""
    from keras_nerf_tpu_torch.data import DatasetLoader
    from keras_nerf_tpu_torch.models import NeRF
    from keras_nerf_tpu_torch.utils import checkpoint as ckpt
    from keras_nerf_tpu_torch.utils.monitor import NeRFTrainMonitor

    logging.info(args)
    if args.eagerly:
        logging.info("--eagerly: the port has no jit; it always runs "
                     "eagerly")
    if args.debug_nans:
        logging.info("debug_nans enabled: a non-finite loss or gradient "
                     "raises at once")
    shard_rays = bool(getattr(args, "shard_rays", False)) and group is not None
    n_ranks = 1 if group is None else group.size
    global_batch = args.batch_size if shard_rays else args.batch_size * n_ranks
    device = args.device if group is None else group.device
    sharding = None
    if group is not None:
        from keras_nerf_tpu_torch.parallel import BatchSharding

        sharding = BatchSharding(group, shard_rays)
        logging.info("Group: %d ranks (%s); global batch %d%s", n_ranks,
                     group.backend, global_batch,
                     " (ray-sharded: image height split across the ranks)"
                     if shard_rays else "")
    loader = DatasetLoader(args.data_dir, args.white_bg,
                           resize_method=args.resize_method,
                           device=device)
    train_dataset, val_dataset, test_dataset = loader.load_dataset(
        batch_size=global_batch, image_width=args.img_wh,
        image_height=args.img_wh, near=args.near, far=args.far,
        n_sample=args.num_coarse_samples, seed=args.seed,
        sharding=sharding, pixel_sampling=args.pixel_sampling)

    model_log_dir = os.path.join(args.log_dir, args.name, "model")
    model_path = model_log_dir if ckpt.has_weights(model_log_dir) else None
    if model_path:
        logging.info("Continuing training from %s", model_path)
    nerf = NeRF(n_coarse=args.num_coarse_samples,
                n_fine=args.num_fine_samples, pos_emb_xyz=args.pos_emb_xyz,
                pos_emb_dir=args.pos_emb_dir, n_layers=args.num_layers,
                dense_units=args.num_units, skip_layer=args.skip_layer,
                model_path=model_path,
                compute_dtype=("bfloat16" if args.mixed_precision
                               else "float32"))
    monitor = NeRFTrainMonitor(
        dataset=test_dataset, log_dir=os.path.join(args.log_dir, args.name),
        batch_size=global_batch, update_freq=args.log_freq,
        verbose=args.verbose)
    nerf.compile(optimizer=args.optimizer, loss="mse",
                 batch_size=global_batch, image_height=args.img_wh,
                 image_width=args.img_wh, ray_chunks=args.ray_chunks,
                 white_background=args.white_bg,
                 learning_rate=args.learning_rate, lr_final=args.lr_final,
                 lr_decay_steps=args.num_epochs * max(len(train_dataset), 1),
                 seed=args.seed, device=device,
                 use_kernels=use_kernels_flag(args),
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
                 far=args.far, group=group, shard_rays=shard_rays,
                 debug_grads=args.debug_grads, debug_nans=args.debug_nans)
    callbacks = [monitor]
    if args.profile_dir:
        callbacks.append(ProfileFirstEpoch(
            args.profile_dir, 0 if group is None else group.rank))
    nerf.fit(train_dataset, validation_data=val_dataset,
             epochs=args.num_epochs, initial_epoch=monitor.last_epoch,
             callbacks=callbacks)
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
