"""Data-parallel training across cards (port of the root ``train.py``).

    python -m keras_nerf_tpu_torch.train --num_gpus 4 --data_dir data/lego \\
        --name lego_128 --img_wh 128 --ray_chunks 2048 --white_bg

One process a card (``--num_gpus``, 0 = every visible card), rank ``r`` on
``cuda:{r}``, meeting through a ``FileStore`` in a temporary directory and
joined in an NCCL group (``--device cpu``: gloo, one rank a process on the
CPU). Each rank runs ``train_single.run_training`` on its share of the
global batch, ``batch_size * num_gpus`` images split along the batch axis,
or with ``--shard_rays`` ``batch_size`` images split along their height;
the gradients are averaged over the ranks before every update
(``keras_nerf_tpu_torch.parallel``). ``--ray_chunks`` is per rank. Rank 0
alone logs, writes ``log.csv`` and the checkpoints, and saves the final
model to ``{model_dirs}/{name}``. The flags are ``train_single``'s, with
the root CLI's defaults, plus ``--num_gpus``, ``--n_slices`` and
``--shard_rays``.
"""

from __future__ import annotations

import logging

from keras_nerf_tpu_torch.train_single import (
    build_arg_parser as single_arg_parser,
)
from keras_nerf_tpu_torch.train_single import run_training


def build_arg_parser():
    """``train_single``'s flags with the root ``train.py``'s defaults and
    its three flags of distribution (`train.py:23-150`)."""
    parser = single_arg_parser()
    parser.set_defaults(img_wh=512, ray_chunks=1024, log_freq=5)
    for action in parser._actions:
        if action.dest == "batch_size":
            action.help = ("PER-DEVICE batch size; global batch is "
                           "batch_size * num_devices")
    parser.add_argument("--num_gpus", type=int, default=0,
                        help="train on the first N cards, one process each "
                             "(0 = every visible card; more than are "
                             "visible raises)")
    parser.add_argument("--n_slices", type=int, default=1,
                        help="multi-slice layout of the JAX package: "
                             "checked (it must divide the ranks), then the "
                             "group is flat, whose arithmetic on one node "
                             "is the 2-D mesh's")
    parser.add_argument("--shard_rays", action="store_true",
                        help="ray-sharded DP: split the image HEIGHT axis "
                             "across the ranks instead of the image-batch "
                             "axis. Global batch stays batch_size (NOT "
                             "batch_size * num_devices), so the optimizer "
                             "trajectory follows the one-card trajectory "
                             "at that batch size (same global-batch "
                             "gradient math; fine-pass sample draws are "
                             "decorrelated per band) — the ranks only "
                             "divide the per-step ray work. Requires "
                             "img_wh %% num_devices == 0")
    return parser


def main(argv=None):
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    if args.shard_rays and args.pixel_sampling:
        parser.error("--shard_rays cannot compose with --pixel_sampling "
                     "(pixel batches have no image-height axis to split; "
                     "plain DP already shards them)")
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    from keras_nerf_tpu_torch.device import resolve_device
    from keras_nerf_tpu_torch.parallel import run_ranks, world_size

    device = resolve_device(args.device)
    n = world_size(args.num_gpus, device)
    if device.type == "cuda" and not args.no_pallas:
        # One build before the ranks start, rather than one in each.
        from keras_nerf_tpu_torch.kernels import _build

        _build.load()
    logging.info("Data parallelism over %d rank(s) on %s", n, device.type)
    run_ranks(run_training, args, n, device.type, n_slices=args.n_slices)


if __name__ == "__main__":
    main()
