"""Evaluate a saved checkpoint on a dataset's held-out split (port of
``scripts/eval_checkpoint.py``).

    python -m keras_nerf_tpu_torch.eval_checkpoint \\
        --model_path model/quality128_r5best --data_dir data/synthetic_128 \\
        --img_wh 128 --white_bg [--split test] [--device cpu]

The training CLI logs the final test metrics at the end of a run; this
evaluates any saved model directory (either package's) the same way after
the fact: the exact render math, the fine draws of ``NeRF``'s fixed
evaluation generator, the split's stratified depths from ``--seed`` (and
``--jitter_epoch``). Runs on
``cuda`` unless ``--device cpu`` is given. Prints one line per metric and a
final one-line JSON record.
"""

from __future__ import annotations

import argparse
import json
import logging


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True,
                        help="dir with model_config.json + *.msgpack")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--img_wh", type=int, default=128)
    parser.add_argument("--near", type=float, default=2.0)
    parser.add_argument("--far", type=float, default=6.0)
    parser.add_argument("--white_bg", action="store_true")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--ray_chunks", type=int, default=16384)
    parser.add_argument("--split", type=str, default="test",
                        choices=["train", "val", "test"])
    parser.add_argument("--resize_method", type=str, default="lanczos",
                        choices=["lanczos", "antialias-bilinear"])
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--jitter_epoch", type=int, default=0,
                        help="the epoch of the split's stratified depth "
                             "jitter to evaluate (0: a fresh loader's). "
                             "The training CLI's final test line reads the "
                             "epoch its monitor left the test split at: 3 "
                             "after 100 epochs at --log_freq 10")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser


def evaluate_checkpoint(args) -> dict:
    """The split's mean metrics for the checkpoint: the JSON record's
    ``model_path``, ``split`` and the six metrics, rounded to 4 places."""
    from keras_nerf_tpu_torch.data import DatasetLoader
    from keras_nerf_tpu_torch.models import NeRF

    nerf = NeRF(model_path=args.model_path)
    loader = DatasetLoader(args.data_dir, args.white_bg,
                           resize_method=args.resize_method,
                           device=args.device)
    splits = loader.load_dataset(
        batch_size=args.batch_size, image_width=args.img_wh,
        image_height=args.img_wh, near=args.near, far=args.far,
        n_sample=nerf.config.n_coarse, seed=args.seed)
    dataset = dict(zip(("train", "val", "test"), splits))[args.split]
    if args.jitter_epoch:
        dataset._epoch = args.jitter_epoch   # NeRFDataset's epoch counter
    nerf.compile(loss="mse", batch_size=args.batch_size,
                 image_height=args.img_wh, image_width=args.img_wh,
                 ray_chunks=args.ray_chunks, white_background=args.white_bg,
                 is_training=False, seed=args.seed, device=args.device)
    metrics = nerf.evaluate(dataset)
    for k, v in metrics.items():
        logging.info("%s %s = %.4f", args.split, k, v)
    return {"model_path": args.model_path, "split": args.split,
            **{k: round(float(v), 4) for k, v in metrics.items()}}


def main(argv=None) -> dict:
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    record = evaluate_checkpoint(args)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
