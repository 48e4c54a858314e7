"""The JAX package's recorded training runs that the port's training is
held to (ROADMAP C): each anchor's recipe, its scene, and its final test
fine PSNR, read from the run's log in ``assets/``.

    python -m keras_nerf_tpu_torch.anchors NAME[:SEED] ... [--seed 42]
        [--out build/anchors] [--drop_models] [--device cuda]

for each run in turn makes the anchor's scene
(:mod:`keras_nerf_tpu_torch.make_scenes`), trains the recipe on the card
through :mod:`keras_nerf_tpu_torch.tpu_rays` (the JAX runs trained and
evaluated on a TPU's DEFAULT-precision rays), then, for ``aabb_demo``,
runs the demo the same way. The run logs to ``{out}/{NAME}_s{seed}.log``
and ends it, and its output, with a JSON record of the port's reading beside JAX's, their
difference and whether it lies within :data:`LIMIT_DB`
(`docs/QUALITY.md:196`). The recipe is the JAX run's own
``Namespace(...)`` (line 1 of its log) with ``--seed`` and the output
directories replaced; the scale-2 demo's is ``scripts/aabb_demo.py:16-24``.
"""

from __future__ import annotations

import argparse
import ast
import json
import logging
import os
import re
import shutil
import time
from dataclasses import dataclass

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The run-to-run limit of a final PSNR (docs/QUALITY.md:196).
LIMIT_DB = 0.2

# Set by the runner, never part of a recipe.
_OUTPUT_KEYS = ("model_dirs", "log_dir")

# scripts/aabb_demo.py:16-24: the scale-2 scene's training and demo flags.
AABB_DEMO_TRAIN = ["--name", "scaled2", "--data_dir", "data/scaled2_64",
                   "--img_wh", "64", "--white_bg", "--near", "4", "--far",
                   "12", "--num_epochs", "40", "--ray_chunks", "4096",
                   "--learning_rate", "1e-3", "--log_freq", "10"]
AABB_DEMO_FLAGS = ["--data_dir", "data/scaled2_64", "--img_wh", "64",
                   "--near", "4", "--far", "12", "--white_bg", "--aabb",
                   "-4", "-4", "-4", "4", "4", "4"]


@dataclass(frozen=True)
class Anchor:
    log: str     # the JAX run's log, relative to the repository
    scene: str   # make_scenes' name of the scene it trains on

    def jax_reading(self) -> float:
        """JAX's test fine PSNR: the log's final test line, or for the
        demo its JSON line's exact render."""
        path = os.path.join(_REPO, self.log)
        if self.log.endswith("aabb_demo.log"):
            return demo_record(path)["exact_psnr"]
        return final_fine_psnr(path)

    def train_flags(self) -> list[str]:
        """The port's ``train_single`` flags of the JAX run."""
        if self.log.endswith("aabb_demo.log"):
            return list(AABB_DEMO_TRAIN)
        with open(os.path.join(_REPO, self.log)) as f:
            return namespace_flags(f.readline())


# The 128² recipes, then the scale-2 demo.
ANCHORS = {
    "occtrain_nomerge": Anchor("assets/occtrain_nomerge_run.log",
                               "spheres"),
    "occtrain_upd2cache": Anchor("assets/occtrain_upd2cache_run.log",
                                 "spheres"),
    "quality128_hard": Anchor("assets/quality128_hard_run.log", "hard"),
    "occtrain_hard_d2": Anchor("assets/occtrain_hard_d2_run.log", "hard"),
    "quality128_b8lr28": Anchor("assets/quality128_b8lr28_run.log",
                                "spheres"),
    "quality128_ps": Anchor("assets/quality128_ps_run.log", "spheres"),
    "aabb_demo": Anchor("assets/aabb_demo.log", "scaled2"),
}


def namespace_args(line: str) -> dict:
    """The keyword arguments of the ``Namespace(...)`` in a log line."""
    start = line.index("Namespace(")
    call = ast.parse(line[start:line.index(")", line.rindex("="))
                          + 1].strip(), mode="eval").body
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords}


def namespace_flags(line: str) -> list[str]:
    """A log's ``Namespace(...)`` as the port's ``train_single`` argv:
    every argument but the output directories, a switch only when set.
    An argument the port's parser lacks raises."""
    from keras_nerf_tpu_torch.train_single import build_arg_parser

    actions = {a.dest: a for a in build_arg_parser()._actions}
    flags = []
    for key, value in namespace_args(line).items():
        if key in _OUTPUT_KEYS:
            continue
        if key not in actions:
            raise ValueError(f"the port's train_single has no --{key}")
        if isinstance(actions[key], argparse._StoreTrueAction):
            flags += [f"--{key}"] if value else []
        else:
            flags += [f"--{key}", str(value)]
    return flags


def final_fine_psnr(path: str) -> float:
    """The fine PSNR of a run log's last ``Final test metrics`` line."""
    value = None
    with open(path, errors="replace") as f:
        for line in f:
            if "Final test metrics" in line:
                value = float(re.search(r"fine_psnr=([0-9.]+)", line)[1])
    if value is None:
        raise ValueError(f"{path}: no final test metrics")
    return value


def demo_record(path: str) -> dict:
    """The last JSON line of an ``aabb_demo`` log."""
    record = None
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith('{"exact_psnr"'):
                record = json.loads(line)
    if record is None:
        raise ValueError(f"{path}: no aabb_demo record")
    return record


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("runs", nargs="+", metavar="NAME[:SEED]",
                   help=f"anchors, each at --seed or its own; of "
                        f"{', '.join(ANCHORS)}")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default="build/anchors",
                   help="the runs' logs, logs and model directories")
    p.add_argument("--drop_models", action="store_true",
                   help="delete each run's checkpoints once it is read")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> list[dict]:
    args = build_arg_parser().parse_args(argv)
    runs = []
    for spec in args.runs:
        name, _, seed = spec.partition(":")
        if name not in ANCHORS:
            raise SystemExit(f"unknown anchor {name!r}; choose from "
                             f"{', '.join(ANCHORS)}")
        runs.append((name, int(seed) if seed else args.seed))
    return [run_anchor(name, seed, args.out, args.device, args.drop_models)
            for name, seed in runs]


def run_anchor(name: str, seed: int, out: str, device: str,
               drop_models: bool = False) -> dict:
    """One anchor at one seed; prints and returns its record."""
    from keras_nerf_tpu_torch import make_scenes, timing, tpu_rays

    anchor = ANCHORS[name]
    _, card = timing.start(device)
    os.makedirs(out, exist_ok=True)
    log = os.path.join(out, f"{name}_s{seed}.log")
    handlers = [logging.FileHandler(log, mode="w"), logging.StreamHandler()]
    root = logging.getLogger()
    for handler in handlers:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s | %(name)s | %(levelname)s | %(message)s"))
        root.addHandler(handler)
    root.setLevel(logging.INFO)
    run = f"{name}_tpurays_s{seed}"
    models = [os.path.join(out, "model", run),
              os.path.join(out, "logs", run, "model")]
    try:
        make_scenes.main([anchor.scene])
        t0 = time.perf_counter()
        tpu_rays.main(["train_single", "--", *anchor.train_flags(),
                       "--name", run, "--seed", str(seed),
                       "--device", device,
                       "--log_dir", os.path.join(out, "logs"),
                       "--model_dirs", os.path.join(out, "model")])
        record = {"anchor": name, "seed": seed, "card": card,
                  "train_s": round(time.perf_counter() - t0, 1)}
        reading = final_fine_psnr(log)
        if name == "aabb_demo":
            demo = tpu_rays.main([
                "aabb_demo", "--", "--model_path", models[0],
                *AABB_DEMO_FLAGS, "--seed", str(seed), "--device", device])
            logging.info("%s", json.dumps(demo))
            record.update(train_fine_psnr=reading, demo=demo)
            reading = demo["exact_psnr"]
        jax = anchor.jax_reading()
        record.update(fine_psnr=reading, jax_fine_psnr=jax,
                      delta=round(reading - jax, 4),
                      within=abs(reading - jax) <= LIMIT_DB, log=log)
        logging.info("Anchor record: %s", json.dumps(record))
    finally:
        for handler in handlers:
            root.removeHandler(handler)
            handler.close()
        if drop_models:
            for path in models:
                shutil.rmtree(path, ignore_errors=True)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
