"""The recipes the port's training is held to on the card
(``keras_nerf_tpu_torch/anchors.py``), on the CPU.

For each anchor, line 1 of the JAX run's log (its ``Namespace(...)``),
turned into the port's ``train_single`` flags and cut to CPU size (the
scene, widths, samples and epochs of ``cli_train_config_matches_jax``; the
occupancy grid, samples and probe bins shrunk), trains both CLIs: their
``train_config.json`` are equal, so the recipe run on the card is the
recipe JAX ran. The scale-2 demo's recipe is the one
``scripts/aabb_demo.py`` states, and each anchor's JAX figure is its log's.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import ast
import math
import os
import shlex

import pytest

import tests.test_torch_occupancy_train as occ_tests
from keras_nerf_tpu_torch import anchors, make_scenes
from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX runs' final test fine PSNR, as the logs state them.
JAX_READINGS = {"occtrain_nomerge": 32.4709, "occtrain_upd2cache": 32.6792,
                "quality128_hard": 25.3343, "occtrain_hard_d2": 23.0497,
                "quality128_b8lr28": 31.9217, "quality128_ps": 30.3603,
                "aabb_demo": 31.32}
# Replaced by cli_train_config_matches_jax's CPU sizes.
SIZE_KEYS = {"name", "data_dir", "num_epochs", "img_wh",
             "num_coarse_samples", "num_fine_samples", "num_layers",
             "num_units", "skip_layer", "ray_chunks"}
OCC_CPU = {"occupancy_train": "8", "occupancy_train_samples": "8",
           "occupancy_train_probe": "16", "occupancy_train_warmup": "1"}


def _pairs(flags):
    """``["--a", "1", "--b", ...]`` -> ``[("a", "1"), ("b", None), ...]``."""
    out = []
    for tok in flags:
        if tok.startswith("--"):
            out.append([tok[2:], None])
        else:
            out[-1][1] = tok if out[-1][1] is None else f"{out[-1][1]} {tok}"
    return out


def cpu_size(flags):
    """An anchor's flags at CPU size: the recipe's own learning rate,
    schedule, batch, bounds, seed and tier switches."""
    out = []
    for key, value in _pairs(flags):
        if key in SIZE_KEYS:
            continue
        if key in OCC_CPU and int(value) > 0:
            value = OCC_CPU[key]
        out += [f"--{key}"] + ([] if value is None else value.split(" ")
                               if key == "aabb" else [value])
    return out


@pytest.mark.parametrize("name", list(anchors.ANCHORS))
def test_anchor_recipe_matches_jax_train_config(tmp_path, monkeypatch, name):
    """Both CLIs trained 2 epochs on a 16^2 scene of 8 train views (batch
    8 is a recipe, whose val and test splits want 8 views too) with the
    anchor's flags record one train config."""
    flags = cpu_size(anchors.ANCHORS[name].train_flags())
    views = max(2, int(dict(_pairs(flags)).get("batch_size") or 1))
    monkeypatch.setattr(occ_tests, "_write_scene", lambda path: (
        write_synthetic_scene(str(path), image_wh=16, n_train=8,
                              n_val=views, n_test=views)))
    _, rows = occ_tests.cli_train_config_matches_jax(tmp_path, flags)
    assert rows and all(math.isfinite(float(r["fine_loss"])) for r in rows)


def test_jax_readings_are_the_logs():
    assert list(anchors.ANCHORS) == list(JAX_READINGS)
    for name, anchor in anchors.ANCHORS.items():
        assert anchor.jax_reading() == JAX_READINGS[name], name
        assert anchor.scene in make_scenes.SCENES


def test_recipes_are_the_logs_namespaces():
    """Every argument of each log's ``Namespace`` (but the output
    directories) reaches the port's parser with its value."""
    from keras_nerf_tpu_torch.train_single import build_arg_parser

    for name, anchor in anchors.ANCHORS.items():
        if name == "aabb_demo":
            continue
        with open(os.path.join(REPO, anchor.log)) as f:
            want = anchors.namespace_args(f.readline())
        got = vars(build_arg_parser().parse_args(anchor.train_flags()))
        for key, value in want.items():
            if key not in ("model_dirs", "log_dir"):
                assert got[key] == value, (name, key)


def test_aabb_demo_recipe_is_the_jax_scripts():
    """``scripts/aabb_demo.py:16-24``: its training command's flags and
    its demo command's (less the model path) are the anchor's."""
    with open(os.path.join(REPO, "scripts", "aabb_demo.py")) as f:
        doc = ast.get_docstring(ast.parse(f.read()))
    commands = [shlex.split(c.replace("\\\n", " "))
                for c in doc.split("python ")[1:]]
    train = next(c for c in commands if c[0] == "train_single.py")
    demo = next(c for c in commands if c[0] == "scripts/aabb_demo.py")
    assert train[1:] == anchors.AABB_DEMO_TRAIN
    i = demo.index("--model_path")
    assert demo[1:i] + demo[i + 2:] == anchors.AABB_DEMO_FLAGS


def test_namespace_flags_refuse_an_argument_the_port_lacks():
    line = "x | INFO | Namespace(img_wh=16, no_such_flag=True) (a.py:1)"
    assert anchors.namespace_args(line) == {"img_wh": 16,
                                            "no_such_flag": True}
    with pytest.raises(ValueError, match="--no_such_flag"):
        anchors.namespace_flags(line)


def test_anchor_runner_on_the_cpu(tmp_path, monkeypatch):
    """``python -m keras_nerf_tpu_torch.anchors`` at 16^2: a recipe from a
    log's ``Namespace`` (the no-merge occupancy tier) trains through
    ``tpu_rays`` with the seed replaced, and the record holds the port's
    final test fine PSNR beside the log's; the demo anchor adds the demo's
    three readings on TPU rays."""
    scene = write_synthetic_scene(str(tmp_path / "scene"), image_wh=16,
                                  n_train=2, n_val=1, n_test=1, scale=2.0)
    log = tmp_path / "jax_run.log"
    log.write_text(
        f"t | root | INFO | Namespace(name='tiny', data_dir='{scene}', "
        "num_coarse_samples=8, num_fine_samples=8, num_layers=2, "
        "num_units=16, skip_layer=1, img_wh=16, near=4.0, far=12.0, "
        "white_bg=True, num_epochs=2, ray_chunks=128, learning_rate=0.005, "
        "seed=42, occupancy_train=8, occupancy_train_samples=8, "
        "occupancy_train_warmup=1, occupancy_train_probe=16, "
        "occupancy_train_no_merge=True, model_dirs='model', "
        "log_dir='logs', log_freq=1) (train_single.py:1)\n"
        "t | root | INFO | Final test metrics: coarse_psnr=9.0000 "
        "fine_psnr=10.5000 fine_ssim=0.5 (train_single.py:2)\n")
    monkeypatch.setitem(anchors.ANCHORS, "occtrain_nomerge",
                        anchors.Anchor(str(log), "spheres"))
    monkeypatch.setattr(make_scenes, "main", lambda names: None)
    out = str(tmp_path / "out")
    record, = anchors.main(["occtrain_nomerge:7", "--out", out,
                            "--device", "cpu"])
    assert os.path.isdir(os.path.join(out, "model",
                                      "occtrain_nomerge_tpurays_s7"))
    port_log = os.path.join(out, "occtrain_nomerge_s7.log")
    with open(port_log) as f:
        ran = anchors.namespace_args(f.readline())
    assert ran["seed"] == 7 and ran["occupancy_train_no_merge"]
    assert ran["name"] == "occtrain_nomerge_tpurays_s7"
    assert record["fine_psnr"] == anchors.final_fine_psnr(port_log)
    assert record["jax_fine_psnr"] == 10.5
    assert record["delta"] == round(record["fine_psnr"] - 10.5, 4)
    assert record["within"] == (abs(record["delta"]) <= anchors.LIMIT_DB)

    tiny = ["--num_coarse_samples", "8", "--num_fine_samples", "8",
            "--num_layers", "2", "--num_units", "16", "--skip_layer", "1",
            "--img_wh", "16", "--num_epochs", "1", "--ray_chunks", "128"]
    monkeypatch.setattr(anchors, "AABB_DEMO_TRAIN", [
        scene if f == "data/scaled2_64" else f
        for f in anchors.AABB_DEMO_TRAIN] + tiny)
    monkeypatch.setattr(anchors, "AABB_DEMO_FLAGS", [
        "--data_dir", scene, "--img_wh", "16", "--near", "4", "--far", "12",
        "--white_bg", "--ray_chunks", "256", "--occ_grid", "16", "--aabb",
        "-4", "-4", "-4", "4", "4", "4"])
    record, = anchors.main(["aabb_demo", "--out", out, "--device", "cpu",
                            "--drop_models"])
    assert not os.path.exists(os.path.join(out, "model",
                                           "aabb_demo_tpurays_s42"))
    with pytest.raises(SystemExit, match="unknown anchor"):
        anchors.main(["no_such_anchor"])
    assert record["jax_fine_psnr"] == 31.32
    assert record["fine_psnr"] == record["demo"]["exact_psnr"]
    assert set(record["demo"]) >= {"occ_default_aabb_psnr",
                                   "occ_correct_aabb_psnr"}
