"""The port's quality tools against the JAX package's scripts, on the CPU:
``make_scenes`` (the scene table and the writer's bytes), ``eval_checkpoint``
(its JSON record) and ``render_frontier`` (its tiers, record and PSNRs).

Where a tool renders, both packages get the same inputs: JAX's loader's
batches (the stratified depths are drawn by JAX), JAX's per-chunk
``sorted_uniforms`` draws, JAX's baked grid and JAX's int8 dicts. Budgets,
each with its reason:

* ``eval_checkpoint``'s six metrics: 2e-4, the record's rounding to four
  places (both packages on their float32 reference paths, whose images
  agree within 1e-4, ``test_torch_render.py``);
* ``render_frontier``'s PSNR per tier: 0.01 dB. The port's kernel path
  (its plain versions) and JAX's Pallas kernels in interpret mode render
  within the fused-sampling budget (image 2e-3, ``test_torch_render.py``),
  but their mean image gap is a few 1e-5, which moves a PSNR near 8 dB by
  about 1e-4 dB.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import dataclasses
import importlib.util
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from keras_nerf_tpu.data.loader import DatasetLoader as JaxLoader
from keras_nerf_tpu.data.synthetic import (
    write_synthetic_scene as jax_write_scene,
)
from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.ops import occupancy as jocc
from keras_nerf_tpu.ops.metrics import psnr as jax_psnr
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu.utils import checkpoint as jckpt
from keras_nerf_tpu_torch import eval_checkpoint, make_scenes, render_frontier
from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene
from keras_nerf_tpu_torch.models import NeRF
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.ops import occupancy as tocc
from keras_nerf_tpu_torch.utils.convert import quantized_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_ATOL = 2e-4
PSNR_ATOL_DB = 0.01
JAX_CFG = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=3,
                             dense_units=256, skip_layer=2)


def _script(name):
    """One of the repo's ``scripts/*.py`` as a module (their ``main`` runs
    only as a script)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(path):
    return sorted(os.path.relpath(os.path.join(root, n), path)
                  for root, _, names in os.walk(path) for n in names)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX-written checkpoint and a JAX-written scene at 16^2."""
    root = tmp_path_factory.mktemp("quality")
    model = str(root / "model")
    state = jengine.init_train_state(jax.random.PRNGKey(3), JAX_CFG,
                                     jengine.make_optimizer("adam"))
    jckpt.save_model(model, state, JAX_CFG)
    data = jax_write_scene(str(root / "scene"), image_wh=16, n_train=1,
                           n_val=1, n_test=2)
    return model, data


def test_scenes_table_equals_jax():
    assert make_scenes.SCENES == _script("make_scenes").SCENES


@pytest.mark.parametrize("kwargs", [
    dict(), dict(scene="hard"), dict(scale=2.0)], ids=["spheres", "hard",
                                                       "scaled2"])
def test_writer_bytes_equal_jax(tmp_path, kwargs):
    """Every PNG and JSON file of a small scene (supersample 4, as the
    committed scenes) byte for byte, and so the digests."""
    kw = dict(image_wh=8, n_train=2, n_val=1, n_test=1, supersample=4,
              **kwargs)
    ours = write_synthetic_scene(str(tmp_path / "port"), **kw)
    theirs = jax_write_scene(str(tmp_path / "jax"), **kw)
    assert _files(ours) == _files(theirs) and len(_files(ours)) == 7
    for rel in _files(ours):
        with open(os.path.join(ours, rel), "rb") as a, \
                open(os.path.join(theirs, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert make_scenes.scene_digest(ours) == make_scenes.scene_digest(theirs)


def test_make_scenes_main_writes_once_and_refuses_unknown(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    monkeypatch.setattr(make_scenes, "_REPO", str(tmp_path))
    monkeypatch.setitem(make_scenes.SCENES, "tiny", ("data/tiny", dict(
        image_wh=8, n_train=1, n_val=1, n_test=1, supersample=4)))
    make_scenes.main(["tiny"])
    make_scenes.main(["tiny"])
    out = capsys.readouterr().out.splitlines()
    digest = json.dumps(make_scenes.scene_digest(str(tmp_path / "data" /
                                                     "tiny")))
    assert out[0].startswith("tiny: wrote data/tiny")
    assert out[2] == "tiny: data/tiny already exists, skipping"
    assert out[1] == out[3] == f"tiny: digest {digest}"
    with pytest.raises(SystemExit, match="unknown scene"):
        make_scenes.main(["nope"])


def _jax_draws(key, n, num_rays, ray_chunks):
    """JAX's draws for a render (``split(key, chunks)``, one
    ``sorted_uniforms`` per chunk) or, with ``ray_chunks`` None, for the
    int8 calibration (``sorted_uniforms(key, (rays,), n)``)."""
    if ray_chunks is None:
        return torch.as_tensor(np.array(
            jax_sorted_uniforms(key, (num_rays,), n)))
    chunk = min(ray_chunks, num_rays)
    return [torch.as_tensor(np.array(jax_sorted_uniforms(k, (chunk,), n)))
            for k in jax.random.split(key, num_rays // chunk)]


def _jax_batches(data, img_wh, seed=42):
    """A fresh JAX loader's test batches (its first epoch), as numpy."""
    _, _, test = JaxLoader(data, True).load_dataset(
        batch_size=1, image_width=img_wh, image_height=img_wh, near=2.0,
        far=6.0, n_sample=JAX_CFG.n_coarse, seed=seed)
    return [jax.tree.map(np.array, b) for b in test]


def test_eval_checkpoint_record_matches_jax_script(checkpoint, monkeypatch,
                                                   capsys):
    """The port's JSON against ``scripts/eval_checkpoint.py``'s on a JAX
    checkpoint, the port fed the JAX script's test batches and its
    evaluation draws (``PRNGKey(seed + 1)``, `nerf.py:211`), both on their
    float32 reference paths."""
    model, data = checkpoint
    argv = ["--model_path", model, "--data_dir", data, "--img_wh", "16",
            "--white_bg"]
    monkeypatch.setattr(sys, "argv", ["eval_checkpoint.py"] + argv)
    _script("eval_checkpoint").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    batches = [(torch.as_tensor(i), tuple(torch.as_tensor(x) for x in r))
               for i, r in _jax_batches(data, 16)]

    class Loader:
        def __init__(self, *args, **kwargs):
            pass

        def load_dataset(self, **kwargs):
            return [], [], batches

    monkeypatch.setattr("keras_nerf_tpu_torch.data.DatasetLoader", Loader)
    monkeypatch.setattr(NeRF, "_eval_draws", lambda self: _jax_draws(
        jax.random.PRNGKey(self._seed + 1), JAX_CFG.n_fine, 256, 16384))
    monkeypatch.setattr(tengine, "resolve_use_kernels",
                        lambda config, device: False)
    got = eval_checkpoint.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == got
    assert got.keys() == want.keys()
    for k in want:
        if k in ("model_path", "split"):
            assert got[k] == want[k]
        else:
            print(f"\neval_checkpoint {k}: port {got[k]} JAX {want[k]} "
                  f"(budget {METRIC_ATOL})")
            assert abs(got[k] - want[k]) <= METRIC_ATOL, k


def _jax_tiers():
    """``(name, family)`` of the JAX script's tier list, read from its
    source (the list is built inside ``main``)."""
    with open(os.path.join(REPO, "scripts", "render_frontier.py")) as f:
        src = f.read()
    body = src[src.index("    tiers = ["):src.index("    if args.tiers:")]
    return re.findall(r'\(\s*"([^"]+)", "([^"]+)",', body)


def test_render_frontier_cpu_run_keeps_jax_record(checkpoint, tmp_path,
                                                  capsys):
    """A whole ``--device cpu`` run at 16^2: the JAX script's ten tiers, in
    its order, with its record and row keys (`render_frontier.py:236-245`,
    the committed record of the JAX run); untimed on the CPU, so no plot."""
    model, data = checkpoint
    out = tmp_path / "frontier.json"
    record = render_frontier.main([
        "--model", model, "--data", data, "--img_wh", "16", "--bench_wh",
        "16", "--iters", "2", "--occ_grid", "16", "--device", "cpu",
        "--out_json", str(out), "--out_png", str(tmp_path / "f.png")])
    with open(os.path.join(REPO, "assets", "render_frontier_r5best.json")) as f:
        jax_record = json.load(f)
    with open(out) as f:
        assert json.load(f) == record
    assert record.keys() == jax_record.keys()
    assert record["backend"] == "cpu"
    names = [(r["tier"], r["family"]) for r in record["rows"]]
    assert names == _jax_tiers() == [(r["tier"], r["family"])
                                     for r in jax_record["rows"]]
    for row, jax_row in zip(record["rows"], jax_record["rows"]):
        assert row.keys() == jax_row.keys()
        assert np.isfinite(row["psnr_db"]) and row["fps"] is None
    assert record["rows"][0]["delta_db"] == 0.0
    assert "plot skipped" in capsys.readouterr().out
    assert not (tmp_path / "f.png").exists()


def test_render_frontier_psnr_matches_jax(checkpoint, monkeypatch):
    """Each tier's test PSNR against the JAX script's ``eval_psnr`` /
    ``occ_psnr`` (`render_frontier.py:103-113`, `:153-163`) on the same
    batches, draws (key 17), grid and int8 dicts: the port's kernel path
    (plain versions) against JAX's kernels in interpret mode."""
    model, data = checkpoint
    img = 8
    args = render_frontier.build_arg_parser().parse_args([
        "--model", model, "--data", data, "--img_wh", str(img),
        "--occ_grid", "16", "--device", "cpu"])
    base = jckpt.load_model_config(model, white_background=True)
    jcfg = dataclasses.replace(base, use_pallas=True)
    pc, pf = jengine.init_params(jax.random.PRNGKey(0), base)
    pc, pf = jckpt.load_weights(model, pc, pf)
    # One test image: JAX's interpret mode takes most of this test's time.
    batches = _jax_batches(data, img)[:1]
    key = jax.random.PRNGKey(17)
    grid = jocc.bake_occupancy_grid(
        jocc.model_density_fn(pf, base), 16, jocc.DEFAULT_AABB,
        sigma_threshold=1.0, dilate=1)
    jq = jengine.quantize_render_params(pc, pf, batches[0][1], key, base)

    def jax_mean(render):
        return float(np.mean([float(jax_psnr(render(r), i[..., :3])[0])
                              for i, r in batches]))

    def std(fast, q):
        cfg = dataclasses.replace(jcfg, fast_render=fast)
        return jax_mean(lambda r: jengine.render_image_batch(
            pc, pf, r, key, cfg, args.ray_chunks, with_weights=False,
            coarse_image=False, packed_q=q)[1]["image"])

    def occ(k, q=None):
        return jax_mean(lambda r: jocc.render_image_batch_occ(
            pf, r, grid, key, jcfg, n_samples=k, ray_chunks=args.ray_chunks,
            packed_q=q)["image"])

    want = [std(0, None), std(0, jq), std(96, None), std(96, jq),
            std(64, None), std(64, jq), occ(64), occ(32), occ(64, jq[1]),
            occ(32, jq[1])]

    monkeypatch.setattr(tocc, "bake_occupancy_grid", lambda *a, **k:
                        torch.as_tensor(np.array(grid)))
    monkeypatch.setattr(tengine, "quantize_render_params", lambda *a, **k:
                        tuple(quantized_from_jax(jax.tree.map(np.array, q),
                                                 "cpu") for q in jq))
    tbase, tpc, tpf, _ = render_frontier.load(args, torch.device("cpu"))
    tbatches = [(torch.as_tensor(i), tuple(torch.as_tensor(x) for x in r))
                for i, r in batches]
    rows, _ = render_frontier.measure_tiers(
        args, tbase, tpc, tpf, tbatches, torch.device("cpu"),
        draws=lambda n, rays, chunks: _jax_draws(key, n, rays, chunks))
    assert len(rows) == len(want) == 10
    for row, w in zip(rows, want):
        print(f"\n{row['tier']}: port {row['psnr_db']:.3f} dB, JAX {w:.4f} "
              f"dB (budget {PSNR_ATOL_DB} dB)")
        assert abs(row["psnr_db"] - w) <= PSNR_ATOL_DB, row["tier"]


def test_eval_checkpoint_reproduces_the_training_clis_final_line(
        tmp_path, caplog):
    """``--jitter_epoch`` reads the test split's depth jitter at the epoch
    the training CLI's monitor left it at, and so its final test line to
    the digit (here 3: the monitor's panel batches read epochs 0-2 of two
    test views over 2 epochs at ``--log_freq 1``); a fresh loader's epoch
    0 reads other depths."""
    import logging

    from keras_nerf_tpu_torch import train_single

    data = write_synthetic_scene(str(tmp_path / "scene"), image_wh=16,
                                 n_train=2, n_val=1, n_test=2)
    with caplog.at_level(logging.INFO):
        train_single.run_training(train_single.build_arg_parser().parse_args(
            ["--name", "run", "--data_dir", data, "--img_wh", "16",
             "--white_bg", "--num_epochs", "2", "--num_coarse_samples", "8",
             "--num_fine_samples", "8", "--num_layers", "2",
             "--ray_chunks", "256", "--log_dir", str(tmp_path / "logs"),
             "--model_dirs", str(tmp_path / "model"), "--device", "cpu"]))
    line = next(r.getMessage() for r in caplog.records
                if r.getMessage().startswith("Final test metrics"))
    want = {k: float(v) for k, v in
            (kv.split("=") for kv in line.split(": ", 1)[1].split())}
    argv = ["--model_path", str(tmp_path / "model" / "run"), "--data_dir",
            data, "--img_wh", "16", "--white_bg", "--ray_chunks", "256",
            "--device", "cpu"]
    got = eval_checkpoint.main(argv + ["--jitter_epoch", "3"])
    assert {k: got[k] for k in want} == want
    fresh = eval_checkpoint.main(argv)
    assert fresh["fine_psnr"] != got["fine_psnr"]
