"""The port's lr probe, real-scene drill and step profiler
(``keras_nerf_tpu_torch/lr_probe.py``, ``real_scene_drill.py``,
``profile_step.py``) against the JAX package's scripts, on the CPU.

* ``lr_probe``: 2 arms x 2 epochs x 3 steps at 16^2, 3 x 64, each arm's
  per-epoch val PSNR against ``scripts/lr_probe.py``'s ``run_arm`` on the
  same data (JAX's loader's batches, epoch by epoch), the same initial
  weights (JAX's, from the seed's key) and the same fine draws (the JAX
  script's keys), both on their float32 reference paths; the ranking
  equal. Budget ``PROBE_PSNR_ATOL``, 2e-3 dB: the two float32 paths'
  matmuls and sums round apart by about 1e-7 relative, and Adam's
  sign-like update on near-zero gradients magnifies that
  (``tests/test_torch_parallel_fit.py``'s C15 run: 2.8e-4 of a tensor's
  displacement after 40 steps); read 6.0e-4 dB here. A planted fault, the
  first arm at 1.01 x its learning rate, reads 2.4e-2 dB and must break
  it.
* the drill: the 800 -> 128 resize path at a 64^2 source resized to 16^2,
  the loader's ``antialias-bilinear`` images bit for bit JAX's; then the
  drill itself on the CPU at that size, its checks and report.
* ``profile_step --device cpu``: runs and prints every field.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import importlib.util
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from keras_nerf_tpu.data.loader import DatasetLoader as JaxLoader
from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu_torch import lr_probe, profile_step, real_scene_drill
from keras_nerf_tpu_torch.data import DatasetLoader
from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene
from keras_nerf_tpu_torch.models import NeRF
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_PSNR_ATOL = 2e-3
TINY_MODEL = ["--num_layers", "3", "--num_units", "64", "--skip_layer", "2",
              "--num_coarse_samples", "8", "--num_fine_samples", "8"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_synthetic_scene(str(tmp_path_factory.mktemp("scene")),
                                 image_wh=16, n_train=4, n_val=2, n_test=2)


def _draws(key, num_rays, chunk, n):
    """JAX's draws for one step or render: ``split(key, chunks)``, one
    ``sorted_uniforms`` a chunk."""
    return [torch.as_tensor(np.array(jax_sorted_uniforms(k, (chunk,), n)))
            for k in jax.random.split(key, num_rays // chunk)]


def test_lr_probe_matches_jax_script(scene, monkeypatch, capsys):
    args = lr_probe.build_arg_parser().parse_args(
        ["--data_dir", scene, "--img_wh", "16", "--white_bg", "--epochs", "2",
         "--steps_per_epoch", "3", "--ray_chunks", "128", "--device", "cpu",
         "--recipes", "1e-3:0", "5e-3:1e-5", *TINY_MODEL])
    jcfg = jengine.NeRFConfig(
        n_coarse=8, n_fine=8, n_layers=3, dense_units=64, skip_layer=2,
        white_background=True, compute_dtype="float32", use_pallas=False)
    train_ds, val_ds, _ = JaxLoader(scene, True).load_dataset(
        batch_size=1, image_width=16, image_height=16, near=2.0, far=6.0,
        n_sample=8, seed=args.seed)
    val_batches = list(val_ds)
    jax_probe = _script("lr_probe")
    recipes = [lr_probe.parse_recipe(r) for r in args.recipes]
    want = {lr_probe.recipe_label(*r): jax_probe.run_arm(
        *r, (train_ds, val_batches), args, jcfg) for r in recipes}

    # The port fed JAX's data, weights and draws.
    train_ds._epoch = 0
    epochs = [[jax.tree.map(np.array, b) for b in train_ds]
              for _ in range(args.epochs)]

    class Replay:
        _epoch = 0

        def __len__(self):
            return len(epochs[0])

        def __iter__(self):
            self._epoch += 1
            return iter(epochs[self._epoch - 1])

    steps, key = args.steps_per_epoch, jax.random.PRNGKey(args.seed + 1)
    count = {"train": 0}
    init = tengine.init_train_state
    start = [params_from_jax(jax.tree.map(np.asarray, p), "cpu") for p in
             jengine.init_params(jax.random.PRNGKey(args.seed), jcfg)]

    def jax_init(gen, config, optimizer, device=None):
        count["train"] = 0
        return init(gen, config, optimizer)._replace(
            coarse_params=start[0], fine_params=start[1])

    train_step, eval_step = NeRF._train_step, NeRF._eval_step

    def jax_train_draws(self, batch, fine_draws=None, indices=None):
        i = count["train"]
        count["train"] += 1
        return train_step(self, batch, _draws(
            jax.random.fold_in(key, i), 256, 128, 8), indices)

    def jax_eval_draws(self, batch, fine_draws=None):
        epoch = count["train"] // steps - 1
        return eval_step(self, batch, _draws(
            jax.random.fold_in(key, args.epochs * steps + epoch), 256, 128,
            8))

    monkeypatch.setattr(tengine, "init_train_state", jax_init)
    monkeypatch.setattr(NeRF, "_train_step", jax_train_draws)
    monkeypatch.setattr(NeRF, "_eval_step", jax_eval_draws)
    monkeypatch.setattr(tengine, "resolve_use_kernels", lambda c, d: False)
    datasets = (Replay(), [jax.tree.map(np.array, b) for b in val_batches])
    got = {lr_probe.recipe_label(*r): lr_probe.run_arm(*r, datasets, args)
           for r in recipes}
    for label in want:
        gap = max(abs(a - b) for a, b in zip(got[label], want[label]))
        with capsys.disabled():
            print(f"\nlr_probe arm [{label}]: port {got[label]} JAX "
                  f"{want[label]}; largest gap {gap:.2e} dB (budget "
                  f"{PROBE_PSNR_ATOL})")
        assert len(got[label]) == args.epochs and gap <= PROBE_PSNR_ATOL
    # A planted fault must break the budget: the first arm at 1.01 x its
    # learning rate.
    lr, lr_final = recipes[0]
    planted = lr_probe.run_arm(lr * 1.01, lr_final, datasets, args)
    gap = max(abs(a - b) for a, b in zip(
        planted, want[lr_probe.recipe_label(lr, lr_final)]))
    with capsys.disabled():
        print(f"lr_probe, the first arm at 1.01 x its learning rate: gap "
              f"{gap:.2e} dB (must exceed the budget)")
    assert gap > PROBE_PSNR_ATOL
    rows = [(label, curve, 0.0, 0.0) for label, curve in got.items()]
    assert ([r[0] for r in lr_probe.ranking(rows)]
            == sorted(want, key=lambda k: -want[k][-1]))

    # The CLI on its own draws: every printed field.
    monkeypatch.undo()
    capsys.readouterr()
    ranked = lr_probe.main(["--data_dir", scene, "--img_wh", "16",
                            "--white_bg", "--epochs", "2",
                            "--steps_per_epoch", "3", "--ray_chunks", "128",
                            "--device", "cpu", "--recipes", "1e-3:0",
                            "5e-3:1e-5", *TINY_MODEL])
    out = capsys.readouterr().out
    assert len(ranked) == 2 and "=== probe ranking" in out
    assert "arm [constant 0.001]:" in out and "recommendation: base lr" in out


def test_drill_resize_is_jax_antialias_bilinear(tmp_path):
    """The drill's 800 -> 128 path at a 64^2 source resized to 16^2: the
    loader's images (every split) bit for bit JAX's loader's."""
    data = write_synthetic_scene(str(tmp_path / "lego"), image_wh=64,
                                 n_train=3, n_val=2, n_test=2)
    kw = dict(batch_size=1, image_width=16, image_height=16, near=2.0,
              far=6.0, n_sample=8, seed=0)
    mine = DatasetLoader(data, True, resize_method="antialias-bilinear",
                         device="cpu").load_dataset(**kw)
    theirs = JaxLoader(data, True, resize_method="antialias-bilinear"
                       ).load_dataset(**kw)
    for m, t in zip(mine, theirs):
        m_img, t_img = m.images, np.asarray(t.images)
        assert m_img.shape == t_img.shape and m_img.shape[1:3] == (16, 16)
        np.testing.assert_array_equal(m_img, t_img)
        np.testing.assert_array_equal(m.poses, np.asarray(t.poses))


def test_drill_runs_its_checks_on_the_cpu(tmp_path):
    report = real_scene_drill.main([
        "--source_wh", "64", "--img_wh", "16", "--n_train", "4", "--epochs",
        "2", "--device", "cpu", "--out", str(tmp_path / "drill"), "--",
        "--ray_chunks", "256", *TINY_MODEL])
    checks = report["checks"]
    before, after = checks["val fine loss: seed's weights -> trained"]
    assert after < before and checks["log.csv rows"] == 2
    assert "train fine loss: first -> last epoch" in checks
    assert os.path.isdir(checks["checkpoint"])
    panels = importlib.util.find_spec("matplotlib") is not None
    assert ("panels" in checks) == panels
    assert (report["skipped"] == []) == panels
    assert isinstance(report["model"], NeRF)


def test_profile_step_on_the_cpu_prints_every_field(capsys):
    out = profile_step.main(["--device", "cpu", "--img_wh", "8", "--chunks",
                             "32", "64", "--iters", "1"])
    printed = capsys.readouterr().out
    record = json.loads(printed.strip().splitlines()[-1])["profile_step"]
    assert record == json.loads(json.dumps(out))
    assert set(out["train_step_ms"]) == {"32", "64"}
    assert all(v > 0 for v in out["train_step_ms"].values())
    comps = out["components_ms"]
    assert list(comps) == [*profile_step.COMPONENTS, "other"]
    assert all(comps[c] > 0 for c in profile_step.COMPONENTS)
    assert abs(sum(comps.values()) - out["instrumented_step_ms"]) < 1e-6
    tl = out["host_timeline"]
    # Per step at 2 chunks: each model's MLP, quadrature, backward and
    # weight gradient per chunk, sample_merge once per chunk.
    assert tl["launches_by_name"] == {
        "ray_march_mlp": 4, "ray_march_quadrature": 4, "mlp_backward": 4,
        "mlp_weight_grad": 4, "sample_merge": 2}
    assert tl["launches"] == 18 and len(tl["longest_gaps"]) == 5
    # On the CPU each launch is a wrapper's own range.
    assert tl["launches_by_range"] == tl["launches_by_name"]
    assert tl["queue_full_ms"] == 0.0
    for g in tl["longest_gaps"]:
        assert g["gap_ms"] >= 0 and g["after"] and g["before"] and g["host"]
    for line in ("train_step chunks=    32", "component        ray batch",
                 "component            other", "host timeline", "host gap"):
        assert line in printed
    assert isinstance(out, dict) and not isinstance(out, types.ModuleType)
