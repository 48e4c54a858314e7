"""The port's int8 simulation, aabb demo and run-log tools
(``quantize_sim_ptq``, ``aabb_demo``, ``extract_milestones``,
``plot_quality``, ``plot_compare``) against the JAX package's scripts, on
the CPU, both sides fed the same numpy inputs made from a seed. Budgets,
each with its reason:

* ``calibrate``: rtol ``CALIB_RTOL`` 2e-6. Both forwards are float32 dots
  of at most 128 terms whose sums round apart by a few ulps; an amax picks
  one of them (read: 4.3e-7 relative). Below the 100th percentile, rtol
  ``PERCENTILE_RTOL`` 5e-5: both interpolate linearly between the two
  order statistics around rank ``q / 100 (n - 1)``, in float32, but
  ``jnp.percentile`` compiled by XLA on the CPU lands up to 1.4e-5
  relative away from the port (and from ``np.percentile``), about 1e-4 of
  the step between the two order statistics.
* ``qdense_grids``: the int8 codes equal, except where the value rounded
  lies within ``HALF_ULPS`` (16) float32 ulps of a .5 boundary, where the
  two float32 chains of one formula may round to neighbouring codes; those
  are counted and printed, each one code apart. Both sides get JAX's
  activations and scales.
* ``sim_apply_mlp`` on a 3 x 64 MLP: rgb and sigma within ``SIM_ATOL``
  2e-4 absolute. The same grids give the same integer sums; the float32
  dequantization, the bias and the next layer's input then round apart
  by ulps, and a code that crosses a .5 boundary moves one activation by
  one step (the count is printed).
* ``render_pair``: the fine image within ``IMAGE_ATOL`` 1e-4 on JAX's
  draws (both float32 reference paths; ``test_torch_render.py``'s budget
  for them).
* ``aabb_demo.split_psnr``: ``PSNR_ATOL_DB`` 0.01 dB on JAX's batches and
  draws, the exact render on both reference paths
  (``test_torch_quality_tools.py``'s budget).
* the log tools: equal, value for value and line for line, on JAX's
  ``assets/quality128_r5best_run.log`` and the port's
  ``assets/quality128_r5best_torch_run.log``.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.data.loader import DatasetLoader as JaxLoader
from keras_nerf_tpu.data.synthetic import (
    write_synthetic_scene as jax_write_scene,
)
from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.ops.encoding import encode_position_and_directions
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu.utils import checkpoint as jckpt
from keras_nerf_tpu_torch import (aabb_demo, extract_milestones,
                                  plot_compare, plot_quality,
                                  quantize_sim_ptq)
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB_RTOL = 2e-6
PERCENTILE_RTOL = 5e-5
HALF_ULPS = 16
SIM_ATOL = 2e-4
IMAGE_ATOL = 1e-4
PSNR_ATOL_DB = 0.01
LOGS = ("quality128_r5best_run.log", "quality128_r5best_torch_run.log")
JAX_CFG = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=3,
                             dense_units=64, skip_layer=2,
                             white_background=True, use_pallas=False)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def sim():
    """The JAX script, a seeded 3 x 64 pair of MLPs (JAX's and the same
    weights in the port), and encodings of 512 seeded points."""
    script = _script("quantize_sim_ptq")
    pc, pf = jengine.init_params(jax.random.PRNGKey(3), JAX_CFG)
    rng = np.random.default_rng(11)
    o = rng.uniform(-0.2, 0.2, (64, 3)).astype(np.float32)
    o[:, 2] += 4.0
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2.0, 6.0, (64, 8)), -1).astype(np.float32)
    ex, ed = encode_position_and_directions(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), 10, 4)
    ex, ed = (np.asarray(x).reshape(-1, x.shape[-1]) for x in (ex, ed))
    return dict(script=script, jax=(pc, pf),
                port=tuple(params_from_jax(p, "cpu") for p in (pc, pf)),
                enc=(ex, ed), rays=(o, d, t))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("percentile", [100.0, 99.9])
def test_calibrate_matches_jax(sim, percentile):
    ex, ed = sim["enc"]
    want = sim["script"].calibrate(sim["jax"][0], jnp.asarray(ex),
                                   jnp.asarray(ed), JAX_CFG.mlp, percentile)
    got = quantize_sim_ptq.calibrate(sim["port"][0], _t(ex), _t(ed),
                                     JAX_CFG.mlp, percentile)
    assert got.keys() == want.keys()
    budget = CALIB_RTOL if percentile >= 100.0 else PERCENTILE_RTOL
    worst = max(float(np.max(np.abs(got[k].numpy() - np.asarray(want[k]))
                             / np.abs(np.asarray(want[k])))) for k in want)
    print(f"\ncalibrate p{percentile}: worst relative gap {worst:.3g} "
          f"(budget {budget})")
    assert worst <= budget


class _DotSpy:
    """Stands in for the JAX script's ``jnp``: records the operands of each
    ``jnp.dot``, which in ``_qdense`` are the two integer grids."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def dot(self, a, b):
        self.calls.append((np.asarray(a), np.asarray(b)))
        return jnp.dot(a, b)


def _near_half(v: np.ndarray) -> np.ndarray:
    """Where ``v`` lies within HALF_ULPS float32 ulps of a .5 boundary."""
    v = np.abs(v.astype(np.float64))
    ulp = np.spacing(np.maximum(v, 1.0).astype(np.float32)).astype(np.float64)
    return np.abs(v - np.floor(v) - 0.5) <= HALF_ULPS * ulp


@pytest.mark.parametrize("mode", ["feature", "tensor", "smooth"])
def test_qdense_grids_match_jax(sim, mode, monkeypatch):
    script = sim["script"]
    ex, ed = sim["enc"]
    params = sim["jax"][1]
    acts = script.forward_collect(params, jnp.asarray(ex), jnp.asarray(ed),
                                  JAX_CFG.mlp)
    scales = script.calibrate(params, jnp.asarray(ex), jnp.asarray(ed),
                              JAX_CFG.mlp, 100.0)
    layers = {f"trunk{i}": params["trunk"][i] for i in range(3)}
    layers.update({k: params[k] for k in ("sigma", "features",
                                          "rgb_features", "rgb")})
    spy = _DotSpy()
    monkeypatch.setattr(script, "jnp", spy)
    flips = 0
    for name, p in layers.items():
        script._qdense(acts[name], p, scales[name], relu=False, mode=mode)
        want_x, want_w = spy.calls[-1]
        tp = {k: _t(v) for k, v in p.items()}
        x, s = _t(acts[name]), _t(scales[name])
        xq, wq, _ = quantize_sim_ptq.qdense_grids(x, tp, s, mode)
        # The values the codes round, recomputed in float64 to find the
        # boundary cases.
        pre_x = _pre_round(x.double(), tp["kernel"].double(), s.double(),
                           mode)
        for got, want, pre in ((xq.numpy(), want_x, pre_x),
                               (wq.numpy(), want_w, None)):
            diff = got != want
            if pre is not None:
                assert np.all(_near_half(pre[diff])), name
            else:
                assert not diff.any(), name
            assert np.all(np.abs(got - want)[diff] == 1)
            flips += int(diff.sum())
    print(f"\nqdense {mode}: {flips} codes one step apart, each within "
          f"{HALF_ULPS} ulps of a .5 boundary")


def _pre_round(x, w, s_in, mode):
    if mode == "feature":
        return (x / s_in * 127.0).numpy()
    if mode == "smooth":
        m = torch.sqrt(s_in / w.abs().amax(dim=1).clamp(min=1e-8)).clamp(
            min=1e-8)
    else:
        m = torch.ones_like(s_in)
    return (x / m / torch.max(s_in / m) * 127.0).numpy()


@pytest.mark.parametrize("mode", ["feature", "tensor", "smooth"])
def test_sim_apply_mlp_matches_jax(sim, mode):
    script = sim["script"]
    ex, ed = sim["enc"]
    params = sim["jax"][1]
    scales = script.calibrate(params, jnp.asarray(ex), jnp.asarray(ed),
                              JAX_CFG.mlp, 100.0)
    want = script.sim_apply_mlp(params, scales, jnp.asarray(ex),
                                jnp.asarray(ed), JAX_CFG.mlp, mode)
    got = quantize_sim_ptq.sim_apply_mlp(
        sim["port"][1], {k: _t(v) for k, v in scales.items()}, _t(ex),
        _t(ed), JAX_CFG.mlp, mode)
    gaps = [float(np.max(np.abs(g.numpy() - np.asarray(w))))
            for g, w in zip(got, want)]
    print(f"\nsim_apply_mlp {mode}: rgb {gaps[0]:.3g}, sigma {gaps[1]:.3g} "
          f"(budget {SIM_ATOL})")
    assert max(gaps) <= SIM_ATOL


def test_render_pair_matches_jax_on_its_draws(sim):
    script = sim["script"]
    o, d, t = sim["rays"]
    key = jax.random.PRNGKey(5)
    (jc, jf), (tc, tf) = sim["jax"], sim["port"]
    from keras_nerf_tpu.models.mlp import apply_mlp as jax_apply
    from keras_nerf_tpu_torch.models.mlp import apply_mlp as port_apply

    _, want = script.render_pair(
        lambda a, b: jax_apply(jc, a, b, JAX_CFG.mlp),
        lambda a, b: jax_apply(jf, a, b, JAX_CFG.mlp), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t), key, JAX_CFG)
    draws = _t(jax_sorted_uniforms(key, (o.shape[0],), JAX_CFG.n_fine))
    _, got = quantize_sim_ptq.render_pair(
        lambda a, b: port_apply(tc, a, b, JAX_CFG.mlp),
        lambda a, b: port_apply(tf, a, b, JAX_CFG.mlp), _t(o), _t(d), _t(t),
        draws, JAX_CFG)
    gap = float(np.max(np.abs(got.image.numpy() - np.asarray(want.image))))
    print(f"\nrender_pair fine image: {gap:.3g} (budget {IMAGE_ATOL})")
    assert gap <= IMAGE_ATOL


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX-written 3 x 64 checkpoint and JAX-written 16^2 scenes: the
    spheres and the scale-2 spheres."""
    root = tmp_path_factory.mktemp("a15q")
    model = str(root / "model")
    state = jengine.init_train_state(jax.random.PRNGKey(3), JAX_CFG,
                                     jengine.make_optimizer("adam"))
    jckpt.save_model(model, state, JAX_CFG)
    kw = dict(image_wh=16, n_train=1, n_val=1, n_test=2)
    return (model, jax_write_scene(str(root / "scene"), **kw),
            jax_write_scene(str(root / "scaled2"), scale=2.0, **kw))


def test_split_psnr_matches_jax(checkpoint):
    model, data, _ = checkpoint
    pc, pf = jengine.init_params(jax.random.PRNGKey(0), JAX_CFG)
    pc, pf = jckpt.load_weights(model, pc, pf)
    _, _, test = JaxLoader(data, True).load_dataset(
        batch_size=1, image_width=16, image_height=16, near=2.0, far=6.0,
        n_sample=JAX_CFG.n_coarse, seed=42)
    batches = [jax.tree.map(np.array, b) for b in test]
    key = jax.random.PRNGKey(42)
    want = _script("aabb_demo").split_psnr(
        None, batches, lambda r: jengine.render_image_batch(
            pc, pf, r, key, JAX_CFG, 256, with_weights=False,
            coarse_image=False)[1])
    draws = [_t(jax_sorted_uniforms(k, (256,), JAX_CFG.n_fine))
             for k in jax.random.split(key, 1)]
    tcfg = tengine.NeRFConfig(**{f.name: getattr(JAX_CFG, f.name)
                                 for f in dataclasses.fields(
                                     tengine.NeRFConfig)
                                 if hasattr(JAX_CFG, f.name)})
    tcfg = dataclasses.replace(tcfg, use_kernels=False)
    tpc, tpf = (params_from_jax(p, "cpu") for p in (pc, pf))
    got = aabb_demo.split_psnr(
        [(_t(i), tuple(_t(x) for x in r)) for i, r in batches],
        lambda r: tengine.render_image_batch(
            tpc, tpf, r, draws, tcfg, 256, with_weights=False,
            coarse_image=False)[1])
    print(f"\nsplit_psnr: port {got:.4f} dB, JAX {want:.4f} dB (budget "
          f"{PSNR_ATOL_DB})")
    assert abs(got - want) <= PSNR_ATOL_DB


def test_aabb_demo_cpu_run_prints_the_jax_record(checkpoint, capsys):
    model, _, scaled = checkpoint
    out = aabb_demo.main(["--model_path", model, "--data_dir", scaled,
                          "--img_wh", "16", "--white_bg", "--ray_chunks",
                          "256", "--occ_grid", "16", "--occ_samples", "8",
                          "--aabb", "-4", "-4", "-4", "4", "4", "4",
                          "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu" and json.loads(lines[-1]) == out
    with open(os.path.join(REPO, "assets", "aabb_demo.log")) as f:
        jax_record = json.loads(f.read().strip().splitlines()[-1])
    assert out.keys() == jax_record.keys()
    assert all(np.isfinite(out[k]) for k in out if k != "aabb")
    # The box of side 8 covers 8x the default's volume with the same voxels.
    assert out["correct_grid_occupied_frac"] <= 1.0


def test_quantize_sim_ptq_cpu_run_prints_every_field(checkpoint, capsys):
    model, data, _ = checkpoint
    out = quantize_sim_ptq.main([
        "--model", model, "--data", data, "--img_wh", "8", "--ray_chunks",
        "32", "--calib_points", "256", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    assert json.loads(lines[-1]) == {"quantize_sim_ptq": out}
    assert [x.split(":")[0].strip() for x in lines[1:4]] == [
        "f32", "int8 c+f", "int8 fine"]
    assert out["delta_fine"] == pytest.approx(out["psnr_int8_fine"]
                                              - out["psnr_f32"])
    assert all(np.isfinite(v) for k, v in out.items()
               if k.startswith(("psnr", "delta")))


@pytest.mark.parametrize("log", LOGS)
def test_read_run_log_and_milestones_match_jax(log):
    path = os.path.join(REPO, "assets", log)
    jax_pq = _script("plot_quality")
    want_cols, want_times = jax_pq.read_run_log(path)
    got_cols, got_times = plot_quality.read_run_log(path)
    assert got_cols == want_cols and got_times == want_times
    assert len(got_cols["epoch"]) == 100
    for thresholds in ((25.0, 28.0, 30.0), (33.0, 39.0, 45.0)):
        assert (plot_quality.milestone_table(
            got_cols["epoch"], got_cols["val_fine_psnr"], got_times,
            thresholds) == jax_pq.milestone_table(
            want_cols["epoch"], want_cols["val_fine_psnr"], want_times,
            thresholds))


@pytest.mark.parametrize("log", LOGS)
def test_extract_milestones_prints_the_jax_scripts_lines(log, monkeypatch,
                                                         capsys):
    path = os.path.join(REPO, "assets", log)
    argv = [path, "--thresholds", "25", "30", "33", "45"]
    monkeypatch.setattr(sys, "argv", ["extract_milestones.py"] + argv)
    _script("extract_milestones").main()
    want = capsys.readouterr().out.strip().splitlines()
    out = extract_milestones.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert got[0] == "cpu" and got[1:-1] == want
    assert json.loads(got[-1]) == {"extract_milestones": out}
    assert out["milestones"]["45.0"] is None


def test_plot_tools_without_matplotlib_still_print_the_table(
        monkeypatch, capsys, tmp_path):
    run_log = os.path.join(REPO, "assets", LOGS[1])
    csv = os.path.join(REPO, "assets", "quality128_r5best_torch_log.csv")
    drawn = plot_quality.main([csv, "--run_log", run_log, "--out_png",
                               str(tmp_path / "q.png"), "--device", "cpu"])
    assert drawn["png"] and (tmp_path / "q.png").exists()
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = plot_quality.main([csv, "--run_log", run_log, "--out_png",
                             str(tmp_path / "q2.png"), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "plot skipped: matplotlib is not installed" in text
    assert "| ≥30 dB | 9 |" in text and out["png"] is None
    assert out["rows"] == drawn["rows"] and out["best_epoch"] == 96
    cmp = plot_compare.main([str(tmp_path / "c.png"), f"torch={run_log}",
                             f"jax={os.path.join(REPO, 'assets', LOGS[0])}",
                             "--device", "cpu"])
    text = capsys.readouterr().out
    assert "plot skipped" in text and cmp["png"] is None
    assert cmp["milestones"]["torch"] == out["rows"]
    assert not (tmp_path / "q2.png").exists()
    assert not (tmp_path / "c.png").exists()
