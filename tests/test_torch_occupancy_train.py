"""The port's occupancy-train tier against the JAX package's, on the CPU.

Parameters drawn by JAX and carried over with ``params_from_jax``; the same
rays, grid and targets; the fine draws injected: JAX's
``sorted_uniforms(fold_in(k, 7), (R,), n_samples)`` for each chunk key ``k``
of ``split(key, num_chunks)``, the stream its occupancy step draws. Budgets,
each with its reason:

* ``probe_rows_for_poses``: equal, bit for bit (the port's rays are JAX's
  bit for bit and the probe is the same float32 arithmetic);
* the reference path (``use_kernels=False``) against JAX's XLA step
  (``use_pallas=False``): losses rtol 1e-5, gradients relative max 1e-4,
  as ``test_torch_train.py::test_reference_train_step_matches_jax_xla_step``;
* the kernel path (the plain versions) against JAX's fused step in
  interpret mode (``use_pallas=True``, whose prologue samples the fine
  depths): the budgets of
  ``test_torch_train.py::test_fused_train_step_matches_jax_fused_step``,
  losses rtol 0.03, per-leaf gradients relative norm 0.03 and relative max
  0.12 (bf16 operands; the prologue's CDF lies one float32 rounding from
  the port's);
* the cached-rows step against the probed step: equal, bit for bit;
* the occupancy step's coarse gradients against the exact step's: atol
  2e-6 (`tests/models/test_occupancy_train.py:62`);
* ``NeRF.fit``'s bake schedule: the same epochs bake, hold a grid and
  rebuild the cache as in JAX's ``NeRF.fit``, epoch for epoch.

Gradients of a step are read as the SGD (lr 1) parameter change. ``-s``
prints each reading beside its budget.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.data.loader import NeRFDataset as JaxDataset
from keras_nerf_tpu.data.utils import pose_spherical as jpose
from keras_nerf_tpu.models import NeRF as JaxNeRF
from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.ops import occupancy as jocc
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu.utils import checkpoint as jckpt
from keras_nerf_tpu_torch.data import NeRFDataset
from keras_nerf_tpu_torch.models import NeRF
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.ops import occupancy as tocc
from keras_nerf_tpu_torch.utils.convert import params_from_jax, params_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_REL_NORM, GRAD_REL_MAX, LOSS_RTOL = 0.03, 0.12, 0.03
REF_LOSS_RTOL, REF_GRAD_REL_MAX = 1e-5, 1e-4
B, H, W, CHUNK = 1, 4, 8, 16
N_SAMPLES, N_PROBE, GRID = 8, 8, 8
NEAR, FAR = 2.0, 6.0


def _report(what, reading, budget):
    print(f"\n{what}: {reading:.3e} (budget {budget:g})")
    assert reading <= budget, what


def _spec(merge):
    return (N_SAMPLES, N_PROBE, NEAR, FAR, jocc.DEFAULT_AABB, merge)


def _grid(g=GRID, radius=1.2, seed=0):
    """A ball with holes: rays with occupied and empty runs of bins."""
    c = (np.arange(g) + 0.5) / g * 4.0 - 2.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    occ = (x * x + y * y + z * z < radius * radius).astype(np.float32)
    holes = np.random.default_rng(seed).uniform(size=occ.shape) < 0.3
    return np.where(holes, 0.0, occ).astype(np.float32)


def _batch(n_coarse, seed=0):
    """Rays from near (0, 0, 4) looking down -z, most through the ball."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, H, W, 4)).astype(np.float32)
    o = np.zeros((B, H, W, 3), np.float32)
    o[..., 2] = 4.0
    o[..., :2] += rng.uniform(-0.5, 0.5, (B, H, W, 2)).astype(np.float32)
    d = np.float32([0.0, 0.0, -1.0]) + rng.normal(0, 0.35, (B, H, W, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = np.sort(rng.uniform(NEAR, FAR, (B, H, W, n_coarse)), -1).astype(
        np.float32)
    return images, (o, d, t)


def _occ_draws(key):
    """JAX's occupancy draws: per chunk key, ``fold_in(k, 7)``."""
    return [torch.as_tensor(np.array(jax_sorted_uniforms(
        jax.random.fold_in(k, 7), (CHUNK,), N_SAMPLES)))
            for k in jax.random.split(key, B * H * W // CHUNK)]


def _port_cfg(jcfg, use_kernels):
    return tengine.NeRFConfig(**jcfg.to_model_config(),
                              white_background=jcfg.white_background,
                              use_kernels=use_kernels)


def _port_state(s0, opt):
    p = [params_from_jax(jax.tree.map(np.asarray, x), "cpu")
         for x in (s0.coarse_params, s0.fine_params)]
    return tengine.TrainState(p[0], p[1], opt.init(p[0]), opt.init(p[1]), 0)


def _grads(s0, s1, tree=lambda p: p):
    """Per model, the SGD (lr 1) parameter change as JAX-layout trees of
    float64 arrays (``tree`` maps a state's parameters to that layout)."""
    return [jax.tree.map(lambda a, b: np.asarray(a, np.float64)
                         - np.asarray(b, np.float64), tree(p), tree(q))
            for p, q in ((s0.coarse_params, s1.coarse_params),
                         (s0.fine_params, s1.fine_params))]


def _rel(a, b):
    return (np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12),
            np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _sgd_steps(jcfg, use_kernels, merge, seed=0):
    """One occupancy step (SGD, lr 1) of each package from the same state,
    batch, grid and draws: ``(jax metrics, port metrics, jax grads, port
    grads)``."""
    opt_j = jengine.make_optimizer("sgd", 1.0)
    s0 = jengine.init_train_state(jax.random.PRNGKey(seed), jcfg, opt_j)
    images, rays = _batch(jcfg.n_coarse)
    key = jax.random.PRNGKey(5)
    grid = _grid()
    s1, m_j = jengine.train_step(
        s0, (jnp.asarray(images), tuple(map(jnp.asarray, rays))), key,
        jnp.asarray(grid), optimizer=opt_j, config=jcfg, ray_chunks=CHUNK,
        occupancy=_spec(merge))
    opt_t = tengine.make_optimizer("sgd", 1.0)
    t0 = _port_state(s0, opt_t)
    t1, m_t = tengine.train_step(
        t0, (torch.as_tensor(images), tuple(torch.as_tensor(x) for x in rays)),
        _occ_draws(key), opt_t, _port_cfg(jcfg, use_kernels), CHUNK,
        occupancy=_spec(merge), occ_grid=torch.as_tensor(grid))
    return (m_j, {k: float(v) for k, v in m_t.items()}, _grads(s0, s1),
            _grads(t0, t1, params_to_jax))


def _assert_grads(label, got, want, rel_norm, rel_max):
    worst = (0.0, 0.0)
    for model, a, b in zip(("coarse", "fine"), got, want):
        for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                                jax.tree.leaves(b)):
            rn, rm = _rel(x, y)
            assert rn <= rel_norm and rm <= rel_max, (
                label, model, jax.tree_util.keystr(path), rn, rm)
            worst = (max(worst[0], rn), max(worst[1], rm))
    _report(f"{label}: worst leaf relative norm", worst[0], rel_norm)
    _report(f"{label}: worst leaf relative max", worst[1], rel_max)


# ------------------------------------------------------- probe_rows_for_poses


@pytest.mark.parametrize("chunk_points", [None, 2 * 12 * 10 * N_PROBE])
def test_probe_rows_for_poses_bit_identical(monkeypatch, chunk_points):
    """Three views against a 16^3 ball with holes, whole (one chunk) and in
    chunks of two images: JAX's uint8 rows, bit for bit."""
    if chunk_points is not None:
        monkeypatch.setattr(tocc, "PROBE_ROWS_POINTS", chunk_points)
    poses = np.stack([jpose(a, -30.0, 4.0) for a in (10.0, 130.0, 250.0)])
    grid = _grid(16)
    kw = dict(image_height=12, image_width=10, near=NEAR, far=FAR,
              n_probe=N_PROBE)
    want = np.asarray(jocc.probe_rows_for_poses(
        jnp.asarray(poses), 11.0, jnp.asarray(grid), **kw))
    got = tocc.probe_rows_for_poses(poses, 11.0, torch.as_tensor(grid), **kw)
    assert got.dtype == torch.uint8 and got.shape == (3, 120, N_PROBE)
    assert 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ one occupancy step


@pytest.mark.parametrize("merge", [True, False])
def test_reference_occupancy_step_matches_jax_xla_step(merge):
    """``use_kernels=False``: autograd over the float32 reference, the fine
    pass on ``sample_occupied`` depths (merged with the stratified ones or
    not), against JAX's ``use_pallas=False`` occupancy step."""
    jcfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=3,
                              dense_units=64, skip_layer=2,
                              white_background=True,
                              compute_dtype="float32", use_pallas=False)
    m_j, m_t, g_j, g_t = _sgd_steps(jcfg, False, merge)
    for k in ("coarse_loss", "fine_loss"):
        _report(f"reference occupancy step (merge {merge}) {k}, relative",
                abs(m_t[k] - float(m_j[k])) / float(m_j[k]), REF_LOSS_RTOL)
    _assert_grads(f"reference occupancy step (merge {merge})", g_t, g_j,
                  np.inf, REF_GRAD_REL_MAX)


@pytest.mark.parametrize("merge", [True, False])
def test_fused_occupancy_step_matches_jax_fused_step(merge):
    """The kernel path (plain versions on the CPU: ``sample_merge`` in its
    partner mode with the stratified depths, or in its no-merge mode, then
    T3) against JAX's fused occupancy step in interpret mode, at 2 x 256."""
    jcfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                              dense_units=256, skip_layer=4,
                              white_background=True,
                              compute_dtype="bfloat16", use_pallas=True)
    m_j, m_t, g_j, g_t = _sgd_steps(jcfg, None, merge)
    for k in ("coarse_loss", "fine_loss", "coarse_grad_norm",
              "fine_grad_norm", "fine_psnr"):
        _report(f"fused occupancy step (merge {merge}) {k}, relative",
                abs(m_t[k] - float(m_j[k])) / abs(float(m_j[k])), LOSS_RTOL)
    _assert_grads(f"fused occupancy step (merge {merge})", g_t, g_j,
                  GRAD_REL_NORM, GRAD_REL_MAX)


@pytest.mark.parametrize("use_kernels", [None, False])
def test_cached_rows_step_equals_probed_step(use_kernels):
    """``occ_rows`` (uint8 rows of the batch's rays) in place of the grid:
    the same step bit for bit, on the kernel and the reference path."""
    cfg = tengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                             dense_units=256 if use_kernels is None else 32,
                             skip_layer=1, white_background=True,
                             use_kernels=use_kernels)
    opt = tengine.make_optimizer("adam", 1e-3)
    state = tengine.init_train_state(torch.Generator().manual_seed(0), cfg,
                                     opt, "cpu")
    images, rays = _batch(cfg.n_coarse, seed=1)
    batch = (torch.as_tensor(images), tuple(torch.as_tensor(x) for x in rays))
    grid = torch.as_tensor(_grid(seed=2))
    _, rows = tocc.occupancy_along_rays(batch[1][0].reshape(-1, 3),
                                        batch[1][1].reshape(-1, 3), grid,
                                        NEAR, FAR, N_PROBE)
    draws = [torch.sort(torch.rand(CHUNK, N_SAMPLES, generator=torch.Generator(
        ).manual_seed(i)), -1).values for i in range(B * H * W // CHUNK)]
    runs = [tengine.train_step(state, batch, draws, opt, cfg, CHUNK,
                               occupancy=_spec(True), **kw)
            for kw in (dict(occ_grid=grid),
                       dict(occ_rows=rows.to(torch.uint8)))]
    (s_grid, m_grid), (s_rows, m_rows) = runs
    for a, b in zip(tengine.tree_leaves(s_grid[:4]),
                    tengine.tree_leaves(s_rows[:4])):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    assert m_grid.keys() == m_rows.keys()
    for k in m_grid:
        assert torch.equal(m_grid[k], m_rows[k]), k


@pytest.mark.parametrize("use_kernels", [None, False])
def test_occupancy_step_keeps_the_exact_coarse_gradients(use_kernels):
    """The tier leaves the coarse pass alone: its gradients are the exact
    step's for the same batch, on either path."""
    cfg = tengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                             dense_units=256 if use_kernels is None else 32,
                             skip_layer=1, white_background=True,
                             use_kernels=use_kernels)
    opt = tengine.make_optimizer("sgd", 1.0)
    state = tengine.init_train_state(torch.Generator().manual_seed(3), cfg,
                                     opt, "cpu")
    images, rays = _batch(cfg.n_coarse, seed=2)
    batch = (torch.as_tensor(images), tuple(torch.as_tensor(x) for x in rays))
    gen = torch.Generator().manual_seed(4)
    exact, _ = tengine.train_step(state, batch, gen, opt, cfg, CHUNK)
    occ, metrics = tengine.train_step(
        state, batch, gen, opt, cfg, CHUNK, occupancy=_spec(True),
        occ_grid=torch.ones(GRID, GRID, GRID))
    for a, b in zip(tengine.tree_leaves(exact.coarse_params),
                    tengine.tree_leaves(occ.coarse_params)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)
    assert float(metrics["fine_grad_norm"]) > 0
    assert any(not torch.equal(a, b) for a, b in zip(
        tengine.tree_leaves(exact.fine_params),
        tengine.tree_leaves(occ.fine_params)))


def test_occupancy_step_needs_a_grid_or_rows():
    cfg = tengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                             dense_units=32, use_kernels=False)
    opt = tengine.make_optimizer("sgd", 1.0)
    state = tengine.init_train_state(torch.Generator().manual_seed(0), cfg,
                                     opt, "cpu")
    images, rays = _batch(8)
    with pytest.raises(ValueError, match="occ_grid"):
        tengine.train_step(state, (torch.as_tensor(images),
                                   tuple(torch.as_tensor(x) for x in rays)),
                           torch.Generator(), opt, cfg, CHUNK,
                           occupancy=_spec(True))


# ----------------------------------------------------- NeRF.fit's schedule


TINY = dict(n_coarse=8, n_fine=8, pos_emb_xyz=4, pos_emb_dir=2, n_layers=2,
            dense_units=16, skip_layer=1)


def _tiny_views(n=4, hw=8, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(n, hw, hw, 4)).astype(np.float32)
    poses = np.stack([jpose(360.0 * i / n, -30.0, 4.0) for i in range(n)])
    return images, poses.astype(np.float32)


def _schedule(model, epochs, dataset):
    """Per epoch: (holds a grid, baked this epoch, holds a cache, cache
    built this epoch), read at each epoch's end."""
    seen = []

    class Probe:
        def on_epoch_end(self, epoch, logs):
            seen.append((model._occ_train_grid, model._occ_probe_cache))

    model.fit(dataset, epochs=epochs, callbacks=[Probe()], verbose=False)
    out, prev = [], (None, None)
    for grid, cache in seen:
        out.append((grid is not None, grid is not None and grid is not prev[0],
                    cache is not None,
                    cache is not None and cache is not prev[1]))
        prev = (grid, cache)
    return out


# (warmup, update, until, cache, epochs)
SCHEDULES = [(1, 1, 0, False, 3), (1, 2, 0, False, 5), (1, 1, 2, False, 4),
             (0, 2, 0, True, 4), (2, 1, 4, True, 5)]


@pytest.mark.parametrize("warmup,update,until,cache,epochs", SCHEDULES)
def test_fit_bakes_on_jax_schedule(warmup, update, until, cache, epochs):
    """Which epochs hold a grid, bake one and rebuild the probe-row cache:
    the port's ``NeRF.fit`` and JAX's, epoch for epoch, on the same tiny
    views; the cache holds every train image's rows."""
    images, poses = _tiny_views()
    kw = dict(batch_size=2, image_height=8, image_width=8, ray_chunks=128,
              occupancy_train=GRID, occupancy_train_samples=N_SAMPLES,
              occupancy_train_probe=N_PROBE, occupancy_train_warmup=warmup,
              occupancy_train_update=update, occupancy_train_until=until,
              occupancy_train_cache=cache, near=NEAR, far=FAR,
              white_background=True)
    data = dict(focal=10.0, near=NEAR, far=FAR, n_samples=8, batch_size=2,
                shuffle=True, seed=0)
    theirs = JaxNeRF(**TINY)
    theirs.compile(**kw)
    want = _schedule(theirs, epochs, JaxDataset(images, poses, **data))
    port = NeRF(**TINY).compile(device="cpu", **kw)
    got = _schedule(port, epochs, NeRFDataset(images, poses, device="cpu",
                                              **data))
    print(f"\nschedule (warmup {warmup}, update {update}, until {until}, "
          f"cache {cache}): {got}")
    assert got == want
    assert any(g for g, *_ in got)
    if port._occ_probe_cache is not None:
        assert port._occ_probe_cache.shape == (4, 64, N_PROBE)
        assert port._occ_probe_cache.dtype == torch.uint8


def test_cache_fit_matches_uncached_fit():
    """``fit`` with the probe-row cache: the same losses as probing the
    grid every step (the cached step is the same step)."""
    images, poses = _tiny_views()

    def run(cache):
        model = NeRF(**TINY).compile(
            batch_size=2, image_height=8, image_width=8, ray_chunks=128,
            occupancy_train=GRID, occupancy_train_samples=N_SAMPLES,
            occupancy_train_warmup=1, occupancy_train_probe=N_PROBE,
            occupancy_train_cache=cache, device="cpu", seed=1)
        hist = model.fit(NeRFDataset(images, poses, focal=10.0, near=NEAR,
                                     far=FAR, n_samples=8, batch_size=2,
                                     shuffle=True, seed=0, device="cpu"),
                         epochs=3, verbose=False)
        return model, hist

    (m_cache, h_cache), (m_plain, h_plain) = run(True), run(False)
    assert m_cache._occ_probe_cache is not None
    assert m_plain._occ_probe_cache is None
    assert h_cache == h_plain


def test_eager_fit_gathers_cached_rows(monkeypatch):
    """``fit`` with a per-batch callback (``train_single --verbose``)
    steps one batch at a time; there too each occupancy step gathers the
    probe-row cache's rows and probes no grid."""
    images, poses = _tiny_views()
    model = NeRF(**TINY).compile(
        batch_size=2, image_height=8, image_width=8, ray_chunks=128,
        occupancy_train=GRID, occupancy_train_samples=N_SAMPLES,
        occupancy_train_warmup=1, occupancy_train_probe=N_PROBE,
        occupancy_train_cache=True, device="cpu", seed=1)
    seen, step = [], tengine.train_step

    def spy(*args, **kwargs):
        seen.append((kwargs.get("occ_grid") is not None,
                     kwargs.get("occ_rows") is not None))
        return step(*args, **kwargs)

    class PerBatch:
        def on_train_batch_end(self, batch, logs):
            pass

    monkeypatch.setattr(tengine, "train_step", spy)
    model.fit(NeRFDataset(images, poses, focal=10.0, near=NEAR, far=FAR,
                          n_samples=8, batch_size=2, shuffle=True, seed=0,
                          device="cpu"),
              epochs=2, callbacks=[PerBatch()], verbose=False)
    # 4 views in batches of 2: the warm-up epoch exact, then cached rows.
    assert seen == [(False, False)] * 2 + [(True, True)] * 2


def test_cache_refuses_pixel_sampling_with_jax_message():
    kw = dict(batch_size=2, image_height=8, image_width=8, ray_chunks=128,
              occupancy_train=8, occupancy_train_cache=True,
              pixel_sampling=True, near=NEAR, far=FAR)
    with pytest.raises(ValueError, match="pixel_sampling") as port:
        NeRF(**TINY).compile(device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        JaxNeRF(**TINY).compile(**kw)
    assert str(port.value) == str(theirs.value)


def test_compile_records_jax_train_config():
    """Every key JAX's compile records, with its value, for non-default
    occupancy flags."""
    kw = dict(batch_size=2, image_height=8, image_width=8, ray_chunks=128,
              learning_rate=2e-3, lr_final=1e-5, lr_decay_steps=7,
              white_background=True, occupancy_train=16,
              occupancy_train_samples=24, occupancy_train_merge=False,
              occupancy_train_warmup=3, occupancy_train_update=2,
              occupancy_train_until=9, occupancy_train_dilate=2,
              occupancy_train_cache=True, occupancy_train_probe=32)
    theirs = JaxNeRF(**TINY)
    theirs.compile(**kw)
    port = NeRF(**TINY).compile(device="cpu", **kw)
    assert port._train_config == theirs._train_config


# ----------------------------------------------------------- the CLI


def _write_scene(path):
    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

    return write_synthetic_scene(str(path), image_wh=16, n_train=4, n_val=2,
                                 n_test=2)


CLI_TINY = ["--img_wh", "16", "--num_coarse_samples", "8",
            "--num_fine_samples", "8", "--num_layers", "2",
            "--num_units", "16", "--skip_layer", "1", "--white_bg",
            "--ray_chunks", "128", "--learning_rate", "5e-3"]


def cli_train_config_matches_jax(tmp_path, flags, epochs="2"):
    """Train the port's CLI on the CPU with ``flags``, then JAX's with the
    same; both models' ``train_config.json`` equal, JAX's resume check
    silent on the port's model. Returns the port's model and log rows."""
    import csv

    from keras_nerf_tpu_torch import train_single as port_cli

    scene = _write_scene(tmp_path / "scene")
    common = ["--data_dir", scene, "--num_epochs", epochs, *CLI_TINY, *flags]
    port_args = port_cli.build_arg_parser().parse_args(
        ["--device", "cpu", "--name", "port", "--log_dir",
         str(tmp_path / "logs"), "--model_dirs", str(tmp_path / "models"),
         *common])
    port = port_cli.run_training(port_args)
    sys.path.insert(0, REPO)
    from train_single import build_arg_parser, run_training

    run_training(build_arg_parser().parse_args(
        ["--name", "jax", "--log_dir", str(tmp_path / "jlogs"),
         "--model_dirs", str(tmp_path / "models"), *common]))
    configs = {}
    for name in ("port", "jax"):
        with open(tmp_path / "models" / name / "train_config.json") as f:
            configs[name] = json.load(f)
    print(f"\ntrain config: {configs['port']}")
    assert configs["port"] == configs["jax"]
    assert jckpt.warn_train_config_mismatch(
        str(tmp_path / "models" / "port"), configs["jax"]) == []
    with open(tmp_path / "logs" / "port" / "log.csv") as f:
        rows = list(csv.DictReader(f))
    return port, rows


def test_train_single_occupancy_train_cli_matches_jax_config(tmp_path):
    """``--occupancy_train`` with every tier flag, on the CPU: the port
    trains (the grid baked after the warm-up, the cache built) and records
    the JAX CLI's training configuration."""
    port, rows = cli_train_config_matches_jax(tmp_path, [
        "--occupancy_train", "8", "--occupancy_train_samples", "8",
        "--occupancy_train_warmup", "1", "--occupancy_train_probe", "16",
        "--occupancy_train_update", "2", "--occupancy_train_until", "5",
        "--occupancy_train_dilate", "2", "--occupancy_train_cache",
        "--occupancy_train_no_merge"])
    assert port._occ_train_grid is not None
    assert port._occ_probe_cache.shape == (4, 256, 16)
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    assert all(np.isfinite(float(r["fine_loss"])) for r in rows)
