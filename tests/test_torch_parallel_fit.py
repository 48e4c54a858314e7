"""The port's data-parallel entry points and the training CLIs' last flags
against the JAX package, on the CPU: ``NeRF.fit`` under a 2-rank group
against JAX's ``fit`` on a 2-device mesh, ``python -m
keras_nerf_tpu_torch.train --num_gpus 2`` and ``inference --num_gpus 2``
(spawned gloo ranks, bounded by a timeout), ``--debug_nans``,
``--debug_grads``, ``--profile_dir``, ``--mixed_precision``, ``--eagerly``
and ``--use_pallas``/``--no_pallas``, and a 40-step Adam run of both
packages' ``train_step`` from one state (ROADMAP C15).

The thread ranks are ``tests/test_torch_parallel.py``'s. Run with ``-s``
to see each reading beside its budget.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu import parallel as jdp
from keras_nerf_tpu.data import DatasetLoader as JaxLoader
from keras_nerf_tpu.models import NeRF as JaxNeRF
from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.models import mlp as jmlp
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu.utils import checkpoint as jckpt
from keras_nerf_tpu_torch import train_single as port_single
from keras_nerf_tpu_torch.models import NeRF
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.models.mlp import MLPConfig, apply_mlp
from keras_nerf_tpu_torch.utils.convert import params_from_jax, params_to_jax

from tests.test_torch_parallel import run_in_threads

pytestmark = pytest.mark.skipif(
    jax.device_count() < 2, reason="needs 2 (fake) JAX devices")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_TIMEOUT = 300
# Per-epoch train and validation losses of the two fits, relative: the
# tolerance of JAX's own DP-against-single-chip trajectories
# (`tests/parallel/test_multi_device_fit.py`); the fine draws differ.
FIT_RTOL = 0.02
TINY = dict(n_coarse=8, n_fine=8, pos_emb_xyz=4, pos_emb_dir=2, n_layers=2,
            dense_units=16, skip_layer=1)


def _report(what, reading, budget):
    print(f"\n{what}: {reading:.3e} (budget {budget:g})")
    assert reading <= budget, what


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

    return write_synthetic_scene(str(tmp_path_factory.mktemp("scene")),
                                 image_wh=16, n_train=4, n_val=2, n_test=2)


def test_fit_under_a_group_tracks_jax_fit_on_a_mesh(scene, tmp_path):
    """Two epochs of ``NeRF.fit`` on 2 thread ranks (global batch 2, one
    image a rank) against JAX's ``fit`` on a 2-device mesh: the same
    weights (JAX's, through a checkpoint), the same global batches (JAX's
    loader, each epoch's), per-epoch losses within ``FIT_RTOL``."""
    kw = dict(batch_size=2, image_height=16, image_width=16, ray_chunks=64,
              white_background=True, learning_rate=5e-3, seed=11)
    theirs = JaxNeRF(**TINY)
    theirs.compile(mesh=jdp.make_mesh(2), **kw)
    theirs.save_model(str(tmp_path))
    train, val, _ = JaxLoader(scene, white_background=True).load_dataset(
        batch_size=2, image_width=16, image_height=16, near=2.0, far=6.0,
        n_sample=8, seed=3)
    epochs = [[jax.tree.map(np.array, b) for b in train] for _ in range(2)]
    val_batches = [jax.tree.map(np.array, b) for b in val]

    class Epochs:
        """Epoch ``e``'s batches on the ``e``-th pass."""

        def __init__(self):
            self.epoch = 0

        def __len__(self):
            return len(epochs[0])

        def __iter__(self):
            self.epoch += 1
            return iter(epochs[self.epoch - 1])

    want = theirs.fit(Epochs(), validation_data=val_batches, epochs=2,
                      verbose=False)

    def rank_fit(group):
        model = NeRF(model_path=str(tmp_path)).compile(
            device="cpu", use_kernels=False, group=group, **kw)
        return model.fit(Epochs(), validation_data=val_batches, epochs=2,
                         verbose=False)

    got = run_in_threads(2, rank_fit)
    assert got[0] == got[1]
    for epoch, (g, w) in enumerate(zip(got[0], want)):
        assert set(g) == set(w)
        for k in ("coarse_loss", "fine_loss", "val_coarse_loss",
                  "val_fine_loss"):
            _report(f"fit epoch {epoch} {k}, relative",
                    abs(g[k] - w[k]) / w[k], FIT_RTOL)


def _cli(module, *args):
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


CLI_TINY = ["--img_wh", "16", "--num_coarse_samples", "8",
            "--num_fine_samples", "8", "--num_layers", "2",
            "--num_units", "16", "--skip_layer", "1", "--white_bg",
            "--ray_chunks", "64", "--learning_rate", "5e-3",
            "--num_epochs", "2", "--batch_size", "1"]


@pytest.mark.parametrize("shard_rays", [False, True])
def test_train_cli_on_two_ranks_matches_jax_train_cli(scene, tmp_path,
                                                      monkeypatch,
                                                      shard_rays):
    """The train CLI on two gloo ranks: it logs both epochs and writes a
    model that JAX's ``load_model`` reads. Batch-sharded, ``python -m
    keras_nerf_tpu_torch.train --device cpu --num_gpus 2`` (two spawned
    ranks) writes the ``train_config.json`` of the root ``train.py`` run
    with the same flags on a 2-device mesh, and ``inference --num_gpus 2``
    then renders the model in height bands. With ``--shard_rays`` the
    CLI's ``run_training`` runs on thread ranks (the spawn is the first
    case's)."""
    flags = ["--data_dir", scene, *CLI_TINY] + (["--shard_rays"]
                                                if shard_rays else [])
    port_flags = ["--device", "cpu", "--num_gpus", "2", "--name", "port",
                  "--log_dir", str(tmp_path / "logs"), "--model_dirs",
                  str(tmp_path / "models"), "--log_freq", "1", *flags]
    if shard_rays:
        from keras_nerf_tpu_torch import train

        args = train.build_arg_parser().parse_args(port_flags)
        run_in_threads(2, lambda group: port_single.run_training(args,
                                                                 group))
    else:
        _cli("keras_nerf_tpu_torch.train", *port_flags)
    with open(tmp_path / "logs" / "port" / "log.csv") as f:
        assert [int(r["epoch"]) for r in csv.DictReader(f)] == [0, 1]
    model_dir = str(tmp_path / "models" / "port")
    loaded = JaxNeRF(model_path=model_dir)
    loaded.compile(image_height=16, image_width=16, ray_chunks=64)
    # 4 images, global batch 2 (1 with --shard_rays) a step, 2 epochs.
    assert int(loaded.state.step) == (8 if shard_rays else 4)
    if shard_rays:
        # The recorded train config does not depend on the layout: the
        # batch-sharded case holds it against JAX's CLI.
        return
    sys.path.insert(0, REPO)
    import train as jax_train

    monkeypatch.setattr(sys, "argv", [
        "train.py", "--num_gpus", "2", "--name", "jax", "--log_dir",
        str(tmp_path / "jlogs"), "--model_dirs", str(tmp_path / "models"),
        *flags])
    jax_train.main()
    configs = {}
    for name in ("port", "jax"):
        with open(tmp_path / "models" / name / "train_config.json") as f:
            configs[name] = json.load(f)
    assert configs["port"] == configs["jax"]
    # The ranks of inference's main are threads here (the train CLI above
    # spawns its ranks through the same ``run_ranks``).
    from keras_nerf_tpu_torch import inference, parallel

    monkeypatch.setattr(parallel, "run_ranks",
                        lambda fn, args, n, device: run_in_threads(
                            n, lambda group: fn(args, group)))
    out = tmp_path / "out"
    inference.main(["--device", "cpu", "--num_gpus", "2", "--model_dirs",
                    model_dir, "--img_wh", "16", "--output_freq", "120",
                    "--ray_chunks", "64", "--white_bg", "--output_dir",
                    str(out)])
    from PIL import Image

    with Image.open(out / "port.gif") as gif:
        assert gif.n_frames == 3 and gif.size == (16, 16)
    assert (out / "port_depth.gif").exists()


def test_cli_refusals(tmp_path, capsys):
    """``--shard_rays`` with ``--pixel_sampling`` at parse time, more cards
    than are visible, and an image height the ranks do not divide."""
    from keras_nerf_tpu_torch import inference, train

    with pytest.raises(SystemExit) as exit_info:
        train.main(["--shard_rays", "--pixel_sampling", "--device", "cpu"])
    assert exit_info.value.code == 2
    assert "--pixel_sampling" in capsys.readouterr().err

    jckpt.save_model(str(tmp_path), jengine.init_train_state(
        jax.random.PRNGKey(0), jengine.NeRFConfig(**TINY),
        jengine.make_optimizer("adam", 1e-3)), jengine.NeRFConfig(**TINY))
    with pytest.raises(SystemExit, match="must divide by the 3"):
        inference.main(["--model_dirs", str(tmp_path), "--img_wh", "16",
                        "--num_gpus", "3", "--device", "cpu"])
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--num_gpus", "1"])


# ----------------------------------------------------- the training flags


def test_train_single_flags(scene, tmp_path, caplog):
    """``--eagerly`` (logged), ``--mixed_precision`` (bf16 reference
    products), ``--no_pallas`` (the reference path), ``--debug_grads``
    (per-tensor norms), ``--profile_dir`` (a trace of the first epoch) and
    ``--debug_nans`` on one CPU run; ``--use_pallas`` wins over
    ``--no_pallas`` as in the root CLI."""
    args = port_single.build_arg_parser().parse_args([
        "--device", "cpu", "--data_dir", scene, *CLI_TINY, "--eagerly",
        "--mixed_precision", "--no_pallas", "--debug_grads", "--debug_nans",
        "--profile_dir", str(tmp_path / "prof"), "--name", "f",
        "--log_dir", str(tmp_path / "logs"), "--model_dirs",
        str(tmp_path / "models")])
    with caplog.at_level("INFO"):
        model = port_single.run_training(args)
    assert "the port has no jit" in caplog.text
    assert model.config.compute_dtype == "bfloat16"
    assert model.config.use_kernels is False
    assert model.debug_grads and model.debug_nans
    with open(tmp_path / "prof" / "trace_rank0.json") as f:
        assert json.load(f)["traceEvents"]
    flag = port_single.use_kernels_flag
    parse = port_single.build_arg_parser().parse_args
    assert flag(parse([])) is None
    assert flag(parse(["--no_pallas"])) is False
    assert flag(parse(["--use_pallas", "--no_pallas"])) is True


def test_debug_nans_raises_on_a_non_finite_step():
    model = NeRF(**TINY).compile(
        image_height=4, image_width=8, ray_chunks=16, device="cpu",
        use_kernels=False, debug_nans=True,
        loss=lambda y, p: torch.mean(torch.square(p - y)) * float("nan"))
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(1, 4, 8, 4)).astype(np.float32)
    o = np.zeros((1, 4, 8, 3), np.float32)
    o[..., 2] = 4.0
    d = np.float32([0.0, 0.0, -1.0]) * np.ones((1, 4, 8, 3), np.float32)
    t = np.sort(rng.uniform(2, 6, (1, 4, 8, 8)), -1).astype(np.float32)
    with pytest.raises(FloatingPointError, match="debug_nans"):
        model.train_step((images, (o, d, t)))


def _step_inputs(seed=0, b=1, h=4, w=8, n_coarse=8):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, h, w, 4)).astype(np.float32)
    o = np.zeros((b, h, w, 3), np.float32)
    o[..., 2] = 4.0
    d = rng.normal(size=(b, h, w, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = np.sort(rng.uniform(2, 6, (b, h, w, n_coarse)), -1).astype(
        np.float32)
    return images, (o, d, t)


def _jax_draws(key, n_chunks, chunk, n):
    return [torch.as_tensor(np.array(jax_sorted_uniforms(k, (chunk,), n)))
            for k in jax.random.split(key, n_chunks)]


def test_debug_grads_metrics_match_jax():
    """``train_step(debug_grads=True)``: JAX's metric names, one norm per
    parameter tensor, and JAX's values (reference path, rtol 1e-4)."""
    jcfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=3,
                              dense_units=32, skip_layer=2, pos_emb_xyz=4,
                              pos_emb_dir=2, white_background=True,
                              use_pallas=False)
    opt_j = jengine.make_optimizer("sgd", 1.0)
    s0 = jengine.init_train_state(jax.random.PRNGKey(0), jcfg, opt_j)
    images, rays = _step_inputs()
    key = jax.random.PRNGKey(4)
    _, m_j = jax.jit(lambda st, b, k: jengine.train_step(
        st, b, k, optimizer=opt_j, config=jcfg, ray_chunks=16,
        debug_grads=True))(
        s0, (jnp.asarray(images), tuple(map(jnp.asarray, rays))), key)
    opt_t = tengine.make_optimizer("sgd", 1.0)
    p = [params_from_jax(jax.tree.map(np.asarray, x), "cpu")
         for x in (s0.coarse_params, s0.fine_params)]
    t0 = tengine.TrainState(p[0], p[1], {}, {}, 0)
    cfg = tengine.NeRFConfig(**jcfg.to_model_config(),
                             white_background=True, use_kernels=False)
    _, m_t = tengine.train_step(
        t0, (torch.as_tensor(images), tuple(map(torch.as_tensor, rays))),
        _jax_draws(key, 2, 16, 8), opt_t, cfg, 16, debug_grads=True)
    assert set(m_t) == set(m_j)
    names = [k for k in m_j if k.startswith("grad_norm/")]
    assert len(names) == 2 * len(jax.tree.leaves(s0.coarse_params))
    assert "grad_norm/coarse[trunk][0][kernel]" in names
    worst = max(abs(float(m_t[k]) - float(m_j[k])) / float(m_j[k])
                for k in names)
    _report("debug_grads norms, worst relative", worst, 1e-4)


def test_mixed_precision_reference_path_matches_jax_bf16():
    """``compute_dtype="bfloat16"`` (``--mixed_precision``): the reference
    MLP against JAX's bf16 XLA ``apply_mlp``, within 2 bf16 steps of the
    outputs' scale (2^-7 relative), and one bf16 reference step's losses
    against JAX's (rtol 1e-2)."""
    cfg_j = jmlp.MLPConfig(n_layers=3, dense_units=64, skip_layer=2)
    params = jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(1),
                                                    cfg_j, 63, 27))
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-1, 1, (256, 63)).astype(np.float32)
    dirs = rng.uniform(-1, 1, (256, 27)).astype(np.float32)
    want = jmlp.apply_mlp(params, xyz, dirs, cfg_j, jnp.bfloat16)
    got = apply_mlp(params_from_jax(params, "cpu"), torch.as_tensor(xyz),
                    torch.as_tensor(dirs), MLPConfig(3, 64, 2),
                    torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        _report("bf16 apply_mlp, max abs over the outputs' max", float(
            np.abs(g.numpy() - w).max() / np.abs(w).max()), 2 * 2.0 ** -7)
    jcfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=3,
                              dense_units=32, skip_layer=2,
                              white_background=True,
                              compute_dtype="bfloat16", use_pallas=False)
    opt_j = jengine.make_optimizer("sgd", 1.0)
    s0 = jengine.init_train_state(jax.random.PRNGKey(0), jcfg, opt_j)
    images, rays = _step_inputs(seed=1)
    key = jax.random.PRNGKey(8)
    _, m_j = jengine.train_step(
        s0, (jnp.asarray(images), tuple(map(jnp.asarray, rays))), key,
        optimizer=opt_j, config=jcfg, ray_chunks=16)
    p = [params_from_jax(jax.tree.map(np.asarray, x), "cpu")
         for x in (s0.coarse_params, s0.fine_params)]
    cfg = tengine.NeRFConfig(**jcfg.to_model_config(), white_background=True,
                             compute_dtype="bfloat16", use_kernels=False)
    _, m_t = tengine.train_step(
        tengine.TrainState(p[0], p[1], {}, {}, 0),
        (torch.as_tensor(images), tuple(map(torch.as_tensor, rays))),
        _jax_draws(key, 2, 16, 8), tengine.make_optimizer("sgd", 1.0), cfg,
        16)
    for k in ("coarse_loss", "fine_loss"):
        _report(f"bf16 step {k}, relative",
                abs(float(m_t[k]) - float(m_j[k])) / float(m_j[k]), 1e-2)


# ------------------------------------------------------------------- C15

C15_STEPS = 40
C15_LR, C15_LR_FINAL = 1e-3, 1e-5
# The budget: after the 40 steps, each parameter tensor's gap from JAX's
# over its displacement from the start, ||port - jax|| / ||jax - start||.
# Adam's update m / sqrt(v) does not depend on the gradient's scale, so a
# relative error e in every step's gradient moves every update, and so
# their sum, by about e of itself: the ratio stays near the per-step
# gradient error. That error is float32 rounding, held per tensor at 1e-4
# relative in one reference step (`tests/test_torch_train.py`); the budget
# is ten times it, for the fine first layer, whose input multiplies the
# fine depths' rounding (ROADMAP C13) by the 2^9 frequency of the
# encoding. Readings on the CPU: coarse 2.78e-4, fine 5.46e-4 (the first
# layer's kernel in both). A real divergence breaks it: the same run with
# the step at count 20 taken at twice its learning rate reads 1.19e-2
# (coarse) and 1.02e-2 (fine), with one of that step's two chunks'
# gradients dropped 1.08e-2 and 1.22e-2, and at count 30 either fault still
# reads 2.0e-3 to 3.4e-3. The test repeats the first fault.
C15_REL_BUDGET = 1e-3
C15_FAULT_COUNT = 20


def _c15_worst_leaf(mine, theirs, start):
    """The worst parameter tensor's gap over its displacement (norms over
    the tensor), and the largest gap of an element."""
    rel, gaps = [], []
    for a, b, c in zip(jax.tree.leaves(params_to_jax(mine)),
                       jax.tree.leaves(theirs), jax.tree.leaves(start)):
        a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
        rel.append(np.linalg.norm(a - b) / np.linalg.norm(b - c))
        gaps.append(np.abs(a - b).max())
    return max(rel), max(gaps)


def test_c15_forty_adam_steps_track_jax():
    """ROADMAP C15's matched run: 40 Adam steps of both packages'
    ``train_step`` from one state, the r5best recipe's learning rate
    (``exponential_lr`` 1e-3 -> 1e-5) compressed to 40 steps, a numpy-made
    batch sequence, JAX's draws injected, the float32 reference path at
    the recipe's encoding (10 and 4 frequencies). Holds each model's
    worst parameter tensor after step 40 at ``C15_REL_BUDGET``, and checks
    that a run with one step at twice its learning rate breaks it."""
    chunk, hw, n = 32, 8, 16
    jcfg = jengine.NeRFConfig(n_coarse=n, n_fine=n, n_layers=3,
                              dense_units=64, skip_layer=2,
                              white_background=True, use_pallas=False)
    cfg = tengine.NeRFConfig(**jcfg.to_model_config(),
                             white_background=True, use_kernels=False)
    opt_j = jengine.make_optimizer("adam", jengine.exponential_lr(
        C15_LR, C15_LR_FINAL, C15_STEPS))
    schedule = tengine.exponential_lr(C15_LR, C15_LR_FINAL, C15_STEPS)
    s = s0 = jengine.init_train_state(jax.random.PRNGKey(0), jcfg, opt_j)
    batches = [_step_inputs(seed=100 + i, h=hw, w=hw, n_coarse=n)
               for i in range(C15_STEPS)]
    keys = [jax.random.PRNGKey(1000 + i) for i in range(C15_STEPS)]
    step = jax.jit(lambda st, b, k: jengine.train_step(
        st, b, k, optimizer=opt_j, config=jcfg, ray_chunks=chunk))
    jax_losses = []
    for (images, rays), key in zip(batches, keys):
        s, m_j = step(s, (jnp.asarray(images), tuple(map(jnp.asarray,
                                                         rays))), key)
        jax_losses.append(float(m_j["fine_loss"]))

    def port_run(learning_rate):
        opt_t = tengine.make_optimizer("adam", learning_rate)
        p = [params_from_jax(jax.tree.map(np.asarray, x), "cpu")
             for x in (s0.coarse_params, s0.fine_params)]
        t = tengine.TrainState(p[0], p[1], opt_t.init(p[0]),
                               opt_t.init(p[1]), 0)
        losses = []
        for (images, rays), key in zip(batches, keys):
            t, m_t = tengine.train_step(
                t, (torch.as_tensor(images),
                    tuple(map(torch.as_tensor, rays))),
                _jax_draws(key, hw * hw // chunk, chunk, n), opt_t, cfg,
                chunk)
            losses.append(float(m_t["fine_loss"]))
        assert t.step == int(s.step) == C15_STEPS
        return t, losses

    t, losses = port_run(schedule)
    gaps = [abs(a - b) / b for a, b in zip(losses, jax_losses)]
    print(f"\nC15: fine loss relative gap, worst over the steps "
          f"{max(gaps):.2e}, at step 40 {gaps[-1]:.2e}")
    fault, _ = port_run(lambda count: schedule(count) * (
        2.0 if count == C15_FAULT_COUNT else 1.0))
    for name in ("coarse", "fine"):
        start, theirs = (getattr(x, f"{name}_params") for x in (s0, s))
        worst, max_abs = _c15_worst_leaf(getattr(t, f"{name}_params"),
                                         theirs, start)
        print(f"C15 {name}: largest element gap {max_abs:.2e}")
        _report(f"C15 {name}: worst tensor's gap over its displacement "
                f"after {C15_STEPS} steps", worst, C15_REL_BUDGET)
        planted, _ = _c15_worst_leaf(getattr(fault, f"{name}_params"),
                                     theirs, start)
        print(f"C15 {name}, step at count {C15_FAULT_COUNT} at twice its "
              f"learning rate: {planted:.3e} (must exceed the budget)")
        assert planted > C15_REL_BUDGET, name
