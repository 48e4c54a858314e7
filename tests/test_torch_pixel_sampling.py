"""The port's pixel-sampling tier against the JAX package's, on the CPU.

``sample_random_ray_batch`` is fed JAX's draws (its flat pixel indices and
stratified depths, from the key's two halves) and gives JAX's pixels and
rays within 1e-6 (both are float32; the port's ray arithmetic is JAX's
order). The train split of ``load_dataset(pixel_sampling=True)`` is a
``RayBatchDataset`` whose every ray is the whole-image ray of its pixel,
and the training CLI's ``--pixel_sampling`` records JAX's training
configuration.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.data import rays as jrays
from keras_nerf_tpu.data.utils import pose_spherical as jpose
from keras_nerf_tpu.ops.sampling import stratified_sample_points as jstrat
from keras_nerf_tpu_torch.data import (
    DatasetLoader,
    NeRFDataset,
    RayBatchDataset,
    generate_rays,
    sample_random_ray_batch,
)
from keras_nerf_tpu_torch.data import synthetic as tsyn
from keras_nerf_tpu_torch.models import NeRF
from tests.test_torch_occupancy_train import cli_train_config_matches_jax

RAY_ATOL = 1e-6


def _views(n=3, h=8, w=6, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(n, h, w, 4)).astype(np.float32)
    poses = np.stack([jpose(a, -30.0, 4.0)
                      for a in np.linspace(10.0, 250.0, n)]).astype(
        np.float32)
    return images, poses


@pytest.mark.parametrize("batch,n_samples", [(2, 5), (1, 8)])
def test_sample_random_ray_batch_on_jax_draws(batch, n_samples):
    images, poses = _views()
    kw = dict(batch=batch, image_height=8, image_width=6, focal=7.0,
              near=2.0, far=6.0, n_samples=n_samples)
    key = jax.random.PRNGKey(batch + n_samples)
    pix_j, rays_j = jrays.sample_random_ray_batch(
        jnp.asarray(images), jnp.asarray(poses), key, **kw)
    # JAX's two draws: the key's first half makes the flat indices, the
    # second the depths (`data/rays.py:140-142`).
    k_idx, k_t = jax.random.split(key)
    r = batch * 8 * 6
    flat = np.array(jax.random.randint(k_idx, (r,), 0, images.shape[0] * 48))
    points = np.array(jstrat(k_t, (r,), n_samples, 2.0, 6.0))
    pix_t, rays_t = sample_random_ray_batch(
        torch.as_tensor(images), torch.as_tensor(poses),
        flat=torch.as_tensor(flat), points=torch.as_tensor(points), **kw)
    assert pix_t.shape == (batch, 8, 6, 4)
    np.testing.assert_allclose(pix_t.numpy(), np.asarray(pix_j), rtol=0,
                               atol=RAY_ATOL)
    for got, want in zip(rays_t, rays_j):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=RAY_ATOL)


def test_random_rays_are_the_whole_image_rays_of_their_pixels():
    """Drawn by a generator: each ray carries its pixel's colour, and its
    origin and direction are ``generate_rays``' for that pixel, bit for
    bit; the depths are stratified in [near, far]."""
    images, poses = _views(h=5, w=7)
    g = torch.Generator().manual_seed(0)
    pix, (o, d, t) = sample_random_ray_batch(
        torch.as_tensor(images), torch.as_tensor(poses), g, batch=4,
        image_height=5, image_width=7, focal=6.0, near=2.0, far=6.0,
        n_samples=4)
    whole = [generate_rays(torch.as_tensor(p), 5, 7, 6.0) for p in poses]
    seen = set()
    for c, ray_o, ray_d in zip(pix.reshape(-1, 4), o.reshape(-1, 3),
                               d.reshape(-1, 3)):
        hits = np.argwhere((images == c.numpy()).all(-1))
        assert len(hits) == 1
        i, y, x = hits[0]
        seen.add(int(i))
        assert torch.equal(ray_o, whole[i][0][y, x])
        assert torch.equal(ray_d, whole[i][1][y, x])
    assert seen == {0, 1, 2}
    assert float(t.min()) >= 2.0 and float(t.max()) <= 6.0
    assert bool((t[..., 1:] >= t[..., :-1]).all())


def test_load_dataset_pixel_sampling_train_split(tmp_path):
    """``pixel_sampling=True``: the train split is a ``RayBatchDataset`` on
    the loader's device (``len`` as JAX's, the whole-image batch's shapes,
    one seed the same batches, each epoch new ones); validation and test
    stay whole images."""
    scene = tsyn.write_synthetic_scene(str(tmp_path), image_wh=8, n_train=3,
                                       n_val=1, n_test=1)
    kw = dict(batch_size=2, image_width=8, image_height=8, near=2.0,
              far=6.0, n_sample=4, seed=1, pixel_sampling=True)
    train, val, test = DatasetLoader(scene, device="cpu").load_dataset(**kw)
    assert isinstance(train, RayBatchDataset) and train.PIXELWISE_METRICS_ONLY
    assert isinstance(val, NeRFDataset) and isinstance(test, NeRFDataset)
    assert len(train) == 1 and train.images.device.type == "cpu"
    epochs = [list(train) for _ in range(2)]
    again = list(DatasetLoader(scene, device="cpu").load_dataset(**kw)[0])
    images, (o, d, t) = epochs[0][0]
    assert images.shape == (2, 8, 8, 4) and t.shape == (2, 8, 8, 4)
    assert torch.equal(images, again[0][0])
    assert not torch.equal(images, epochs[1][0][0])
    assert len(RayBatchDataset(np.zeros((1, 2, 2, 4), np.float32),
                               np.stack([np.eye(4)]), focal=1.0, near=2.0,
                               far=6.0, n_samples=2, batch_size=4,
                               device="cpu")) == 1


def test_fit_warns_that_pixel_ssim_is_not_meaningful(caplog):
    images, poses = _views(n=2, h=8, w=8)
    data = RayBatchDataset(images, poses, focal=8.0, near=2.0, far=6.0,
                           n_samples=8, batch_size=1, device="cpu")
    model = NeRF(n_coarse=8, n_fine=8, n_layers=2, dense_units=16,
                 skip_layer=1).compile(image_height=8, image_width=8,
                                       ray_chunks=64, pixel_sampling=True,
                                       white_background=True, device="cpu")
    with caplog.at_level(logging.WARNING):
        hist = model.fit(data, epochs=1, verbose=False)
    assert "pixel-sampling mode" in caplog.text
    assert np.isfinite(hist[0]["fine_loss"])


def test_pixel_sampling_composes_with_occupancy_train():
    """Occupancy sampling is per ray, so scrambled pixel batches train the
    tier as whole images do (`tests/models/test_monitor_and_cli.py:342`):
    the grid bakes after the warm-up and the fine loss falls."""
    images, poses = _views(n=4, h=8, w=8)
    images[..., :3] = 0.7
    data = RayBatchDataset(images, poses, focal=8.0, near=2.0, far=6.0,
                           n_samples=8, batch_size=2, device="cpu", seed=3)
    model = NeRF(n_coarse=8, n_fine=8, pos_emb_xyz=4, pos_emb_dir=2,
                 n_layers=2, dense_units=16, skip_layer=1).compile(
        batch_size=2, image_height=8, image_width=8, ray_chunks=128,
        learning_rate=5e-3, occupancy_train=8, occupancy_train_samples=8,
        occupancy_train_warmup=1, pixel_sampling=True, device="cpu")
    hist = model.fit(data, epochs=6, verbose=False)
    assert model._occ_train_grid is not None
    assert hist[-1]["fine_loss"] < hist[0]["fine_loss"]


def test_train_single_pixel_sampling_cli_matches_jax_config(tmp_path):
    """``--pixel_sampling`` on the CPU: the port trains on ray batches and
    records the JAX CLI's training configuration."""
    port, rows = cli_train_config_matches_jax(tmp_path, ["--pixel_sampling"])
    assert port._train_config["pixel_sampling"] is True
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    assert all(np.isfinite(float(r["fine_loss"])) for r in rows)


# ------------------------------------------------------------------- C16

C16_STEPS = 40
# assets/quality128_ps_run.log's learning rate, compressed to 40 steps.
C16_LR, C16_LR_FINAL = 5e-4, 5e-6
# The budget: each parameter tensor's gap from JAX's over its displacement
# (C15's measure), at the per-step float32 gradient error one reference
# step is held to (1e-4, `tests/test_torch_train.py`). Readings on the
# CPU: coarse 1.6e-6, fine 8.4e-6. The encoding is 4 frequencies, as in
# JAX's data-parallel tests: at the anchor's 10 the fine first layer's
# kernel reads 1.5e-2 here, and 3.5e-2 on whole images of the same poses,
# which is the fine depths' float32 rounding (C13: JAX's CDF summation
# order) times the 2^9 frequency, not the sampler.
C16_REL_BUDGET = 1e-4


def test_c16_pixel_sampled_adam_steps_track_jax():
    """ROADMAP C16's matched run: 40 Adam steps of pixel-sampled training
    in both packages from one state. Each step's batch is JAX's
    ``sample_random_ray_batch`` and the port's fed its flat indices and
    depths (equal at ``RAY_ATOL``), JAX's fine draws are injected, on the
    float32 reference path at the anchor's learning rate. Holds each
    model's worst parameter tensor after step 40 at ``C16_REL_BUDGET``,
    and checks that a run with one step at twice its learning rate breaks
    it."""
    from keras_nerf_tpu.models import engine as jengine
    from keras_nerf_tpu_torch.models import engine as tengine
    from keras_nerf_tpu_torch.utils.convert import params_from_jax
    from tests.test_torch_parallel_fit import (C15_FAULT_COUNT,
                                               _c15_worst_leaf, _jax_draws,
                                               _report)

    chunk, hw, n, views = 32, 8, 16, 4
    images, poses = _views(n=views, h=hw, w=hw, seed=16)
    kw = dict(batch=1, image_height=hw, image_width=hw, focal=7.0, near=2.0,
              far=6.0, n_samples=n)
    jcfg = jengine.NeRFConfig(n_coarse=n, n_fine=n, n_layers=3,
                              dense_units=64, skip_layer=2, pos_emb_xyz=4,
                              white_background=True, use_pallas=False)
    cfg = tengine.NeRFConfig(**jcfg.to_model_config(),
                             white_background=True, use_kernels=False)
    opt_j = jengine.make_optimizer("adam", jengine.exponential_lr(
        C16_LR, C16_LR_FINAL, C16_STEPS))
    schedule = tengine.exponential_lr(C16_LR, C16_LR_FINAL, C16_STEPS)
    s = s0 = jengine.init_train_state(jax.random.PRNGKey(0), jcfg, opt_j)
    step = jax.jit(lambda st, b, k: jengine.train_step(
        st, b, k, optimizer=opt_j, config=jcfg, ray_chunks=chunk))
    port_batches, draw_keys = [], []
    for i in range(C16_STEPS):
        key, draw_key = jax.random.PRNGKey(3000 + i), jax.random.PRNGKey(
            4000 + i)
        batch = jrays.sample_random_ray_batch(
            jnp.asarray(images), jnp.asarray(poses), key, **kw)
        s, _ = step(s, batch, draw_key)
        k_idx, k_t = jax.random.split(key)
        flat = np.array(jax.random.randint(k_idx, (hw * hw,), 0,
                                           views * hw * hw))
        pix, rays = sample_random_ray_batch(
            torch.as_tensor(images), torch.as_tensor(poses),
            flat=torch.as_tensor(flat),
            points=torch.as_tensor(np.array(jstrat(k_t, (hw * hw,), n, 2.0,
                                                   6.0))), **kw)
        for got, want in zip((pix, *rays), (batch[0], *batch[1])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=RAY_ATOL)
        port_batches.append((pix, rays))
        draw_keys.append(draw_key)

    def port_run(learning_rate):
        opt_t = tengine.make_optimizer("adam", learning_rate)
        p = [params_from_jax(jax.tree.map(np.asarray, x), "cpu")
             for x in (s0.coarse_params, s0.fine_params)]
        t = tengine.TrainState(p[0], p[1], opt_t.init(p[0]),
                               opt_t.init(p[1]), 0)
        for batch, key in zip(port_batches, draw_keys):
            t, _ = tengine.train_step(
                t, batch, _jax_draws(key, hw * hw // chunk, chunk, n), opt_t,
                cfg, chunk)
        assert t.step == int(s.step) == C16_STEPS
        return t

    t = port_run(schedule)
    fault = port_run(lambda count: schedule(count) * (
        2.0 if count == C15_FAULT_COUNT else 1.0))
    for name in ("coarse", "fine"):
        start, theirs = (getattr(x, f"{name}_params") for x in (s0, s))
        worst, _ = _c15_worst_leaf(getattr(t, f"{name}_params"), theirs,
                                   start)
        _report(f"C16 {name}: worst tensor's gap over its displacement "
                f"after {C16_STEPS} pixel-sampled steps", worst,
                C16_REL_BUDGET)
        planted, _ = _c15_worst_leaf(getattr(fault, f"{name}_params"),
                                     theirs, start)
        print(f"C16 {name}, step at count {C15_FAULT_COUNT} at twice its "
              f"learning rate: {planted:.3e} (must exceed the budget)")
        assert planted > C16_REL_BUDGET, name
