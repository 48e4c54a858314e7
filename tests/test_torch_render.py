"""The port's render path as a whole against the JAX package's.

Same parameters (drawn by JAX, carried over with ``params_from_jax``), the
same rays and stratified depths, and the same fine draws: JAX's per-chunk
``sorted_uniforms(split(key, num_chunks)[i], (R,), n_fine)`` injected into
the port. Budgets: the kernel path against JAX's fused kernels (interpret
mode) at the fused-sampling budgets of `test_pallas_kernel.py:431-434`
(image atol 2e-3, depth atol 5e-3); the float32 reference paths at atol
1e-4.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu.utils import checkpoint as jckpt
from keras_nerf_tpu_torch.models import NeRF
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_ATOL, DEPTH_ATOL = 2e-3, 5e-3
REF_ATOL = 1e-4
B, H, W, CHUNK = 1, 4, 8, 16

# The configuration of test_pallas_kernel.py:266-294.
JAX_CFG = jengine.NeRFConfig(n_coarse=8, n_fine=8, pos_emb_xyz=10,
                             pos_emb_dir=4, n_layers=3, dense_units=256,
                             skip_layer=2, white_background=True,
                             use_pallas=True)


def _port_cfg(jcfg, use_kernels):
    return tengine.NeRFConfig(**jcfg.to_model_config(),
                              white_background=jcfg.white_background,
                              use_kernels=use_kernels)


@pytest.fixture(scope="module")
def scene():
    params_c, params_f = jengine.init_params(jax.random.PRNGKey(2), JAX_CFG)
    rng = np.random.default_rng(0)
    o = np.zeros((B, H, W, 3), np.float32)
    o[..., 2] = 4.0
    d = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2, 6, (B, H, W, JAX_CFG.n_coarse)), -1
                ).astype(np.float32)
    key = jax.random.PRNGKey(7)
    num_chunks = B * H * W // CHUNK
    draws = [np.asarray(jax_sorted_uniforms(k, (CHUNK,), JAX_CFG.n_fine))
             for k in jax.random.split(key, num_chunks)]
    return (jax.tree.map(np.asarray, params_c),
            jax.tree.map(np.asarray, params_f), (o, d, t), key, draws)


def _jax_render(scene, cfg, **kw):
    params_c, params_f, rays, key, _ = scene
    return jengine.render_image_batch(
        params_c, params_f, tuple(jnp.asarray(x) for x in rays), key, cfg,
        CHUNK, **kw)


def _port_render(scene, cfg, **kw):
    params_c, params_f, rays, _, draws = scene
    return tengine.render_image_batch(
        params_from_jax(params_c, "cpu"), params_from_jax(params_f, "cpu"),
        tuple(torch.as_tensor(x) for x in rays),
        [torch.tensor(u) for u in draws], cfg, CHUNK, **kw)


def _assert_close(got: dict, want: dict, atol: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol[k], err_msg=k)


@pytest.mark.parametrize("with_weights,coarse_image",
                         [(False, False), (True, True)])
def test_kernel_path_matches_jax_fused_render(scene, with_weights,
                                              coarse_image):
    kw = dict(with_weights=with_weights, coarse_image=coarse_image)
    want_c, want_f = _jax_render(scene, JAX_CFG, **kw)
    got_c, got_f = _port_render(scene, _port_cfg(JAX_CFG, None), **kw)
    atol = {"image": IMAGE_ATOL, "depth": DEPTH_ATOL, "weights": 2e-3}
    _assert_close(got_f, want_f, atol)
    _assert_close(got_c, want_c, atol)
    if not coarse_image:
        assert float(got_c["image"].abs().max()) == 0.0
    assert float(got_f["image"].std()) > 0.01   # a non-trivial render


def test_reference_path_matches_jax_xla_path(scene):
    jcfg = dataclasses.replace(JAX_CFG, use_pallas=False)
    want_c, want_f = _jax_render(scene, jcfg)
    got_c, got_f = _port_render(scene, _port_cfg(jcfg, False))
    atol = {"image": REF_ATOL, "depth": REF_ATOL, "weights": REF_ATOL}
    _assert_close(got_c, want_c, atol)
    _assert_close(got_f, want_f, atol)


def test_render_draws_from_a_generator(scene):
    """A generator stands in for injected draws: same shapes, and two
    generators with one seed give one render."""
    params_c, params_f, rays, _, _ = scene
    cfg = _port_cfg(JAX_CFG, None)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        outs.append(tengine.render_image_batch(
            params_from_jax(params_c, "cpu"), params_from_jax(params_f, "cpu"),
            tuple(torch.as_tensor(x) for x in rays), g, cfg, CHUNK,
            with_weights=False))
    assert outs[0][1]["image"].shape == (B, H, W, 3)
    assert "weights" not in outs[0][1]
    np.testing.assert_array_equal(outs[0][1]["image"].numpy(),
                                  outs[1][1]["image"].numpy())
    with pytest.raises(ValueError):
        tengine.render_image_batch(
            params_from_jax(params_c, "cpu"), params_from_jax(params_f, "cpu"),
            tuple(torch.as_tensor(x) for x in rays), [], cfg, CHUNK)


def _save_jax_checkpoint(path, cfg, seed=3):
    state = jengine.init_train_state(jax.random.PRNGKey(seed), cfg,
                                     jengine.make_optimizer("adam"))
    jckpt.save_model(str(path), state, cfg)
    return state


def test_nerf_loads_a_jax_checkpoint(scene, tmp_path):
    state = _save_jax_checkpoint(tmp_path, JAX_CFG)
    nerf = NeRF(model_path=str(tmp_path))
    assert nerf.config.to_model_config() == JAX_CFG.to_model_config()
    nerf.compile(batch_size=B, image_height=H, image_width=W,
                 ray_chunks=CHUNK, white_background=True, device="cpu")
    for mine, theirs in ((nerf.coarse_params, state.coarse_params),
                         (nerf.fine_params, state.fine_params)):
        theirs = params_from_jax(jax.tree.map(np.asarray, theirs), "cpu")
        for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(mine)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    _, _, rays, _, draws = scene
    draws = [torch.tensor(u) for u in draws]
    got_c, got_f = nerf.predict_and_render_images(rays, fine_draws=draws)
    want_c, want_f = tengine.render_image_batch(
        params_from_jax(jax.tree.map(np.asarray, state.coarse_params), "cpu"),
        params_from_jax(jax.tree.map(np.asarray, state.fine_params), "cpu"),
        tuple(torch.as_tensor(x) for x in rays), draws, nerf.config, CHUNK)
    for k in want_f:
        np.testing.assert_array_equal(got_f[k].numpy(), want_f[k].numpy())
        np.testing.assert_array_equal(got_c[k].numpy(), want_c[k].numpy())


def test_inference_cli_writes_both_gifs(tmp_path):
    import imageio.v2 as imageio

    model_dir = tmp_path / "model"
    cfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                             dense_units=256, skip_layer=4)
    _save_jax_checkpoint(model_dir, cfg)
    out = tmp_path / "out"
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "keras_nerf_tpu_torch.inference",
         "--model_dirs", str(model_dir), "--img_wh", "16",
         "--output_freq", "180", "--ray_chunks", "256", "--white_bg",
         "--device", "cpu", "--output_dir", str(out), "--name", "orbit"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("orbit.gif", "orbit_depth.gif"):
        frames = imageio.mimread(out / name)
        assert len(frames) == 2 and frames[0].shape[:2] == (16, 16), name
