"""The port's fast render tier (``--fast_render``) against the JAX
package's, on the CPU.

JAX's small render configuration (`test_pallas_kernel.py:266-294`: 3 x 256
with skip 2, 8 + 8 samples, 32 rays in chunks of 16) with the fine pass at
``K = 12`` importance samples alone. Parameters are drawn by JAX and carried
over with ``params_from_jax``; the fine draws are JAX's per-chunk
``sorted_uniforms(split(key, num_chunks)[i], (R,), K)`` fed in. Budgets,
each with its reason:

* the float32 reference ``render_chunk`` against JAX's on XLA: atol 1e-4 on
  the depths used, image and depth, the reference paths' budget of
  ``test_torch_render.py`` (float32 sums of 256-wide layers in another
  order: the depths used agree within a few ulps, the image within 1.5e-5
  and the depth within 7.5e-5, where the density sums of a steep ray
  differ most);
* the kernel path (the plain versions) against JAX's fused kernels in
  interpret mode, and the int8 tier from JAX's own int8 dicts: the
  fused-sampling budget of `test_pallas_kernel.py:431-434`, image 2e-3,
  depth 5e-3 (as ``test_torch_render.py`` and ``test_torch_quantize.py``).

Training, evaluation and the int8 calibration zero the field, so their
results are the same bits with the tier on and off.
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
from keras_nerf_tpu_torch.utils.convert import (
    params_from_jax,
    quantized_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_ATOL, DEPTH_ATOL = 2e-3, 5e-3
REF_ATOL = 1e-4
B, H, W, CHUNK = 1, 4, 8, 16
FAST = 12

JAX_CFG = jengine.NeRFConfig(n_coarse=8, n_fine=8, pos_emb_xyz=10,
                             pos_emb_dir=4, n_layers=3, dense_units=256,
                             skip_layer=2, white_background=True,
                             use_pallas=True, fast_render=FAST)


def _port_cfg(jcfg, use_kernels):
    return tengine.NeRFConfig(**jcfg.to_model_config(),
                              white_background=jcfg.white_background,
                              use_kernels=use_kernels,
                              fast_render=jcfg.fast_render)


def _report(what, reading, budget):
    print(f"\n{what}: {reading:.3e} (budget {budget:g})")
    assert reading <= budget, what


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
    keys = jax.random.split(key, B * H * W // CHUNK)
    return {"pc": jax.tree.map(np.asarray, params_c),
            "pf": jax.tree.map(np.asarray, params_f), "rays": (o, d, t),
            "key": key,
            "draws": {n: [np.asarray(jax_sorted_uniforms(k, (CHUNK,), n))
                          for k in keys] for n in (FAST, JAX_CFG.n_fine)}}


def _port_render(scene, cfg, n=FAST, **kw):
    return tengine.render_image_batch(
        params_from_jax(scene["pc"], "cpu"),
        params_from_jax(scene["pf"], "cpu"),
        tuple(torch.as_tensor(x) for x in scene["rays"]),
        [torch.tensor(u) for u in scene["draws"][n]], cfg, CHUNK, **kw)


def _jax_render(scene, cfg, **kw):
    return jengine.render_image_batch(
        scene["pc"], scene["pf"],
        tuple(jnp.asarray(x) for x in scene["rays"]), scene["key"], cfg,
        CHUNK, **kw)


def test_render_chunk_reference_matches_jax_xla(scene):
    """The fine pass of the float32 reference path: the draws' depths alone
    (no coarse depths merged in), rendered, against JAX's render_chunk on
    XLA with the same draws, chunk by chunk."""
    jcfg = dataclasses.replace(JAX_CFG, use_pallas=False)
    cfg = _port_cfg(jcfg, False)
    o, d, t = (x.reshape(-1, x.shape[-1]) for x in scene["rays"])
    keys = jax.random.split(scene["key"], o.shape[0] // CHUNK)
    pc, pf = (params_from_jax(scene[k], "cpu") for k in ("pc", "pf"))
    for i, k in enumerate(keys):
        sl = slice(i * CHUNK, (i + 1) * CHUNK)
        jo, jd, jt = (jnp.asarray(x[sl]) for x in (o, d, t))
        want_c, _ = jengine.render_chunk(scene["pc"], jo, jd, jt, k, jcfg)
        want_f, want_pts = jengine.render_chunk(
            scene["pf"], jo, jd, jt, k, jcfg, coarse_weights=want_c.weights)
        to, td, tt = (torch.as_tensor(x[sl]) for x in (o, d, t))
        got_c, _ = tengine.render_chunk(pc, to, td, tt, cfg)
        got_f, got_pts = tengine.render_chunk(
            pf, to, td, tt, cfg, u=torch.tensor(scene["draws"][FAST][i]),
            coarse_weights=got_c.weights)
        assert got_pts.shape == (CHUNK, FAST)
        _report(f"chunk {i} fine depths used, max abs", float(np.abs(
            got_pts.numpy() - np.asarray(want_pts)).max()), REF_ATOL)
        for name in ("image", "depth"):
            _report(f"chunk {i} fine {name}, max abs", float(np.abs(
                getattr(got_f, name).detach().numpy()
                - np.asarray(getattr(want_f, name))).max()), REF_ATOL)


@pytest.mark.parametrize("with_weights,coarse_image",
                         [(False, False), (True, True)])
def test_kernel_path_matches_jax_fused_render(scene, with_weights,
                                              coarse_image):
    """The kernel path (the plain versions: the fine pass samples in
    sample_merge's no-merge mode) against JAX's fused kernels in
    interpret mode, which sample with sample_pdf_sorted on XLA."""
    kw = dict(with_weights=with_weights, coarse_image=coarse_image)
    want_c, want_f = _jax_render(scene, JAX_CFG, **kw)
    got_c, got_f = _port_render(scene, _port_cfg(JAX_CFG, True), **kw)
    budget = {"image": IMAGE_ATOL, "depth": DEPTH_ATOL, "weights": 2e-3}
    for name, got, want in (("coarse", got_c, want_c),
                            ("fine", got_f, want_f)):
        assert set(got) == set(want)
        for k in want:
            _report(f"kernel path {name} {k}, max abs", float(np.abs(
                got[k].numpy() - np.asarray(want[k])).max()), budget[k])
    if with_weights:
        assert got_f["weights"].shape == (B, H, W, FAST)
    assert float(got_f["image"].std()) > 0.01


def test_int8_fast_render_matches_jax(scene):
    """int8 + fast_render from JAX's own int8 dicts (its calibration,
    jitted as NeRF calls it), against JAX's quantized render in interpret
    mode."""
    jrays = tuple(jnp.asarray(x) for x in scene["rays"])
    want_q = jax.jit(lambda a, b, r, k: jengine.quantize_render_params(
        a, b, r, k, JAX_CFG))(scene["pc"], scene["pf"], jrays, scene["key"])
    same = tuple(quantized_from_jax(jax.tree.map(np.array, q), "cpu")
                 for q in want_q)
    want_c, want_f = _jax_render(scene, JAX_CFG, packed_q=want_q,
                                 with_weights=False, coarse_image=False)
    got_c, got_f = _port_render(scene, _port_cfg(JAX_CFG, True),
                                packed_q=same, with_weights=False,
                                coarse_image=False)
    for name, got, want in (("coarse", got_c, want_c),
                            ("fine", got_f, want_f)):
        for k, budget in (("image", IMAGE_ATOL), ("depth", DEPTH_ATOL)):
            _report(f"int8 fast render {name} {k}, max abs", float(np.abs(
                got[k].numpy() - np.asarray(want[k])).max()), budget)
    exact = _port_render(
        scene, dataclasses.replace(_port_cfg(JAX_CFG, True), fast_render=0),
        n=JAX_CFG.n_fine, packed_q=same, with_weights=False)[1]
    assert not np.array_equal(exact["image"].numpy(),
                              got_f["image"].numpy())


def test_render_draws_must_match_the_tier(scene):
    """The fine draws are [R, fast_render] when the tier is on; [R, n_fine]
    ones are refused by name."""
    with pytest.raises(ValueError, match="fine draws must be"):
        _port_render(scene, _port_cfg(JAX_CFG, True), n=JAX_CFG.n_fine)


def _train_batch():
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    o = np.zeros((B, H, W, 3), np.float32)
    o[..., 2] = 4.0
    d = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2, 6, (B, H, W, 8)), -1).astype(np.float32)
    return tuple(torch.as_tensor(x) for x in (images, o, d, t))


def _same_bits(a, b) -> bool:
    """Nested dicts, lists and tuples of tensors and numbers, equal leaf
    for leaf (tensors bit for bit)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_bits, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("fn", ["train_step", "eval_step",
                                "quantize_render_params"])
def test_exact_paths_ignore_the_tier(scene, fn, use_kernels):
    """train_step, eval_step and quantize_render_params zero fast_render
    (`engine.py:653`, `:858`, `:422`): the same bits with it on and off."""
    images, o, d, t = _train_batch()
    rays = (o, d, t)
    draws = [torch.tensor(u) for u in scene["draws"][JAX_CFG.n_fine]]
    pc, pf = (params_from_jax(scene[k], "cpu") for k in ("pc", "pf"))
    outs = []
    for fast in (0, FAST):
        cfg = dataclasses.replace(_port_cfg(JAX_CFG, use_kernels),
                                  fast_render=fast)
        if fn == "train_step":
            opt = tengine.make_optimizer("adam", 1e-3)
            state = tengine.TrainState(pc, pf, opt.init(pc), opt.init(pf), 0)
            outs.append(tengine.train_step(state, (images, rays), draws, opt,
                                           cfg, CHUNK))
        elif fn == "eval_step":
            state = tengine.TrainState(pc, pf, {}, {}, 0)
            outs.append(tengine.eval_step(state, (images, rays), draws, cfg,
                                          CHUNK))
        else:
            # One calibration draw row for each of the 32 rays.
            outs.append(tengine.quantize_render_params(
                pc, pf, rays, torch.cat(draws), cfg))
    assert _same_bits(outs[0], outs[1])


def test_nerf_fast_render_survives_load_model(scene, tmp_path):
    """compile(fast_render=) survives load_model (`nerf.py:799-815`), the
    render follows it, and load_model drops the baked occupancy grid of the
    old weights (`nerf.py:821`); the occupancy render ignores the tier."""
    cfg = dataclasses.replace(JAX_CFG, use_pallas=None, fast_render=0)
    state = jengine.init_train_state(jax.random.PRNGKey(3), cfg,
                                     jengine.make_optimizer("adam"))
    jckpt.save_model(str(tmp_path), state, cfg)
    nerf = NeRF(model_path=str(tmp_path))
    nerf.compile(batch_size=B, image_height=H, image_width=W,
                 ray_chunks=CHUNK, white_background=True, device="cpu",
                 fast_render=FAST)
    assert nerf.config.fast_render == FAST
    rays = tuple(torch.as_tensor(x) for x in scene["rays"])
    draws = [torch.tensor(u) for u in scene["draws"][FAST]]
    _, before = nerf.predict_and_render_images(rays, fine_draws=draws)
    assert before["weights"].shape == (B, H, W, FAST)
    nerf.bake_occupancy(16)
    occ = [nerf.render_occupancy(rays, fine_draws=[
        torch.tensor(u) for u in scene["draws"][FAST]], n_samples=FAST)]
    nerf.load_model(str(tmp_path))
    assert nerf.config.fast_render == FAST
    assert nerf.occ_grid is None
    with pytest.raises(RuntimeError, match="bake_occupancy"):
        nerf.render_occupancy(rays)
    _, after = nerf.predict_and_render_images(rays, fine_draws=draws)
    for k in before:
        np.testing.assert_array_equal(after[k].numpy(), before[k].numpy())
    # The occupancy render reads no fast_render: off, the same bits.
    exact = NeRF(model_path=str(tmp_path))
    exact.compile(batch_size=B, image_height=H, image_width=W,
                  ray_chunks=CHUNK, white_background=True, device="cpu")
    exact.bake_occupancy(16)
    occ.append(exact.render_occupancy(rays, fine_draws=[
        torch.tensor(u) for u in scene["draws"][FAST]], n_samples=FAST))
    for k in occ[0]:
        np.testing.assert_array_equal(occ[0][k].numpy(), occ[1][k].numpy())


@pytest.mark.parametrize("quantized", [False, True])
def test_inference_cli_fast_render_writes_both_gifs(tmp_path, quantized):
    import imageio.v2 as imageio

    model_dir = tmp_path / "model"
    cfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                             dense_units=256, skip_layer=4)
    jckpt.save_model(str(model_dir), jengine.init_train_state(
        jax.random.PRNGKey(3), cfg, jengine.make_optimizer("adam")), cfg)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "keras_nerf_tpu_torch.inference",
         "--model_dirs", str(model_dir), "--img_wh", "16",
         "--output_freq", "180", "--ray_chunks", "256", "--white_bg",
         "--fast_render", "8", "--device", "cpu", "--output_dir", str(out),
         "--name", "orbit"] + (["--quantized_render"] if quantized else []),
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "fast_render=8" in proc.stderr
    for name in ("orbit.gif", "orbit_depth.gif"):
        frames = imageio.mimread(out / name)
        assert len(frames) == 2 and frames[0].shape[:2] == (16, 16), name
