"""The port's training path against the JAX package's, on the CPU.

Same parameters (drawn by JAX, carried over with ``params_from_jax``), rays,
targets and fine draws (JAX's per-chunk ``sorted_uniforms`` injected into
the port). Budgets:

* the kernel path (the port's plain versions) against JAX's TPU kernel in
  interpret mode: image atol 2e-3, depth atol 5e-3 (the fused-sampling
  budget, `test_pallas_kernel.py:431-434`), per-leaf gradients relative
  norm 0.03 and relative max 0.12, step losses rtol 0.03
  (`test_pallas_kernel.py:336-349,380-389`);
* the float32 reference path against JAX's XLA path: gradients relative
  max 1e-4, losses rtol 1e-5;
* Adam against optax: rtol 1e-6.

Gradients of a step are read as the SGD (lr 1) parameter change.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from keras_nerf_tpu.kernels import ray_march as jrm
from keras_nerf_tpu.models import NeRF as JaxNeRF
from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.models import mlp as jmlp
from keras_nerf_tpu.ops.sampling import invert_cdf as jax_invert_cdf
from keras_nerf_tpu.ops.sampling import merge_sorted as jax_merge_sorted
from keras_nerf_tpu.ops.sampling import midpoints as jax_midpoints
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu.utils import checkpoint as jckpt
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRF
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.models.mlp import MLPConfig
from keras_nerf_tpu_torch.utils.convert import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_ATOL, DEPTH_ATOL, WEIGHTS_ATOL = 2e-3, 5e-3, 2e-3
GRAD_REL_NORM, GRAD_REL_MAX, LOSS_RTOL = 0.03, 0.12, 0.03
R = 16


def _rel(a, b):
    """(relative norm, relative max) of ``a`` against the reference ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12),
            np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _assert_grads_close(got, want, rel_norm, rel_max, label=""):
    got_leaves, want_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    worst = (0.0, 0.0)
    for path_leaf, a, b in zip(jax.tree_util.tree_leaves_with_path(want),
                               got_leaves, want_leaves):
        assert np.shape(a) == np.shape(b)
        rn, rm = _rel(a, b)
        name = jax.tree_util.keystr(path_leaf[0])
        assert rn <= rel_norm and rm <= rel_max, (label, name, rn, rm)
        worst = (max(worst[0], rn), max(worst[1], rm))
    print(f"{label}: worst leaf relative norm {worst[0]:.2e}, "
          f"relative max {worst[1]:.2e}")


# ---------------------------------------------------------------------------
# fused_train_chunk(with_grad=True): the plain T3 against the TPU kernel.


def _model(n_layers, skip, seed=2):
    cfg_j = jmlp.MLPConfig(n_layers=n_layers, dense_units=256,
                           skip_layer=skip)
    params = jax.tree.map(np.asarray, jmlp.init_mlp(
        jax.random.PRNGKey(seed), cfg_j, 63, 27))
    # A sigma bias of 0.5 gives every ray density, so every leaf gets a
    # gradient well above rounding noise.
    params["sigma"]["bias"] = params["sigma"]["bias"] + 0.5
    cfg_t = MLPConfig(n_layers=n_layers, dense_units=256, skip_layer=skip)
    return (cfg_j, jrm.pack_mlp_params(params, cfg_j, 10, 4), cfg_t,
            trm.pack_mlp_params(params_from_jax(params, "cpu"), cfg_t, 10, 4))


def _chunk(s_c, n_fine, seed=0):
    rng = np.random.default_rng(seed)
    o = np.zeros((R, 3), np.float32)
    o[:, 2] = 4.0
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cp = np.sort(rng.uniform(2, 6, (R, s_c)).astype(np.float32), -1)
    wc = (rng.uniform(size=(R, s_c)) ** 3).astype(np.float32)
    u = np.sort(rng.uniform(size=(R, n_fine)).astype(np.float32), -1)
    tgt = rng.uniform(size=(R, 3)).astype(np.float32)
    return o, d, cp, wc, u, tgt


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


# (n_layers, skip, s_c, n_fine, mode, white_bg). The 3 x 1 trunk's last
# layer skips, so w_sf_enc and trunk_enc_w train too.
TRAIN_CASES = [(3, 1, 24, 16, mode, white) for mode in ("coarse", "fine")
               for white in (True, False)]
TRAIN_CASES += [(2, 4, 8, 8, mode, True) for mode in ("coarse", "fine")]
# Fine S = 64 + 1024 = 1088: past the 1024 samples a ray that the card's
# with_grad quadrature once refused (ROADMAP C14). Past 128 draws JAX's
# engine samples outside its kernel (engine._fused_sampling_ok): the same
# inverse CDF and merge, on XLA, then the kernel on the given depths.
TRAIN_CASES += [(2, 4, 64, 1024, "fine", True)]


@pytest.mark.parametrize("n_layers,skip,s_c,n_fine,mode,white_bg",
                         TRAIN_CASES)
def test_fused_train_chunk_matches_tpu_kernel(n_layers, skip, s_c, n_fine,
                                              mode, white_bg):
    """Coarse mode (given depths, weights out) and fine mode (in-kernel
    sampling; JAX's sampling on XLA past 128 draws, as its engine runs
    it): image, depth, weights and every packed gradient."""
    cfg_j, packed_j, cfg_t, packed_t = _model(n_layers, skip)
    o, d, cp, wc, u, tgt = _chunk(s_c, n_fine)
    kw = dict(white_background=white_bg)
    kw_j = dict(kw, with_grad=True, interpret=True)
    if mode == "coarse":
        out_j = jrm.fused_train_chunk(packed_j, o, d, cp, tgt, cfg_j, **kw_j)
        out_t = trm.fused_train_chunk(packed_t, *_t(o, d, cp, tgt), **kw)
        np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]),
                                   atol=WEIGHTS_ATOL)
    elif n_fine > 128:
        points = jax_merge_sorted(cp, jax_invert_cdf(u, jax_midpoints(cp),
                                                     wc))
        out_j = jrm.fused_train_chunk(packed_j, o, d, points, tgt, cfg_j,
                                      emit_weights=False, **kw_j)
    else:
        out_j = jrm.fused_train_chunk(
            packed_j, o, d, None, tgt, cfg_j, emit_weights=False,
            sample_inputs=(cp, wc, u), **kw_j)
    if mode == "fine":
        out_t = trm.fused_train_chunk(
            packed_t, *_t(o, d), None, torch.as_tensor(tgt),
            emit_weights=False, sample_inputs=_t(cp, wc, u), **kw)
        assert out_t[2] is None and out_j[2] is None
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               atol=IMAGE_ATOL)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]),
                               atol=DEPTH_ATOL)
    print(f"image max_abs_err "
          f"{np.abs(out_t[0].numpy() - np.asarray(out_j[0])).max():.2e}, "
          f"depth max_abs_err "
          f"{np.abs(out_t[1].numpy() - np.asarray(out_j[1])).max():.2e}")
    got = params_to_jax(trm.unpack_grads(out_t[3], cfg_t, 10, 4))
    want = jrm.unpack_grads(out_j[3], cfg_j, 10, 4)
    _assert_grads_close(got, want, GRAD_REL_NORM, GRAD_REL_MAX,
                        f"{n_layers}x256 skip {skip} {mode} white {white_bg}")


def test_sub_launches_give_the_single_launch(monkeypatch):
    """A chunk cut into sub-launches of whole rays, as a 16384-ray chunk is
    on the card, gives the single launch's outputs and gradients (float32
    sums over the points in another grouping)."""
    assert trm.train_sub_launches(16384, 192) == [
        (0, 5462), (5462, 10924), (10924, 16384)]
    _, _, _, packed_t = _model(2, 4)
    o, d, cp, _, _, tgt = _chunk(24, 16)
    args = (packed_t, *_t(o, d, cp, tgt))
    whole = trm.fused_train_chunk(*args, white_background=True)
    monkeypatch.setattr(trm, "MAX_TRAIN_POINTS", 5 * 24)
    assert len(trm.train_sub_launches(R, 24)) == 4
    parts = trm.fused_train_chunk(*args, white_background=True)
    for a, b in zip(parts[:3], whole[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    for a, b in zip(tengine.tree_leaves(parts[3]),
                    tengine.tree_leaves(whole[3])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("n_layers,skip", [(8, 4), (3, 2), (3, 1)])
def test_unpack_grads_matches_jax_exactly(n_layers, skip):
    cfg_j, packed_j, cfg_t, _ = _model(n_layers, skip)
    rng = np.random.default_rng(n_layers + skip)
    d_packed = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), packed_j)
    want = jrm.unpack_grads(d_packed, cfg_j, 10, 4)
    got = trm.unpack_grads(jax.tree.map(torch.as_tensor, d_packed), cfg_t,
                           10, 4)
    for a, b in zip(jax.tree.leaves(params_to_jax(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# One train step against JAX's.

B, H, W, CHUNK = 1, 4, 8, 16


def _batch(n_coarse, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, H, W, 4)).astype(np.float32)
    o = np.zeros((B, H, W, 3), np.float32)
    o[..., 2] = 4.0
    d = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2, 6, (B, H, W, n_coarse)), -1).astype(
        np.float32)
    return images, (o, d, t)


def _jax_draws(key, n_fine):
    keys = jax.random.split(key, B * H * W // CHUNK)
    return [torch.as_tensor(np.array(jax_sorted_uniforms(
        k, (CHUNK,), n_fine))) for k in keys]


def _port_cfg(jcfg, use_kernels):
    return tengine.NeRFConfig(**jcfg.to_model_config(),
                              white_background=jcfg.white_background,
                              use_kernels=use_kernels)


def _sgd_steps(jcfg, use_kernels, seed=0):
    """One SGD (lr 1) step of each package from the same state, batch and
    draws: ``(jax metrics, port metrics, jax grads, port grads)``."""
    opt_j = jengine.make_optimizer("sgd", 1.0)
    s0 = jengine.init_train_state(jax.random.PRNGKey(seed), jcfg, opt_j)
    images, rays = _batch(jcfg.n_coarse)
    key = jax.random.PRNGKey(5)
    s1, m_j = jengine.train_step(
        s0, (jnp.asarray(images), tuple(map(jnp.asarray, rays))), key,
        optimizer=opt_j, config=jcfg, ray_chunks=CHUNK)
    opt_t = tengine.make_optimizer("sgd", 1.0)
    p0 = [params_from_jax(jax.tree.map(np.asarray, p), "cpu")
          for p in (s0.coarse_params, s0.fine_params)]
    t0 = tengine.TrainState(p0[0], p0[1], opt_t.init(p0[0]),
                            opt_t.init(p0[1]), 0)
    t1, m_t = tengine.train_step(
        t0, (torch.as_tensor(images), tuple(_t(*rays))),
        _jax_draws(key, jcfg.n_fine), opt_t, _port_cfg(jcfg, use_kernels),
        CHUNK)
    assert t1.step == 1
    g_j = [jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), p, q)
           for p, q in ((s0.coarse_params, s1.coarse_params),
                        (s0.fine_params, s1.fine_params))]
    g_t = [jax.tree.map(lambda a, b: a - b, params_to_jax(p),
                        params_to_jax(q))
           for p, q in ((t0.coarse_params, t1.coarse_params),
                        (t0.fine_params, t1.fine_params))]
    return m_j, {k: float(v) for k, v in m_t.items()}, g_j, g_t


def test_fused_train_step_matches_jax_fused_step():
    """The port's kernel path (plain versions on the CPU) against
    ``train_step(use_pallas=True)`` (`test_pallas_kernel.py:352-389`)."""
    jcfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                              dense_units=256, skip_layer=4,
                              white_background=True,
                              compute_dtype="bfloat16", use_pallas=True)
    m_j, m_t, g_j, g_t = _sgd_steps(jcfg, None)
    for k in ("coarse_loss", "fine_loss"):
        np.testing.assert_allclose(m_t[k], float(m_j[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    for name, a, b in zip(("coarse", "fine"), g_t, g_j):
        _assert_grads_close(a, b, GRAD_REL_NORM, GRAD_REL_MAX,
                            f"fused step {name}")
    for k in ("coarse_grad_norm", "fine_grad_norm", "fine_psnr"):
        np.testing.assert_allclose(m_t[k], float(m_j[k]), rtol=LOSS_RTOL,
                                   err_msg=k)


def test_reference_train_step_matches_jax_xla_step():
    """``use_kernels=False`` (autograd over apply_mlp + render_rays) against
    ``train_step(use_pallas=False)`` in float32."""
    jcfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=3,
                              dense_units=64, skip_layer=2,
                              white_background=True,
                              compute_dtype="float32", use_pallas=False)
    m_j, m_t, g_j, g_t = _sgd_steps(jcfg, False)
    for k in ("coarse_loss", "fine_loss"):
        np.testing.assert_allclose(m_t[k], float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    for name, a, b in zip(("coarse", "fine"), g_t, g_j):
        _assert_grads_close(a, b, np.inf, 1e-4, f"reference step {name}")


# ---------------------------------------------------------------------------
# Guards of the engine (`tests/models/test_engine.py:86-145`).


@pytest.mark.parametrize("use_kernels,units", [(False, 32), (None, 256)])
def test_chunked_equals_unchunked_grads(use_kernels, units):
    """``ray_chunks`` is a memory knob, not a math knob: with the same draws
    per ray, chunked and whole-batch gradients of both models agree."""
    cfg = tengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=3,
                             dense_units=units, skip_layer=2,
                             white_background=True, use_kernels=use_kernels)
    images, rays = _batch(cfg.n_coarse, seed=3)
    batch = (torch.as_tensor(images), tuple(_t(*rays)))
    draws = torch.sort(torch.rand(B * H * W, cfg.n_fine,
                                  generator=torch.Generator().manual_seed(1)),
                       -1).values
    opt = tengine.make_optimizer("sgd", 1.0)
    gen = torch.Generator().manual_seed(0)
    s0 = tengine.init_train_state(gen, cfg, opt, "cpu")
    states = [tengine.train_step(s0, batch, list(draws.split(chunk)), opt,
                                 cfg, chunk)[0]
              for chunk in (B * H * W, CHUNK)]
    for a, b in zip(tengine.tree_leaves(states[0][:2]),
                    tengine.tree_leaves(states[1][:2])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=1e-6)


def test_fine_loss_does_not_update_coarse_params():
    """The gradient of coarse + fine loss with respect to the coarse
    parameters is the gradient of the coarse loss alone, on the reference
    path (autograd) and on the kernel path (separate accumulators)."""
    cfg = tengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                             dense_units=256, skip_layer=4,
                             white_background=True)
    images, (o, d, t) = _batch(cfg.n_coarse, seed=4)
    o, d, t = (torch.as_tensor(x.reshape(-1, x.shape[-1])) for x in (o, d, t))
    tgt = torch.as_tensor(images[..., :3].reshape(-1, 3))
    u = torch.sort(torch.rand(o.shape[0], cfg.n_fine,
                              generator=torch.Generator().manual_seed(2)),
                   -1).values
    coarse, fine = tengine.init_params(torch.Generator().manual_seed(1), cfg)

    def grad_of(loss_fn):
        pc = tengine.tree_map(lambda x: x.clone().requires_grad_(True),
                              coarse)
        pf = tengine.tree_map(lambda x: x.clone().requires_grad_(True), fine)
        loss_fn(pc, pf).backward()
        return [x.grad for x in tengine.tree_leaves(pc)]

    def total(pc, pf):
        out_c, out_f = tengine.render_chunk_pair(pc, pf, o, d, t, u, cfg)
        return (tengine.mse_loss(tgt, out_c.image)
                + tengine.mse_loss(tgt, out_f.image))

    def coarse_only(pc, pf):
        out_c, _ = tengine.render_chunk(pc, o, d, t, cfg)
        return tengine.mse_loss(tgt, out_c.image)

    for a, b in zip(grad_of(total), grad_of(coarse_only)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)

    packed = [trm.pack_mlp_params(p, cfg.mlp, 10, 4) for p in (coarse, fine)]
    acc = (trm.zero_grads(packed[0]), trm.zero_grads(packed[1]))
    tengine._fused_chunk_pair(*packed, o, d, t, u, cfg, target=tgt,
                              grads=acc)
    alone = trm.fused_train_chunk(packed[0], o, d, t, tgt,
                                  white_background=True)[3]
    for a, b in zip(tengine.tree_leaves(acc[0]), tengine.tree_leaves(alone)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Optimizer and checkpoints.


def test_adam_with_exponential_lr_matches_optax():
    rng = np.random.default_rng(6)
    params = {"trunk": [{"kernel": rng.normal(size=(4, 3)).astype(
        np.float32), "bias": np.zeros(3, np.float32)}],
        "rgb": {"kernel": rng.normal(size=(3, 2)).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32) * 10.0 ** rng.integers(-4, 1), params) for _ in range(5)]
    opt_j = jengine.make_optimizer(
        "adam", jengine.exponential_lr(1e-2, 1e-4, 3))
    opt_t = tengine.make_optimizer(
        "adam", tengine.exponential_lr(1e-2, 1e-4, 3))
    p_j, s_j = params, opt_j.init(params)
    p_t = params_from_jax(params, "cpu")
    s_t = opt_t.init(p_t)
    for g in grads:
        upd, s_j = opt_j.update(g, s_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        p_t, s_t = opt_t.update(params_from_jax(g, "cpu"), s_t, p_t)
    for a, b in zip(jax.tree.leaves(params_to_jax(p_t)), jax.tree.leaves(p_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
    from flax import serialization
    want = jax.tree.map(np.asarray, serialization.to_state_dict(s_j))
    got = opt_state_to_jax(s_t)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    back = opt_state_from_jax(got, "cpu")
    assert back["count"] == 5 and back["schedule_count"] == 5
    for name in ("adamw", "rmsprop"):
        with pytest.raises(ValueError, match="ROADMAP"):
            tengine.make_optimizer(name)


def _toy_nerf_cfg():
    return dict(n_coarse=8, n_fine=8, n_layers=3, dense_units=32,
                skip_layer=2)


def _step_batch():
    images, rays = _batch(8, seed=7)
    return images, rays


def test_port_checkpoint_resumes_in_jax(tmp_path):
    nerf = NeRF(**_toy_nerf_cfg()).compile(
        optimizer="adam", image_height=H, image_width=W, ray_chunks=CHUNK,
        white_background=True, learning_rate=1e-3, lr_final=1e-4,
        lr_decay_steps=10, device="cpu", use_kernels=False)
    nerf.train_step(_step_batch())
    nerf.save_model(str(tmp_path))
    jcfg = jengine.NeRFConfig(**_toy_nerf_cfg())
    opt = jengine.make_optimizer("adam",
                                 jengine.exponential_lr(1e-3, 1e-4, 10))
    template = jengine.init_train_state(jax.random.PRNGKey(9), jcfg, opt)
    state = jckpt.load_train_state(str(tmp_path), template)
    assert int(state.step) == 1
    for mine, theirs in ((nerf.state.coarse_params, state.coarse_params),
                         (nerf.state.fine_params, state.fine_params)):
        for a, b in zip(jax.tree.leaves(params_to_jax(mine)),
                        jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(a, np.asarray(b))
    from flax import serialization
    for mine, theirs in ((nerf.state.coarse_opt, state.coarse_opt),
                         (nerf.state.fine_opt, state.fine_opt)):
        want = jax.tree.map(np.asarray, serialization.to_state_dict(theirs))
        got = opt_state_to_jax(mine)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    assert int(want["0"]["count"]) == 1 and int(want["1"]["count"]) == 1


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jcfg = jengine.NeRFConfig(**_toy_nerf_cfg(), white_background=True)
    opt = jengine.make_optimizer("adam", 1e-3)
    state = jengine.init_train_state(jax.random.PRNGKey(3), jcfg, opt)
    images, rays = _step_batch()
    state, _ = jengine.train_step(
        state, (jnp.asarray(images), tuple(map(jnp.asarray, rays))),
        jax.random.PRNGKey(1), optimizer=opt, config=jcfg, ray_chunks=CHUNK)
    jckpt.save_model(str(tmp_path), state, jcfg,
                     train_config={"learning_rate": 1e-3})
    nerf = NeRF(model_path=str(tmp_path)).compile(
        optimizer="adam", image_height=H, image_width=W, ray_chunks=CHUNK,
        white_background=True, device="cpu", use_kernels=False)
    assert nerf.state.step == 1
    assert nerf.state.coarse_opt["count"] == 1
    for mine, theirs in ((nerf.state.coarse_params, state.coarse_params),
                         (nerf.state.coarse_opt["mu"], state.coarse_opt[0].mu),
                         (nerf.state.fine_opt["nu"], state.fine_opt[0].nu)):
        for a, b in zip(jax.tree.leaves(params_to_jax(mine)),
                        jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(a, np.asarray(b))
    nerf.train_step(_step_batch())
    assert nerf.state.step == 2 and nerf.state.fine_opt["count"] == 2


# ---------------------------------------------------------------------------
# The whole path.


def _write_scene(path):
    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

    return write_synthetic_scene(str(path), image_wh=16, n_train=4, n_val=2,
                                 n_test=2)


def test_train_single_cli_trains_and_writes_a_jax_readable_model(tmp_path):
    scene = _write_scene(tmp_path / "scene")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "keras_nerf_tpu_torch.train_single",
         "--device", "cpu", "--data_dir", scene, "--img_wh", "16",
         "--num_coarse_samples", "8", "--num_fine_samples", "8",
         "--num_layers", "2", "--white_bg", "--num_epochs", "2",
         "--ray_chunks", "128", "--learning_rate", "5e-3",
         "--log_dir", str(tmp_path / "logs"),
         "--model_dirs", str(tmp_path / "models"), "--name", "t"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "logs" / "t" / "log.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    assert float(rows[1]["fine_loss"]) < float(rows[0]["fine_loss"])
    model_dir = str(tmp_path / "models" / "t")
    port = NeRF(model_path=model_dir).compile(
        image_height=16, image_width=16, ray_chunks=128, device="cpu")
    theirs = JaxNeRF(model_path=model_dir)
    theirs.compile(image_height=16, image_width=16, ray_chunks=128)
    assert theirs.config.to_model_config() == port.config.to_model_config()
    for a, b in zip(jax.tree.leaves(params_to_jax(port.state.fine_params)),
                    jax.tree.leaves(theirs.state.fine_params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(theirs.state.step) == port.state.step == 8


def test_two_runs_with_one_seed_give_equal_losses(tmp_path):
    from keras_nerf_tpu_torch.data import DatasetLoader

    scene = _write_scene(tmp_path / "scene")
    histories = []
    for _ in range(2):
        train, val, _ = DatasetLoader(scene, True, device="cpu").load_dataset(
            batch_size=1, image_width=16, image_height=16, near=2.0,
            far=6.0, n_sample=8, seed=3)
        nerf = NeRF(n_coarse=8, n_fine=8, n_layers=2).compile(
            image_height=16, image_width=16, ray_chunks=128,
            white_background=True, device="cpu", seed=3)
        histories.append(nerf.fit(train, validation_data=val, epochs=2,
                                  verbose=False))
    assert histories[0] == histories[1]
    assert all(np.isfinite(v) for h in histories[0] for v in h.values())
