"""The custom-loss training path of the port against the JAX package's, on
the CPU: ``encode_block128``, the T5 kernel ``apply_mlp`` (forward of
``fused_point_forward``), T6 (``fused_mlp_backward``, its backward) and
``train_step`` with a callable loss.

The JAX side runs its Pallas kernels in interpret mode; the port's wrappers
run their plain versions on CPU tensors. Inputs come from numpy with a
seed, weights from JAX through ``params_from_jax``. Budgets:

* ``encode_block128``: one bf16 step per entry (XLA's and PyTorch's sin and
  cos of arguments up to ~3000 rad may differ by a float32 ulp, which can
  flip a bf16 rounding);
* ``apply_mlp``: atol 2e-3 on (rgb, sigma);
* ``fused_point_forward`` gradients against ``jax.grad`` of the JAX
  custom_vjp, per leaf: relative max 0.05 (`test_pallas_kernel.py:152-153`)
  and relative norm 0.03;
* ``train_step(loss_fn=l1)``: losses rtol 0.03, per-leaf gradients
  relative norm 0.03 and relative max 0.12
  (`test_pallas_kernel.py:336-349,380-389`);
* ``point_render_chunk`` against JAX ``fused_render_chunk``: image atol
  0.03, depth atol 0.05 (`test_pallas_kernel.py:61-76`).

Run with ``-s`` to see each reading beside its budget.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.kernels import ray_march as jrm
from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.models import mlp as jmlp
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu_torch.kernels import KERNELS
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRF
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.models.mlp import MLPConfig
from keras_nerf_tpu_torch.utils.convert import params_from_jax, params_to_jax

APPLY_ATOL = 2e-3
FPF_REL_MAX, FPF_REL_NORM = 0.05, 0.03
GRAD_REL_NORM, GRAD_REL_MAX, LOSS_RTOL = 0.03, 0.12, 0.03
RENDER_IMAGE_ATOL, RENDER_DEPTH_ATOL = 0.03, 0.05
# (n_layers, skip): 2 x 256 whose last layer skips (w_sf_enc trains), and
# the 8 x 256 default.
ARCHS = [(2, 1), (8, 4)]


def _rel(a, b):
    """(relative norm, relative max) of ``a`` against the reference ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12),
            np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _assert_trees_close(got, want, rel_norm, rel_max, label):
    worst = (0.0, 0.0)
    for (path, b), a in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        assert np.shape(a) == np.shape(b), jax.tree_util.keystr(path)
        rn, rm = _rel(a, b)
        assert rn <= rel_norm and rm <= rel_max, (
            label, jax.tree_util.keystr(path), rn, rm)
        worst = (max(worst[0], rn), max(worst[1], rm))
    print(f"{label}: worst leaf relative norm {worst[0]:.2e} (budget "
          f"{rel_norm}), relative max {worst[1]:.2e} (budget {rel_max})")


def _model(n_layers, skip, seed=2):
    cfg_j = jmlp.MLPConfig(n_layers=n_layers, dense_units=256,
                           skip_layer=skip)
    params = jax.tree.map(np.asarray, jmlp.init_mlp(
        jax.random.PRNGKey(seed), cfg_j, 63, 27))
    # Density everywhere: sigma's relu passes and every leaf trains.
    params["sigma"]["bias"] = params["sigma"]["bias"] + 0.5
    cfg_t = MLPConfig(n_layers=n_layers, dense_units=256, skip_layer=skip)
    return cfg_j, cfg_t, params


def _points(p, seed=0):
    """Points on rays from (0, 0, 4) at depths in [2, 6], as training
    samples them: coordinates up to ~6, encoding arguments to ~3000 rad."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(p, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(2.0, 6.0, (p, 1)).astype(np.float32)
    pos = (np.array([0.0, 0.0, 4.0], np.float32) + d * t).astype(np.float32)
    return pos, d


def _bf16_order(x: torch.Tensor) -> np.ndarray:
    """bf16 values as integers in the order of the values (+0 and -0 both
    0), so that neighbouring bf16 values differ by 1."""
    bits = x.view(torch.int16).numpy().astype(np.int32) & 0xFFFF
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def test_encode_block128_matches_jax():
    pos, d = _points(4096)
    want = np.asarray(jrm.encode_block128(jnp.asarray(pos), jnp.asarray(d),
                                          10, 4).astype(jnp.float32))
    got = trm.encode_block128(torch.as_tensor(pos), torch.as_tensor(d), 10, 4)
    assert got.dtype == torch.bfloat16 and got.shape == (4096, 128)
    steps = np.abs(_bf16_order(got) - _bf16_order(
        torch.from_numpy(want.copy()).to(torch.bfloat16)))
    share = float((steps > 0).mean())
    print(f"encode_block128: most bf16 steps apart {steps.max()} (budget 1), "
          f"share of entries that differ {share:.2e}")
    assert steps.max() <= 1
    # The raw lanes are exact: positions and directions, bit for bit.
    np.testing.assert_array_equal(got[:, [0, 1, 2]].float().numpy(),
                                  want[:, [0, 1, 2]])


def test_ray_points_match_the_engines_positions():
    rng = np.random.default_rng(1)
    o = rng.normal(size=(5, 3)).astype(np.float32)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    t = np.sort(rng.uniform(2, 6, (5, 7)), -1).astype(np.float32)
    pos, dirs = trm.ray_points(*map(torch.as_tensor, (o, d, t)))
    exact = (o[:, None].astype(np.float64)
             + d[:, None].astype(np.float64) * t[..., None])
    np.testing.assert_array_equal(pos.numpy(),
                                  exact.astype(np.float32).reshape(-1, 3))
    np.testing.assert_array_equal(dirs.numpy(),
                                  np.repeat(d, 7, axis=0))


@pytest.mark.parametrize("n_layers,skip", ARCHS)
def test_apply_mlp_plain_matches_jax_fused_apply_mlp(n_layers, skip):
    cfg_j, cfg_t, params = _model(n_layers, skip)
    pos, d = _points(300, seed=3)
    enc_j = jrm.encode_block128(jnp.asarray(pos), jnp.asarray(d), 10, 4)
    want = np.asarray(jrm.fused_apply_mlp(
        jrm.pack_mlp_params(params, cfg_j, 10, 4), enc_j, cfg_j,
        interpret=True))[:, :4]
    enc = torch.as_tensor(np.array(enc_j.astype(jnp.float32))).to(
        torch.bfloat16)
    packed = trm.pack_mlp_params(params_from_jax(params, "cpu"), cfg_t, 10, 4)
    got = trm.apply_mlp(packed, enc)
    err = float(np.abs(got.numpy() - want).max())
    print(f"apply_mlp {n_layers}x256 skip {skip}: max_abs_err {err:.2e} "
          f"(budget {APPLY_ATOL})")
    assert got.shape == (300, 4) and err <= APPLY_ATOL
    # The stash mode: the same outputs, the input itself as the stash's
    # encoding, and the activations that the forward kept.
    stash = trm.alloc_stash(300, 256, n_layers, enc.device, enc=enc)
    assert torch.equal(trm.apply_mlp(packed, enc, stash=stash), got)
    assert stash["enc"] is enc
    assert float(stash["h"][-1].float().abs().max()) > 0
    with pytest.raises(ValueError, match="enc"):
        trm.apply_mlp(packed, enc, stash=trm.alloc_stash(300, 256, n_layers,
                                                         enc.device))


def _fpf_loss(rgb, sigma, xp):
    return xp.sum(rgb * xp.arange(3)) + 0.5 * xp.sum(sigma ** 2)


@pytest.mark.parametrize("n_layers,skip", ARCHS)
def test_fused_point_forward_grads_match_jax_custom_vjp(n_layers, skip):
    """The loss of `test_pallas_kernel.py:135-144` through both packages'
    fused_point_forward: T5 forward, T6 backward."""
    cfg_j, cfg_t, params = _model(n_layers, skip, seed=0)
    pos, d = _points(96, seed=4)

    def jax_loss(prm):
        rgb, sg = jrm.fused_point_forward(prm, jnp.asarray(pos),
                                          jnp.asarray(d), cfg_j, 10, 4, 64,
                                          True)
        return _fpf_loss(rgb, sg, jnp)

    want = jax.grad(jax_loss)(params)
    leaves = jax.tree.map(lambda x: x.requires_grad_(True),
                          params_from_jax(params, "cpu"))
    rgb, sg = trm.fused_point_forward(leaves, torch.as_tensor(pos),
                                      torch.as_tensor(d), cfg_t, 10, 4)
    assert rgb.shape == (96, 3) and sg.shape == (96, 1)
    _fpf_loss(rgb, sg, torch).backward()
    got = params_to_jax(jax.tree.map(lambda x: x.grad, leaves))
    _assert_trees_close(got, want, FPF_REL_NORM, FPF_REL_MAX,
                        f"fused_point_forward {n_layers}x256 skip {skip}")


def test_fused_mlp_backward_sub_launches_give_the_single_launch(monkeypatch):
    """Above MAX_TRAIN_POINTS (patched small) the recompute runs in
    sub-launches, which add up to the single launch's gradient."""
    _, cfg_t, params = _model(2, 1)
    pos, d = _points(96, seed=5)
    enc = trm.encode_block128(torch.as_tensor(pos), torch.as_tensor(d))
    g = torch.as_tensor(np.random.default_rng(6).normal(
        size=(96, 4)).astype(np.float32)).to(torch.bfloat16)
    packed = trm.pack_mlp_params(params_from_jax(params, "cpu"), cfg_t, 10, 4)
    whole = trm.fused_mlp_backward(packed, enc, g)
    monkeypatch.setattr(trm, "MAX_TRAIN_POINTS", 40)
    assert len(trm.train_sub_launches(96, 1)) == 3
    parts = trm.fused_mlp_backward(packed, enc, g)
    # float32 sums over the points in another grouping: 1e-5 of each
    # leaf's largest magnitude.
    for a, b in zip(tengine.tree_leaves(parts), tengine.tree_leaves(whole)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# One train step with a callable loss against JAX's.

B, H, W, CHUNK = 1, 4, 8, 16


def l1(y_true, y_pred):
    return (y_pred - y_true).abs().mean()


def jax_l1(y_true, y_pred):
    return jnp.mean(jnp.abs(y_pred - y_true))


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


def _sgd_step(jcfg, jax_loss, port_loss):
    """One SGD (lr 1) step of each package from the same state, batch and
    fine draws (JAX's per-chunk sorted_uniforms injected): ``(jax metrics,
    port metrics, jax grads, port grads)``, the gradients read as the
    parameter change."""
    opt_j = jengine.make_optimizer("sgd", 1.0)
    s0 = jengine.init_train_state(jax.random.PRNGKey(0), jcfg, opt_j)
    images, rays = _batch(jcfg.n_coarse)
    key = jax.random.PRNGKey(5)
    s1, m_j = jengine.train_step(
        s0, (jnp.asarray(images), tuple(map(jnp.asarray, rays))), key,
        optimizer=opt_j, config=jcfg, ray_chunks=CHUNK, loss_fn=jax_loss)
    draws = [torch.as_tensor(np.array(jax_sorted_uniforms(
        k, (CHUNK,), jcfg.n_fine))) for k in jax.random.split(
            key, B * H * W // CHUNK)]
    opt_t = tengine.make_optimizer("sgd", 1.0)
    p0 = [params_from_jax(jax.tree.map(np.asarray, p), "cpu")
          for p in (s0.coarse_params, s0.fine_params)]
    t0 = tengine.TrainState(p0[0], p0[1], {}, {}, 0)
    cfg_t = tengine.NeRFConfig(**jcfg.to_model_config(),
                               white_background=jcfg.white_background)
    trm.reset_launch_counts()
    t1, m_t = tengine.train_step(
        t0, (torch.as_tensor(images), tuple(map(torch.as_tensor, rays))),
        draws, opt_t, cfg_t, CHUNK, loss_fn=port_loss)
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    g_j = [jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), p, q)
           for p, q in ((s0.coarse_params, s1.coarse_params),
                        (s0.fine_params, s1.fine_params))]
    g_t = [jax.tree.map(lambda a, b: a - b, params_to_jax(p),
                        params_to_jax(q))
           for p, q in ((t0.coarse_params, t1.coarse_params),
                        (t0.fine_params, t1.fine_params))]
    return m_j, {k: float(v) for k, v in m_t.items()}, g_j, g_t


@pytest.mark.parametrize("n_layers,skip", [(2, 4), (2, 1)])
def test_l1_train_step_matches_jax_pallas_step(n_layers, skip):
    """The port's kernel branch (T5/T6 plain versions on the CPU) against
    ``train_step(use_pallas=True, loss_fn=l1)``, whose fused_point_forward
    runs the TPU kernels in interpret mode."""
    jcfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=n_layers,
                              dense_units=256, skip_layer=skip,
                              white_background=True,
                              compute_dtype="bfloat16", use_pallas=True)
    m_j, m_t, g_j, g_t = _sgd_step(jcfg, jax_l1, l1)
    for k in ("coarse_loss", "fine_loss"):
        err = abs(m_t[k] - float(m_j[k])) / abs(float(m_j[k]))
        print(f"l1 step {n_layers}x256 skip {skip} {k}: relative err "
              f"{err:.2e} (budget {LOSS_RTOL})")
        assert err <= LOSS_RTOL, k
    for name, a, b in zip(("coarse", "fine"), g_t, g_j):
        _assert_trees_close(a, b, GRAD_REL_NORM, GRAD_REL_MAX,
                            f"l1 step {n_layers}x256 skip {skip} {name}")


def test_point_render_chunk_matches_jax_fused_render_chunk():
    jcfg = jengine.NeRFConfig(n_coarse=24, n_fine=0, n_layers=8,
                              dense_units=256, skip_layer=4,
                              white_background=True)
    cfg_j, cfg_t, params = _model(8, 4, seed=7)
    rng = np.random.default_rng(8)
    r = 16
    o = np.zeros((r, 3), np.float32)
    o[:, 2] = 4.0
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2, 6, (r, 24)), -1).astype(np.float32)
    want = jrm.fused_render_chunk(jrm.pack_mlp_params(params, cfg_j, 10, 4),
                                  o, d, t, jcfg, interpret=True)
    packed = trm.pack_mlp_params(params_from_jax(params, "cpu"), cfg_t, 10, 4)
    got = trm.point_render_chunk(packed, *map(torch.as_tensor, (o, d, t)),
                                 white_background=True)
    errs = {k: float(np.abs(getattr(got, k).numpy()
                            - np.asarray(getattr(want, k))).max())
            for k in ("image", "depth", "weights")}
    print(f"point_render_chunk: image max_abs_err {errs['image']:.2e} "
          f"(budget {RENDER_IMAGE_ATOL}), depth {errs['depth']:.2e} "
          f"(budget {RENDER_DEPTH_ATOL}), weights {errs['weights']:.2e}")
    assert errs["image"] <= RENDER_IMAGE_ATOL
    assert errs["depth"] <= RENDER_DEPTH_ATOL
    assert float(got.weights.sum(-1).min()) > 0.1   # the rays see density


def test_render_rays_clip_gradient_matches_jax_at_the_bounds():
    """An empty ray on a white background renders exactly 1.0 before the
    clip; its colour and density still get cotangents, through the clip's
    subgradient, which is 0.5 there in JAX."""
    from keras_nerf_tpu.ops.rendering import render_rays as jax_render_rays
    from keras_nerf_tpu_torch.ops import render_rays

    rng = np.random.default_rng(11)
    rgb = rng.uniform(size=(6, 12, 3)).astype(np.float32)
    sigma = rng.uniform(0, 3, (6, 12)).astype(np.float32)
    sigma[::2] = 0.0                        # empty rays: image exactly 1
    t = np.sort(rng.uniform(2, 6, (6, 12)), -1).astype(np.float32)
    c = rng.normal(size=(6, 3)).astype(np.float32)

    def jax_loss(rgb, sigma):
        out = jax_render_rays(rgb, sigma, t, white_background=True)
        return jnp.sum(out.image * c)

    want = jax.grad(jax_loss, argnums=(0, 1))(rgb, sigma)
    x = [torch.tensor(a, requires_grad=True) for a in (rgb, sigma)]
    out = render_rays(*x, torch.as_tensor(t), white_background=True)
    assert float(out.image.detach()[::2].min()) == 1.0
    (out.image * torch.as_tensor(c)).sum().backward()
    for a, b in zip(x, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    assert float(x[1].grad[::2].abs().max()) > 0


# ---------------------------------------------------------------------------
# The loss reaches training and evaluation (`test_engine.py:183-215`).


def _toy():
    cfg = tengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                             dense_units=256, skip_layer=4,
                             white_background=True)
    images, rays = _batch(8, seed=9)
    batch = (torch.as_tensor(images), tuple(map(torch.as_tensor, rays)))
    state = tengine.init_train_state(torch.Generator().manual_seed(0), cfg,
                                     tengine.make_optimizer("sgd", 0.0))
    return cfg, batch, state


def _draws():
    return torch.Generator().manual_seed(3)


def test_custom_loss_callable_is_used():
    cfg, batch, state = _toy()
    opt = tengine.make_optimizer("sgd", 0.0)
    _, m_l1 = tengine.train_step(state, batch, _draws(), opt, cfg, CHUNK,
                                 loss_fn=l1)
    _, m_mse = tengine.train_step(state, batch, _draws(), opt, cfg, CHUNK)
    # L1 of a sub-unit error is larger than its square: the callable was
    # used, on the kernel branch (T5/T6), against the fused T3 path's MSE.
    assert float(m_l1["coarse_loss"]) > float(m_mse["coarse_loss"])
    assert float(m_l1["coarse_loss"]) != pytest.approx(
        float(m_mse["coarse_loss"]))
    e_l1 = tengine.eval_step(state, batch, _draws(), cfg, CHUNK,
                             loss_fn=l1)
    e_mse = tengine.eval_step(state, batch, _draws(), cfg, CHUNK)
    assert float(e_l1["coarse_loss"]) != pytest.approx(
        float(e_mse["coarse_loss"]))
    # An MSE written as a callable takes the autograd path and agrees with
    # the fused one.
    _, m_call = tengine.train_step(
        state, batch, _draws(), opt, cfg, CHUNK,
        loss_fn=lambda y, p: ((p - y) ** 2).mean())
    for k in ("coarse_loss", "fine_loss"):
        assert float(m_call[k]) == pytest.approx(float(m_mse[k]), rel=1e-2)


def test_nerf_compile_takes_a_callable_and_rejects_unknown_loss_strings():
    nerf = NeRF(n_coarse=8, n_fine=8, n_layers=2)
    with pytest.raises(ValueError, match="unsupported loss"):
        nerf.compile(loss="huber", image_height=4, image_width=8,
                     ray_chunks=16, device="cpu")
    for loss, want in ((None, tengine.mse_loss), ("mse", tengine.mse_loss),
                       (l1, l1)):
        nerf.compile(loss=loss, image_height=4, image_width=8,
                     ray_chunks=16, device="cpu")
        assert nerf.loss_fn is want
    images, rays = _batch(8, seed=10)
    before = nerf.train_step((images, rays))
    after = nerf.train_step((images, rays))
    assert after["fine_loss"] != before["fine_loss"]
    assert all(np.isfinite(v) for v in after.values())
    # evaluate applies the compiled loss too.
    val_l1 = nerf.evaluate([(images, rays)])
    nerf.compile(loss="mse", image_height=4, image_width=8, ray_chunks=16,
                 device="cpu")
    val_mse = nerf.evaluate([(images, rays)])
    assert val_l1["fine_loss"] > val_mse["fine_loss"]
    assert val_l1["fine_psnr"] == val_mse["fine_psnr"]
