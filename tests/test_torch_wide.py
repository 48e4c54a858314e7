"""The port at widths above 512 against the JAX package, on the CPU.

JAX's kernel envelope takes any ``dense_units`` whose half is a multiple of
128 and any number of layers (`keras_nerf_tpu/kernels/ray_march.py:98-104`),
and so does the port's: its resident kernels take u = 256, 512 and 768 (C10
repaired 768) up to 16 layers, the int8 one up to 1280, and the streamed
kernels every other width and depth (ROADMAP C12). Here the plain versions
that the kernels are held against on the card meet JAX's kernels
(interpret mode) at those shapes: 2 layers of 768 with skip 1 (the last
layer reads the encoding too), 3 of 1024 with skip 1, 20 of 256 with skip
4, T4 up to 2048; a few points each. Budgets as the 8 x 256 tests of the
same functions:

* T3 whole (``fused_train_chunk``: forward, quadrature, backward, dW):
  image 2e-3, depth 5e-3, weights 2e-3, each gradient leaf relative norm
  0.03 and relative max 0.12 (`tests/test_torch_train.py`);
* T5 (``apply_mlp``) 2e-3 absolute, T6 (``fused_point_forward``'s
  gradients) relative norm 0.03 and max 0.05
  (`tests/test_torch_custom_loss.py`);
* T4 (``forward_core_int8`` on JAX's own int8 weights and one float32
  encoding) 1e-6 absolute (`tests/test_torch_quantize.py`).

``-s`` prints each reading beside its budget.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.kernels import quantize as jq
from keras_nerf_tpu.kernels import ray_march as jrm
from keras_nerf_tpu.models import mlp as jmlp
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models.mlp import MLPConfig
from keras_nerf_tpu_torch.utils.convert import (
    params_from_jax,
    params_to_jax,
    quantized_from_jax,
)

IMAGE_ATOL, DEPTH_ATOL, WEIGHTS_ATOL = 2e-3, 5e-3, 2e-3
GRAD_REL_NORM, GRAD_REL_MAX = 0.03, 0.12
APPLY_ATOL, FPF_REL_NORM, FPF_REL_MAX = 2e-3, 0.03, 0.05
FORWARD_ATOL = 1e-6
N_LAYERS, SKIP, R = 2, 1, 8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12),
            np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _assert_trees_close(got, want, rel_norm, rel_max, label, spread=None):
    """Each leaf of ``got`` within ``rel_norm`` / ``rel_max`` of ``want``'s;
    with ``spread`` (leaf path -> relative norm and max of JAX's own two
    orders at that leaf), within the larger of the budget and that."""
    worst = (0.0, 0.0)
    for (path, b), a in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        assert np.shape(a) == np.shape(b)
        key = jax.tree_util.keystr(path)
        rn, rm = _rel(a, b)
        sn, sm = (0.0, 0.0) if spread is None else spread[key]
        assert rn <= max(rel_norm, sn) and rm <= max(rel_max, sm), (
            label, key, rn, rm, sn, sm)
        worst = (max(worst[0], rn), max(worst[1], rm))
    print(f"\n{label}: worst leaf relative norm {worst[0]:.2e} (budget "
          f"{rel_norm}), relative max {worst[1]:.2e} (budget {rel_max})")


def _model(units, seed=2, n_layers=N_LAYERS, skip=SKIP):
    """JAX's weights of an ``n_layers``-layer MLP of width ``units`` (sigma
    bias +0.5, so that every ray has density) and both packages'
    configs."""
    cfg_j = jmlp.MLPConfig(n_layers=n_layers, dense_units=units,
                           skip_layer=skip)
    params = jax.tree.map(np.asarray, jmlp.init_mlp(
        jax.random.PRNGKey(seed), cfg_j, 63, 27))
    params["sigma"]["bias"] = params["sigma"]["bias"] + 0.5
    cfg_t = MLPConfig(n_layers=n_layers, dense_units=units, skip_layer=skip)
    return cfg_j, cfg_t, params


def _rays(s, seed=0, rays=R):
    rng = np.random.default_rng(seed)
    o = np.zeros((rays, 3), np.float32)
    o[:, 2] = 4.0
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2, 6, (rays, s)).astype(np.float32), -1)
    return o, d, t, rng


@pytest.mark.parametrize("mode", ["coarse", "fine"])
def test_fused_train_chunk_matches_tpu_kernel_at_768_units(mode):
    """T3 whole at u = 768, the width C10 opened to the card's kernels:
    image, depth, weights and every packed gradient."""
    _check_fused_train_chunk(mode, 768, N_LAYERS, SKIP)


# ROADMAP C12's streamed route: wider than the resident tiles, deeper than
# their 16 layers of tensor maps (20 layers of 256, skip 4: 4 skip layers);
# (units, layers, skip, rays). A leaf of a deep model's gradient over 8
# rays is a sum over 128 points: on those the fine pass of a 16- or
# 20-layer model misses the per-leaf relative-norm budget against JAX's
# kernel, and JAX's kernel and its own XLA chain miss it against each other
# by more (test_fused_train_chunk_deep_at_8_rays_within_jax_spread holds
# that case and prints both). At 32 rays the budgets hold the 20-layer pass
# as they stand.
_STREAMED = {"1024x3_skip1": (1024, 3, 1, R), "256x20_skip4": (256, 20, 4, 32)}


@pytest.mark.parametrize("shape", sorted(_STREAMED))
@pytest.mark.parametrize("mode", ["coarse", "fine"])
def test_fused_train_chunk_matches_tpu_kernel_streamed(mode, shape):
    """T3 whole at the streamed route's shapes: image, depth, weights and
    every packed gradient."""
    _check_fused_train_chunk(mode, *_STREAMED[shape])


@pytest.mark.parametrize("n_layers", [16, 20])
def test_fused_train_chunk_deep_at_8_rays_within_jax_spread(n_layers):
    """T3's fine pass of ``n_layers`` x 256 (skip 4) on 8 rays, where the
    per-leaf relative-norm budget lies below what bf16 leaves of a deep
    model's gradient over 128 points can hold: every leaf within the budget
    or within the distance of JAX's own two bf16 orders at that leaf (its
    kernel, interpret mode, against XLA's autodiff of the same loss on the
    same points), whichever is larger. Image and depth at their budgets.
    ``-s`` prints the readings, and both against float32 autodiff."""
    _check_fused_train_chunk("fine", 256, n_layers, 4, R, with_spread=True)


def _xla_grads(params, units, n_layers, skip, o, d, pts, tgt, dtype):
    """JAX's XLA autodiff of the chunk's MSE, on the points ``pts``."""
    from keras_nerf_tpu.models import engine

    cfg = engine.NeRFConfig(
        n_coarse=pts.shape[1], n_fine=0, pos_emb_xyz=10, pos_emb_dir=4,
        n_layers=n_layers, dense_units=units, skip_layer=skip,
        white_background=True, compute_dtype=dtype)

    def loss(prm):
        out, _ = engine.render_chunk(prm, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(pts), jax.random.PRNGKey(0),
                                     cfg)
        return jnp.mean(jnp.square(out.image - tgt))

    return jax.jit(jax.grad(loss))(params)


def _tree_rel(got, want):
    return {jax.tree_util.keystr(path): _rel(a, b) for (path, b), a in zip(
        jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got))}


def _check_fused_train_chunk(mode, units, n_layers, skip, rays=R,
                             with_spread=False):
    cfg_j, cfg_t, params = _model(units, n_layers=n_layers, skip=skip)
    packed_j = jrm.pack_mlp_params(params, cfg_j, 10, 4)
    packed_t = trm.pack_mlp_params(params_from_jax(params, "cpu"), cfg_t, 10,
                                   4)
    o, d, cp, rng = _rays(8, rays=rays)
    wc = (rng.uniform(size=cp.shape) ** 3).astype(np.float32)
    u = np.sort(rng.uniform(size=(rays, 8)).astype(np.float32), -1)
    tgt = rng.uniform(size=(rays, 3)).astype(np.float32)
    tt = [torch.as_tensor(x) for x in (o, d, cp, wc, u, tgt)]
    kw_j = dict(white_background=True, with_grad=True, interpret=True)
    if mode == "coarse":
        out_j = jrm.fused_train_chunk(packed_j, o, d, cp, tgt, cfg_j, **kw_j)
        out_t = trm.fused_train_chunk(packed_t, tt[0], tt[1], tt[2], tt[5],
                                      white_background=True)
        np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]),
                                   atol=WEIGHTS_ATOL)
    else:
        out_j = jrm.fused_train_chunk(packed_j, o, d, None, tgt, cfg_j,
                                      emit_weights=False,
                                      sample_inputs=(cp, wc, u), **kw_j)
        out_t = trm.fused_train_chunk(packed_t, tt[0], tt[1], None, tt[5],
                                      emit_weights=False,
                                      sample_inputs=tt[2:5],
                                      white_background=True)
    for i, atol in ((0, IMAGE_ATOL), (1, DEPTH_ATOL)):
        err = float(np.abs(out_t[i].numpy() - np.asarray(out_j[i])).max())
        print(f"\n{n_layers}x{units} {mode} "
              f"{'image' if i == 0 else 'depth'}: max abs {err:.2e} (budget "
              f"{atol})")
        assert err <= atol
    got = params_to_jax(trm.unpack_grads(out_t[3], cfg_t, 10, 4))
    want = jrm.unpack_grads(out_j[3], cfg_j, 10, 4)
    label = f"fused_train_chunk {n_layers}x{units} skip {skip} {mode}"
    spread = None
    if with_spread:
        pts = trm.sample_merge.plain(*tt[2:5], tt[2]).numpy()
        xla = {dt: _xla_grads(params, units, n_layers, skip, o, d, pts, tgt,
                              dt) for dt in ("bfloat16", "float32")}
        spread = _tree_rel(want, xla["bfloat16"])
        for name, a, b in (("port vs JAX's kernel", got, want),
                           ("JAX's kernel vs XLA bf16", want,
                            xla["bfloat16"]),
                           ("port vs XLA float32", got, xla["float32"]),
                           ("JAX's kernel vs XLA float32", want,
                            xla["float32"])):
            rel = _tree_rel(a, b).values()
            print(f"\n{label} on {rays} rays, {name}: worst leaf relative "
                  f"norm {max(r[0] for r in rel):.3e}, relative max "
                  f"{max(r[1] for r in rel):.3e}")
    _assert_trees_close(got, want, GRAD_REL_NORM, GRAD_REL_MAX, label,
                        spread)


def test_apply_mlp_and_its_backward_match_jax_at_768_units():
    """T5 (``apply_mlp``, its stash mode) and T6 (``fused_point_forward``'s
    gradients through ``fused_mlp_backward``) at u = 768."""
    _check_apply_mlp_and_backward(768, N_LAYERS, SKIP, R)


@pytest.mark.parametrize("shape", sorted(_STREAMED))
def test_apply_mlp_and_its_backward_match_jax_streamed(shape):
    """T5 and T6 at the streamed route's shapes."""
    _check_apply_mlp_and_backward(*_STREAMED[shape])


def _check_apply_mlp_and_backward(units, n_layers, skip, rays):
    cfg_j, cfg_t, params = _model(units, seed=0, n_layers=n_layers,
                                  skip=skip)
    o, d, t, _ = _rays(6, seed=3, rays=rays)
    pos = (o[:, None] + d[:, None] * t[..., None]).reshape(-1, 3)
    dirs = np.repeat(d, t.shape[1], axis=0)
    enc_j = jrm.encode_block128(jnp.asarray(pos), jnp.asarray(dirs), 10, 4)
    want = np.asarray(jrm.fused_apply_mlp(
        jrm.pack_mlp_params(params, cfg_j, 10, 4), enc_j, cfg_j,
        interpret=True))[:, :4]
    enc = torch.as_tensor(np.array(enc_j.astype(jnp.float32))).to(
        torch.bfloat16)
    packed = trm.pack_mlp_params(params_from_jax(params, "cpu"), cfg_t, 10, 4)
    got = trm.apply_mlp(packed, enc)
    err = float(np.abs(got.numpy() - want).max())
    print(f"\napply_mlp {n_layers}x{units}: max abs {err:.2e} (budget "
          f"{APPLY_ATOL})")
    assert err <= APPLY_ATOL
    stash = trm.alloc_stash(enc.shape[0], units, n_layers, enc.device,
                            enc=enc)
    assert torch.equal(trm.apply_mlp(packed, enc, stash=stash), got)

    def loss(rgb, sigma, xp):
        return xp.sum(rgb * xp.arange(3)) + 0.5 * xp.sum(sigma ** 2)

    def jax_loss(prm):
        rgb, sg = jrm.fused_point_forward(prm, jnp.asarray(pos),
                                          jnp.asarray(dirs), cfg_j, 10, 4, 64,
                                          True)
        return loss(rgb, sg, jnp)

    want_g = jax.grad(jax_loss)(params)
    leaves = jax.tree.map(lambda x: x.requires_grad_(True),
                          params_from_jax(params, "cpu"))
    rgb, sg = trm.fused_point_forward(leaves, torch.as_tensor(pos),
                                      torch.as_tensor(dirs), cfg_t, 10, 4)
    loss(rgb, sg, torch).backward()
    got_g = params_to_jax(jax.tree.map(lambda x: x.grad, leaves))
    _assert_trees_close(got_g, want_g, FPF_REL_NORM, FPF_REL_MAX,
                        f"fused_point_forward {n_layers}x{units} skip {skip}")


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("units", [768, 1024, 1536, 2048])
def test_ray_march_mlp_int8_plain_matches_forward_core_int8_wide(units,
                                                                 sigma_only):
    """T4's plain version against JAX's forward_core_int8 on JAX's own
    calibration and int8 weights of a 2 x ``units`` MLP (skip 1: the last
    layer's encoding product and its own quantization site), on one float32
    encoding."""
    cfg_j, _, params = _model(units, seed=1)
    o, d, t, _ = _rays(8, seed=5)
    packed = jrm.pack_mlp_params(params, cfg_j, 10, 4)
    pos = (o[:, None] + d[:, None] * t[..., None]).reshape(-1, 3)
    enc_b = jrm.encode_block128(jnp.asarray(pos),
                                jnp.asarray(np.repeat(d, 8, axis=0)), 10, 4)
    last_skip = (N_LAYERS - 1) in set(cfg_j.skip_indices())
    q_j = jq.quantize_packed(
        packed, jq.collect_act_amax(packed, enc_b, cfg_j, last_skip), cfg_j,
        last_skip)
    q_j = jax.tree.map(np.array, q_j)
    q = quantized_from_jax(q_j, "cpu")
    assert q["w_sig_enc"] is not None
    base, slope, masks = trm.ray_encoding_coeffs(
        torch.as_tensor(o), torch.as_tensor(d), 10, 4)
    tt = torch.as_tensor(t)
    enc = trm.encode_points_f32(base, slope, tt, masks).reshape(-1, 128)
    rgb_pre, sig_pre, _ = jq.forward_core_int8(
        cfg_j, last_skip, jnp.asarray(enc.numpy()), q_j,
        sigma_only=sigma_only)
    sigma = np.asarray(jax.nn.relu(sig_pre[:, 0]))
    got = trm.ray_march_mlp_int8(q, base, slope, tt, masks,
                                 sigma_only=sigma_only).numpy()
    want = sigma if sigma_only else np.concatenate(
        [np.asarray(jax.nn.sigmoid(rgb_pre[:, :3])), sigma[:, None]], axis=1)
    err = float(np.abs(got - want).max())
    print(f"\nray_march_mlp_int8 plain 2x{units} "
          f"{'sigma-only' if sigma_only else 'full'}: max abs {err:.2e} "
          f"(budget {FORWARD_ATOL})")
    assert err <= FORWARD_ATOL
    assert float(np.abs(sigma).max()) > 0.1
