"""The kernels' plain versions against the JAX package's TPU kernel.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX side runs ``fused_train_chunk(with_grad=False)`` in Pallas interpret
mode, as ``tests/models/test_pallas_kernel.py`` does. Same parameters, rays,
coarse depths, weights and sorted draws, made with numpy. Budgets are those
of the JAX package's own fused-sampling check
(`test_pallas_kernel.py:431-434`): image atol 2e-3, depth atol 5e-3,
weights atol 2e-3; the sampling chain alone atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.kernels import pack_mlp_params as jax_pack
from keras_nerf_tpu.kernels.ray_march import fused_train_chunk
from keras_nerf_tpu.models import mlp as jmlp
from keras_nerf_tpu.ops import sampling as jsamp
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models.mlp import MLPConfig
from keras_nerf_tpu_torch.utils.convert import params_from_jax

IMAGE_ATOL, DEPTH_ATOL, WEIGHTS_ATOL = 2e-3, 5e-3, 2e-3
SAMPLING_ATOL = 1e-4
R = 16
# 3 x 256 with a skip after every layer: a post-skip trunk layer
# (trunk_enc_w) and heads that read the encoding (w_sf_enc) both run.
N_LAYERS, SKIP = 3, 1


@pytest.fixture(scope="module")
def model():
    cfg_j = jmlp.MLPConfig(n_layers=N_LAYERS, dense_units=256,
                           skip_layer=SKIP)
    params = jax.tree.map(np.asarray, jmlp.init_mlp(
        jax.random.PRNGKey(2), cfg_j, 63, 27))
    cfg_t = MLPConfig(n_layers=N_LAYERS, dense_units=256, skip_layer=SKIP)
    packed_t = trm.pack_mlp_params(params_from_jax(params, "cpu"), cfg_t,
                                   10, 4)
    return cfg_j, jax_pack(params, cfg_j, 10, 4), packed_t


def _inputs(s_c, n_fine, seed=0):
    rng = np.random.default_rng(seed)
    o = np.zeros((R, 3), np.float32)
    o[:, 2] = 4.0
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cp = np.sort(rng.uniform(2, 6, (R, s_c)).astype(np.float32), -1)
    wc = (rng.uniform(size=(R, s_c)) ** 3).astype(np.float32)
    u = np.sort(rng.uniform(size=(R, n_fine)).astype(np.float32), -1)
    return o, d, cp, wc, u


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("s_c", [24, 64])
def test_sigma_only_coarse_pass_matches_tpu_kernel(model, s_c):
    cfg_j, packed_j, packed_t = model
    o, d, cp, _, _ = _inputs(s_c, 16)
    _, depth_j, w_j = fused_train_chunk(
        packed_j, o, d, cp, None, cfg_j, with_grad=False, emit_weights=True,
        sigma_only=True, interpret=True)
    image_t, depth_t, w_t = trm.fused_render_chunk(
        packed_t, *_t(o, d, cp), sigma_only=True)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j),
                               atol=WEIGHTS_ATOL)
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j),
                               atol=DEPTH_ATOL)
    assert float(image_t.abs().max()) == 0.0
    assert float(w_t.max()) > 1e-3   # the pass sees real density


@pytest.mark.parametrize("emit_weights", [True, False])
@pytest.mark.parametrize("white_bg", [True, False])
@pytest.mark.parametrize("s_c,n_fine", [(24, 16), (64, 128)])
def test_fine_pass_with_sampling_matches_tpu_kernel(model, s_c, n_fine,
                                                    white_bg, emit_weights):
    cfg_j, packed_j, packed_t = model
    o, d, cp, wc, u = _inputs(s_c, n_fine, seed=1)
    image_j, depth_j, w_j = fused_train_chunk(
        packed_j, o, d, None, None, cfg_j, white_background=white_bg,
        with_grad=False, emit_weights=emit_weights,
        sample_inputs=(cp, wc, u), interpret=True)
    image_t, depth_t, w_t = trm.fused_render_chunk(
        packed_t, *_t(o, d), None, white_background=white_bg,
        emit_weights=emit_weights, sample_inputs=_t(cp, wc, u))
    np.testing.assert_allclose(image_t.numpy(), np.asarray(image_j),
                               atol=IMAGE_ATOL)
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j),
                               atol=DEPTH_ATOL)
    if emit_weights:
        assert w_t.shape == (R, s_c + n_fine)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j),
                                   atol=WEIGHTS_ATOL)
    else:
        assert w_t is None and w_j is None


@pytest.mark.parametrize("s_c,n_fine", [(24, 16), (64, 128)])
def test_sample_merge_plain_matches_jax_sampling_chain(s_c, n_fine):
    _, _, cp, wc, u = _inputs(s_c, n_fine, seed=2)
    want = np.asarray(jsamp.merge_sorted(
        jnp.asarray(cp),
        jsamp.invert_cdf(jnp.asarray(u), jsamp.midpoints(jnp.asarray(cp)),
                         jnp.asarray(wc))))
    got = trm.sample_merge(*_t(cp, wc, u, cp)).numpy()
    np.testing.assert_allclose(got, want, atol=SAMPLING_ATOL)
    assert np.all(np.diff(got, axis=-1) >= 0)


def test_mlp_plain_matches_tpu_kernel_on_given_depths(model):
    """Full colour pass over explicit depths (no sampling prologue)."""
    cfg_j, packed_j, packed_t = model
    o, d, cp, _, _ = _inputs(32, 16, seed=3)
    image_j, depth_j, w_j = fused_train_chunk(
        packed_j, o, d, cp, None, cfg_j, white_background=True,
        with_grad=False, emit_weights=True, interpret=True)
    image_t, depth_t, w_t = trm.fused_render_chunk(
        packed_t, *_t(o, d, cp), white_background=True)
    np.testing.assert_allclose(image_t.numpy(), np.asarray(image_j),
                               atol=IMAGE_ATOL)
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j),
                               atol=DEPTH_ATOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j),
                               atol=WEIGHTS_ATOL)


def test_encode_points_matches_the_tpu_kernels_encoding():
    """The plain encoding reproduces the TPU kernel's in-kernel encoding
    (range reduction + polynomial sin) to the bf16 rounding it feeds."""
    from keras_nerf_tpu.kernels.ray_march import ray_encoding_coeffs

    o, d, cp, _, _ = _inputs(8, 4, seed=4)
    base, slope, masks = trm.ray_encoding_coeffs(*_t(o, d), 10, 4)
    enc = trm.encode_points(base, slope, torch.as_tensor(cp), masks)
    # The same encoding from the exact sin/cos of the same arguments.
    b_j, s_j, m_j = ray_encoding_coeffs(jnp.asarray(o), jnp.asarray(d), 10, 4)
    rep = np.asarray(b_j)[:, None, :] + cp[..., None] * np.asarray(s_j)[:, None]
    m = np.asarray(m_j)
    exact = m[0] * rep + m[1] * np.sin(rep) + m[2] * np.cos(rep)
    np.testing.assert_allclose(enc.to(torch.float32).numpy(), exact,
                               atol=8e-3, rtol=8e-3)
    # The polynomial itself: 1.4e-5 max error on [-pi, pi].
    x = torch.linspace(-np.pi, np.pi, 10001)
    assert float((trm.sin_poly(x) - torch.sin(x)).abs().max()) < 2e-5


def test_quadrature_plain_is_exact_transmittance():
    """exp(-exclusive cumsum) weights against a float64 product form."""
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(2, 6, (4, 20)), -1)
    sigma = rng.uniform(0, 5, (4, 20))
    rgbs = np.concatenate([rng.uniform(size=(4, 20, 3)), sigma[..., None]],
                          -1)
    image, depth, w = trm.ray_march_quadrature(
        torch.as_tensor(rgbs, dtype=torch.float32),
        torch.as_tensor(t, dtype=torch.float32), white_background=True)
    delta = np.concatenate([np.diff(t, axis=-1), np.full((4, 1), 1e-10)], -1)
    alpha = 1 - np.exp(-sigma * delta)
    trans = np.concatenate([np.ones((4, 1)),
                            np.cumprod(1 - alpha, -1)[:, :-1]], -1)
    w_ref = alpha * trans
    np.testing.assert_allclose(w.numpy(), w_ref, atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), (w_ref * t).sum(-1), atol=1e-4)
    img_ref = np.clip((w_ref[..., None] * rgbs[..., :3]).sum(1)
                      + (1 - w_ref.sum(-1))[:, None], 0, 1)
    np.testing.assert_allclose(image.numpy(), img_ref, atol=1e-5)
