"""The port's MLP, packing and encoding coefficients against the JAX package.

Parameters are drawn by the JAX package and carried across with
``params_from_jax``, so both packages compute the same function.
Tolerances: float32 forward atol 1e-5; packing and encoding coefficients
exact (both are copies and exact float32 products).
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.kernels import ray_march as jrm
from keras_nerf_tpu.models import mlp as jmlp
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import mlp as tmlp
from keras_nerf_tpu_torch.utils.convert import params_from_jax, params_to_jax

# (n_layers, skip_layer): the reference 8 x 256 shape (skip after layer 4),
# a small one whose last trunk layer is a skip (heads read the encoding),
# and one with post-skip layers in the trunk and a skipping last layer.
SHAPES = [(8, 4), (3, 2), (3, 1)]


def _jax_params(n_layers, skip_layer, seed=0):
    cfg = jmlp.MLPConfig(n_layers=n_layers, dense_units=256,
                         skip_layer=skip_layer)
    params = jmlp.init_mlp(jax.random.PRNGKey(seed), cfg, 63, 27)
    return cfg, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("n_layers,skip_layer", SHAPES)
def test_apply_mlp_matches_jax(n_layers, skip_layer):
    cfg_j, params = _jax_params(n_layers, skip_layer)
    rng = np.random.default_rng(0)
    enc_x = rng.normal(size=(5, 7, 63)).astype(np.float32)
    enc_d = rng.normal(size=(5, 7, 27)).astype(np.float32)
    rgb_j, sig_j = jmlp.apply_mlp(params, jnp.asarray(enc_x),
                                  jnp.asarray(enc_d), cfg_j)
    cfg_t = tmlp.MLPConfig(n_layers=n_layers, dense_units=256,
                           skip_layer=skip_layer)
    rgb_t, sig_t = tmlp.apply_mlp(params_from_jax(params, "cpu"),
                                  torch.as_tensor(enc_x),
                                  torch.as_tensor(enc_d), cfg_t)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=1e-5)


@pytest.mark.parametrize("n_layers,skip_layer", SHAPES)
def test_pack_mlp_params_matches_jax_array_for_array(n_layers, skip_layer):
    cfg_j, params = _jax_params(n_layers, skip_layer, seed=1)
    want = jrm.pack_mlp_params(params, cfg_j, 10, 4)
    cfg_t = tmlp.MLPConfig(n_layers=n_layers, dense_units=256,
                           skip_layer=skip_layer)
    got = trm.pack_mlp_params(params_from_jax(params, "cpu"), cfg_t, 10, 4)
    assert set(got) == set(want)
    for key in want:
        w_list = want[key] if isinstance(want[key], list) else [want[key]]
        g_list = got[key] if isinstance(got[key], list) else [got[key]]
        assert len(g_list) == len(w_list), key
        for i, (g, w) in enumerate(zip(g_list, w_list)):
            if w is None:
                assert g is None, (key, i)
                continue
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape, (key, i)
            assert str(g.dtype).endswith(str(w.dtype)), (key, i, g.dtype)
            np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                          w.astype(np.float32),
                                          err_msg=f"{key}[{i}]")


def test_pack_rejects_widths_outside_the_envelope():
    cfg = tmlp.MLPConfig(dense_units=128)
    params = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg, 63, 27)
    assert not trm.kernel_supported(cfg, 10, 4)
    with pytest.raises(ValueError):
        trm.pack_mlp_params(params, cfg, 10, 4)


def test_ray_encoding_coeffs_match_jax():
    rng = np.random.default_rng(2)
    o = rng.normal(size=(9, 3)).astype(np.float32) * 4
    d = rng.normal(size=(9, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    base_j, slope_j, masks_j = jrm.ray_encoding_coeffs(
        jnp.asarray(o), jnp.asarray(d), 10, 4)
    base_t, slope_t, masks_t = trm.ray_encoding_coeffs(
        torch.as_tensor(o), torch.as_tensor(d), 10, 4)
    np.testing.assert_allclose(base_t.numpy(), np.asarray(base_j), atol=1e-5)
    np.testing.assert_allclose(slope_t.numpy(), np.asarray(slope_j),
                               atol=1e-5)
    np.testing.assert_array_equal(masks_t.numpy(), np.asarray(masks_j))


def test_init_mlp_has_reference_layout():
    cfg_j, params_j = _jax_params(8, 4)
    cfg_t = tmlp.MLPConfig()
    params_t = tmlp.init_mlp(torch.Generator().manual_seed(0), cfg_t, 63, 27)
    shapes_j = jax.tree.map(lambda a: a.shape, params_j)
    shapes_t = jax.tree.map(lambda a: tuple(a.shape),
                            params_to_jax(params_t))
    assert shapes_t == shapes_j
    # Glorot-uniform bounds and zero biases, as the JAX initializer.
    k0 = params_t["trunk"][0]["kernel"]
    limit = np.sqrt(6.0 / (63 + 256))
    assert float(k0.abs().max()) <= limit
    assert float(k0.std()) > 0.5 * limit / np.sqrt(3)
    assert float(params_t["rgb"]["bias"].abs().max()) == 0.0


def test_params_round_trip():
    _, params = _jax_params(3, 2)
    back = params_to_jax(params_from_jax(params, "cpu"))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_fwd_flop_per_point_counts_the_unpadded_mlp():
    cfg = tmlp.MLPConfig()
    assert trm.fwd_flop_per_point(cfg) == 1_186_816
    assert trm.fwd_flop_per_point(cfg, sigma_only=True) == 982_528
