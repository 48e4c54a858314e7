"""The port's ops against the JAX package's, in float32 on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port's functions run on CPU tensors. Tolerance: atol 1e-5 (float32 math in
both; only transcendental implementations and sum orders differ).
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.ops import encoding as jenc
from keras_nerf_tpu.ops import metrics as jmetrics
from keras_nerf_tpu.ops import rendering as jrender
from keras_nerf_tpu.ops import sampling as jsamp
from keras_nerf_tpu_torch.ops import encoding as tenc
from keras_nerf_tpu_torch.ops import metrics as tmetrics
from keras_nerf_tpu_torch.ops import rendering as trender
from keras_nerf_tpu_torch.ops import sampling as tsamp

ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("num_freqs", [0, 4, 10])
def test_positional_encoding_matches_jax(num_freqs):
    x = np.random.default_rng(0).uniform(-2, 2, (7, 5, 3)).astype(np.float32)
    want = np.asarray(jenc.positional_encoding(jnp.asarray(x), num_freqs))
    got = tenc.positional_encoding(_t(x), num_freqs).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert tenc.encoded_dim(3, num_freqs) == want.shape[-1]


@pytest.mark.parametrize("num_freqs", [1, 4, 10])
def test_block_order_and_permutation_match_jax(num_freqs):
    x = np.random.default_rng(1).normal(size=(6, 3)).astype(np.float32)
    assert tenc.block_permutation(3, num_freqs) == \
        jenc.block_permutation(3, num_freqs)
    want = np.asarray(jenc.positional_encoding_block(jnp.asarray(x),
                                                     num_freqs))
    got = tenc.positional_encoding_block(_t(x), num_freqs).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    b_j, m_j = jenc._selection_constants(3, num_freqs, "block")
    b_t, m_t = tenc._selection_constants(3, num_freqs, "block")
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_array_equal(m_t, m_j)


def test_encode_position_and_directions_matches_jax():
    rng = np.random.default_rng(2)
    o = rng.normal(size=(4, 3)).astype(np.float32)
    d = rng.normal(size=(4, 3)).astype(np.float32)
    t = np.sort(rng.uniform(2, 6, (4, 9)).astype(np.float32), -1)
    want = jenc.encode_position_and_directions(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), 10, 4)
    got = tenc.encode_position_and_directions(_t(o), _t(d), _t(t), 10, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("white_bg", [False, True])
def test_render_rays_matches_jax(white_bg):
    rng = np.random.default_rng(3)
    rgb = rng.uniform(size=(5, 16, 3)).astype(np.float32)
    sigma = rng.uniform(0, 3, (5, 16, 1)).astype(np.float32)
    t = np.sort(rng.uniform(2, 6, (5, 16)).astype(np.float32), -1)
    want = jrender.render_rays(jnp.asarray(rgb), jnp.asarray(sigma),
                               jnp.asarray(t), white_background=white_bg)
    got = trender.render_rays(_t(rgb), _t(sigma), _t(t),
                              white_background=white_bg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("s,n", [(24, 16), (64, 128)])
def test_invert_cdf_matches_jax_with_peaky_weights(s, n):
    """Weights ``u**3`` leave near-empty bins, so the ``denom < 1e-5``
    clamp fires."""
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(2, 6, (8, s)).astype(np.float32), -1)
    w = (rng.uniform(size=(8, s)) ** 3).astype(np.float32)
    u = np.sort(rng.uniform(size=(8, n)).astype(np.float32), -1)
    mids_j = jsamp.midpoints(jnp.asarray(t))
    mids_t = tsamp.midpoints(_t(t))
    np.testing.assert_allclose(mids_t.numpy(), np.asarray(mids_j), atol=ATOL)
    want = np.asarray(jsamp.invert_cdf(jnp.asarray(u), mids_j,
                                       jnp.asarray(w)))
    got = tsamp.invert_cdf(_t(u), mids_t, _t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_merge_sorted_matches_jax_with_ties():
    """Equal values in both inputs: the first array's element goes first."""
    rng = np.random.default_rng(5)
    a = np.sort(rng.integers(0, 6, (6, 9)).astype(np.float32), -1)
    b = np.sort(rng.integers(0, 6, (6, 13)).astype(np.float32), -1)
    want = np.asarray(jsamp.merge_sorted(jnp.asarray(a), jnp.asarray(b)))
    got = tsamp.merge_sorted(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(np.concatenate([a, b], -1)))


def test_merge_sorted_matches_jax_on_depths():
    rng = np.random.default_rng(6)
    a = np.sort(rng.uniform(2, 6, (4, 64)).astype(np.float32), -1)
    b = np.sort(rng.uniform(2, 6, (4, 128)).astype(np.float32), -1)
    want = np.asarray(jsamp.merge_sorted(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(tsamp.merge_sorted(_t(a), _t(b)).numpy(),
                               want, atol=ATOL)


def test_sorted_uniforms_are_sorted_uniforms():
    g = torch.Generator().manual_seed(0)
    u = tsamp.sorted_uniforms(g, (2000,), 16)
    assert u.shape == (2000, 16)
    assert bool((u[:, 1:] >= u[:, :-1]).all())
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    # Order statistic i of n uniforms has mean (i + 1) / (n + 1).
    np.testing.assert_allclose(u.mean(0).numpy(),
                               np.arange(1, 17) / 17.0, atol=0.01)
    # The JAX construction on the same exponential spacings agrees.
    e = torch.empty(3, 17).exponential_(generator=g)
    s = torch.cumsum(e, -1)
    ref = (s[:, :-1] / s[:, -1:]).numpy()
    s_j = jnp.cumsum(jnp.asarray(e.numpy()), -1)
    np.testing.assert_allclose(ref, np.asarray(s_j[:, :-1] / s_j[:, -1:]),
                               atol=ATOL)


def test_stratified_samples_match_jax_layout():
    g = torch.Generator().manual_seed(1)
    pts = tsamp.stratified_sample_points(g, (4, 5), 16, 2.0, 6.0)
    assert pts.shape == (4, 5, 16)
    assert float(pts.min()) >= 2.0 and float(pts.max()) <= 6.0
    lin = np.asarray(jnp.linspace(2.0, 6.0, 16))
    # Jitter stays inside half an interval of the JAX linspace.
    assert np.abs(pts.numpy() - lin).max() <= 0.125 + 1e-6


def test_sample_pdf_sorted_uses_generator_draws():
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(2, 6, (3, 16)).astype(np.float32), -1)
    w = rng.uniform(size=(3, 16)).astype(np.float32)
    mids = tsamp.midpoints(_t(t))
    got = tsamp.sample_pdf_sorted(torch.Generator().manual_seed(3), mids,
                                  _t(w), 32)
    u = tsamp.sorted_uniforms(torch.Generator().manual_seed(3), (3,), 32)
    want = np.asarray(jsamp.invert_cdf(jnp.asarray(u.numpy()),
                                       jnp.asarray(mids.numpy()),
                                       jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert bool((got[:, 1:] >= got[:, :-1]).all())


def test_jax_is_on_cpu():
    assert jax.devices()[0].platform == "cpu"


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 8, 12, 3)])
def test_psnr_and_ssim_match_jax(shape):
    """Per-image PSNR and SSIM (the 8 x 12 image clamps the window to 8)."""
    rng = np.random.default_rng(9)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(
        np.float32)
    for name in ("mse", "psnr", "ssim"):
        want = np.asarray(getattr(jmetrics, name)(jnp.asarray(a),
                                                  jnp.asarray(b)))
        got = getattr(tmetrics, name)(_t(a), _t(b)).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
