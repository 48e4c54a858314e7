"""The last exports of the JAX package's ``ops`` and ``models`` in the port,
against the JAX package on the CPU: ``sample_pdf`` (unsorted uniform
draws through the inverse CDF) fed JAX's own uniforms, at the sampling
chain's budget of ``tests/test_torch_ray_march.py`` (atol 1e-4);
``batched_searchsorted_right`` bit for bit, ties included; and
``param_count`` equal at 8 x 256 and 3 x 64.

On rays whose CDF is flat over most bins (no mass, or all of it in one
bin) the two packages' CDFs, summed in other orders, lie a few ulps apart,
and a bin holding a 1e-5 share multiplies that by 1e5: ROADMAP C13. There
``sample_pdf``'s inversion is held to JAX's bit for bit on JAX's own CDF,
and its CDF to JAX's within ``CDF_BUDGET``, as C13's test holds
``sample_merge``.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.models import mlp as jmlp
from keras_nerf_tpu.ops import batched_searchsorted_right as jax_search
from keras_nerf_tpu.ops import sample_pdf as jax_sample_pdf
from keras_nerf_tpu.ops.sampling import invert_cdf as jax_invert_cdf
from keras_nerf_tpu_torch import models as tmodels
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.ops import batched_searchsorted_right, sample_pdf
from keras_nerf_tpu_torch.ops.sampling import invert_cdf_of
from keras_nerf_tpu_torch.utils.convert import params_from_jax

from tests.test_torch_ray_march import CDF_BUDGET, SAMPLING_ATOL


def _bins(seed, rays=64, s=63, flat=False):
    """Bin midpoints ``[rays, s]`` and weights ``[rays, s + 1]`` (the
    coarse pass's ``u^3`` weights); with ``flat``, rays of no mass and
    rays with all of it in one bin."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(2, 6, (rays, s + 1)), -1).astype(np.float32)
    mids = (0.5 * (t[:, 1:] + t[:, :-1])).astype(np.float32)
    w = (rng.uniform(size=(rays, s + 1)) ** 3).astype(np.float32)
    if flat:
        w[::2] = 0.0
        w[1::2, :] = 0.0
        w[1::2, 5] = 1.0
    return mids, w


def _sample_pdf_on(u, mids, w, monkeypatch):
    """The port's ``sample_pdf`` with its ``torch.rand`` draw replaced by
    the uniforms ``u``."""
    gen = torch.Generator().manual_seed(0)

    def given(size, *, generator, dtype, device):
        assert generator is gen and tuple(size) == u.shape
        return torch.tensor(u, dtype=dtype, device=device)

    with monkeypatch.context() as m:
        m.setattr(torch, "rand", given)
        return sample_pdf(gen, torch.as_tensor(mids), torch.as_tensor(w),
                          u.shape[-1]).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_pdf_with_jax_uniforms_matches_jax(seed, monkeypatch):
    """Fed the uniforms of JAX's key (``jax.random.uniform``, as JAX's
    ``sample_pdf`` draws them): JAX's ``sample_pdf`` within
    ``SAMPLING_ATOL``, in its unsorted order."""
    mids, w = _bins(seed)
    n = 128
    key = jax.random.PRNGKey(100 + seed)
    want = np.asarray(jax_sample_pdf(key, jnp.asarray(mids), jnp.asarray(w),
                                     n))
    u = np.array(jax.random.uniform(key, (mids.shape[0], n)))
    got = _sample_pdf_on(u, mids, w, monkeypatch)
    err = float(np.abs(got - want).max())
    print(f"\nsample_pdf against JAX (seed {seed}): max abs error {err:.3e} "
          f"(budget {SAMPLING_ATOL})")
    assert got.shape == want.shape == (mids.shape[0], n)
    assert err <= SAMPLING_ATOL
    assert not np.all(np.diff(got, axis=-1) >= 0)   # unsorted draws
    # Its own draws: finite depths inside the bins' span.
    own = sample_pdf(torch.Generator().manual_seed(seed),
                     torch.as_tensor(mids), torch.as_tensor(w), n)
    assert own.shape == (mids.shape[0], n) and bool(torch.isfinite(own).all())
    assert float(own.min()) >= mids.min() and float(own.max()) <= mids.max()


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_pdf_on_flat_cdfs_is_jax_on_jax_cdf(seed, monkeypatch):
    """C13's form on flat CDFs, JAX's uniforms fed: ``sample_pdf`` is the
    inversion of its own CDF bit for bit; that inversion on JAX's CDF (the
    expression of `keras_nerf_tpu/ops/sampling.py:119-121`) is JAX's
    ``invert_cdf`` bit for bit; and its CDF lies within ``CDF_BUDGET`` of
    JAX's."""
    mids, w = _bins(seed, flat=True)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(7 + seed),
                                    (mids.shape[0], 128)))
    want = np.asarray(jax_invert_cdf(jnp.asarray(u), jnp.asarray(mids),
                                     jnp.asarray(w)))
    wj = jnp.asarray(w) + 1e-5
    jax_cdf = np.array(jnp.cumsum(wj / jnp.sum(wj, -1, keepdims=True),
                                  -1))
    wt = torch.as_tensor(w) + 1e-5
    port_cdf = torch.cumsum(wt / wt.sum(-1, keepdim=True), -1).numpy()

    def invert(cdf):
        return invert_cdf_of(*(torch.as_tensor(x) for x in (u, mids, cdf))
                             ).numpy()

    got = _sample_pdf_on(u, mids, w, monkeypatch)
    np.testing.assert_array_equal(got, invert(port_cdf))
    pinned = invert(jax_cdf)
    np.testing.assert_array_equal(pinned, want)
    cdf_err = float(np.abs(port_cdf - jax_cdf).max())
    print(f"\nsample_pdf on flat CDFs (seed {seed}): on JAX's CDF max abs "
          f"{np.abs(pinned - want).max():.3e} (budget 0); CDF gap "
          f"{cdf_err:.3e} (budget {CDF_BUDGET:.3e}); on its own CDF max abs "
          f"{np.abs(got - want).max():.3e} (C13's amplification)")
    assert cdf_err <= CDF_BUDGET


def test_batched_searchsorted_right_equals_jax():
    rng = np.random.default_rng(3)
    cdf = np.sort(rng.uniform(size=(5, 7, 33)), -1).astype(np.float32)
    cdf[..., :4] = 0.0
    u = rng.uniform(size=(5, 7, 40)).astype(np.float32)
    u[..., :10] = cdf[..., 3:13]     # ties with CDF entries
    u[..., 10] = 0.0
    u[..., 11] = 1.0
    want = np.asarray(jax_search(jnp.asarray(cdf), jnp.asarray(u)))
    got = batched_searchsorted_right(torch.as_tensor(cdf),
                                     torch.as_tensor(u))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.stack([np.searchsorted(c, v, side="right")
                               for c, v in zip(cdf.reshape(-1, 33),
                                               u.reshape(-1, 40))]
                              ).reshape(want.shape))


@pytest.mark.parametrize("shape", [(8, 256, 4), (3, 64, 2)])
def test_param_count_equals_jax(shape):
    n_layers, units, skip = shape
    jcfg = jengine.NeRFConfig(n_layers=n_layers, dense_units=units,
                              skip_layer=skip)
    coarse, _ = jengine.init_params(jax.random.PRNGKey(0), jcfg)
    want = jmlp.param_count(coarse)
    assert tmodels.param_count(params_from_jax(
        jax.tree.map(np.asarray, coarse), "cpu")) == want
    tcfg = tengine.NeRFConfig(**jcfg.to_model_config())
    own, _ = tengine.init_params(torch.Generator().manual_seed(0), tcfg,
                                 "cpu")
    assert tmodels.param_count(own) == want
    print(f"\nparam_count {n_layers} x {units}: {want}")
