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
from keras_nerf_tpu_torch.ops.sampling import sequential_cdf
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
    print(f"fine pass with sampling, s_c {s_c} n {n_fine}: image max abs "
          f"{np.abs(image_t.numpy() - np.asarray(image_j)).max():.3e} "
          f"(budget {IMAGE_ATOL}), depth max abs "
          f"{np.abs(depth_t.numpy() - np.asarray(depth_j)).max():.3e} "
          f"(budget {DEPTH_ATOL})")
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
    print(f"sample_merge against JAX's invert_cdf + merge_sorted, s_c {s_c} "
          f"n {n_fine}: max abs {np.abs(got - want).max():.3e} (budget "
          f"{SAMPLING_ATOL})")
    np.testing.assert_allclose(got, want, atol=SAMPLING_ATOL)
    assert np.all(np.diff(got, axis=-1) >= 0)


def _heavy_tailed(r, s_c, seed):
    """Log-normal weights with sigma 8, half the bins zeroed: what a trained
    coarse pass gives, one surface bin holding most of a ray's mass."""
    rng = np.random.default_rng(seed)
    w = rng.lognormal(0.0, 8.0, (r, s_c)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.5] = 0.0
    return w


def test_sample_merge_cdf_never_steps_down_on_heavy_tailed_weights():
    """The CDF that sample_merge inverts is non-decreasing in every ray,
    by construction (each prefix the one before plus a bin's share), on the
    weights where the TPU prologue's ``inclusive - pdf`` steps down by an
    ulp; the depths it draws there are sorted, and no farther from JAX's
    ``invert_cdf`` than the prologue's CDF puts them. (JAX sums the total
    in another order, so its CDF lies some ulps away, and in a bin with a
    tiny share the inverse CDF multiplies that by 1 / denom: on such
    weights both definitions exceed ``SAMPLING_ATOL`` on a few depths.)"""
    r, s_c, n = 2000, 64, 128
    w = torch.as_tensor(_heavy_tailed(r, s_c, seed=5))
    cdf = sequential_cdf(w)
    assert bool((cdf[:, 1:] >= cdf[:, :-1]).all())
    # The prologue's exclusive form, one float32 rounding off the chain.
    wp = w + 1e-5
    total = torch.zeros(r)
    for i in range(s_c):
        total = total + wp[:, i]
    excl = cdf - wp / total[:, None]
    steps_down = int((excl[:, 1:] < excl[:, :-1]).any(dim=1).sum())
    print(f"heavy-tailed weights, {r} rays: inclusive - pdf steps down in "
          f"{steps_down}, the sequential CDF in 0")
    assert steps_down > 0

    rng = np.random.default_rng(6)
    cp = np.sort(rng.uniform(2, 6, (r, s_c)).astype(np.float32), -1)
    u = np.sort(rng.uniform(size=(r, n)).astype(np.float32), -1)
    got = trm.sample_merge(*_t(cp, w.numpy(), u), None)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    want = np.asarray(jsamp.invert_cdf(
        jnp.asarray(u), jsamp.midpoints(jnp.asarray(cp)),
        jnp.asarray(w.numpy())))
    before = _prologue_form(*_t(cp, u), w, excl)
    new_err = float(np.abs(got.numpy() - want).max())
    old_err = float(np.abs(before.numpy() - want).max())
    print(f"heavy-tailed weights, drawn depths against JAX's invert_cdf: "
          f"max abs {new_err:.3e}, the prologue's CDF {old_err:.3e} (JAX "
          f"sums the total in another order: its CDF "
          f"{np.abs(cdf.numpy() - np.asarray(_jax_cdf(w))).max():.3e} "
          f"away); the two definitions "
          f"{float((got - before).abs().max()):.3e} apart")
    assert new_err <= old_err


def _search_form(cp, w, u, mp):
    """sample_merge as csrc/sample_merge.cu computes it: k, the count of
    0-prepended CDF entries <= u, by a search; the brackets cdf[k-1],
    cdf[k], mid[k-1], mid[k]; each depth's slot by a search into the
    other array (the partner's into the drawn depths as they come)."""
    r, s_c = w.shape
    cdf = torch.cat([torch.zeros(r, 1), sequential_cdf(w)], 1)
    i = torch.arange(s_c + 1).clamp(max=s_c - 2)
    mids = 0.5 * (cp[:, i] + cp[:, i + 1])
    k = torch.searchsorted(cdf, u, right=True)
    below = (k - 1).clamp(min=0)
    ninf = torch.full_like(u, -float("inf"))
    c_lo = torch.where(k > 0, cdf.gather(1, below), ninf)
    b_lo = torch.where(k > 0, mids.gather(1, below), ninf)
    above = k.clamp(max=s_c)
    c_hi, b_hi = cdf.gather(1, above), mids.gather(1, above)
    denom = c_hi - c_lo
    denom = torch.where(denom < float(np.float32(1e-5)),
                        torch.ones_like(denom), denom)
    f = b_lo + (u - c_lo) / denom * (b_hi - b_lo)
    if mp is None:
        return f
    n, s_m = u.shape[1], mp.shape[1]
    out = torch.zeros(r, s_m + n)
    out.scatter_(1, torch.arange(s_m) + torch.searchsorted(f, mp), mp)
    out.scatter_(1, torch.arange(n) + torch.searchsorted(mp, f, right=True),
                 f)
    return out


@pytest.mark.parametrize("mode", ["coarse", "none", "partner"])
@pytest.mark.parametrize("weights", ["cubed", "occupancy", "heavy",
                                     "one bin"])
def test_sample_merge_search_form_is_the_plain_version_bit_for_bit(weights,
                                                                   mode):
    """The kernel's design, run on the CPU: brackets and ranks found by
    search give the masked reductions' and the counted ranks' bits."""
    r, s_c, n = 512, 64, 128
    rng = np.random.default_rng(9)
    cp = np.sort(rng.uniform(2, 6, (r, s_c)).astype(np.float32), -1)
    w = {"cubed": rng.uniform(size=(r, s_c)) ** 3,
         "occupancy": rng.uniform(size=(r, s_c)) > 0.6,
         "heavy": _heavy_tailed(r, s_c, seed=9),
         "one bin": np.eye(s_c)[rng.integers(0, s_c, r)]}[weights]
    u = np.sort(rng.uniform(size=(r, n)).astype(np.float32), -1)
    mp = {"coarse": cp, "none": None, "partner": np.sort(
        rng.uniform(2, 6, (r, 48)).astype(np.float32), -1)}[mode]
    cp, w, u = _t(cp, w.astype(np.float32), u)
    mp = None if mp is None else torch.as_tensor(mp)
    want = trm.sample_merge_plain(cp, w, u, mp)
    assert torch.equal(_search_form(cp, w, u, mp), want)
    assert bool((want[:, 1:] >= want[:, :-1]).all())


def test_merge_ranks_are_a_permutation_only_when_the_counts_rise():
    """The lemma behind the kernel's partner ranks: every case of up to 4
    drawn and 3 sorted partner depths over 4 values. Where merge_sorted's
    slots are a permutation, each drawn depth's count of partners <= it
    never decreases along the draws, so "drawn < partner" holds on a
    prefix of the draws and a search counts it exactly; where the counts
    decrease, two depths share a slot."""
    import itertools

    vals = range(4)
    for n in range(1, 5):
        for m in range(1, 4):
            for f in itertools.product(vals, repeat=n):
                for a in itertools.combinations_with_replacement(vals, m):
                    c = [sum(x <= y for x in a) for y in f]
                    d = [sum(y < x for y in f) for x in a]
                    slots = ([j + c[j] for j in range(n)]
                             + [i + d[i] for i in range(m)])
                    rising = all(p <= q for p, q in zip(c, c[1:]))
                    assert (len(set(slots)) == n + m) == rising
                    if rising:
                        for x in a:
                            lt = [y < x for y in f]
                            assert lt == sorted(lt, reverse=True)


def _jax_cdf(w):
    wj = jnp.asarray(w.numpy()) + 1e-5
    return jnp.cumsum(wj / jnp.sum(wj, -1, keepdims=True), -1)


def _prologue_form(cp, u, w, excl):
    """The drawn depths from the TPU prologue's exclusive CDF ``excl``
    (``inclusive - pdf``, `_sample_merge_prologue`): masked max/min over
    its ``s_c`` entries, the total as the bracket past the last one."""
    big = float(np.float32(3.0e38))
    total = sequential_cdf(w)[:, -1:]
    mids = 0.5 * (cp[:, :-1] + cp[:, 1:])
    mids = torch.cat([mids, mids.amax(1, keepdim=True)], 1)
    le = excl[:, None, :] <= u[:, :, None]
    c_lo = torch.where(le, excl[:, None, :], -big).amax(2)
    c_hi = torch.where(le, big, excl[:, None, :]).amin(2)
    c_hi = torch.where(c_hi >= 0.5 * big, total, c_hi)
    b_lo = torch.where(le, mids[:, None, :], -big).amax(2)
    b_hi = torch.where(le, big, mids[:, None, :]).amin(2)
    b_hi = torch.where(b_hi >= 0.5 * big, mids[:, -1:], b_hi)
    denom = c_hi - c_lo
    denom = torch.where(denom < float(np.float32(1e-5)),
                        torch.ones_like(denom), denom)
    return b_lo + (u - c_lo) / denom * (b_hi - b_lo)


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
