"""The kernels' plain versions against the JAX package's TPU kernel.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX side runs ``fused_train_chunk(with_grad=False)`` in Pallas interpret
mode, as ``tests/models/test_pallas_kernel.py`` does. Same parameters, rays,
coarse depths, weights and sorted draws, made with numpy. Budgets are those
of the JAX package's own fused-sampling check
(`test_pallas_kernel.py:431-434`): image atol 2e-3, depth atol 5e-3,
weights atol 2e-3; the sampling chain alone atol 1e-4.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
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
from keras_nerf_tpu_torch.ops.sampling import (invert_cdf_of,
                                               sequential_cdf)
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


HEAVY_SEEDS = (5, 9, 11, 13)


@pytest.mark.parametrize("seed", HEAVY_SEEDS)
def test_sample_merge_cdf_never_steps_down_on_heavy_tailed_weights(seed):
    """The CDF that sample_merge inverts is non-decreasing in every ray,
    by construction (each prefix the one before plus a bin's share), on the
    weights where the TPU prologue's ``inclusive - pdf`` steps down by an
    ulp; the depths it draws there are sorted, and no farther from JAX's
    ``invert_cdf`` than the prologue's CDF puts them. (JAX sums the total
    in another order, so its CDF lies some ulps away, and in a bin with a
    tiny share the inverse CDF multiplies that by 1 / denom: on such
    weights both definitions exceed ``SAMPLING_ATOL`` on a few depths;
    :func:`test_sample_merge_on_heavy_tailed_weights_is_jax_on_jax_cdf`
    accounts for every one.)"""
    r, s_c, n = 2000, 64, 128
    w = torch.as_tensor(_heavy_tailed(r, s_c, seed=seed))
    cdf = sequential_cdf(w)
    assert bool((cdf[:, 1:] >= cdf[:, :-1]).all())
    # The prologue's exclusive form, one float32 rounding off the chain.
    wp = w + 1e-5
    total = torch.zeros(r)
    for i in range(s_c):
        total = total + wp[:, i]
    excl = cdf - wp / total[:, None]
    steps_down = int((excl[:, 1:] < excl[:, :-1]).any(dim=1).sum())
    print(f"heavy-tailed weights (seed {seed}), {r} rays: inclusive - pdf "
          f"steps down in {steps_down}, the sequential CDF in 0")
    assert steps_down > 0

    cp, u = _heavy_draws(r, s_c, n)
    got = trm.sample_merge(*_t(cp, w.numpy(), u), None)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    want = np.asarray(jsamp.invert_cdf(
        jnp.asarray(u), jsamp.midpoints(jnp.asarray(cp)),
        jnp.asarray(w.numpy())))
    before = _prologue_form(*_t(cp, u), w, excl)
    new_err = float(np.abs(got.numpy() - want).max())
    old_err = float(np.abs(before.numpy() - want).max())
    print(f"heavy-tailed weights (seed {seed}), drawn depths against JAX's "
          f"invert_cdf: max abs {new_err:.3e}, the prologue's CDF "
          f"{old_err:.3e} (JAX sums the total in another order: its CDF "
          f"{np.abs(cdf.numpy() - np.asarray(_jax_cdf(w))).max():.3e} "
          f"away); the two definitions "
          f"{float((got - before).abs().max()):.3e} apart")
    assert new_err <= old_err


def _heavy_draws(r, s_c, n):
    """The coarse depths and sorted draws of the heavy-tailed checks."""
    rng = np.random.default_rng(6)
    cp = np.sort(rng.uniform(2, 6, (r, s_c)).astype(np.float32), -1)
    u = np.sort(rng.uniform(size=(r, n)).astype(np.float32), -1)
    return cp, u


F32_ULP = 2.0 ** -24   # unit roundoff of float32
# A CDF of 64 bins, summed in any order: the total with at most 63
# roundings (gamma_63 relative), each share one rounding of the divide,
# each prefix at most 63 more roundings of a sum of shares <= 1. So each
# entry lies within (63 + 1 + 63) u of the exact CDF, whatever the order,
# and two orders lie within twice that of each other: 254 u = 1.514e-5.
# (``w + 1e-5`` is one rounding of the same operands in both.)
CDF_BUDGET = 2 * (63 + 1 + 63) * F32_ULP
# Depths whose bracket differs between the two CDFs (a draw between the
# two values of one entry), as measured per weights seed: 2,000 rays x 128
# draws.
BRACKET_CHANGES = {5: 0, 9: 0, 11: 1, 13: 0}


@pytest.mark.parametrize("seed", HEAVY_SEEDS)
def test_sample_merge_on_heavy_tailed_weights_is_jax_on_jax_cdf(seed):
    """ROADMAP C13: the port's sampling against JAX's ``invert_cdf`` on
    heavy-tailed weights is JAX's inversion on a CDF a few ulps away.

    (a) Pinned: ``invert_cdf_of`` fed JAX's own inclusive CDF (the
    expression of `keras_nerf_tpu/ops/sampling.py:119-121`) is JAX's
    ``invert_cdf`` bit for bit. (b) The port's ``sequential_cdf`` lies
    within :data:`CDF_BUDGET` of JAX's CDF, entry by entry. (c) Unpinned,
    each drawn depth lies within ``SAMPLING_ATOL`` plus the first-order
    effect of the two CDFs' difference at its own bracket (JAX's),
    ``(|dc_lo| (1 - t) + |dc_hi| t) / denom (b_hi - b_lo)``, except where
    the bracket itself differs between the two CDFs: those are counted
    and held at :data:`BRACKET_CHANGES`. The witness: JAX's own float32
    ``invert_cdf`` against a float64 inversion of the same weights."""
    r, s_c, n = 2000, 64, 128
    w = _heavy_tailed(r, s_c, seed=seed)
    cp, u = _heavy_draws(r, s_c, n)
    mids = np.array(jsamp.midpoints(jnp.asarray(cp)))
    want = np.asarray(jsamp.invert_cdf(jnp.asarray(u), jnp.asarray(mids),
                                       jnp.asarray(w)))
    wj = jnp.asarray(w) + 1e-5
    jax_cdf = np.array(jnp.cumsum(wj / jnp.sum(wj, axis=-1, keepdims=True),
                                   axis=-1))
    pinned = invert_cdf_of(*_t(u, mids, jax_cdf)).numpy()
    assert np.array_equal(pinned, want)

    port_cdf = sequential_cdf(torch.as_tensor(w)).numpy()
    cdf_err = float(np.abs(port_cdf - jax_cdf).max())
    assert cdf_err <= CDF_BUDGET

    got = trm.sample_merge(*_t(cp, w, u), None).numpy()
    zero = np.zeros((r, 1), np.float32)
    cj = np.concatenate([zero, jax_cdf], 1)
    cport = np.concatenate([zero, port_cdf], 1)
    k_jax = _bracket(cj, u)
    changed = k_jax != _bracket(cport, u)
    lo, hi = np.maximum(k_jax - 1, 0), np.minimum(k_jax, s_c)
    rows = np.arange(r)[:, None]
    mp = np.concatenate([mids] + [mids[:, -1:]] * 2, 1)   # edge-padded
    c_lo, c_hi = cj[rows, lo], cj[rows, hi]
    b_lo, b_hi = mp[rows, lo], mp[rows, hi]
    denom = c_hi - c_lo
    denom = np.where(denom < np.float32(1e-5), np.float32(1.0), denom)
    t = (u - c_lo) / denom
    first = ((np.abs(cport[rows, lo] - c_lo) * (1 - t)
              + np.abs(cport[rows, hi] - c_hi) * t) / denom * (b_hi - b_lo))
    err = np.abs(got - want)
    over = (err > SAMPLING_ATOL + first) & ~changed
    share = float((err / (SAMPLING_ATOL + first))[~changed].max())

    w64 = w.astype(np.float64) + 1e-5
    cdf64 = torch.as_tensor(np.cumsum(w64 / w64.sum(-1, keepdims=True), -1))
    f64 = invert_cdf_of(torch.as_tensor(u, dtype=torch.float64),
                        torch.as_tensor(mids, dtype=torch.float64),
                        cdf64).numpy()
    print(f"C13, heavy-tailed weights seed {seed}, {r} rays x {n} draws: "
          f"(a) invert_cdf_of on JAX's CDF against JAX's invert_cdf: max "
          f"abs {np.abs(pinned - want).max():.3e} (budget 0, bit for bit); "
          f"(b) sequential_cdf against JAX's CDF {cdf_err:.3e} (budget "
          f"{CDF_BUDGET:.3e}); (c) depths: max abs {err.max():.3e}, "
          f"{int((err > SAMPLING_ATOL).sum())} beyond SAMPLING_ATOL "
          f"{SAMPLING_ATOL}, each within SAMPLING_ATOL + the first-order "
          f"effect of the CDFs' difference at its bracket (worst share of "
          f"that budget {share:.3f}, {int(over.sum())} beyond it), bracket "
          f"changes {int(changed.sum())} (cap {BRACKET_CHANGES[seed]}), "
          f"their largest error "
          f"{(err[changed].max() if changed.any() else 0.0):.3e}; witness: "
          f"JAX's float32 invert_cdf against a float64 inversion "
          f"{np.abs(want - f64).max():.3e}")
    assert not over.any()
    assert int(changed.sum()) <= BRACKET_CHANGES[seed]


def _bracket(cdf, u):
    """The count of 0-prepended CDF entries <= each draw, per ray."""
    return np.stack([np.searchsorted(c, x, side="right")
                     for c, x in zip(cdf, u)])


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


QUAD_TOL = {"abs": 1e-4, "rel": 1e-2, "rel_norm": 1e-2}   # chip_smoke.py's
QUAD_S = [1, 8, 31, 32, 33, 64, 192, 256, 257, 1024]
# Past 1024 samples only the with_grad mode's windows changed (ROADMAP C14):
# its carries in shared memory, 4 and 15 of them here.
QUAD_GRAD_S = [1088, 4096]
QUAD_MODES = ["sigma-only", "full", "full white", "with_grad",
              "with_grad white"]
QUAD_CASES = ["random", "saturated", "zero sigma"]


def _lane_scan(v, reverse=False):
    """A warp's Hillis-Steele inclusive scan over the last axis (32
    lanes), in the kernel's rounds: lane l adds lane l - off (l + off
    when ``reverse``) for off = 1, 2, ..., 16."""
    off = 1
    while off < 32:
        if reverse:
            v = torch.cat([v[..., :-off] + v[..., off:], v[..., -off:]], -1)
        else:
            v = torch.cat([v[..., :off], v[..., off:] + v[..., :-off]], -1)
        off *= 2
    return v


def _warp_sum(v):
    """The kernel's butterfly reduction over 32 lanes (xor 16, 8, ..., 1):
    every lane ends with the same sum."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _blocked_form(rgbs, t, white_bg=False, sigma_only=False, target=None,
                  loss_scale=0.0):
    """ray_march_quadrature as csrc/ray_march_quadrature.cu computes it: a
    warp a ray, lane l of window w holding samples w 32 k + l k + j; the
    exclusive optical depth as (carry + the lanes' exclusive scan) + the
    in-lane prefix; per-lane partial sums reduced by a butterfly; with a
    target, the reverse walk, last window first: each window before the
    last rebuilt from the carry the forward walk stored for it, then (suffix
    carry + the lanes' exclusive reverse scan) + the in-lane suffix.
    Returns what ``ray_march_quadrature_plain`` returns, weights
    included."""
    r, s = t.shape
    plan = trm.quadrature_plan(s, with_grad=target is not None)
    k, n_win = plan["k"], plan["windows"]
    pad = n_win * 32 * k
    sigma = rgbs if sigma_only else rgbs[..., 3]
    delta = torch.cat([t[:, 1:] - t[:, :-1],
                       torch.full_like(t[:, :1], trm._LAST_DELTA)], 1)

    def blocks(a):   # [r, s] -> [r, windows, 32 lanes, k], zeros past s
        a = torch.cat([a, a.new_zeros(r, pad - s)], 1)
        return a.reshape(r, n_win, 32, k)

    x = blocks(sigma * delta)
    pre, p = torch.zeros_like(x), torch.zeros_like(x[..., 0])
    for j in range(k):
        pre[..., j] = p
        p = p + x[..., j]
    incl = _lane_scan(p)
    ex = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)
    carry, excl, carries = torch.zeros(r), torch.zeros_like(x), []
    for w in range(n_win):
        carries.append(carry)
        b = carry[:, None] + ex[:, w]
        carry = carry + incl[:, w, 31]
        excl[:, w] = b[..., None] + pre[:, w]
    e, tr = torch.exp(-x), torch.exp(-excl)
    wgt = (1.0 - e) * tr

    def lane_sums(a):   # per lane over windows then samples, then butterfly
        acc = torch.zeros(r, 32)
        for w in range(n_win):
            for j in range(k):
                acc = acc + a[:, w, :, j]
        return _warp_sum(acc)

    depth = lane_sums(wgt * blocks(t))
    weights = wgt.reshape(r, pad)[:, :s]
    if sigma_only:
        return torch.zeros(r, 3), depth, weights
    c = [blocks(rgbs[..., i]) for i in range(3)]
    pre_clip = torch.stack([lane_sums(wgt * ci) for ci in c], 1)
    if white_bg:
        pre_clip = pre_clip + (1.0 - lane_sums(wgt))[:, None]
    image = pre_clip.clamp(0.0, 1.0)
    if target is None:
        return image, depth, weights
    d_image = (image - target) * trm._f32(loss_scale)
    dp = torch.where((pre_clip > 0) & (pre_clip < 1), d_image,
                     torch.where((pre_clip == 0) | (pre_clip == 1),
                                 0.5 * d_image, torch.zeros_like(d_image)))
    dp = [dp[:, i, None, None, None] for i in range(3)]
    d_w = (c[0] * dp[0] + c[1] * dp[1]) + c[2] * dp[2]
    if white_bg:
        d_w = d_w - ((dp[0] + dp[1]) + dp[2])
    suffix_carry, d_x = torch.zeros(r), torch.zeros_like(x)
    wgt_rev = wgt.clone()   # the weights as the reverse walk holds them
    for w in reversed(range(n_win)):
        tr_w = tr[:, w]
        if w != n_win - 1:   # rebuilt from the carry stored for it
            tr_w = torch.exp(-((carries[w][:, None] + ex[:, w])[..., None]
                               + pre[:, w]))
            wgt_rev[:, w] = (1.0 - e[:, w]) * tr_w
        v = wgt_rev[:, w] * d_w[:, w]
        later, q = torch.zeros_like(v), torch.zeros_like(v[..., 0])
        for j in reversed(range(k)):
            later[..., j] = q
            q = q + v[..., j]
        suf = _lane_scan(q, reverse=True)
        after = torch.cat([suf[..., 1:], torch.zeros_like(suf[..., :1])], -1)
        b = suffix_carry[:, None] + after
        suffix_carry = suffix_carry + suf[:, 0]
        d_x[:, w] = e[:, w] * tr_w * d_w[:, w] - (b[..., None] + later)
    d_sigma = torch.where(blocks(sigma) > 0, d_x * blocks(delta), 0.0)
    d_rgb = torch.zeros(r * s, trm.D_HEAD, dtype=torch.bfloat16)
    for i in range(3):
        g = wgt_rev * dp[i] * c[i] * (1.0 - c[i])
        d_rgb[:, i] = g.reshape(r, pad)[:, :s].reshape(-1).to(torch.bfloat16)
    return (image, depth, weights, d_rgb,
            d_sigma.reshape(r, pad)[:, :s].reshape(-1).to(torch.bfloat16))


def _quad_inputs(s, case, r=8, seed=7):
    rng = np.random.default_rng(seed + s)
    t = np.sort(rng.uniform(2, 6, (r, s)), -1)
    rgbs = rng.uniform(size=(r, s, 4))
    rgbs[..., 3] = {"random": 5 * rgbs[..., 3], "saturated": 1e4,
                    "zero sigma": 0.0}[case]
    target = rng.uniform(size=(r, 3))
    return _t(t.astype(np.float32), rgbs.astype(np.float32),
              target.astype(np.float32))


@pytest.mark.parametrize("s,case,mode", [
    (s, case, mode) for s in QUAD_S + QUAD_GRAD_S for case in QUAD_CASES
    for mode in QUAD_MODES if s in QUAD_S or mode.startswith("with_grad")])
def test_quadrature_blocked_form_matches_the_plain_version(s, case, mode):
    """The kernel's design, run on the CPU, against
    ``ray_march_quadrature_plain`` at the card's budgets (image, depth and
    weights absolutely, the bf16 cotangents relative to their largest
    entry and by norm), on the register route (S <= 256: k = ceil(S / 32)
    samples a lane, its edges 31, 32, 33) and the windowed one (257,
    1024, and with_grad 1088 and 4096: 5 and 16 windows, ROADMAP C14);
    saturated rays (x >> 1), all-zero sigma and, on a white background
    with zero sigma, a pre-clip image of exactly 1 (the clip's subgradient
    0.5, ROADMAP C5)."""
    t, rgbs, target = _quad_inputs(s, case)
    sigma_only = mode == "sigma-only"
    inp = rgbs[..., 3].contiguous() if sigma_only else rgbs
    kw = dict(white_bg="white" in mode, sigma_only=sigma_only)
    if mode.startswith("with_grad"):
        kw.update(target=target, loss_scale=2.0 / (3 * t.shape[0]))
    got = _blocked_form(inp, t, **kw)
    want = trm.ray_march_quadrature_plain(
        inp, t, kw["white_bg"], sigma_only, True, target=kw.get("target"),
        loss_scale=kw.get("loss_scale", 0.0))
    assert len(got) == len(want)
    for a, b in zip(got[:3], want[:3]):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= QUAD_TOL["abs"]
    for a, b in zip(got[3:], want[3:]):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        a, b = a.float(), b.float()
        scale = b.abs().max().clamp_min(1e-30)
        assert float((a - b).abs().max() / scale) <= QUAD_TOL["rel"]
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) \
            <= QUAD_TOL["rel_norm"]
    if case == "zero sigma" and mode == "with_grad white":
        assert bool((want[0] == 1.0).all())   # the clip's edge, slope 0.5
        d_rgb = want[3].float()
        assert float(d_rgb.abs().max()) == 0.0   # no weight, no colour term


@pytest.mark.parametrize("s", [0] + QUAD_S + [1025, 4096]
                         + [1088, 2 ** 16, 2 ** 19, 2 ** 19 + 1])
def test_quadrature_plan_routes(s):
    """Registers up to 256 samples (k = ceil(S / 32) a lane), windows of
    256 above; the with_grad mode takes 1 to 2^19 samples (a carry in
    shared memory for each window but the last, ROADMAP C14) and refuses
    others by name; 8 rays a block in sigma-only mode, 4 with the
    colours."""
    plan = trm.quadrature_plan(s)
    assert plan["k"] == max(1, min(8, -(-s // 32)))
    assert plan["windows"] == -(-s // (32 * plan["k"]))
    assert plan["route"] == ("registers" if s <= 256 else "windowed")
    assert plan["rays_per_block"] == 4
    assert trm.quadrature_plan(s, sigma_only=True) == {
        **plan, "rays_per_block": 8}
    if not 1 <= s <= 2 ** 19:
        with pytest.raises(ValueError, match="with_grad mode takes at most "
                                             "524288 samples"):
            trm.quadrature_plan(s, with_grad=True)
    else:
        assert trm.quadrature_plan(s, with_grad=True) == plan
