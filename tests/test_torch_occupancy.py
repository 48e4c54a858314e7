"""The port's occupancy-grid render against the JAX package's, on the CPU.

Parameters drawn by JAX and carried over with ``params_from_jax``; the
same rays; the draws injected: JAX's per-chunk ``sorted_uniforms(split(key,
num_chunks)[i], (R,), n_samples)``. The configuration of
`test_pallas_kernel.py:266-294` (3 x 256), so that JAX's ``use_pallas=True``
runs its kernels in interpret mode. Budgets, each with its reason:

* the grid's coordinates, probe centres, probe occupancy and dilation:
  equal, float32 bit for bit;
* ``sample_occupied`` on JAX's draws: atol 1e-5 (float32 sums in another
  order inside the CDF);
* the density: the float32 reference path against XLA at rtol 1e-5 and an
  equal grid; the kernel path (``apply_mlp``'s plain version, bf16
  operands) against JAX's Pallas kernel at the bf16 budget, 0.03 of the
  largest sigma, and an equal grid but at voxels whose JAX sigma lies within
  that budget of the threshold;
* ``sample_merge``'s no-merge and partner modes, and whole renders on the
  kernel path, against JAX's fused kernel: the fused-sampling budget of
  `test_pallas_kernel.py:431-434`, image 2e-3, depth 5e-3 (weights 2e-3);
  the reference path against XLA: atol 1e-4; the int8 tier from JAX's own
  int8 dict: the same fused-sampling budget, as `test_torch_quantize.py`.

``-s`` prints each reading beside its budget.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from keras_nerf_tpu.kernels import pack_mlp_params as jax_pack
from keras_nerf_tpu.kernels import quantize as jq
from keras_nerf_tpu.kernels.ray_march import encode_block128 as jax_encode
from keras_nerf_tpu.kernels.ray_march import fused_train_chunk as jax_chunk
from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.ops import occupancy as jocc
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu.utils import checkpoint as jckpt
from keras_nerf_tpu_torch.kernels import KERNELS
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRF
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.ops import merge_sorted
from keras_nerf_tpu_torch.ops import occupancy as tocc
from keras_nerf_tpu_torch.utils.convert import (
    params_from_jax,
    quantized_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_ATOL, DEPTH_ATOL, WEIGHTS_ATOL = 2e-3, 5e-3, 2e-3
REF_ATOL = 1e-4
SIGMA_RTOL, BF16_SIGMA = 1e-5, 0.03
B, H, W, CHUNK = 1, 4, 8, 16
N_SAMPLES, N_PROBE, GRID = 8, 16, 16
NEAR, FAR = 2.0, 6.0

JAX_CFG = jengine.NeRFConfig(n_coarse=8, n_fine=8, pos_emb_xyz=10,
                             pos_emb_dir=4, n_layers=3, dense_units=256,
                             skip_layer=2, white_background=True,
                             use_pallas=True)


def _port_cfg(jcfg, use_kernels=None):
    return tengine.NeRFConfig(**jcfg.to_model_config(),
                              white_background=jcfg.white_background,
                              use_kernels=use_kernels)


def _report(what, reading, budget):
    print(f"\n{what}: {reading:.3e} (budget {budget:g})")
    assert reading <= budget, what


def _sphere_grid(g=GRID, radius=1.2, seed=0):
    """A ball with holes: a grid with occupied and empty runs per ray."""
    c = (np.arange(g) + 0.5) / g * 4.0 - 2.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    occ = (x * x + y * y + z * z < radius * radius).astype(np.float32)
    holes = np.random.default_rng(seed).uniform(size=occ.shape) < 0.3
    return np.where(holes, 0.0, occ).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """JAX's fine parameters, rays (some leave the box, some miss the
    ball), the grid, stratified depths and the per-chunk draws."""
    _, params_f = jengine.init_params(jax.random.PRNGKey(2), JAX_CFG)
    rng = np.random.default_rng(0)
    r = B * H * W
    o = np.tile(np.float32([0.0, 0.0, 4.0]), (r, 1))
    o[:, :2] += rng.uniform(-0.5, 0.5, (r, 2)).astype(np.float32)
    d = np.float32([0.0, 0.0, -1.0]) + rng.normal(0, 0.35, (r, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = np.sort(rng.uniform(NEAR, FAR, (r, JAX_CFG.n_coarse)), -1
                ).astype(np.float32)
    key = jax.random.PRNGKey(7)
    draws = [np.asarray(jax_sorted_uniforms(k, (CHUNK,), N_SAMPLES))
             for k in jax.random.split(key, r // CHUNK)]
    return {"pf": jax.tree.map(np.asarray, params_f), "o": o, "d": d,
            "t": t, "key": key, "draws": draws, "grid": _sphere_grid()}


def _rays(scene):
    return tuple(scene[k].reshape(B, H, W, -1) for k in "odt")


# ---------------------------------------------------------------- the grid


@pytest.mark.parametrize("g,aabb", [(16, jocc.DEFAULT_AABB), (37, None),
                                    (20, ((-1.5, -2.0, -0.7),
                                          (2.5, 1.0, 3.3)))])
def test_grid_coordinates_bit_identical(g, aabb):
    aabb = aabb or jocc.DEFAULT_AABB
    want = np.asarray(jocc.grid_coordinates(g, aabb))
    got = tocc.grid_coordinates(g, aabb, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("near,far,d", [(2.0, 6.0, 64), (2.0, 6.0, 16),
                                        (0.1, 7.3, 33), (2.0, 6.0, 100)])
def test_probe_bin_mids_bit_identical(near, far, d):
    np.testing.assert_array_equal(
        tocc.probe_bin_mids(near, far, d, "cpu").numpy(),
        np.asarray(jocc.probe_bin_mids(near, far, d)))


def test_occupancy_along_rays_bit_identical(scene):
    """Random rays, some leaving the box (their points read empty)."""
    rng = np.random.default_rng(3)
    o = (rng.normal(size=(500, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    grid = scene["grid"]
    want_m, want_o = jocc.occupancy_along_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(grid), NEAR, FAR, 64)
    got_m, got_o = tocc.occupancy_along_rays(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(grid), NEAR,
        FAR, 64)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    pts = o[:, None] + d[:, None] * got_m.numpy()[..., None]
    outside = (np.abs(pts) >= 2.0).any(-1)
    assert outside.any() and (~outside).any()
    assert not got_o.numpy()[outside].any()
    assert 0.0 < float(got_o.mean()) < 1.0


@pytest.mark.parametrize("iterations", [0, 1, 2])
def test_dilate_occupancy_equal(iterations):
    occ = (np.random.default_rng(1).uniform(size=(12, 12, 12)) > 0.8
           ).astype(np.float32)
    want = np.asarray(jocc.dilate_occupancy(jnp.asarray(occ), iterations))
    got = tocc.dilate_occupancy(torch.as_tensor(occ), iterations).numpy()
    np.testing.assert_array_equal(got, want)
    # The 6-neighbourhood: one voxel grows into the L1 ball (1, 7, 25).
    one = np.zeros((9, 9, 9), np.float32)
    one[4, 4, 4] = 1.0
    assert tocc.dilate_occupancy(torch.as_tensor(one), iterations).sum() \
        == (1, 7, 25)[iterations]


def test_sample_occupied_matches_jax(scene):
    o, d = (torch.as_tensor(scene[k][:CHUNK]) for k in "od")
    mids, occ = tocc.occupancy_along_rays(o, d, torch.as_tensor(scene["grid"]),
                                          NEAR, FAR, N_PROBE)
    k = jax.random.split(scene["key"], 2)[0]
    want = jocc.sample_occupied(k, jnp.asarray(mids.numpy()),
                                jnp.asarray(occ.numpy()), N_SAMPLES)
    got = tocc.sample_occupied(torch.as_tensor(scene["draws"][0]), mids, occ)
    _report("sample_occupied depths, max abs", float(np.abs(
        got.numpy() - np.asarray(want)).max()), 1e-5)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    g = torch.Generator().manual_seed(0)
    assert tocc.sample_occupied(g, mids, occ, N_SAMPLES).shape == (CHUNK,
                                                                   N_SAMPLES)


# ------------------------------------------------------------- the density


def _density_inputs(scene, g=8):
    coords = np.asarray(jocc.grid_coordinates(g)).reshape(-1, 3)
    return coords, params_from_jax(scene["pf"], "cpu")


def _threshold(sigma):
    """A threshold between two neighbouring sigmas near the median."""
    s = np.sort(sigma)
    i = len(s) // 2
    return float(0.5 * (s[i] + s[i + 1]))


@pytest.mark.parametrize("path", ["reference", "kernel"])
def test_model_density_fn_and_bake_match_jax(scene, path):
    kernel = path == "kernel"
    g = 8
    coords, params = _density_inputs(scene, g)
    want = np.asarray(jocc.model_density_fn(scene["pf"], JAX_CFG,
                                            use_pallas=kernel)(
        jnp.asarray(coords)))
    density = tocc.model_density_fn(params, _port_cfg(JAX_CFG, kernel),
                                    chunk=100)
    got = density(torch.as_tensor(coords)).numpy()
    budget = BF16_SIGMA * float(np.abs(want).max()) if kernel else None
    if kernel:
        _report("kernel-path sigma, max abs / largest sigma",
                float(np.abs(got - want).max() / np.abs(want).max()),
                BF16_SIGMA)
    else:
        np.testing.assert_allclose(got, want, rtol=SIGMA_RTOL, atol=1e-6)
    thr = _threshold(want)
    want_grid = np.asarray(jocc.bake_occupancy_grid(
        jocc.model_density_fn(scene["pf"], JAX_CFG, use_pallas=kernel), g,
        sigma_threshold=thr, dilate=0))
    got_grid = tocc.bake_occupancy_grid(density, g, sigma_threshold=thr,
                                        dilate=0, device="cpu").numpy()
    assert 0.0 < got_grid.mean() < 1.0
    differ = got_grid.reshape(-1) != want_grid.reshape(-1)
    if kernel:
        near = np.abs(want - thr) <= budget
        print(f"\nkernel-path bake: {int(near.sum())} of {want.size} voxels "
              f"lie within the bf16 budget of the threshold, "
              f"{int(differ.sum())} differ")
        assert not differ[~near].any()
    else:
        assert not differ.any()
    dilated = tocc.bake_occupancy_grid(density, g, sigma_threshold=thr,
                                       dilate=1, device="cpu")
    np.testing.assert_array_equal(
        dilated.numpy(), tocc.dilate_occupancy(torch.as_tensor(got_grid),
                                               1).numpy())


# ---------------------------------------------------- sample_merge's modes


def _chunk_inputs(scene):
    o, d, t = (scene[k][:CHUNK] for k in "odt")
    mids, occ = jocc.occupancy_along_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(scene["grid"]), NEAR, FAR,
        N_PROBE)
    return o, d, t, np.asarray(mids), np.asarray(occ), scene["draws"][0]


@pytest.mark.parametrize("mode", ["no_merge", "partner"])
def test_sample_merge_modes_match_jax_prologue(scene, mode):
    """``sample_inputs=(mids, occ, u, None)`` (``s_m = 0``) and ``(mids,
    occ, u, t_coarse)`` (``s_m > 0``) through the port's chunk against
    JAX's fused_train_chunk in interpret mode."""
    o, d, t, mids, occ, u = _chunk_inputs(scene)
    mp = None if mode == "no_merge" else t
    packed = jax_pack(scene["pf"], JAX_CFG.mlp, 10, 4)
    want = jax_chunk(packed, jnp.asarray(o), jnp.asarray(d), None, None,
                     JAX_CFG.mlp, white_background=True, with_grad=False,
                     emit_weights=True, interpret=True,
                     sample_inputs=(jnp.asarray(mids), jnp.asarray(occ),
                                    jnp.asarray(u),
                                    None if mp is None else jnp.asarray(mp)))
    tp = trm.pack_mlp_params(params_from_jax(scene["pf"], "cpu"),
                             JAX_CFG.mlp, 10, 4)
    sample_inputs = tuple(torch.as_tensor(x) for x in (mids, occ, u)) + (
        None if mp is None else torch.as_tensor(mp),)
    got = trm.fused_render_chunk(tp, torch.as_tensor(o), torch.as_tensor(d),
                                 None, white_background=True,
                                 sample_inputs=sample_inputs)
    width = N_SAMPLES + (0 if mp is None else t.shape[1])
    assert got[2].shape == (CHUNK, width)
    for name, i, budget in (("image", 0, IMAGE_ATOL), ("depth", 1, DEPTH_ATOL),
                            ("weights", 2, WEIGHTS_ATOL)):
        _report(f"sample_merge {mode}: chunk {name}, max abs", float(np.abs(
            got[i].numpy() - np.asarray(want[i])).max()), budget)
    assert float(got[0].std()) > 0.01


def test_sample_merge_modes_agree_with_each_other(scene):
    """The partner mode is the no-merge draws merged with the partner; with
    the CDF source as partner (the TPU's ``s_m = -1``) it is, bit for bit,
    the function written out on its own: the 0-prepended sequential CDF,
    masked max/min brackets and the rank merge."""
    _, _, t, mids, occ, u = _chunk_inputs(scene)
    mids, occ, u, t = (torch.as_tensor(x) for x in (mids, occ, u, t))
    mids = mids.contiguous()
    drawn = trm.sample_merge(mids, occ, u, None)
    assert drawn.shape == (CHUNK, N_SAMPLES)
    assert bool((drawn[:, 1:] >= drawn[:, :-1]).all())
    torch.testing.assert_close(trm.sample_merge(mids, occ, u, t),
                               merge_sorted(t, drawn), rtol=0, atol=0)
    g = torch.Generator().manual_seed(3)
    w = torch.rand(t.shape, generator=g) ** 3
    w[::3] = 0.0
    u8 = torch.sort(torch.rand(CHUNK, 8, generator=g), -1).values
    fine = _sample_merge_written_out(t, w, u8)
    torch.testing.assert_close(trm.sample_merge(t, w, u8, t), fine, rtol=0,
                               atol=0)


def test_sample_merge_no_merge_is_sample_occupied_bit_for_bit(scene):
    """The occupancy render's two routes draw the same depths: the kernel
    path's ``sample_merge`` without merge and the reference path's
    :func:`sample_occupied`, on the same draws (one CDF helper)."""
    _, _, _, mids, occ, u = _chunk_inputs(scene)
    mids, occ, u = (torch.as_tensor(x) for x in (mids, occ, u))
    torch.testing.assert_close(trm.sample_merge(mids, occ, u, None),
                               tocc.sample_occupied(u, mids, occ), rtol=0,
                               atol=0)


@pytest.mark.parametrize("mode", ["no_merge", "partner"])
def test_sample_merge_reads_the_probe_bins_as_one_row(scene, mode):
    """``occupancy_along_rays`` gives the probe-bin centres as one row
    broadcast to every ray (row stride 0); the chunk takes it without a
    copy and draws the bits of the copied source."""
    o, d, t, _, _, u = (torch.as_tensor(x) for x in _chunk_inputs(scene))
    mids, occ = tocc.occupancy_along_rays(o, d, torch.as_tensor(
        scene["grid"]), NEAR, FAR, N_PROBE)
    assert mids.stride() == (0, 1)
    assert trm._cdf_source_stride(mids, CHUNK, N_PROBE) == 0
    assert trm._cdf_source_stride(mids.contiguous(), CHUNK, N_PROBE) == \
        N_PROBE
    with pytest.raises(ValueError, match="contiguous"):
        trm._cdf_source_stride(torch.zeros(N_PROBE, CHUNK).T, CHUNK,
                               N_PROBE)
    mp = None if mode == "no_merge" else t
    torch.testing.assert_close(trm.sample_merge(mids, occ, u, mp),
                               trm.sample_merge(mids.contiguous(), occ, u,
                                                mp), rtol=0, atol=0)
    tp = trm.pack_mlp_params(params_from_jax(scene["pf"], "cpu"),
                             JAX_CFG.mlp, 10, 4)
    one_row, copied = (trm.fused_render_chunk(
        tp, o, d, None, white_background=True,
        sample_inputs=(src, occ, u, mp)) for src in (mids, mids.contiguous()))
    for a, b in zip(one_row, copied):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["no_merge", "partner"])
def test_fused_train_chunk_takes_the_four_tuple(scene, mode):
    """The training pass samples in the same two modes: the 4-tuple gives
    the pass on the depths sample_merge draws, bit for bit."""
    o, d, t, mids, occ, u = (torch.as_tensor(x)
                             for x in _chunk_inputs(scene))
    mp = None if mode == "no_merge" else t
    packed = trm.pack_mlp_params(params_from_jax(scene["pf"], "cpu"),
                                 JAX_CFG.mlp, 10, 4)
    target = torch.full((CHUNK, 3), 0.5)
    got = trm.fused_train_chunk(packed, o, d, None, target,
                                white_background=True,
                                sample_inputs=(mids, occ, u, mp))
    want = trm.fused_train_chunk(
        packed, o, d, trm.sample_merge(mids.contiguous(), occ, u, mp),
        target, white_background=True)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(tengine.tree_leaves(got[3]), tengine.tree_leaves(want[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got[2].shape == (CHUNK, N_SAMPLES + (0 if mp is None else 8))


def _sample_merge_written_out(cp, w, u):
    """``sample_merge_plain`` with the CDF source as partner, written out:
    the total and the CDF summed bin after bin in float32 with a 0 in
    front, masked max/min brackets over the edge-padded midpoints, then
    each depth's slot by counting the other array."""
    s_c = cp.shape[1]
    inf = float("inf")
    wp = w + float(np.float32(1e-5))
    tot = torch.zeros_like(wp[:, 0])
    for i in range(s_c):
        tot = tot + wp[:, i]
    pdf = wp / tot[:, None]
    cdf = [torch.zeros_like(tot)]
    for i in range(s_c):
        cdf.append(cdf[-1] + pdf[:, i])
    cdf = torch.stack(cdf, 1)                               # [R, s_c + 1]
    mids = 0.5 * (cp[:, :-1] + cp[:, 1:])
    mids = torch.cat([mids, mids[:, -1:], mids[:, -1:]], dim=1)
    le = cdf[:, None, :] <= u[:, :, None]
    cdf_below = torch.where(le, cdf[:, None, :], -inf).amax(dim=2)
    cdf_above = torch.where(le, inf, cdf[:, None, :]).amin(dim=2)
    cdf_above = torch.where(cdf_above == inf, cdf[:, -1:], cdf_above)
    bin_below = torch.where(le, mids[:, None, :], -inf).amax(dim=2)
    bin_above = torch.where(le, inf, mids[:, None, :]).amin(dim=2)
    bin_above = torch.where(bin_above == inf, mids[:, -1:], bin_above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < float(np.float32(1e-5)),
                        torch.ones_like(denom), denom)
    fine = bin_below + (u - cdf_below) / denom * (bin_above - bin_below)
    n = u.shape[1]
    rank_c = torch.arange(s_c) + (fine[:, None, :] < cp[:, :, None]).sum(2)
    rank_f = torch.arange(n) + (cp[:, None, :] <= fine[:, :, None]).sum(2)
    out = torch.zeros((cp.shape[0], s_c + n), dtype=cp.dtype)
    out.scatter_(1, rank_c, cp)
    out.scatter_(1, rank_f, fine)
    return out


# ------------------------------------------------------------ whole renders


def _jax_occ(scene, cfg, grid, **kw):
    return jocc.render_image_batch_occ(
        scene["pf"], tuple(jnp.asarray(x) for x in _rays(scene)),
        jnp.asarray(grid), scene["key"], cfg, near=NEAR, far=FAR,
        n_samples=N_SAMPLES, n_probe=N_PROBE, ray_chunks=CHUNK, **kw)


def _port_occ(scene, cfg, grid, **kw):
    return tocc.render_image_batch_occ(
        params_from_jax(scene["pf"], "cpu"),
        tuple(torch.as_tensor(x) for x in _rays(scene)),
        torch.as_tensor(grid), [torch.as_tensor(u) for u in scene["draws"]],
        cfg, near=NEAR, far=FAR, n_samples=N_SAMPLES, n_probe=N_PROBE,
        ray_chunks=CHUNK, **kw)


def _assert_render(label, got, want, atol):
    assert got["image"].shape == (B, H, W, 3)
    assert got["depth"].shape == (B, H, W)
    for k in ("image", "depth"):
        _report(f"{label} {k}, max abs", float(np.abs(
            got[k].numpy() - np.asarray(want[k])).max()), atol[k])
    assert float(got["image"].std()) > 0.01


def test_render_image_batch_occ_kernel_path_matches_jax(scene):
    trm.reset_launch_counts()
    got = _port_occ(scene, _port_cfg(JAX_CFG), scene["grid"])
    want = _jax_occ(scene, JAX_CFG, scene["grid"])
    _assert_render("occupancy render, kernel path", got, want,
                   {"image": IMAGE_ATOL, "depth": DEPTH_ATOL})
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_render_image_batch_occ_reference_path_matches_jax(scene):
    jcfg = jengine.NeRFConfig(**{**JAX_CFG.__dict__, "use_pallas": False})
    got = _port_occ(scene, _port_cfg(JAX_CFG, False), scene["grid"])
    want = _jax_occ(scene, jcfg, scene["grid"])
    _assert_render("occupancy render, reference path", got, want,
                   {"image": REF_ATOL, "depth": REF_ATOL})


def test_render_image_batch_occ_int8_matches_jax(scene):
    """The int8 tier over the grid from JAX's own int8 fine dict, calibrated
    on the fine model's points along the rays."""
    packed = jax_pack(scene["pf"], JAX_CFG.mlp, 10, 4)
    o, d, t = scene["o"], scene["d"], scene["t"]
    pos = o[:, None] + d[:, None] * t[..., None]
    enc = jax_encode(jnp.asarray(pos.reshape(-1, 3)),
                     jnp.asarray(np.broadcast_to(d[:, None], pos.shape)
                                 .reshape(-1, 3)), 10, 4)
    last_skip = (JAX_CFG.n_layers - 1) in set(JAX_CFG.mlp.skip_indices())
    q = jq.quantize_packed(packed, jq.collect_act_amax(packed, enc,
                                                       JAX_CFG.mlp, last_skip),
                           JAX_CFG.mlp, last_skip)
    want = _jax_occ(scene, JAX_CFG, scene["grid"], packed_q=q)
    got = _port_occ(scene, _port_cfg(JAX_CFG), scene["grid"],
                    packed_q=quantized_from_jax(jax.tree.map(np.array, q),
                                                "cpu"))
    _assert_render("int8 occupancy render", got, want,
                   {"image": IMAGE_ATOL, "depth": DEPTH_ATOL})
    bf16 = _port_occ(scene, _port_cfg(JAX_CFG), scene["grid"])
    assert not np.array_equal(bf16["image"].numpy(), got["image"].numpy())


# ------------------------------------------------------- the model and CLI


def _save_jax_checkpoint(path, cfg, seed=3):
    state = jengine.init_train_state(jax.random.PRNGKey(seed), cfg,
                                     jengine.make_optimizer("adam"))
    jckpt.save_model(str(path), state, cfg)
    return state


def test_nerf_bake_and_render_occupancy_on_a_jax_checkpoint(scene, tmp_path):
    """NeRF.bake_occupancy then render_occupancy (device cpu) from a JAX
    checkpoint; the render against JAX's kernel path on the port's grid."""
    state = _save_jax_checkpoint(tmp_path, JAX_CFG)
    nerf = NeRF(model_path=str(tmp_path))
    nerf.compile(batch_size=B, image_height=H, image_width=W,
                 ray_chunks=CHUNK, white_background=True, is_training=False,
                 device="cpu")
    with pytest.raises(RuntimeError, match="bake_occupancy"):
        nerf.render_occupancy(_rays(scene))
    coords = tocc.grid_coordinates(GRID, device="cpu").reshape(-1, 3)
    sigma = tocc.model_density_fn(nerf.fine_params, nerf.config)(coords)
    thr = float(torch.quantile(sigma, 0.7))
    grid = nerf.bake_occupancy(GRID, sigma_threshold=thr, dilate=1)
    assert grid.shape == (GRID,) * 3 and 0.05 < float(grid.mean()) < 0.95
    draws = [torch.as_tensor(u) for u in scene["draws"]]
    got = nerf.render_occupancy(_rays(scene), fine_draws=draws, near=NEAR,
                                far=FAR, n_samples=N_SAMPLES,
                                n_probe=N_PROBE)
    fine = jax.tree.map(np.asarray, state.fine_params)
    want = jocc.render_image_batch_occ(
        fine, tuple(jnp.asarray(x) for x in _rays(scene)),
        jnp.asarray(grid.numpy()), scene["key"], JAX_CFG, near=NEAR,
        far=FAR, n_samples=N_SAMPLES, n_probe=N_PROBE, ray_chunks=CHUNK)
    _assert_render("NeRF.render_occupancy", got, want,
                   {"image": IMAGE_ATOL, "depth": DEPTH_ATOL})


@pytest.mark.parametrize("quantized", [False, True])
def test_inference_cli_occupancy_writes_both_gifs(tmp_path, quantized):
    model_dir = tmp_path / "model"
    cfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                             dense_units=256, skip_layer=4)
    _save_jax_checkpoint(model_dir, cfg)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "keras_nerf_tpu_torch.inference",
         "--model_dirs", str(model_dir), "--img_wh", "16",
         "--output_freq", "180", "--ray_chunks", "256", "--white_bg",
         "--occupancy_grid", "16", "--occupancy_samples", "16",
         "--sigma_threshold", "0.0", "--device", "cpu",
         "--output_dir", str(out), "--name", "orbit"]
        + (["--quantized_render"] if quantized else []),
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Baked 16^3 occupancy grid" in proc.stderr
    assert ("int8 weights calibrated" in proc.stderr) == quantized
    for name in ("orbit.gif", "orbit_depth.gif"):
        with Image.open(out / name) as gif:
            assert gif.n_frames == 2 and gif.size == (16, 16), name
