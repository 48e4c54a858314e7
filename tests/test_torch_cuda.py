"""The CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test skips (the ``cuda_device`` fixture decides at run
time, so every process collects the same tests). Tolerances as in
``chip_smoke.py``: sample_merge 1e-6 (same float32 operations in the same
order), ray_march_mlp 3e-2 (bf16 activations rounded after sums taken in
another order), ray_march_quadrature 1e-4 (float32 scan order). The
training kernels, on the same inputs as their plain versions:

* bf16 arrays (kept activations, cotangents) are held relative to their
  largest magnitude: 1e-2 where one rounding can flip (one bf16 step is
  at most 2^-7 of a value), 3e-2 where flips compound through the layers;
  and by the norm of the difference relative to their own norm, 1e-2, so
  that garbled small entries cannot hide under the largest;
* float32 weight gradients by relative norm 1e-3 and relative max 1e-2:
  the same bf16 operands summed over the points in another order.

``apply_mlp`` (T5) is held as ``ray_march_mlp`` is, and the output-head
mode of ``mlp_backward`` (T6's head) as its quadrature mode. T6 whole
(``fused_mlp_backward``: recompute, dX chain, dW) is held as the dX chain's
cotangents, relative max 3e-2 and relative norm 1e-2: the recompute's and
the chain's bf16 flips compound into the first trunk layers' gradients
(about 5e-3 relative norm at 8 x 256 on this test's loss).

``ray_march_mlp_int8`` (T4) is held at 1e-3: its int8 codes and int32 sums
are exact and its float32 epilogue runs in the plain version's order, so
only ``expf`` in the sigmoid differs (~1e-7), unless an encoding lane that
the plain version's float64 FMA emulation double-rounds moves one code by
one step. ``mma_ceiling`` (T7) is held as ``ray_march_mlp``, relative to its
largest output, 3e-2.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import functools
import math

import pytest
import torch

from keras_nerf_tpu_torch.inference import ORBIT, render_orbit
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRF, NeRFConfig, engine, init_mlp
from keras_nerf_tpu_torch.ops import sorted_uniforms

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _chunk(device, r=512, s_c=64, n_fine=128, n_layers=8, skip=4, seed=0):
    cfg = NeRFConfig(n_coarse=s_c, n_fine=n_fine, n_layers=n_layers,
                     skip_layer=skip)
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_mlp(g, cfg.mlp, cfg.in_xyz, cfg.in_dir)
    packed = trm.pack_mlp_params(params, cfg.mlp, 10, 4)
    o = torch.zeros(r, 3, device=device)
    o[:, 2] = 4.0
    d = torch.nn.functional.normalize(
        torch.randn(r, 3, generator=g, device=device), dim=-1)
    t = torch.sort(torch.rand(r, s_c, generator=g, device=device) * 4 + 2,
                   dim=-1).values
    u = sorted_uniforms(g, (r,), n_fine)
    return packed, o, d, t, u


@pytest.mark.parametrize("n_layers,skip", [(8, 4), (3, 1)])
@pytest.mark.parametrize("sigma_only", [True, False])
def test_ray_march_mlp_matches_plain(cuda_device, n_layers, skip,
                                     sigma_only):
    packed, o, d, t, _ = _chunk(cuda_device, n_layers=n_layers, skip=skip)
    base, slope, masks = trm.ray_encoding_coeffs(o, d, 10, 4)
    before = trm.ray_march_mlp.launches
    got = trm.ray_march_mlp(packed, base, slope, t, masks,
                            sigma_only=sigma_only)
    torch.cuda.synchronize()
    assert trm.ray_march_mlp.launches == before + 1
    want = trm.ray_march_mlp_plain(packed, base, slope, t, masks,
                                   sigma_only=sigma_only)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 3e-2


def _fwd_inputs(device, units, rays, samples, seed=7, n_layers=8, skip=4):
    """Seeded weights of an ``n_layers``-layer MLP (skip ``skip``) of width
    ``units`` (a fog: sigma bias +1, so every head and every layer carries
    a value), random rays' encoding coefficients and depths, and the same
    points encoded outside the kernel for the input mode."""
    cfg = NeRFConfig(dense_units=units, n_layers=n_layers, skip_layer=skip)
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_mlp(g, cfg.mlp, cfg.in_xyz, cfg.in_dir)
    params["sigma"]["bias"] += 1.0
    packed = trm.pack_mlp_params(params, cfg.mlp, 10, 4)
    o = torch.zeros(rays, 3, device=device)
    o[:, 2] = 4.0
    d = torch.nn.functional.normalize(
        torch.randn(rays, 3, generator=g, device=device), dim=-1)
    t = torch.sort(torch.rand(rays, samples, generator=g, device=device) * 4
                   + 2, dim=-1).values
    base, slope, masks = trm.ray_encoding_coeffs(o, d, 10, 4)
    enc = trm.encode_block128(*trm.ray_points(o, d, t))
    return cfg, packed, (base, slope, t, masks), enc


def _forward(mode, cfg, packed, rm_args, enc, plain=False):
    """One call of ray_march_mlp.cu's ``mode`` (or its plain version):
    ``(outputs, stash or None)``."""
    p, u, n = enc.shape[0], cfg.dense_units, cfg.n_layers
    if mode in ("sigma_only", "full", "train"):
        f = trm.ray_march_mlp_plain if plain else trm.ray_march_mlp
        stash = (trm.alloc_stash(p, u, n, enc.device) if mode == "train"
                 else None)
        return f(packed, *rm_args, sigma_only=mode == "sigma_only",
                 stash=stash), stash
    f = trm.apply_mlp_plain if plain else trm.apply_mlp
    stash = (trm.alloc_stash(p, u, n, enc.device, enc=enc)
             if mode == "input_stash" else None)
    return f(packed, enc, stash=stash), stash


# (units, rays, samples[, layers]): no point; one block's 50 rows (a ragged
# tile that TMA and the prologue fill with zeros, no store past P); 17 past
# a whole number of tiles; u = 512 (64-point tiles, each warpgroup half the
# columns); u = 768 (each half in passes of 128 columns, ROADMAP C10); the
# training chunk's fine launch; and the streamed route (ROADMAP C12): u =
# 1024 and 2048, and 40 layers of 256.
_FWD_EDGES = {"empty": (256, 0, 64), "ragged_50": (256, 5, 10),
              "ragged_8192_plus_17": (256, 8209, 1),
              "units_512": (512, 17, 241), "units_768": (768, 17, 241),
              "fine_chunk_2048x192": (256, 2048, 192),
              "units_1024": (1024, 17, 241), "units_2048": (2048, 17, 241),
              "layers_40": (256, 17, 241, 40)}
_FWD_MODES = ("sigma_only", "full", "train", "input", "input_stash")


@pytest.mark.parametrize("mode", _FWD_MODES)
@pytest.mark.parametrize("case", sorted(_FWD_EDGES))
def test_forward_matches_plain_at_edge_shapes(cuda_device, case, mode):
    """Every mode of ray_march_mlp.cu (sigma-only, full, train; apply_mlp
    without and with its stash) against its plain version, each run twice
    with identical bits; budgets as above: outputs 3e-2, kept activations
    relative max 3e-2 and relative norm 1e-2."""
    units, rays, samples, *layers = _FWD_EDGES[case]
    cfg, packed, rm_args, enc = _fwd_inputs(cuda_device, units, rays,
                                            samples, n_layers=(layers or
                                                               [8])[0])
    kernel = trm.apply_mlp if mode.startswith("input") else trm.ray_march_mlp
    before = kernel.launches
    runs = [_forward(mode, cfg, packed, rm_args, enc) for _ in range(2)]
    want, want_s = _forward(mode, cfg, packed, rm_args, enc, plain=True)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    (got, got_s), (again, again_s) = runs
    assert got.shape == want.shape == (
        (rays * samples,) if mode == "sigma_only" else (rays * samples, 4))
    assert torch.equal(got, again), case
    if got.numel():
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 3e-2, case
    if want_s is None:
        return
    names = ["features", "rf"] + (["enc"] if mode == "train" else [])
    pairs = [(got_s[k], again_s[k], want_s[k]) for k in names]
    pairs += list(zip(got_s["h"], again_s["h"], want_s["h"]))
    for x, y, z in pairs:
        assert torch.equal(x, y), case
        if x.numel():
            _assert_bf16_close(x, z, 3e-2, case)


def test_forward_refuses_other_widths_before_launching(cuda_device,
                                                      monkeypatch):
    # 384, outside the JAX package's envelope (384 / 2 is not a multiple of
    # 128): pack_mlp_params refuses it too, so let it pack one.
    monkeypatch.setattr(trm, "kernel_supported", lambda *a: True)
    cfg, packed, rm_args, enc = _fwd_inputs(cuda_device, 384, 4, 16)
    before = (trm.ray_march_mlp.launches, trm.apply_mlp.launches)
    with pytest.raises(ValueError, match="384"):
        trm.ray_march_mlp(packed, *rm_args)
    with pytest.raises(ValueError, match="384"):
        trm.apply_mlp(packed, enc)
    assert (trm.ray_march_mlp.launches, trm.apply_mlp.launches) == before


# (rays, samples) of the persistent route's edges: one tile; 305 points, not
# a multiple of 128 (the last tile's rows past P); 25 tiles, fewer blocks
# than SMs; the 800^2 render's chunk, 36 tiles a block and more.
_PERSIST = {"one_tile": (2, 64), "ragged_305": (5, 61),
            "fewer_tiles_than_sms": (50, 64), "chunk_800_3200x192": (3200, 192)}


@pytest.mark.parametrize("n_layers,skip", [(8, 4), (3, 1)])
@pytest.mark.parametrize("sigma_only", [True, False])
@pytest.mark.parametrize("case", sorted(_PERSIST))
def test_persistent_route_gives_the_resident_bits(cuda_device, case,
                                                  sigma_only, n_layers, skip):
    """The no-grad modes at u = 256 take the persistent kernel; the resident
    kernel's C entry on the same inputs gives the same bits (the same bf16
    operands, float32 sums in the same k order, the same epilogue and heads'
    operations), and both are held against the plain version at 3e-2."""
    rays, samples = _PERSIST[case]
    cfg, packed, rm_args, _ = _fwd_inputs(cuda_device, 256, rays, samples,
                                          n_layers=n_layers, skip=skip)
    assert trm.ray_march_mlp_plan(256, n_layers, no_grad=True)["route"] == (
        "persistent")
    before = dict(trm.ray_march_mlp.routes)
    got = trm.ray_march_mlp(packed, *rm_args, sigma_only=sigma_only)
    want = trm.ray_march_mlp(packed, *rm_args, sigma_only=sigma_only,
                             route="resident")
    plain = trm.ray_march_mlp_plain(packed, *rm_args, sigma_only=sigma_only)
    torch.cuda.synchronize()
    moved = {k: v - before.get(k, 0)
             for k, v in trm.ray_march_mlp.routes.items()}
    assert {k: v for k, v in moved.items() if v} == {"persistent": 1,
                                                     "resident": 1}
    assert got.shape == want.shape == plain.shape
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), case
    assert float((got - plain).abs().max()) <= 3e-2, case


def test_route_counter_keeps_train_mode_and_apply_mlp_off_the_persistent_route(
        cuda_device):
    """The train mode (a stash) and ``apply_mlp`` keep their resident route
    at u = 256; a no-grad call takes the persistent one."""
    cfg, packed, rm_args, enc = _fwd_inputs(cuda_device, 256, 17, 64)
    p, u, n = enc.shape[0], cfg.dense_units, cfg.n_layers
    trm.reset_launch_counts()
    trm.ray_march_mlp(packed, *rm_args,
                      stash=trm.alloc_stash(p, u, n, cuda_device))
    trm.apply_mlp(packed, enc)
    trm.apply_mlp(packed, enc, stash=trm.alloc_stash(p, u, n, cuda_device,
                                                     enc=enc))
    torch.cuda.synchronize()
    assert dict(trm.ray_march_mlp.routes) == {"resident": 1}
    assert dict(trm.apply_mlp.routes) == {"resident": 2}
    trm.ray_march_mlp(packed, *rm_args, sigma_only=True)
    trm.ray_march_mlp(packed, *rm_args)
    torch.cuda.synchronize()
    assert dict(trm.ray_march_mlp.routes) == {"resident": 1, "persistent": 2}
    assert trm.ray_march_mlp.launches == 3 and trm.apply_mlp.launches == 2


# The register route (k = ceil(S / 32) samples a lane), its edges, and the
# windowed route past 256 samples.
QUAD_S = [1, 8, 31, 32, 33, 64, 192, 256, 257, 1024]


@pytest.mark.parametrize("s", QUAD_S)
@pytest.mark.parametrize("sigma_only,white_bg", [(True, False),
                                                 (False, True),
                                                 (False, False)])
def test_ray_march_quadrature_matches_plain(cuda_device, sigma_only,
                                            white_bg, s):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    r = 300
    t = torch.sort(torch.rand(r, s, generator=g, device=cuda_device) * 4 + 2,
                   dim=-1).values
    rgbs = torch.rand(r, s, 4, generator=g, device=cuda_device)
    rgbs[..., 3] *= 5
    inp = rgbs[..., 3].contiguous() if sigma_only else rgbs
    for emit in (True, False):
        got = trm.ray_march_quadrature(inp, t, white_bg, sigma_only, emit)
        again = trm.ray_march_quadrature(inp, t, white_bg, sigma_only, emit)
        want = trm.ray_march_quadrature_plain(inp, t, white_bg, sigma_only,
                                              emit)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, again):
            if b is None:
                assert a is None and c is None
                continue
            assert float((a - b).abs().max()) <= 1e-4
            assert torch.equal(a, c)


@pytest.mark.parametrize("sigma_only", [True, False])
def test_ray_march_quadrature_takes_zero_samples(cuda_device, sigma_only):
    """No sample: the background alone, as the plain version gives it."""
    t = torch.empty(64, 0, device=cuda_device)
    inp = t if sigma_only else torch.empty(64, 0, 4, device=cuda_device)
    got = trm.ray_march_quadrature(inp, t, True, sigma_only, True)
    want = trm.ray_march_quadrature_plain(inp, t, True, sigma_only, True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def _merge_weights(kind: str, r: int, s_c: int, g) -> torch.Tensor:
    """Bin weights for sample_merge: ``cubed`` (uniform cubed), ``occupancy``
    (0/1, every fifth ray empty), ``heavy`` (log-normal with sigma 8, half
    the bins zeroed: a trained coarse pass's surface bins) or ``one bin``
    (all of each ray's mass in one bin)."""
    dev = g.device
    if kind == "cubed":
        return torch.rand(r, s_c, generator=g, device=dev) ** 3
    if kind == "occupancy":
        w = (torch.rand(r, s_c, generator=g, device=dev) > 0.6).float()
        w[::5] = 0.0
        return w
    if kind == "heavy":
        w = torch.exp(8.0 * torch.randn(r, s_c, generator=g, device=dev))
        return torch.where(torch.rand(r, s_c, generator=g, device=dev) < 0.5,
                           0.0, w)
    w = torch.zeros(r, s_c, device=dev)
    w[torch.arange(r, device=dev),
      torch.randint(0, s_c, (r,), generator=g, device=dev)] = 1.0
    return w


@pytest.mark.parametrize("mode", ["coarse", "none", "partner"])
@pytest.mark.parametrize("weights", ["cubed", "heavy", "one bin"])
@pytest.mark.parametrize("s_c,n_fine", [(64, 128), (24, 16)])
def test_sample_merge_matches_plain(cuda_device, s_c, n_fine, weights, mode):
    _, _, _, t, u = _chunk(cuda_device, s_c=s_c, n_fine=n_fine)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    w = _merge_weights(weights, t.shape[0], s_c, g)
    mp = {"coarse": t, "none": None,
          "partner": torch.sort(torch.rand(t.shape, generator=g,
                                           device=cuda_device) * 4 + 2,
                                dim=-1).values}[mode]
    got = trm.sample_merge(t, w, u, mp)
    want = trm.sample_merge_plain(t, w, u, mp)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-6
    assert bool((got[:, 1:] >= got[:, :-1]).all())


def test_wrappers_raise_on_bad_inputs(cuda_device):
    packed, o, d, t, u = _chunk(cuda_device, r=64)
    with pytest.raises(TypeError):
        trm.sample_merge(t.double(), t.double(), u.double(), t.double())
    with pytest.raises(ValueError):
        trm.sample_merge(t[:, ::2], t[:, ::2], u, t)   # not contiguous


def test_render_path_launches_every_kernel(cuda_device):
    nerf = NeRF(config=NeRFConfig(n_layers=8)).compile(
        image_height=64, image_width=64, ray_chunks=1024,
        white_background=True, device="cuda", seed=0)

    trm.reset_launch_counts()
    images, depths = render_orbit(nerf, [0.0, 90.0], img_wh=64, **ORBIT)
    chunks = 2 * 64 * 64 // 1024
    assert [k.launches for k in trm.KERNELS] == [chunks, 2 * chunks,
                                                 2 * chunks, 0, 0, 0, 0, 0]
    assert images.shape == (2, 64, 64, 3)
    assert (images >= 0).all() and (images <= 1).all()


def _train_inputs(device, r=512, s=64, n_layers=8, skip=4, seed=3):
    """A fog (sigma bias 1) over random rays, with random targets: every
    head and every layer gets a non-trivial cotangent."""
    cfg = NeRFConfig(n_layers=n_layers, skip_layer=skip)
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_mlp(g, cfg.mlp, cfg.in_xyz, cfg.in_dir)
    params["sigma"]["bias"] += 1.0
    packed = trm.pack_mlp_params(params, cfg.mlp, 10, 4)
    o = torch.zeros(r, 3, device=device)
    o[:, 2] = 4.0
    d = torch.nn.functional.normalize(
        torch.randn(r, 3, generator=g, device=device), dim=-1)
    t = torch.sort(torch.rand(r, s, generator=g, device=device) * 4 + 2,
                   dim=-1).values
    target = torch.rand(r, 3, generator=g, device=device)
    base, slope, masks = trm.ray_encoding_coeffs(o, d, 10, 4)
    return cfg, packed, base, slope, t, masks, target


def _rel_max(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _assert_bf16_close(got, want, rel_max, label=""):
    assert _rel_max(got, want) <= rel_max, label
    got, want = got.float(), want.float()
    assert float((got - want).norm() / want.norm().clamp_min(1e-30)) <= 1e-2, \
        label


def _plain_chain(cfg, packed, base, slope, t, masks, target):
    """The plain forward, quadrature and backward of one sub-launch."""
    r, s = t.shape
    stash = trm.alloc_stash(r * s, cfg.dense_units, cfg.n_layers, t.device)
    rgbs = trm.ray_march_mlp_plain(packed, base, slope, t, masks, stash=stash)
    quad = trm.ray_march_quadrature_plain(
        rgbs.reshape(r, s, 4), t, True, False, True, target=target,
        loss_scale=2.0 / (3 * r))
    cots = trm.mlp_backward_plain(quad[3], quad[4], packed, stash)
    return stash, rgbs, quad, cots


@pytest.mark.parametrize("n_layers,skip", [(8, 4), (3, 1)])
def test_ray_march_mlp_train_mode_matches_plain(cuda_device, n_layers, skip):
    cfg, packed, base, slope, t, masks, _ = _train_inputs(
        cuda_device, n_layers=n_layers, skip=skip)
    r, s = t.shape
    stash_k = trm.alloc_stash(r * s, 256, n_layers, cuda_device)
    stash_p = trm.alloc_stash(r * s, 256, n_layers, cuda_device)
    got = trm.ray_march_mlp(packed, base, slope, t, masks, stash=stash_k)
    want = trm.ray_march_mlp_plain(packed, base, slope, t, masks,
                                   stash=stash_p)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 3e-2
    for name in ("enc", "features", "rf"):
        _assert_bf16_close(stash_k[name], stash_p[name], 3e-2, name)
    for i in range(n_layers):
        _assert_bf16_close(stash_k["h"][i], stash_p["h"][i], 3e-2, i)


# k = 3, 4, 5 and 7 samples a lane (the occupancy-train fine pass runs
# 128 samples, k = 4). Past 1024 samples the with_grad mode keeps a carry a
# window in shared memory (ROADMAP C14): 4, 4 and 15 carries.
@pytest.mark.parametrize("s", QUAD_S + [96, 128, 160, 224, 1025, 1088, 4096])
@pytest.mark.parametrize("white_bg", [True, False])
def test_ray_march_quadrature_with_grad_matches_plain(cuda_device, white_bg,
                                                      s):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    r = 300
    t = torch.sort(torch.rand(r, s, generator=g, device=cuda_device) * 4 + 2,
                   dim=-1).values
    rgbs = torch.rand(r, s, 4, generator=g, device=cuda_device)
    rgbs[..., 3] *= 3
    rgbs[::7, :, 3] = 0.0          # empty rays: white pixels clip at 1
    rgbs[1::7, :, 3] = 1e4         # saturated rays
    target = torch.rand(r, 3, generator=g, device=cuda_device)
    kw = dict(target=target, loss_scale=2.0 / (3 * r))
    got = trm.ray_march_quadrature(rgbs, t, white_bg, False, True, **kw)
    again = trm.ray_march_quadrature(rgbs, t, white_bg, False, True, **kw)
    want = trm.ray_march_quadrature_plain(rgbs, t, white_bg, False, True,
                                          **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want[:3]):
        assert float((a - b).abs().max()) <= 1e-4
    for a, b in zip(got[3:], want[3:]):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _assert_bf16_close(a, b, 1e-2)
    for a, c in zip(got, again):
        assert torch.equal(a, c)
    if s == 4096:
        over = 2 ** 19 + 1
        with pytest.raises(ValueError, match="ray_march_quadrature's "
                                             "with_grad mode takes at most "
                                             "524288 samples"):
            trm.ray_march_quadrature(
                torch.rand(1, over, 4, device=cuda_device),
                torch.linspace(2, 6, over, device=cuda_device)[None],
                white_bg, False, True, target=target[:1], loss_scale=1.0)


@pytest.mark.parametrize("n_layers,skip", [(8, 4), (3, 1)])
def test_mlp_backward_matches_plain(cuda_device, n_layers, skip):
    cfg, packed, base, slope, t, masks, target = _train_inputs(
        cuda_device, n_layers=n_layers, skip=skip)
    stash, _, quad, want = _plain_chain(cfg, packed, base, slope, t, masks,
                                        target)
    got = trm.mlp_backward(quad[3], quad[4], packed, stash)
    torch.cuda.synchronize()
    _assert_bf16_close(got["d_rf"], want["d_rf"], 1e-2, "d_rf")
    _assert_bf16_close(got["d_sf"], want["d_sf"], 1e-2, "d_sf")
    for i in range(n_layers):
        _assert_bf16_close(got["d_pre"][i], want["d_pre"][i], 3e-2, i)


def _bwd_inputs(device, points, units, seed=0, n_layers=8):
    """Seeded weights, a random stash (about half of each h_i above zero,
    so every relu mask is mixed) and the head inputs of both modes: the
    quadrature's ``d_rgb [P, 16]`` (columns 0..2) and ``d_sigma [P]``, and
    T6's ``g [P, 4]`` bf16 with ``y [P, 4]`` (sigmoid-like rgb, relu
    sigma with zeros)."""
    cfg = NeRFConfig(dense_units=units, n_layers=n_layers)
    g = torch.Generator(device=device).manual_seed(seed)
    packed = trm.pack_mlp_params(init_mlp(g, cfg.mlp, cfg.in_xyz,
                                          cfg.in_dir), cfg.mlp, 10, 4)
    stash = trm.alloc_stash(points, units, cfg.n_layers, device)
    for v in [stash["enc"], *stash["h"], stash["features"], stash["rf"]]:
        v.copy_(torch.randn(v.shape, generator=g, device=device))
    d_rgb = torch.zeros((points, trm.D_HEAD), dtype=torch.bfloat16,
                        device=device)
    d_rgb[:, :3] = torch.randn((points, 3), generator=g, device=device)
    d_sigma = torch.randn(points, generator=g, device=device).to(
        torch.bfloat16)
    out_g = torch.randn((points, 4), generator=g, device=device).to(
        torch.bfloat16)
    y = torch.rand((points, 4), generator=g, device=device)
    y[:, 3] = torch.relu(torch.randn(points, generator=g, device=device))
    return packed, stash, (d_rgb, d_sigma), (out_g, y)


def _assert_backward_close(got, want, n_layers, label):
    for name in ("d_rgb", "d_rf", "d_sf"):
        assert got[name].shape == want[name].shape, (label, name)
        _assert_bf16_close(got[name], want[name], 1e-2, (label, name))
    for i in range(n_layers):
        _assert_bf16_close(got["d_pre"][i], want["d_pre"][i], 3e-2,
                           (label, i))


# (units, points[, layers]): u = 512 (64-point tiles, each warpgroup half
# the columns), u = 768 (each half in passes of 128 columns from a ring of
# two 16 KB stages, ROADMAP C10), a point count 17 past a tile and one below
# a single tile (TMA's zero rows, no store past P), the training chunk's
# fine launch, and the streamed route (ROADMAP C12): u = 1024 and 2048, and
# 40 layers of 256.
_BWD_EDGES = {"units_512": (512, 4096 + 1), "units_768": (768, 4096 + 1),
              "ragged_8192_plus_17": (256, 8209),
              "ragged_50": (256, 50), "fine_chunk_2048x192": (256, 2048 * 192),
              "units_1024": (1024, 4096 + 1), "units_2048": (2048, 4096 + 1),
              "layers_40": (256, 4096 + 1, 40)}


@pytest.mark.parametrize("from_output", [False, True],
                         ids=["quadrature", "output_head"])
@pytest.mark.parametrize("case", sorted(_BWD_EDGES))
def test_mlp_backward_matches_plain_at_edge_shapes(cuda_device, case,
                                                   from_output):
    """Both modes against the plain version, each run twice with identical
    bits; budgets as the chain's tests above."""
    units, points, *layers = _BWD_EDGES[case]
    n_layers = (layers or [8])[0]
    packed, stash, quad_in, out_in = _bwd_inputs(cuda_device, points, units,
                                                 n_layers=n_layers)
    a, b = out_in if from_output else quad_in
    want = trm.mlp_backward_plain(a, b, packed, stash,
                                  from_output=from_output)
    runs = [trm.mlp_backward(a, b, packed, stash, from_output=from_output)
            for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip(*(engine.tree_leaves(r) for r in runs)):
        assert torch.equal(x, y), case
    _assert_backward_close(runs[0], want, n_layers, case)


def test_mlp_backward_repeats_bit_for_bit(cuda_device):
    """The quadrature mode on the real chain's cotangents, twice: no
    atomics and a fixed k order give identical bits."""
    cfg, packed, base, slope, t, masks, target = _train_inputs(cuda_device)
    stash, _, quad, _ = _plain_chain(cfg, packed, base, slope, t, masks,
                                     target)
    runs = [trm.mlp_backward(quad[3], quad[4], packed, stash)
            for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip(*(engine.tree_leaves(r) for r in runs)):
        assert torch.equal(x, y)


def test_mlp_backward_refuses_other_widths_before_launching(cuda_device,
                                                           monkeypatch):
    # 384, outside the JAX package's envelope: let pack_mlp_params pack it.
    monkeypatch.setattr(trm, "kernel_supported", lambda *a: True)
    packed, stash, (d_rgb, d_sigma), _ = _bwd_inputs(cuda_device, 64, 384)
    before = trm.mlp_backward.launches
    with pytest.raises(ValueError, match="384"):
        trm.mlp_backward(d_rgb, d_sigma, packed, stash)
    assert trm.mlp_backward.launches == before


# (40, 4): 53 weight arrays, more than one launch holds (ROADMAP C12).
@pytest.mark.parametrize("n_layers,skip", [(8, 4), (3, 1), (40, 4)])
def test_mlp_weight_grad_matches_plain_and_repeats_bit_for_bit(
        cuda_device, n_layers, skip):
    cfg, packed, base, slope, t, masks, target = _train_inputs(
        cuda_device, n_layers=n_layers, skip=skip)
    stash, _, _, cots = _plain_chain(cfg, packed, base, slope, t, masks,
                                     target)
    _assert_weight_grad_matches_plain_twice(packed, stash, cots)


def _assert_weight_grad_matches_plain_twice(packed, stash, cots):
    want = trm.mlp_weight_grad_plain(stash, cots, trm.zero_grads(packed))
    runs = [trm.mlp_weight_grad(stash, cots, trm.zero_grads(packed))
            for _ in range(2)]
    torch.cuda.synchronize()
    for (got, again, ref) in zip(*(engine.tree_leaves(x)
                                   for x in (*runs, want))):
        assert torch.equal(got, again)
        diff = got - ref
        assert float(diff.norm() / ref.norm().clamp_min(1e-30)) <= 1e-3
        assert _rel_max(got, ref) <= 1e-2


def _wg_edge_points(units):
    """A point count that splits into more than one slice and ends 17
    points past a stage boundary, inside the last slice."""
    points = 64 * 400 + 17
    plan = trm.weight_grad_plan(_wg_shapes(units), points)
    assert plan["slices"] > 1 and plan["bounds"][-1][1] == points
    return points


def _wg_inputs(device, points, units, seed=0):
    """Random bf16 stash and cotangents, zero where the training kernels
    write zeros (d_sf past column u, d_rgb past column 2)."""
    cfg = NeRFConfig(dense_units=units)
    g = torch.Generator(device=device).manual_seed(seed)
    packed = trm.pack_mlp_params(init_mlp(g, cfg.mlp, cfg.in_xyz,
                                          cfg.in_dir), cfg.mlp, 10, 4)
    stash = trm.alloc_stash(points, units, cfg.n_layers, device)
    cots = trm.alloc_cotangents(points, units, cfg.n_layers, device)
    for v in [stash["enc"], *stash["h"], stash["features"], stash["rf"],
              cots["d_rf"], cots["d_sf"], *cots["d_pre"]]:
        v.copy_(torch.randn(v.shape, generator=g, device=device))
    cots["d_sf"][:, units + 1:] = 0
    cots["d_rgb"] = torch.zeros((points, trm.D_HEAD), dtype=torch.bfloat16,
                                device=device)
    cots["d_rgb"][:, :3] = torch.randn((points, 3), generator=g,
                                       device=device)
    return packed, stash, cots


def _wg_shapes(units):
    packed, stash, cots = _wg_inputs(torch.device("cpu"), 1, units)
    return [(a.shape[1], g.shape[1], b is not None) for a, g, _, b in
            trm.weight_grad_tasks(stash, cots, trm.zero_grads(packed))]


@pytest.mark.parametrize("case", ["empty", "ragged_below_one_stage",
                                  "slices_plus_17", "units_512"])
def test_mlp_weight_grad_matches_plain_at_edge_shapes(cuda_device, case):
    """No points; fewer points than one 64-point stage (not a multiple of
    64); more than one slice, ending 17 points past a stage; and u =
    512, where d_sf is 528 wide (two 256 tiles and a 16-wide tail). Each
    is held as above and run twice with identical bits."""
    units = 512 if case == "units_512" else 256
    points = {"empty": 0, "ragged_below_one_stage": 50,
              "slices_plus_17": _wg_edge_points(256),
              "units_512": 4096 + 1}[case]
    _assert_weight_grad_matches_plain_twice(
        *_wg_inputs(cuda_device, points, units))


def test_default_train_step_runs_through_the_kernels(cuda_device):
    cfg = NeRFConfig(n_coarse=16, n_fine=16, n_layers=8,
                     white_background=True)
    nerf = NeRF(config=cfg).compile(
        optimizer="adam", image_height=32, image_width=32, ray_chunks=512,
        white_background=True, device="cuda", seed=0)
    assert engine.resolve_use_kernels(nerf.config, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    images = torch.rand(1, 32, 32, 4, generator=g, device=cuda_device)
    rays = (torch.zeros(1, 32, 32, 3, device=cuda_device) + torch.tensor(
                [0.0, 0.0, 4.0], device=cuda_device),
            torch.nn.functional.normalize(torch.randn(
                1, 32, 32, 3, generator=g, device=cuda_device), dim=-1),
            torch.sort(torch.rand(1, 32, 32, 16, generator=g,
                                  device=cuda_device) * 4 + 2, -1).values)
    trm.reset_launch_counts()
    metrics = nerf.train_step((images, rays))
    chunks = 32 * 32 // 512
    assert {k.name: k.launches for k in trm.KERNELS} == {
        "sample_merge": chunks, "ray_march_mlp": 2 * chunks,
        "ray_march_quadrature": 2 * chunks, "mlp_backward": 2 * chunks,
        "mlp_weight_grad": 2 * chunks, "apply_mlp": 0,
        "ray_march_mlp_int8": 0, "mma_ceiling": 0}
    assert all(map(math.isfinite, metrics.values()))
    assert metrics["coarse_grad_norm"] > 0 and metrics["fine_grad_norm"] > 0


def test_default_render_outside_the_kernel_envelope_raises(cuda_device):
    # 128 units do not fit the kernels; the card never gives way to the
    # float32 reference path unless use_kernels=False asks for it.
    nerf = NeRF(config=NeRFConfig(n_layers=2, dense_units=128)).compile(
        image_height=16, image_width=16, ray_chunks=256, device="cuda",
        seed=0)
    trm.reset_launch_counts()
    with pytest.raises(ValueError, match="kernels require"):
        render_orbit(nerf, [0.0], img_wh=16, **ORBIT)
    assert [k.launches for k in trm.KERNELS] == [0] * len(trm.KERNELS)


def _encoded_points(device, n_layers, skip, p=4096, seed=5):
    """Encoded points along random rays, a fog's weights and the output
    cotangent of an L1 loss of the rendered rays against random targets
    (the plain forward, ``render_rays`` and autograd): every column of the
    head sees a non-trivial value, with the signs a loss gives them."""
    from keras_nerf_tpu_torch.ops import render_rays

    r = p // 64
    cfg, packed, base, slope, t, masks, target = _train_inputs(
        device, r=r, n_layers=n_layers, skip=skip, seed=seed)
    o = torch.zeros(r, 3, device=device)
    o[:, 2] = 4.0
    g = torch.Generator(device=device).manual_seed(seed)
    d = torch.nn.functional.normalize(
        torch.randn(r, 3, generator=g, device=device), dim=-1)
    enc = trm.encode_block128(*trm.ray_points(o, d, t))
    y = trm.apply_mlp_plain(packed, enc).requires_grad_(True)
    image = render_rays(y[:, :3].reshape(r, 64, 3), y[:, 3].reshape(r, 64),
                        t, white_background=True).image
    (image - target).abs().mean().backward()
    return cfg, packed, enc, y.grad.to(torch.bfloat16)


@pytest.mark.parametrize("n_layers,skip", [(8, 4), (2, 1)])
def test_apply_mlp_and_its_stash_match_plain(cuda_device, n_layers, skip):
    cfg, packed, enc, _ = _encoded_points(cuda_device, n_layers, skip)
    p = enc.shape[0]
    before = trm.apply_mlp.launches
    got = trm.apply_mlp(packed, enc)
    stash_k = trm.alloc_stash(p, 256, n_layers, cuda_device, enc=enc)
    stash_p = trm.alloc_stash(p, 256, n_layers, cuda_device, enc=enc)
    got_s = trm.apply_mlp(packed, enc, stash=stash_k)
    want = trm.apply_mlp_plain(packed, enc)
    want_s = trm.apply_mlp_plain(packed, enc, stash=stash_p)
    torch.cuda.synchronize()
    assert trm.apply_mlp.launches == before + 2
    assert got.shape == (p, 4) and torch.equal(got, got_s)
    assert float((got - want).abs().max()) <= 3e-2
    assert float((got_s - want_s).abs().max()) <= 3e-2
    for name in ("features", "rf"):
        _assert_bf16_close(stash_k[name], stash_p[name], 3e-2, name)
    for i in range(n_layers):
        _assert_bf16_close(stash_k["h"][i], stash_p["h"][i], 3e-2, i)


@pytest.mark.parametrize("n_layers,skip", [(8, 4), (2, 1)])
def test_mlp_backward_output_head_mode_matches_plain(cuda_device, n_layers,
                                                     skip):
    cfg, packed, enc, cot = _encoded_points(cuda_device, n_layers, skip)
    p = enc.shape[0]
    stash = trm.alloc_stash(p, 256, n_layers, cuda_device, enc=enc)
    y = trm.apply_mlp_plain(packed, enc, stash=stash)
    got = trm.mlp_backward(cot, y, packed, stash, from_output=True)
    want = trm.mlp_backward_plain(cot, y, packed, stash, from_output=True)
    torch.cuda.synchronize()
    assert got["d_rgb"].shape == (p, trm.D_HEAD)
    _assert_bf16_close(got["d_rgb"], want["d_rgb"], 1e-2, "d_rgb")
    _assert_bf16_close(got["d_rf"], want["d_rf"], 1e-2, "d_rf")
    _assert_bf16_close(got["d_sf"], want["d_sf"], 1e-2, "d_sf")
    for i in range(n_layers):
        _assert_bf16_close(got["d_pre"][i], want["d_pre"][i], 3e-2, i)


def test_fused_mlp_backward_matches_plain_and_repeats_bit_for_bit(
        cuda_device):
    cfg, packed, enc, cot = _encoded_points(cuda_device, 8, 4)
    want = trm.fused_mlp_backward_plain(packed, enc, cot)
    runs = [trm.fused_mlp_backward(packed, enc, cot) for _ in range(2)]
    torch.cuda.synchronize()
    for got, again, ref in zip(*(engine.tree_leaves(x)
                                 for x in (*runs, want))):
        assert torch.equal(got, again)
        _assert_bf16_close(got, ref, 3e-2)


def test_callable_loss_step_runs_through_t5_and_t6(cuda_device):
    cfg = NeRFConfig(n_coarse=16, n_fine=16, n_layers=8,
                     white_background=True)
    nerf = NeRF(config=cfg).compile(
        optimizer="adam", loss=lambda y, p: (p - y).abs().mean(),
        image_height=32, image_width=32, ray_chunks=512,
        white_background=True, device="cuda", seed=0)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    images = torch.rand(1, 32, 32, 4, generator=g, device=cuda_device)
    rays = (torch.zeros(1, 32, 32, 3, device=cuda_device) + torch.tensor(
                [0.0, 0.0, 4.0], device=cuda_device),
            torch.nn.functional.normalize(torch.randn(
                1, 32, 32, 3, generator=g, device=cuda_device), dim=-1),
            torch.sort(torch.rand(1, 32, 32, 16, generator=g,
                                  device=cuda_device) * 4 + 2, -1).values)
    trm.reset_launch_counts()
    metrics = nerf.train_step((images, rays))
    chunks = 32 * 32 // 512
    assert {k.name: k.launches for k in trm.KERNELS} == {
        "sample_merge": 0, "ray_march_mlp": 0, "ray_march_quadrature": 0,
        "mlp_backward": 2 * chunks, "mlp_weight_grad": 2 * chunks,
        "apply_mlp": 4 * chunks, "ray_march_mlp_int8": 0, "mma_ceiling": 0}
    assert all(map(math.isfinite, metrics.values()))
    assert metrics["coarse_grad_norm"] > 0 and metrics["fine_grad_norm"] > 0


def _int8_chunk(device, n_layers, skip, r=512, s=64, seed=6):
    """A fog's weights quantized on the card from its own points (the
    ranges read from apply_mlp's stash), and the chunk's encoding
    coefficients."""
    from keras_nerf_tpu_torch.kernels import quantize as tq

    cfg, packed, base, slope, t, masks, _ = _train_inputs(
        device, r=r, s=s, n_layers=n_layers, skip=skip, seed=seed)
    enc = trm.encode_points(base, slope, t, masks).reshape(-1, 128)
    q = tq.quantize_packed(packed, tq.collect_act_amax(packed, enc, cfg.mlp),
                           cfg.mlp)
    return q, base, slope, t, masks


@pytest.mark.parametrize("n_layers,skip", [(8, 4), (3, 1), (3, 2)])
@pytest.mark.parametrize("sigma_only", [True, False])
def test_ray_march_mlp_int8_matches_plain(cuda_device, n_layers, skip,
                                          sigma_only):
    q, base, slope, t, masks = _int8_chunk(cuda_device, n_layers, skip)
    before = trm.ray_march_mlp_int8.launches
    got = trm.ray_march_mlp_int8(q, base, slope, t, masks,
                                 sigma_only=sigma_only)
    torch.cuda.synchronize()
    assert trm.ray_march_mlp_int8.launches == before + 1
    want = trm.ray_march_mlp_int8.plain(q, base, slope, t, masks,
                                        sigma_only=sigma_only)
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-3
    sigma = got if sigma_only else got[:, 3]
    assert float(sigma.max()) > 0.1          # the fog is not empty


@functools.lru_cache(maxsize=None)
def _int8_state_cpu(units, n_layers, skip, seed=6):
    """A fog's weights of width ``units``, quantized on the CPU from 512
    points of its own rays (the plain forward's stash), so that the int8
    kernel is held on states that no bf16 kernel made."""
    from keras_nerf_tpu_torch.kernels import quantize as tq

    cpu = torch.device("cpu")
    cfg = NeRFConfig(n_layers=n_layers, skip_layer=skip, dense_units=units)
    g = torch.Generator().manual_seed(seed)
    params = init_mlp(g, cfg.mlp, cfg.in_xyz, cfg.in_dir)
    params["sigma"]["bias"] += 1.0
    packed = trm.pack_mlp_params(params, cfg.mlp, 10, 4)
    o = torch.zeros(16, 3)
    o[:, 2] = 4.0
    d = torch.nn.functional.normalize(torch.randn(16, 3, generator=g), dim=-1)
    t = torch.sort(torch.rand(16, 32, generator=g) * 4 + 2, dim=-1).values
    base, slope, masks = trm.ray_encoding_coeffs(o, d, 10, 4)
    enc = trm.encode_points(base, slope, t, masks).reshape(-1, 128)
    assert enc.device == cpu
    return tq.quantize_packed(packed, tq.collect_act_amax(packed, enc,
                                                          cfg.mlp), cfg.mlp)


# (rays, samples): no point; one block's 50 rows; 17 past a whole number of
# 64-point tiles.
_INT8_POINTS = {"empty": (0, 64), "ragged_50": (5, 10),
                "ragged_8192_plus_17": (8209, 1)}


@pytest.mark.parametrize("layers", [(8, 4), (3, 2)],
                         ids=["no_last_skip", "last_skip"])
@pytest.mark.parametrize("sigma_only", [True, False])
@pytest.mark.parametrize("case", sorted(_INT8_POINTS))
@pytest.mark.parametrize("units", [256, 512, 768, 1280, 1536, 2048])
def test_ray_march_mlp_int8_matches_plain_at_edge_shapes(
        cuda_device, units, case, sigma_only, layers):
    """T4 on wgmma s8 against its plain version at every part width (128
    columns up to u = 1024, 64 at 1280) and ring depth (2 stages at u =
    256, 4 at 512 and 768, 3 at 1280), and on the streamed route at 1536
    and 2048 (ROADMAP C12), with and without the last layer's encoding
    product, each run twice with identical bits; 1e-3 as above."""
    from keras_nerf_tpu_torch.models.engine import tree_map

    q = tree_map(lambda x: None if x is None else x.to(cuda_device),
                 _int8_state_cpu(units, *layers))
    rays, samples = _INT8_POINTS[case]
    g = torch.Generator(device=cuda_device).manual_seed(11)
    o = torch.zeros(rays, 3, device=cuda_device)
    o[:, 2] = 4.0
    d = torch.nn.functional.normalize(
        torch.randn(rays, 3, generator=g, device=cuda_device), dim=-1)
    t = torch.sort(torch.rand(rays, samples, generator=g, device=cuda_device)
                   * 4 + 2, dim=-1).values
    base, slope, masks = trm.ray_encoding_coeffs(o, d, 10, 4)
    before = trm.ray_march_mlp_int8.launches
    got, again = (trm.ray_march_mlp_int8(q, base, slope, t, masks,
                                         sigma_only=sigma_only)
                  for _ in range(2))
    want = trm.ray_march_mlp_int8.plain(q, base, slope, t, masks,
                                        sigma_only=sigma_only)
    torch.cuda.synchronize()
    assert trm.ray_march_mlp_int8.launches == before + 2
    assert got.shape == want.shape
    assert torch.equal(got, again)
    if got.numel():
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-3
        sigma = got if sigma_only else got[:, 3]
        assert float(sigma.max()) > 0.1          # the fog is not empty


@pytest.mark.parametrize("sigma_only", [True, False])
def test_ray_march_mlp_int8_streamed_at_40_layers_matches_plain(cuda_device,
                                                               sigma_only):
    """T4's streamed route at 40 layers of 256 (skip 4: nine encoding
    sites, past the resident kernel's 16 layers of tensor maps, ROADMAP
    C12), twice with identical bits; 1e-3 as above."""
    from keras_nerf_tpu_torch.models.engine import tree_map

    q = tree_map(lambda x: None if x is None else x.to(cuda_device),
                 _int8_state_cpu(256, 40, 4))
    assert trm.ray_march_mlp_int8_plan(256, 40)["route"] == "streamed"
    g = torch.Generator(device=cuda_device).manual_seed(12)
    o = torch.zeros(257, 3, device=cuda_device)
    o[:, 2] = 4.0
    d = torch.nn.functional.normalize(
        torch.randn(257, 3, generator=g, device=cuda_device), dim=-1)
    t = torch.sort(torch.rand(257, 64, generator=g, device=cuda_device) * 4
                   + 2, dim=-1).values
    base, slope, masks = trm.ray_encoding_coeffs(o, d, 10, 4)
    got, again = (trm.ray_march_mlp_int8(q, base, slope, t, masks,
                                         sigma_only=sigma_only)
                  for _ in range(2))
    want = trm.ray_march_mlp_int8.plain(q, base, slope, t, masks,
                                        sigma_only=sigma_only)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-3


def test_nerf_at_768_units_renders_and_trains_through_the_kernels(
        cuda_device):
    """ROADMAP C10: dense_units 768 on the card. A 16^2 render through the
    kernels against the CPU's (image 2e-3, depth 5e-3, chip_smoke.py's
    budgets), and one MSE step (T3) and one L1 step (T5/T6) whose losses
    and whole gradients are held against the CPU's (rtol 0.03, relative
    norm 0.03, chip_smoke.py's STEP_TOL), each launching only its
    kernels."""
    from keras_nerf_tpu_torch.data import generate_ray_batch, pose_spherical

    cpu = torch.device("cpu")
    cfg = NeRFConfig(n_layers=2, dense_units=768, n_coarse=16, n_fine=16,
                     white_background=True)
    g = torch.Generator().manual_seed(4)
    params = list(engine.init_params(g, cfg, cpu))
    for p in params:
        p["sigma"]["bias"] += 1.0
    rays = generate_ray_batch(pose_spherical(30.0, ORBIT["phi"],
                                             ORBIT["z_translate"])[None], g,
                              image_height=16, image_width=16, focal=20.0,
                              near=ORBIT["near"], far=ORBIT["far"],
                              n_samples=16)
    draws = [sorted_uniforms(g, (128,), 16) for _ in range(2)]
    target = torch.rand(1, 16, 16, 4, generator=g)

    def on(x, dev):
        return engine.tree_map(lambda v: v.to(dev), x)

    trm.reset_launch_counts()
    card = engine.render_image_batch(*on(params, cuda_device),
                                     on(rays, cuda_device),
                                     on(draws, cuda_device), cfg, 128)[1]
    host = engine.render_image_batch(*params, rays, draws, cfg, 128)[1]
    assert {k.name: k.launches for k in trm.KERNELS}["ray_march_mlp"] == 4
    assert float((card["image"].cpu() - host["image"]).abs().max()) <= 2e-3
    assert float((card["depth"].cpu() - host["depth"]).abs().max()) <= 5e-3

    def l1(y_true, y_pred):
        return (y_pred - y_true).abs().mean()

    for loss_fn, kernels in ((None, ("ray_march_mlp", "mlp_backward",
                                     "mlp_weight_grad")),
                             (l1, ("apply_mlp", "mlp_backward",
                                   "mlp_weight_grad"))):
        steps = []
        for dev in (cuda_device, cpu):
            state = engine.TrainState(*on(params, dev), {}, {}, 0)
            trm.reset_launch_counts()
            new, metrics = engine.train_step(
                state, (target.to(dev), on(rays, dev)), on(draws, dev),
                engine.make_optimizer("sgd", 1.0), cfg, 128, loss_fn=loss_fn)
            launched = {k.name for k in trm.KERNELS if k.launches}
            grads = torch.cat([(a - b).double().cpu().flatten() for a, b in
                               zip(engine.tree_leaves(state[:2]),
                                   engine.tree_leaves(new[:2]))])
            steps.append((metrics, grads, launched))
        (m_card, g_card, on_card), (m_host, g_host, on_host) = steps
        assert set(kernels) <= on_card and not on_host
        for key in ("coarse_loss", "fine_loss"):
            assert math.isclose(float(m_card[key]), float(m_host[key]),
                                rel_tol=0.03), key
        assert float((g_card - g_host).norm() / g_host.norm()) <= 0.03


# Every width route of the wgmma probe (u = 128 and 384 on m64n128k16, 384
# in three column passes, 512 with the columns split) and, at T = 64 and
# 192, a 128-row tile whose second warpgroup lies past T.
@pytest.mark.parametrize("t", [64, 192, 256])
@pytest.mark.parametrize("u", [128, 256, 384, 512])
@pytest.mark.parametrize("mode", ["bare", "epi"])
def test_mma_ceiling_matches_plain(cuda_device, mode, u, t):
    from keras_nerf_tpu_torch.kernels import ceiling

    ws, bs, seed = ceiling.make_inputs(4, u, cuda_device, seed=2,
                                       bias_scale=0.05)
    seed[8:] = 0.5
    got = trm.mma_ceiling(ws, bs, seed, t, 2, mode)
    again = trm.mma_ceiling(ws, bs, seed, t, 2, mode)
    want = trm.mma_ceiling.plain(ws, bs, seed, t, 2, mode)
    torch.cuda.synchronize()
    assert _rel_max(got, want) <= 3e-2
    assert float(want.abs().max()) > 0.0
    assert torch.equal(got, again)


def test_quantized_render_runs_the_int8_kernel_and_never_the_bf16_one(
        cuda_device):
    nerf = NeRF(config=NeRFConfig(n_layers=8)).compile(
        image_height=64, image_width=64, ray_chunks=1024,
        white_background=True, device="cuda", seed=0, quantized_render=True)
    assert nerf.quantized_render
    trm.reset_launch_counts()
    images, _ = render_orbit(nerf, [0.0, 90.0], img_wh=64, **ORBIT)
    chunks = 2 * 64 * 64 // 1024
    # Calibration reads its ranges through apply_mlp's stash, once per model.
    assert {k.name: k.launches for k in trm.KERNELS} == {
        "sample_merge": chunks, "ray_march_mlp": 0,
        "ray_march_quadrature": 2 * chunks, "mlp_backward": 0,
        "mlp_weight_grad": 0, "apply_mlp": 2,
        "ray_march_mlp_int8": 2 * chunks, "mma_ceiling": 0}
    assert images.shape == (2, 64, 64, 3)
    assert (images >= 0).all() and (images <= 1).all()


@pytest.mark.parametrize("weights", ["occupancy", "heavy", "one bin"])
@pytest.mark.parametrize("s_c,n,s_m", [
    (64, 128, -1), (64, 64, 0), (64, 64, 64), (24, 16, 40),
    (300, 200, 0), (4096, 64, 64)])     # the last needs > 48 KB of smem
def test_sample_merge_three_modes_match_plain_bit_for_bit(cuda_device, s_c,
                                                          n, s_m, weights):
    """The merge with the CDF source (the TPU's s_m = -1, mp = cp), no
    merge (0) and another partner (> 0): the kernel's depths are its plain
    version's, bit for bit, sorted, and the same bits twice; empty rays,
    heavy-tailed weights and all mass in one bin among them."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    r = 512
    cp = torch.sort(torch.rand(r, s_c, generator=g, device=cuda_device) * 4
                    + 2, dim=-1).values
    w = _merge_weights(weights, r, s_c, g)
    u = sorted_uniforms(g, (r,), n)
    mp = (cp if s_m < 0 else None if s_m == 0 else
          torch.sort(torch.rand(r, s_m, generator=g, device=cuda_device) * 4
                     + 2, dim=-1).values)
    before = trm.sample_merge.launches
    got = trm.sample_merge(cp, w, u, mp)
    want = trm.sample_merge_plain(cp, w, u, mp)
    torch.cuda.synchronize()
    assert trm.sample_merge.launches == before + 1
    assert got.shape == (r, n + (s_c if s_m < 0 else s_m))
    assert torch.equal(got, want)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    assert torch.equal(trm.sample_merge(cp, w, u, mp), got)


@pytest.mark.parametrize("s_m", [0, 64])
def test_sample_merge_reads_one_broadcast_row_of_bins(cuda_device, s_m):
    """The occupancy render's CDF source, the probe-bin centres broadcast to
    every ray (row stride 0), gives the bits of its contiguous copy."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    r, s_c = 4096, 64
    row = torch.sort(torch.rand(s_c, generator=g, device=cuda_device) * 4
                     + 2).values
    cp = row.expand(r, s_c)
    w = _merge_weights("occupancy", r, s_c, g)
    u = sorted_uniforms(g, (r,), 64)
    mp = None if s_m == 0 else torch.sort(
        torch.rand(r, s_m, generator=g, device=cuda_device) * 4 + 2,
        dim=-1).values
    got = trm.sample_merge(cp, w, u, mp)
    assert torch.equal(got, trm.sample_merge(cp.contiguous(), w, u, mp))
    assert torch.equal(got, trm.sample_merge_plain(cp, w, u, mp))


def test_train_then_occupancy_render_cli_on_the_card(cuda_device, tmp_path):
    """A16: train_single for one epoch at 16^2 writes its checkpoints (the
    port's own msgpack codec), then the orbit CLI loads the final one and
    writes both GIFs through --occupancy_grid 32 --quantized_render."""
    import os
    import subprocess
    import sys

    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    scene = write_synthetic_scene(str(tmp_path / "scene"), image_wh=16,
                                  n_train=2, n_val=1, n_test=1)
    train = subprocess.run(
        [sys.executable, "-m", "keras_nerf_tpu_torch.train_single",
         "--data_dir", scene, "--img_wh", "16", "--num_coarse_samples",
         "16", "--num_fine_samples", "16", "--white_bg", "--num_epochs",
         "1", "--ray_chunks", "256", "--name", "toy", "--log_dir",
         str(tmp_path / "logs"), "--model_dirs", str(tmp_path / "model")],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    assert train.returncode == 0, train.stderr[-3000:]
    out = tmp_path / "out"
    render = subprocess.run(
        [sys.executable, "-m", "keras_nerf_tpu_torch.inference",
         "--model_dirs", str(tmp_path / "model" / "toy"), "--img_wh", "16",
         "--output_freq", "180", "--ray_chunks", "256", "--white_bg",
         "--occupancy_grid", "32", "--quantized_render", "--output_dir",
         str(out), "--name", "orbit"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    assert render.returncode == 0, render.stderr[-3000:]
    assert "Baked 32^3 occupancy grid" in render.stderr
    for name in ("orbit.gif", "orbit_depth.gif"):
        assert (out / name).stat().st_size > 0, name


def _occupancy_step_inputs(seed=8):
    """A 16^2 view, 16 + 16 samples at 8 x 256 with the fog's sigma bias,
    a 32^3 ball with holes and the occupancy tier's draws, on the CPU."""
    from keras_nerf_tpu_torch.data import generate_ray_batch, pose_spherical

    cfg = NeRFConfig(n_coarse=16, n_fine=16, white_background=True)
    g = torch.Generator().manual_seed(seed)
    params = list(engine.init_params(g, cfg, torch.device("cpu")))
    for p in params:
        p["sigma"]["bias"] += 1.0
    rays = generate_ray_batch(pose_spherical(30.0, ORBIT["phi"],
                                             ORBIT["z_translate"])[None], g,
                              image_height=16, image_width=16, focal=20.0,
                              near=ORBIT["near"], far=ORBIT["far"],
                              n_samples=16)
    c = (torch.arange(32) + 0.5) / 32 * 4.0 - 2.0
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    grid = ((x * x + y * y + z * z < 1.44)
            & (torch.rand(32, 32, 32, generator=g) > 0.3)).float()
    draws = [sorted_uniforms(g, (128,), 16) for _ in range(2)]
    target = torch.rand(1, 16, 16, 4, generator=g)
    return cfg, params, (target, rays), grid, draws


def _occupancy_step(cfg, params, batch, draws, dev, **occ):
    def on(x):
        return engine.tree_map(lambda v: v.to(dev), x)

    state = engine.TrainState(*on(params), {}, {}, 0)
    trm.reset_launch_counts()
    new, metrics = engine.train_step(
        state, on(batch), on(draws), engine.make_optimizer("sgd", 1.0), cfg,
        128, **{k: v.to(dev) if torch.is_tensor(v) else v
                for k, v in occ.items()})
    launches = {k.name: k.launches for k in trm.KERNELS}
    grads = torch.cat([(a - b).double().cpu().flatten() for a, b in
                       zip(engine.tree_leaves(state[:2]),
                           engine.tree_leaves(new[:2]))])
    return metrics, grads, launches


@pytest.mark.parametrize("merge", [True, False])
def test_occupancy_train_step_matches_cpu(cuda_device, merge):
    """One occupancy-train step (``sample_merge`` in its partner or its
    no-merge mode, then T3 per pass) on the card against the CPU's on the
    same grid and draws: losses rtol 0.03, the whole gradient's relative
    norm 0.03 (chip_smoke.py's STEP_TOL), the T3 kernels and one
    sample_merge launch per chunk."""
    from keras_nerf_tpu_torch.ops.occupancy import DEFAULT_AABB

    cfg, params, batch, grid, draws = _occupancy_step_inputs()
    spec = (16, 16, ORBIT["near"], ORBIT["far"], DEFAULT_AABB, merge)
    (m_card, g_card, launches), (m_host, g_host, on_host) = (
        _occupancy_step(cfg, params, batch, draws, dev, occupancy=spec,
                        occ_grid=grid)
        for dev in (cuda_device, torch.device("cpu")))
    assert launches == {"sample_merge": 2, "ray_march_mlp": 4,
                        "ray_march_quadrature": 4, "mlp_backward": 4,
                        "mlp_weight_grad": 4, "apply_mlp": 0,
                        "ray_march_mlp_int8": 0, "mma_ceiling": 0}
    assert not any(on_host.values())
    for key in ("coarse_loss", "fine_loss"):
        assert math.isclose(float(m_card[key]), float(m_host[key]),
                            rel_tol=0.03), key
    assert float((g_card - g_host).norm() / g_host.norm()) <= 0.03


def test_cached_rows_occupancy_step_equals_probed_on_the_card(cuda_device):
    """The probe-row cache tier on the card: the rows of
    ``probe_rows_for_poses`` in place of the grid give the same step, bit
    for bit."""
    from keras_nerf_tpu_torch.data import pose_spherical
    from keras_nerf_tpu_torch.ops.occupancy import (
        DEFAULT_AABB,
        probe_rows_for_poses,
    )

    cfg, params, batch, grid, draws = _occupancy_step_inputs(seed=9)
    spec = (16, 16, ORBIT["near"], ORBIT["far"], DEFAULT_AABB, True)
    pose = pose_spherical(30.0, ORBIT["phi"], ORBIT["z_translate"])[None]
    rows = probe_rows_for_poses(pose, 20.0, grid.to(cuda_device),
                                image_height=16, image_width=16,
                                near=ORBIT["near"], far=ORBIT["far"],
                                n_probe=16)
    (m_grid, g_grid, _), (m_rows, g_rows, _) = (
        _occupancy_step(cfg, params, batch, draws, cuda_device,
                        occupancy=spec, **kw)
        for kw in (dict(occ_grid=grid),
                   dict(occ_rows=rows.reshape(-1, 16))))
    assert torch.equal(g_grid, g_rows)
    for key in m_grid:
        assert torch.equal(m_grid[key], m_rows[key]), key
