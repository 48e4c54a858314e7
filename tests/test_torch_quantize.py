"""The port's int8 render tier against the JAX package's, on the CPU.

The JAX package's own small configuration (`tests/models/
test_quantized_render.py:23-34`: 3 x 256 with skip 2, 8 + 8 samples, 32
rays), and 3 x 256 with skip 1 so that a trunk skip layer is quantized too.
Parameters are drawn by JAX and carried over with ``params_from_jax``; the
int8 weights and scales with ``quantized_from_jax``; the fine draws are
JAX's ``sorted_uniforms`` fed in. JAX runs its Pallas kernels in interpret
mode. Budgets, each with its reason:

* scales ``u``/``r``: rtol 1e-5 (float32 square roots and quotients, a few
  ulps); int8 codes: equal, but for at most one code per array moved by one
  step at a rounding tie;
* activation ranges: rtol 8e-3, one bf16 step (the same bf16 activations);
  so too the scales of a whole calibration, where each package encodes the
  points itself and a bf16 activation can round the other way;
* the int8 forward on one float32 encoding: atol 1e-6 (the codes and int32
  sums are exact, the float32 epilogue runs in the same order);
* a quantized chunk and a whole render against JAX's kernels from the same
  int8 dicts: the fused-sampling budget of `test_pallas_kernel.py:431-434`,
  image 2e-3, depth 5e-3; from each package's own calibration, one int8
  step of the image and depth ranges, 8e-3 and 3e-2;
* the int8 render against the bf16 one on random weights: 0.25, as the JAX
  package's own test (`test_quantized_render.py:264-268`).

``-s`` prints each reading beside its budget.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import functools
import importlib.util
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.kernels import pack_mlp_params as jax_pack
from keras_nerf_tpu.kernels import quantize as jq
from keras_nerf_tpu.kernels.ray_march import encode_block128 as jax_encode
from keras_nerf_tpu.kernels.ray_march import fused_train_chunk as jax_chunk
from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu.utils import checkpoint as jckpt
from keras_nerf_tpu_torch.kernels import KERNELS
from keras_nerf_tpu_torch.kernels import ceiling as tmc
from keras_nerf_tpu_torch.kernels import quantize as tq
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRF
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.utils.convert import (
    params_from_jax,
    quantized_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_ATOL, DEPTH_ATOL = 2e-3, 5e-3
SCALE_RTOL, AMAX_RTOL, FORWARD_ATOL = 1e-5, 8e-3, 1e-6
B, H, W, CHUNK = 1, 4, 8, 16
SKIPS = [2, 1]      # the JAX test's skip 2 (last layer), and skip 1 (trunk)


def _jax_cfg(skip):
    return jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=3,
                              dense_units=256, skip_layer=skip,
                              white_background=True, use_pallas=True)


def _port_cfg(jcfg):
    return tengine.NeRFConfig(**jcfg.to_model_config(),
                              white_background=jcfg.white_background)


def _report(what, reading, budget):
    print(f"\n{what}: {reading:.3e} (budget {budget:g})")
    assert reading <= budget, what


@pytest.fixture(scope="module", params=SKIPS, ids=[f"skip{s}" for s in SKIPS])
def scene(request):
    """JAX's parameters, rays, depths and calibration of the fine model."""
    jcfg = _jax_cfg(request.param)
    pc, pf = jengine.init_params(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(0)
    r = B * H * W
    o = np.zeros((r, 3), np.float32)
    o[:, 2] = 4.0
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2, 6, (r, jcfg.n_coarse)), -1).astype(np.float32)
    last_skip = (jcfg.n_layers - 1) in set(jcfg.mlp.skip_indices())
    packed = jax_pack(pf, jcfg.mlp, jcfg.pos_emb_xyz, jcfg.pos_emb_dir)
    pos = o[:, None] + d[:, None] * t[..., None]
    enc = jax_encode(jnp.asarray(pos.reshape(-1, 3)),
                     jnp.asarray(np.broadcast_to(d[:, None], pos.shape)
                                 .reshape(-1, 3)),
                     jcfg.pos_emb_xyz, jcfg.pos_emb_dir)
    amax = jq.collect_act_amax(packed, enc, jcfg.mlp, last_skip)
    q = jq.quantize_packed(packed, amax, jcfg.mlp, last_skip)
    return {"jcfg": jcfg, "cfg": _port_cfg(jcfg),
            "pc": jax.tree.map(np.array, pc),
            "pf": jax.tree.map(np.array, pf), "o": o, "d": d, "t": t,
            "enc": np.array(enc.astype(jnp.float32)), "last_skip": last_skip,
            "amax": jax.tree.map(np.array, amax),
            "q": jax.tree.map(np.array, q)}


def _port_packed(scene, params):
    cfg = scene["cfg"]
    return trm.pack_mlp_params(params_from_jax(params, "cpu"), cfg.mlp,
                               cfg.pos_emb_xyz, cfg.pos_emb_dir)


def _leaves(q):
    """``(key, index, array)`` of a quantized dict, None entries kept."""
    for k in sorted(q):
        v = q[k] if isinstance(q[k], list) else [q[k]]
        for i, x in enumerate(v):
            yield k, i, x


def _quantized_close(got: dict, want: dict) -> tuple[float, int]:
    """Worst scale rtol and the most codes moved in one array: the two dicts
    must have the same keys, Nones, shapes and types, every code within one
    step."""
    assert sorted(got) == sorted(want)
    worst_rel, worst_moved = 0.0, 0
    for (k, i, a), (_, _, b) in zip(_leaves(got), _leaves(want)):
        assert (a is None) == (b is None), (k, i)
        if a is None:
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (k, i)
        if b.dtype == np.int8:
            moved = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert moved.max(initial=0) <= 1, (k, i)
            worst_moved = max(worst_moved, int((moved > 0).sum()))
        else:
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
            worst_rel = max(worst_rel, float(rel.max(initial=0.0)))
    return worst_rel, worst_moved


def test_quantize_packed_matches_jax(scene):
    """The same packed weights and the same ranges give the same int8
    layout: every key, None and shape, codes and scales."""
    amax = {k: torch.as_tensor(v) for k, v in scene["amax"].items()}
    got = tq.quantize_packed(_port_packed(scene, scene["pf"]), amax,
                             scene["cfg"].mlp)
    rel, moved = _quantized_close(got, scene["q"])
    _report("quantize_packed scales, worst relative error", rel, SCALE_RTOL)
    _report("quantize_packed codes moved in one array (at ties)", moved, 1)
    assert (got["w_sig_enc"] is not None) == scene["last_skip"]


def test_collect_act_amax_matches_jax(scene):
    """The ranges of every quantization site from the same bf16 encoding,
    read from apply_mlp's stash (its plain version here)."""
    enc = torch.as_tensor(scene["enc"]).to(torch.bfloat16)
    got = tq.collect_act_amax(_port_packed(scene, scene["pf"]), enc,
                              scene["cfg"].mlp)
    assert sorted(got) == sorted(scene["amax"])
    rel = max(float(np.max(np.abs(got[k].numpy() - v)
                           / np.maximum(np.abs(v), 1e-30)))
              for k, v in scene["amax"].items())
    _report("collect_act_amax, worst relative error", rel, AMAX_RTOL)


@pytest.mark.parametrize("sigma_only", [False, True])
def test_ray_march_mlp_int8_plain_matches_forward_core_int8(scene,
                                                            sigma_only):
    """T4's plain version against JAX's forward_core_int8 on JAX's own int8
    weights and one float32 encoding (the port's, which both take)."""
    q = quantized_from_jax(scene["q"], "cpu")
    o, d, t = (torch.as_tensor(scene[k]) for k in "odt")
    base, slope, masks = trm.ray_encoding_coeffs(o, d, 10, 4)
    enc = trm.encode_points_f32(base, slope, t, masks).reshape(-1, 128)
    rgb_pre, sig_pre, _ = jq.forward_core_int8(
        scene["jcfg"].mlp, scene["last_skip"], jnp.asarray(enc.numpy()),
        scene["q"], sigma_only=sigma_only)
    sigma = np.asarray(jax.nn.relu(sig_pre[:, 0]))
    got = trm.ray_march_mlp_int8(q, base, slope, t, masks,
                                 sigma_only=sigma_only).numpy()
    if sigma_only:
        err = float(np.abs(got - sigma).max())
    else:
        want = np.concatenate([np.asarray(jax.nn.sigmoid(rgb_pre[:, :3])),
                               sigma[:, None]], axis=1)
        err = float(np.abs(got - want).max())
    _report(f"ray_march_mlp_int8 plain {'sigma-only' if sigma_only else 'full'}"
            f" vs forward_core_int8, max abs", err, FORWARD_ATOL)
    assert float(np.abs(sigma).max()) > 0.1     # a non-trivial density


def test_quantized_render_chunk_matches_jax_kernel(scene):
    """fused_render_chunk(quantized=True) against JAX's
    fused_train_chunk(quantized=True) in interpret mode: the coarse pass on
    given points, sigma-only, then the fine pass sampling off its weights."""
    jcfg = scene["jcfg"]
    q = quantized_from_jax(scene["q"], "cpu")
    o, d, t = (jnp.asarray(scene[k]) for k in "odt")
    u = jax_sorted_uniforms(jax.random.PRNGKey(4), (t.shape[0],), 8)
    kw = dict(white_background=True, with_grad=False, quantized=True,
              interpret=True)
    want_c = jax_chunk(scene["q"], o, d, t, None, jcfg.mlp, sigma_only=True,
                       **kw)
    want_f = jax_chunk(scene["q"], o, d, None, None, jcfg.mlp,
                       sample_inputs=(t, want_c[2], u), **kw)
    to, td, tt = (torch.as_tensor(scene[k]) for k in "odt")
    got_c = trm.fused_render_chunk(q, to, td, tt, white_background=True,
                                   sigma_only=True, quantized=True)
    got_f = trm.fused_render_chunk(
        q, to, td, None, white_background=True, quantized=True,
        sample_inputs=(tt, got_c[2], torch.as_tensor(np.array(u))))
    for name, got, want in (("coarse sigma-only", got_c, want_c),
                            ("fine, in-kernel sampling", got_f, want_f)):
        _report(f"quantized chunk {name}, image", float(np.abs(
            got[0].numpy() - np.asarray(want[0])).max()), IMAGE_ATOL)
        _report(f"quantized chunk {name}, depth", float(np.abs(
            got[1].numpy() - np.asarray(want[1])).max()), DEPTH_ATOL)
    assert float(got_f[0].std()) > 0.01


def _rays(scene):
    return tuple(scene[k].reshape(B, H, W, -1) for k in "odt")


def _port_render(scene, packed_q, **kw):
    """The port's render_image_batch with JAX's per-chunk draws of key 5."""
    key = jax.random.PRNGKey(5)
    draws = [torch.as_tensor(np.array(jax_sorted_uniforms(k, (CHUNK,), 8)))
             for k in jax.random.split(key, B * H * W // CHUNK)]
    return tengine.render_image_batch(
        params_from_jax(scene["pc"], "cpu"), params_from_jax(scene["pf"], "cpu"),
        tuple(torch.as_tensor(x) for x in _rays(scene)), draws, scene["cfg"],
        CHUNK, packed_q=packed_q, **kw)


def _port_calibration(scene):
    """quantize_render_params with the draws JAX's calibration takes."""
    key = jax.random.PRNGKey(5)
    u = torch.as_tensor(np.array(jax_sorted_uniforms(key, (B * H * W,), 8)))
    return tengine.quantize_render_params(
        params_from_jax(scene["pc"], "cpu"), params_from_jax(scene["pf"], "cpu"),
        tuple(torch.as_tensor(x) for x in _rays(scene)), u, scene["cfg"])


def test_quantize_render_params_and_render_match_jax(scene):
    """Calibration on the strided rays and the int8 render through both
    passes, against JAX's quantize_render_params and render_image_batch
    (packed_q) with the same draws: the render from JAX's own int8 dicts at
    the fused-sampling budget, and from each package's own calibration."""
    jcfg, key = scene["jcfg"], jax.random.PRNGKey(5)
    jrays = tuple(jnp.asarray(x) for x in _rays(scene))
    # Jitted, as NeRF calls it (`nerf.py:346-348`).
    want_q = jax.jit(functools.partial(jengine.quantize_render_params,
                                       config=jcfg))(
        scene["pc"], scene["pf"], jrays, key)
    got_q = _port_calibration(scene)
    # The coarse ranges come from the stratified points: the same bits. The
    # fine ones come from points sampled off float32 reference weights whose
    # sums run in another order, so a fine depth can move by an ulp, a bf16
    # activation round the other way and a range move by one bf16 step.
    for model, got, want in zip(("coarse", "fine"), got_q, want_q):
        rel, moved = _quantized_close(got, jax.tree.map(np.asarray, want))
        _report(f"quantize_render_params {model} scales, worst relative "
                f"error", rel, AMAX_RTOL)
        print(f"quantize_render_params {model}: at most {moved} codes of one "
              f"array moved by one step")
    want_c, want_f = jengine.render_image_batch(
        scene["pc"], scene["pf"], jrays, key, jcfg, CHUNK, packed_q=want_q)
    same = tuple(quantized_from_jax(jax.tree.map(np.array, q), "cpu")
                 for q in want_q)
    # From the same int8 dicts: the kernels' budget. From each package's own
    # calibration: a code moved by one step moves an activation by 1/127 of
    # its range, so the image (in [0, 1]) by up to about 8e-3, the depth by
    # up to 8e-3 of the 4-unit depth range, 3e-2.
    for label, packed_q, atol in (
            ("JAX's int8 dicts", same, (IMAGE_ATOL, DEPTH_ATOL)),
            ("its own calibration", got_q, (8e-3, 3e-2))):
        got_c, got_f = _port_render(scene, packed_q)
        for name, got, want in (("coarse", got_c, want_c),
                                ("fine", got_f, want_f)):
            for k, budget in zip(("image", "depth"), atol):
                _report(f"int8 render from {label}, {name} {k}",
                        float(np.abs(got[k].numpy()
                                     - np.asarray(want[k])).max()), budget)
    bf16_f = _port_render(scene, None)[1]
    assert not np.array_equal(bf16_f["image"].numpy(),
                              got_f["image"].numpy())


def test_sigma_only_coarse_pass_leaves_the_fine_image_unchanged(scene):
    """The orbit's flags (a sigma-only coarse pass, no weights) give the
    same fine image bit for bit (as `test_quantized_render.py:136-142`)."""
    packed_q = _port_calibration(scene)
    full = _port_render(scene, packed_q)[1]
    _, fast = _port_render(scene, packed_q, coarse_image=False,
                           with_weights=False)
    assert "weights" not in fast
    np.testing.assert_array_equal(fast["image"].numpy(),
                                  full["image"].numpy())
    np.testing.assert_array_equal(fast["depth"].numpy(),
                                  full["depth"].numpy())


def _nerf(quantized, use_kernels=None):
    nerf = NeRF(n_coarse=8, n_fine=8, n_layers=2, dense_units=256,
                skip_layer=1)
    return nerf.compile(batch_size=1, image_height=8, image_width=8,
                        ray_chunks=64, is_training=False, device="cpu",
                        use_kernels=use_kernels, quantized_render=quantized)


def _nerf_rays():
    rng = np.random.default_rng(1)
    o = np.tile(np.float32([0.0, 0.0, 4.0]), (1, 8, 8, 1))
    d = rng.normal(size=(1, 8, 8, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2, 6, (1, 8, 8, 8)), -1).astype(np.float32)
    draws = [torch.as_tensor(np.sort(rng.uniform(size=(64, 8)), -1)
                             .astype(np.float32))]
    return (o, d, t), draws


def test_nerf_quantized_render_calibrates_once_per_state():
    """compile(quantized_render=True): calibration on the first call, none
    on the next, again after the state changes; the int8 render stays
    within 0.25 of the bf16 one on the same weights
    (`test_quantized_render.py:221-268`)."""
    rays, draws = _nerf_rays()
    nerf = _nerf(True)
    assert nerf.quantized_render and nerf._packed_q is None
    _, first = nerf.predict_and_render_images(rays, fine_draws=draws)
    packed_q = nerf._packed_q
    assert packed_q is not None
    _, again = nerf.predict_and_render_images(rays, fine_draws=draws)
    assert nerf._packed_q is packed_q
    np.testing.assert_array_equal(first["image"].numpy(),
                                  again["image"].numpy())

    nerf.state = tengine.init_train_state(
        torch.Generator().manual_seed(99), nerf.config,
        tengine.make_optimizer("sgd", 1e-2), device="cpu")
    _, fresh = nerf.predict_and_render_images(rays, fine_draws=draws)
    assert nerf._packed_q is not packed_q
    assert not np.array_equal(fresh["image"].numpy(), first["image"].numpy())

    plain = _nerf(False)
    plain.state = nerf.state
    _, bf16 = plain.predict_and_render_images(rays, fine_draws=draws)
    diff = float(np.abs(bf16["image"].numpy() - fresh["image"].numpy()).max())
    _report("NeRF int8 render vs bf16 render, max abs", diff, 0.25)
    assert diff > 0.0


def test_quantized_render_without_kernels_is_ignored_with_a_warning(caplog):
    """use_kernels=False has no int8 path: the flag is dropped with a
    warning, as the JAX package does (`nerf.py:340-345`), and nothing
    launches."""
    trm.reset_launch_counts()
    with caplog.at_level(logging.WARNING):
        nerf = _nerf(True, use_kernels=False)
    assert not nerf.quantized_render
    assert "quantized_render requires the kernel render path" in caplog.text
    rays, draws = _nerf_rays()
    _, fine = nerf.predict_and_render_images(rays, fine_draws=draws)
    assert fine["image"].shape == (1, 8, 8, 3) and nerf._packed_q is None
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_inference_cli_quantized_render_writes_both_gifs(tmp_path):
    import imageio.v2 as imageio

    model_dir = tmp_path / "model"
    cfg = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=2,
                             dense_units=256, skip_layer=4)
    jckpt.save_model(str(model_dir), jengine.init_train_state(
        jax.random.PRNGKey(3), cfg, jengine.make_optimizer("adam")), cfg)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "keras_nerf_tpu_torch.inference",
         "--model_dirs", str(model_dir), "--img_wh", "16",
         "--output_freq", "180", "--ray_chunks", "256", "--white_bg",
         "--quantized_render", "--device", "cpu", "--output_dir", str(out),
         "--name", "orbit"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "int8 weights calibrated" in proc.stderr
    for name in ("orbit.gif", "orbit_depth.gif"):
        frames = imageio.mimread(out / name)
        assert len(frames) == 2 and frames[0].shape[:2] == (16, 16), name


def _tpu_probe():
    """The TPU probe script as a module (its main() runs only as a
    script)."""
    path = os.path.join(REPO, "scripts", "profile_mxu_ceiling.py")
    spec = importlib.util.spec_from_file_location("profile_mxu_ceiling", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("mode", tmc.MODES)
def test_mma_ceiling_plain_matches_the_tpu_probe(mode):
    """T7's plain version against the TPU probe's kernel body in interpret
    mode on the same weights: bf16 activations rounded after sums in
    another order, through 16 layers; relative to the largest output,
    3e-2 (as ray_march_mlp against its plain version)."""
    from jax.experimental import pallas as pl

    probe = _tpu_probe()
    steps, t, u, rep = 2, 64, 128, 2
    ws, bs, seed = tmc.make_inputs(steps, u, "cpu", seed=1, bias_scale=0.05)
    seed[8:] = 0.25             # each grid step starts from its own seed
    jws = [jnp.asarray(w.float().numpy()).astype(jnp.bfloat16) for w in ws]
    jbs = [jnp.asarray(b.numpy())[None, :] for b in bs]
    spec = pl.BlockSpec((8, 128), lambda i: (i, 0))
    full = [pl.BlockSpec(x.shape, lambda i: (0, 0)) for x in jws + jbs]
    want = pl.pallas_call(
        probe.make_kernel(mode, t, u, rep), grid=(steps,),
        in_specs=[spec] + full, out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((steps * 8, 128), jnp.float32),
        interpret=True)(jnp.asarray(seed.numpy()), *jws, *jbs)
    got = trm.mma_ceiling(ws, bs, seed, t, rep, mode)
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    _report(f"mma_ceiling plain {mode} vs the TPU probe, relative max", err,
            3e-2)
    assert float(np.abs(want).max()) > 0.0
