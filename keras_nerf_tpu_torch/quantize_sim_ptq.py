"""Post-training int8 quantization, simulated: the test-split PSNR that an
int8 MLP loses against float32 on a trained checkpoint (port of
``scripts/quantize_sim_ptq.py``).

    python -m keras_nerf_tpu_torch.quantize_sim_ptq --model DIR --data DIR
        [--img_wh 128] [--percentile 100] [--ray_chunks 16384]
        [--calib_points 65536] [--mode smooth] [--seed 17] [--device cuda]

The simulation runs on the float32 reference ops (``apply_mlp``,
``encode_position_and_directions``, ``render_rays``, ``invert_cdf``,
``merge_sorted``), with every dense layer replaced by :func:`_qdense`: the
activations and weights rounded to int8 grids, their products summed in
float32 (exact, every sum below 2^24), then dequantized and the bias
added. Three modes (:func:`qdense_grids`): ``feature`` (per-feature
activation scales folded into the weights, then per-channel weight
scales), ``tensor`` (one activation scale) and ``smooth`` (SmoothQuant,
alpha 0.5: the per-feature balance ``sqrt(act_amax / w_amax)`` folded into
the weights, one activation scale, per-channel weight scales), the kernel
tier's scheme. It prints the test PSNR three ways: float32, int8 on both
models, and int8 on the fine model only, and the two deltas.

Where its calibration differs from ``engine.quantize_render_params``
(`models/engine.py:351`), the int8 kernel tier's (T4, ``kernels/
quantize.py``): the simulation takes its activation ranges from the
float32 forward over the reference encoding (``percentile`` may clip them),
where the tier reads the bf16 activations of ``apply_mlp``'s stash over
``encode_block128``'s block encoding, their amax; the simulation gives a
skip layer's concatenated input ``[h, enc]`` one activation scale, where
the tier scales the encoding's rows and the trunk's rows apart (two int8
products); the simulation quantizes sigma and the features as two layers,
where the tier packs them into one head (``w_sf``); and the tier skips
weight rows that are all zero (the packed layout's padding), which the
simulation does not have. Both calibrate on ``calib_points // n_coarse``
rays strided over the first test image, the fine model on the coarse
depths merged with importance samples of the float32 coarse pass.

Each chunk's importance draws come from a generator seeded with ``seed +
first ray``, the same in all three renders (the JAX script folds the
chunk's first ray into its key). Dropped from the JAX script: its
``jax.jit`` of each apply. Prints the card's line first, a line each
render and the deltas, and, last, ``{"quantize_sim_ptq": ...}``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from keras_nerf_tpu_torch import timing
from keras_nerf_tpu_torch.data import DatasetLoader
from keras_nerf_tpu_torch.models.mlp import apply_mlp
from keras_nerf_tpu_torch.ops.encoding import encode_position_and_directions
from keras_nerf_tpu_torch.ops.metrics import psnr
from keras_nerf_tpu_torch.ops.rendering import render_rays
from keras_nerf_tpu_torch.ops.sampling import (invert_cdf, merge_sorted,
                                               midpoints, sorted_uniforms)
from keras_nerf_tpu_torch.utils import checkpoint


def forward_collect(params, enc_xyz, enc_dir, config) -> dict:
    """The float32 forward's input activation of every dense layer."""
    skip = set(config.skip_indices())
    acts = {}
    x = inputs = enc_xyz
    for i, layer in enumerate(params["trunk"]):
        acts[f"trunk{i}"] = x
        x = torch.relu(x @ layer["kernel"] + layer["bias"])
        if i in skip:
            x = torch.cat([x, inputs], dim=-1)
    acts["sigma"] = acts["features"] = x
    features = torch.cat([x @ params["features"]["kernel"]
                          + params["features"]["bias"], enc_dir], dim=-1)
    acts["rgb_features"] = features
    # rgb_features is linear (no relu), as in apply_mlp.
    acts["rgb"] = (features @ params["rgb_features"]["kernel"]
                   + params["rgb_features"]["bias"])
    return acts


def _percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """Per-column ``q``-th percentile, linear interpolation (numpy's
    default; ``torch.quantile`` refuses inputs past 2^24 elements)."""
    s = torch.sort(a, dim=0).values
    pos = q / 100.0 * (s.shape[0] - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, s.shape[0] - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def calibrate(params, enc_xyz, enc_dir, config, percentile: float) -> dict:
    """Per-feature activation scale (amax, or the ``percentile``-th
    percentile of |a|) of every dense layer's input, at least 1e-8."""
    scales = {}
    for name, a in forward_collect(params, enc_xyz, enc_dir, config).items():
        a = a.abs()
        s = a.amax(dim=0) if percentile >= 100.0 else _percentile(a,
                                                                  percentile)
        scales[name] = torch.clamp(s, min=1e-8)
    return scales


def _round_clip(x: torch.Tensor) -> torch.Tensor:
    # torch.round is round-half-to-even, as jnp.round.
    return torch.clamp(torch.round(x), -127, 127)


def qdense_grids(x, p, s_in, mode: str = "smooth"):
    """``(xq, wq, u)``: the activation codes ``[P, K]``, the weight codes
    ``[K, N]`` and the per-channel dequantization scale ``[N]`` of one int8
    dense layer in ``mode`` (``feature``, ``tensor`` or ``smooth``)."""
    w = p["kernel"]
    if mode == "feature":
        xq = _round_clip(x / s_in * 127.0)
        w_eff = w * (s_in[:, None] / 127.0)
    else:
        if mode == "smooth":
            w_amax = torch.clamp(w.abs().amax(dim=1), min=1e-8)
            m = torch.clamp(torch.sqrt(s_in / w_amax), min=1e-8)
        else:
            m = torch.ones_like(s_in)
        s_t = torch.max(s_in / m)          # the per-tensor activation scale
        xq = _round_clip(x / m / s_t * 127.0)
        w_eff = (w * m[:, None]) * (s_t / 127.0)
    u = torch.clamp(w_eff.abs().amax(dim=0), min=1e-12) / 127.0
    return xq, _round_clip(w_eff / u), u


def _qdense(x, p, s_in, relu: bool, mode: str = "smooth"):
    """One int8 dense layer: integer products summed in float32 (exact:
    |sum| < 256 x 127^2 < 2^24), then ``u`` and the bias, relu'd or not."""
    xq, wq, u = qdense_grids(x, p, s_in, mode)
    out = (xq @ wq) * u + p["bias"]
    return torch.relu(out) if relu else out


def sim_apply_mlp(params, scales, enc_xyz, enc_dir, config,
                  mode: str = "smooth"):
    """``apply_mlp`` with every dense layer int8-simulated: ``(rgb [P, 3],
    sigma [P, 1])`` float32."""
    skip = set(config.skip_indices())
    x = inputs = enc_xyz
    for i, layer in enumerate(params["trunk"]):
        x = _qdense(x, layer, scales[f"trunk{i}"], True, mode)
        if i in skip:
            x = torch.cat([x, inputs], dim=-1)
    sigma = torch.relu(_qdense(x, params["sigma"], scales["sigma"], False,
                               mode))
    features = torch.cat([_qdense(x, params["features"], scales["features"],
                                  False, mode), enc_dir], dim=-1)
    rf = _qdense(features, params["rgb_features"], scales["rgb_features"],
                 False, mode)
    rgb = torch.sigmoid(_qdense(rf, params["rgb"], scales["rgb"], False,
                                mode))
    return rgb, sigma


def render_pair(apply_c, apply_f, o, d, t, draws, config):
    """Coarse then fine render of one chunk with the MLPs ``apply_c`` /
    ``apply_f`` (``(enc_xyz, enc_dir) -> (rgb, sigma)``): the fine depths
    are the coarse depths merged with ``draws`` (sorted uniforms ``[R,
    n_fine]``) through the coarse weights' inverse CDF. Returns the two
    ``RenderOutput``."""
    def run(apply_fn, points):
        ex, ed = encode_position_and_directions(
            o, d, points, config.pos_emb_xyz, config.pos_emb_dir)
        rgb, sigma = apply_fn(ex.reshape(-1, ex.shape[-1]),
                              ed.reshape(-1, ed.shape[-1]))
        return render_rays(rgb.reshape(*points.shape, 3),
                           sigma.reshape(*points.shape, 1), points,
                           white_background=config.white_background)

    out_c = run(apply_c, t)
    points = merge_sorted(t, invert_cdf(draws, midpoints(t), out_c.weights))
    return out_c, run(apply_f, points)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="model/quality128")
    ap.add_argument("--data", default="data/synthetic_128")
    ap.add_argument("--img_wh", type=int, default=128)
    ap.add_argument("--percentile", type=float, default=100.0)
    ap.add_argument("--ray_chunks", type=int, default=16384)
    ap.add_argument("--calib_points", type=int, default=65536)
    ap.add_argument("--mode", default="smooth",
                    choices=["feature", "tensor", "smooth"])
    ap.add_argument("--seed", type=int, default=17,
                    help="the calibration's and the renders' draws")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


@torch.no_grad()
def main(argv=None) -> dict:
    args = build_arg_parser().parse_args(argv)
    device, card = timing.start(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    config = checkpoint.load_model_config(args.model, white_background=True)
    pc, pf = checkpoint.load_params(args.model, device)
    _, _, test = DatasetLoader(args.data, white_background=True,
                               device=device).load_dataset(
        batch_size=1, image_width=args.img_wh, image_height=args.img_wh,
        near=2.0, far=6.0, n_sample=config.n_coarse)
    batches = test.take(len(test))
    mlp = config.mlp

    def draws(seed, rays):
        g = torch.Generator(device=device).manual_seed(seed)
        return sorted_uniforms(g, (rays,), config.n_fine)

    # Calibration rays strided over the whole first test image: the leading
    # rays are its top rows, background only, which would clip the
    # on-object activations.
    _, (o0, d0, t0) = batches[0]
    o0, d0, t0 = (x.reshape(-1, x.shape[-1]) for x in (o0, d0, t0))
    nc = args.calib_points // config.n_coarse
    stride = max(1, -(-o0.shape[0] // nc))
    o0, d0, t0 = (x[::stride][:nc] for x in (o0, d0, t0))

    def flat_enc(points):
        ex, ed = encode_position_and_directions(
            o0, d0, points, config.pos_emb_xyz, config.pos_emb_dir)
        return ex.reshape(-1, ex.shape[-1]), ed.reshape(-1, ed.shape[-1])

    def f32(params):
        return lambda a, b: apply_mlp(params, a, b, mlp)

    scales_c = calibrate(pc, *flat_enc(t0), mlp, args.percentile)
    # The fine model's points: importance samples of the float32 coarse
    # pass merged with the coarse depths.
    u0 = draws(args.seed, o0.shape[0])
    out_c, _ = render_pair(f32(pc), f32(pf), o0, d0, t0, u0, config)
    ft = merge_sorted(t0, invert_cdf(u0, midpoints(t0), out_c.weights))
    scales_f = calibrate(pf, *flat_enc(ft), mlp, args.percentile)

    def q(params, scales):
        return lambda a, b: sim_apply_mlp(params, scales, a, b, mlp,
                                          args.mode)

    def render_split(apply_c, apply_f, tag):
        vals = []
        for images, (o, d, t) in batches:
            h, w = images.shape[1:3]
            o, d, t = (x.reshape(-1, x.shape[-1]) for x in (o, d, t))
            parts = []
            for s in range(0, o.shape[0], args.ray_chunks):
                e = s + args.ray_chunks
                _, out = render_pair(apply_c, apply_f, o[s:e], d[s:e],
                                     t[s:e], draws(args.seed + s,
                                                   o[s:e].shape[0]), config)
                parts.append(out.image)
            img = torch.cat(parts).reshape(1, h, w, 3)
            vals.append(float(psnr(img, images[..., :3])[0]))
        mean = float(np.mean(vals))
        print(f"{tag}: per-image PSNR " + " ".join(f"{v:.2f}" for v in vals)
              + f" | mean {mean:.4f} dB", flush=True)
        return mean

    p32 = render_split(f32(pc), f32(pf), "f32      ")
    pq = render_split(q(pc, scales_c), q(pf, scales_f), "int8 c+f ")
    pqf = render_split(f32(pc), q(pf, scales_f), "int8 fine")
    out = {"card": card, "mode": args.mode, "percentile": args.percentile,
           "psnr_f32": p32, "psnr_int8_coarse_fine": pq,
           "psnr_int8_fine": pqf, "delta_coarse_fine": pq - p32,
           "delta_fine": pqf - p32}
    print(f"delta (c+f quantized): {pq - p32:+.4f} dB", flush=True)
    print(f"delta (fine only)    : {pqf - p32:+.4f} dB", flush=True)
    print(json.dumps({"quantize_sim_ptq": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
