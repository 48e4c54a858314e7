#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``keras_nerf_tpu_torch`` from ``kernels/csrc``,
holds each kernel against its plain PyTorch version at the render path's
shapes (4096-ray chunks, 64 coarse + 128 fine samples, 8 x 256 MLPs), then
renders 4 orbit frames at 128^2 through ``inference.render_orbit`` with
random weights from a fixed seed and checks that every kernel ran, that the
frames are sane, and that the card's render matches the plain versions run
on the CPU for a small frame. Finally it times each kernel and its plain
version with CUDA events, and profiles the orbit render with
``torch.profiler``: device time per frame by kernel and the device's busy
share.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
as the last line, ``{"ok": true, "device": {...}}``. Exits non-zero, with
no result line, when there is no card, outside the repository, or when any
phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak, 700 W
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth

CHUNK = 4096
N_COARSE, N_FINE = 64, 128
IMG = 128
FRAMES = [0.0, 10.0, 20.0, 30.0]

# Tolerances of kernel vs plain version on the same inputs, with reasons.
TOL = {
    # The plain version repeats the kernel's float32 operations in the same
    # order (sequential CDF sums, no fused multiply-add): identical bits
    # expected; the bound allows one ulp of a depth in [2, 6].
    "sample_merge": 1e-6,
    # Same bf16 operands and float32 encoding bit for bit; the sums run in
    # another order, which can flip a bf16 rounding of an activation.
    "ray_march_mlp": 3e-2,
    # Float32 scan and sums in another order.
    "ray_march_quadrature": 1e-4,
}
# End to end, card vs the plain versions on the CPU: the fused-sampling
# budget that the CPU test holds the port to against JAX
# (test_pallas_kernel.py:431-434). The two sides round the bf16 activations
# of eight layers after sums taken in different orders; in the fog scene
# that moves the image and depth by a few 1e-4.
E2E_TOL = {"image": 2e-3, "depth": 5e-3}
# init_mlp's zero biases leave the density to the seed: sigma is the relu of
# one random sum, and on the card seed 0 gives an almost empty scene (weight
# sums ~0.007). A sigma bias of 1 turns every render into a fog that stops
# most of each ray, so the image and depth checks depend on every kernel.
SIGMA_BIAS = 1.0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import keras_nerf_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the keras_nerf_tpu_torch package is not next to "
              f"this script ({e})", file=sys.stderr)
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(
            keras_nerf_tpu_torch.__file__))) != HERE:
        print(f"chip_smoke: imported keras_nerf_tpu_torch from "
              f"{keras_nerf_tpu_torch.__file__}, not from the checkout "
              f"beside this script", file=sys.stderr)
        return 2
    import numpy as np

    from keras_nerf_tpu_torch.data import generate_ray_batch, pose_spherical
    from keras_nerf_tpu_torch.data import get_focal_from_fov
    from keras_nerf_tpu_torch.inference import ORBIT, render_orbit
    from keras_nerf_tpu_torch.kernels import (
        KERNELS,
        pack_mlp_params,
        ray_encoding_coeffs,
        ray_march_mlp,
        ray_march_quadrature,
        reset_launch_counts,
        sample_merge,
    )
    from keras_nerf_tpu_torch.kernels import _build
    from keras_nerf_tpu_torch.kernels.ray_march import fwd_flop_per_point
    from keras_nerf_tpu_torch.models import NeRF, NeRFConfig, init_mlp
    from keras_nerf_tpu_torch.models.engine import render_image_batch
    from keras_nerf_tpu_torch.ops import sorted_uniforms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. environment ---------------------------------------------------
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    card_tag = f"[{card}]"

    # ---- 2. build ---------------------------------------------------------
    _build.load()
    built = _build.last_build()
    log(f"build: {built.seconds:.2f} s ({'cached' if built.cached else 'nvcc'})"
        f" -> {os.path.relpath(built.path, HERE)}")
    for line in built.log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line \
                or "Compiling entry" in line:
            log("  " + line.strip())

    # ---- 3. per-kernel check at main-path shapes -------------------------
    cfg = NeRFConfig(n_coarse=N_COARSE, n_fine=N_FINE, white_background=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = _fog(init_mlp(gen, cfg.mlp, cfg.in_xyz, cfg.in_dir))
    packed = pack_mlp_params(params, cfg.mlp, cfg.pos_emb_xyz,
                             cfg.pos_emb_dir)
    focal = get_focal_from_fov(ORBIT["fov"], IMG)
    rays = generate_ray_batch(
        pose_spherical(30.0, ORBIT["phi"], ORBIT["z_translate"])[None], gen,
        image_height=IMG, image_width=IMG, focal=focal, near=ORBIT["near"],
        far=ORBIT["far"], n_samples=N_COARSE)
    stride = IMG * IMG // CHUNK   # rays spread over the whole frame
    o = rays[0].reshape(-1, 3)[::stride].contiguous()
    d = rays[1].reshape(-1, 3)[::stride].contiguous()
    tc = rays[2].reshape(-1, N_COARSE)[::stride].contiguous()
    base, slope, masks = ray_encoding_coeffs(o, d, cfg.pos_emb_xyz,
                                             cfg.pos_emb_dir)
    u = sorted_uniforms(gen, (CHUNK,), N_FINE)

    errors = {}

    def check(name, got, want):
        got = [g for g in got if g is not None]
        want = [w for w in want if w is not None]
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        errors[name] = max(errors.get(name, 0.0), err)
        ok = finite and err <= TOL[name]
        return err, ok

    # Coarse pass inputs: the plain MLP's sigma, then its weights.
    sig_plain = ray_march_mlp.plain(packed, base, slope, tc, masks,
                                    sigma_only=True)
    sig_kern = ray_march_mlp(packed, base, slope, tc, masks, sigma_only=True)
    torch.cuda.synchronize()
    e1, ok1 = check("ray_march_mlp", [sig_kern], [sig_plain])
    coarse_plain = ray_march_quadrature.plain(
        sig_plain.reshape(CHUNK, N_COARSE), tc, True, True, True)
    coarse_kern = ray_march_quadrature(
        sig_plain.reshape(CHUNK, N_COARSE), tc, True, True, True)
    torch.cuda.synchronize()
    e2, ok2 = check("ray_march_quadrature", coarse_kern, coarse_plain)
    wc = coarse_plain[2]
    tf_plain = sample_merge.plain(tc, wc, u)
    tf_kern = sample_merge(tc, wc, u)
    torch.cuda.synchronize()
    e3, ok3 = check("sample_merge", [tf_kern], [tf_plain])
    rgbs_plain = ray_march_mlp.plain(packed, base, slope, tf_plain, masks)
    rgbs_kern = ray_march_mlp(packed, base, slope, tf_plain, masks)
    torch.cuda.synchronize()
    e4, ok4 = check("ray_march_mlp", [rgbs_kern], [rgbs_plain])
    s_f = N_COARSE + N_FINE
    fine_in = rgbs_plain.reshape(CHUNK, s_f, 4)
    fine_plain = ray_march_quadrature.plain(fine_in, tf_plain, True, False,
                                            True)
    fine_kern = ray_march_quadrature(fine_in, tf_plain, True, False, True)
    torch.cuda.synchronize()
    e5, ok5 = check("ray_march_quadrature", fine_kern, fine_plain)
    # The mode the orbit render launches: no weights out.
    fine_plain = ray_march_quadrature.plain(fine_in, tf_plain, True, False,
                                            False)
    fine_kern = ray_march_quadrature(fine_in, tf_plain, True, False, False)
    torch.cuda.synchronize()
    e6, ok6 = check("ray_march_quadrature", fine_kern, fine_plain)
    for label, err, ok, name in (
            (f"ray_march_mlp sigma-only [{CHUNK} x {N_COARSE}]", e1, ok1,
             "ray_march_mlp"),
            (f"ray_march_quadrature sigma-only [{CHUNK} x {N_COARSE}]", e2,
             ok2, "ray_march_quadrature"),
            (f"sample_merge [{CHUNK}, {N_COARSE} + {N_FINE}]", e3, ok3,
             "sample_merge"),
            (f"ray_march_mlp full [{CHUNK} x {s_f}]", e4, ok4,
             "ray_march_mlp"),
            (f"ray_march_quadrature full [{CHUNK} x {s_f}]", e5, ok5,
             "ray_march_quadrature"),
            (f"ray_march_quadrature full, no weights [{CHUNK} x {s_f}]", e6,
             ok6, "ray_march_quadrature")):
        log(f"check {label}: max_abs_err {err:.3e} (tolerance "
            f"{TOL[name]:.0e}) {'ok' if ok else 'FAIL'}")
    if not all((ok1, ok2, ok3, ok4, ok5, ok6)):
        fail("a kernel disagrees with its plain version")

    # ---- 4. main path: 4 orbit frames through render_orbit --------------
    nerf = NeRF(config=cfg)
    nerf.compile(batch_size=1, image_height=IMG, image_width=IMG,
                 ray_chunks=CHUNK, white_background=True, device="cuda",
                 seed=0)
    _fog(nerf.coarse_params)
    _fog(nerf.fine_params)
    render_orbit(nerf, FRAMES[:1], img_wh=IMG, **ORBIT)   # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    images, depths = render_orbit(nerf, FRAMES, img_wh=IMG, **ORBIT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    chunks = len(FRAMES) * IMG * IMG // CHUNK
    expected = {"sample_merge": chunks, "ray_march_mlp": 2 * chunks,
                "ray_march_quadrature": 2 * chunks}
    log(f"main path: {len(FRAMES)} frames {IMG}^2 in {wall:.3f} s "
        f"({1e3 * wall / len(FRAMES):.1f} ms/frame wall, host clock) "
        f"{card_tag}; launches {launches}")
    if launches != expected:
        fail(f"launch counts {launches} != expected {expected}")
    if images.shape != (len(FRAMES), IMG, IMG, 3) or \
            depths.shape != (len(FRAMES), IMG, IMG):
        fail(f"frame shapes {images.shape} {depths.shape}")
    if not (np.isfinite(images).all() and images.min() >= 0.0
            and images.max() <= 1.0 and np.isfinite(depths).all()):
        fail("frames not finite / outside [0, 1]")
    log(f"frames: image mean {images.mean():.4f} std {images.std():.4f}, "
        f"depth mean {depths.mean():.4f}")

    # The other flag path: weights and coarse image, one frame.
    coarse, fine = nerf.predict_and_render_images(
        rays, with_weights=True, coarse_image=True)
    torch.cuda.synchronize()
    wmax = float(coarse["weights"].amax())
    opacity = float(coarse["weights"].sum(-1).mean())
    if not (coarse["weights"].shape == (1, IMG, IMG, N_COARSE)
            and fine["weights"].shape == (1, IMG, IMG, s_f)
            and wmax > 0.0 and opacity > 0.5
            and bool(torch.isfinite(coarse["image"]).all())
            and float(coarse["image"].min()) >= 0.0
            and float(coarse["image"].max()) <= 1.0):
        fail("with_weights/coarse_image render is malformed or empty")
    log(f"with_weights + coarse_image frame: coarse weights max {wmax:.4f}, "
        f"mean opacity {opacity:.4f}, rays with nonzero coarse weight "
        f"{int((coarse['weights'].sum(-1) > 0).sum())}/{IMG * IMG}")

    # Card vs the plain versions on the CPU, same params, rays and draws.
    small = 32
    srays = generate_ray_batch(
        pose_spherical(30.0, ORBIT["phi"], ORBIT["z_translate"])[None], gen,
        image_height=small, image_width=small,
        focal=get_focal_from_fov(ORBIT["fov"], small), near=ORBIT["near"],
        far=ORBIT["far"], n_samples=N_COARSE)
    sdraws = [sorted_uniforms(gen, (small * small,), N_FINE)]
    fine_params = _fog(init_mlp(gen, cfg.mlp, cfg.in_xyz, cfg.in_dir))
    cpu = torch.device("cpu")
    _, gpu_f = render_image_batch(params, fine_params, srays, sdraws, cfg,
                                  small * small)
    _, cpu_f = render_image_batch(
        _to(params, cpu), _to(fine_params, cpu),
        tuple(x.to(cpu) for x in srays), [x.to(cpu) for x in sdraws], cfg,
        small * small)
    diff = {k: (gpu_f[k].cpu() - cpu_f[k]).abs() for k in ("image", "depth")}
    e2e = {k: float(v.max()) for k, v in diff.items()}
    log(f"end to end {small}^2, card kernels vs CPU plain versions: "
        + ", ".join(f"{k} max_abs_err {e2e[k]:.3e} mean {float(v.mean()):.3e}"
                    f" (tolerance {E2E_TOL[k]:.0e})"
                    for k, v in diff.items()))
    if any(e2e[k] > E2E_TOL[k] for k in e2e):
        fail("card render disagrees with the plain versions")

    # ---- 5. times ---------------------------------------------------------
    def time_ms(fn, iters, spin=True):
        """Device ms per call. With ``spin`` a spin kernel (cycles at the
        H100's ~2 GHz) holds the stream while the host enqueues every call,
        so the events time the card's work and not the host's launch
        overhead; without it, calls run back to back at the pace the host
        launches them."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        if spin:
            torch.cuda._sleep(int(2e9 * (2 * iters * host_s + 1e-3)))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    # One call per kernel mode at the main path's chunk shape, with the
    # least time the card could take for it: the larger of its bytes (each
    # input read once, each output written once) over 3.35 TB/s and its
    # operations over the peak of their type (bf16 tensor cores for the
    # MLP, float32 for the rest).
    per_frame = IMG * IMG // CHUNK
    coarse_sig = sig_plain.reshape(CHUNK, N_COARSE)
    f32b = 4
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       _tensors(packed))
    enc_bytes = 2 * CHUNK * 128 * f32b + weight_bytes

    def bound(nbytes, ops, peak_ops):
        t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
        return (1e3 * max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    def mlp_bound(points, sigma_only):
        flop = points * fwd_flop_per_point(cfg.mlp, sigma_only=sigma_only)
        nbytes = enc_bytes + points * f32b * (2 if sigma_only else 5)
        return bound(nbytes, flop, PEAK_BF16_FLOPS)

    # sample_merge per ray, by the least work the function needs: 6 float32
    # operations per coarse bin (eps, sum, divide, prefix sum, midpoint), a
    # binary search plus 6 operations of interpolation per draw, and a
    # binary search into the other array per merged depth.
    lg_c, lg_f = (N_COARSE - 1).bit_length(), (N_FINE - 1).bit_length()
    merge_ops = CHUNK * (6 * N_COARSE + N_FINE * (2 * lg_c + 6)
                         + N_COARSE * lg_f)
    # Quadrature per sample: delta, sigma delta, scan, two exp, weight
    # (9 with the depth sum); + the weight sum and rgb sums (16).
    modes = [  # kernel, mode, call, (bound ms per launch, bound_by)
        (sample_merge, f"[{CHUNK}, {N_COARSE} + {N_FINE}]",
         lambda f: f(tc, wc, u),
         bound(CHUNK * (2 * N_COARSE + N_FINE + s_f) * f32b, merge_ops,
               PEAK_F32_FLOPS)),
        (ray_march_mlp, f"sigma-only [{CHUNK} x {N_COARSE}]",
         lambda f: f(packed, base, slope, tc, masks, sigma_only=True),
         mlp_bound(CHUNK * N_COARSE, True)),
        (ray_march_mlp, f"full [{CHUNK} x {s_f}]",
         lambda f: f(packed, base, slope, tf_plain, masks),
         mlp_bound(CHUNK * s_f, False)),
        (ray_march_quadrature, f"sigma-only [{CHUNK} x {N_COARSE}]",
         lambda f: f(coarse_sig, tc, True, True, True),
         bound(CHUNK * (3 * N_COARSE + 1) * f32b, CHUNK * N_COARSE * 9,
               PEAK_F32_FLOPS)),
        (ray_march_quadrature, f"full, no weights [{CHUNK} x {s_f}]",
         lambda f: f(fine_in, tf_plain, True, False, False),
         bound(CHUNK * (5 * s_f + 4) * f32b, CHUNK * s_f * 16,
               PEAK_F32_FLOPS)),
    ]
    totals = {k.name: [0.0, 0.0, 0.0, None] for k in KERNELS}
    for k, mode, call, (bms, by) in modes:
        kms = time_ms(lambda: call(k), 20)
        paced = time_ms(lambda: call(k), 20, spin=False)
        pms = time_ms(lambda: call(k.plain), 3)
        log(f"time {k.name} {mode}: {kms:.4f} ms/launch kernel "
            f"({paced:.4f} paced by the host's launches), {pms:.3f} "
            f"ms/launch plain, bound {bms:.4f} ms/launch ({by}), "
            f"{kms / bms:.1f}x bound {card_tag}")
        tot = totals[k.name]
        tot[0] += per_frame * kms
        tot[1] += per_frame * pms
        tot[2] += per_frame * bms
        tot[3] = by

    # ---- 6. profile: device time by kernel, device busy share -----------
    log(json.dumps({"profile": _profile(nerf, render_orbit, ORBIT), "card":
                    card}))

    entries = []
    for k in KERNELS:
        kms, pms, bms, by = totals[k.name]
        log(f"time {k.name}: {kms:.4f} ms/frame kernel, {pms:.3f} ms/frame "
            f"plain, bound {bms:.4f} ms/frame ({by}) {card_tag}")
        entries.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": errors[k.name], "tolerance": TOL[k.name],
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "per": f"{IMG}^2 frame, {per_frame} chunks "
            f"of {CHUNK} rays"})
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _profile(nerf, render_orbit, orbit) -> dict:
    """Render the orbit frames under ``torch.profiler``: host wall and
    device busy ms per frame (the union of the card's activity spans), and
    device ms per frame of the busiest kernels."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render_orbit(nerf, FRAMES, img_wh=IMG, **orbit)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # The card's own activity (kernels, copies, fills); the GPU-side ranges
    # of annotated aten ops only repeat the time of the kernels inside them.
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not ev.is_user_annotation)
    per_kernel = {}
    busy_us, reach = 0.0, float("-inf")
    for start, end, name in spans:
        name = name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0]
        if len(name) > 80:
            name = name[:40] + "..." + name[-37:]
        per_kernel[name] = (per_kernel.get(name, 0.0)
                            + (end - start) / 1e3 / len(FRAMES))
        busy_us += max(0.0, end - max(start, reach))   # union of spans
        reach = max(reach, end)
    device_ms = busy_us / 1e3 / len(FRAMES) if spans else None
    wall_ms = 1e3 * wall / len(FRAMES)
    return {"frames": len(FRAMES), "img_wh": IMG,
            "wall_ms_per_frame": wall_ms,
            "device_ms_per_frame": device_ms,
            "device_busy_share": device_ms / wall_ms if spans else None,
            "device_ms_per_frame_by_kernel": dict(sorted(
                per_kernel.items(), key=lambda kv: -kv[1])[:8])}


def _fog(params):
    params["sigma"]["bias"] += SIGMA_BIAS
    return params


def _tensors(packed):
    for v in packed.values():
        for t in (v if isinstance(v, list) else [v]):
            if t is not None:
                yield t


def _to(params, device):
    if isinstance(params, dict):
        return {k: _to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_to(v, device) for v in params]
    return params.to(device)


if __name__ == "__main__":
    sys.exit(main())
