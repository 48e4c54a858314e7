#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``keras_nerf_tpu_torch`` from ``kernels/csrc``
and drives both paths of the port at full width (8 x 256 MLPs, 64 coarse +
128 fine samples, 128^2 images), with random weights from fixed seeds:

* render: holds the render kernels against their plain PyTorch versions at
  4096-ray chunks, renders 4 orbit frames through
  ``inference.render_orbit`` and holds a small frame against the plain
  versions run on the CPU;
* train: holds each training kernel and mode against its plain version at
  2048-ray chunks (and ``mlp_weight_grad`` against itself, bit for bit),
  trains 20 steps through ``NeRF.fit`` on an in-memory spheres scene, takes
  one step at 16384-ray chunks (peak memory), and holds one card step
  against the same step on the CPU.

Each path's launch counts are read just after it runs. Then every kernel
and its plain version is timed with CUDA events, and both paths are
profiled with ``torch.profiler``: device time by kernel and the device's
busy share.

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
F32B = 4

CHUNK = 4096
N_COARSE, N_FINE = 64, 128
IMG = 128
FRAMES = [0.0, 10.0, 20.0, 30.0]
TRAIN_CHUNK = 2048         # the training CLI's default --ray_chunks
BIG_CHUNK = 16384          # the round-5 recipe's --ray_chunks
TRAIN_POSES, TRAIN_EPOCHS = 5, 4   # 20 steps
E2E_IMG, E2E_CHUNK = 16, 128       # 2 chunks

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
# Training kernels vs plain versions on the same inputs. bf16 arrays are
# held relative to their largest magnitude ("rel") and, so that garbled
# small entries cannot hide under the largest, by the norm of the
# difference relative to the array's norm ("rel_norm"): a flipped bf16
# rounding moves an entry by at most 2^-7 of its value, so flips alone keep
# the relative norm under 7.8e-3 unless they compound through many layers
# at once. float32 arrays are held absolutely ("abs").
TRAIN_TOL = {
    # The fine pass's depths at the training chunk: as at the render chunk.
    "sample_merge": {"abs": 1e-6},
    # The stash and outputs: bf16 activations rounded after sums taken in
    # another order, flips compounding through the layers (as above).
    "ray_march_mlp": {"abs": 3e-2, "rel": 3e-2, "rel_norm": 1e-2},
    # Image, depth, weights: float32 scans in another order (as above);
    # cotangents: the same float32 values rounded once to bf16, where one
    # flip is at most 2^-7 of a value.
    "ray_march_quadrature": {"abs": 1e-4, "rel": 1e-2, "rel_norm": 1e-2},
    # d_rf and d_sf round once; the trunk's d_pre compound like the forward.
    "mlp_backward": {"rel": 3e-2, "rel_norm": 1e-2},
    # The same bf16 operands, float32 sums over up to 3.9e5 points in
    # another order (cuBLAS in the plain version): per leaf, relative norm
    # and relative max.
    "mlp_weight_grad": {"rel_norm": 1e-3, "rel": 1e-2},
}
# Card step vs the same step on the CPU: the JAX package's budgets for its
# fused train step against XLA (test_pallas_kernel.py:336-349,380-389).
STEP_TOL = {"loss_rtol": 0.03, "grad_rel_norm": 0.03, "grad_rel_max": 0.12}
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
    from keras_nerf_tpu_torch.models.engine import (
        render_image_batch,
        tree_leaves,
    )
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
    render_launches = {k.name: k.launches for k in KERNELS}
    chunks = len(FRAMES) * IMG * IMG // CHUNK
    expected = {"sample_merge": chunks, "ray_march_mlp": 2 * chunks,
                "ray_march_quadrature": 2 * chunks, "mlp_backward": 0,
                "mlp_weight_grad": 0}
    log(f"main path: {len(FRAMES)} frames {IMG}^2 in {wall:.3f} s "
        f"({1e3 * wall / len(FRAMES):.1f} ms/frame wall, host clock) "
        f"{card_tag}; launches {render_launches}")
    if render_launches != expected:
        fail(f"launch counts {render_launches} != expected {expected}")
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

    # ---- 5. training kernels against their plain versions ----------------
    train_in = _train_inputs(cfg, gen)
    rel_errors = {}
    for name, err, rel, rel_norm, ok, label in _train_kernel_checks(
            train_in):
        errors[name] = max(errors.get(name, 0.0), err)
        old = rel_errors.get(name, (0.0, 0.0))
        rel_errors[name] = (max(old[0], rel), max(old[1], rel_norm))
        log(f"check {label}: max_abs_err {err:.3e}, relative max "
            f"{rel:.3e}, relative norm {rel_norm:.3e} (tolerance "
            f"{TRAIN_TOL[name]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{label} disagrees with its plain version")

    # ---- 6. main path: training through NeRF.fit -------------------------
    tnerf, dataset, train_launches, n_steps = _train_main_path(cfg,
                                                               card_tag)

    # One step at the round-5 recipe's chunk: launches and peak memory.
    _big_chunk_step(tnerf, dataset, card_tag)

    # Card step vs the same step on the CPU, from the trained weights.
    _train_step_vs_cpu(tnerf, cfg, gen)

    # ---- 7. times ---------------------------------------------------------
    # One call per kernel mode at its path's chunk shape, with the least
    # time the card could take for it: the larger of its bytes (each input
    # read once, each output written once) over 3.35 TB/s and its
    # operations over the peak of their type (bf16 tensor cores for the
    # MLP products, float32 for the rest).
    per_frame = IMG * IMG // CHUNK
    coarse_sig = sig_plain.reshape(CHUNK, N_COARSE)
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       tree_leaves(packed))
    enc_bytes = 2 * CHUNK * 128 * F32B + weight_bytes

    def mlp_bound(points, sigma_only):
        flop = points * fwd_flop_per_point(cfg.mlp, sigma_only=sigma_only)
        nbytes = enc_bytes + points * F32B * (2 if sigma_only else 5)
        return _bound(nbytes, flop, PEAK_BF16_FLOPS)

    # Quadrature per sample: delta, sigma delta, scan, two exp, weight
    # (9 with the depth sum); + the weight sum and rgb sums (16).
    modes = [  # kernel, path, mode, call, launches per unit, bound
        (sample_merge, "render", f"[{CHUNK}, {N_COARSE} + {N_FINE}]",
         lambda f: f(tc, wc, u), per_frame, _merge_bound(CHUNK)),
        (ray_march_mlp, "render", f"sigma-only [{CHUNK} x {N_COARSE}]",
         lambda f: f(packed, base, slope, tc, masks, sigma_only=True),
         per_frame, mlp_bound(CHUNK * N_COARSE, True)),
        (ray_march_mlp, "render", f"full [{CHUNK} x {s_f}]",
         lambda f: f(packed, base, slope, tf_plain, masks), per_frame,
         mlp_bound(CHUNK * s_f, False)),
        (ray_march_quadrature, "render", f"sigma-only [{CHUNK} x {N_COARSE}]",
         lambda f: f(coarse_sig, tc, True, True, True), per_frame,
         _bound(CHUNK * (3 * N_COARSE + 1) * F32B, CHUNK * N_COARSE * 9,
                PEAK_F32_FLOPS)),
        (ray_march_quadrature, "render", f"full, no weights [{CHUNK} x {s_f}]",
         lambda f: f(fine_in, tf_plain, True, False, False), per_frame,
         _bound(CHUNK * (5 * s_f + 4) * F32B, CHUNK * s_f * 16,
                PEAK_F32_FLOPS)),
    ]
    modes += _train_modes(train_in, cfg)
    totals = {"render": {}, "train": {}}
    for k, path, mode, call, count, (bms, by), *design in modes:
        kms = _time_ms(lambda: call(k), 20)
        paced = _time_ms(lambda: call(k), 20, spin=False)
        pms = _time_ms(lambda: call(k.plain), 3)
        dms = 1e3 * design[0] / PEAK_BYTES if design else 0.0
        log(f"time {k.name} {mode}: {kms:.4f} ms/launch kernel "
            f"({paced:.4f} paced by the host's launches), {pms:.3f} "
            f"ms/launch plain, bound {bms:.4f} ms/launch ({by}), "
            f"{kms / bms:.1f}x bound"
            + (f", the design's bytes {dms:.4f} ms/launch" if design else "")
            + f", {count} launches per "
            f"{'frame' if path == 'render' else 'step'} {card_tag}")
        tot = totals[path].setdefault(k.name, [0.0, 0.0, 0.0, {}, None])
        tot[0] += count * kms
        tot[1] += count * pms
        tot[2] += count * bms
        tot[3][by] = tot[3].get(by, 0.0) + count * bms
        if design:
            tot[4] = (tot[4] or 0.0) + count * dms
    _t3_bound(cfg, totals["train"], card_tag)

    # ---- 8. profile: device time by kernel, device busy share -----------
    log(json.dumps({"profile": _profile(
        lambda: render_orbit(nerf, FRAMES, img_wh=IMG, **ORBIT),
        len(FRAMES), "frame"), "card": card}))
    log(json.dumps({"profile_train": _profile(
        lambda: tnerf.fit(dataset, epochs=1, verbose=False), len(dataset),
        "step"), "card": card}))

    entries = []
    for k in KERNELS:
        kms, pms, bms, by, dms = totals["train"][k.name]
        log(f"time {k.name}: {kms:.4f} ms/step kernel, {pms:.3f} ms/step "
            f"plain, bound {bms:.4f} ms/step ({_by(by)})"
            + (f", the design's bytes {dms:.4f} ms/step" if dms else "")
            + f" {card_tag}")
        entry = {
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": train_launches[k.name],
            "max_abs_err": errors[k.name],
            "rel_err": dict(zip(("max", "norm"), rel_errors[k.name])),
            "tolerance": {"render": TOL.get(k.name),
                          "train": TRAIN_TOL.get(k.name)},
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": _by(by),
            "library_ms": None, "design_bytes_ms": dms,
            "per": f"{IMG}^2 train step, {IMG * IMG // TRAIN_CHUNK} chunks "
                   f"of {TRAIN_CHUNK} rays; launches over {n_steps} steps"}
        if k.name in totals["render"]:
            kms, pms, bms, by, _ = totals["render"][k.name]
            log(f"time {k.name}: {kms:.4f} ms/frame kernel, {pms:.3f} "
                f"ms/frame plain, bound {bms:.4f} ms/frame ({_by(by)}) "
                f"{card_tag}")
            entry["render_frame"] = {
                "launches": render_launches[k.name], "ms": kms,
                "plain_ms": pms, "bound_ms": bms, "bound_by": _by(by),
                "per": f"{IMG}^2 frame, {per_frame} chunks of {CHUNK} rays; "
                       f"launches over {len(FRAMES)} frames"}
        entries.append(entry)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _by(shares: dict) -> str:
    """The bound that holds for most of a kernel's summed bound time."""
    return max(shares, key=shares.get)


def _bound(nbytes, ops, peak_ops):
    """(ms, "bytes" or "operations"): the least time of the work."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _merge_bound(rays):
    """sample_merge per ray, by the least work the function needs: 6
    float32 operations per coarse bin (eps, sum, divide, prefix sum,
    midpoint), a binary search plus 6 operations of interpolation per draw,
    and a binary search into the other array per merged depth."""
    lg_c, lg_f = (N_COARSE - 1).bit_length(), (N_FINE - 1).bit_length()
    ops = rays * (6 * N_COARSE + N_FINE * (2 * lg_c + 6) + N_COARSE * lg_f)
    nbytes = rays * (2 * N_COARSE + N_FINE + N_COARSE + N_FINE) * F32B
    return _bound(nbytes, ops, PEAK_F32_FLOPS)


def _time_ms(fn, iters, spin=True):
    """Device ms per call. With ``spin`` a spin kernel (cycles at the
    H100's ~2 GHz) holds the stream while the host enqueues every call, so
    the events time the card's work and not the host's launch overhead;
    without it, calls run back to back at the pace the host launches
    them."""
    import torch

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


def _profile(run, units: int, unit: str) -> dict:
    """``run()`` under ``torch.profiler``: host wall and device busy ms per
    ``unit`` (the union of the card's activity spans), and device ms per
    ``unit`` of the busiest kernels."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
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
                            + (end - start) / 1e3 / units)
        busy_us += max(0.0, end - max(start, reach))   # union of spans
        reach = max(reach, end)
    device_ms = busy_us / 1e3 / units if spans else None
    wall_ms = 1e3 * wall / units
    return {f"{unit}s": units, "img_wh": IMG,
            f"wall_ms_per_{unit}": wall_ms,
            f"device_ms_per_{unit}": device_ms,
            "device_busy_share": device_ms / wall_ms if spans else None,
            f"device_ms_per_{unit}_by_kernel": dict(sorted(
                per_kernel.items(), key=lambda kv: -kv[1])[:10])}


def _to(params, device):
    from keras_nerf_tpu_torch.models.engine import tree_map

    return tree_map(lambda x: x.to(device), params)


def _fog(params):
    params["sigma"]["bias"] += SIGMA_BIAS
    return params


# ---------------------------------------------------------------------------
# The training path.


def _spheres_scene(n_poses: int, seed: int, img: int = IMG):
    """``n_poses`` views of the spheres scene (the JAX package's synthetic
    fixture, ray traced in numpy) composited on white: ``(images
    [N, img, img, 4], poses [N, 4, 4], focal)``."""
    import numpy as np

    from keras_nerf_tpu_torch.data import get_focal_from_fov, pose_spherical
    from keras_nerf_tpu_torch.data.synthetic import render_pose
    from keras_nerf_tpu_torch.inference import ORBIT

    rng = np.random.default_rng(seed)
    poses = np.stack([pose_spherical(float(rng.uniform(0.0, 360.0)),
                                     float(rng.uniform(-60.0, -10.0)), 4.0)
                      for _ in range(n_poses)])
    rgba = np.stack([render_pose(c2w, img) for c2w in poses])
    alpha = rgba[..., 3:]
    images = np.concatenate([rgba[..., :3] * alpha + (1.0 - alpha), alpha],
                            axis=-1).astype(np.float32)
    return images, poses, get_focal_from_fov(ORBIT["fov"], img)


def _train_inputs(cfg, gen) -> dict:
    """One training chunk of 2048 rays spread over a 128^2 view of the
    spheres scene, with its targets, and the two passes' depths: the
    stratified coarse ones and the fine ones the plain versions sample
    from the coarse weights."""
    import torch

    from keras_nerf_tpu_torch.data import generate_ray_batch
    from keras_nerf_tpu_torch.inference import ORBIT
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models import init_mlp
    from keras_nerf_tpu_torch.ops import sorted_uniforms

    dev = torch.device("cuda")
    params = _fog(init_mlp(gen, cfg.mlp, cfg.in_xyz, cfg.in_dir))
    packed = trm.pack_mlp_params(params, cfg.mlp, cfg.pos_emb_xyz,
                                 cfg.pos_emb_dir)
    images, poses, focal = _spheres_scene(1, seed=1)
    rays = generate_ray_batch(poses, gen, image_height=IMG, image_width=IMG,
                              focal=focal, near=ORBIT["near"],
                              far=ORBIT["far"], n_samples=N_COARSE)
    stride = IMG * IMG // TRAIN_CHUNK
    o, d, tc = (x.reshape(-1, x.shape[-1])[::stride].contiguous()
                for x in rays)
    target = torch.as_tensor(images[0, ..., :3].reshape(-1, 3)[::stride],
                             device=dev).contiguous()
    base, slope, masks = trm.ray_encoding_coeffs(o, d, cfg.pos_emb_xyz,
                                                 cfg.pos_emb_dir)
    rgbs = trm.ray_march_mlp.plain(packed, base, slope, tc, masks)
    wc = trm.ray_march_quadrature.plain(rgbs.reshape(TRAIN_CHUNK, N_COARSE, 4),
                                        tc, True, False, True)[2]
    u = sorted_uniforms(gen, (TRAIN_CHUNK,), N_FINE)
    tf = trm.sample_merge.plain(tc, wc, u)
    return {"cfg": cfg, "packed": packed, "base": base, "slope": slope,
            "masks": masks, "target": target, "wc": wc, "u": u,
            "passes": {"coarse": {"t": tc, "weights": True},
                       "fine": {"t": tf, "weights": False}}}


def _rel_max(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _rel_norm(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _held(name: str, pairs, label: str, err=None, extra_ok: bool = True):
    """``(kernel, max_abs_err, relative max, relative norm, ok, label)`` of
    the (kernel, plain) array ``pairs`` against ``TRAIN_TOL[name]``: each of
    its keys bounds the worst pair; ``err`` (the absolute error) defaults to
    the worst pair's."""
    import torch

    tol = TRAIN_TOL[name]
    if err is None:
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in pairs)
    rel = max(_rel_max(a, b) for a, b in pairs)
    rel_norm = max(_rel_norm(a, b) for a, b in pairs)
    finite = all(bool(torch.isfinite(a.float()).all()) for a, _ in pairs)
    ok = (finite and extra_ok and err <= tol.get("abs", float("inf"))
          and rel <= tol.get("rel", float("inf"))
          and rel_norm <= tol.get("rel_norm", float("inf")))
    return name, err, rel, rel_norm, ok, label


def _train_kernel_checks(ti: dict):
    """Each training kernel and mode against its plain version on the same
    inputs (the plain outputs of the step before), at both passes' shapes.
    Yields :func:`_held` tuples and keeps the plain intermediates in ``ti``
    for the timing phase."""
    import torch

    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models.engine import tree_leaves

    cfg, packed = ti["cfg"], ti["packed"]
    u, n = cfg.dense_units, cfg.n_layers
    tc = ti["passes"]["coarse"]["t"]
    tf_k = trm.sample_merge(tc, ti["wc"], ti["u"])
    torch.cuda.synchronize()
    yield _held("sample_merge", [(tf_k, ti["passes"]["fine"]["t"])],
                f"sample_merge train [{TRAIN_CHUNK}, {N_COARSE} + {N_FINE}]")
    del tf_k
    for name, p in ti["passes"].items():
        t = p["t"]
        r, s = t.shape
        shape = f"[{r} x {s}]"
        stash_k = trm.alloc_stash(r * s, u, n, t.device)
        stash_p = trm.alloc_stash(r * s, u, n, t.device)
        args = (packed, ti["base"], ti["slope"], t, ti["masks"])
        out_k = trm.ray_march_mlp(*args, stash=stash_k)
        out_p = trm.ray_march_mlp.plain(*args, stash=stash_p)
        torch.cuda.synchronize()
        pairs = [(stash_k[k], stash_p[k]) for k in ("enc", "features", "rf")]
        pairs += list(zip(stash_k["h"], stash_p["h"]))
        yield _held("ray_march_mlp", pairs + [(out_k, out_p)],
                    f"ray_march_mlp train, outputs and kept activations "
                    f"{shape}", err=float((out_k - out_p).abs().max()))
        del stash_k, out_k

        rgbs = out_p.reshape(r, s, 4)
        kw = dict(target=ti["target"], loss_scale=2.0 / (3 * r))
        q_args = (rgbs, t, True, False, p["weights"])
        q_k = trm.ray_march_quadrature(*q_args, **kw)
        q_p = trm.ray_march_quadrature.plain(*q_args, **kw)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(q_k[:3], q_p[:3])
                  if a is not None)
        yield _held("ray_march_quadrature", list(zip(q_k[3:], q_p[3:])),
                    f"ray_march_quadrature with_grad, "
                    f"{'weights' if p['weights'] else 'no weights'} {shape}",
                    err=err)

        cots_k = trm.mlp_backward(q_p[3], q_p[4], packed, stash_p)
        cots_p = trm.mlp_backward.plain(q_p[3], q_p[4], packed, stash_p)
        torch.cuda.synchronize()
        pairs = [(cots_k["d_rf"], cots_p["d_rf"]),
                 (cots_k["d_sf"], cots_p["d_sf"])]
        pairs += list(zip(cots_k["d_pre"], cots_p["d_pre"]))
        yield _held("mlp_backward", pairs,
                    f"mlp_backward, every cotangent {shape}")
        del cots_k

        want = trm.mlp_weight_grad.plain(stash_p, cots_p,
                                         trm.zero_grads(packed))
        runs = [trm.mlp_weight_grad(stash_p, cots_p, trm.zero_grads(packed))
                for _ in range(2)]
        torch.cuda.synchronize()
        leaves = [tree_leaves(x) for x in (*runs, want)]
        same = all(torch.equal(a, b) for a, b in zip(leaves[0], leaves[1]))
        log(f"check mlp_weight_grad {shape}: two runs identical bits: {same}")
        yield _held("mlp_weight_grad", list(zip(leaves[0], leaves[2])),
                    f"mlp_weight_grad, every packed gradient, twice {shape}",
                    extra_ok=same)
        p.update(stash=stash_p, cots=cots_p, rgbs=rgbs, quad=q_p)


class _StepLog:
    """A quiet callback: keeps each step's metrics, fetched once per epoch
    (``verbose = False`` leaves fit's deferred fetch on)."""

    verbose = False

    def __init__(self):
        self.logs = []

    def on_train_batch_end(self, batch, logs):
        self.logs.append(logs)


def _train_main_path(cfg, card_tag):
    """20 steps of ``NeRF.fit`` at 128^2, 2048-ray chunks, Adam at 1e-3,
    on 5 views of the spheres scene; counts every kernel's launches."""
    import math

    import torch

    from keras_nerf_tpu_torch.data import NeRFDataset
    from keras_nerf_tpu_torch.inference import ORBIT
    from keras_nerf_tpu_torch.kernels import KERNELS, reset_launch_counts
    from keras_nerf_tpu_torch.models import NeRF

    images, poses, focal = _spheres_scene(TRAIN_POSES, seed=0)
    dataset = NeRFDataset(images, poses, focal=focal, near=ORBIT["near"],
                          far=ORBIT["far"], n_samples=N_COARSE, batch_size=1,
                          shuffle=True, seed=0, device="cuda")
    nerf = NeRF(config=cfg).compile(
        optimizer="adam", batch_size=1, image_height=IMG, image_width=IMG,
        ray_chunks=TRAIN_CHUNK, white_background=True, learning_rate=1e-3,
        device="cuda", seed=0)
    nerf.train_step(next(iter(dataset)))        # warm-up
    torch.cuda.synchronize()
    steps = _StepLog()
    reset_launch_counts()
    t0 = time.perf_counter()
    nerf.fit(dataset, epochs=TRAIN_EPOCHS, callbacks=[steps], verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    n = len(steps.logs)
    chunks = IMG * IMG // TRAIN_CHUNK
    expected = {k.name: 2 * n * chunks for k in KERNELS}
    expected["sample_merge"] = n * chunks
    fine = [m["fine_loss"] for m in steps.logs]
    log(f"train main path: {n} steps of NeRF.fit at {IMG}^2, ray_chunks "
        f"{TRAIN_CHUNK}, in {wall:.3f} s: {1e3 * wall / n:.1f} ms/step, "
        f"{n * IMG * IMG / wall:.0f} rays/s (wall, host clock) {card_tag}; "
        f"launches {launches}")
    log("train main path: fine_loss by step "
        + " ".join(f"{v:.4f}" for v in fine))
    log(f"train main path: grad norms coarse "
        f"{min(m['coarse_grad_norm'] for m in steps.logs):.3e}.."
        f"{max(m['coarse_grad_norm'] for m in steps.logs):.3e}, fine "
        f"{min(m['fine_grad_norm'] for m in steps.logs):.3e}.."
        f"{max(m['fine_grad_norm'] for m in steps.logs):.3e}")
    if n != TRAIN_POSES * TRAIN_EPOCHS or launches != expected:
        fail(f"train launch counts {launches} != expected {expected}")
    if not all(math.isfinite(v) for m in steps.logs for v in m.values()):
        fail("non-finite training metrics")
    if not all(m[k] > 0.0 for m in steps.logs
               for k in ("coarse_grad_norm", "fine_grad_norm")):
        fail("a gradient norm is zero")
    if not sum(fine[-5:]) / 5 < fine[0]:
        fail(f"the fine loss did not fall: {fine}")
    return nerf, dataset, launches, n


def _big_chunk_step(nerf, dataset, card_tag):
    """One step at 16384-ray chunks: the fine pass runs in sub-launches of
    about 1 M points; prints the peak device memory."""
    import math

    import torch

    from keras_nerf_tpu_torch.kernels import KERNELS, reset_launch_counts
    from keras_nerf_tpu_torch.kernels.ray_march import train_sub_launches

    kw = dict(optimizer="adam", batch_size=1, image_height=IMG,
              image_width=IMG, white_background=True, learning_rate=1e-3,
              device="cuda", seed=0)
    nerf.compile(ray_chunks=BIG_CHUNK, **kw)
    batch = next(iter(dataset))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = nerf.train_step(batch)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    subs = (len(train_sub_launches(BIG_CHUNK, N_COARSE))
            + len(train_sub_launches(BIG_CHUNK, N_COARSE + N_FINE)))
    expected = {k.name: subs for k in KERNELS}
    expected["sample_merge"] = IMG * IMG // BIG_CHUNK
    peak = torch.cuda.max_memory_allocated()
    log(f"train step at ray_chunks {BIG_CHUNK}: {1e3 * wall:.1f} ms wall, "
        f"peak device memory {peak / 2**30:.2f} GiB "
        f"({(peak - base_mem) / 2**30:.2f} GiB above the step's start) "
        f"{card_tag}; launches {launches}")
    if launches != expected:
        fail(f"launch counts {launches} != expected {expected}")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail("non-finite metrics at the large chunk")
    nerf.compile(ray_chunks=TRAIN_CHUNK, **kw)


def _train_step_vs_cpu(nerf, cfg, gen):
    """One SGD (lr 1) step of the card from the trained weights against the
    same step on the CPU's plain versions: 16^2, 2 chunks, same rays,
    targets and draws. The parameter change is the gradient."""
    import numpy as np
    import torch

    from keras_nerf_tpu_torch.data import generate_ray_batch
    from keras_nerf_tpu_torch.inference import ORBIT
    from keras_nerf_tpu_torch.models import engine
    from keras_nerf_tpu_torch.models.engine import tree_leaves
    from keras_nerf_tpu_torch.ops import sorted_uniforms

    images, poses, focal = _spheres_scene(1, seed=2, img=E2E_IMG)
    rays = generate_ray_batch(poses, gen, image_height=E2E_IMG,
                              image_width=E2E_IMG, focal=focal,
                              near=ORBIT["near"], far=ORBIT["far"],
                              n_samples=N_COARSE)
    batch = (torch.as_tensor(images, device="cuda"), rays)
    draws = [sorted_uniforms(gen, (E2E_CHUNK,), N_FINE)
             for _ in range(E2E_IMG * E2E_IMG // E2E_CHUNK)]
    opt = engine.make_optimizer("sgd", 1.0)
    cpu = torch.device("cpu")
    params = (nerf.state.coarse_params, nerf.state.fine_params)
    results = []
    for device in ("cuda", cpu):
        p0 = [_to(p, device) for p in params]
        state = engine.TrainState(p0[0], p0[1], {}, {}, 0)
        moved = (batch[0].to(device), tuple(x.to(device) for x in batch[1]))
        s1, metrics = engine.train_step(state, moved,
                                        [x.to(device) for x in draws], opt,
                                        cfg, E2E_CHUNK)
        grads = [[(a - b).double().cpu() for a, b in
                  zip(tree_leaves(p), tree_leaves(q))]
                 for p, q in zip(p0, (s1.coarse_params, s1.fine_params))]
        results.append(({k: float(v) for k, v in metrics.items()}, grads))
    (m_g, g_g), (m_c, g_c) = results
    loss_err = max(abs(m_g[k] - m_c[k]) / abs(m_c[k])
                   for k in ("coarse_loss", "fine_loss"))
    rel_norm = rel_max = 0.0
    for a, b in zip(sum(g_g, []), sum(g_c, [])):
        rel_norm = max(rel_norm, float((a - b).norm() / b.norm()))
        rel_max = max(rel_max, float((a - b).abs().max() / b.abs().max()))
    log(f"train step {E2E_IMG}^2, card kernels vs CPU plain versions: loss "
        f"relative err {loss_err:.3e} (tolerance {STEP_TOL['loss_rtol']}), "
        f"worst leaf gradient relative norm {rel_norm:.3e} (tolerance "
        f"{STEP_TOL['grad_rel_norm']}), relative max {rel_max:.3e} "
        f"(tolerance {STEP_TOL['grad_rel_max']}); losses card "
        f"{m_g['coarse_loss']:.5f}/{m_g['fine_loss']:.5f}, cpu "
        f"{m_c['coarse_loss']:.5f}/{m_c['fine_loss']:.5f}")
    if not (np.isfinite([loss_err, rel_norm, rel_max]).all()
            and loss_err <= STEP_TOL["loss_rtol"]
            and rel_norm <= STEP_TOL["grad_rel_norm"]
            and rel_max <= STEP_TOL["grad_rel_max"]):
        fail("the card's train step disagrees with the plain versions")


def _train_modes(ti: dict, cfg) -> list:
    """The timing modes of the training kernels at one 2048-ray chunk per
    pass, each launched once per chunk: 8 times per 128^2 step.

    A mode's bound is its share of T3's least work, whatever the split into
    kernels moves: the forward's, dX's and dW's unpadded products at the
    bf16 peak for the three MLP kernels; for the quadrature and
    ``sample_merge``, the unpadded arrays that T3 reads and writes (image,
    depth, coarse weights, the head cotangents of three colours and sigma)
    against their float32 operations. The bytes that the split itself moves
    (the kept activations and cotangents, the 16-column padded colour
    cotangent) come apart as the 7th item: the design's own cost."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models.engine import tree_leaves

    packed = ti["packed"]
    u, n = cfg.dense_units, cfg.n_layers
    per_step = IMG * IMG // TRAIN_CHUNK
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       tree_leaves(packed))
    grad_bytes = 2 * F32B * sum(t.numel() for t in tree_leaves(packed))
    stash_b = 2 * (128 + n * u + u + u // 2)         # 5,120 B per point
    cots_b = 2 * (u // 2 + u + trm.D_HEAD + n * u)  # 4,896 B per point
    head_b = 2 * 3 + 2                              # d_rgb, d_sigma: bf16
    head_pad_b = 2 * trm.D_HEAD + 2                 # d_rgb as [P, 16]
    fwd = trm.fwd_flop_per_point(cfg.mlp)
    dx = trm.bwd_dx_flop_per_point(cfg.mlp)
    modes = [(trm.sample_merge, "train", f"[{TRAIN_CHUNK}, {N_COARSE} + "
              f"{N_FINE}]", lambda f: f(ti["passes"]["coarse"]["t"], ti["wc"],
                                        ti["u"]),
              per_step, _merge_bound(TRAIN_CHUNK))]
    for name, p in ti["passes"].items():
        t, r = p["t"], TRAIN_CHUNK
        pts = r * t.shape[1]
        shape = f"[{r} x {t.shape[1]}]"
        stash = trm.alloc_stash(pts, u, n, t.device)
        cots = trm.alloc_cotangents(pts, u, n, t.device)
        acc = trm.zero_grads(packed)
        q_kw = dict(target=ti["target"], loss_scale=2.0 / (3 * r))
        mlp_io = 2 * r * 128 * F32B + weight_bytes + pts * (F32B + 16)
        w_b = F32B if p["weights"] else 0
        modes += [
            (trm.ray_march_mlp, "train", f"train {name} {shape}",
             lambda f, t=t, stash=stash: f(packed, ti["base"], ti["slope"],
                                           t, ti["masks"], stash=stash),
             per_step, _bound(mlp_io, pts * fwd, PEAK_BF16_FLOPS),
             mlp_io + pts * stash_b),
            (trm.ray_march_quadrature, "train",
             f"with_grad {name} {shape}",
             lambda f, p=p, t=t: f(p["rgbs"], t, True, False, p["weights"],
                                   **q_kw),
             per_step, _bound(pts * (20 + head_b + w_b) + r * 28, pts * 38,
                              PEAK_F32_FLOPS),
             pts * (20 + head_pad_b + w_b) + r * 28),
            (trm.mlp_backward, "train", f"{name} {shape}",
             lambda f, p=p, cots=cots: f(p["quad"][3], p["quad"][4], packed,
                                         p["stash"], cots),
             per_step, _bound(weight_bytes + pts * head_b, pts * dx,
                              PEAK_BF16_FLOPS),
             weight_bytes + pts * (head_pad_b + 2 * n * u + cots_b)),
            (trm.mlp_weight_grad, "train", f"{name} {shape}",
             lambda f, p=p, acc=acc: f(p["stash"], p["cots"], acc),
             per_step, _bound(grad_bytes, pts * fwd, PEAK_BF16_FLOPS),
             grad_bytes + pts * (stash_b + cots_b + 2 * trm.D_HEAD)),
        ]
    return modes


def _t3_bound(cfg, train_totals: dict, card_tag):
    """The least time of T3 per 128^2 step, from its operations alone;
    the sum of the kernels' bounds; and the bytes that this design's
    kernels move, for comparison."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm

    flop_pt = (2 * trm.fwd_flop_per_point(cfg.mlp)
               + trm.bwd_dx_flop_per_point(cfg.mlp))
    points = IMG * IMG * (2 * N_COARSE + N_FINE)
    bounds = sum(v[2] for v in train_totals.values())
    design = sum(v[4] or 0.0 for v in train_totals.values())
    log(f"T3 bound per {IMG}^2 step: {flop_pt:,} FLOP per point x "
        f"{points:,} points = {flop_pt * points:.4e} FLOP, "
        f"{1e3 * flop_pt * points / PEAK_BF16_FLOPS:.3f} ms at 989 TFLOP/s "
        f"(bf16 dense, 700 W); the kernels' bounds add up to {bounds:.3f} "
        f"ms; the bytes the split moves (kept activations and cotangents, "
        f"padding included) take {design:.3f} ms at 3.35 TB/s {card_tag}")


if __name__ == "__main__":
    sys.exit(main())
