#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``keras_nerf_tpu_torch`` from ``kernels/csrc``
and drives both paths of the port at full width (8 x 256 MLPs, 64 coarse +
128 fine samples, 128^2 images), with random weights from fixed seeds:

* render: holds the render kernels against their plain PyTorch versions at
  4096-ray chunks (``ray_march_mlp``'s persistent route also bit for bit
  against its resident kernel, and every orbit launch on the persistent
  route; ``sample_merge`` also on heavy-tailed weights and on all
  mass in one bin in its three modes; every ``sample_merge`` check runs the
  kernel twice, with identical bits, and logs whether it equals its plain
  version bit for bit), renders 4 orbit frames through
  ``inference.render_orbit`` and holds a small frame against the plain
  versions run on the CPU;
* train: holds each training kernel and mode against its plain version at
  2048-ray chunks (and ``mlp_weight_grad`` against itself, bit for bit),
  trains 20 steps through ``NeRF.fit`` on an in-memory spheres scene, takes
  one step at 16384-ray chunks (peak memory), and holds one card step
  against the same step on the CPU, also at 64 + 1024 samples a ray
  (ROADMAP C14: the with_grad quadrature past 1024 samples, also held
  against its plain version and timed at [2048 x 1088]);
* train with a custom loss (``compile(loss=l1)``): holds ``apply_mlp``
  (T5, with and without its stash), the output-head mode of
  ``mlp_backward`` and ``fused_mlp_backward`` (T6) against their plain
  versions at the same chunks, trains 20 steps through ``NeRF.fit``, takes
  one step at 16384-ray chunks, holds the MSE as a callable (T5/T6)
  against the fused MSE (T3) on the same points, pass by pass over a 16^2
  step's chunks with the fine depths drawn once, and the card's L1 step
  against the CPU's;
* the int8 render tier (``compile(quantized_render=True)``): calibrates the
  fog weights through ``quantize_render_params``, holds
  ``ray_march_mlp_int8`` (T4) against its plain version in both modes at
  4096-ray chunks, renders 4 orbit frames through ``render_orbit`` and
  holds a 16^2 int8 frame against the same int8 weights on the CPU;
* the tensor-core ceiling probe (T7): holds ``mma_ceiling`` against its
  plain version at 2 passes, reads it at the full 16 against the plain
  version with float64 sums (its drift at most ``CEILING_DRIFT_RATIO``
  times the plain version's), and runs ``profile_mma_ceiling.measure``
  (TFLOP/s and the L2 weight rate of the ``wgmma`` product loop that the
  MLP kernels run, alone);
* the occupancy render (``inference --occupancy_grid 128``): bakes the fog
  weights' 128^3 grid through ``NeRF.bake_occupancy`` (8 ``apply_mlp``
  launches, one chunk held against its plain version), holds
  ``sample_merge`` in its no-merge and partner modes, ``ray_march_mlp`` and
  ``ray_march_mlp_int8`` in full mode and ``ray_march_quadrature`` without
  weights against their plain versions at 4096 rays x 64 samples over the
  grid's probe bins, renders 4 orbit frames
  through ``render_orbit(occupancy_samples=64)`` in bf16 and int8 (4
  ``sample_merge``, 4 full MLP and 4 quadrature launches per frame) and
  holds a 16^2 occupancy frame against the CPU's on the card's grid;
* the fast render (``inference --fast_render``), on the fog weights:
  ``sample_merge``'s no-merge mode at [4096, 64 -> 96] on the coarse
  weights, the full forward and the quadrature without weights at [4096 x
  96] against their plain versions, 4 orbit frames at ``--fast_render 96``
  in bf16 and 4 at 64 in int8 (per chunk a sigma-only MLP and quadrature,
  ``sample_merge`` without partner, the full MLP at K samples and the
  quadrature without weights; no plain call), 16^2 frames of both against
  the CPU's; then the quality tools' entry points on a 16^2 scene written
  by the port's writer: 2 epochs of ``train_single``, ``eval_checkpoint``
  and ``render_frontier --bench_wh 16 --iters 2``;
* the occupancy-train tier (``train_single --occupancy_train 128
  --occupancy_train_samples 64 --occupancy_train_probe 64``) and pixel
  sampling, after 60 exact steps from the seed-0 weights: ``NeRF.fit``
  merged (one exact epoch, then a 128^3 bake and occupancy steps each
  epoch: ``sample_merge`` in its partner mode, 8 launches a step, then T3
  at [2048 x 128]), with ``--occupancy_train_no_merge`` (the no-merge mode,
  T3 at [2048 x 64]) and with ``--occupancy_train_update 2
  --occupancy_train_cache``, each run's launches, ``sample_merge`` modes,
  MLP depths, probe gathers and bakes' occupied shares held; both
  ``sample_merge`` modes against their plain versions on the path's
  inputs, and T3's chain (twice, identical bits) on the inputs of the
  path's coarse pass [2048 x 64] (no weights) and merged fine pass
  [2048 x 128]; 16^2 occupancy steps on the card against the CPU (merged and
  not, the MSE step's pinning) and the cached-rows step against the probed
  one, bit for bit; 5 ``--pixel_sampling`` steps; each tier timed;
* data parallelism (``_data_parallel_phases``), then the last ported
  tools (``_a15_tools_phases``): ``real_scene_drill`` on its 800^2 scene
  for 1 epoch, ``lr_probe`` with 2 arms x 1 epoch x 10 steps and
  ``profile_step --chunks 2048`` (components, the host timeline and its
  five longest gaps), each failing unless every T3 kernel launched in it;
  then the profilers ported last at small sizes (``A15_PROFILERS``:
  ``profile_render`` and its ``--components``, ``profile_occtrain``,
  ``profile_probe``, ``profile_shard_step``, ``profile_pallas`` and its
  ``--components``, ``profile_ablate``, which builds every ablation
  library of both forwards, holds the build without a macro bit for bit
  against the package's kernels and times each ablation beside it), each
  failing unless every kernel it times launched in it; ``aabb_demo`` on a
  scale-2 16^2 scene and ``quantize_sim_ptq`` in its three modes on a
  16^2 scene, each trained 2 epochs, and the run-log tools
  (``extract_milestones``, ``plot_quality``, ``plot_compare``) on the
  r5best run log;
* u = 768 (3 layers) on every path: each bf16 kernel mode held against its
  plain version (twice, identical bits), the 16^2 render, an MSE and an L1
  step, a 32^3 bake, the int8 calibration and an int8 render, each against
  the CPU, and ``ray_march_mlp_int8`` at u = 512 and 768 against its plain
  version; each such kernel mode timed at [4096 x 64].

Each path's launch counts are read just after it runs. Then every kernel
and its plain version is timed with CUDA events, beside the launch floor
(``torch.cuda._sleep(0)`` timed the same way) (``mlp_weight_grad`` also
beside its cuBLAS yardstick, one product per weight array, and
``mlp_backward``, ``ray_march_mlp`` and ``apply_mlp`` beside their PyTorch
chains, one bf16 matmul per layer; T1's and T2's MLP modes also on both of
``ray_march_mlp``'s routes in turns; the
card's SM clock, power and temperature sampled before and after), and the
five model paths (the occupancy render among them), the two fast-render
orbits and the three occupancy-train tiers are profiled with
``torch.profiler``:
device time by kernel and the device's busy share. A last profiler phase
(``profile_quadrature``) fails unless each ``ray_march_quadrature`` call of
the paths' modes runs one kernel on the card and nothing else (no fill).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
as the last line, ``{"ok": true, "device": {...}}``. Exits non-zero, with
no result line, when there is no card, outside the repository, or when any
phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak, 700 W
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 tensor-core peak, 700 W
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
F32B = 4

CHUNK = 4096
N_COARSE, N_FINE = 64, 128
IMG = 128
FRAMES = [0.0, 10.0, 20.0, 30.0]
TRAIN_CHUNK = 2048         # the training CLI's default --ray_chunks
# ROADMAP C14: --num_fine_samples 1024, fine S = 64 + 1024, past the 1024
# samples a ray that the with_grad quadrature once refused.
C14_FINE = 1024
BIG_CHUNK = 16384          # the round-5 recipe's --ray_chunks
TRAIN_POSES, TRAIN_EPOCHS = 5, 4   # 20 steps
E2E_IMG, E2E_CHUNK = 16, 128       # 2 chunks
# inference --occupancy_grid 128 --occupancy_samples 64, 64 probe bins.
OCC_GRID, OCC_SAMPLES, OCC_PROBE = 128, 64, 64
# The fog has no surface: at the inference CLI's default threshold (1.0)
# its grid comes out empty or full, depending on the draw of the weights.
# The threshold is set, as a user sets --sigma_threshold for a scene, at
# this quantile of the density over the voxels: after one dilation about
# half the grid is occupied, so the probe bins' CDF is far from uniform.
OCC_QUANTILE = 0.8
OCC_SHARE = (0.05, 0.95)
# inference --fast_render: the bf16 orbit at 96 importance samples a ray and
# the int8 one at 64, two of the render frontier's fast tiers.
FAST_RENDER, FAST_RENDER_INT8 = 96, 64
TOOLS_IMG = 16   # the quality tools' scene

# Tolerances of kernel vs plain version on the same inputs, with reasons.
TOL = {
    # The plain version computes the same function in the same float32
    # operations (the 0-prepended CDF summed bin after bin, the brackets,
    # no fused multiply-add): identical bits expected (and logged); the
    # bound allows one ulp of a depth in [2, 6].
    "sample_merge": 1e-6,
    # Same bf16 operands and float32 encoding bit for bit; the sums run in
    # another order, which can flip a bf16 rounding of an activation.
    "ray_march_mlp": 3e-2,
    # Float32 scan and sums in another order.
    "ray_march_quadrature": 1e-4,
    # int8 codes and int32 sums are exact and the float32 epilogue runs in
    # the plain version's order, one rounding per step: only expf in the
    # sigmoid differs (~1e-7), unless an encoding lane that the plain
    # version's float64 FMA emulation double-rounds moves one code by one
    # step.
    "ray_march_mlp_int8": 1e-3,
    # Relative to the largest output: bf16 activations rounded after sums in
    # another order, through 16 layers (as ray_march_mlp).
    "mma_ceiling": 3e-2,
}
# The probe's shapes, the TPU script's defaults: measured, and checked with
# the chain cut to 2 passes (16 layers): bf16 roundings of sums taken in
# another order compound through the layers, and at the 16 passes measured
# the kernel and the plain version drift about 7e-2 of the largest output
# apart on an H100.
CEILING_RUN = dict(t=1536, u=256, rep=16, grid=128)
CEILING_CHECK = dict(CEILING_RUN, rep=2)
# At the probe's full depth the kernel's drift from the plain version with
# float64 sums may be at most this multiple of the drift of the plain
# version with float32 sums from it, the measure of how far bf16 roundings
# of sums taken in another order compound over 128 layers (ROADMAP C7).
# The plain version's float32 products run in full IEEE float32 (TF32 off);
# the kernel's accumulate on the tensor cores, whose float32 sums align
# the products with fewer guard bits: at equal depth they drift further,
# 1.8x in the first reading (bare mode, H100), hence 2.
CEILING_DRIFT_RATIO = 2.0
# The same chain summed on the tensor cores (a bf16 cuBLAS product with a
# float32 output, kernels/ceiling.py:pytorch_chain) is the plain order of the
# kernel's own accumulation: the kernel may drift at most as far as it
# (ROADMAP C7; it read ratio 1.000, H100, both modes).
CEILING_TC_RATIO = 1.0
# The shapes past the main path's 8 x 256, each with the widths T4 is also
# held at: ROADMAP C10, the bf16 kernels at u = 768, the JAX envelope's
# width after 512, on the resident route (T4 also at 512); ROADMAP C12, the
# streamed route: u = 1024 and 2048 (T4 at 1536 and 2048, past its
# resident 1280) at a cut depth of 3 layers with skip 1 (a trunk skip layer
# and the last one reading the encoding), and 40 layers of 256 with skip 4
# (9 skip layers, 53 weight-grad tasks: more than one launch holds). Kernel
# checks on a 16^2 frame's rays [256 x 64]; timings at the render chunk's
# coarse shape.
WIDE_SHAPES = (
    (dict(n_layers=3, dense_units=768, skip_layer=1), (512,)),
    (dict(n_layers=3, dense_units=1024, skip_layer=1), (1536,)),
    (dict(n_layers=3, dense_units=2048, skip_layer=1), ()),
    (dict(n_layers=40, dense_units=256, skip_layer=4), ()),
)
# The calibration on the card against the CPU's: activation ranges read
# from bf16 activations that can round the other way, one bf16 step
# (tests/test_torch_quantize.py), and codes within one step.
CALIB_RTOL = 8e-3
# (n_layers, dense_units) of the wide shapes whose int8 calibration is held
# against the CPU's on the card's fine calibration depths only (as the MSE
# and L1 steps are held on the card's draws), and not also on the CPU's
# own: at 40 layers the CPU alone, moved from its own fine depths onto the
# card's, moves the scales past CALIB_RTOL (the witness that
# _wide_phases prints), so the draw of depths, not the kernels, is what the
# budget cannot absorb there.
CALIB_PINNED = {(40, 256)}
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
# T5 is ray_march_mlp's MLP over a given encoding: held as its train mode.
# T6 ends in mlp_weight_grad's sums: held as they are, per leaf.
TRAIN_TOL["apply_mlp"] = TRAIN_TOL["ray_march_mlp"]
TRAIN_TOL["fused_mlp_backward"] = TRAIN_TOL["mlp_weight_grad"]
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
# Launches per training chunk of each path: the fused MSE step (T3) and the
# custom-loss step (T5 forward and recompute, T6's head/dX and dW, per pass).
MSE_LAUNCHES = {"sample_merge": 1, "ray_march_mlp": 2,
                "ray_march_quadrature": 2, "mlp_backward": 2,
                "mlp_weight_grad": 2}
CUSTOM_LAUNCHES = {"apply_mlp": 4, "mlp_backward": 2, "mlp_weight_grad": 2}


def l1_loss(y_true, y_pred):
    """The custom-loss path's loss: mean absolute error."""
    return (y_pred - y_true).abs().mean()


class SignedL1:
    """The L1 loss with its subgradient fixed per pixel-channel: call k
    returns ``mean(s_k (pred - true))``, which is ``mean(|pred - true|)``
    where ``s_k = sign(pred - true)``. Without ``signs`` every call takes
    its own signs; with the signs that a reference step recorded, the first
    ``len(signs)`` calls (a step's gradient calls, per chunk the coarse then
    the fine image) take those, and later calls (the step's reported
    losses) their own. Every call records its own signs and residuals."""

    def __init__(self, signs=None):
        self.signs = signs
        self.own, self.residual = [], []

    def __call__(self, y_true, y_pred):
        import torch

        r = y_pred - y_true
        k = len(self.own)
        self.own.append(torch.sign(r).detach().cpu())
        self.residual.append(r.detach().abs().cpu())
        use = (self.own[-1] if self.signs is None or k >= len(self.signs)
               else self.signs[k])
        return (use.to(r.device) * r).mean()


def mse_callable(y_true, y_pred):
    """The MSE as a callable of its own: not ``engine.mse_loss``, so it
    trains through T5/T6, not T3."""
    return ((y_pred - y_true) ** 2).mean()


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
    from keras_nerf_tpu_torch.kernels.ray_march import (
        encode_points,
        fwd_flop_per_point,
    )
    from keras_nerf_tpu_torch.models import NeRF, NeRFConfig, init_mlp
    from keras_nerf_tpu_torch.models.engine import (
        quantize_render_params,
        render_image_batch,
        tree_leaves,
    )
    from keras_nerf_tpu_torch.ops import sorted_uniforms
    from keras_nerf_tpu_torch.time_ray_march_mlp import (
        pytorch_chain as forward_chain,
    )

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
    # profile_ablate's ten libraries build on the host's cores while the
    # card runs the phases below; _a15_profiler_phases waits for them.
    from concurrent.futures import ThreadPoolExecutor

    from keras_nerf_tpu_torch import profile_ablate

    ablation_pool = ThreadPoolExecutor(max_workers=1)
    ablation_builds = ablation_pool.submit(profile_ablate.build_all,
                                           profile_ablate.build_plan())
    ablation_pool.shutdown(wait=False)

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
    rel_errors = {}

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
    tf_plain = sample_merge.plain(tc, wc, u, tc)
    _merge_held(f"render [{CHUNK}, {N_COARSE} + {N_FINE}]", tc, wc, u, tc,
                TOL["sample_merge"], errors)
    # A generator of their own, so that every draw after them is unchanged.
    merge_gen = torch.Generator(device=dev)
    merge_gen.manual_seed(14)
    for case in _merge_weight_cases(merge_gen, tc, u, wc):
        _merge_held(*case, TOL["sample_merge"], errors)
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
    # Both modes take the persistent route at u = 256: the resident kernel
    # on the same inputs gives the same bits.
    same = [torch.equal(got, ray_march_mlp(packed, base, slope, t, masks,
                                           sigma_only=so, route="resident"))
            for got, t, so in ((sig_kern, tc, True),
                               (rgbs_kern, tf_plain, False))]
    torch.cuda.synchronize()
    log(f"check ray_march_mlp persistent route against the resident kernel "
        f"(sigma-only, full): identical bits {same}")
    if not all(same):
        fail("the persistent route's bits differ from the resident kernel's")
    for label, err, ok, name in (
            (f"ray_march_mlp sigma-only [{CHUNK} x {N_COARSE}]", e1, ok1,
             "ray_march_mlp"),
            (f"ray_march_quadrature sigma-only [{CHUNK} x {N_COARSE}]", e2,
             ok2, "ray_march_quadrature"),
            (f"ray_march_mlp full [{CHUNK} x {s_f}]", e4, ok4,
             "ray_march_mlp"),
            (f"ray_march_quadrature full [{CHUNK} x {s_f}]", e5, ok5,
             "ray_march_quadrature"),
            (f"ray_march_quadrature full, no weights [{CHUNK} x {s_f}]", e6,
             ok6, "ray_march_quadrature")):
        log(f"check {label}: max_abs_err {err:.3e} (tolerance "
            f"{TOL[name]:.0e}) {'ok' if ok else 'FAIL'}")
    if not all((ok1, ok2, ok4, ok5, ok6)):
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
    expected = {k.name: 0 for k in KERNELS}
    expected.update(sample_merge=chunks, ray_march_mlp=2 * chunks,
                    ray_march_quadrature=2 * chunks)
    log(f"main path: {len(FRAMES)} frames {IMG}^2 in {wall:.3f} s "
        f"({1e3 * wall / len(FRAMES):.1f} ms/frame wall, host clock) "
        f"{card_tag}; launches {render_launches}; ray_march_mlp by route "
        f"{dict(ray_march_mlp.routes)}")
    if render_launches != expected:
        fail(f"launch counts {render_launches} != expected {expected}")
    if dict(ray_march_mlp.routes) != {"persistent": 2 * chunks}:
        fail(f"ray_march_mlp routes {dict(ray_march_mlp.routes)}: every "
             f"no-grad launch at u = 256 should take the persistent one")
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

    # ---- 4b. the int8 render tier (T4) ------------------------------------
    # Calibrated on the 128^2 frame's rays, the fog weights as both models.
    packed_q = quantize_render_params(params, fine_params, rays, gen, cfg)
    torch.cuda.synchronize()
    int8_in = _int8_kernel_checks(packed_q, base, slope, masks, tc, u, errors)
    quantized_launches, qnerf = _quantized_main_path(nerf, cfg, images,
                                                     card_tag)
    _quantized_e2e(packed_q, params, fine_params, cfg, gen)

    # ---- 4c. the tensor-core ceiling probe (T7) ---------------------------
    probe_launches, ceiling_in = _ceiling_probe(errors, card_tag)

    # ---- 4d. the occupancy render (B9: sample_merge's other two modes) ---
    occ_in = _occupancy_phases(nerf, cfg, gen, (o, d, tc), errors,
                               rel_errors, card_tag)

    # ---- 4e. the fast render (--fast_render) and the quality tools ------
    fast_in = _fast_render_phases(
        nerf, cfg, {"tc": tc, "wc": wc, "packed": packed, "base": base,
                    "slope": slope, "masks": masks},
        params, fine_params, packed_q, images, errors, card_tag)
    _quality_tools_phase(card_tag)

    # ---- 4f. every path past 8 x 256 (C10, C12) -----------------------
    wide = {"launches": {}, "times": {}}
    for shape, int8_widths in WIDE_SHAPES:
        t0 = time.perf_counter()
        got = _wide_phases(gen, errors, rel_errors, card_tag, shape,
                           int8_widths)
        label = _shape_label(shape)
        log(f"phases at {label}: {time.perf_counter() - t0:.1f} s (wall, "
            f"CPU references included)")
        for path, launches in got["launches"].items():
            wide["launches"][f"{path}_{label}"] = launches
        for name, rows in got["times"].items():
            wide["times"].setdefault(name, []).extend(rows)

    # ---- 5. training kernels against their plain versions ----------------
    train_in = _train_inputs(cfg, gen)
    _record_held(_train_kernel_checks(train_in), errors, rel_errors)

    # T5 and T6 at the same shapes, on the custom loss's cotangents.
    _record_held(_custom_kernel_checks(train_in), errors, rel_errors)

    # ---- 6. main path: training through NeRF.fit -------------------------
    dataset = _train_dataset()
    tnerf = _compile_train(NeRF(config=cfg), "mse")
    train_launches, n_steps = _fit_main_path(tnerf, dataset, MSE_LAUNCHES,
                                             "train", card_tag)

    # One step at the round-5 recipe's chunk: launches and peak memory.
    _big_chunk_step(tnerf, dataset, card_tag, "mse")

    # ---- 6b. main path of the custom loss: the trained model compiled
    # again with loss=l1 (it keeps its weights and Adam state) and fit.
    # From random weights, L1 on this mostly white scene empties it within
    # a few steps on every path, the float32 reference's included.
    _compile_train(tnerf, l1_loss)
    custom_launches, _ = _fit_main_path(tnerf, dataset, CUSTOM_LAUNCHES,
                                        "train custom (l1)", card_tag)
    _big_chunk_step(tnerf, dataset, card_tag, l1_loss)

    # 16^2 steps from the trained weights: the card against the CPU on
    # both paths, and T5/T6 against T3 on the same MSE and the same fine
    # depths.
    small = _small_step_inputs(gen)
    _compare_mse_steps(f"train step {E2E_IMG}^2, card kernels vs CPU plain "
                       f"versions", tnerf.state, small, cfg)
    _compare_l1_steps(f"l1 train step {E2E_IMG}^2, card kernels vs CPU "
                      f"plain versions, at the CPU's subgradient",
                      tnerf.state, small, cfg)
    _compare_passes(tnerf.state, small, cfg)
    _c14_step(tnerf.state, card_tag)

    # ---- 6c. the occupancy-train tier and pixel sampling (A10b) ---------
    occ_train = _occupancy_train_phases(cfg, dataset, errors, rel_errors,
                                        card_tag)

    # ---- 6d. data parallelism (A13): train --num_gpus 1 on NCCL, two
    # ranks on the card for a shard_rays step and the banded render ------
    dp_launches = _data_parallel_phases(card_tag)

    # ---- 6e. the last ported tools: the real-scene drill, lr_probe and
    # profile_step ------------------------------------------------------
    _a15_tools_phases(card_tag, ablation_builds)

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

    def mlp_chain(t, sigma_only):
        """The forward's PyTorch chain over this chunk's encoding."""
        enc = encode_points(base, slope, t, masks).reshape(-1, 128)
        return forward_chain(packed, enc, sigma_only=sigma_only)

    # Quadrature per sample: delta, sigma delta, scan, two exp, weight
    # (9 with the depth sum); + the weight sum and rgb sums (16).
    modes = [  # kernel, path, mode, call, launches per unit, bound
        (sample_merge, "render", f"[{CHUNK}, {N_COARSE} + {N_FINE}]",
         lambda f: f(tc, wc, u, tc), per_frame, _merge_bound(CHUNK)),
        (ray_march_mlp, "render", f"sigma-only [{CHUNK} x {N_COARSE}]",
         lambda f: f(packed, base, slope, tc, masks, sigma_only=True),
         per_frame, mlp_bound(CHUNK * N_COARSE, True), None, None,
         mlp_chain(tc, True)),
        (ray_march_mlp, "render", f"full [{CHUNK} x {s_f}]",
         lambda f: f(packed, base, slope, tf_plain, masks), per_frame,
         mlp_bound(CHUNK * s_f, False), None, None,
         mlp_chain(tf_plain, False)),
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
    modes += _custom_modes(train_in, cfg)
    modes += _quantized_modes(int8_in, cfg)
    modes += _ceiling_modes(ceiling_in)
    modes += _occupancy_modes(occ_in, cfg)
    modes += _occ_train_modes(occ_train)
    modes += _fast_render_modes(fast_in, cfg)
    totals = {"render": {}, "train": {}, "custom": {}, "quantized": {},
              "probe": {}, "occupancy": {}, "bake": {}, "merge_partner": {},
              "occ_train": {}, "occ_train_no_merge": {}, "fast_render": {},
              "fast_render_int8": {}}
    library = {path: {} for path in totals}   # ms per unit, where timed
    chain = {path: {} for path in totals}     # the PyTorch chain, likewise
    timed = []   # (kernel, path, mode, launches per unit, ms, plain, bound)
    clocks = [_gpu_clocks("before the kernel timings")]
    # What an empty launch costs in the same timing: the floor a small
    # kernel's time can fall to.
    floor = _time_ms(lambda: torch.cuda._sleep(0), 20)
    log(f"time launch floor (torch.cuda._sleep(0)): {floor:.4f} ms/launch, "
        f"{_time_ms(lambda: torch.cuda._sleep(0), 20, spin=False):.4f} "
        f"paced by the host's launches {card_tag}")
    for k, path, mode, call, count, (bms, by), *design in modes:
        kms = _time_ms(lambda: call(k), 20)
        paced = _time_ms(lambda: call(k), 20, spin=False)
        pms = _time_ms(lambda: call(k.plain), 3)
        dms = 1e3 * design[0] / PEAK_BYTES if design and design[0] else 0.0
        lms = (_time_ms(design[1], 20) if len(design) > 1 and design[1]
               else None)
        cms = _time_ms(design[2], 20) if len(design) > 2 else None
        log(f"time {k.name} {mode}: {kms:.4f} ms/launch kernel "
            f"({paced:.4f} paced by the host's launches), {pms:.3f} "
            f"ms/launch plain, bound {bms:.4f} ms/launch ({by}), "
            f"{kms / bms:.1f}x bound, launch floor {floor:.4f}"
            + (f", the design's bytes {dms:.4f} ms/launch" if dms else "")
            + (f", library (cuBLAS) {lms:.4f} ms/launch" if lms else "")
            + (f", PyTorch chain {cms:.4f} ms/launch" if cms else "")
            + f", {count} launches per {_UNIT[path]} {card_tag}")
        if lms is not None:
            library[path][k.name] = (library[path].get(k.name, 0.0)
                                     + count * lms)
        if cms is not None:
            chain[path][k.name] = chain[path].get(k.name, 0.0) + count * cms
        timed.append((k, path, mode, count, kms, pms, bms))
        tot = totals[path].setdefault(k.name, [0.0, 0.0, 0.0, {}, None])
        tot[0] += count * kms
        tot[1] += count * pms
        tot[2] += count * bms
        tot[3][by] = tot[3].get(by, 0.0) + count * bms
        if design and design[0]:
            tot[4] = (tot[4] or 0.0) + count * dms
    _route_turns(packed, (base, slope, masks), (tc, tf_plain), timed,
                 card_tag)
    clocks.append(_gpu_clocks("after the kernel timings"))
    log(json.dumps({"clocks": clocks, "card": card}))
    _t3_bound(cfg, totals["train"], card_tag)
    _t5_t6_times(train_in, cfg, timed, card_tag)
    _bake_times(occ_in, cfg, card_tag)

    # ---- 8. profile: device time by kernel, device busy share -----------
    log(json.dumps({"profile": _profile(
        lambda: render_orbit(nerf, FRAMES, img_wh=IMG, **ORBIT),
        len(FRAMES), "frame"), "card": card}))
    log(json.dumps({"profile_quantized": _profile(
        lambda: render_orbit(qnerf, FRAMES, img_wh=IMG, **ORBIT),
        len(FRAMES), "frame"), "card": card}))
    log(json.dumps({"profile_occupancy": _profile(
        lambda: render_orbit(occ_in["nerf"], FRAMES, img_wh=IMG,
                             occupancy_samples=OCC_SAMPLES, **ORBIT),
        len(FRAMES), "frame"), "card": card}))
    log(json.dumps({"profile_fast_render": {
        name: _profile(lambda m=m: render_orbit(m, FRAMES, img_wh=IMG,
                                                **ORBIT), len(FRAMES),
                       "frame")
        for name, m in fast_in["models"].items()}, "card": card}))
    for key, loss in (("profile_train", "mse"),
                      ("profile_train_custom", l1_loss)):
        _compile_train(tnerf, loss)
        log(json.dumps({key: _profile(
            lambda: tnerf.fit(dataset, epochs=1, verbose=False),
            len(dataset), "step"), "card": card}))
    # The occupancy-train tiers, profiled in _occupancy_train_phases right
    # after each one's timed steps: 5 steps that bake nothing.
    for name, prof in occ_train["profiles"].items():
        log(json.dumps({f"profile_train_occupancy_{name}": prof,
                        "card": card}))
    # One kernel a quadrature call, in every mode of the paths, and no
    # fill beside it: the kernel writes every output itself.
    quad_calls = {
        f"sigma-only [{CHUNK} x {N_COARSE}]":
            lambda: ray_march_quadrature(coarse_sig, tc, True, True, True),
        f"full, no weights [{CHUNK} x {s_f}]":
            lambda: ray_march_quadrature(fine_in, tf_plain, True, False,
                                         False)}
    for name, p in train_in["passes"].items():
        quad_calls[f"with_grad {name} [{TRAIN_CHUNK} x {p['t'].shape[1]}]"] = (
            lambda p=p: ray_march_quadrature(
                p["rgbs"], p["t"], True, False, p["weights"],
                target=train_in["target"],
                loss_scale=2.0 / (3 * TRAIN_CHUNK)))
    t14 = train_in["c14"]["t"]
    quad_calls[f"with_grad fine [{TRAIN_CHUNK} x {t14.shape[1]}]"] = (
        lambda: ray_march_quadrature(
            train_in["c14"]["rgbs"], t14, True, False, False,
            target=train_in["target"], loss_scale=2.0 / (3 * TRAIN_CHUNK)))
    log(json.dumps({"profile_quadrature": _one_kernel_each(
        quad_calls, "quadrature"), "card": card}))

    entries = []
    step_per = (f"{IMG}^2 train step, {IMG * IMG // TRAIN_CHUNK} chunks of "
                f"{TRAIN_CHUNK} rays")
    per = {"train": step_per, "custom": f"{step_per}, loss l1 (custom)",
           "quantized": f"{IMG}^2 int8 frame, {per_frame} chunks of {CHUNK} "
                        f"rays",
           "probe": "one probe run: each mode once at T={t}, u={u}, "
                    "rep={rep}, grid={grid}".format(**CEILING_RUN)}
    for k in KERNELS:
        by_path = {"render": render_launches[k.name],
                   "train": train_launches[k.name],
                   "train_custom": custom_launches[k.name],
                   "render_quantized": quantized_launches[k.name],
                   "ceiling_probe": probe_launches[k.name],
                   "occupancy_bake": occ_in["bake_launches"][k.name],
                   "render_occupancy": occ_in["launches"][k.name],
                   "render_occupancy_quantized":
                       occ_in["q_launches"][k.name],
                   **{path: launches[k.name] for path, launches
                      in occ_train["launches"].items()},
                   **{path: launches[k.name] for path, launches
                      in fast_in["launches"].items()},
                   **{path: launches[k.name]
                      for path, launches in wide["launches"].items()},
                   **{f"data_parallel_{path}": launches[k.name]
                      for path, launches in dp_launches.items()}}
        for path in ("train", "custom", "quantized", "probe"):
            if k.name not in totals[path]:
                continue
            kms, pms, bms, by, dms = totals[path][k.name]
            unit = f"ms/{_UNIT[path]}"
            lms = library[path].get(k.name)
            cms = chain[path].get(k.name)
            log(f"time {k.name}: {kms:.4f} {unit} kernel, {pms:.3f} {unit} "
                f"plain, bound {bms:.4f} {unit} ({_by(by)})"
                + (f", the design's bytes {dms:.4f} {unit}" if dms else "")
                + (f", library (cuBLAS) {lms:.4f} {unit}" if lms else "")
                + (f", PyTorch chain {cms:.4f} {unit}" if cms else "")
                + f" {card_tag}")
        # The numbers of the MSE step where the kernel runs there, else of
        # the first other path it runs on.
        path = next(p for p in ("train", "custom", "quantized", "probe")
                    if k.name in totals[p])
        kms, pms, bms, by, dms = totals[path][k.name]
        entry = {
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errors[k.name],
            "rel_err": dict(zip(("max", "norm"), rel_errors.get(
                k.name, (None, None)))),
            "tolerance": {"render": TOL.get(k.name),
                          "train": TRAIN_TOL.get(k.name)},
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": _by(by),
            "library_ms": library[path].get(k.name),
            "pytorch_chain_ms": chain[path].get(k.name),
            "design_bytes_ms": dms,
            "per": per[path]
                   + f"; launches over {n_steps} steps of each train path, "
                     f"{len(FRAMES)} frames of each render path, one bake "
                     f"and one probe run"}
        if path == "train" and k.name in totals["custom"]:
            kms, pms, bms, by, dms = totals["custom"][k.name]
            entry["custom_step"] = {
                "launches": custom_launches[k.name], "ms": kms,
                "plain_ms": pms, "bound_ms": bms, "bound_by": _by(by),
                "library_ms": library["custom"].get(k.name),
                "pytorch_chain_ms": chain["custom"].get(k.name),
                "design_bytes_ms": dms,
                "per": f"{step_per}, loss l1 (custom)"}
        if k.name in totals["render"]:
            kms, pms, bms, by, _ = totals["render"][k.name]
            cms = chain["render"].get(k.name)
            log(f"time {k.name}: {kms:.4f} ms/frame kernel, {pms:.3f} "
                f"ms/frame plain, bound {bms:.4f} ms/frame ({_by(by)})"
                + (f", PyTorch chain {cms:.4f} ms/frame" if cms else "")
                + f" {card_tag}")
            entry["render_frame"] = {
                "launches": render_launches[k.name], "ms": kms,
                "plain_ms": pms, "bound_ms": bms, "bound_by": _by(by),
                "pytorch_chain_ms": cms,
                "per": f"{IMG}^2 frame, {per_frame} chunks of {CHUNK} rays; "
                       f"launches over {len(FRAMES)} frames"}
        occ_per = {
            "occupancy": ("occupancy_frame", occ_in["launches"],
                          f"{IMG}^2 occupancy frame, {per_frame} chunks of "
                          f"{CHUNK} rays x {OCC_SAMPLES} samples; launches "
                          f"over {len(FRAMES)} frames"),
            "bake": ("occupancy_bake", occ_in["bake_launches"],
                     f"one {OCC_GRID}^3 bake, {OCC_GRID ** 3 // 262144} "
                     f"launches of 262,144 voxels"),
            "merge_partner": ("merge_partner", {k.name: 0},
                              f"one call at [{CHUNK}, {OCC_PROBE} bins, "
                              f"{N_COARSE} + {OCC_SAMPLES}], the occupancy "
                              f"render's chunk (the occupancy-train path's "
                              f"is occupancy_train_step)"),
            "occ_train": ("occupancy_train_step",
                          occ_train["launches"]["train_occupancy"],
                          f"{IMG}^2 occupancy-train step (merged), "
                          f"{IMG * IMG // TRAIN_CHUNK} chunks of "
                          f"{TRAIN_CHUNK} rays, "
                          f"{OCC_PROBE} probe bins, {N_COARSE} + "
                          f"{OCC_SAMPLES} samples; launches over the merged "
                          f"run, its exact epoch included"),
            "occ_train_no_merge": (
                "occupancy_train_step_no_merge",
                occ_train["launches"]["train_occupancy_no_merge"],
                f"{IMG}^2 occupancy-train step (--occupancy_train_no_merge),"
                f" {IMG * IMG // TRAIN_CHUNK} chunks of {TRAIN_CHUNK} rays, "
                f"{OCC_PROBE} probe bins -> {OCC_SAMPLES} samples; launches "
                f"over the no-merge run"),
            "fast_render": (
                "fast_render_frame",
                fast_in["launches"][f"render_fast_bf16_{FAST_RENDER}"],
                f"{IMG}^2 frame at --fast_render {FAST_RENDER}, the fine "
                f"pass's kernels (the coarse pass's are render_frame's), "
                f"{per_frame} chunks of {CHUNK} rays; launches over "
                f"{len(FRAMES)} frames, both passes"),
            "fast_render_int8": (
                "fast_render_int8_frame",
                fast_in["launches"][f"render_fast_int8_{FAST_RENDER_INT8}"],
                f"{IMG}^2 int8 frame at --fast_render {FAST_RENDER_INT8}, "
                f"the fine pass's kernels (the coarse pass's are the int8 "
                f"render's), {per_frame} chunks of {CHUNK} rays; launches "
                f"over {len(FRAMES)} frames, both passes")}
        for path, (key, launches, what) in occ_per.items():
            if k.name not in totals[path]:
                continue
            kms, pms, bms, by, _ = totals[path][k.name]
            cms = chain[path].get(k.name)
            log(f"time {k.name} ({key}): {kms:.4f} ms kernel, {pms:.3f} ms "
                f"plain, bound {bms:.4f} ms ({_by(by)})"
                + (f", PyTorch chain {cms:.4f} ms" if cms else "")
                + f" per {what} {card_tag}")
            entry[key] = {"launches": launches[k.name], "ms": kms,
                          "plain_ms": pms, "bound_ms": bms,
                          "bound_by": _by(by), "pytorch_chain_ms": cms,
                          "per": what}
        if k.name in wide["times"]:
            entry["wide"] = wide["times"][k.name]
        entries.append(entry)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# What one launch count of each timing path is per.
_UNIT = {"render": "frame", "train": "train step",
         "custom": "custom step", "quantized": "int8 frame",
         "probe": "probe run", "occupancy": "occupancy frame",
         "bake": "bake", "merge_partner": "call",
         "occ_train": "occupancy train step",
         "occ_train_no_merge": "no-merge occupancy train step",
         "fast_render": f"fast-render frame ({FAST_RENDER})",
         "fast_render_int8": f"int8 fast-render frame ({FAST_RENDER_INT8})"}


def _by(shares: dict) -> str:
    """The bound that holds for most of a kernel's summed bound time."""
    return max(shares, key=shares.get)


def _bound(nbytes, ops, peak_ops):
    """(ms, "bytes" or "operations"): the least time of the work."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _merge_bound(rays, s_c=N_COARSE, n=N_FINE, s_m=-1):
    """sample_merge, by the least work the function needs: per ray 6
    float32 operations per bin (eps, sum, divide, prefix sum, midpoint), a
    binary search plus 6 operations of interpolation per draw, and, where
    it merges (``s_m != 0``), a binary search into the draws per partner
    depth; bytes: bins, weights, draws and partner read, depths written.
    ``s_m`` is the TPU prologue's: -1, the fine pass, merges with its bins,
    the coarse depths of each ray (read once); 0 and > 0 are the occupancy
    paths, whose bins are the probe-bin centres, the same for every ray:
    one row per call."""
    s_p = s_c if s_m < 0 else s_m
    lg_c, lg_f = (s_c - 1).bit_length(), (n - 1).bit_length()
    ops = rays * (6 * s_c + n * (2 * lg_c + 6) + s_p * lg_f)
    bins = rays * s_c if s_m < 0 else s_c
    nbytes = (bins + rays * (s_c + n + max(s_m, 0) + s_p + n)) * F32B
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


def _route_turns(packed, coeffs, depths, timed, card_tag):
    """T1's and T2's MLP modes at u = 256 on both of ``ray_march_mlp``'s
    routes in turns (persistent, resident, resident, persistent): the
    persistent kernel the plan takes and the resident one, each the least of
    its two timings, beside the rows' bound and plain version."""
    from keras_nerf_tpu_torch.kernels.ray_march import ray_march_mlp

    rows = {mode: (pms, bms) for k, path, mode, _, _, pms, bms in timed
            if k is ray_march_mlp and path == "render"}
    base, slope, masks = coeffs
    for t, so in zip(depths, (True, False)):
        mode = (f"{'sigma-only' if so else 'full'} "
                f"[{t.shape[0]} x {t.shape[1]}]")
        ms = {"persistent": [], "resident": []}
        for route in ("persistent", "resident", "resident", "persistent"):
            ms[route].append(_time_ms(
                lambda r=route: ray_march_mlp(packed, base, slope, t, masks,
                                              sigma_only=so, route=r), 20))
        pms, bms = rows[mode]
        per, res = min(ms["persistent"]), min(ms["resident"])
        log(f"time ray_march_mlp {mode} by route: persistent {per:.4f} "
            f"ms/launch ({100 * bms / per:.2f}% of the bound), resident "
            f"{res:.4f} ({100 * bms / res:.2f}%), bound {bms:.4f}, plain "
            f"{pms:.3f} ms/launch; turns {ms} {card_tag}")


def _gpu_clocks(when: str) -> dict:
    """The card's SM clock, power draw, power limit and temperature, as
    ``nvidia-smi`` reads them now."""
    q = "clocks.sm,power.draw,power.limit,temperature.gpu"
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    row = dict(zip(q.split(","), (x.strip() for x in
                                  out.splitlines()[0].split(","))))
    log(f"nvidia-smi {when}: " + ", ".join(f"{k} {v}"
                                           for k, v in row.items()))
    return {"when": when, **row}


def _weight_grad_library(stash, cots, acc):
    """The cuBLAS yardstick of ``mlp_weight_grad``: for every weight array
    one product ``A^T G`` and, where it has a bias, ``sum_p G`` in float32
    (PyTorch calls timed beside the kernel, never called by the port)."""
    import torch

    from keras_nerf_tpu_torch.kernels import ray_march as trm

    pairs = [(a, g, bias is not None)
             for a, g, _, bias in trm.weight_grad_tasks(stash, cots, acc)]

    def run():
        for a, g, bias in pairs:
            a.T @ g
            if bias:
                g.sum(0, dtype=torch.float32)
    return run


def _weight_grad_partial_bytes(stash, cots, acc) -> int:
    """Bytes of ``mlp_weight_grad``'s float32 partial sums, written once
    and read once by its reduction: its plan's ``partial_floats``."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm

    tasks = trm.weight_grad_tasks(stash, cots, acc)
    plan = trm.weight_grad_plan(
        [(a.shape[1], g.shape[1], b is not None) for a, g, _, b in tasks],
        stash["enc"].shape[0])
    return 2 * F32B * plan["partial_floats"]


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


def _one_kernel_each(calls: dict, kernel: str, reps: int = 20) -> dict:
    """Each of ``calls`` ``reps`` times under one ``torch.profiler`` run,
    each label inside its own ``record_function`` range, after a warm-up
    call of each inside the same run: per label, every launch onto
    the card (the runtime's launch, memset and copy calls, on the host's
    clock inside the range) by the name of the activity it ran there (its
    correlation id). Fails unless every label made ``reps`` launches, each
    a kernel whose name holds ``kernel``: no fill, no copy, one kernel a
    call."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        for label, call in calls.items():
            with torch.profiler.record_function(label):
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    ranges = {ev.name: ev.time_range for ev in events
              if ev.name in calls and ev.device_type == cpu}
    on_card = {ev.id: ev.name for ev in events
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.is_user_annotation}
    seen = {label: {} for label in calls}
    for ev in events:
        if ev.device_type != cpu or not ev.name.startswith(
                ("cudaLaunch", "cuLaunch", "cudaMemset", "cudaMemcpy")):
            continue
        label = next((lb for lb, tr in ranges.items()
                      if tr.start <= ev.time_range.start <= tr.end), None)
        if label is None:
            continue
        name = on_card.get(ev.id)
        if name is None:
            name = f"{ev.name}: no record on the card"
        else:
            name = name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
        seen[label][name] = seen[label].get(name, 0) + 1
    for label, names in seen.items():
        if (sum(names.values()) != reps or not all(
                kernel in n or "no record" in n for n in names)):
            fail(f"{label}: {reps} calls, one {kernel} kernel each "
                 f"expected; the card ran {names}")
    return {"calls_each": reps, "launches": seen}


def _to(params, device):
    """Parameters (or an int8 dict, whose None entries stay) on ``device``."""
    from keras_nerf_tpu_torch.models.engine import tree_map

    return tree_map(lambda x: None if x is None else x.to(device), params)


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
    tf = trm.sample_merge.plain(tc, wc, u, tc)
    # The fine pass of 1024 draws (ROADMAP C14), from a generator of its
    # own so that every other draw is unchanged: its depths and colours.
    c14_gen = torch.Generator(device=dev)
    c14_gen.manual_seed(16)
    t14 = trm.sample_merge.plain(
        tc, wc, sorted_uniforms(c14_gen, (TRAIN_CHUNK,), C14_FINE), tc)
    rgbs14 = trm.ray_march_mlp.plain(packed, base, slope, t14, masks)
    return {"cfg": cfg, "packed": packed, "o": o, "d": d, "base": base,
            "slope": slope, "masks": masks, "target": target, "wc": wc,
            "u": u,
            "passes": {"coarse": {"t": tc, "weights": True},
                       "fine": {"t": tf, "weights": False}},
            "c14": {"t": t14, "rgbs": rgbs14.reshape(TRAIN_CHUNK, -1, 4)}}


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


def _record_held(results, errors: dict, rel_errors: dict) -> None:
    """Logs each :func:`_held` tuple of ``results`` beside its tolerance,
    keeps each kernel's worst errors, and fails on the first that is not
    held."""
    for name, err, rel, rel_norm, ok, label in results:
        errors[name] = max(errors.get(name, 0.0), err)
        old = rel_errors.get(name, (0.0, 0.0))
        rel_errors[name] = (max(old[0], rel), max(old[1], rel_norm))
        log(f"check {label}: max_abs_err {err:.3e}, relative max "
            f"{rel:.3e}, relative norm {rel_norm:.3e} (tolerance "
            f"{TRAIN_TOL[name]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{label} disagrees with its plain version")


def _merge_held(label: str, cp, w, u, mp, tol: float, errors: dict):
    """``sample_merge`` on ``(cp, w, u, mp)`` against its plain version:
    run twice with identical bits, within ``tol``, finite and sorted; logs
    whether kernel and plain version agree bit for bit. Fails otherwise."""
    import torch

    from keras_nerf_tpu_torch.kernels import ray_march as trm

    runs = [trm.sample_merge(cp, w, u, mp) for _ in range(2)]
    want = trm.sample_merge.plain(cp, w, u, mp)
    torch.cuda.synchronize()
    got = runs[0]
    err = float((got - want).abs().max())
    errors["sample_merge"] = max(errors.get("sample_merge", 0.0), err)
    twice = torch.equal(runs[0], runs[1])
    ok = (bool(torch.isfinite(got).all()) and err <= tol and twice
          and bool((got[:, 1:] >= got[:, :-1]).all()))
    log(f"check sample_merge {label}: max_abs_err {err:.3e} (tolerance "
        f"{tol:.0e}), bit-equal {torch.equal(got, want)}, identical bits "
        f"twice {twice}, sorted {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"sample_merge {label} disagrees with its plain version")


def _merge_weight_cases(gen, tc, u, coarse_w):
    """``(label, cp, w, u, mp)`` cases of ``sample_merge`` at the render
    chunk beyond the fog's coarse weights: heavy-tailed weights
    (log-normal, sigma 8, half the bins zeroed, where a CDF formed as
    ``inclusive - pdf`` steps down) and all of each ray's mass in one bin,
    each in the three modes (the coarse depths as partner, none, another
    sorted partner)."""
    import torch

    r, s_c = coarse_w.shape
    dev = coarse_w.device
    heavy = torch.exp(8.0 * torch.randn(r, s_c, generator=gen, device=dev))
    heavy = torch.where(torch.rand(r, s_c, generator=gen, device=dev) < 0.5,
                        0.0, heavy)
    one = torch.zeros_like(coarse_w)
    one[torch.arange(r, device=dev), torch.randint(
        0, s_c, (r,), generator=gen, device=dev)] = 1.0
    partner = torch.sort(torch.rand(r, s_c, generator=gen, device=dev) * 4
                         + 2, dim=-1).values
    shape = f"[{r}, {s_c} + {u.shape[1]}]"
    return [(f"{kind}, {mode} {shape}", tc, w, u, mp)
            for kind, w in (("heavy-tailed weights", heavy),
                            ("all mass in one bin", one))
            for mode, mp in (("merged with the coarse depths", tc),
                             ("no merge", None),
                             ("another partner", partner))]


def _train_chain(packed, base, slope, masks, t, target, weights_modes,
                 white_background=True, loss_scale=None, where=""):
    """T3's chain at ``t``'s shape, each kernel against its plain version
    on the plain outputs of the step before and run twice with identical
    bits: ``ray_march_mlp`` with its stash, ``ray_march_quadrature``
    with_grad in each mode of ``weights_modes`` (weights emitted or not),
    ``mlp_backward`` on the first mode's cotangents and
    ``mlp_weight_grad``. ``loss_scale`` defaults to the MSE's 2 / (3 R).
    Yields :func:`_held` tuples; returns the plain intermediates."""
    import torch

    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models.engine import tree_leaves

    r, s = t.shape
    u, n = packed["trunk_b"][0].shape[1], len(packed["trunk_w"])
    shape = f"[{r} x {s}]{where}"
    stashes = [trm.alloc_stash(r * s, u, n, t.device) for _ in range(3)]
    args = (packed, base, slope, t, masks)
    out_k = [trm.ray_march_mlp(*args, stash=st) for st in stashes[:2]]
    out_p = trm.ray_march_mlp.plain(*args, stash=stashes[2])
    torch.cuda.synchronize()

    def kept(st):
        return [st[k] for k in ("enc", "features", "rf")] + list(st["h"])

    twice = torch.equal(out_k[0], out_k[1]) and all(
        torch.equal(a, b) for a, b in zip(kept(stashes[0]), kept(stashes[1])))
    yield _held("ray_march_mlp",
                list(zip(kept(stashes[0]), kept(stashes[2])))
                + [(out_k[0], out_p)],
                f"ray_march_mlp train, outputs and kept activations "
                f"{shape}, identical bits twice {twice}",
                err=float((out_k[0] - out_p).abs().max()), extra_ok=twice)
    stash_p = stashes[2]
    del stashes, out_k

    rgbs = out_p.reshape(r, s, 4)
    kw = dict(target=target, loss_scale=(2.0 / (3 * r) if loss_scale is None
                                         else loss_scale))
    quads = []
    for weights in weights_modes:
        q_args = (rgbs, t, white_background, False, weights)
        q_k = [trm.ray_march_quadrature(*q_args, **kw) for _ in range(2)]
        q_p = trm.ray_march_quadrature.plain(*q_args, **kw)
        torch.cuda.synchronize()
        twice = all(torch.equal(a, b) for a, b in zip(q_k[0], q_k[1])
                    if a is not None)
        err = max(float((a - b).abs().max())
                  for a, b in zip(q_k[0][:3], q_p[:3]) if a is not None)
        yield _held("ray_march_quadrature", list(zip(q_k[0][3:], q_p[3:])),
                    f"ray_march_quadrature with_grad, "
                    f"{'weights' if weights else 'no weights'} {shape}, "
                    f"identical bits twice {twice}", err=err, extra_ok=twice)
        quads.append(q_p)
    q_p = quads[0]

    def cotangents(c):
        return [c["d_rf"], c["d_sf"]] + list(c["d_pre"])

    cots_k = [trm.mlp_backward(q_p[3], q_p[4], packed, stash_p)
              for _ in range(2)]
    cots_p = trm.mlp_backward.plain(q_p[3], q_p[4], packed, stash_p)
    torch.cuda.synchronize()
    twice = all(torch.equal(a, b) for a, b in zip(cotangents(cots_k[0]),
                                                  cotangents(cots_k[1])))
    yield _held("mlp_backward",
                list(zip(cotangents(cots_k[0]), cotangents(cots_p))),
                f"mlp_backward, every cotangent {shape}, identical bits "
                f"twice {twice}", extra_ok=twice)
    del cots_k

    want = trm.mlp_weight_grad.plain(stash_p, cots_p, trm.zero_grads(packed))
    runs = [trm.mlp_weight_grad(stash_p, cots_p, trm.zero_grads(packed))
            for _ in range(2)]
    torch.cuda.synchronize()
    leaves = [tree_leaves(x) for x in (*runs, want)]
    same = all(torch.equal(a, b) for a, b in zip(leaves[0], leaves[1]))
    yield _held("mlp_weight_grad", list(zip(leaves[0], leaves[2])),
                f"mlp_weight_grad, every packed gradient {shape}, identical "
                f"bits twice {same}", extra_ok=same)
    return dict(stash=stash_p, cots=cots_p, rgbs=rgbs, quad=q_p)


def _train_kernel_checks(ti: dict):
    """Each training kernel and mode against its plain version on the same
    inputs (the plain outputs of the step before), at both passes' shapes.
    Yields :func:`_held` tuples and keeps the plain intermediates in ``ti``
    for the timing phase."""
    import torch

    from keras_nerf_tpu_torch.kernels import ray_march as trm

    packed = ti["packed"]
    tc = ti["passes"]["coarse"]["t"]
    tf_k = [trm.sample_merge(tc, ti["wc"], ti["u"], tc) for _ in range(2)]
    tf_p = ti["passes"]["fine"]["t"]
    torch.cuda.synchronize()
    twice = torch.equal(tf_k[0], tf_k[1])
    yield _held("sample_merge", [(tf_k[0], tf_p)],
                f"sample_merge train [{TRAIN_CHUNK}, {N_COARSE} + {N_FINE}]"
                f", bit-equal {torch.equal(tf_k[0], tf_p)}, identical bits "
                f"twice {twice}, sorted",
                extra_ok=twice and bool((tf_k[0][:, 1:]
                                         >= tf_k[0][:, :-1]).all()))
    del tf_k
    for name, p in ti["passes"].items():
        p.update((yield from _train_chain(
            packed, ti["base"], ti["slope"], ti["masks"], p["t"],
            ti["target"], (p["weights"],))))
    # ROADMAP C14: the with_grad mode past 1024 samples a ray.
    c14 = ti["c14"]
    kw = dict(target=ti["target"], loss_scale=2.0 / (3 * TRAIN_CHUNK))
    q_args = (c14["rgbs"], c14["t"], True, False, False)
    q_k = [trm.ray_march_quadrature(*q_args, **kw) for _ in range(2)]
    q_p = trm.ray_march_quadrature.plain(*q_args, **kw)
    torch.cuda.synchronize()
    twice = all(torch.equal(a, b) for a, b in zip(q_k[0], q_k[1])
                if a is not None)
    err = max(float((a - b).abs().max()) for a, b in zip(q_k[0][:2],
                                                         q_p[:2]))
    yield _held("ray_march_quadrature", list(zip(q_k[0][3:], q_p[3:])),
                f"ray_march_quadrature with_grad, no weights "
                f"[{TRAIN_CHUNK} x {c14['t'].shape[1]}] (ROADMAP C14), "
                f"identical bits twice {twice}", err=err, extra_ok=twice)


def _custom_kernel_checks(ti: dict):
    """T5 and T6 against their plain versions at both passes' training
    shapes, on the points of :func:`_train_inputs`: ``apply_mlp`` without
    and with its stash, ``mlp_backward``'s output-head mode, and
    ``fused_mlp_backward`` whole (twice: identical bits). The output
    cotangent is the chunk's L1 loss's, through the reference quadrature.
    Yields :func:`_held` tuples and keeps the inputs in ``ti`` for the
    timing phase."""
    import torch

    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models.engine import tree_leaves
    from keras_nerf_tpu_torch.ops import render_rays

    cfg, packed = ti["cfg"], ti["packed"]
    u, n = cfg.dense_units, cfg.n_layers
    for p in ti["passes"].values():
        t = p["t"]
        r, s = t.shape
        pts = r * s
        shape = f"[{r} x {s}]"
        enc = trm.encode_block128(*trm.ray_points(ti["o"], ti["d"], t),
                                  cfg.pos_emb_xyz, cfg.pos_emb_dir)
        out_k = trm.apply_mlp(packed, enc)
        out_p = trm.apply_mlp.plain(packed, enc)
        torch.cuda.synchronize()
        yield _held("apply_mlp", [(out_k, out_p)], f"apply_mlp {shape}")
        del out_k, out_p
        stash_k = trm.alloc_stash(pts, u, n, t.device, enc=enc)
        stash_p = trm.alloc_stash(pts, u, n, t.device, enc=enc)
        y_k = trm.apply_mlp(packed, enc, stash=stash_k)
        y_p = trm.apply_mlp.plain(packed, enc, stash=stash_p)
        torch.cuda.synchronize()
        pairs = [(stash_k[k], stash_p[k]) for k in ("features", "rf")]
        pairs += list(zip(stash_k["h"], stash_p["h"]))
        yield _held("apply_mlp", pairs + [(y_k, y_p)],
                    f"apply_mlp with a stash, outputs and kept activations "
                    f"{shape}", err=float((y_k - y_p).abs().max()))
        del stash_k, y_k

        y = y_p.detach().requires_grad_(True)
        image = render_rays(y[:, :3].reshape(r, s, 3), y[:, 3].reshape(r, s),
                            t, white_background=True).image
        l1_loss(ti["target"], image).backward()
        g = y.grad.to(torch.bfloat16)
        head = (g, y_p, packed, stash_p)
        cots_k = trm.mlp_backward(*head, from_output=True)
        cots_p = trm.mlp_backward.plain(*head, from_output=True)
        torch.cuda.synchronize()
        pairs = [(cots_k[k], cots_p[k]) for k in ("d_rgb", "d_rf", "d_sf")]
        pairs += list(zip(cots_k["d_pre"], cots_p["d_pre"]))
        yield _held("mlp_backward", pairs,
                    f"mlp_backward output-head mode, every cotangent "
                    f"{shape}")
        del cots_k

        want = trm.fused_mlp_backward_plain(packed, enc, g)
        runs = [trm.fused_mlp_backward(packed, enc, g) for _ in range(2)]
        torch.cuda.synchronize()
        leaves = [tree_leaves(x) for x in (*runs, want)]
        same = all(torch.equal(a, b) for a, b in zip(leaves[0], leaves[1]))
        log(f"check fused_mlp_backward {shape}: two runs identical bits: "
            f"{same}")
        yield _held("fused_mlp_backward", list(zip(leaves[0], leaves[2])),
                    f"fused_mlp_backward (T6), every packed gradient, twice "
                    f"{shape}", extra_ok=same)
        p.update(enc=enc, g=g, y=y_p, t6_stash=stash_p, t6_cots=cots_p)


class _StepLog:
    """A quiet callback: keeps each step's metrics, fetched once per epoch
    (``verbose = False`` leaves fit's deferred fetch on)."""

    verbose = False

    def __init__(self):
        self.logs = []

    def on_train_batch_end(self, batch, logs):
        self.logs.append(logs)


def _train_dataset():
    """The training views: 5 poses of the spheres scene at 128^2."""
    from keras_nerf_tpu_torch.data import NeRFDataset
    from keras_nerf_tpu_torch.inference import ORBIT

    images, poses, focal = _spheres_scene(TRAIN_POSES, seed=0)
    return NeRFDataset(images, poses, focal=focal, near=ORBIT["near"],
                       far=ORBIT["far"], n_samples=N_COARSE, batch_size=1,
                       shuffle=True, seed=0, device="cuda")


def _compile_train(nerf, loss, ray_chunks: int = TRAIN_CHUNK):
    """``nerf.compile`` for training at 128^2 with Adam at 1e-3 and
    ``loss``; a compiled model keeps its weights and optimizer state."""
    return nerf.compile(
        optimizer="adam", loss=loss, batch_size=1, image_height=IMG,
        image_width=IMG, ray_chunks=ray_chunks, white_background=True,
        learning_rate=1e-3, device="cuda", seed=0)


def _fit_main_path(nerf, dataset, per_chunk: dict, label: str, card_tag):
    """A warm-up step, then 20 steps of ``NeRF.fit`` of the compiled
    ``nerf`` (:func:`_compile_train`); counts every kernel's launches
    against ``per_chunk`` (launches per chunk, 0 for a kernel not named)
    and checks that the metrics are finite, the gradients nonzero and the
    fine loss falls."""
    import math

    import torch

    from keras_nerf_tpu_torch.kernels import KERNELS, reset_launch_counts

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
    expected = {k.name: n * chunks * per_chunk.get(k.name, 0)
                for k in KERNELS}
    fine = [m["fine_loss"] for m in steps.logs]
    log(f"{label} main path: {n} steps of NeRF.fit at {IMG}^2, ray_chunks "
        f"{TRAIN_CHUNK}, in {wall:.3f} s: {1e3 * wall / n:.1f} ms/step, "
        f"{n * IMG * IMG / wall:.0f} rays/s (wall, host clock) {card_tag}; "
        f"launches {launches}")
    log(f"{label} main path: fine_loss by step "
        + " ".join(f"{v:.4f}" for v in fine))
    log(f"{label} main path: grad norms coarse "
        f"{min(m['coarse_grad_norm'] for m in steps.logs):.3e}.."
        f"{max(m['coarse_grad_norm'] for m in steps.logs):.3e}, fine "
        f"{min(m['fine_grad_norm'] for m in steps.logs):.3e}.."
        f"{max(m['fine_grad_norm'] for m in steps.logs):.3e}")
    if n != TRAIN_POSES * TRAIN_EPOCHS or launches != expected:
        fail(f"{label} launch counts {launches} != expected {expected}")
    if not all(math.isfinite(v) for m in steps.logs for v in m.values()):
        fail(f"{label}: non-finite training metrics")
    if not all(m[k] > 0.0 for m in steps.logs
               for k in ("coarse_grad_norm", "fine_grad_norm")):
        fail(f"{label}: a gradient norm is zero")
    if not sum(fine[-5:]) / 5 < fine[0]:
        fail(f"{label}: the fine loss did not fall: {fine}")
    return launches, n


def _big_chunk_step(nerf, dataset, card_tag, loss):
    """One step at 16384-ray chunks, compiled with ``loss``: the fine pass
    (T3) or its backward (T6) runs in sub-launches of about 1 M points;
    prints the peak device memory."""
    import math

    import torch

    from keras_nerf_tpu_torch.kernels import KERNELS, reset_launch_counts
    from keras_nerf_tpu_torch.kernels.ray_march import train_sub_launches

    _compile_train(nerf, loss, BIG_CHUNK)
    batch = next(iter(dataset))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = nerf.train_step(batch)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    chunks = IMG * IMG // BIG_CHUNK
    expected = {k.name: 0 for k in KERNELS}
    if loss == "mse":
        subs = chunks * (len(train_sub_launches(BIG_CHUNK, N_COARSE))
                         + len(train_sub_launches(BIG_CHUNK,
                                                  N_COARSE + N_FINE)))
        expected.update(ray_march_mlp=subs, ray_march_quadrature=subs,
                        mlp_backward=subs, mlp_weight_grad=subs,
                        sample_merge=chunks)
    else:   # forward per pass, then the recompute per sub-launch
        subs = chunks * sum(len(train_sub_launches(BIG_CHUNK * s, 1))
                            for s in (N_COARSE, N_COARSE + N_FINE))
        expected.update(apply_mlp=2 * chunks + subs, mlp_backward=subs,
                        mlp_weight_grad=subs)
    peak = torch.cuda.max_memory_allocated()
    name = "mse" if loss == "mse" else loss.__name__
    log(f"train step ({name}) at ray_chunks {BIG_CHUNK}: "
        f"{1e3 * wall:.1f} ms wall, "
        f"peak device memory {peak / 2**30:.2f} GiB "
        f"({(peak - base_mem) / 2**30:.2f} GiB above the step's start) "
        f"{card_tag}; launches {launches}")
    if launches != expected:
        fail(f"launch counts {launches} != expected {expected}")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail("non-finite metrics at the large chunk")
    _compile_train(nerf, loss)


def _small_step_inputs(gen, n_fine=N_FINE):
    """A 16^2 view of the spheres scene (2 chunks) with its rays and
    ``n_fine`` fine draws a ray, on the card."""
    import torch

    from keras_nerf_tpu_torch.data import generate_ray_batch
    from keras_nerf_tpu_torch.inference import ORBIT
    from keras_nerf_tpu_torch.ops import sorted_uniforms

    images, poses, focal = _spheres_scene(1, seed=2, img=E2E_IMG)
    rays = generate_ray_batch(poses, gen, image_height=E2E_IMG,
                              image_width=E2E_IMG, focal=focal,
                              near=ORBIT["near"], far=ORBIT["far"],
                              n_samples=N_COARSE)
    batch = (torch.as_tensor(images, device="cuda"), rays)
    draws = [sorted_uniforms(gen, (E2E_CHUNK,), n_fine)
             for _ in range(E2E_IMG * E2E_IMG // E2E_CHUNK)]
    return batch, draws


def _c14_step(state, card_tag):
    """ROADMAP C14: a 16^2 MSE step at 64 + 1024 samples a ray through the
    fused path (T3: the with_grad quadrature at S = 1088), the card's step
    against the CPU's at ``STEP_TOL`` (:func:`_compare_mse_steps`), from
    ``state``'s weights; fails unless the card's step ran the T3 kernels,
    2 chunks of ``MSE_LAUNCHES``. Prints its seconds."""
    import torch

    from keras_nerf_tpu_torch.kernels import KERNELS, reset_launch_counts
    from keras_nerf_tpu_torch.models import NeRFConfig

    cfg = NeRFConfig(n_coarse=N_COARSE, n_fine=C14_FINE,
                     white_background=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    small = _small_step_inputs(gen, C14_FINE)
    label = (f"train step {E2E_IMG}^2 at {N_COARSE} + {C14_FINE} samples "
             f"(ROADMAP C14), card kernels vs CPU plain versions")
    t0 = time.perf_counter()
    reset_launch_counts()
    _compare_mse_steps(label, state, small, cfg)
    launches = {k.name: k.launches for k in KERNELS}
    chunks = E2E_IMG * E2E_IMG // E2E_CHUNK
    expected = {k.name: chunks * MSE_LAUNCHES.get(k.name, 0)
                for k in KERNELS}
    log(f"{label}: {time.perf_counter() - t0:.1f} s (wall: the card's step "
        f"and two CPU steps) {card_tag}; card launches {launches}")
    if launches != expected:
        fail(f"{label}: launch counts {launches} != expected {expected}")


def _one_step(state, small, cfg, device, loss_fn, occ=None):
    """One SGD (lr 1) step from ``state``'s weights on ``small``'s batch and
    draws on ``device`` (with ``occ``, ``train_step``'s occupancy keywords,
    the occupancy step on the grid or rows given): its metrics and the
    gradients (the parameter change) of both models, leaf by leaf."""
    import torch

    from keras_nerf_tpu_torch.models import engine
    from keras_nerf_tpu_torch.models.engine import tree_leaves

    batch, draws = small
    device = torch.device(device)
    p0 = [_to(p, device) for p in (state.coarse_params, state.fine_params)]
    s0 = engine.TrainState(p0[0], p0[1], {}, {}, 0)
    moved = (batch[0].to(device), tuple(x.to(device) for x in batch[1]))
    occ = {k: v.to(device) if torch.is_tensor(v) else v
           for k, v in (occ or {}).items()}
    s1, metrics = engine.train_step(s0, moved, [x.to(device) for x in draws],
                                    engine.make_optimizer("sgd", 1.0), cfg,
                                    E2E_CHUNK, loss_fn=loss_fn, **occ)
    grads = [[(a - b).double().cpu() for a, b in
              zip(tree_leaves(p), tree_leaves(q))]
             for p, q in zip(p0, (s1.coarse_params, s1.fine_params))]
    return {k: float(v) for k, v in metrics.items()}, grads


def _compare_l1_steps(label, state, small, cfg):
    """The card's L1 step against the CPU's at the same subgradient
    (ROADMAP C9). L1's gradient jumps by 2 / N at a pixel-channel whose
    prediction crosses its target, and the card's renders may differ from
    the CPU's by up to ``E2E_TOL["image"]``: where a prediction lies that
    close to its target (a white background pixel rendered at 1.0), the two
    devices' signs are a draw of float32 rounding, and one flip moves a
    16^2 step's fine gradient by about 1 / sqrt(768) of its norm. So a CPU
    step records the reference's signs, both steps are taken with them
    (:class:`SignedL1`: L1's value, the reference's subgradient) and held
    at ``STEP_TOL`` by :func:`_compare_steps`, and the card's own signs may
    differ from the reference's only where the reference's residual lies
    within ``E2E_TOL["image"]``."""
    ref = SignedL1()
    _one_step(state, small, cfg, "cpu", ref)
    n = 2 * len(small[1])   # the gradient calls: coarse, fine per chunk
    signs = ref.own[:n]
    card = SignedL1(signs)
    _compare_steps(label, state, small, cfg, ("cuda", card),
                   ("cpu", SignedL1(signs)))
    flips = [card.own[k] != signs[k] for k in range(n)]
    count = sum(int(f.sum()) for f in flips)
    widest = max((float(ref.residual[k][f].max())
                  for k, f in enumerate(flips) if f.any()), default=0.0)
    log(f"{label}: the card's own sign differs from the reference's at "
        f"{count} of {sum(x.numel() for x in signs)} pixel-channels, where "
        f"the reference's residual is at most {widest:.3e} (must lie within "
        f"the render budget {E2E_TOL['image']:.0e})")
    if widest > E2E_TOL["image"]:
        fail(f"{label}: the card's L1 signs differ from the CPU's beyond "
             f"the render budget")


class PinnedMse:
    """The card's 16^2 MSE step recorded, and the CPU's pinned to it
    (ROADMAP C11). Each device draws its fine depths from its own coarse
    weights, and the clip of each composite to [0, 1] passes the MSE's
    gradient only inside: where a composite lies at the clip's edge, the
    two devices' decisions are a draw of float32 rounding, and at a trained
    state 3 of 768 flipped decisions moved the coarse leaves by 3-6%. So
    the card's step records its fine depths (``sample_merge``) and each
    pass's clipped image (inside the clip where 0 < image < 1); the CPU
    step then takes the card's depths, and the card's decision at a
    pixel-channel whose CPU composite lies within the render budget
    ``E2E_TOL["image"]`` of 0 or 1, its own elsewhere. ``far`` counts the
    decisions that differ farther from the edge, which fail the check."""

    def __init__(self):
        self.depths, self.images = [], []
        self.near = self.far = self.pinned = 0

    def recording(self):
        from keras_nerf_tpu_torch.kernels import ray_march as trm

        def merge(launch):
            def call(*args, **kwargs):
                out = launch(*args, **kwargs)
                self.depths.append(out.clone())
                return out
            return call

        def quad(launch):
            def call(*args, **kwargs):
                out = launch(*args, **kwargs)
                if kwargs.get("target") is not None:
                    self.images.append(out[0].clone())
                return out
            return call

        return _Swapped([(trm.sample_merge, "_launch", merge),
                         (trm.ray_march_quadrature, "_launch", quad)])

    def pinning(self):
        import torch

        from keras_nerf_tpu_torch.kernels import ray_march as trm

        depths, images = iter(self.depths), iter(self.images)
        budget = E2E_TOL["image"]

        def merge(plain):
            def call(*args, **kwargs):
                own = plain(*args, **kwargs)
                card = next(depths).to(own.device)
                assert card.shape == own.shape
                return card
            return call

        def slope(own):
            def call(pre_clip):
                card = next(images).to(pre_clip.device)
                inside = (card > 0.0) & (card < 1.0)
                mine = (pre_clip > 0.0) & (pre_clip < 1.0)
                near = ((pre_clip.abs() <= budget)
                        | ((pre_clip - 1.0).abs() <= budget))
                differ = inside != mine
                self.near += int(near.sum())
                self.pinned += int((differ & near).sum())
                self.far += int((differ & ~near).sum())
                return torch.where(differ & near, inside.to(pre_clip.dtype),
                                   own(pre_clip))
            return call

        return _Swapped([(trm.sample_merge, "plain", merge),
                         (trm, "clip_subgradient", slope)])


class _Swapped:
    """Within ``with``, each ``(owner, attribute, wrap)`` has its attribute
    replaced by ``wrap(attribute)``."""

    def __init__(self, swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [(o, a, getattr(o, a)) for o, a, _ in self.swaps]
        for o, a, wrap in self.swaps:
            setattr(o, a, wrap(getattr(o, a)))
        return self

    def __exit__(self, *exc):
        for o, a, old in self.saved:
            setattr(o, a, old)
        return False


def _compare_mse_steps(label, state, small, cfg, occ=None):
    """The card's 16^2 MSE step against the CPU's pinned to its fine depths
    and near-edge clip decisions (:class:`PinnedMse`), held at
    ``STEP_TOL``; fails where a clip decision differs farther from the edge
    than the render budget. The unpinned reading (each device's own depths
    and decisions) is printed beside it, not held. ``occ``: the occupancy
    step's keywords (:func:`_one_step`)."""
    pin = PinnedMse()
    with pin.recording():
        card = _one_step(state, small, cfg, "cuda", None, occ)
    with pin.pinning():
        host = _one_step(state, small, cfg, "cpu", None, occ)
    _compare_steps(f"{label}, the CPU on the card's fine depths and clip "
                   f"decisions", state, small, cfg, None, None,
                   steps=(card, host))
    log(f"{label}: {pin.pinned} of {pin.near} pixel-channels within "
        f"{E2E_TOL['image']:.0e} of the clip's edge took the card's "
        f"decision; {pin.far} decisions differ farther from it (must be 0)")
    if pin.far:
        fail(f"{label}: the card's clip decisions differ from the CPU's "
             f"beyond the render budget")
    _compare_steps(f"{label}, each device on its own draws (unpinned, not "
                   f"held)", state, small, cfg, None, None,
                   steps=(card, _one_step(state, small, cfg, "cpu", None,
                                          occ)),
                   held=False)


def _compare_steps(label, state, small, cfg, run_a, run_b, steps=None,
                   held=True):
    """One SGD (lr 1) step from ``state``'s weights on the same batch and
    draws for each run ``(device, loss_fn)`` (or the two given ``steps``,
    ``_one_step``'s results), held at ``STEP_TOL`` unless not ``held``:
    losses relative, per-leaf gradients (the parameter change) of both
    models by relative norm and relative max, ``run_b`` the reference."""
    import numpy as np

    (m_a, g_a), (m_b, g_b) = steps or [_one_step(state, small, cfg, *run)
                                       for run in (run_a, run_b)]
    loss_err = max(abs(m_a[k] - m_b[k]) / abs(m_b[k])
                   for k in ("coarse_loss", "fine_loss"))
    worst = {}
    for model, leaves_a, leaves_b in zip(("coarse", "fine"), g_a, g_b):
        worst[model] = _worst_leaf(zip(leaves_a, leaves_b))
    log(f"{label}: loss relative err {loss_err:.3e} (tolerance "
        f"{STEP_TOL['loss_rtol']}); worst leaf gradient relative norm / "
        f"max " + ", ".join(
            f"{m} {w[0]:.3e} / {w[1]:.3e}" for m, w in worst.items())
        + f" (tolerance {STEP_TOL['grad_rel_norm']} / "
        f"{STEP_TOL['grad_rel_max']}); losses "
        f"{m_a['coarse_loss']:.5f}/{m_a['fine_loss']:.5f} vs "
        f"{m_b['coarse_loss']:.5f}/{m_b['fine_loss']:.5f}")
    if held and not (np.isfinite(loss_err)
                     and loss_err <= STEP_TOL["loss_rtol"]
                     and all(map(_within_step_tol, worst.values()))):
        fail(f"{label}: the two steps disagree")


def _worst_leaf(pairs):
    """(worst relative norm, worst relative max) over (got, reference)
    gradient leaves."""
    rel_norm = rel_max = 0.0
    for a, b in pairs:
        a, b = a.double().cpu(), b.double().cpu()
        rel_norm = max(rel_norm, float((a - b).norm() / b.norm()))
        rel_max = max(rel_max, float((a - b).abs().max() / b.abs().max()))
    return rel_norm, rel_max


def _within_step_tol(worst) -> bool:
    import math

    return (all(math.isfinite(x) for x in worst)
            and worst[0] <= STEP_TOL["grad_rel_norm"]
            and worst[1] <= STEP_TOL["grad_rel_max"])


def _compare_passes(state, small, cfg):
    """The 16^2 MSE step's passes on the same points through both training
    paths on the card, chunk by chunk: ``fused_train_chunk`` (T3) against
    autograd of the MSE through ``render_chunk``'s kernel branch (T5/T6)
    and ``render_rays``; the coarse pass on its stratified depths, the fine
    pass of both paths on the depths that ``sample_merge`` draws from T3's
    coarse weights. Per model, the loss (the mean of the chunk losses, as
    ``train_step`` takes it) and every gradient leaf summed over the chunks
    held at ``STEP_TOL`` (the budgets of test_pallas_kernel.py:308-349,
    which compares T3 with autodiff on shared points). A step in which each
    path draws its fine depths from its own coarse weights compares two
    draws, and its reading moves with the trained state (ROADMAP C8)."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models import engine

    (images, (origin, direction, points)), draws = small
    n = E2E_CHUNK
    enc = (cfg.pos_emb_xyz, cfg.pos_emb_dir)
    kw = dict(pos_emb_xyz=cfg.pos_emb_xyz, pos_emb_dir=cfg.pos_emb_dir,
              white_background=cfg.white_background)
    models = {"coarse": state.coarse_params, "fine": state.fine_params}
    packed = {m: trm.pack_mlp_params(p, cfg.mlp, *enc)
              for m, p in models.items()}
    # Per model: losses and summed gradient leaves of (T5/T6, T3).
    sums = {m: [0.0, 0.0, None, None] for m in models}
    for c, draw in enumerate(draws):
        rows = slice(c * n, (c + 1) * n)
        o = origin.reshape(-1, 3)[rows].contiguous()
        d = direction.reshape(-1, 3)[rows].contiguous()
        tc = points.reshape(-1, N_COARSE)[rows].contiguous()
        target = images[..., :3].reshape(-1, 3)[rows].contiguous()
        weights_c = trm.fused_render_chunk(packed["coarse"], o, d, tc, **kw)[2]
        tf = trm.sample_merge(tc, weights_c, draw, tc)
        for name, t in (("coarse", tc), ("fine", tf)):
            image3, _, _, g3 = trm.fused_train_chunk(packed[name], o, d, t,
                                                     target, **kw)
            g3 = trm.unpack_grads(g3, cfg.mlp, *enc)
            leaves = engine.tree_map(
                lambda x: x.detach().clone().requires_grad_(True),
                models[name])
            out, _ = engine.render_chunk(leaves, o, d, t, cfg)
            loss = mse_callable(target, out.image)
            loss.backward()
            got = [x.grad.double() for x in engine.tree_leaves(leaves)]
            ref = [x.double() for x in engine.tree_leaves(
                engine.tree_map(lambda g, x: g, g3, leaves))]
            acc = sums[name]
            acc[0] += float(loss.detach()) / len(draws)
            acc[1] += float(engine.mse_loss(target, image3)) / len(draws)
            acc[2] = got if acc[2] is None else [
                a + b for a, b in zip(acc[2], got)]
            acc[3] = ref if acc[3] is None else [
                a + b for a, b in zip(acc[3], ref)]
    for name, (loss_t, loss3, got, ref) in sums.items():
        loss_err = abs(loss_t - loss3) / loss3
        worst = _worst_leaf(zip(got, ref))
        log(f"{name} pass, {len(draws)} chunks of {n} rays x "
            f"{N_COARSE if name == 'coarse' else N_COARSE + N_FINE} on the "
            f"same points, MSE through T5/T6 vs T3 on the card: loss "
            f"relative err {loss_err:.3e} (tolerance "
            f"{STEP_TOL['loss_rtol']}), worst leaf gradient (summed over the "
            f"chunks) relative norm {worst[0]:.3e} / max {worst[1]:.3e} "
            f"(tolerance {STEP_TOL['grad_rel_norm']} / "
            f"{STEP_TOL['grad_rel_max']}); losses {loss_t:.5f} vs "
            f"{loss3:.5f}")
        if not (loss_err <= STEP_TOL["loss_rtol"] and _within_step_tol(worst)):
            fail(f"the {name} pass through T5/T6 disagrees with T3")


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
    cotangent) come apart as the 7th item: the design's own cost;
    ``mlp_weight_grad``'s also counts its float32 partial sums (written and
    read once), and its 8th item is its cuBLAS yardstick
    (:func:`_weight_grad_library`). ``mlp_backward`` has no one-call
    library equivalent; its 9th item is the PyTorch chain of its function
    (``time_mlp_backward.pytorch_chain``: one bf16 matmul per layer,
    ``torch.where`` masks), reported apart from library times;
    ``ray_march_mlp``'s is the forward's PyTorch chain
    (``time_ray_march_mlp.pytorch_chain``) over the pass's encoding."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.time_mlp_backward import pytorch_chain
    from keras_nerf_tpu_torch.time_ray_march_mlp import (
        pytorch_chain as forward_chain,
    )
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
                                        ti["u"], ti["passes"]["coarse"]["t"]),
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
             mlp_io + pts * stash_b, None, forward_chain(
                 packed, trm.encode_points(ti["base"], ti["slope"], t,
                                           ti["masks"]).reshape(-1, 128))),
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
             weight_bytes + pts * (head_pad_b + 2 * n * u + cots_b), None,
             pytorch_chain(p["quad"][3], p["quad"][4], packed, p["stash"])),
            (trm.mlp_weight_grad, "train", f"{name} {shape}",
             lambda f, p=p, acc=acc: f(p["stash"], p["cots"], acc),
             per_step, _bound(grad_bytes, pts * fwd, PEAK_BF16_FLOPS),
             grad_bytes + pts * (stash_b + cots_b + 2 * trm.D_HEAD)
             + _weight_grad_partial_bytes(p["stash"], p["cots"], acc),
             _weight_grad_library(p["stash"], p["cots"], acc)),
        ]
    # ROADMAP C14's fine pass of 1024 draws: on no 128^2 step (0 launches).
    t14, rgbs14 = ti["c14"]["t"], ti["c14"]["rgbs"]
    r, pts = TRAIN_CHUNK, t14.numel()
    q_kw = dict(target=ti["target"], loss_scale=2.0 / (3 * r))
    modes.append((trm.ray_march_quadrature, "train",
                  f"with_grad fine [{r} x {t14.shape[1]}] (ROADMAP C14)",
                  lambda f: f(rgbs14, t14, True, False, False, **q_kw), 0,
                  _bound(pts * (20 + head_b) + r * 28, pts * 38,
                         PEAK_F32_FLOPS),
                  pts * (20 + head_pad_b) + r * 28))
    return modes


def _custom_modes(ti: dict, cfg) -> list:
    """The timing modes of the custom-loss step's kernels at one 2048-ray
    chunk per pass, each launched once per chunk: 8 times per 128^2 step.

    Bounds as for T3: T5's forward, and T6's least work split as the
    forward (the recompute), dX (``mlp_backward``) and dW
    (``mlp_weight_grad``), at the bf16 peak, against each function's own
    inputs and outputs; the stash and cotangents the split moves (and
    ``mlp_weight_grad``'s partial sums) come apart as the design's bytes,
    and ``mlp_weight_grad`` has its cuBLAS yardstick, ``mlp_backward`` and
    ``apply_mlp`` their PyTorch chains as in :func:`_train_modes`."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.time_mlp_backward import pytorch_chain
    from keras_nerf_tpu_torch.time_ray_march_mlp import (
        pytorch_chain as forward_chain,
    )
    from keras_nerf_tpu_torch.models.engine import tree_leaves

    packed = ti["packed"]
    u, n = cfg.dense_units, cfg.n_layers
    per_step = IMG * IMG // TRAIN_CHUNK
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       tree_leaves(packed))
    grad_bytes = 2 * F32B * sum(t.numel() for t in tree_leaves(packed))
    kept_b = 2 * (n * u + u + u // 2)              # the stash less enc
    cots_b = 2 * (u // 2 + u + trm.D_HEAD + n * u)
    io_b = 2 * 128 + 4 * F32B                      # enc in, (rgb, sigma) out
    head_b = 4 * 2 + 4 * F32B                      # g bf16, y float32
    fwd = trm.fwd_flop_per_point(cfg.mlp)
    dx = trm.bwd_dx_flop_per_point(cfg.mlp)
    modes = []
    for name, p in ti["passes"].items():
        pts = p["enc"].shape[0]
        shape = f"[{TRAIN_CHUNK} x {p['t'].shape[1]}]"
        stash = trm.alloc_stash(pts, u, n, p["enc"].device, enc=p["enc"])
        cots = trm.alloc_cotangents(pts, u, n, p["enc"].device)
        acc = trm.zero_grads(packed)
        fwd_bound = _bound(weight_bytes + pts * io_b, pts * fwd,
                           PEAK_BF16_FLOPS)
        chain = forward_chain(packed, p["enc"])
        modes += [
            (trm.apply_mlp, "custom", f"forward {name} {shape}",
             lambda f, p=p: f(packed, p["enc"]), per_step, fwd_bound, None,
             None, chain),
            (trm.apply_mlp, "custom", f"recompute (stash) {name} {shape}",
             lambda f, p=p, stash=stash: f(packed, p["enc"], stash=stash),
             per_step, fwd_bound, weight_bytes + pts * (io_b + kept_b), None,
             chain),
            (trm.mlp_backward, "custom", f"output head {name} {shape}",
             lambda f, p=p, cots=cots: f(p["g"], p["y"], packed,
                                         p["t6_stash"], cots,
                                         from_output=True),
             per_step, _bound(weight_bytes + pts * head_b, pts * dx,
                              PEAK_BF16_FLOPS),
             weight_bytes + pts * (head_b + 2 * n * u + cots_b
                                   + 2 * trm.D_HEAD), None,
             pytorch_chain(p["g"], p["y"], packed, p["t6_stash"],
                           from_output=True)),
            (trm.mlp_weight_grad, "custom", f"{name} {shape}",
             lambda f, p=p, acc=acc: f(p["t6_stash"], p["t6_cots"], acc),
             per_step, _bound(grad_bytes, pts * fwd, PEAK_BF16_FLOPS),
             grad_bytes + pts * (2 * 128 + kept_b + cots_b
                                 + 2 * trm.D_HEAD)
             + _weight_grad_partial_bytes(p["t6_stash"], p["t6_cots"], acc),
             _weight_grad_library(p["t6_stash"], p["t6_cots"], acc)),
        ]
    return modes


def _t5_t6_times(ti: dict, cfg, timed: list, card_tag):
    """T5 (``apply_mlp``'s forward launches, from the timing phase's
    ``timed`` modes) and T6 (``fused_mlp_backward`` whole, timed here) per
    128^2 custom-loss step, beside their plain versions and bounds: T5's
    least work is the forward's unpadded products, T6's the forward, dX and
    dW (3,489,024 FLOP per point at 8 x 256), at 989 TFLOP/s."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models.engine import tree_leaves

    packed = ti["packed"]
    per_step = IMG * IMG // TRAIN_CHUNK
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       tree_leaves(packed))
    grad_bytes = 2 * F32B * sum(t.numel() for t in tree_leaves(packed))
    fwd = trm.fwd_flop_per_point(cfg.mlp)
    t6_flop = 2 * fwd + trm.bwd_dx_flop_per_point(cfg.mlp)
    t6 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "by": {}}
    for name, p in ti["passes"].items():
        pts = p["enc"].shape[0]
        kms = _time_ms(lambda p=p: trm.fused_mlp_backward(packed, p["enc"],
                                                          p["g"]), 10)
        pms = _time_ms(lambda p=p: trm.fused_mlp_backward_plain(
            packed, p["enc"], p["g"]), 2)
        bms, by = _bound(weight_bytes + grad_bytes + pts * (2 * 128 + 8),
                         pts * t6_flop, PEAK_BF16_FLOPS)
        log(f"time fused_mlp_backward (T6) {name} [{TRAIN_CHUNK} x "
            f"{p['t'].shape[1]}]: {kms:.4f} ms/call kernels, {pms:.3f} "
            f"ms/call plain, bound {bms:.4f} ms/call ({by}), "
            f"{kms / bms:.1f}x bound, {per_step} calls per custom step "
            f"{card_tag}")
        t6["ms"] += per_step * kms
        t6["plain_ms"] += per_step * pms
        t6["bound_ms"] += per_step * bms
        t6["by"][by] = t6["by"].get(by, 0.0) + per_step * bms
    t6["by"] = _by(t6["by"])
    # T5 is the forward half of apply_mlp's launches.
    fwd = [(count * kms, count * pms, count * bms)
           for k, path, mode, count, kms, pms, bms in timed
           if k is trm.apply_mlp and mode.startswith("forward")]
    fwd_ms, fwd_plain, fwd_bound = (sum(x) for x in zip(*fwd))
    log(f"T5 (apply_mlp forward, 16 launches) per {IMG}^2 custom step: "
        f"{fwd_ms:.4f} ms kernel, {fwd_plain:.3f} ms plain, bound "
        f"{fwd_bound:.4f} ms (operations), {fwd_ms / fwd_bound:.1f}x "
        f"{card_tag}")
    log(f"T6 (fused_mlp_backward, 16 calls) per {IMG}^2 custom step: "
        f"{t6['ms']:.4f} ms kernels, {t6['plain_ms']:.3f} ms plain, bound "
        f"{t6['bound_ms']:.4f} ms ({t6['by']}), "
        f"{t6['ms'] / t6['bound_ms']:.1f}x {card_tag}")
    log(json.dumps({"t5_t6_per_custom_step": {
        "T5_apply_mlp_forward": {"launches": 2 * per_step, "ms": fwd_ms,
                                 "plain_ms": fwd_plain,
                                 "bound_ms": fwd_bound,
                                 "bound_by": "operations"},
        "T6_fused_mlp_backward": {
            "calls": 2 * per_step, "ms": t6["ms"],
            "plain_ms": t6["plain_ms"], "bound_ms": t6["bound_ms"],
            "bound_by": t6["by"]},
        "kernel_ms_by_mode": {f"{k.name} {mode}": count * kms
                              for k, path, mode, count, kms, _, _ in timed
                              if path == "custom"},
        "card": card_tag.strip("[]")}}))


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


# ---------------------------------------------------------------------------
# The int8 render tier and the tensor-core ceiling probe.


def _int8_kernel_checks(packed_q, base, slope, masks, tc, u, errors):
    """T4 against its plain version on the same inputs at the orbit's
    shapes: the coarse model sigma-only on the stratified depths [4096 x
    64], the fine model in full on the depths ``sample_merge`` draws from
    the int8 coarse weights [4096 x 192]. Returns the timing phase's
    inputs."""
    import torch

    from keras_nerf_tpu_torch.kernels import ray_march as trm

    q_c, q_f = packed_q
    sig_k = trm.ray_march_mlp_int8(q_c, base, slope, tc, masks,
                                   sigma_only=True)
    sig_p = trm.ray_march_mlp_int8.plain(q_c, base, slope, tc, masks,
                                         sigma_only=True)
    wc = trm.ray_march_quadrature.plain(sig_p.reshape(CHUNK, N_COARSE), tc,
                                        True, True, True)[2]
    tf = trm.sample_merge.plain(tc, wc, u, tc)
    rgbs_k = trm.ray_march_mlp_int8(q_f, base, slope, tf, masks)
    rgbs_p = trm.ray_march_mlp_int8.plain(q_f, base, slope, tf, masks)
    torch.cuda.synchronize()
    tol = TOL["ray_march_mlp_int8"]
    ok = True
    for label, got, want in (
            (f"sigma-only (coarse) [{CHUNK} x {N_COARSE}]", sig_k, sig_p),
            (f"full (fine) [{CHUNK} x {N_COARSE + N_FINE}]", rgbs_k, rgbs_p)):
        diff = (got - want).abs()
        err = float(diff.max())
        errors["ray_march_mlp_int8"] = max(
            errors.get("ray_march_mlp_int8", 0.0), err)
        good = bool(torch.isfinite(got).all()) and err <= tol
        ok = ok and good
        sigma = want if want.dim() == 1 else want[:, 3]
        log(f"check ray_march_mlp_int8 {label}: max_abs_err {err:.3e} "
            f"(tolerance {tol:.0e}), outputs not bit-equal "
            f"{int((diff > 0).sum())}/{diff.numel()}, sigma max "
            f"{float(sigma.max()):.3f} {'ok' if good else 'FAIL'}")
    if not ok:
        fail("ray_march_mlp_int8 disagrees with its plain version")
    return {"q": packed_q, "base": base, "slope": slope, "masks": masks,
            "tc": tc, "tf": tf}


def _quantized_main_path(nerf, cfg, bf16_images, card_tag):
    """The int8 orbit: a model compiled with ``quantized_render=True`` on
    the bf16 model's weights renders 4 frames through ``render_orbit``.
    The first run calibrates (``apply_mlp``'s stash mode, once per model)
    and both passes of every chunk run ``ray_march_mlp_int8``, never
    ``ray_march_mlp``; a second run, timed, calibrates nothing. Prints the
    int8 frames' difference from the bf16 frames of the same poses and
    draws. Returns the second run's launch counts and the model."""
    import numpy as np
    import torch

    from keras_nerf_tpu_torch.inference import ORBIT, render_orbit
    from keras_nerf_tpu_torch.kernels import KERNELS, reset_launch_counts
    from keras_nerf_tpu_torch.models import NeRF

    qnerf = NeRF(config=cfg)
    qnerf.compile(batch_size=1, image_height=IMG, image_width=IMG,
                  ray_chunks=CHUNK, white_background=True, device="cuda",
                  seed=0, quantized_render=True)
    qnerf.state = nerf.state
    chunks = len(FRAMES) * IMG * IMG // CHUNK
    expected = {k.name: 0 for k in KERNELS}
    expected.update(sample_merge=chunks, ray_march_quadrature=2 * chunks,
                    ray_march_mlp_int8=2 * chunks)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    render_orbit(qnerf, FRAMES, img_wh=IMG, **ORBIT)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    calibrating = {k.name: k.launches for k in KERNELS}
    if calibrating != {**expected, "apply_mlp": 2}:
        fail(f"int8 orbit with calibration: launch counts {calibrating} != "
             f"expected {expected} and 2 apply_mlp (the calibration)")
    reset_launch_counts()
    t0 = time.perf_counter()
    images, depths = render_orbit(qnerf, FRAMES, img_wh=IMG, **ORBIT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    per_frame = {k: v // len(FRAMES) for k, v in launches.items() if v}
    log(f"int8 main path: {len(FRAMES)} frames {IMG}^2 in {wall:.3f} s "
        f"({1e3 * wall / len(FRAMES):.1f} ms/frame wall, host clock; the "
        f"first run, calibration included, {first:.3f} s) {card_tag}; "
        f"launches per frame {per_frame}; with calibration {calibrating}")
    if launches != expected:
        fail(f"int8 orbit: launch counts {launches} != expected {expected}")
    if images.shape != (len(FRAMES), IMG, IMG, 3) or not (
            np.isfinite(images).all() and images.min() >= 0.0
            and images.max() <= 1.0 and np.isfinite(depths).all()):
        fail("int8 frames malformed, not finite or outside [0, 1]")
    diff = np.abs(images - bf16_images)
    log(f"int8 frames vs bf16 frames (same weights, poses and draws): image "
        f"max abs {diff.max():.4f} mean {diff.mean():.3e}; image mean "
        f"{images.mean():.4f} (bf16 {bf16_images.mean():.4f}), std "
        f"{images.std():.4f}, depth mean {depths.mean():.4f}")
    return launches, qnerf


def _quantized_e2e(packed_q, params, fine_params, cfg, gen):
    """A 16^2 int8 render on the card against the same int8 weights moved
    to the CPU (the plain versions), same rays and draws, held at the
    fused-sampling budget ``E2E_TOL``."""
    import torch

    from keras_nerf_tpu_torch.data import (
        generate_ray_batch,
        get_focal_from_fov,
        pose_spherical,
    )
    from keras_nerf_tpu_torch.inference import ORBIT
    from keras_nerf_tpu_torch.models.engine import render_image_batch
    from keras_nerf_tpu_torch.ops import sorted_uniforms

    rays = generate_ray_batch(
        pose_spherical(30.0, ORBIT["phi"], ORBIT["z_translate"])[None], gen,
        image_height=E2E_IMG, image_width=E2E_IMG,
        focal=get_focal_from_fov(ORBIT["fov"], E2E_IMG), near=ORBIT["near"],
        far=ORBIT["far"], n_samples=N_COARSE)
    draws = [sorted_uniforms(gen, (E2E_IMG * E2E_IMG,), N_FINE)]
    cpu = torch.device("cpu")
    _, card = render_image_batch(params, fine_params, rays, draws, cfg,
                                 E2E_IMG * E2E_IMG, packed_q=packed_q)
    _, host = render_image_batch(
        _to(params, cpu), _to(fine_params, cpu),
        tuple(x.to(cpu) for x in rays), [x.to(cpu) for x in draws], cfg,
        E2E_IMG * E2E_IMG, packed_q=tuple(_to(q, cpu) for q in packed_q))
    diff = {k: (card[k].cpu() - host[k]).abs() for k in ("image", "depth")}
    err = {k: float(v.max()) for k, v in diff.items()}
    log(f"int8 end to end {E2E_IMG}^2, card kernels vs CPU plain versions "
        f"(same int8 weights): " + ", ".join(
            f"{k} max_abs_err {err[k]:.3e} mean {float(v.mean()):.3e} "
            f"(tolerance {E2E_TOL[k]:.0e})" for k, v in diff.items()))
    if any(err[k] > E2E_TOL[k] for k in err):
        fail("the card's int8 render disagrees with the plain versions")


def _ceiling_probe(errors, card_tag):
    """``mma_ceiling`` against its plain version at the probe's shapes
    ``CEILING_CHECK`` (both modes, a bias so that ``epi`` adds one, each
    grid step's own seed), then the probe's own entry point
    ``profile_mma_ceiling.measure`` at ``CEILING_RUN`` with 3 timed calls
    per mode: its launch counts and TFLOP/s."""
    import torch

    from keras_nerf_tpu_torch.kernels import (
        KERNELS,
        mma_ceiling,
        reset_launch_counts,
    )
    from keras_nerf_tpu_torch.kernels.ceiling import (
        MODES,
        make_inputs,
        pytorch_chain,
    )
    from keras_nerf_tpu_torch.profile_mma_ceiling import measure

    c = CEILING_CHECK
    ws, bs, seed = make_inputs(c["grid"], c["u"], "cuda", seed=1,
                               bias_scale=0.05)
    seed += torch.arange(c["grid"], device="cuda").repeat_interleave(8)[
        :, None] * 1e-2
    for mode in MODES:
        got = mma_ceiling(ws, bs, seed, c["t"], c["rep"], mode)
        want = mma_ceiling.plain(ws, bs, seed, c["t"], c["rep"], mode)
        torch.cuda.synchronize()
        err = _rel_max(got, want)
        errors["mma_ceiling"] = max(errors.get("mma_ceiling", 0.0),
                                    float((got - want).abs().max()))
        ok = bool(torch.isfinite(got).all()) and err <= TOL["mma_ceiling"]
        log(f"check mma_ceiling {mode} [{c['grid']} x {c['t']}, u "
            f"{c['u']}, rep {c['rep']}]: relative max err {err:.3e} "
            f"(tolerance {TOL['mma_ceiling']:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("mma_ceiling disagrees with its plain version")
    # ROADMAP C7: at the probe's full depth (16 passes, 128 layers) bf16
    # roundings of sums taken in another order compound past TOL. Read the
    # kernel and the plain version (float32 sums) each against the plain
    # version with float64 sums, two valid orders, and hold the kernel's
    # drift to CEILING_DRIFT_RATIO times the plain version's, and to
    # CEILING_TC_RATIO times that of the same chain summed on the tensor
    # cores (ceiling.pytorch_chain), the plain order of the kernel's own
    # accumulation.
    c = CEILING_RUN
    ws, bs, seed = make_inputs(c["grid"], c["u"], "cuda", seed=1,
                               bias_scale=0.05)
    seed += torch.arange(c["grid"], device="cuda").repeat_interleave(8)[
        :, None] * 1e-2
    for mode in MODES:
        got = mma_ceiling(ws, bs, seed, c["t"], c["rep"], mode)
        plain = mma_ceiling.plain(ws, bs, seed, c["t"], c["rep"], mode)
        wide = mma_ceiling.plain(ws, bs, seed, c["t"], c["rep"], mode,
                                 sums=torch.float64)
        tc = pytorch_chain(ws, bs, seed, c["t"], c["rep"], mode)
        torch.cuda.synchronize()
        drift, plain_drift = _rel_max(got, wide), _rel_max(plain, wide)
        tc_drift = _rel_max(tc, wide)
        ok = (bool(torch.isfinite(got).all())
              and drift <= CEILING_TC_RATIO * tc_drift)
        log(f"check mma_ceiling {mode} at full depth against the chain "
            f"summed on the tensor cores (bf16 torch.mm, float32 out, "
            f"reduced-precision reduction off): drift from the float64 "
            f"order, kernel {drift:.3e}, that chain {tc_drift:.3e}: ratio "
            f"{drift / tc_drift:.3f} (at most {CEILING_TC_RATIO:g}); kernel "
            f"against that chain {_rel_max(got, tc):.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("mma_ceiling at full depth drifts further than the chain "
                 "summed on the tensor cores does")
        ok = (bool(torch.isfinite(got).all())
              and drift <= CEILING_DRIFT_RATIO * plain_drift)
        log(f"check mma_ceiling {mode} at full depth [{c['grid']} x "
            f"{c['t']}, u {c['u']}, rep {c['rep']}]: relative max err "
            f"against the plain version {_rel_max(got, plain):.3e}; against "
            f"the plain version with float64 sums, kernel {drift:.3e}, plain "
            f"version (float32 sums) {plain_drift:.3e} (kernel at most "
            f"{CEILING_DRIFT_RATIO:g}x the plain version's) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("mma_ceiling at full depth drifts further than the plain "
                 "version does")
        del got, plain, wide, tc
    reset_launch_counts()
    rows = measure(iters=3, **CEILING_RUN)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    expected = {k.name: 0 for k in KERNELS}
    expected["mma_ceiling"] = len(MODES) * 4
    for r in rows:
        log(f"ceiling probe {r['mode']}: T={r['T']} U={r['U']} rep="
            f"{r['rep']} grid={r['grid']}: {r['ms']:.3f} ms/call, "
            f"{r['tflops']:.1f} TFLOP/s ({100 * r['share_of_peak']:.1f}% of "
            f"989 TFLOP/s bf16 dense), weights from L2 "
            f"{r['l2_weight_tbps']:.2f} TB/s {card_tag}")
    if launches != expected:
        fail(f"ceiling probe launch counts {launches} != {expected}")
    # The timing phase's inputs, as measure makes them.
    return launches, make_inputs(CEILING_RUN["grid"], CEILING_RUN["u"],
                                 "cuda")


def _quantized_modes(qi: dict, cfg) -> list:
    """T4's timing modes at the orbit's chunks, each launched 4 times per
    frame: the coarse model sigma-only and the fine model in full. Bound:
    the unpadded forward's operations at the dense int8 rate, against the
    per-ray coefficients, depths, int8 weights and scales in and the
    outputs out."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models.engine import tree_leaves

    per_frame = IMG * IMG // CHUNK
    q_c, q_f = qi["q"]
    modes = []
    for q, t, sigma_only, label in ((q_c, qi["tc"], True, "sigma-only"),
                                    (q_f, qi["tf"], False, "full")):
        pts = t.numel()
        nbytes = (sum(x.numel() * x.element_size() for x in tree_leaves(q))
                  + 2 * CHUNK * 128 * F32B + pts * F32B
                  + pts * F32B * (1 if sigma_only else 4))
        flop = pts * trm.fwd_flop_per_point(cfg.mlp, sigma_only=sigma_only)
        modes.append((trm.ray_march_mlp_int8, "quantized",
                      f"{label} [{CHUNK} x {t.shape[1]}]",
                      lambda f, q=q, t=t, so=sigma_only: f(
                          q, qi["base"], qi["slope"], t, qi["masks"],
                          sigma_only=so),
                      per_frame, _bound(nbytes, flop, PEAK_INT8_OPS)))
    return modes


def _ceiling_modes(inputs: tuple) -> list:
    """T7's timing modes: one call of each mode at the TPU script's
    defaults. Bound: its products at the bf16 peak (it moves about 1 MB);
    the 9th item is the PyTorch chain of the same function
    (``ceiling.pytorch_chain``: one bf16 ``torch.mm`` a layer)."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.kernels.ceiling import (
        MODES,
        ceiling_flop,
        pytorch_chain,
    )

    c = CEILING_RUN
    ws, bs, seed = inputs
    flop = ceiling_flop(c["grid"], c["t"], c["u"], c["rep"])
    # The weights and the seed read once, the [grid * 8, 128] slice written.
    nbytes = (sum(x.numel() * x.element_size() for x in (*ws, *bs))
              + 2 * seed.numel() * seed.element_size())
    return [(trm.mma_ceiling, "probe", f"{mode} [T={c['t']}, u={c['u']}, "
             f"rep={c['rep']}, grid={c['grid']}]",
             lambda f, mode=mode: f(ws, bs, seed, c["t"], c["rep"], mode), 1,
             _bound(nbytes, flop, PEAK_BF16_FLOPS), None, None,
             lambda mode=mode: pytorch_chain(ws, bs, seed, c["t"], c["rep"],
                                             mode))
            for mode in MODES]


# ---------------------------------------------------------------------------
# The width C10 opened (u = 768) and T4's other widths.


def _ran(launches: dict, names, label: str) -> None:
    """Fails unless each kernel of ``names`` launched in the run read."""
    idle = [n for n in names if not launches.get(n)]
    if idle:
        fail(f"{label}: {', '.join(idle)} never launched ({launches})")


def _counts() -> dict:
    from keras_nerf_tpu_torch.kernels import KERNELS

    return {k.name: k.launches for k in KERNELS}


def _calibration_error(q, q_ref):
    """(worst relative error of the scales, most steps a code moved) of the
    quantized states ``q`` (card) against ``q_ref`` (CPU)."""
    import torch

    from keras_nerf_tpu_torch.models import engine

    scale_err, moved = 0.0, 0
    for a, b in zip(engine.tree_leaves([{k: v for k, v in x.items()
                                         if k != "transposed"} for x in q]),
                    engine.tree_leaves(list(q_ref))):
        a = a.cpu()
        if a.dtype == torch.int8:
            moved = max(moved, int((a.int() - b.int()).abs().max()))
        else:
            scale_err = max(scale_err, float(((a - b).abs() / b.abs()
                                              .clamp_min(1e-30)).max()))
    return scale_err, moved


def _shape_label(shape: dict) -> str:
    return f"u{shape['dense_units']}x{shape['n_layers']}"


def _wide_phases(gen, errors, rel_errors, card_tag, shape,
                 int8_widths) -> dict:
    """ROADMAP C10 and C12 at ``shape`` (one of ``WIDE_SHAPES``), fog
    weights.

    * Each kernel and mode against its plain version on the same inputs,
      each run twice with identical bits, on a 16^2 frame's rays [256 x
      64]: ``ray_march_mlp`` sigma-only, full and train (``TRAIN_TOL``,
      outputs and stash), ``apply_mlp`` with and without its stash,
      ``mlp_backward`` in both modes on the plain chain's cotangents,
      ``mlp_weight_grad`` on the plain chain's stash and each mode's plain
      cotangents (per leaf, its launches per call printed).
    * Every path through the kernels, its launch counts read just after it
      runs: the 16^2 render (``render_image_batch``) against the CPU's
      (``E2E_TOL``); an MSE step (T3) and an L1 step (T5/T6) against the
      CPU's, losses at ``STEP_TOL``'s rtol and the whole gradient at its
      relative norm (each leaf's worst printed); a 32^3 bake through
      ``model_density_fn`` (one chunk held against ``apply_mlp``'s plain
      version); the int8 calibration (``quantize_render_params``, whose
      ranges come from ``apply_mlp``'s stash) against the CPU's on the
      card's fine depths and, outside ``CALIB_PINNED``, on its own (scales
      at ``CALIB_RTOL``, codes within one step) and a 16^2 int8 render on the
      card's int8 weights against the CPU's (``E2E_TOL``).
    * T4 at the shape's width and each of ``int8_widths`` against its plain
      version in both modes, twice with identical bits (``TOL``).

    Each kernel mode (``mlp_weight_grad`` on the plain chain's operands)
    and T4 at each width are then timed at [4096 x 64] beside its plain
    version and bound. Returns ``{"launches": by path, "times": kernel ->
    [timing rows]}``."""
    import torch

    from keras_nerf_tpu_torch.kernels import quantize as tq
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.kernels import reset_launch_counts
    from keras_nerf_tpu_torch.models import NeRFConfig, engine, init_mlp
    from keras_nerf_tpu_torch.ops import occupancy as occ_mod
    from keras_nerf_tpu_torch.ops import sorted_uniforms

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = NeRFConfig(n_coarse=N_COARSE, n_fine=N_FINE,
                     white_background=True, **shape)
    width, n = cfg.dense_units, cfg.n_layers
    params = [_fog(init_mlp(gen, cfg.mlp, cfg.in_xyz, cfg.in_dir))
              for _ in range(2)]
    packed = trm.pack_mlp_params(params[0], cfg.mlp, cfg.pos_emb_xyz,
                                 cfg.pos_emb_dir)
    small = _small_step_inputs(gen)
    (images, rays), draws = small
    o, d, t = (x.reshape(-1, x.shape[-1]) for x in rays)
    p = t.numel()
    base, slope, masks = trm.ray_encoding_coeffs(o, d, cfg.pos_emb_xyz,
                                                 cfg.pos_emb_dir)
    enc = trm.encode_block128(*trm.ray_points(o, d, t), cfg.pos_emb_xyz,
                              cfg.pos_emb_dir)
    tag = f"u {width}, {n} layers [{o.shape[0]} x {N_COARSE}]"

    def report(held):
        name, err, rel, rel_norm, ok, label = held
        errors[name] = max(errors.get(name, 0.0), err)
        old = rel_errors.get(name, (0.0, 0.0))
        rel_errors[name] = (max(old[0], rel), max(old[1], rel_norm))
        log(f"check {label}: max_abs_err {err:.3e}, relative max {rel:.3e}, "
            f"relative norm {rel_norm:.3e} (tolerance {TRAIN_TOL[name]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{label} disagrees with its plain version")

    def stash_blocks(st):
        return [st["features"], st["rf"], *st["h"]]

    # ---- each kernel and mode against its plain version -----------------
    for mode in ("sigma-only", "full", "train", "input", "input + stash"):
        kernel = trm.apply_mlp if mode.startswith("input") else \
            trm.ray_march_mlp
        runs = []
        for f in (kernel, kernel, kernel.plain):
            if kernel is trm.ray_march_mlp:
                st = trm.alloc_stash(p, width, n, dev) if mode == "train" \
                    else None
                out = f(packed, base, slope, t, masks,
                        sigma_only=mode == "sigma-only", stash=st)
            else:
                st = (trm.alloc_stash(p, width, n, dev, enc=enc)
                      if mode == "input + stash" else None)
                out = f(packed, enc, stash=st)
            runs.append([out] + ([] if st is None else stash_blocks(st)))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])):
            fail(f"{kernel.name} {mode} at {tag}: two runs differ")
        report(_held(kernel.name, list(zip(runs[0], runs[2])),
                     f"{kernel.name} {mode} at {tag}, identical bits twice"))
    stash = trm.alloc_stash(p, width, n, dev)
    rgbs = trm.ray_march_mlp.plain(packed, base, slope, t, masks, stash=stash)
    r = o.shape[0]
    target = images.reshape(r, 4)[:, :3].contiguous()
    quad = trm.ray_march_quadrature.plain(
        rgbs.reshape(r, N_COARSE, 4), t, True, False, True, target=target,
        loss_scale=2.0 / (3 * r))
    # sample_merge on this MLP's coarse weights, its draws from a generator
    # of their own (the phase's other draws stay as they were).
    merge_gen = torch.Generator(device=dev)
    merge_gen.manual_seed(14)
    _merge_held(f"fine pass at {tag[:tag.index(' [')]} [{r}, {N_COARSE} + "
                f"{N_FINE}]", t, quad[2],
                sorted_uniforms(merge_gen, (r,), N_FINE), t,
                TOL["sample_merge"], errors)
    g_out = torch.randn(p, 4, generator=gen, device=dev).to(torch.bfloat16)
    plain_cots = {}
    for label, args, kw in (
            ("quadrature mode", (quad[3], quad[4]), {}),
            ("output-head mode", (g_out, rgbs), {"from_output": True})):
        runs = [f(*args, packed, stash, **kw) for f in (
            trm.mlp_backward, trm.mlp_backward, trm.mlp_backward.plain)]
        torch.cuda.synchronize()
        leaves = [engine.tree_leaves({k: x[k] for k in (
            "d_rgb", "d_rf", "d_sf", "d_pre")}) for x in runs]
        if not all(torch.equal(a, b) for a, b in zip(leaves[0], leaves[1])):
            fail(f"mlp_backward {label} at {tag}: two runs differ")
        report(_held("mlp_backward", list(zip(leaves[0], leaves[2])),
                     f"mlp_backward {label} at {tag}, identical bits twice"))
        plain_cots[label] = runs[2]
    # mlp_weight_grad on the plain chain's stash and each mode's plain
    # cotangents, as the main path holds it: every packed gradient per leaf
    # (TRAIN_TOL), twice with identical bits, in as many launches per call
    # as weight_grad_plan splits the call into.
    for label, cots in plain_cots.items():
        split = len(trm.weight_grad_plan(
            [(a.shape[1], g.shape[1], b is not None) for a, g, _, b in
             trm.weight_grad_tasks(stash, cots, trm.zero_grads(packed))],
            p)["launches"])
        want = trm.mlp_weight_grad.plain(stash, cots, trm.zero_grads(packed))
        runs = [trm.mlp_weight_grad(stash, cots, trm.zero_grads(packed))
                for _ in range(2)]
        torch.cuda.synchronize()
        leaves = [engine.tree_leaves(x) for x in (*runs, want)]
        if not all(torch.equal(a, b) for a, b in zip(leaves[0], leaves[1])):
            fail(f"mlp_weight_grad on the {label}'s cotangents at {tag}: two "
                 f"runs differ")
        report(_held("mlp_weight_grad", list(zip(leaves[0], leaves[2])),
                     f"mlp_weight_grad, every packed gradient on the "
                     f"{label}'s cotangents at {tag}, {split} launch(es) per "
                     f"call, identical bits twice"))

    launches = {}
    # ---- the render ---------------------------------------------------------
    torch.cuda.synchronize()
    reset_launch_counts()
    _, card = engine.render_image_batch(params[0], params[1], rays, draws,
                                        cfg, E2E_CHUNK)
    torch.cuda.synchronize()
    launches["render"] = _counts()
    _ran(launches["render"], ("sample_merge", "ray_march_mlp",
                              "ray_march_quadrature"), f"render at u {width}")
    _, host = engine.render_image_batch(
        *(_to(x, cpu) for x in params), tuple(x.to(cpu) for x in rays),
        [x.to(cpu) for x in draws], cfg, E2E_CHUNK)
    err = {k: float((card[k].cpu() - host[k]).abs().max())
           for k in ("image", "depth")}
    ok = all(err[k] <= E2E_TOL[k] for k in err)
    log(f"render {E2E_IMG}^2 at u {width}, card kernels vs CPU plain "
        f"versions: " + ", ".join(f"{k} max_abs_err {v:.3e} (tolerance "
                                  f"{E2E_TOL[k]:.0e})" for k, v in err.items())
        + f"; launches {launches['render']} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the card's render at u {width} disagrees with the CPU's")

    # ---- an MSE step (T3) and an L1 step (T5/T6) ---------------------------
    state = engine.TrainState(params[0], params[1], {}, {}, 0)
    for key, loss, names in (
            ("train", None, ("sample_merge", "ray_march_mlp",
                             "ray_march_quadrature", "mlp_backward",
                             "mlp_weight_grad")),
            ("train_custom", l1_loss, ("apply_mlp", "mlp_backward",
                                       "mlp_weight_grad"))):
        torch.cuda.synchronize()
        reset_launch_counts()
        m_card, g_card = _one_step(state, small, cfg, "cuda", loss)
        launches[key] = _counts()
        _ran(launches[key], names, f"{key} step at u {width}")
        m_host, g_host = _one_step(state, small, cfg, "cpu", loss)
        flat = [torch.cat([x.flatten() for x in leaves])
                for leaves in (sum(g_card, []), sum(g_host, []))]
        grad = _rel_norm(flat[0], flat[1])
        loss_err = max(abs(m_card[k] - m_host[k]) / abs(m_host[k])
                       for k in ("coarse_loss", "fine_loss"))
        worst = max(_rel_norm(a, b) for a, b in zip(sum(g_card, []),
                                                     sum(g_host, [])))
        ok = (grad <= STEP_TOL["grad_rel_norm"]
              and loss_err <= STEP_TOL["loss_rtol"])
        log(f"{key} step {E2E_IMG}^2 at u {width}, card kernels vs CPU plain "
            f"versions: losses rtol {loss_err:.3e} (tolerance "
            f"{STEP_TOL['loss_rtol']}), whole gradient relative norm "
            f"{grad:.3e} (tolerance {STEP_TOL['grad_rel_norm']}), worst leaf "
            f"{worst:.3e}; launches {launches[key]} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the card's {key} step at u {width} disagrees with the "
                 f"CPU's")

    # ---- the bake -------------------------------------------------------------
    coords = occ_mod.grid_coordinates(32, device=dev).reshape(-1, 3)
    chunk = coords[:4096]
    enc_b = trm.encode_block128(chunk, torch.tensor(
        [0.0, 0.0, -1.0], device=dev).expand(chunk.shape), cfg.pos_emb_xyz,
        cfg.pos_emb_dir)
    packed_f = trm.pack_mlp_params(params[1], cfg.mlp, cfg.pos_emb_xyz,
                                   cfg.pos_emb_dir)
    report(_held("apply_mlp", [(trm.apply_mlp(packed_f, enc_b)[:, 3],
                                trm.apply_mlp.plain(packed_f, enc_b)[:, 3])],
                 f"apply_mlp, the bake's sigma at u {width} [4096]"))
    density = occ_mod.model_density_fn(params[1], cfg)
    threshold = float(torch.quantile(density(coords[::8]), OCC_QUANTILE))
    torch.cuda.synchronize()
    reset_launch_counts()
    grid = occ_mod.bake_occupancy_grid(density, 32,
                                       sigma_threshold=threshold, device=dev)
    torch.cuda.synchronize()
    launches["occupancy_bake"] = _counts()
    _ran(launches["occupancy_bake"], ("apply_mlp",), f"bake at u {width}")
    share = float(grid.mean())
    log(f"bake 32^3 at u {width}: occupied share {share:.4f} (must lie in "
        f"{OCC_SHARE}); launches {launches['occupancy_bake']}")
    if not OCC_SHARE[0] <= share <= OCC_SHARE[1]:
        fail(f"the bake at u {width} is empty or full")

    # ---- the int8 tier: calibration, render, T4 ----------------------------
    # Each device calibrates the fine model on the fine depths that it draws
    # from its own float32 coarse render. The card's calibration is held
    # against the CPU's on the card's fine depths (the kernels on the same
    # inputs) at every shape, and against the CPU's on its own depths
    # (each device end to end) at every shape outside CALIB_PINNED. The
    # witness is the CPU alone on the two sets of depths: how far the draw
    # of fine depths moves the scales with no kernel in it.
    calib = sorted_uniforms(gen, (o.shape[0],), N_FINE)
    card_depths, host_depths = [], []

    def recorded(into):
        def wrap(invert):
            def call(*args, **kwargs):
                into.append(invert(*args, **kwargs))
                return into[-1]
            return call
        return wrap

    def pinned(invert):
        pending = list(card_depths)

        def call(*args, **kwargs):
            own = invert(*args, **kwargs)
            assert pending[0].shape == own.shape
            return pending.pop(0).to(own.device)
        return call

    torch.cuda.synchronize()
    reset_launch_counts()
    with _Swapped([(engine, "invert_cdf", recorded(card_depths))]):
        q = engine.quantize_render_params(params[0], params[1], rays, calib,
                                          cfg)
    torch.cuda.synchronize()
    launches["int8_calibration"] = _counts()
    _ran(launches["int8_calibration"], ("apply_mlp",),
         f"int8 calibration at u {width}")
    host_args = (*(_to(x, cpu) for x in params),
                 tuple(x.to(cpu) for x in rays), calib.to(cpu), cfg)
    with _Swapped([(engine, "invert_cdf", pinned)]):
        q_pinned = engine.quantize_render_params(*host_args)
    with _Swapped([(engine, "invert_cdf", recorded(host_depths))]):
        q_own = engine.quantize_render_params(*host_args)
    shift = max(float((a.cpu() - b).abs().max())
                for a, b in zip(card_depths, host_depths))
    held_own = (n, width) not in CALIB_PINNED
    for label, got, want, held in (
            ("card vs the CPU on the card's fine calibration depths", q,
             q_pinned, True),
            ("card vs the CPU on its own depths", q, q_own, held_own),
            ("witness: the CPU on the card's depths vs on its own",
             q_pinned, q_own, False)):
        scale_err, moved = _calibration_error(got, want)
        ok = scale_err <= CALIB_RTOL and moved <= 1
        log(f"int8 calibration at u {width}, {n} layers (apply_mlp's "
            f"stash), {label}: scales worst relative error {scale_err:.3e} "
            f"(tolerance {CALIB_RTOL:.0e}), codes moved at most {moved} "
            f"step(s) (tolerance 1), fine depths {shift:.3e} apart at most; "
            f"launches {launches['int8_calibration']} "
            + ({True: "ok", False: "FAIL"}[ok] if held else "(not held)"))
        if held and not ok:
            fail(f"the int8 calibration at u {width}, {n} layers disagrees "
                 f"with the CPU's ({label})")
    torch.cuda.synchronize()
    reset_launch_counts()
    _, card = engine.render_image_batch(params[0], params[1], rays, draws,
                                        cfg, E2E_CHUNK, packed_q=q)
    torch.cuda.synchronize()
    launches["render_quantized"] = _counts()
    _ran(launches["render_quantized"], ("sample_merge",
                                        "ray_march_mlp_int8",
                                        "ray_march_quadrature"),
         f"int8 render at u {width}")
    _, host = engine.render_image_batch(
        *(_to(x, cpu) for x in params), tuple(x.to(cpu) for x in rays),
        [x.to(cpu) for x in draws], cfg, E2E_CHUNK,
        packed_q=tuple(_to({k: v for k, v in x.items() if k != "transposed"},
                           cpu) for x in q))
    err = {k: float((card[k].cpu() - host[k]).abs().max())
           for k in ("image", "depth")}
    ok = all(err[k] <= E2E_TOL[k] for k in err) and \
        not launches["render_quantized"]["ray_march_mlp"]
    log(f"int8 render {E2E_IMG}^2 at u {width}, card kernels vs CPU plain "
        f"versions on the card's int8 weights: " + ", ".join(
            f"{k} max_abs_err {v:.3e} (tolerance {E2E_TOL[k]:.0e})"
            for k, v in err.items())
        + f"; launches {launches['render_quantized']} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the card's int8 render at u {width} disagrees with the CPU's")

    states = {width: (q[0], cfg)}
    for u_q in int8_widths:
        if u_q in states:
            continue
        c_q = NeRFConfig(n_coarse=N_COARSE, n_fine=N_FINE,
                         white_background=True,
                         **dict(shape, dense_units=u_q))
        pk = trm.pack_mlp_params(_fog(init_mlp(gen, c_q.mlp, c_q.in_xyz,
                                               c_q.in_dir)), c_q.mlp,
                                 c_q.pos_emb_xyz, c_q.pos_emb_dir)
        states[u_q] = (tq.quantize_packed(pk, tq.collect_act_amax(
            pk, enc, c_q.mlp), c_q.mlp), c_q)
    for u_q in states:
        q_u = states[u_q][0]
        for sigma_only in (True, False):
            runs = [f(q_u, base, slope, t, masks, sigma_only=sigma_only)
                    for f in (trm.ray_march_mlp_int8, trm.ray_march_mlp_int8,
                              trm.ray_march_mlp_int8.plain)]
            torch.cuda.synchronize()
            diff = float((runs[0] - runs[2]).abs().max())
            errors["ray_march_mlp_int8"] = max(
                errors.get("ray_march_mlp_int8", 0.0), diff)
            ok = (torch.equal(runs[0], runs[1]) and diff <= TOL[
                "ray_march_mlp_int8"] and bool(torch.isfinite(runs[0]).all()))
            kind = "sigma-only" if sigma_only else "full"
            log(f"check ray_march_mlp_int8 {kind} at u {u_q}, {n} layers "
                f"[{o.shape[0]} x "
                f"{N_COARSE}]: max_abs_err {diff:.3e} (tolerance "
                f"{TOL['ray_march_mlp_int8']:.0e}), identical bits twice "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"ray_march_mlp_int8 at u {u_q} disagrees with its "
                     f"plain version or with itself")

    # ---- times at [4096 x 64] -------------------------------------------------
    rays4 = CHUNK
    o4 = o.repeat(rays4 // o.shape[0], 1)
    d4 = d.repeat(rays4 // d.shape[0], 1)
    t4 = t.repeat(rays4 // t.shape[0], 1)
    b4, s4, m4 = trm.ray_encoding_coeffs(o4, d4, cfg.pos_emb_xyz,
                                         cfg.pos_emb_dir)
    e4 = trm.encode_block128(*trm.ray_points(o4, d4, t4), cfg.pos_emb_xyz,
                             cfg.pos_emb_dir)
    p4 = t4.numel()
    st4 = trm.alloc_stash(p4, width, n, dev)
    ste4 = trm.alloc_stash(p4, width, n, dev, enc=e4)
    rgb4 = trm.ray_march_mlp.plain(packed, b4, s4, t4, m4, stash=st4)
    q4 = trm.ray_march_quadrature.plain(
        rgb4.reshape(rays4, N_COARSE, 4), t4, True, False, True,
        target=target.repeat(rays4 // r, 1), loss_scale=2.0 / (3 * rays4))
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in engine.tree_leaves(packed))
    weight_elems = sum(x.numel() for x in engine.tree_leaves(packed))
    g4 = torch.randn(p4, 4, generator=gen, device=dev).to(torch.bfloat16)
    cots4 = trm.mlp_backward.plain(q4[3], q4[4], packed, st4)
    cot_bytes = sum(x.numel() * x.element_size() for x in
                    engine.tree_leaves([cots4[k] for k in ("d_rgb", "d_rf",
                                                           "d_sf", "d_pre")]))
    acc4 = trm.zero_grads(packed)
    fwd = p4 * trm.fwd_flop_per_point(cfg.mlp)
    fwd_sigma = p4 * trm.fwd_flop_per_point(cfg.mlp, sigma_only=True)
    dx = p4 * trm.bwd_dx_flop_per_point(cfg.mlp)
    act = p4 * 2 * (width * (n + 1) + width // 2)   # a stash's bf16 blocks
    enc_in = 2 * rays4 * 128 * F32B + p4 * F32B
    rows = [  # kernel, mode, call, bound
        (trm.ray_march_mlp, "sigma-only", lambda f: f(
            packed, b4, s4, t4, m4, sigma_only=True),
         _bound(weight_bytes + enc_in + p4 * F32B, fwd_sigma,
                PEAK_BF16_FLOPS)),
        (trm.ray_march_mlp, "full", lambda f: f(packed, b4, s4, t4, m4),
         _bound(weight_bytes + enc_in + 4 * p4 * F32B, fwd,
                PEAK_BF16_FLOPS)),
        (trm.ray_march_mlp, "train", lambda f: f(
            packed, b4, s4, t4, m4, stash=st4),
         _bound(weight_bytes + enc_in + 4 * p4 * F32B + act + 256 * p4,
                fwd, PEAK_BF16_FLOPS)),
        (trm.apply_mlp, "input", lambda f: f(packed, e4),
         _bound(weight_bytes + 256 * p4 + 4 * p4 * F32B, fwd,
                PEAK_BF16_FLOPS)),
        (trm.apply_mlp, "input + stash", lambda f: f(packed, e4, stash=ste4),
         _bound(weight_bytes + 256 * p4 + 4 * p4 * F32B + act, fwd,
                PEAK_BF16_FLOPS)),
        (trm.mlp_backward, "quadrature mode", lambda f: f(
            q4[3], q4[4], packed, st4),
         _bound(weight_bytes + 34 * p4 + 2 * act, dx, PEAK_BF16_FLOPS)),
        (trm.mlp_backward, "output-head mode", lambda f: f(
            g4, rgb4, packed, st4, from_output=True),
         _bound(weight_bytes + 56 * p4 + 2 * act, dx, PEAK_BF16_FLOPS)),
        (trm.mlp_weight_grad, "dW and db", lambda f: f(st4, cots4, acc4),
         _bound(cot_bytes + act + 256 * p4 + 2 * F32B * weight_elems, fwd,
                PEAK_BF16_FLOPS)),
    ]
    for u_q in states:
        q_u, c_q = states[u_q]
        q_bytes = sum(x.numel() * x.element_size() for x in
                      engine.tree_leaves([q_u["trunk_w"], q_u["w_feat"]]))
        for sigma_only in (True, False):
            rows.append((
                trm.ray_march_mlp_int8,
                f"{'sigma-only' if sigma_only else 'full'} at u {u_q}",
                lambda f, q_u=q_u, so=sigma_only: f(q_u, b4, s4, t4, m4,
                                                    sigma_only=so),
                _bound(q_bytes + enc_in + p4 * F32B * (1 if sigma_only
                                                       else 4),
                       p4 * trm.fwd_flop_per_point(c_q.mlp,
                                                   sigma_only=sigma_only),
                       PEAK_INT8_OPS)))
    times = {}
    for k, mode, call, (bms, by) in rows:
        kms = _time_ms(lambda: call(k), 20)
        pms = _time_ms(lambda: call(k.plain), 3)
        if " at u " not in mode:
            mode = f"{mode} at u {width}"
        log(f"time {k.name} {mode}, {n} layers [{rays4} x {N_COARSE}]: "
            f"{kms:.4f} ms/launch kernel, {pms:.3f} ms/launch plain, bound "
            f"{bms:.4f} ms/launch ({by}), {kms / bms:.1f}x bound {card_tag}")
        times.setdefault(k.name, []).append({
            "mode": f"{mode}, {n} layers [{rays4} x {N_COARSE}]",
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by})
    return {"launches": launches, "times": times}

# ---------------------------------------------------------------------------
# The occupancy render.


def _clone_tree(x):
    """A clone of each tensor of a nest of dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone_tree(v) for v in x)
    return None if x is None else x.clone()


class _CallLog:
    """Within ``with``, counts every plain-version call of the kernels and
    records, per kernel launch, ``ray_march_mlp``'s ``sigma_only`` flag and
    depths' shape ``(rays, samples)`` (the launch counts cannot tell its
    modes apart) and ``sample_merge``'s mode ``(s_c, n, s_m, the CDF
    source's row stride)``, ``s_m`` -1 where the partner is the CDF source,
    keeping clones of the inputs of the first launch of each mode; keeps,
    in ``train_inputs``, clones of the inputs of the first train-mode
    ``ray_march_mlp`` launch (the one with a stash) and of the
    ``ray_march_quadrature`` launch after it for each (depths' shape,
    weights emitted); records each quadrature launch's ``(depths' shape,
    sigma_only, weights emitted)``; counts the calls of
    ``occupancy_along_rays`` (the probe gather)."""

    def __enter__(self):
        from keras_nerf_tpu_torch.kernels import KERNELS, ray_march_mlp
        from keras_nerf_tpu_torch.kernels import (ray_march_quadrature,
                                                  sample_merge)
        from keras_nerf_tpu_torch.ops import occupancy as occ_mod

        self.plain_calls, self.mlp_modes, self.mlp_shapes = 0, [], []
        self.merges, self.inputs, self.probes = [], {}, 0
        self.quad_modes = []
        self.train_inputs, pending = {}, []
        self._saved = [(k, k.plain, k._launch) for k in KERNELS]
        self._probe = occ_mod.occupancy_along_rays

        def counted(plain):
            def call(*args, **kwargs):
                self.plain_calls += 1
                return plain(*args, **kwargs)
            return call

        for k, plain, _ in self._saved:
            k.plain = counted(plain)
        mlp, merge = ray_march_mlp._launch, sample_merge._launch
        quad = ray_march_quadrature._launch

        def mlp_launch(packed, base, slope, depths, *args, **kwargs):
            self.mlp_modes.append(bool(kwargs.get("sigma_only", False)))
            self.mlp_shapes.append(tuple(depths.shape))
            pending[:] = ([(packed, base, slope, depths, *args)]
                          if kwargs.get("stash") is not None else [])
            return mlp(packed, base, slope, depths, *args, **kwargs)

        def quad_launch(rgbs, t, white_background=False, sigma_only=False,
                        emit_weights=True, **kwargs):
            key = (tuple(t.shape), bool(emit_weights))
            self.quad_modes.append((tuple(t.shape), bool(sigma_only),
                                    bool(emit_weights)))
            if (pending and kwargs.get("target") is not None
                    and key not in self.train_inputs):
                packed, base, slope, depths, masks = pending[0]
                self.train_inputs[key] = dict(
                    packed=_clone_tree(packed), base=base.clone(),
                    slope=slope.clone(), t=depths.clone(),
                    masks=masks.clone(), target=kwargs["target"].clone(),
                    loss_scale=kwargs.get("loss_scale", 0.0),
                    white_background=white_background)
            pending.clear()
            return quad(rgbs, t, white_background, sigma_only, emit_weights,
                        **kwargs)

        def merge_launch(cp, w, u, mp, *args, **kwargs):
            s_m = 0 if mp is None else (-1 if mp is cp else mp.shape[1])
            mode = (cp.shape[1], u.shape[1], s_m, cp.stride(0))
            self.merges.append(mode)
            if mode not in self.inputs:
                self.inputs[mode] = tuple(
                    None if x is None else x.clone() for x in (cp, w, u, mp))
            return merge(cp, w, u, mp, *args, **kwargs)

        def probe(*args, **kwargs):
            self.probes += 1
            return self._probe(*args, **kwargs)

        ray_march_mlp._launch, sample_merge._launch = mlp_launch, merge_launch
        ray_march_quadrature._launch = quad_launch
        occ_mod.occupancy_along_rays = probe
        return self

    def __exit__(self, *exc):
        from keras_nerf_tpu_torch.ops import occupancy as occ_mod

        for k, plain, launch in self._saved:
            k.plain, k._launch = plain, launch
        occ_mod.occupancy_along_rays = self._probe
        return False


def _occupancy_phases(nerf, cfg, gen, chunk_rays, errors, rel_errors,
                      card_tag) -> dict:
    """The occupancy render at full width: ``inference --occupancy_grid 128
    --occupancy_samples 64``, 64 probe bins, ``ray_chunks`` 4096, on the
    fog weights of the bf16 orbit (``nerf``).

    The bake (``NeRF.bake_occupancy``: 8 ``apply_mlp`` launches of 262,144
    voxels, one chunk held against its plain version) with its occupied
    share held in ``OCC_SHARE``; ``sample_merge`` against its plain version
    at 4096 rays over the grid's probe bins, without merge (``TOL``) and
    with the 64 stratified depths as partner (``TRAIN_TOL``); the full MLP
    in bf16 and int8 and the quadrature at the same chunk against their
    plain versions (``TOL``); 4 orbit frames
    through ``render_orbit(occupancy_samples=64)`` in bf16 and then int8,
    with their launch counts, modes and plain calls; a 16^2 occupancy frame
    against the CPU's on the card's grid (``E2E_TOL``). Returns the inputs
    of the timing and profile phases."""
    import numpy as np
    import torch

    from keras_nerf_tpu_torch.data import (
        generate_ray_batch,
        get_focal_from_fov,
        pose_spherical,
    )
    from keras_nerf_tpu_torch.inference import ORBIT, render_orbit
    from keras_nerf_tpu_torch.kernels import KERNELS, reset_launch_counts
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models import NeRF
    from keras_nerf_tpu_torch.ops import occupancy as occ_mod
    from keras_nerf_tpu_torch.ops import sorted_uniforms

    dev = torch.device("cuda")

    def compiled(quantized):
        m = NeRF(config=cfg)
        m.compile(batch_size=1, image_height=IMG, image_width=IMG,
                  ray_chunks=CHUNK, white_background=True, device="cuda",
                  seed=0, quantized_render=quantized)
        m.state = nerf.state
        return m

    onerf = compiled(False)
    packed = trm.pack_mlp_params(onerf.fine_params, cfg.mlp, cfg.pos_emb_xyz,
                                 cfg.pos_emb_dir)
    coords = occ_mod.grid_coordinates(OCC_GRID, device=dev).reshape(-1, 3)
    density = occ_mod.model_density_fn(onerf.fine_params, onerf.config)
    threshold = float(torch.quantile(density(coords[::64]), OCC_QUANTILE))
    # One bake chunk, kernel against plain version.
    chunk = coords[:occ_mod.DENSITY_CHUNK]
    enc = trm.encode_block128(chunk, torch.tensor(
        [0.0, 0.0, -1.0], device=dev).expand(chunk.shape), cfg.pos_emb_xyz,
        cfg.pos_emb_dir)
    held = _held("apply_mlp", [(trm.apply_mlp(packed, enc)[:, 3],
                                trm.apply_mlp.plain(packed, enc)[:, 3])],
                 f"apply_mlp, the bake's sigma [{occ_mod.DENSITY_CHUNK}]")
    name, err, rel, rel_norm, ok, label = held
    errors[name] = max(errors.get(name, 0.0), err)
    old = rel_errors.get(name, (0.0, 0.0))
    rel_errors[name] = (max(old[0], rel), max(old[1], rel_norm))
    log(f"check {label}: max_abs_err {err:.3e}, relative max {rel:.3e}, "
        f"relative norm {rel_norm:.3e} (tolerance {TRAIN_TOL[name]}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label} disagrees with its plain version")

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    grid = onerf.bake_occupancy(OCC_GRID, sigma_threshold=threshold)
    torch.cuda.synchronize()
    bake_wall = time.perf_counter() - t0
    bake_launches = {k.name: k.launches for k in KERNELS}
    share = float(grid.mean())
    expected = {k.name: 0 for k in KERNELS}
    expected["apply_mlp"] = OCC_GRID ** 3 // occ_mod.DENSITY_CHUNK
    log(f"occupancy bake {OCC_GRID}^3 at sigma_threshold {threshold:.4f} "
        f"(the {OCC_QUANTILE} quantile), dilate 1: occupied share "
        f"{share:.4f} (must lie in {OCC_SHARE}), {1e3 * bake_wall:.1f} ms "
        f"wall {card_tag}; launches {bake_launches}")
    if bake_launches != expected:
        fail(f"bake launch counts {bake_launches} != expected {expected}")
    if not OCC_SHARE[0] <= share <= OCC_SHARE[1]:
        fail(f"occupied share {share} outside {OCC_SHARE}: the probe bins' "
             f"CDF would be uniform")

    # B9 on the card: both new modes at one chunk over the grid.
    o, d, tc = chunk_rays
    # The probe-bin centres: one row for every ray (stride 0), as the
    # path hands them to the kernel.
    mids, occ = occ_mod.occupancy_along_rays(o, d, grid, ORBIT["near"],
                                             ORBIT["far"], OCC_PROBE)
    u = sorted_uniforms(gen, (CHUNK,), OCC_SAMPLES)
    log(f"occupancy chunk: rays with an occupied bin "
        f"{int((occ.sum(1) > 0).sum())}/{CHUNK}, the bins' row stride "
        f"{mids.stride(0)}")
    for label, mp, tol in (
            (f"no merge [{CHUNK}, {OCC_PROBE} bins -> {OCC_SAMPLES}]", None,
             TOL["sample_merge"]),
            (f"partner [{CHUNK}, {OCC_PROBE} bins, {N_COARSE} + "
             f"{OCC_SAMPLES}]", tc, TRAIN_TOL["sample_merge"]["abs"])):
        _merge_held(label, mids, occ, u, mp, tol, errors)
        if not torch.equal(trm.sample_merge(mids, occ, u, mp),
                           trm.sample_merge(mids.contiguous(), occ, u, mp)):
            fail(f"sample_merge {label}: the bins as one row and copied "
                 f"to every ray differ")

    # The path: 4 orbit frames, bf16 then int8.
    chunks = len(FRAMES) * IMG * IMG // CHUNK
    orbit = dict(img_wh=IMG, occupancy_samples=OCC_SAMPLES, **ORBIT)
    qnerf = compiled(True)
    qnerf.bake_occupancy(OCC_GRID, sigma_threshold=threshold)
    render_orbit(onerf, FRAMES[:1], **orbit)      # warm-up
    render_orbit(qnerf, FRAMES[:1], **orbit)      # warm-up, calibration
    chunk_in = _occupancy_chunk_checks(packed, qnerf._packed_q[1], cfg, o, d,
                                       mids, occ, u, errors)
    runs = {}
    for label, m, mlp in (("bf16", onerf, "ray_march_mlp"),
                          ("int8", qnerf, "ray_march_mlp_int8")):
        torch.cuda.synchronize()
        reset_launch_counts()
        with _CallLog() as calls:
            t0 = time.perf_counter()
            images, depths = render_orbit(m, FRAMES, **orbit)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in KERNELS}
        expected = {k.name: 0 for k in KERNELS}
        expected.update(sample_merge=chunks, ray_march_quadrature=chunks)
        expected[mlp] = chunks
        sigma_only = sum(calls.mlp_modes)
        log(f"occupancy main path ({label}): {len(FRAMES)} frames {IMG}^2 "
            f"in {wall:.3f} s ({1e3 * wall / len(FRAMES):.1f} ms/frame wall, "
            f"host clock) {card_tag}; launches {launches}; sigma-only MLP "
            f"launches {sigma_only}; plain calls {calls.plain_calls}")
        if launches != expected:
            fail(f"occupancy orbit ({label}): launch counts {launches} != "
                 f"expected {expected}")
        if sigma_only or calls.plain_calls:
            fail(f"occupancy orbit ({label}): {sigma_only} sigma-only MLP "
                 f"launches, {calls.plain_calls} plain calls")
        if images.shape != (len(FRAMES), IMG, IMG, 3) or not (
                np.isfinite(images).all() and images.min() >= 0.0
                and images.max() <= 1.0 and np.isfinite(depths).all()):
            fail(f"occupancy frames ({label}) malformed, not finite or "
                 f"outside [0, 1]")
        log(f"occupancy frames ({label}): image mean {images.mean():.4f} std "
            f"{images.std():.4f}, depth mean {depths.mean():.4f}")
        runs[label] = (launches, 1e3 * wall / len(FRAMES))

    # End to end: a 16^2 frame on the card and on the CPU, the card's grid
    # passed to both (two bakes may flip voxels at the threshold).
    rays = generate_ray_batch(
        pose_spherical(30.0, ORBIT["phi"], ORBIT["z_translate"])[None], gen,
        image_height=E2E_IMG, image_width=E2E_IMG,
        focal=get_focal_from_fov(ORBIT["fov"], E2E_IMG), near=ORBIT["near"],
        far=ORBIT["far"], n_samples=N_COARSE)
    n_chunks = E2E_IMG * E2E_IMG // E2E_CHUNK
    draws = [sorted_uniforms(gen, (E2E_CHUNK,), OCC_SAMPLES)
             for _ in range(n_chunks)]
    kw = dict(near=ORBIT["near"], far=ORBIT["far"], n_samples=OCC_SAMPLES,
              n_probe=OCC_PROBE, ray_chunks=E2E_CHUNK)
    cpu = torch.device("cpu")
    card = occ_mod.render_image_batch_occ(onerf.fine_params, rays, grid,
                                          draws, cfg, **kw)
    host = occ_mod.render_image_batch_occ(
        _to(onerf.fine_params, cpu), tuple(x.to(cpu) for x in rays),
        grid.to(cpu), [x.to(cpu) for x in draws], cfg, **kw)
    diff = {k: (card[k].cpu() - host[k]).abs() for k in ("image", "depth")}
    err = {k: float(v.max()) for k, v in diff.items()}
    log(f"occupancy end to end {E2E_IMG}^2, card kernels vs CPU plain "
        f"versions (the card's grid): " + ", ".join(
            f"{k} max_abs_err {err[k]:.3e} mean {float(v.mean()):.3e} "
            f"(tolerance {E2E_TOL[k]:.0e})" for k, v in diff.items()))
    if any(err[k] > E2E_TOL[k] for k in err):
        fail("the card's occupancy render disagrees with the plain versions")

    return {"nerf": onerf, "packed": packed, "grid": grid, "mids": mids,
            "occ": occ, "u": u, "tc": tc, "enc": enc, **chunk_in,
            "density": density, "threshold": threshold,
            "bake_launches": bake_launches, "launches": runs["bf16"][0],
            "q_launches": runs["int8"][0]}


def _occupancy_chunk_checks(packed, packed_q, cfg, o, d, mids, occ, u,
                            errors) -> dict:
    """The occupancy render's other kernels against their plain versions at
    its chunk, [4096 x 64], on the plain no-merge depths over the grid:
    ``ray_march_mlp`` and ``ray_march_mlp_int8`` (the fine int8 weights) in
    full mode, and ``ray_march_quadrature`` without weights on the plain
    bf16 MLP's output (``TOL``). Returns the timing phase's inputs."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm

    base, slope, masks = trm.ray_encoding_coeffs(o, d, cfg.pos_emb_xyz,
                                                 cfg.pos_emb_dir)
    t = trm.sample_merge.plain(mids, occ, u, None)
    rgbs = trm.ray_march_mlp.plain(packed, base, slope, t, masks)
    quad_in = rgbs.reshape(CHUNK, OCC_SAMPLES, 4)
    shape = f"[{CHUNK} x {OCC_SAMPLES}]"
    held = (
        ("ray_march_mlp", f"full {shape}",
         [trm.ray_march_mlp(packed, base, slope, t, masks)], [rgbs]),
        ("ray_march_mlp_int8", f"full (fine) {shape}",
         [trm.ray_march_mlp_int8(packed_q, base, slope, t, masks)],
         [trm.ray_march_mlp_int8.plain(packed_q, base, slope, t, masks)]),
        ("ray_march_quadrature", f"full, no weights {shape}",
         trm.ray_march_quadrature(quad_in, t, True, False, False),
         trm.ray_march_quadrature.plain(quad_in, t, True, False, False)))
    _held_at_tol(held, "occupancy", errors)
    return {"base": base, "slope": slope, "masks": masks, "t": t,
            "rgbs": quad_in}


def _occupancy_modes(oi: dict, cfg) -> list:
    """The occupancy render's timing modes at its 4096-ray chunks, each
    launched 4 times per frame: ``sample_merge`` without merge, the full MLP
    and the quadrature without weights over 64 samples; the bake's
    ``apply_mlp`` (8 launches per bake); ``sample_merge``'s partner mode
    once (on no path yet). Bounds as for the render modes."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models.engine import tree_leaves

    per_frame = IMG * IMG // CHUNK
    s = OCC_SAMPLES
    packed = oi["packed"]
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       tree_leaves(packed))
    base, slope, masks, t, rgbs = (oi[k] for k in
                                   ("base", "slope", "masks", "t", "rgbs"))
    pts = CHUNK * s
    bake_pts = oi["enc"].shape[0]
    fwd = trm.fwd_flop_per_point(cfg.mlp)
    return [
        (trm.sample_merge, "occupancy",
         f"no merge [{CHUNK}, {OCC_PROBE} bins -> {s}]",
         lambda f: f(oi["mids"], oi["occ"], oi["u"], None), per_frame,
         _merge_bound(CHUNK, OCC_PROBE, s, 0)),
        (trm.ray_march_mlp, "occupancy", f"full [{CHUNK} x {s}]",
         lambda f: f(packed, base, slope, t, masks), per_frame,
         _bound(2 * CHUNK * 128 * F32B + weight_bytes + pts * F32B * 5,
                pts * fwd, PEAK_BF16_FLOPS)),
        (trm.ray_march_quadrature, "occupancy",
         f"full, no weights [{CHUNK} x {s}]",
         lambda f: f(rgbs, t, True, False, False), per_frame,
         _bound(CHUNK * (5 * s + 4) * F32B, CHUNK * s * 16, PEAK_F32_FLOPS)),
        (trm.apply_mlp, "bake", f"the bake's chunk [{bake_pts}]",
         lambda f: f(packed, oi["enc"]), OCC_GRID ** 3 // bake_pts,
         _bound(weight_bytes + bake_pts * (2 * 128 + 4 * F32B),
                bake_pts * fwd, PEAK_BF16_FLOPS)),
        (trm.sample_merge, "merge_partner",
         f"partner [{CHUNK}, {OCC_PROBE} bins, {N_COARSE} + {s}]",
         lambda f: f(oi["mids"], oi["occ"], oi["u"], oi["tc"]), 1,
         _merge_bound(CHUNK, OCC_PROBE, s, N_COARSE)),
    ]


def _occ_train_modes(oti: dict) -> list:
    """The occupancy-train path's ``sample_merge`` modes on the inputs of
    their first launch there, 8 launches each per 128^2 step: the partner
    mode (merged) and the no-merge mode (``--occupancy_train_no_merge``)."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm

    per_step = IMG * IMG // TRAIN_CHUNK
    partner = oti["inputs"][OCC_STEP["merge"]["merge"]]
    alone = oti["inputs"][OCC_STEP["no_merge"]["merge"]]
    return [
        (trm.sample_merge, "occ_train",
         f"partner [{TRAIN_CHUNK}, {OCC_PROBE} bins, {N_COARSE} + "
         f"{OCC_SAMPLES}]", lambda f: f(*partner), per_step,
         _merge_bound(TRAIN_CHUNK, OCC_PROBE, OCC_SAMPLES, N_COARSE)),
        (trm.sample_merge, "occ_train_no_merge",
         f"no merge [{TRAIN_CHUNK}, {OCC_PROBE} bins -> {OCC_SAMPLES}]",
         lambda f: f(*alone), per_step,
         _merge_bound(TRAIN_CHUNK, OCC_PROBE, OCC_SAMPLES, 0)),
    ]


def _bake_times(oi: dict, cfg, card_tag):
    """The whole bake (``bake_occupancy_grid``: coordinates, the encoding,
    8 ``apply_mlp`` launches, threshold, dilation) by CUDA events, beside
    its bound: 2,097,152 voxels x the unpadded forward to sigma alone (the
    bake keeps no colour) at 989 TFLOP/s."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.ops import occupancy as occ_mod

    def bake():
        return occ_mod.bake_occupancy_grid(
            oi["density"], OCC_GRID, sigma_threshold=oi["threshold"],
            device="cuda")

    kms = _time_ms(bake, 3)
    bound = 1e3 * OCC_GRID ** 3 * trm.fwd_flop_per_point(
        cfg.mlp, sigma_only=True) / PEAK_BF16_FLOPS
    log(f"time occupancy bake {OCC_GRID}^3 (bake_occupancy_grid, CUDA "
        f"events): {kms:.3f} ms, bound {bound:.3f} ms (operations), "
        f"{kms / bound:.1f}x {card_tag}")
    log(json.dumps({"occupancy_bake": {"grid": OCC_GRID, "ms": kms,
                                       "bound_ms": bound,
                                       "bound_by": "operations",
                                       "card": card_tag.strip("[]")}}))


# ---------------------------------------------------------------------------
# The fast render tier and the quality tools.


def _held_at_tol(held, where: str, errors: dict) -> None:
    """Each ``(kernel, label, outputs, plain outputs)`` of ``held`` within
    ``TOL[kernel]`` and finite (None outputs skipped); logs each, keeps each
    kernel's worst error and fails if any is not held."""
    import torch

    torch.cuda.synchronize()
    ok = True
    for name, label, got, want in held:
        pairs = [(g, w) for g, w in zip(got, want) if g is not None]
        err = max(float((g - w).abs().max()) for g, w in pairs)
        good = (all(bool(torch.isfinite(g).all()) for g, _ in pairs)
                and err <= TOL[name])
        errors[name] = max(errors.get(name, 0.0), err)
        ok = ok and good
        log(f"check {name} {where} {label}: max_abs_err {err:.3e} "
            f"(tolerance {TOL[name]:.0e}) {'ok' if good else 'FAIL'}")
    if not ok:
        fail(f"a {where} kernel disagrees with its plain version")


def _fast_render_phases(nerf, cfg, chunk: dict, params, fine_params,
                        packed_q, bf16_images, errors, card_tag) -> dict:
    """``inference --fast_render`` at full width, on the fog weights of the
    bf16 orbit (``nerf``): ``sample_merge``'s no-merge mode at [4096, 64 ->
    96] on the fog's coarse weights (``TOL``, identical bits twice), the
    full forward and the quadrature without weights at [4096 x 96] on its
    depths against their plain versions; 4 orbit frames through
    ``render_orbit`` in bf16 at 96 samples and in int8 at 64, each chunk
    one sigma-only MLP, one sigma-only quadrature, one ``sample_merge``
    without partner at K draws, one full MLP at [4096 x K] and one
    quadrature without weights, and no plain call; 16^2 frames of both
    against the CPU's (``E2E_TOL``). Returns the timing and profile
    phases' inputs."""
    import dataclasses

    import numpy as np
    import torch

    from keras_nerf_tpu_torch.data import (
        generate_ray_batch,
        get_focal_from_fov,
        pose_spherical,
    )
    from keras_nerf_tpu_torch.inference import ORBIT, render_orbit
    from keras_nerf_tpu_torch.kernels import KERNELS, reset_launch_counts
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models import NeRF
    from keras_nerf_tpu_torch.models.engine import render_image_batch
    from keras_nerf_tpu_torch.ops import sorted_uniforms

    dev = torch.device("cuda")
    # A generator of its own, so that every other draw is unchanged.
    fgen = torch.Generator(device=dev)
    fgen.manual_seed(18)
    tc, wc, packed = chunk["tc"], chunk["wc"], chunk["packed"]
    base, slope, masks = chunk["base"], chunk["slope"], chunk["masks"]
    inputs = {}
    for k in (FAST_RENDER, FAST_RENDER_INT8):
        u = sorted_uniforms(fgen, (CHUNK,), k)
        t = trm.sample_merge.plain(tc, wc, u, None)
        rgbs = trm.ray_march_mlp.plain(packed, base, slope, t, masks)
        inputs[k] = {"u": u, "t": t, "rgbs": rgbs.reshape(CHUNK, k, 4)}
    k = FAST_RENDER
    u, t, quad_in = (inputs[k][x] for x in ("u", "t", "rgbs"))
    _merge_held(f"fast render, no merge [{CHUNK}, {N_COARSE} -> {k}]", tc,
                wc, u, None, TOL["sample_merge"], errors)
    _held_at_tol((
        ("ray_march_mlp", f"full [{CHUNK} x {k}]",
         [trm.ray_march_mlp(packed, base, slope, t, masks)],
         [quad_in.reshape(-1, 4)]),
        ("ray_march_quadrature", f"full, no weights [{CHUNK} x {k}]",
         trm.ray_march_quadrature(quad_in, t, True, False, False),
         trm.ray_march_quadrature.plain(quad_in, t, True, False, False))),
        "fast render", errors)

    chunks = len(FRAMES) * IMG * IMG // CHUNK
    runs = {}
    for label, samples, quantized, mlp in (
            ("bf16", FAST_RENDER, False, "ray_march_mlp"),
            ("int8", FAST_RENDER_INT8, True, "ray_march_mlp_int8")):
        m = NeRF(config=cfg)
        m.compile(batch_size=1, image_height=IMG, image_width=IMG,
                  ray_chunks=CHUNK, white_background=True, device="cuda",
                  seed=0, fast_render=samples, quantized_render=quantized)
        m.state = nerf.state
        render_orbit(m, FRAMES[:1], img_wh=IMG, **ORBIT)   # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        with _CallLog() as calls:
            t0 = time.perf_counter()
            images, depths = render_orbit(m, FRAMES, img_wh=IMG, **ORBIT)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {kk.name: kk.launches for kk in KERNELS}
        expected = {kk.name: 0 for kk in KERNELS}
        expected.update(sample_merge=chunks, ray_march_quadrature=2 * chunks)
        expected[mlp] = 2 * chunks
        merges = sorted({m_[:3] for m_ in calls.merges})
        quads = {q: calls.quad_modes.count(q) for q in set(calls.quad_modes)}
        want_quads = {((CHUNK, N_COARSE), True, True): chunks,
                      ((CHUNK, samples), False, False): chunks}
        name = f"render_fast_{label}_{samples}"
        log(f"fast render main path ({label}, --fast_render {samples}): "
            f"{len(FRAMES)} frames {IMG}^2 in {wall:.3f} s "
            f"({1e3 * wall / len(FRAMES):.1f} ms/frame wall, host clock) "
            f"{card_tag}; launches {launches}; sample_merge modes (s_c, n, "
            f"s_m) {merges}; quadrature (shape, sigma-only, weights) "
            f"{quads}; MLP depths {sorted(set(calls.mlp_shapes))}, "
            f"sigma-only {sum(calls.mlp_modes)}; plain calls "
            f"{calls.plain_calls}")
        if launches != expected:
            fail(f"{name}: launch counts {launches} != expected {expected}")
        if merges != [(N_COARSE, samples, 0)] or quads != want_quads:
            fail(f"{name}: sample_merge modes {merges}, quadrature modes "
                 f"{quads}; expected [({N_COARSE}, {samples}, 0)] and "
                 f"{want_quads}")
        if not quantized and (
                sum(calls.mlp_modes) != chunks
                or set(calls.mlp_shapes) != {(CHUNK, N_COARSE),
                                             (CHUNK, samples)}):
            fail(f"{name}: MLP launches sigma-only {sum(calls.mlp_modes)}, "
                 f"depths {set(calls.mlp_shapes)}")
        if calls.plain_calls:
            fail(f"{name}: {calls.plain_calls} plain calls")
        if images.shape != (len(FRAMES), IMG, IMG, 3) or not (
                np.isfinite(images).all() and images.min() >= 0.0
                and images.max() <= 1.0 and np.isfinite(depths).all()):
            fail(f"{name}: frames malformed, not finite or outside [0, 1]")
        diff = np.abs(images - bf16_images)
        log(f"fast render frames ({label}, {samples}): image mean "
            f"{images.mean():.4f} std {images.std():.4f}, depth mean "
            f"{depths.mean():.4f}; against the exact bf16 frames of the same "
            f"poses: max abs {diff.max():.4f} mean {diff.mean():.3e}")
        runs[name] = (launches, m)

    # End to end: 16^2 frames of both tiers on the card and on the CPU.
    rays = generate_ray_batch(
        pose_spherical(30.0, ORBIT["phi"], ORBIT["z_translate"])[None], fgen,
        image_height=E2E_IMG, image_width=E2E_IMG,
        focal=get_focal_from_fov(ORBIT["fov"], E2E_IMG), near=ORBIT["near"],
        far=ORBIT["far"], n_samples=N_COARSE)
    cpu = torch.device("cpu")
    rays_cpu = tuple(x.to(cpu) for x in rays)
    for label, samples, pq in (("bf16", FAST_RENDER, None),
                               ("int8", FAST_RENDER_INT8, packed_q)):
        fcfg = dataclasses.replace(cfg, fast_render=samples)
        draws = [sorted_uniforms(fgen, (E2E_IMG * E2E_IMG,), samples)]
        _, card = render_image_batch(params, fine_params, rays, draws, fcfg,
                                     E2E_IMG * E2E_IMG, packed_q=pq)
        _, host = render_image_batch(
            _to(params, cpu), _to(fine_params, cpu), rays_cpu,
            [x.to(cpu) for x in draws], fcfg, E2E_IMG * E2E_IMG,
            packed_q=None if pq is None else tuple(_to(q, cpu) for q in pq))
        diff = {kk: (card[kk].cpu() - host[kk]).abs()
                for kk in ("image", "depth")}
        err = {kk: float(v.max()) for kk, v in diff.items()}
        log(f"fast render ({label}, {samples}) end to end {E2E_IMG}^2, card "
            f"kernels vs CPU plain versions: " + ", ".join(
                f"{kk} max_abs_err {err[kk]:.3e} mean {float(v.mean()):.3e} "
                f"(tolerance {E2E_TOL[kk]:.0e})" for kk, v in diff.items()))
        if any(err[kk] > E2E_TOL[kk] for kk in err):
            fail(f"the card's fast render ({label}) disagrees with the plain "
                 f"versions")
    return {"inputs": inputs, "chunk": chunk, "q": packed_q,
            "launches": {n: r[0] for n, r in runs.items()},
            "models": {n: r[1] for n, r in runs.items()}}


def _fast_render_modes(fi: dict, cfg) -> list:
    """The fast render's fine-pass modes at its 4096-ray chunks, 4 launches
    each per frame (the coarse pass's are the render's and the int8
    render's): at 96 draws ``sample_merge`` without partner, the full
    forward (beside its PyTorch chain) and the quadrature without weights;
    at 64 the same with the int8 forward. Bounds as for the render and
    int8 modes."""
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models.engine import tree_leaves
    from keras_nerf_tpu_torch.time_ray_march_mlp import pytorch_chain

    per_frame = IMG * IMG // CHUNK
    c = fi["chunk"]
    packed, tc, wc = c["packed"], c["tc"], c["wc"]
    base, slope, masks = c["base"], c["slope"], c["masks"]
    fwd = trm.fwd_flop_per_point(cfg.mlp)
    modes = []
    for k, path, mlp, weights, peak in (
            (FAST_RENDER, "fast_render", trm.ray_march_mlp, packed,
             PEAK_BF16_FLOPS),
            (FAST_RENDER_INT8, "fast_render_int8", trm.ray_march_mlp_int8,
             fi["q"][1], PEAK_INT8_OPS)):
        u, t, rgbs = (fi["inputs"][k][x] for x in ("u", "t", "rgbs"))
        pts = CHUNK * k
        weight_bytes = sum(x.numel() * x.element_size()
                           for x in tree_leaves(weights))
        chain = []
        if mlp is trm.ray_march_mlp:
            enc = trm.encode_points(base, slope, t, masks).reshape(-1, 128)
            chain = [None, None, pytorch_chain(packed, enc)]
        modes += [
            (trm.sample_merge, path, f"no merge [{CHUNK}, {N_COARSE} -> {k}]",
             lambda f, u=u: f(tc, wc, u, None), per_frame,
             _merge_bound(CHUNK, N_COARSE, k, 0)),
            (mlp, path, f"full [{CHUNK} x {k}]",
             lambda f, mlp_w=weights, t=t: f(mlp_w, base, slope, t, masks),
             per_frame,
             _bound(2 * CHUNK * 128 * F32B + weight_bytes + pts * F32B * 5,
                    pts * fwd, peak), *chain),
            (trm.ray_march_quadrature, path,
             f"full, no weights [{CHUNK} x {k}]",
             lambda f, rgbs=rgbs, t=t: f(rgbs, t, True, False, False),
             per_frame,
             _bound(CHUNK * (5 * k + 4) * F32B, CHUNK * k * 16,
                    PEAK_F32_FLOPS)),
        ]
    return modes


def _quality_tools_phase(card_tag) -> None:
    """The quality tools' entry points on the card: a 16^2 spheres scene
    written by the port's writer under ``build/``, 2 epochs of the training
    CLI, then ``eval_checkpoint`` on its test split and ``render_frontier
    --bench_wh 16 --iters 2`` (its ten tiers), both in this process. Holds
    the six metrics finite, and every tier's PSNR finite and its time
    taken. Removes the directory after."""
    import math
    import shutil

    from keras_nerf_tpu_torch import eval_checkpoint, render_frontier
    from keras_nerf_tpu_torch import train_single
    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

    root = os.path.join(HERE, "build", "chip_smoke_tools")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data = write_synthetic_scene(os.path.join(root, "scene"),
                                 image_wh=TOOLS_IMG, n_train=4, n_val=2,
                                 n_test=2)
    args = train_single.build_arg_parser().parse_args([
        "--name", "tools", "--data_dir", data, "--img_wh", str(TOOLS_IMG),
        "--white_bg", "--num_epochs", "2", "--ray_chunks", "256",
        "--log_dir", os.path.join(root, "logs"),
        "--model_dirs", os.path.join(root, "model")])
    nerf = train_single.run_training(args)
    model = os.path.join(root, "model", "tools")
    record = eval_checkpoint.evaluate_checkpoint(
        eval_checkpoint.build_arg_parser().parse_args([
            "--model_path", model, "--data_dir", data, "--img_wh",
            str(TOOLS_IMG), "--white_bg", "--ray_chunks", "256"]))
    log(f"eval_checkpoint on the card: {json.dumps(record)}")
    metrics = [v for k, v in record.items() if k not in ("model_path",
                                                         "split")]
    if len(metrics) != 6 or not all(math.isfinite(v) for v in metrics):
        fail(f"eval_checkpoint: {record}")
    frontier = render_frontier.main([
        "--model", model, "--data", data, "--img_wh", str(TOOLS_IMG),
        "--bench_wh", str(TOOLS_IMG), "--iters", "2",
        "--out_json", os.path.join(root, "frontier.json"),
        "--out_png", os.path.join(root, "frontier.png")])
    rows = frontier["rows"]
    if len(rows) != 10 or not all(
            math.isfinite(r["psnr_db"]) and r["fps"] is not None
            and r["fps"] > 0 for r in rows):
        fail(f"render_frontier: {rows}")
    wall = time.perf_counter() - t0
    log(f"quality tools on the card ({TOOLS_IMG}^2 scene, 2 epochs, "
        f"eval_checkpoint, render_frontier's 10 tiers): {wall:.1f} s wall "
        f"{card_tag}; trained {nerf.state.step} steps")
    shutil.rmtree(root, ignore_errors=True)


A15_LR_STEPS = 10   # lr_probe's steps an epoch, on a 10-view scene


def _a15_tools_phases(card_tag, ablation_builds) -> dict:
    """The last ported tools on the card, each driven with the launch
    counts set to 0 just before and read just after, each failing unless
    every T3 kernel launched: (a) ``real_scene_drill`` on its 800^2 scene
    (12 train views resized to 128^2 by ``antialias-bilinear``), 1 epoch,
    its checks; (b) ``lr_probe`` with 2 arms x 1 epoch x 10 steps on a
    10-view 128^2 spheres scene, its ranking finite; (c) ``profile_step
    --chunks 2048``: the per-component ms and the five longest host gaps,
    every component timed; then :func:`_a15_profiler_phases`, which waits
    for ``ablation_builds``. Writes under ``build/`` and removes it after.
    Returns each phase's launches."""
    import math
    import shutil

    import torch

    from keras_nerf_tpu_torch import lr_probe, profile_step, real_scene_drill
    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene
    from keras_nerf_tpu_torch.kernels import reset_launch_counts

    root = os.path.join(HERE, "build", "chip_smoke_a15")
    shutil.rmtree(root, ignore_errors=True)
    launches = {}

    t0 = time.perf_counter()
    reset_launch_counts()
    try:
        drill = real_scene_drill.main(["--epochs", "1", "--out",
                                       os.path.join(root, "drill")])
    except real_scene_drill.DrillFailed as e:
        fail(f"real_scene_drill: {e}")
    launches["real_scene_drill"] = _counts()
    _ran(launches["real_scene_drill"], MSE_LAUNCHES, "real_scene_drill")
    log(f"real_scene_drill (800^2 source -> 128^2, 1 epoch): checks "
        f"{json.dumps(drill['checks'])}, skipped {drill['skipped']}; "
        f"{time.perf_counter() - t0:.1f} s wall {card_tag}; launches "
        f"{launches['real_scene_drill']}")

    t0 = time.perf_counter()
    data = write_synthetic_scene(os.path.join(root, "scene"), image_wh=IMG,
                                 n_train=A15_LR_STEPS, n_val=2, n_test=1)
    reset_launch_counts()
    ranked = lr_probe.main([
        "--data_dir", data, "--img_wh", str(IMG), "--white_bg", "--epochs",
        "1", "--steps_per_epoch", str(A15_LR_STEPS), "--recipes", "1e-3:0",
        "5e-4:5e-6"])
    launches["lr_probe"] = _counts()
    _ran(launches["lr_probe"], MSE_LAUNCHES, "lr_probe")
    if len(ranked) != 2 or not all(math.isfinite(v) for row in ranked
                                   for v in row[1]):
        fail(f"lr_probe: {ranked}")
    log(f"lr_probe (2 arms x 1 epoch x {A15_LR_STEPS} steps, {IMG}^2): "
        + ", ".join(f"[{label}] val {curve[-1]:.4f} dB in {sec:.1f} s"
                    for label, curve, sec, _ in ranked)
        + f"; {time.perf_counter() - t0:.1f} s wall {card_tag}; launches "
        f"{launches['lr_probe']}")

    t0 = time.perf_counter()
    reset_launch_counts()
    prof = profile_step.main(["--chunks", str(TRAIN_CHUNK)])
    launches["profile_step"] = _counts()
    _ran(launches["profile_step"], MSE_LAUNCHES, "profile_step")
    comps = prof["components_ms"]
    gaps = prof["host_timeline"]["longest_gaps"]
    if (not all(math.isfinite(v) for v in comps.values())
            or not all(comps[c] > 0 for c in profile_step.COMPONENTS)
            or len(gaps) != 5):
        fail(f"profile_step: {comps}, gaps {gaps}")
    log(f"profile_step --chunks {TRAIN_CHUNK}: train_step "
        f"{prof['train_step_ms'][str(TRAIN_CHUNK)]:.3f} ms, components "
        + ", ".join(f"{k} {v:.3f}" for k, v in comps.items())
        + f" ms/step; {prof['host_timeline']['launches']} launches a step "
        f"by range {json.dumps(prof['host_timeline']['launches_by_range'])},"
        f" host blocked on a full launch queue "
        f"{prof['host_timeline']['queue_full_ms']:.3f} ms; five longest host "
        f"gaps " + "; ".join(f"{g['gap_ms']:.3f} ms after {g['after']} "
                             f"before {g['before']}" for g in gaps)
        + f"; {time.perf_counter() - t0:.1f} s wall {card_tag}; launches "
        f"{launches['profile_step']}")
    launches.update(_a15_profiler_phases(root, card_tag, ablation_builds))
    shutil.rmtree(root, ignore_errors=True)
    # The runs' models are gone: return their cached blocks.
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# The tools' small sizes on the card: each launches the kernels it times.
A15_PROFILERS = (
    # (module, argv, kernels that must launch in it)
    ("profile_render", ["--img_wh", "128", "--chunks", "4096", "--iters",
                        "2"], ("sample_merge", "ray_march_mlp",
                               "ray_march_quadrature")),
    ("profile_render", ["--components", "--img_wh", "128", "--chunk", "2048",
                        "--iters", "2"], tuple(MSE_LAUNCHES)),
    ("profile_occtrain", ["--img_wh", "64", "--chunks", "2048", "--iters",
                          "2"], tuple(MSE_LAUNCHES)),
    ("profile_probe", ["--iters", "5"], ()),
    ("profile_shard_step", ["--n", "1", "4", "--iters", "2", "--ray_chunks",
                            "2048"], tuple(MSE_LAUNCHES)),
    ("profile_pallas", ["--iters", "2", "--chunks", "2048", "4096"],
     (*MSE_LAUNCHES, *CUSTOM_LAUNCHES)),
    ("profile_pallas", ["--components", "--iters", "2", "--launch_points",
                        "196608", "393216"], tuple(CUSTOM_LAUNCHES)),
    # Every ablation library built; the build without a macro held bit for
    # bit against the package's kernel inside the tool.
    ("profile_ablate", ["--iters", "8"],
     ("ray_march_mlp", "ray_march_quadrature", "mlp_backward",
      "mlp_weight_grad", "ray_march_mlp_int8")),
)


def _a15_profiler_phases(root: str, card_tag, ablation_builds) -> dict:
    """The profilers and the quality and log tools ported last, each driven
    through its ``main`` with the launch counts set to 0 just before and
    read just after, failing unless each kernel it times launched: the
    runs of :data:`A15_PROFILERS` (``profile_ablate``'s ms of each
    ablation printed beside the build without a macro), then ``aabb_demo``
    on a scale-2 16^2 scene and ``quantize_sim_ptq`` in its three modes on
    a 16^2 scene, each trained 2 epochs, and the log tools on the repo's
    r5best run log. ``ablation_builds``: the future of
    ``profile_ablate.build_all``, started after the package's build.
    Returns each run's launches."""
    import importlib
    import math

    from keras_nerf_tpu_torch import train_single
    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene
    from keras_nerf_tpu_torch.kernels import reset_launch_counts

    t0 = time.perf_counter()
    try:
        ablation_builds.result()
    except RuntimeError as e:
        fail(f"profile_ablate's builds: {e}")
    log(f"profile_ablate's 10 libraries built (waited "
        f"{time.perf_counter() - t0:.1f} s here)")
    launches = {}
    for name, argv, kernels in A15_PROFILERS:
        tool = importlib.import_module(f"keras_nerf_tpu_torch.{name}")
        t0 = time.perf_counter()
        reset_launch_counts()
        out = tool.main(argv)
        label = f"{name} {' '.join(argv)}"
        launches[label] = _counts()
        _ran(launches[label], kernels, label)
        if name == "profile_ablate":
            rows = out["readings"]
            if any(r["ms"] is None for row in rows.values()
                   for r in row.values()) or not out["bit_for_bit"]:
                fail(f"profile_ablate: a build was not timed or not held "
                     f"against the package's kernel: {json.dumps(out)}")
            for key, row in rows.items():
                log(f"profile_ablate {key}: " + ", ".join(
                    f"{abl} {r['ms']:.4f} ms" for abl, r in row.items())
                    + f" {card_tag}")
            log(f"profile_ablate: the build without a macro equals the "
                f"package's kernel bit for bit "
                f"{json.dumps(out['bit_for_bit'])}")
        log(f"{label}: {time.perf_counter() - t0:.1f} s wall {card_tag}; "
            f"launches {launches[label]}")
        gc.collect()

    t0 = time.perf_counter()
    tools = {}
    for scene, kw, near_far in (("scaled2", dict(scale=2.0), ("4", "12")),
                                ("spheres", {}, ("2", "6"))):
        data = write_synthetic_scene(os.path.join(root, scene),
                                     image_wh=TOOLS_IMG, n_train=4, n_val=2,
                                     n_test=2, **kw)
        train_single.run_training(train_single.build_arg_parser().parse_args([
            "--name", scene, "--data_dir", data, "--img_wh", str(TOOLS_IMG),
            "--white_bg", "--num_epochs", "2", "--ray_chunks", "256",
            "--near", near_far[0], "--far", near_far[1],
            "--log_dir", os.path.join(root, "logs"),
            "--model_dirs", os.path.join(root, "model")]))
        tools[scene] = (os.path.join(root, "model", scene), data)
    from keras_nerf_tpu_torch import aabb_demo, quantize_sim_ptq

    model, data = tools["scaled2"]
    reset_launch_counts()
    demo = aabb_demo.main(["--model_path", model, "--data_dir", data,
                           "--img_wh", str(TOOLS_IMG), "--white_bg",
                           "--ray_chunks", "256", "--occ_grid", "16",
                           "--aabb", "-4", "-4", "-4", "4", "4", "4"])
    launches["aabb_demo"] = _counts()
    _ran(launches["aabb_demo"], ("sample_merge", "ray_march_mlp",
                                 "ray_march_quadrature", "apply_mlp"),
         "aabb_demo")
    if not all(math.isfinite(demo[k]) for k in (
            "exact_psnr", "occ_default_aabb_psnr", "occ_correct_aabb_psnr")):
        fail(f"aabb_demo: {demo}")
    log(f"aabb_demo ({TOOLS_IMG}^2 scale-2 scene, 2 epochs): "
        f"{json.dumps(demo)}")
    model, data = tools["spheres"]
    for mode in ("smooth", "tensor", "feature"):
        sim = quantize_sim_ptq.main([
            "--model", model, "--data", data, "--img_wh", str(TOOLS_IMG),
            "--ray_chunks", "256", "--calib_points", "1024", "--mode", mode])
        if not all(math.isfinite(v) for k, v in sim.items()
                   if k.startswith(("psnr", "delta"))):
            fail(f"quantize_sim_ptq {mode}: {sim}")
        log(f"quantize_sim_ptq --mode {mode} ({TOOLS_IMG}^2, 2 epochs): "
            f"f32 {sim['psnr_f32']:.4f} dB, int8 c+f "
            f"{sim['delta_coarse_fine']:+.4f}, fine only "
            f"{sim['delta_fine']:+.4f}")

    from keras_nerf_tpu_torch import (extract_milestones, plot_compare,
                                      plot_quality)
    run_log = os.path.join(HERE, "assets", "quality128_r5best_torch_run.log")
    csv = os.path.join(HERE, "assets", "quality128_r5best_torch_log.csv")
    ms = extract_milestones.main([run_log])
    pq = plot_quality.main([csv, "--run_log", run_log, "--out_png",
                            os.path.join(root, "q.png")])
    pc = plot_compare.main([os.path.join(root, "c.png"), f"r5best={run_log}"])
    if (ms["epochs"] != 100 or [r["epoch"] for r in pq["rows"]] != [3, 6, 9]
            or pc["milestones"]["r5best"] != pq["rows"]):
        fail(f"log tools: {ms}, {pq['rows']}, {pc['milestones']}")
    log(f"quality and log tools (aabb_demo, quantize_sim_ptq x 3, "
        f"extract_milestones, plot_quality, plot_compare): "
        f"{time.perf_counter() - t0:.1f} s wall {card_tag}")
    return launches


# ---------------------------------------------------------------------------
# The occupancy-train tier and pixel sampling.


class _EpochLog(_StepLog):
    """:class:`_StepLog` that also keeps, at each epoch's end (the card
    synchronized), the host clock, the grid and cache objects and the
    grid's occupied share."""

    def __init__(self, nerf):
        super().__init__()
        self.nerf, self.epochs = nerf, []

    def on_epoch_end(self, epoch, logs):
        import torch

        torch.cuda.synchronize()
        grid = self.nerf._occ_train_grid
        self.epochs.append(dict(
            epoch=epoch, t=time.perf_counter(), grid=grid,
            cache=self.nerf._occ_probe_cache, steps=len(self.logs),
            share=None if grid is None else float(grid.mean())))


def _occ_train_warm(nerf, dataset, **tier):
    """:func:`_occ_train_compile` with warm-up 0 and an update period past
    any run, then one epoch of ``fit`` (its bake, and the cache's build):
    every later epoch steps without a bake."""
    _occ_train_compile(nerf, occupancy_train_warmup=0,
                       occupancy_train_update=1000, **tier)
    nerf.fit(dataset, epochs=1, verbose=False)


def _occ_train_compile(nerf, **tier):
    """``nerf.compile`` as :func:`_compile_train`, plus the training CLI's
    occupancy flags ``--occupancy_train 128 --occupancy_train_samples 64
    --occupancy_train_probe 64`` (defaults otherwise) and ``tier``'s."""
    from keras_nerf_tpu_torch.inference import ORBIT

    return nerf.compile(
        optimizer="adam", loss="mse", batch_size=1, image_height=IMG,
        image_width=IMG, ray_chunks=TRAIN_CHUNK, white_background=True,
        learning_rate=1e-3, device="cuda", seed=0, near=ORBIT["near"],
        far=ORBIT["far"], occupancy_train=OCC_GRID,
        occupancy_train_samples=OCC_SAMPLES,
        occupancy_train_probe=OCC_PROBE, **tier)


def _occ_train_run(nerf, dataset, label, epochs, initial_epoch, kinds,
                   bake_epochs, card_tag) -> dict:
    """One ``NeRF.fit`` of the compiled ``nerf``, the launch counts set to
    0 just before and read just after. ``kinds`` names each epoch's steps
    (``exact``, ``merge``, ``no_merge``; ``cached`` when the steps gather
    cached rows), ``bake_epochs`` the epochs that bake. Fails unless every
    step's kernels ran as its kind says (:data:`OCC_STEP`: launches per
    chunk, ``sample_merge``'s mode, the MLP's depths), each bake's 8
    ``apply_mlp`` launches and occupied share in ``OCC_SHARE``, no plain
    call, the probe gather only where the steps probe (and per cache
    build), and finite metrics with nonzero gradient norms. Returns the
    launches, the bakes' and steps' wall times and the run's log."""
    import math
    from collections import Counter

    import torch

    from keras_nerf_tpu_torch.kernels import KERNELS, reset_launch_counts
    from keras_nerf_tpu_torch.ops import occupancy as occ_mod

    per_epoch = len(dataset)
    chunks = IMG * IMG // TRAIN_CHUNK
    bakes = []
    bake = nerf._maybe_update_occupancy_train

    def timed_bake(epoch, ds):     # the bake and any cache build, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bake(epoch, ds)
        torch.cuda.synchronize()
        bakes.append((epoch, time.perf_counter() - t0))

    nerf._maybe_update_occupancy_train = timed_bake
    elog = _EpochLog(nerf)
    torch.cuda.synchronize()
    reset_launch_counts()
    try:
        with _CallLog() as calls:
            t0 = time.perf_counter()
            nerf.fit(dataset, epochs=epochs, initial_epoch=initial_epoch,
                     callbacks=[elog], verbose=False)
            torch.cuda.synchronize()
    finally:
        del nerf._maybe_update_occupancy_train
    launches = {k.name: k.launches for k in KERNELS}
    bake_s = dict(bakes)
    baked = [e["epoch"] for prev, e in zip([None] + elog.epochs, elog.epochs)
             if e["grid"] is not None
             and (prev is None or e["grid"] is not prev["grid"])]
    builds = sum(1 for prev, e in zip([None] + elog.epochs, elog.epochs)
                 if e["cache"] is not None
                 and (prev is None or e["cache"] is not prev["cache"]))
    expected = {k.name: 0 for k in KERNELS}
    modes, shapes, probes = Counter(), Counter(), 0
    for kind in kinds:
        step = OCC_STEP[kind.replace("cached ", "")]
        for name, n in MSE_LAUNCHES.items():
            expected[name] += per_epoch * chunks * n
        modes[step["merge"]] += per_epoch * chunks
        for shape in step["mlp"]:
            shapes[shape] += per_epoch * chunks
        if kind in ("merge", "no_merge"):
            probes += per_epoch * chunks
    expected["apply_mlp"] = len(bake_epochs) * OCC_GRID ** 3 \
        // occ_mod.DENSITY_CHUNK
    pixels = IMG * IMG
    per_build = -(-dataset.num_examples // max(
        1, occ_mod.PROBE_ROWS_POINTS // (pixels * OCC_PROBE)))
    probes += builds * per_build
    shares = [e["share"] for e in elog.epochs if e["epoch"] in baked]
    # Step walls: each epoch's, less its bake (and cache build).
    starts = [t0] + [e["t"] for e in elog.epochs[:-1]]
    walls = {e["epoch"]: e["t"] - start - bake_s.get(e["epoch"], 0.0)
             for start, e in zip(starts, elog.epochs)}
    occ_epochs = [e for e, k in zip(range(initial_epoch, epochs), kinds)
                  if k != "exact"]
    occ_ms = (1e3 * sum(walls[e] for e in occ_epochs)
              / (per_epoch * len(occ_epochs)) if occ_epochs else None)
    log(f"{label}: {len(elog.logs)} steps of NeRF.fit at {IMG}^2, "
        f"ray_chunks {TRAIN_CHUNK}, epochs {initial_epoch}..{epochs - 1} "
        f"({', '.join(kinds)}); bakes at epochs {baked} (shares "
        f"{', '.join(f'{x:.4f}' for x in shares)}, must lie in "
        f"{OCC_SHARE}; walls "
        f"{', '.join(f'{1e3 * bake_s[e]:.1f}' for e in baked)} ms with any "
        f"cache build); cache builds {builds}; occupancy steps "
        + (f"{occ_ms:.1f} ms/step wall less the bakes" if occ_ms else "none")
        + f" {card_tag}; launches {launches}; sample_merge modes "
        f"{dict(Counter(calls.merges))}; MLP depths "
        f"{dict(Counter(calls.mlp_shapes))}; probe gathers {calls.probes}; "
        f"plain calls {calls.plain_calls}")
    log(f"{label}: fine_loss by step " + " ".join(
        f"{m['fine_loss']:.4f}" for m in elog.logs))
    if len(elog.logs) != per_epoch * len(kinds):
        fail(f"{label}: {len(elog.logs)} steps")
    if baked != list(bake_epochs):
        fail(f"{label}: bakes at epochs {baked}, expected {bake_epochs}")
    if launches != expected:
        fail(f"{label}: launch counts {launches} != expected {expected}")
    if Counter(calls.merges) != modes or Counter(calls.mlp_shapes) != shapes:
        fail(f"{label}: sample_merge modes {Counter(calls.merges)} / MLP "
             f"depths {Counter(calls.mlp_shapes)} != expected {modes} / "
             f"{shapes}")
    if calls.plain_calls or calls.probes != probes:
        fail(f"{label}: {calls.plain_calls} plain calls, {calls.probes} "
             f"probe gathers (expected {probes})")
    if not all(OCC_SHARE[0] <= x <= OCC_SHARE[1] for x in shares):
        fail(f"{label}: an occupied share {shares} outside {OCC_SHARE}")
    if not all(math.isfinite(v) for m in elog.logs for v in m.values()):
        fail(f"{label}: non-finite training metrics")
    if not all(m[k] > 0.0 for m in elog.logs
               for k in ("coarse_grad_norm", "fine_grad_norm")):
        fail(f"{label}: a gradient norm is zero")
    return {"launches": launches, "occ_ms": occ_ms, "inputs": calls.inputs,
            "train_inputs": calls.train_inputs, "shares": shares}


# Per 2048-ray chunk of each kind of step: sample_merge's mode (s_c, n,
# s_m, the CDF source's row stride) and the depths of the two MLP passes.
OCC_STEP = {
    "exact": {"merge": (N_COARSE, N_FINE, -1, N_COARSE),
              "mlp": ((TRAIN_CHUNK, N_COARSE),
                      (TRAIN_CHUNK, N_COARSE + N_FINE))},
    "merge": {"merge": (OCC_PROBE, OCC_SAMPLES, N_COARSE, 0),
              "mlp": ((TRAIN_CHUNK, N_COARSE),
                      (TRAIN_CHUNK, N_COARSE + OCC_SAMPLES))},
    "no_merge": {"merge": (OCC_PROBE, OCC_SAMPLES, 0, 0),
                 "mlp": ((TRAIN_CHUNK, N_COARSE), (TRAIN_CHUNK, OCC_SAMPLES))},
}
# The occupancy-train tier's checks: (label, compile flags, fit's epochs,
# initial epoch, each epoch's steps, the epochs that bake).
OCC_TRAIN_RUNS = (
    ("occupancy train (merged)",
     dict(occupancy_train_warmup=1, occupancy_train_update=1), 3, 0,
     ("exact", "merge", "merge"), (1, 2)),
    ("occupancy train (--occupancy_train_no_merge)",
     dict(occupancy_train_warmup=1, occupancy_train_update=1,
          occupancy_train_merge=False), 2, 1, ("no_merge",), (1,)),
    ("occupancy train (--occupancy_train_update 2 "
     "--occupancy_train_cache)",
     dict(occupancy_train_warmup=1, occupancy_train_update=2,
          occupancy_train_cache=True), 3, 1,
     ("cached merge", "cached merge"), (1,)),
)
# Exact epochs before the occupancy-train checks: from the seed-0 weights
# the density lies below the bake's default threshold (1.0) everywhere, and
# some 40 steps grow the spheres' density past it; each bake's occupied
# share is logged and held in OCC_SHARE.
OCC_TRAIN_PRE_EPOCHS = 12
# The timed and profiled tiers, each after _occ_train_warm.
OCC_TRAIN_TIMED = {
    "merged": {}, "no_merge": dict(occupancy_train_merge=False),
    "cache": dict(occupancy_train_cache=True)}


def _occupancy_train_phases(cfg, dataset, errors, rel_errors,
                            card_tag) -> dict:
    """The occupancy-train tier at full width (``train_single
    --occupancy_train 128 --occupancy_train_samples 64
    --occupancy_train_probe 64``, ROADMAP A10b) and pixel sampling, through
    ``NeRF.fit`` on the 5 spheres views, from the seed-0 weights trained
    :data:`OCC_TRAIN_PRE_EPOCHS` epochs of exact steps first, so that the
    bake at the default threshold marks the spheres:

    * :data:`OCC_TRAIN_RUNS`, each through :func:`_occ_train_run`: merged
      (one exact epoch, then a bake and occupancy steps each epoch: 8
      ``sample_merge`` launches a step in the partner mode at [2048, 64
      bins, 64 + 64], then T3 at [2048 x 128]), without merge (the no-merge
      mode, T3 at [2048 x 64]) and with the cache every other epoch;
    * ``sample_merge`` against its plain version on the inputs of the
      first launch of each mode on the path (``_merge_held``), and T3's
      chain (:func:`_train_chain`, ``TRAIN_TOL``, twice with identical
      bits, the quadrature with and without weights) on the inputs of the
      first launch of each occupancy pass on the path: the coarse pass at
      [2048 x 64], which emits no weights there, and the merged fine pass
      at [2048 x 128];
    * 16^2 occupancy steps on the card against the CPU, merged and not, on
      the card's grid with the same draws (:func:`_compare_mse_steps`, the
      C11 pinning, ``STEP_TOL``), and the cached-rows step
      (``probe_rows_for_poses``) against the probed one on the card, bit
      for bit;
    * 5 ``--pixel_sampling`` steps (``RayBatchDataset``);
    * each tier of :data:`OCC_TRAIN_TIMED`, after one warm epoch that
      bakes, timed over 10 steps (wall, no bake, no profiler) and then
      profiled over 5.

    Logs the wall time of each of these sub-phases. Returns the launches
    by path, the recorded inputs, the timings and the profiles."""
    import math

    import torch

    from keras_nerf_tpu_torch.data import RayBatchDataset
    from keras_nerf_tpu_torch.inference import ORBIT
    from keras_nerf_tpu_torch.kernels import KERNELS, reset_launch_counts
    from keras_nerf_tpu_torch.models import NeRF
    from keras_nerf_tpu_torch.ops import occupancy as occ_mod

    dev = torch.device("cuda")
    walls, t_start = {}, time.perf_counter()

    def lap(name):
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t_start - sum(walls.values())

    nerf = _compile_train(NeRF(config=cfg), "mse")
    nerf.fit(dataset, epochs=OCC_TRAIN_PRE_EPOCHS, verbose=False)
    lap(f"{OCC_TRAIN_PRE_EPOCHS * len(dataset)} exact steps")
    out = {"launches": {}, "ms": {}, "profiles": {}}
    train_inputs = {}
    for (label, tier, epochs, first, kinds, bake_epochs), key in zip(
            OCC_TRAIN_RUNS, ("train_occupancy", "train_occupancy_no_merge",
                             "train_occupancy_cache")):
        _occ_train_compile(nerf, **tier)
        run = _occ_train_run(nerf, dataset, label, epochs, first, kinds,
                             bake_epochs, card_tag)
        out["launches"][key] = run["launches"]
        out.setdefault("inputs", {}).update(run["inputs"])
        for mode, got in run["train_inputs"].items():
            train_inputs.setdefault(mode, got)
        lap(label)
        if key == "train_occupancy_cache":
            cache = nerf._occ_probe_cache
            if (cache is None or cache.dtype != torch.uint8 or tuple(
                    cache.shape) != (TRAIN_POSES, IMG * IMG, OCC_PROBE)):
                fail(f"{label}: the probe-row cache is "
                     f"{None if cache is None else tuple(cache.shape)}")
    inputs = out["inputs"]
    partner = OCC_STEP["merge"]["merge"]
    alone = OCC_STEP["no_merge"]["merge"]
    _merge_held(f"partner on the occupancy-train path [{TRAIN_CHUNK}, "
                f"{OCC_PROBE} bins, {N_COARSE} + {OCC_SAMPLES}]",
                *inputs[partner], TRAIN_TOL["sample_merge"]["abs"], errors)
    _merge_held(f"no merge on the occupancy-train path [{TRAIN_CHUNK}, "
                f"{OCC_PROBE} bins -> {OCC_SAMPLES}]", *inputs[alone],
                TRAIN_TOL["sample_merge"]["abs"], errors)
    for s, where in ((N_COARSE, " (occupancy coarse pass)"),
                     (N_COARSE + OCC_SAMPLES, " (occupancy fine pass, "
                                              "merged)")):
        got = train_inputs[((TRAIN_CHUNK, s), False)]
        _record_held(_train_chain(
            got["packed"], got["base"], got["slope"], got["masks"], got["t"],
            got["target"], (False, True), got["white_background"],
            got["loss_scale"], where), errors, rel_errors)
    del train_inputs
    lap("the kernels held on the path's inputs")

    # 16^2 steps: the card against the CPU on the card's last grid, and
    # the cached rows against the probe on the card.
    grid = nerf._occ_train_grid
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    small = _small_step_inputs(gen, OCC_SAMPLES)
    for merge in (True, False):
        spec = (OCC_SAMPLES, OCC_PROBE, ORBIT["near"], ORBIT["far"],
                occ_mod.DEFAULT_AABB, merge)
        t0 = time.perf_counter()
        reset_launch_counts()
        tier = "merged" if merge else "no merge"
        _compare_mse_steps(
            f"occupancy train step {E2E_IMG}^2 ({tier}), card kernels vs "
            f"CPU plain versions on the card's grid",
            nerf.state, small, cfg, dict(occupancy=spec, occ_grid=grid))
        launches = {k.name: k.launches for k in KERNELS}
        expected = {k.name: E2E_IMG * E2E_IMG // E2E_CHUNK
                    * MSE_LAUNCHES.get(k.name, 0) for k in KERNELS}
        log(f"occupancy train step {E2E_IMG}^2 (merge {merge}): "
            f"{time.perf_counter() - t0:.1f} s (wall: the card's step and "
            f"two CPU steps); card launches {launches}")
        if launches != expected:
            fail(f"occupancy train step {E2E_IMG}^2: launch counts "
                 f"{launches} != expected {expected}")
    _, poses, focal = _spheres_scene(1, seed=2, img=E2E_IMG)
    rows = occ_mod.probe_rows_for_poses(
        poses, focal, grid, image_height=E2E_IMG, image_width=E2E_IMG,
        near=ORBIT["near"], far=ORBIT["far"], n_probe=OCC_PROBE)
    spec = (OCC_SAMPLES, OCC_PROBE, ORBIT["near"], ORBIT["far"],
            occ_mod.DEFAULT_AABB, True)
    steps = [_one_step(nerf.state, small, cfg, "cuda", None,
                       dict(occupancy=spec, **kw))
             for kw in (dict(occ_grid=grid),
                        dict(occ_rows=rows.reshape(-1, OCC_PROBE)))]
    (m_grid, g_grid), (m_rows, g_rows) = steps
    same = (m_grid == m_rows and all(
        torch.equal(a, b) for ga, gb in zip(g_grid, g_rows)
        for a, b in zip(ga, gb)))
    log(f"occupancy train step {E2E_IMG}^2 on the card, cached rows "
        f"(probe_rows_for_poses) vs the probed grid: bit for bit {same}")
    if not same:
        fail("the cached-rows step differs from the probed step")
    lap(f"{E2E_IMG}^2 steps card vs CPU, cached vs probed")

    # Pixel sampling: 5 steps of NeRF.fit on RayBatchDataset.
    images, poses, focal = _spheres_scene(TRAIN_POSES, seed=0)
    rays = RayBatchDataset(images, poses, focal=focal, near=ORBIT["near"],
                           far=ORBIT["far"], n_samples=N_COARSE,
                           batch_size=1, seed=0, device="cuda")
    nerf.compile(optimizer="adam", loss="mse", batch_size=1,
                 image_height=IMG, image_width=IMG, ray_chunks=TRAIN_CHUNK,
                 white_background=True, learning_rate=1e-3, device="cuda",
                 seed=0, pixel_sampling=True)
    steps = _StepLog()
    torch.cuda.synchronize()
    reset_launch_counts()
    with _CallLog() as calls:
        t0 = time.perf_counter()
        nerf.fit(rays, epochs=1, callbacks=[steps], verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    n = len(steps.logs)
    expected = {k.name: n * IMG * IMG // TRAIN_CHUNK
                * MSE_LAUNCHES.get(k.name, 0) for k in KERNELS}
    log(f"pixel sampling: {n} steps of NeRF.fit on RayBatchDataset "
        f"({IMG}^2 rays a batch drawn across {TRAIN_POSES} views) in "
        f"{wall:.3f} s {card_tag}; launches {launches}; fine_loss "
        + " ".join(f"{m['fine_loss']:.4f}" for m in steps.logs))
    if n != len(rays) or launches != expected or calls.plain_calls:
        fail(f"pixel sampling: {n} steps, launches {launches} != expected "
             f"{expected}, {calls.plain_calls} plain calls")
    if not all(math.isfinite(v) and (not k.endswith("grad_norm") or v > 0)
               for m in steps.logs for k, v in m.items()):
        fail("pixel sampling: non-finite metrics or a zero gradient norm")
    out["launches"]["train_pixel_sampling"] = launches
    lap("pixel sampling")

    # Each tier after a warm epoch (the bake): 10 steps that bake nothing
    # timed without the profiler, then 5 under it.
    for name, tier in OCC_TRAIN_TIMED.items():
        _occ_train_warm(nerf, dataset, **tier)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nerf.fit(dataset, epochs=3, initial_epoch=1, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = 2 * len(dataset)
        out["ms"][name] = 1e3 * wall / steps
        log(f"time occupancy train step ({name}): {out['ms'][name]:.1f} "
            f"ms/step, {steps * IMG * IMG / wall:.0f} rays/s over {steps} "
            f"steps of NeRF.fit (wall, host clock, no bake, no profiler) "
            f"{card_tag}")
        out["profiles"][name] = _profile(
            lambda: nerf.fit(dataset, epochs=2, initial_epoch=1,
                             verbose=False), len(dataset), "step")
        lap(f"{name} timed and profiled")
    log(f"occupancy train tier: {time.perf_counter() - t_start:.1f} s "
        f"(wall, CPU references included): " + ", ".join(
            f"{k} {v:.1f} s" for k, v in walls.items()))
    return out



# ---------------------------------------------------------------------------
# Data parallelism (keras_nerf_tpu_torch.parallel, train --num_gpus).

DP_STEPS = 5              # phase (a): 5 train views, batch 1, one epoch
DP_RANKS = 2              # phases (b) and (c): two processes on the card
DP_TIMEOUT = 600          # seconds for the two ranks of (b) and (c)
DP_TIMED_STEPS = 10       # world-1 step and all-reduce timings


def _dp_flags(root: str, name: str) -> list:
    """The training CLI's flags of phase (a): the spheres views at 128^2,
    8 x 256, 64 + 128 samples, --ray_chunks 2048, one epoch of 5 steps."""
    return ["--name", name, "--data_dir", os.path.join(root, "scene"),
            "--img_wh", str(IMG), "--white_bg", "--num_epochs", "1",
            "--batch_size", "1", "--ray_chunks", str(TRAIN_CHUNK),
            "--seed", "0", "--log_freq", "1",
            "--log_dir", os.path.join(root, "logs"),
            "--model_dirs", os.path.join(root, "model")]


def _load_state(path: str):
    from keras_nerf_tpu_torch.models import NeRF

    return NeRF(model_path=path).compile(
        batch_size=1, image_height=IMG, image_width=IMG,
        ray_chunks=TRAIN_CHUNK, white_background=True, is_training=False,
        device="cuda").state


def _dp_world1_phase(root: str, card_tag) -> dict:
    """(a) ``python -m keras_nerf_tpu_torch.train --num_gpus 1`` (one rank,
    NCCL, in this process) against ``train_single``'s ungrouped
    ``NeRF.fit`` from the same seed: the same 5 steps' parameters bit for
    bit, since a one-rank sum divided by 1 is exact and rank 0 draws what
    an ungrouped run draws. Then times the world-1 NCCL step beside the
    plain step, in turns on one batch, and the two flat all-reduces."""
    import numpy as np
    import torch

    from keras_nerf_tpu_torch import train, train_single
    from keras_nerf_tpu_torch.kernels import reset_launch_counts
    from keras_nerf_tpu_torch.models import engine
    from keras_nerf_tpu_torch.models.engine import tree_leaves
    from keras_nerf_tpu_torch.parallel import make_group
    from keras_nerf_tpu_torch.data import DatasetLoader

    reset_launch_counts()
    t0 = time.perf_counter()
    train.main(["--num_gpus", "1", *_dp_flags(root, "world1")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    log(f"data parallel (a): train --num_gpus 1 (NCCL, one rank), {DP_STEPS}"
        f" steps at {IMG}^2 with validation, test and checkpoints, "
        f"{wall:.2f} s wall {card_tag}; launches {launches}")
    _ran(launches, MSE_LAUNCHES, "train --num_gpus 1")
    t0 = time.perf_counter()
    train_single.run_training(train_single.build_arg_parser().parse_args(
        _dp_flags(root, "plain")))
    log(f"data parallel (a): train_single (no group), the same run, "
        f"{time.perf_counter() - t0:.2f} s wall {card_tag}")
    grouped, plain = (_load_state(os.path.join(root, "model", name))
                      for name in ("world1", "plain"))
    leaves = [(a, b) for a, b in zip(tree_leaves(grouped[:4]),
                                     tree_leaves(plain[:4]))
              if torch.is_tensor(a)]
    differ = sum(not torch.equal(a, b) for a, b in leaves)
    worst = max(float((a - b).abs().max()) for a, b in leaves)
    if grouped.coarse_opt.get("count") != plain.coarse_opt.get("count"):
        fail("train --num_gpus 1 took another number of Adam steps")
    log(f"data parallel (a): {len(leaves)} tensors of the state after "
        f"{grouped.step} steps, {differ} differ from the ungrouped run's "
        f"(max abs {worst:.3e}); bit for bit expected")
    if differ or grouped.step != plain.step or grouped.step != DP_STEPS:
        fail("train --num_gpus 1 is not the ungrouped run bit for bit")

    # Times: the grouped and the plain step in turns on one batch, from
    # the trained state (not updated), then each flat all-reduce.
    group = make_group(1, device="cuda")
    try:
        train_ds = DatasetLoader(os.path.join(root, "scene"), True,
                                 device="cuda").load_dataset(
            batch_size=1, image_width=IMG, image_height=IMG, near=2.0,
            far=6.0, n_sample=N_COARSE, seed=0)[0]
        batch = next(iter(train_ds))
        cfg = engine.NeRFConfig(n_coarse=N_COARSE, n_fine=N_FINE,
                                white_background=True)
        opt = engine.make_optimizer("adam", 1e-3)
        gen = torch.Generator(device="cuda")

        def step(g):
            gen.manual_seed(0)
            return engine.train_step(plain, batch, gen, opt, cfg,
                                     TRAIN_CHUNK, group=g)

        for g in (None, group):   # warm-up
            step(g)
        ms = {"plain": [], "nccl": []}
        for i in range(2 * DP_TIMED_STEPS):
            g = group if i % 2 else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(g)
            torch.cuda.synchronize()
            ms["nccl" if g else "plain"].append(
                1e3 * (time.perf_counter() - t0))
        sizes = [sum(x.numel() for x in tree_leaves(p))
                 for p in (plain.coarse_params, plain.fine_params)]
        flat = torch.zeros(sizes[0], device="cuda")
        reduce_ms = _time_ms(lambda: group.all_reduce_(flat), 20,
                             spin=False)
        out = {"step_ms_plain": float(np.median(ms["plain"])),
               "step_ms_nccl_world1": float(np.median(ms["nccl"])),
               "all_reduce_ms": reduce_ms, "all_reduce_floats": sizes[0]}
        log(f"time data parallel (a): {IMG}^2 train step, ray_chunks "
            f"{TRAIN_CHUNK}, median of {DP_TIMED_STEPS} in turns: plain "
            f"{out['step_ms_plain']:.2f} ms, NCCL world 1 "
            f"{out['step_ms_nccl_world1']:.2f} ms (wall, host clock); one "
            f"flat all-reduce of {sizes[0]} float32 (a model's gradients; "
            f"a step makes two, and one of its 8 metrics) {reduce_ms:.4f} "
            f"ms (CUDA events, paced by the host's calls) {card_tag}")
        log(json.dumps({"data_parallel_world1": out, "card": card_tag}))
    finally:
        group.close()
    return launches


def _dp_worker(paths, group) -> None:
    """One of the ranks of phases (b) and (c), spawned by ``run_ranks``
    with gloo over CUDA tensors on card 0. (b) one shard_rays step of
    ``sharded_train_step`` on its height band with its band's draws; (c)
    the banded render of ``NeRF.predict_and_render_images`` in bf16 and in
    int8. ``paths`` is ``(inputs, out_dir)``; writes its results and each
    phase's launches to ``out_dir/rank{rank}.pt``."""
    import torch

    from keras_nerf_tpu_torch.kernels import reset_launch_counts
    from keras_nerf_tpu_torch.models import NeRF, engine
    from keras_nerf_tpu_torch.parallel import (
        replicate,
        shard_batch,
        sharded_train_step,
    )

    inputs_path, out_dir = paths
    rank, n = group.rank, group.size
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = torch.load(inputs_path, map_location="cuda:0")
    out = {"launches": {}}
    cfg = engine.NeRFConfig(n_coarse=N_COARSE, n_fine=N_FINE,
                            white_background=True)
    state = replicate(engine.TrainState(
        inp["coarse"], inp["fine"], {}, {}, 0), group)
    band = shard_batch(inp["batch"], group, shard_rays=True)
    step = sharded_train_step(group, engine.make_optimizer("sgd", 1.0),
                              cfg, TRAIN_CHUNK)
    per_band = len(inp["draws"]) // n
    reset_launch_counts()
    new, metrics = step(state, band, inp["draws"][rank * per_band:
                                                  (rank + 1) * per_band])
    torch.cuda.synchronize()
    out["launches"]["train_shard_rays"] = _counts()
    out["step"] = {"coarse": _to(new.coarse_params, "cpu"),
                   "fine": _to(new.fine_params, "cpu"),
                   "metrics": {k: float(v) for k, v in metrics.items()}}
    per_band = len(inp["render_draws"]) // n
    for tier in ("bf16", "int8"):
        nerf = NeRF(config=cfg).compile(
            batch_size=1, image_height=IMG, image_width=IMG,
            ray_chunks=CHUNK, white_background=True, is_training=False,
            device="cuda:0", seed=0, quantized_render=tier == "int8",
            group=group)
        nerf.state = engine.TrainState(inp["render_coarse"],
                                       inp["render_fine"], {}, {}, 0)
        reset_launch_counts()
        _, fine = nerf.predict_and_render_images(
            inp["rays"], with_weights=False, coarse_image=False,
            fine_draws=inp["render_draws"][rank * per_band:
                                           (rank + 1) * per_band])
        torch.cuda.synchronize()
        out["launches"][f"render_{tier}"] = _counts()
        out[tier] = {k: v.cpu() for k, v in fine.items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _dp_ranks_phase(root: str, trained, card_tag) -> dict:
    """(b) and (c): two spawned ranks on the one card (gloo over CUDA
    tensors). (b): one ``shard_rays`` step at batch 1 from ``trained``
    (SGD, lr 1) against the one-rank step fed the same per-band draws:
    the bands' 2048-ray chunks are the whole image's, so only the order of
    the final sum differs; held at ``STEP_TOL``. (c): the banded render of
    the fog weights in bf16 and int8 against the one-rank frame fed the
    same draws, held at ``E2E_TOL``."""
    import torch

    from keras_nerf_tpu_torch.data import generate_ray_batch, pose_spherical
    from keras_nerf_tpu_torch.data import get_focal_from_fov
    from keras_nerf_tpu_torch.inference import ORBIT
    from keras_nerf_tpu_torch.models import NeRF, engine, init_mlp
    from keras_nerf_tpu_torch.ops import sorted_uniforms
    from keras_nerf_tpu_torch.parallel import run_ranks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    cfg = engine.NeRFConfig(n_coarse=N_COARSE, n_fine=N_FINE,
                            white_background=True)
    images, poses, focal = _spheres_scene(1, seed=19)
    batch = (torch.as_tensor(images, device="cuda"), generate_ray_batch(
        poses, gen, image_height=IMG, image_width=IMG, focal=focal,
        near=ORBIT["near"], far=ORBIT["far"], n_samples=N_COARSE))
    draws = [sorted_uniforms(gen, (TRAIN_CHUNK,), N_FINE)
             for _ in range(IMG * IMG // TRAIN_CHUNK)]
    rays = generate_ray_batch(
        pose_spherical(30.0, ORBIT["phi"], ORBIT["z_translate"])[None], gen,
        image_height=IMG, image_width=IMG,
        focal=get_focal_from_fov(ORBIT["fov"], IMG), near=ORBIT["near"],
        far=ORBIT["far"], n_samples=N_COARSE)
    render_draws = [sorted_uniforms(gen, (CHUNK,), N_FINE)
                    for _ in range(IMG * IMG // CHUNK)]
    fog = [_fog(init_mlp(gen, cfg.mlp, cfg.in_xyz, cfg.in_dir))
           for _ in range(2)]
    inputs = {"coarse": trained.coarse_params, "fine": trained.fine_params,
              "batch": batch, "draws": draws, "rays": rays,
              "render_draws": render_draws, "render_coarse": fog[0],
              "render_fine": fog[1]}
    inputs_path = os.path.join(root, "dp_inputs.pt")
    torch.save(inputs, inputs_path)
    out_dir = os.path.join(root, "dp_out")
    os.makedirs(out_dir, exist_ok=True)
    # The ranks share the card with this process: hand its cached blocks
    # back first.
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        run_ranks(_dp_worker, (inputs_path, out_dir), DP_RANKS, "cuda:0",
                  backend="gloo", timeout=DP_TIMEOUT)
    except RuntimeError as e:
        fail(f"the data-parallel ranks failed: {e}")
    log(f"data parallel (b, c): {DP_RANKS} spawned ranks on one card (gloo "
        f"over CUDA tensors), {time.perf_counter() - t0:.1f} s wall "
        f"(process start included) {card_tag}")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
             for r in range(DP_RANKS)]
    launches = {}
    for r, res in enumerate(ranks):
        for path, counts in res["launches"].items():
            log(f"data parallel ({'b' if path.startswith('train') else 'c'}"
                f") {path}, rank {r}: launches {counts}")
            launches[f"{path}_rank{r}"] = counts
        _ran(res["launches"]["train_shard_rays"], MSE_LAUNCHES,
             f"rank {r}'s shard_rays step")
        _ran(res["launches"]["render_bf16"],
             ("sample_merge", "ray_march_mlp", "ray_march_quadrature"),
             f"rank {r}'s banded bf16 render")
        _ran(res["launches"]["render_int8"],
             ("sample_merge", "ray_march_mlp_int8", "ray_march_quadrature"),
             f"rank {r}'s banded int8 render")

    # (b): the one-rank step on the whole image with the bands' draws.
    state = engine.TrainState(trained.coarse_params, trained.fine_params,
                              {}, {}, 0)
    new, metrics = engine.train_step(state, batch, draws,
                                     engine.make_optimizer("sgd", 1.0), cfg,
                                     TRAIN_CHUNK)
    got = ranks[0]["step"]
    m_a = got["metrics"]
    m_b = {k: float(v) for k, v in metrics.items()}
    loss_err = max(abs(m_a[k] - m_b[k]) / abs(m_b[k])
                   for k in ("coarse_loss", "fine_loss"))
    worst = {}
    for model in ("coarse", "fine"):
        p0 = engine.tree_leaves(getattr(state, f"{model}_params"))
        worst[model] = _worst_leaf(
            ((a - b.cpu()), (a - c.cpu())) for a, b, c in zip(
                (x.cpu() for x in p0), engine.tree_leaves(got[model]),
                engine.tree_leaves(getattr(new, f"{model}_params"))))
    log(f"data parallel (b): shard_rays step on {DP_RANKS} ranks vs the "
        f"one-rank step, same draws: loss relative err {loss_err:.3e} "
        f"(tolerance {STEP_TOL['loss_rtol']}); worst leaf gradient relative "
        f"norm / max " + ", ".join(f"{m} {w[0]:.3e} / {w[1]:.3e}"
                                   for m, w in worst.items())
        + f" (tolerance {STEP_TOL['grad_rel_norm']} / "
        f"{STEP_TOL['grad_rel_max']}) {card_tag}")
    if not (loss_err <= STEP_TOL["loss_rtol"]
            and all(map(_within_step_tol, worst.values()))):
        fail("the shard_rays step disagrees with the one-rank step")
    if any(ranks[r]["step"]["metrics"] != m_a for r in range(DP_RANKS)):
        fail("the ranks' step metrics differ")

    # (c): the one-rank frames with the same weights and draws.
    for tier in ("bf16", "int8"):
        nerf = NeRF(config=cfg).compile(
            batch_size=1, image_height=IMG, image_width=IMG, ray_chunks=CHUNK,
            white_background=True, is_training=False, device="cuda", seed=0,
            quantized_render=tier == "int8")
        nerf.state = engine.TrainState(fog[0], fog[1], {}, {}, 0)
        _, fine = nerf.predict_and_render_images(
            rays, with_weights=False, coarse_image=False,
            fine_draws=render_draws)
        errs = {k: max(float((res[tier][k] - fine[k].cpu()).abs().max())
                       for res in ranks) for k in ("image", "depth")}
        log(f"data parallel (c): banded {tier} render on {DP_RANKS} ranks vs "
            f"the one-rank frame, same draws: " + ", ".join(
                f"{k} max_abs_err {v:.3e} (tolerance {E2E_TOL[k]:.0e})"
                for k, v in errs.items()) + f" {card_tag}")
        if any(errs[k] > E2E_TOL[k] for k in errs):
            fail(f"the banded {tier} render disagrees with one rank's")
    return launches


def _data_parallel_phases(card_tag) -> dict:
    """Phases (a), (b) and (c) of data parallelism on one card; returns
    each path's launches, read just after it ran."""
    import shutil

    import torch.distributed as dist

    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

    import torch

    nccl = dist.is_nccl_available()
    log(f"torch.distributed: NCCL available {nccl}"
        + (f" (version {torch.cuda.nccl.version()})" if nccl else "")
        + f", gloo available {dist.is_gloo_available()}")
    root = os.path.join(HERE, "build", "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_synthetic_scene(os.path.join(root, "scene"), image_wh=IMG,
                          n_train=DP_STEPS, n_val=1, n_test=1)
    # NCCL and the spawned ranks allocate outside this process's caching
    # allocator: hand its cached blocks back first.
    gc.collect()
    torch.cuda.empty_cache()
    log(f"card memory before the data-parallel phases: allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    launches = {"train_nccl_world1": _dp_world1_phase(root, card_tag)}
    trained = _load_state(os.path.join(root, "model", "world1"))
    for path, counts in _dp_ranks_phase(root, trained, card_tag).items():
        launches[path] = counts
    log(f"data parallel phases: {time.perf_counter() - t0:.1f} s wall "
        f"{card_tag}")
    shutil.rmtree(root, ignore_errors=True)
    return launches


if __name__ == "__main__":
    sys.exit(main())
