"""Render traffic: the orbit of the inference CLI, one pose a call of
``NeRF.predict_and_render_images(rays, with_weights=False,
coarse_image=False, fine_draws=...)`` as ``inference.render_orbit`` calls
it, the fine image and depth copied to the host each frame, poses in
turn until the deadline, in a closed loop. The mix may add keyword
arguments of ``NeRF.compile`` (``"compile"``, such as
``{"quantized_render": true}``).

Set-up makes the weights (the density bias of the configuration's
``assumed``), every pose's rays, stratified depths and fine draws from the
seed, and renders one frame to warm up. After the window the plain
reference renders a sample of the finished frames, drawn from the seed,
from the same inputs, and the check compares the fine images.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nerfbench import clock, flops, harness, inputs
from nerfbench.reference import nerf as ref
from nerfbench.trace import Stretch, describe, traced_stretch


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device,
          quantized: bool = False):
    """``(model, weights, per-pose inputs)``; ``quantized`` compiles the
    int8 render tier (the control)."""
    from keras_nerf_tpu_torch.models.engine import TrainState

    s_weights, s_rays, s_model = inputs.derive_seeds(seed, 3)
    gen = torch.Generator(device=device).manual_seed(s_weights)
    bias = cfg["assumed"]["render_sigma_bias"]
    weights = tuple(inputs.make_params(gen, cfg, sigma_bias=bias)
                    for _ in range(2))
    poses = inputs.orbit_inputs(
        cfg, traffic, torch.Generator(device=device).manual_seed(s_rays))
    wh = cfg["img_wh"]
    model = harness.build_nerf(cfg)
    model.compile(batch_size=1, image_height=wh, image_width=wh,
                  ray_chunks=cfg["render_ray_chunks"],
                  white_background=cfg["white_background"], is_training=False,
                  seed=s_model % 2 ** 31, device=device,
                  **dict(traffic.get("compile", {}),
                         **({"quantized_render": True} if quantized else {})))
    model.state = TrainState(weights[0], weights[1], {}, {}, 0)
    return model, weights, poses


def render_frame(model, pose) -> tuple[np.ndarray, np.ndarray]:
    rays, draws = pose
    _, fine = model.predict_and_render_images(
        rays, with_weights=False, coarse_image=False,
        fine_draws=list(draws.unbind(0)))
    return fine["image"].cpu().numpy(), fine["depth"].cpu().numpy()


def window(model, poses, seconds: float, device: torch.device,
           stretch: Stretch | None) -> dict:
    """Frames until ``seconds`` have passed: each frame's host time from
    the call to its depth on the host, and every frame's output."""
    frames, times = [], []
    clock.sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        k = len(frames)
        if stretch is not None:
            stretch.between(k)
        t = time.perf_counter()
        frames.append(render_frame(model, poses[k % len(poses)]))
        times.append(time.perf_counter() - t)
    if stretch is not None:
        stretch.close(len(frames))
    wall = time.perf_counter() - t0
    return {"t0": t0, "wall_s": wall, "frames": frames, "frame_s": times}


def sample(seed: int, finished: int, n: int) -> list[int]:
    """``n`` of the ``finished`` frames (all, if fewer), drawn from the
    seed."""
    rng = np.random.default_rng(inputs.derive_seeds(seed, 4)[3])
    n = min(n, finished)
    return sorted(rng.choice(finished, size=n, replace=False).tolist())


def reference_frames(cfg: dict, weights, poses, pose_ids,
                     precision: str = "float32") -> dict:
    """The reference's fine image and depth of each pose in ``pose_ids``."""
    out = {}
    for p in sorted(set(pose_ids)):
        (origin, direction, points), draws = poses[p]
        n_f = cfg["n_fine"]
        image, depth = ref.render(
            weights[0], weights[1], origin.reshape(-1, 3),
            direction.reshape(-1, 3), points.reshape(-1, cfg["n_coarse"]),
            draws.reshape(-1, n_f), cfg, precision)
        out[p] = (image.cpu().numpy(), depth.cpu().numpy())
    return out


# Half a step of an 8-bit image: an error past it can move a pixel's
# 8-bit value by one.
HALF_STEP = 1.0 / 510.0


def gaps(frames: list, refs: dict, pose_of) -> dict:
    """Against the reference, over the sampled frames, the worst frame's
    99th percentile of the fine image's absolute error over its channel
    values (``image_p99``) and share of channel values off by more than
    half an 8-bit step (``image_off_pct``, %)."""
    worst = dict.fromkeys(("image_p99", "image_off_pct"), 0.0)
    for i, (image, _) in frames:
        err = np.abs(image.reshape(-1, 3).astype(np.float64)
                     - refs[pose_of(i)][0])
        for key, val in (("image_p99", np.quantile(err, 0.99)),
                         ("image_off_pct", 100.0 * np.mean(err > HALF_STEP))):
            worst[key] = max(worst[key], float(val))
    return worst


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device) -> harness.Outcome:
    cfg, traffic, checks = cell.config, cell.traffic, cell.checks
    model, weights, poses = setup(cfg, traffic, seed, device)
    render_frame(model, poses[0])
    stretch = traced_stretch(trace, device, checks["trace"])
    w = window(model, poses, seconds, device, stretch)
    peak = clock.memory_peak(device)
    rays = cfg["img_wh"] ** 2
    n = len(w["frames"])
    e2e = {"render_rays_per_s": n * rays / w["wall_s"],
           "render_frame_ms_p95": 1e3 * harness.p95(w["frame_s"])}
    del model
    clock.free(device)
    picked = sample(seed, n, checks["sample_frames"])
    refs = reference_frames(cfg, weights, poses,
                            [i % len(poses) for i in picked])
    readings = gaps([(i, w["frames"][i]) for i in picked], refs,
                    lambda i: i % len(poses))
    out = harness.Outcome(attempted=n, end_to_end=e2e,
                          readings=readings, memory_peak_bytes=peak,
                          window_start=w["t0"])
    layer = {"kind": "render", "units": 0, "rays_per_unit": rays,
             "flop_per_ray": flops.render_flop_per_ray(cfg)}
    out.stretch = describe(stretch, out, layer)
    return out
