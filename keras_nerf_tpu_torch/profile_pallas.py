"""The point-MLP kernels' chunk-level times and the train step at several
chunk sizes (port of ``scripts/profile_pallas.py``, whose kernels were the
TPU's Pallas ones; here the CUDA kernels).

    python -m keras_nerf_tpu_torch.profile_pallas [--iters 20]
        [--rays 2048] [--samples 192] [--img_wh 128]
        [--chunks 2048 4096 8192 16384] [--device cuda]
    python -m keras_nerf_tpu_torch.profile_pallas --components
        [--launch_points 49152 98304 196608 393216]

Default, on the fine model (8 x 256, seed-0 weights), rotating among 8
random chunks of ``--rays`` rays x ``--samples`` sorted depths:

* the fine forward chunk: ``point_render_chunk`` (``encode_block128``,
  ``apply_mlp`` (T5), the reference quadrature), the port's form of the
  JAX package's ``fused_render_chunk``;
* its forward and backward through ``fused_point_forward``, packing
  included, as custom-loss (L1) training runs it: the forward's
  ``apply_mlp``, then ``apply_mlp`` with a stash, ``mlp_backward`` in its
  output-head mode and ``mlp_weight_grad`` (T6) for the gradient of the
  mean squared image;
* ``engine.train_step`` (the fused MSE path, Adam) on one random
  ``img_wh``^2 batch at each ``--chunks``: wall ms and rays/s, then one
  step under ``torch.profiler``: device ms (busy), host gap and launches.

``--components``: the same points through each kernel alone:
``encode_block128``, ``apply_mlp`` and ``fused_mlp_backward`` (T6); the
port's kernels take no tile argument, so the points a launch are scanned
instead (``--launch_points``: the chunk's points cut into launches of that
many, the ms for all of them).

Device ms by CUDA events over ``--iters`` calls (``timing.device_ms``).
Dropped from the JAX script: synchronising by fetching a host scalar, the
Pallas ``tile=`` scans, and its printing "FAILED" for a step or tile that
raised and carrying on: here a failure raises. On the CPU (``--device
cpu``) the host clock stands in for the events and the device columns
read "not measured". Prints the card's line first, one line a reading and,
last, ``{"profile_pallas": ...}``.
"""

from __future__ import annotations

import argparse
import json

import torch

from keras_nerf_tpu_torch import timing

N_INPUTS = 8


def _chunks(rays: int, samples: int, device) -> list:
    g = torch.Generator(device=device).manual_seed(2)
    out = []
    for _ in range(N_INPUTS):
        o = torch.zeros(rays, 3, device=device)
        o[:, 2] = 4.0
        d = torch.nn.functional.normalize(
            torch.randn(rays, 3, generator=g, device=device), dim=-1)
        t = torch.sort(torch.rand(rays, samples, generator=g, device=device)
                       * 4 + 2, dim=-1).values
        out.append((o, d, t))
    return out


def chunk_readings(cfg, params, rays, samples, iters, device) -> dict:
    from keras_nerf_tpu_torch.kernels import ray_march as trm
    from keras_nerf_tpu_torch.models.engine import tree_map
    from keras_nerf_tpu_torch.ops.rendering import render_rays

    xs = _chunks(rays, samples, device)
    enc = (cfg.pos_emb_xyz, cfg.pos_emb_dir)
    packed = trm.pack_mlp_params(params, cfg.mlp, *enc)

    def fwd(i):
        o, d, t = xs[i]
        return trm.point_render_chunk(packed, o, d, t, *enc,
                                      white_background=True)

    def fwd_bwd(i):
        o, d, t = xs[i]
        prm = tree_map(lambda x: x.detach().requires_grad_(True), params)
        pos, dirs = trm.ray_points(o, d, t)
        rgb, sigma = trm.fused_point_forward(prm, pos, dirs, cfg.mlp, *enc)
        out = render_rays(rgb.reshape(rays, samples, 3),
                          sigma.reshape(rays, samples), t,
                          white_background=True)
        torch.mean(out.image ** 2).backward()

    out = {}
    for label, fn in ((f"fine forward chunk [{rays} x {samples}]", fwd),
                      (f"fine forward + backward [{rays} x {samples}] "
                       "(fused_point_forward)", fwd_bwd)):
        out[label] = timing.device_ms(fn, N_INPUTS, iters, device)
        print(f"{label}: {out[label]:.4f} ms", flush=True)
    return out


def step_readings(cfg, img_wh, chunks, iters, device) -> dict:
    from keras_nerf_tpu_torch.data.synthetic import random_ray_batch
    from keras_nerf_tpu_torch.models import engine

    opt = engine.make_optimizer("adam", 1e-3)
    gen = torch.Generator(device=device).manual_seed(0)
    state = engine.init_train_state(gen, cfg, opt, device=device)
    batch = random_ray_batch(1, img_wh, img_wh, cfg.n_coarse,
                             torch.Generator(device=device).manual_seed(1))
    rays = img_wh * img_wh
    out = {}
    for rc in chunks:
        if rc > rays or rays % rc:
            continue
        split = timing.run_split(
            lambda _: engine.train_step(state, batch, gen, opt, cfg, rc), 1,
            iters, device)
        split["rays_per_s"] = rays / split["wall_ms"] * 1e3
        out[str(rc)] = split
        print(timing.split_line(f"train_step chunks={rc:6d}", split)
              + f" ({split['rays_per_s']:,.0f} rays/s)", flush=True)
    return out


def component_readings(cfg, params, rays, samples, launch_points, iters,
                       device) -> dict:
    from keras_nerf_tpu_torch.kernels import ray_march as trm

    p = rays * samples
    g = torch.Generator(device=device).manual_seed(3)
    pos = [torch.randn(p, 3, generator=g, device=device)
           for _ in range(N_INPUTS)]
    dirs = [torch.nn.functional.normalize(
        torch.randn(p, 3, generator=g, device=device), dim=-1)
        for _ in range(N_INPUTS)]
    enc_args = (cfg.pos_emb_xyz, cfg.pos_emb_dir)
    encs = [trm.encode_block128(a, b, *enc_args) for a, b in zip(pos, dirs)]
    cot = [torch.randn(p, 4, generator=g, device=device).to(torch.bfloat16)
           for _ in range(N_INPUTS)]
    packed = trm.pack_mlp_params(params, cfg.mlp, *enc_args)
    out = {}
    label = f"encode_block128 ({p} points)"
    out[label] = timing.device_ms(
        lambda i: trm.encode_block128(pos[i], dirs[i], *enc_args), N_INPUTS,
        iters, device)
    print(f"{label}: {out[label]:.4f} ms", flush=True)
    for n in launch_points:
        if n > p or p % n:
            continue
        cuts = [(a, a + n) for a in range(0, p, n)]

        def fwd(i):
            for a, b in cuts:
                trm.apply_mlp(packed, encs[i][a:b])

        def bwd(i):
            grads = trm.zero_grads(packed)
            for a, b in cuts:
                trm.fused_mlp_backward(packed, encs[i][a:b], cot[i][a:b],
                                       grads)

        for name, fn in (("apply_mlp", fwd), ("fused_mlp_backward", bwd)):
            label = f"{name} ({p} points, {n} a launch)"
            out[label] = timing.device_ms(fn, N_INPUTS, iters, device)
            print(f"{label}: {out[label]:.4f} ms", flush=True)
    return out


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--samples", type=int, default=192)
    ap.add_argument("--img_wh", type=int, default=128)
    ap.add_argument("--chunks", type=int, nargs="*",
                    default=[2048, 4096, 8192, 16384])
    ap.add_argument("--components", action="store_true",
                    help="encode_block128, apply_mlp, fused_mlp_backward "
                         "alone")
    ap.add_argument("--launch_points", type=int, nargs="*",
                    default=[49152, 98304, 196608, 393216])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    from keras_nerf_tpu_torch.models import NeRFConfig, engine

    args = build_arg_parser().parse_args(argv)
    device, card = timing.start(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NeRFConfig(white_background=True)
    _, params = engine.init_params(torch.Generator(device=device)
                                   .manual_seed(0), cfg, device)
    out = {"card": card, "rays": args.rays, "samples": args.samples}
    if args.components:
        out["components"] = component_readings(
            cfg, params, args.rays, args.samples, args.launch_points,
            args.iters, device)
    else:
        out["chunk"] = chunk_readings(cfg, params, args.rays, args.samples,
                                      args.iters, device)
        out["train_step"] = step_readings(cfg, args.img_wh, args.chunks,
                                          args.iters, device)
    print(json.dumps({"profile_pallas": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
