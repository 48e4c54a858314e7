"""Time the ``mlp_backward`` kernel on the card, in turns against another
build of its source and against PyTorch's own calls for the same chain.

    python -m keras_nerf_tpu_torch.time_mlp_backward [--parent DIR] \\
        [--units 256,512,768] [--iters 20] [--out FILE]

``DIR`` is the ``keras_nerf_tpu_torch/kernels/csrc`` directory of another
checkout (the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists): its ``mlp_backward.cu`` is compiled alone, with
this package's ``nvcc`` flags, into a library with the same C entry points,
and launched through this package's wrapper (the same argument checks and
structs). At the training chunk's coarse and fine launches, [2048 x 64] and
[2048 x 192] points of the 8-layer MLP of each of ``--units`` (256 by
default), and in both modes (quadrature,
output head), it times in turns: parent, this tree, this tree's streamed
route (the kernel that the plan picks past u = 768 or 16 layers, forced
here at the resident route's shapes), the PyTorch chain, the streamed
route, this tree, parent; device ms per launch by CUDA events over ``iters`` launches,
with a spin kernel holding the stream while the host enqueues them (as
``chip_smoke.py`` times). Each build is first held against the plain
version (relative max of every cotangent). The card's name and power
limit, and its clocks and power before and after the turns, come from
``nvidia-smi``. Prints one line per turn and the whole as JSON (also to
``FILE``). Without ``--parent`` the parent's turns are left out. Needs a
card.

The PyTorch chain (:func:`pytorch_chain`) is the yardstick: one bf16
``torch.matmul`` per layer (cuBLAS, float32 sums rounded once to bf16),
``torch.where`` for the masks and the bf16 casts; a chain of calls, not
one library call, and never called by the port.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from keras_nerf_tpu_torch.kernels import _build
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRFConfig, init_mlp

SHAPES = {"coarse [2048 x 64]": 2048 * 64, "fine [2048 x 192]": 2048 * 192}
MODES = ("quadrature", "output head")


def pytorch_chain(a, b, packed: dict, stash: dict, from_output=False):
    """A callable running ``mlp_backward``'s function as PyTorch's own
    calls on the card: the head step (output-head mode) as elementwise
    ops, then one bf16 ``torch.matmul`` per layer, ``torch.where`` for each
    relu mask. ``(a, b)`` are ``(d_rgb, d_sigma)`` or, with
    ``from_output``, ``(g, y)``."""
    u = packed["trunk_b"][0].shape[1]
    n = len(packed["trunk_w"])
    w_rgb = packed["w_rgb"][:, :trm.D_HEAD].T
    w_sf = packed["w_sf"][:, :u + trm.D_HEAD].T
    pad = torch.zeros((a.shape[0], trm.D_HEAD - 1), dtype=torch.bfloat16,
                      device=a.device)

    def run():
        d_rgb, d_sigma = (trm.output_head_cotangents(a, b) if from_output
                          else (a, b))
        d_rf = torch.matmul(d_rgb, w_rgb)
        d_features = torch.matmul(d_rf, packed["w_rf_top"].T)
        d_sf = torch.cat([d_features, d_sigma[:, None], pad], dim=1)
        d_h = torch.matmul(d_sf, w_sf)
        d_pre = []
        for i in reversed(range(n)):
            d_pre.append(torch.where(stash["h"][i] > 0, d_h, 0.0))
            if i > 0:
                d_h = torch.matmul(d_pre[-1], packed["trunk_w"][i].T)
        return d_rf, d_sf, d_pre
    return run


def make_inputs(points: int, device, seed: int = 0, units: int = 256):
    """Seeded weights of the 8-layer MLP of width ``units``, a random stash
    (about half of each h_i above zero) and the head inputs of both
    modes."""
    cfg = NeRFConfig(dense_units=units)
    g = torch.Generator(device=device).manual_seed(seed)
    packed = trm.pack_mlp_params(init_mlp(g, cfg.mlp, cfg.in_xyz,
                                          cfg.in_dir), cfg.mlp, 10, 4)
    stash = trm.alloc_stash(points, cfg.dense_units, cfg.n_layers, device)
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
    return packed, stash, {"quadrature": (d_rgb, d_sigma),
                           "output head": (out_g, y)}


def time_ms(fn, iters: int) -> float:
    """Device ms per call: a spin kernel holds the stream while the host
    enqueues ``iters`` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    torch.cuda._sleep(int(2e9 * (2 * iters * host_s + 1e-3)))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _rel_max(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def measure(parent: Path | None = None, iters: int = 20,
            units=(256,)) -> dict:
    """The turns at both shapes in both modes at each width; see the
    module's text."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_mlp_backward needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lib = None if parent is None else _build.build_single(
        parent / "mlp_backward.cu",
        _build.BUILD_ROOT.parent / "parent_mlp_backward",
        ("knt_mlp_backward", "knt_mlp_backward_from_output"))
    q = "clocks.sm,power.draw,power.limit,temperature.gpu"
    out = {"card": _smi("name,power.limit"), "clocks": [
        {"when": "before the turns", q: _smi(q)}], "turns": {}, "errors": {}}
    builds = {"new": None, "streamed": "streamed"}
    if lib is not None:
        builds["parent"] = lib
    for width, (shape, points) in (
            (w, item) for w in units for item in SHAPES.items()):
        packed, stash, heads = make_inputs(points, dev, units=width)
        cots = trm.alloc_cotangents(points, width, 8, dev)
        for mode in MODES:
            a, b = heads[mode]
            fo = mode == "output head"
            key = f"{shape} {mode} at u {width}"
            want = trm.mlp_backward_plain(a, b, packed, stash,
                                          from_output=fo)
            calls = {label: (lambda lb=lb: trm._mlp_backward_cuda(
                a, b, packed, stash, cots, from_output=fo, lib=lb))
                for label, lb in builds.items() if label != "streamed"}
            calls["streamed"] = lambda: trm._mlp_backward_streamed(
                a, b, packed, stash, cots, fo, _build.load())
            for label, call in calls.items():
                got = call()
                torch.cuda.synchronize()
                out["errors"][f"{key} {label}"] = {
                    "heads_rel_max": max(_rel_max(got[k], want[k]) for k in
                                         ("d_rgb", "d_rf", "d_sf")),
                    "d_pre_rel_max": max(_rel_max(x, y) for x, y in
                                         zip(got["d_pre"], want["d_pre"]))}
            chain = pytorch_chain(a, b, packed, stash, from_output=fo)
            order = (["parent"] if lib is not None else []) + [
                "new", "streamed", "pytorch chain", "streamed", "new"] + (
                ["parent"] if lib is not None else [])
            times = []
            for label in order:
                fn = chain if label == "pytorch chain" else calls[label]
                ms = time_ms(fn, iters)
                times.append((label, ms))
                print(f"turn {key} {label}: {ms:.4f} ms/launch", flush=True)
            out["turns"][key] = times
            del want
        del packed, stash, heads, cots
        torch.cuda.empty_cache()
    out["clocks"].append({"when": "after the turns", q: _smi(q)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="kernels/csrc directory of another checkout")
    ap.add_argument("--units", default="256",
                    help="comma-separated widths of the 8-layer MLP")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    res = measure(args.parent, args.iters,
                  tuple(int(x) for x in args.units.split(",")))
    text = json.dumps(res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
