"""Time the ``ray_march_mlp`` kernel (and ``apply_mlp``, its input mode) on
the card, in turns against another build of its source and against
PyTorch's own calls for the same MLP.

    python -m keras_nerf_tpu_torch.time_ray_march_mlp [--parent DIR] \\
        [--units 256,512,768] [--iters 20] [--out FILE]

``DIR`` is the ``keras_nerf_tpu_torch/kernels/csrc`` directory of another
checkout (the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists): its ``ray_march_mlp.cu`` is compiled alone,
with this package's ``nvcc`` flags, into a library with the same C entry
points, and launched through this package's wrappers (the same argument
checks and structs). On the 8-layer MLP of each of ``--units`` (256 by
default; seed-0 weights, sigma bias +1: a fog) it times every mode at the
shapes of its path (:data:`SHAPES`): the
training chunk's train mode at [2048 x 64] and [2048 x 192], the render
chunk's sigma-only [4096 x 64] and full [4096 x 192] modes, and
``apply_mlp`` without and with its stash at 131,072 and 393,216 points.
At each it runs in turns: parent, this tree, this tree's streamed route
(the kernel that the plans pick past u = 768 or 16 layers, whose weights'
tensor maps come from a device table, forced here at the resident route's
shapes), the PyTorch chain, the streamed route, this tree, parent; in the
sigma-only and full modes, whose plan at u = 256 is the persistent route,
this tree's resident kernel too, after the streamed route and before the
chain, and the parent's build runs its resident kernel; device
ms per launch by CUDA events over ``iters`` launches, with a
spin kernel holding the stream while the host enqueues them
(``time_mlp_backward.time_ms``). Each build is first held against the
plain version (largest absolute error of the outputs, relative max of
every stash block). The card's name and power limit, and its clocks and
power before and after the turns, come from ``nvidia-smi``. Prints one
line per turn and the whole as JSON (also to ``FILE``). Without
``--parent`` the parent's turns are left out. Needs a card.

The PyTorch chain (:func:`pytorch_chain`) is the yardstick: one bf16
``torch.matmul`` per layer (cuBLAS, float32 sums rounded once to bf16)
with the float32 bias, relu and bf16 casts, over an encoding made before
the timed calls; a chain of calls, not one library call, and never called
by the port.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from keras_nerf_tpu_torch.kernels import _build
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRFConfig, init_mlp
from keras_nerf_tpu_torch.time_mlp_backward import _rel_max, _smi, time_ms

# label: (mode, rays, samples); the apply_mlp shapes are the custom-loss
# step's coarse and fine passes, 2048 rays x 64 and x 192 points.
SHAPES = {
    "train [2048 x 64]": ("train", 2048, 64),
    "train [2048 x 192]": ("train", 2048, 192),
    "render sigma-only [4096 x 64]": ("sigma_only", 4096, 64),
    "render full [4096 x 192]": ("full", 4096, 192),
    "apply_mlp [131072]": ("input", 2048, 64),
    "apply_mlp with a stash [131072]": ("input_stash", 2048, 64),
    "apply_mlp [393216]": ("input", 2048, 192),
    "apply_mlp with a stash [393216]": ("input_stash", 2048, 192),
}
ENTRIES = ("knt_ray_march_mlp", "knt_apply_mlp")


def pytorch_chain(packed: dict, enc: torch.Tensor, sigma_only=False):
    """A callable running ``ray_march_mlp``'s MLP as PyTorch's own calls on
    the card, over ``enc [P, 128]`` bf16: per trunk layer one bf16
    ``torch.matmul`` (over ``[h | enc]`` with the weights concatenated
    beforehand where the layer skips), the float32 bias, relu and a bf16
    cast; then sigma (and the features) as one product over ``w_sf``'s
    columns, rf, and rgb over ``w_rgb[:, :3]`` with a sigmoid."""
    bf16 = torch.bfloat16
    u = packed["trunk_b"][0].shape[1]

    def cat_rows(w, w_enc):
        return w if w_enc is None else torch.cat([w, w_enc]).contiguous()

    trunk = [(cat_rows(w, we), we is not None, b) for w, we, b in
             zip(packed["trunk_w"], packed["trunk_enc_w"], packed["trunk_b"])]
    sf_skip = packed["w_sf_enc"] is not None
    cols = slice(u, u + 1) if sigma_only else slice(0, u + 1)
    w_sf = cat_rows(packed["w_sf"], packed["w_sf_enc"])[:, cols].contiguous()
    b_sf = packed["b_sf"][:, cols]
    w_rf = torch.cat([packed["w_rf_top"], packed["w_rf_enc"]])
    w_rgb = packed["w_rgb"][:, :3].contiguous()

    def run():
        h = enc
        for w, skip, b in trunk:
            x = torch.cat([h, enc], dim=1) if skip else h
            h = torch.relu(torch.matmul(x, w).float() + b).to(bf16)
        x = torch.cat([h, enc], dim=1) if sf_skip else h
        sf = torch.matmul(x, w_sf).float() + b_sf
        sigma = torch.relu(sf[:, -1])
        if sigma_only:
            return sigma
        features = sf[:, :u].to(bf16)
        rf = (torch.matmul(torch.cat([features, enc], dim=1), w_rf).float()
              + packed["b_rf"]).to(bf16)
        rgb = torch.sigmoid(torch.matmul(rf, w_rgb).float()
                            + packed["b_rgb"][:, :3])
        return torch.cat([rgb, sigma[:, None]], dim=1)
    return run


def make_inputs(rays: int, samples: int, device, seed: int = 0,
                units: int = 256):
    """Seeded fog weights of the 8-layer MLP of width ``units``, random
    rays' encoding coefficients and sorted depths, and the same points
    encoded outside the kernel (``encode_block128``)."""
    cfg = NeRFConfig(dense_units=units)
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


STREAMED = "streamed"   # the label of this tree's streamed route
RESIDENT = "resident"   # this tree's resident kernel where the plan persists


def _call(mode: str, packed, rm_args, enc, stash, lib=None, plain=False):
    """One launch of ``mode`` through this package's wrapper, on ``lib``'s
    build (None: this package's library; :data:`STREAMED`: its streamed
    route, whatever the shape; :data:`RESIDENT`: its resident kernel; a
    parent's build: its resident kernel, the only one it has in every
    mode), or the plain version."""
    if mode in ("sigma_only", "full", "train"):
        kw = dict(sigma_only=mode == "sigma_only",
                  stash=stash if mode == "train" else None)
        if plain:
            return trm.ray_march_mlp_plain(packed, *rm_args, **kw)
        if lib == STREAMED:
            return trm._mlp_streamed(packed, enc.device, _build.load(),
                                     points=rm_args, **kw)
        if lib is not None:
            kw["route"] = "resident"
        return trm._ray_march_mlp_cuda(
            packed, *rm_args, lib=None if lib == RESIDENT else lib, **kw)
    st = stash if mode == "input_stash" else None
    if plain:
        return trm.apply_mlp_plain(packed, enc, stash=st)
    if lib == STREAMED:
        return trm._mlp_streamed(packed, enc.device, _build.load(), stash=st,
                                 enc=enc)
    return trm._apply_mlp_cuda(packed, enc, stash=st, lib=lib)


def _stash_blocks(stash: dict) -> list:
    return [stash["features"], stash["rf"], *stash["h"]]


def measure(parent: Path | None = None, iters: int = 20,
            units=(256,)) -> dict:
    """The turns at every shape and width; see the module's text."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_ray_march_mlp needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lib = None if parent is None else _build.build_single(
        parent / "ray_march_mlp.cu",
        _build.BUILD_ROOT.parent / "parent_ray_march_mlp", ENTRIES)
    q = "clocks.sm,power.draw,power.limit,temperature.gpu"
    out = {"card": _smi("name,power.limit"), "clocks": [
        {"when": "before the turns", q: _smi(q)}], "turns": {}, "errors": {}}
    builds = {"new": None, STREAMED: STREAMED, RESIDENT: RESIDENT}
    if lib is not None:
        builds["parent"] = lib
    for width, (key, (mode, rays, samples)) in (
            (w, item) for w in units for item in SHAPES.items()):
        key = f"{key} at u {width}"
        cfg, packed, rm_args, enc = make_inputs(rays, samples, dev,
                                                units=width)
        u, n, p = cfg.dense_units, cfg.n_layers, rays * samples
        stash = (trm.alloc_stash(p, u, n, dev, enc=enc) if mode ==
                 "input_stash" else trm.alloc_stash(p, u, n, dev))
        want_stash = (trm.alloc_stash(p, u, n, dev, enc=enc) if mode ==
                      "input_stash" else trm.alloc_stash(p, u, n, dev))
        want = _call(mode, packed, rm_args, enc, want_stash, plain=True)
        persists = mode in ("sigma_only", "full") and trm.ray_march_mlp_plan(
            u, n, no_grad=True)["route"] == "persistent"
        for label, lb in builds.items():
            if label == RESIDENT and not persists:
                continue
            got = _call(mode, packed, rm_args, enc, stash, lib=lb)
            torch.cuda.synchronize()
            err = {"out_abs_max": float((got - want).abs().max())}
            if mode in ("train", "input_stash"):
                err["stash_rel_max"] = max(
                    _rel_max(a, b) for a, b in zip(_stash_blocks(stash),
                                                   _stash_blocks(want_stash)))
            out["errors"][f"{key} {label}"] = err
        chain_enc = (enc if mode.startswith("input") else
                     trm.encode_points(*rm_args[:3], rm_args[3]).reshape(
                         -1, trm.LANE))
        chain = pytorch_chain(packed, chain_enc,
                              sigma_only=mode == "sigma_only")
        middle = [STREAMED] + ([RESIDENT] if persists else [])
        order = (["parent"] if lib is not None else []) + [
            "new", *middle, "pytorch chain", *middle[::-1], "new"] + (
            ["parent"] if lib is not None else [])
        times = []
        for label in order:
            fn = chain if label == "pytorch chain" else (
                lambda lb=builds[label]: _call(mode, packed, rm_args, enc,
                                               stash, lib=lb))
            ms = time_ms(fn, iters)
            times.append((label, ms))
            print(f"turn {key} {label}: {ms:.4f} ms/launch", flush=True)
        out["turns"][key] = times
        del want, want_stash, stash, chain, chain_enc
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
