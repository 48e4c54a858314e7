"""Time the ``ray_march_mlp_int8`` kernel (T4, the int8 render tier's MLP)
on the card, in turns against another build of its source and against
PyTorch's own calls for the same int8 MLP.

    python -m keras_nerf_tpu_torch.time_ray_march_mlp_int8 [--parent DIR] \\
        [--units 256,512,768] [--iters 20] [--out FILE]

``DIR`` is the ``keras_nerf_tpu_torch/kernels/csrc`` directory of another
checkout (the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists): its ``ray_march_mlp_int8.cu`` is compiled
alone, with this package's ``nvcc`` flags, into a library with the same C
entry point, and launched through this package's wrapper (the same checks,
struct and transposed weights). The 8-layer MLP of each of ``--units`` (256
by default; seed-0 weights, sigma bias +1: a fog) is quantized on the card from the timed points themselves
(``collect_act_amax``, ``quantize_packed``), and the kernel is timed at the
render chunk's shapes (:data:`SHAPES`): sigma-only [4096 x 64] (the coarse
pass) and full [4096 x 192] (the fine pass). At each it runs in turns:
parent, this tree, the PyTorch chain, this tree, parent; device ms per
launch by CUDA events over ``iters`` launches, with a spin kernel holding
the stream while the host enqueues them (``time_mlp_backward.time_ms``).
Each build is first held against the plain version (largest absolute
error). The card's name and power limit, and its clocks and power before
and after the turns, come from ``nvidia-smi``. Prints one line per turn and
the whole as JSON (also to ``FILE``). Without ``--parent`` the parent's
turns are left out. Needs a card.

The PyTorch chain (:func:`pytorch_chain`) is the yardstick: one
``torch._int_mm`` (int8 x int8 -> int32) per product with PyTorch's own
float32 epilogues (dequantize, add, bias, relu, requantize to int8 codes),
over a float32 encoding made before the timed calls; the heads take the
first 8 columns of ``w_sig`` and ``w_rgb`` (``_int_mm`` needs a multiple
of 8). A chain of calls, not one library call, and never called by the
port.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from keras_nerf_tpu_torch.kernels import _build
from keras_nerf_tpu_torch.kernels import quantize as tq
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.time_mlp_backward import _smi, time_ms
from keras_nerf_tpu_torch.time_ray_march_mlp import make_inputs

# label: (sigma_only, rays, samples), the render chunk's coarse and fine
# passes.
SHAPES = {
    "render sigma-only [4096 x 64]": (True, 4096, 64),
    "render full [4096 x 192]": (False, 4096, 192),
}
ENTRIES = ("knt_ray_march_mlp_int8",)


def pytorch_chain(q: dict, enc: torch.Tensor, sigma_only=False):
    """A callable running ``forward_core_int8`` as PyTorch's own calls on
    the card over ``enc [P, 128]`` float32: per product one
    ``torch._int_mm`` of int8 codes by the int8 weights (their transposed
    copies, read as column-major ``[fan_in, fan_out]``), then float32
    dequantization, the encoding's product where the layer has one, bias,
    relu and the next codes; sigma and rgb as products over the first 8
    columns of ``w_sig`` and ``w_rgb``, with relu and sigmoid."""
    t = tq.transposed_int8_weights(q)

    def codes(x, r):
        return tq._quant_act(x, r).to(torch.int8)

    def mm(x, wt, n=None):
        w = wt.t() if n is None else wt[:n].t()
        return torch._int_mm(x, w).float()

    heads = {k: t[k][:8].contiguous() for k in ("w_sig", "w_rgb")}
    last_enc = q["w_sig_enc"] is not None
    sig_enc = t["w_sig_enc"][:8].contiguous() if last_enc else None

    def run():
        hq = codes(enc, q["enc_r"][0])
        for i, w in enumerate(t["trunk_w"]):
            acc = mm(hq, w) * q["trunk_u"][i]
            if i > 0 and t["trunk_enc_w"][i] is not None:
                acc = acc + (mm(codes(enc, q["enc_r"][i]),
                                t["trunk_enc_w"][i]) * q["trunk_enc_u"][i])
            hq = codes(torch.relu(acc + q["trunk_b"][i]), q["trunk_r"][i])
        eq = codes(enc, q["enc_r_sf"]) if last_enc else None
        sigma = mm(hq, heads["w_sig"])[:, :1] * q["u_sig"][:, :1]
        if last_enc:
            sigma = sigma + mm(eq, sig_enc)[:, :1] * q["u_sig_enc"][:, :1]
        sigma = torch.relu(sigma + q["b_sig"][:, :1])[:, 0]
        if sigma_only:
            return sigma
        feat = mm(hq, t["w_feat"]) * q["u_feat"]
        if last_enc:
            feat = feat + mm(eq, t["w_feat_enc"]) * q["u_feat_enc"]
        fq = codes(feat + q["b_feat"], q["r_feat"])
        rf = (mm(fq, t["w_rf_top"]) * q["u_rf_top"]
              + mm(codes(enc, q["enc_r_rf"]), t["w_rf_enc"]) * q["u_rf_enc"]
              + q["b_rf"])
        rgb = torch.sigmoid(mm(codes(rf, q["r_rf"]), heads["w_rgb"])[:, :3]
                            * q["u_rgb"][:, :3] + q["b_rgb"][:, :3])
        return torch.cat([rgb, sigma[:, None]], dim=1)
    return run


def measure(parent: Path | None = None, iters: int = 20,
            units=(256,)) -> dict:
    """The turns at every shape and width; see the module's text."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_ray_march_mlp_int8 needs an NVIDIA card")
    dev = torch.device("cuda")
    lib = None if parent is None else _build.build_single(
        parent / "ray_march_mlp_int8.cu",
        _build.BUILD_ROOT.parent / "parent_ray_march_mlp_int8", ENTRIES)
    q_smi = "clocks.sm,power.draw,power.limit,temperature.gpu"
    out = {"card": _smi("name,power.limit"), "clocks": [
        {"when": "before the turns", q_smi: _smi(q_smi)}], "turns": {},
        "errors": {}}
    builds = {"new": None} if lib is None else {"new": None, "parent": lib}
    for width, (key, (sigma_only, rays, samples)) in (
            (w, item) for w in units for item in SHAPES.items()):
        key = f"{key} at u {width}"
        cfg, packed, rm_args, enc = make_inputs(rays, samples, dev,
                                                units=width)
        q = tq.quantize_packed(packed, tq.collect_act_amax(packed, enc,
                                                           cfg.mlp), cfg.mlp)
        tq.transposed_int8_weights(q)

        def call(lb):
            return trm._ray_march_mlp_int8_cuda(q, *rm_args,
                                                sigma_only=sigma_only, lib=lb)

        want = trm.ray_march_mlp_int8_plain(q, *rm_args, sigma_only=sigma_only)
        for label, lb in builds.items():
            got = call(lb)
            torch.cuda.synchronize()
            out["errors"][f"{key} {label}"] = {
                "out_abs_max": float((got - want).abs().max())}
        enc32 = trm.encode_points_f32(*rm_args).reshape(-1, trm.LANE)
        chain = pytorch_chain(q, enc32, sigma_only=sigma_only)
        order = (["parent"] if lib is not None else []) + [
            "new", "pytorch chain", "new"] + (
            ["parent"] if lib is not None else [])
        times = []
        for label in order:
            fn = chain if label == "pytorch chain" else (
                lambda lb=builds[label]: call(lb))
            ms = time_ms(fn, iters)
            times.append((label, ms))
            print(f"turn {key} {label}: {ms:.4f} ms/launch", flush=True)
        out["turns"][key] = times
        del want, chain, enc32, q
        torch.cuda.empty_cache()
    out["clocks"].append({"when": "after the turns", q_smi: _smi(q_smi)})
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
