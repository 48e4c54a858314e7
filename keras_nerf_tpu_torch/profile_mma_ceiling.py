"""Measure the tensor-core ceiling of the ``wgmma`` product loop on the card
(port of the root ``scripts/profile_mxu_ceiling.py``).

    python -m keras_nerf_tpu_torch.profile_mma_ceiling [--t 1536] [--u 256] \\
        [--rep 16] [--grid 128] [--iters 10] [--parent DIR] [--out FILE]

The ``mma_ceiling`` kernel (``kernels/csrc/mma_ceiling.cu``) runs nothing
but the trunk's product chain: ``[T, u] @ [u, u]`` bf16 products with
float32 accumulation over 8 resident weights, ``rep`` passes, on ``grid``
tiles of ``T`` rows made from an iota, with the convert-only (``bare``) or
the bias + relu + convert (``epi``) epilogue. It runs the loop of the MLP
kernels' trunk (``ray_march_mlp.cu``: activation tiles in shared memory,
weights streamed by TMA through a ring of stages, ``wgmma`` from
``csrc/gmma.cuh``), so its rate is the ceiling of the product loop those
kernels run, without the encoding, the heads or a stash. Prints per mode
the device ms per call (CUDA events), TFLOP/s against the 989 TFLOP/s
dense bf16 peak, and the rate at which the call streams its weights from
L2 (every block reads each weight once a layer), with the card's name and
power limit.

With ``--parent DIR`` (the ``keras_nerf_tpu_torch/kernels/csrc`` directory
of another checkout, unpacked with ``git archive`` into a directory that
``.gitignore`` lists), that checkout's ``mma_ceiling.cu`` is compiled alone
(``_build.build_single``) and launched through this package's wrapper: per
mode the parent's build and this tree's in turns (parent, new, new,
parent), each first held against the plain version, then the PyTorch chain
of the same function (``kernels/ceiling.py:pytorch_chain``: 8 rep bf16
``torch.mm`` calls with the epilogue in PyTorch ops, a yardstick the port
never calls), all timed by CUDA events with a spin kernel holding the
stream (``time_mlp_backward.time_ms``). Needs a card.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from keras_nerf_tpu_torch.device import resolve_device
from keras_nerf_tpu_torch.kernels import _build
from keras_nerf_tpu_torch.kernels.ceiling import (
    MODES,
    ceiling_flop,
    ceiling_weight_bytes,
    make_inputs,
    mma_ceiling_cuda,
    pytorch_chain,
)
from keras_nerf_tpu_torch.kernels.ray_march import mma_ceiling
from keras_nerf_tpu_torch.time_mlp_backward import _rel_max, _smi, time_ms

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak, 700 W


def _rates(ms: float, flop: int, weight_bytes: int) -> dict:
    tflops = flop / ms / 1e9
    return {"ms": ms, "tflops": tflops,
            "share_of_peak": tflops * 1e12 / PEAK_BF16_FLOPS,
            "l2_weight_tbps": weight_bytes / ms / 1e9}


def measure(t: int = 1536, u: int = 256, rep: int = 16, grid: int = 128,
            iters: int = 10) -> list[dict]:
    """One warm-up call and ``iters`` timed calls of each mode on the
    card: ``{"mode", "T", "U", "rep", "grid", "ms", "tflops",
    "share_of_peak", "l2_weight_tbps"}`` per mode, ``ms`` the device time
    of one call."""
    device = resolve_device("cuda")
    ws, bs, seed = make_inputs(grid, u, device)
    flop = ceiling_flop(grid, t, u, rep)
    weight_bytes = ceiling_weight_bytes(grid, t, u, rep)
    rows = []
    for mode in MODES:
        mma_ceiling(ws, bs, seed, t, rep, mode)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            mma_ceiling(ws, bs, seed, t, rep, mode)
        end.record()
        end.synchronize()
        rows.append({"mode": mode, "T": t, "U": u, "rep": rep, "grid": grid,
                     **_rates(start.elapsed_time(end) / iters, flop,
                              weight_bytes)})
    return rows


def turns(parent: Path, t: int = 1536, u: int = 256, rep: int = 16,
          grid: int = 128, iters: int = 10) -> dict:
    """The parent's build and this tree's in turns, and the PyTorch chain,
    per mode; each build first held against the plain version (relative
    max) and run twice (identical bits or not)."""
    device = resolve_device("cuda")
    _build.load()
    out_dir = _build.BUILD_ROOT.parent / "parent_mma_ceiling"
    lib = _build.build_single(parent / "mma_ceiling.cu", out_dir,
                              ("knt_mma_ceiling",))
    ws, bs, seed = make_inputs(grid, u, device, seed=1, bias_scale=0.05)
    seed += torch.arange(grid, device=device).repeat_interleave(8)[
        :, None] * 1e-2
    flop = ceiling_flop(grid, t, u, rep)
    weight_bytes = ceiling_weight_bytes(grid, t, u, rep)
    out = {"card": _smi("name,power.limit"), "modes": {}}
    for mode in MODES:
        builds = {
            "parent": lambda: mma_ceiling_cuda(ws, bs, seed, t, rep, mode,
                                               lib=lib),
            "new": lambda: mma_ceiling_cuda(ws, bs, seed, t, rep, mode)}
        row = {"checks": {}, "turns": []}
        want = mma_ceiling.plain(ws, bs, seed, t, rep, mode)
        for label, fn in builds.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            row["checks"][label] = {"rel_max": _rel_max(got, want),
                                    "identical_twice": torch.equal(got,
                                                                   again)}
        for label in ("parent", "new", "new", "parent"):
            ms = time_ms(builds[label], iters)
            row["turns"].append({"build": label,
                                 **_rates(ms, flop, weight_bytes)})
        row["pytorch_chain"] = _rates(time_ms(
            lambda: pytorch_chain(ws, bs, seed, t, rep, mode), iters), flop,
            weight_bytes)
        out["modes"][mode] = row
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--t", type=int, default=1536,
                   help="rows per grid step (a multiple of 64)")
    p.add_argument("--u", type=int, default=256,
                   help="width (a multiple of 128, at most 512)")
    p.add_argument("--rep", type=int, default=16)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--parent", type=Path, default=None,
                   help="kernels/csrc directory of another checkout")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    shape = dict(t=args.t, u=args.u, rep=args.rep, grid=args.grid,
                 iters=args.iters)
    card = _smi("name,power.limit")
    rows = measure(**shape)
    for r in rows:
        print(f"{r['mode']:5s} T={r['T']} U={r['U']} rep={r['rep']} "
              f"grid={r['grid']}: {r['ms']:8.3f} ms  {r['tflops']:7.1f} "
              f"TFLOP/s ({100 * r['share_of_peak']:.1f}% of 989 TFLOP/s), "
              f"weights from L2 {r['l2_weight_tbps']:.2f} TB/s [{card}]")
    result = {"card": card, "rows": rows}
    if args.parent is not None:
        result["turns"] = turns(args.parent, **shape)
        for mode, row in result["turns"]["modes"].items():
            print(f"{mode:5s} checks {row['checks']}")
            for r in row["turns"] + [{"build": "PyTorch chain",
                                      **row["pytorch_chain"]}]:
                print(f"{mode:5s} {r['build']:13s} {r['ms']:8.3f} ms  "
                      f"{r['tflops']:7.1f} TFLOP/s ({100 * r['share_of_peak']:.1f}"
                      f"% of 989), weights from L2 {r['l2_weight_tbps']:.2f} "
                      f"TB/s [{result['turns']['card']}]")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result) + "\n")
    return rows


if __name__ == "__main__":
    main()
