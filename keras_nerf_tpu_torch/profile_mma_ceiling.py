"""Measure the tensor-core ceiling of the ``wmma`` product loop on the card
(port of the root ``scripts/profile_mxu_ceiling.py``).

    python -m keras_nerf_tpu_torch.profile_mma_ceiling [--t 1536] [--u 256] \\
        [--rep 16] [--grid 128] [--iters 10]

The ``mma_ceiling`` kernel (``kernels/csrc/mma_ceiling.cu``) runs nothing
but the trunk's product chain: ``[T, u] @ [u, u]`` bf16 products with
float32 accumulation over 8 resident weights, ``rep`` passes, on ``grid``
tiles of ``T`` rows made from an iota, with the convert-only (``bare``) or
the bias + relu + convert (``epi``) epilogue. It uses the design that the
MLP kernels ran before they moved to ``wgmma`` (64-row tiles in shared
memory, weights as ``wmma`` fragments from L2, ``csrc/mlp.cuh``), so its
rate is the ceiling of that design's product loop, without the encoding,
the heads or the quadrature. Prints per mode the device ms per
call (CUDA events) and TFLOP/s against the 989 TFLOP/s dense bf16 peak,
with the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from keras_nerf_tpu_torch.device import resolve_device
from keras_nerf_tpu_torch.kernels.ceiling import MODES, ceiling_flop, make_inputs
from keras_nerf_tpu_torch.kernels.ray_march import mma_ceiling

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak, 700 W


def measure(t: int = 1536, u: int = 256, rep: int = 16, grid: int = 128,
            iters: int = 10) -> list[dict]:
    """One warm-up call and ``iters`` timed calls of each mode on the
    card: ``{"mode", "T", "U", "rep", "grid", "ms", "tflops",
    "share_of_peak"}`` per mode, ``ms`` the device time of one call."""
    device = resolve_device("cuda")
    ws, bs, seed = make_inputs(grid, u, device)
    flop = ceiling_flop(grid, t, u, rep)
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
        ms = start.elapsed_time(end) / iters
        tflops = flop / ms / 1e9
        rows.append({"mode": mode, "T": t, "U": u, "rep": rep, "grid": grid,
                     "ms": ms, "tflops": tflops,
                     "share_of_peak": tflops * 1e12 / PEAK_BF16_FLOPS})
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--t", type=int, default=1536,
                   help="rows per grid step (a multiple of 64)")
    p.add_argument("--u", type=int, default=256,
                   help="width (a multiple of 128, at most 512)")
    p.add_argument("--rep", type=int, default=16)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    rows = measure(args.t, args.u, args.rep, args.grid, args.iters)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for r in rows:
        print(f"{r['mode']:5s} T={r['T']} U={r['U']} rep={r['rep']} "
              f"grid={r['grid']}: {r['ms']:8.3f} ms  {r['tflops']:7.1f} TFLOP/s"
              f" ({100 * r['share_of_peak']:.1f}% of 989 TFLOP/s) [{card}]")
    return rows


if __name__ == "__main__":
    main()
