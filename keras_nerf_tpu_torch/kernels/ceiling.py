"""The tensor-core ceiling probe (port of the TPU kernel of
``scripts/profile_mxu_ceiling.py``): a compute-only chain of
``[T, u] @ [u, u]`` bf16 products with float32 accumulation over ``L = 8``
resident weights, ``rep`` passes, its input made from an iota and only an
``[8, 128]`` slice per grid step written out.

:func:`mma_ceiling_plain` is the plain version of the ``mma_ceiling``
kernel (``csrc/mma_ceiling.cu``), which ``kernels/ray_march.py`` wraps;
``python -m keras_nerf_tpu_torch.profile_mma_ceiling`` times it. The probe
lies on no path of the package: it measures the ceiling of the ``wgmma``
product loop (``csrc/gmma.cuh``) that the MLP kernels run, their trunk's
loop without the encoding, the heads or a stash. :func:`pytorch_chain` is
the same chain in PyTorch ops, a yardstick the package never calls.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

LAYERS = 8                 # csrc/mma_ceiling.cu: kLayers
MODES = ("bare", "epi")    # convert only; bias + relu + convert
_IOTA_SCALE = float(np.float32(1e-4))


def ceiling_flop(steps: int, t: int, u: int, rep: int) -> int:
    """FLOPs of one call: ``2 T u^2`` per layer, ``L rep`` layers per grid
    step (`profile_mxu_ceiling.py:107`)."""
    return 2 * steps * t * u * u * LAYERS * rep


def ceiling_tile(u: int) -> int:
    """Rows a block of the kernel owns (csrc/mma_ceiling.cu: tile_of): 64
    at u = 512, where its two warpgroups split the columns, else 128."""
    return 64 if u == 512 else 128


def ceiling_weight_bytes(steps: int, t: int, u: int, rep: int) -> int:
    """Bytes of weights one call streams from L2 into shared memory: every
    block of ``ceiling_tile(u)`` rows reads each ``[u, u]`` bf16 weight once
    a layer."""
    blocks = steps * -(-t // ceiling_tile(u))
    return blocks * rep * LAYERS * u * u * 2


def _check_args(ws, bs, seed, t: int, rep: int, mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if len(ws) != LAYERS or len(bs) != LAYERS:
        raise ValueError(f"the probe takes {LAYERS} weights and biases")
    u = ws[0].shape[0]
    if t <= 0 or t % 64 or u % 128 or not 128 <= u <= 512 or rep < 0:
        raise ValueError(f"T must be a positive multiple of 64 and u a "
                         f"multiple of 128 in [128, 512] (got T={t}, u={u}, "
                         f"rep={rep})")
    if seed.dim() != 2 or seed.shape[0] % 8 or seed.shape[1] != 128:
        raise ValueError(f"seed must be [steps * 8, 128], got "
                         f"{tuple(seed.shape)}")
    return u


def mma_ceiling_plain(ws: list, bs: list, seed: torch.Tensor, t: int,
                      rep: int, mode: str = "bare",
                      sums: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the ``mma_ceiling`` kernel: per grid step ``g``
    (``seed [steps * 8, 128]``), ``h = bf16(iota(T) * 1e-4 + seed[8 g, 0])``
    broadcast over ``u`` columns, ``rep`` passes over the weights ``ws``
    (``[u, u]`` bf16) with float32 products, ``bf16(acc)`` ("bare") or
    ``bf16(relu(acc + b))`` ("epi"); returns ``h[:, :8, :128]`` as float32
    ``[steps * 8, 128]``. ``sums=torch.float64`` takes the products and
    the bias in float64 before each bf16 rounding: another valid order of
    the same sums, the reference of how far two orders drift at depth."""
    u = _check_args(ws, bs, seed, t, rep, mode)
    steps = seed.shape[0] // 8
    io = torch.arange(t, dtype=torch.float32, device=seed.device) * _IOTA_SCALE
    h = (io[None, :, None] + seed[::8, :1, None]).expand(steps, t, u)
    h = h.to(torch.bfloat16)
    for _ in range(rep):
        for w, b in zip(ws, bs):
            acc = h.to(sums) @ w.to(sums)
            if mode == "epi":
                acc = torch.relu(acc + b.to(sums))
            h = acc.to(torch.bfloat16)
    return h[:, :8, :128].float().reshape(steps * 8, 128)


def pytorch_chain(ws: list, bs: list, seed: torch.Tensor, t: int, rep: int,
                  mode: str = "bare") -> torch.Tensor:
    """The kernel's function as a chain of PyTorch ops: ``L rep`` bf16
    ``torch.mm`` calls of ``[steps T, u] @ [u, u]`` with float32 outputs
    (cuBLAS; reduced-precision reduction off), each followed by the float32
    bias, relu and bf16 rounding in PyTorch ops; returns what
    :func:`mma_ceiling_plain` returns. A yardstick (its time, and the
    tensor cores' own order of the sums) that the package never calls."""
    u = _check_args(ws, bs, seed, t, rep, mode)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        steps = seed.shape[0] // 8
        io = torch.arange(t, dtype=torch.float32,
                          device=seed.device) * _IOTA_SCALE
        h = (io[None, :, None] + seed[::8, :1, None]).expand(steps, t, u)
        h = h.reshape(steps * t, u).to(torch.bfloat16)
        for _ in range(rep):
            for w, b in zip(ws, bs):
                acc = torch.mm(h, w, out_dtype=torch.float32)
                if mode == "epi":
                    acc = torch.relu(acc + b)
                h = acc.to(torch.bfloat16)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
    return h.reshape(steps, t, u)[:, :8, :128].float().reshape(steps * 8, 128)


class _CeilingWeights(ctypes.Structure):
    """Mirror of ``struct CeilingWeights`` in csrc/mma_ceiling.cu."""

    _fields_ = [("w", ctypes.c_void_p * LAYERS),
                ("b", ctypes.c_void_p * LAYERS)]


def mma_ceiling_cuda(ws: list, bs: list, seed: torch.Tensor, t: int,
                     rep: int, mode: str = "bare", lib=None) -> torch.Tensor:
    """The ``mma_ceiling`` kernel's launch: arguments and result as
    :func:`mma_ceiling_plain`; ``lib`` another build of its C entry point
    (``profile_mma_ceiling --parent`` times a parent's kernel through it),
    else this package's library."""
    from keras_nerf_tpu_torch.kernels._build import load
    from keras_nerf_tpu_torch.kernels.ray_march import (
        _check,
        _raise_on_mapped,
        _stream,
    )

    lib = load() if lib is None else lib
    u = _check_args(ws, bs, seed, t, rep, mode)
    dev = seed.device
    cw = _CeilingWeights()
    for i, (w, b) in enumerate(zip(ws, bs)):
        cw.w[i] = _check(w, f"w[{i}]", torch.bfloat16, dev, (u, u))
        cw.b[i] = _check(b, f"b[{i}]", torch.float32, dev, (u,))
    out = torch.empty(seed.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _raise_on_mapped(lib.knt_mma_ceiling(
            ctypes.addressof(cw), _check(seed, "seed", torch.float32, dev),
            out.data_ptr(), seed.shape[0] // 8, t, u, rep,
            int(mode == "epi"), _stream(dev)), "mma_ceiling")
    return out


def make_inputs(steps: int, u: int, device, seed: int = 0,
                bias_scale: float = 0.0):
    """The probe's inputs, as the TPU script makes them: ``L`` weights
    ``[u, u]`` of N(0, 1) x 0.05 in bf16, biases ``[u]`` (zeros, or
    N(0, 1) x ``bias_scale`` so that a check sees the bias), and a seed of
    ones ``[steps * 8, 128]``."""
    g = torch.Generator(device=device).manual_seed(seed)
    ws = [(torch.randn(u, u, generator=g, device=device) * 0.05).to(
        torch.bfloat16) for _ in range(LAYERS)]
    bs = [torch.randn(u, generator=g, device=device) * bias_scale
          for _ in range(LAYERS)]
    return ws, bs, torch.ones(steps * 8, 128, device=device)
