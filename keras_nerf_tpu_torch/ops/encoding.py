"""Positional encoding and ray-point expansion (port of
``keras_nerf_tpu/ops/encoding.py``).

Frequencies are exactly ``2**i`` (no pi scaling); the raw coordinate comes
first, then ``sin(2**i x), cos(2**i x)`` per frequency (reference
interleave) or all sines then all cosines (block order, the kernel layout).
Each scaled argument is one exact float32 product ``x * 2**i``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _selection_constants(d: int, num_freqs: int, order: str):
    """``B [D, n]`` with one nonzero (``2^l``) per column and 0/1 masks
    ``[3, n]`` (raw / sin / cos) — the JAX package's encoding constants."""
    n = d * (1 + 2 * num_freqs)
    b = np.zeros((d, n), np.float32)
    masks = np.zeros((3, n), np.float32)

    def put(lane, src, freq, kind):
        b[src, lane] = freq
        masks[kind, lane] = 1.0

    for i in range(d):
        put(i, i, 1.0, 0)
    for l in range(num_freqs):
        for i in range(d):
            if order == "interleave":
                sin_lane = d + (2 * l) * d + i
                cos_lane = d + (2 * l + 1) * d + i
            else:  # block: [x | all sin | all cos]
                sin_lane = d + l * d + i
                cos_lane = d + (num_freqs + l) * d + i
            put(sin_lane, i, 2.0 ** l, 1)
            put(cos_lane, i, 2.0 ** l, 2)
    return b, masks


def _encode(x: torch.Tensor, num_freqs: int, order: str) -> torch.Tensor:
    if num_freqs == 0:
        return x
    b, masks = _selection_constants(x.shape[-1], num_freqs, order)
    src = torch.as_tensor(b.argmax(axis=0), device=x.device)
    freq = torch.as_tensor(b.max(axis=0), dtype=x.dtype, device=x.device)
    m = torch.as_tensor(masks, dtype=x.dtype, device=x.device)
    rep = x[..., src] * freq
    return m[0] * rep + m[1] * torch.sin(rep) + m[2] * torch.cos(rep)


def positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """``[..., D] -> [..., D * (1 + 2 L)]`` in the reference's interleaved
    order (`keras_nerf/model/nerf/utils.py:177-186`)."""
    return _encode(x, num_freqs, "interleave")


def positional_encoding_block(x: torch.Tensor,
                              num_freqs: int) -> torch.Tensor:
    """Block order ``[x | sin block | cos block]`` — the same features as
    :func:`positional_encoding`, permuted by :func:`block_permutation`."""
    return _encode(x, num_freqs, "block")


def encoded_dim(d: int, num_freqs: int) -> int:
    return d * (1 + 2 * num_freqs)


def block_permutation(d: int, num_freqs: int) -> list[int]:
    """``enc_block[..., i] == enc_ref[..., perm[i]]``."""
    perm = list(range(d))
    for trig in (0, 1):
        for l in range(num_freqs):
            for i in range(d):
                perm.append(d + l * 2 * d + trig * d + i)
    return perm


def encode_position_and_directions(
    ray_origin: torch.Tensor,
    ray_direction: torch.Tensor,
    sample_points: torch.Tensor,
    pos_emb_xyz: int,
    pos_emb_dir: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``p = o + t d`` per sample, then both encodings:
    ``(enc_xyz [..., S, Dx], enc_dir [..., S, Dd])``."""
    positions = (ray_origin[..., None, :]
                 + ray_direction[..., None, :] * sample_points[..., None])
    enc_xyz = positional_encoding(positions, pos_emb_xyz)
    directions = ray_direction[..., None, :].expand(positions.shape)
    enc_dir = positional_encoding(directions, pos_emb_dir)
    return enc_xyz, enc_dir
