"""The ray-march kernels, for the H100, and their plain PyTorch versions
(port of ``keras_nerf_tpu/kernels/ray_march.py``).

The TPU's ``fused_train_chunk`` runs sampling, encoding, MLP, quadrature
and (for training) the loss cotangent and the whole backward in one Pallas
kernel per ray tile, with every activation in VMEM (a fine tile holds
~24 MB) and the weight gradients summed over a grid that runs in order. An
H100 SM has 227 KB of shared memory and runs its blocks in no order, so the
port splits the pass into CUDA kernels (``csrc/``), one library:

* :data:`sample_merge` — the fine pass's prologue in its three modes: the
  inverse CDF of bin weights over the CDF source's midpoints, then no merge
  (``s_m = 0``, the occupancy render's probe bins) or the rank merge with a
  sorted partner: the source itself (``s_m = -1``, the coarse depths) or
  another (``s_m > 0``, the occupancy-train tier);
* :data:`ray_march_mlp` — positional encoding and the MLP per point, bf16
  tensor-core products with float32 accumulation, ``(r, g, b, sigma)`` or
  sigma alone out; in its train mode it also keeps every bf16 activation;
* :data:`ray_march_quadrature` — transmittance, weights, image, depth; with
  a target, also the head cotangents of the chunk's MSE;
* :data:`mlp_backward` — the dX chain of the MLP's backward per point;
* :data:`mlp_weight_grad` — dW and db of every packed array, summed over
  the chunk's points in a fixed order.

The TPU's two kernels over pre-encoded points, the forward and backward of
the custom-loss path's :func:`fused_point_forward`, reuse them:

* :data:`apply_mlp` — ``fused_apply_mlp`` (T5): ``ray_march_mlp``'s MLP
  over an encoded ``[P, 128]`` input (:func:`encode_block128`), with a
  stash mode for the recompute;
* :func:`fused_mlp_backward` — ``fused_mlp_backward`` (T6): ``apply_mlp``
  with a stash, ``mlp_backward`` in its output-head mode and
  ``mlp_weight_grad``.

Two more kernels have a wrapper here and their plain versions in modules of
their own:

* :data:`ray_march_mlp_int8` — the int8 render tier's trunk and heads (T4,
  ``kernels/quantize.py:forward_core_int8``): the encoding of
  ``ray_march_mlp``, kept float32, then W8A8 products with exact int32 sums
  and static scales; :func:`fused_render_chunk`'s ``quantized`` mode;
* :data:`mma_ceiling` — the tensor-core ceiling probe (T7,
  ``scripts/profile_mxu_ceiling.py``), ``kernels/ceiling.py``, timed by
  ``python -m keras_nerf_tpu_torch.profile_mma_ceiling``.

The render split costs one float32 ``[R, S, 4]`` round trip through device
memory (16 B per point), small beside the MLP's ~1.2 MFLOP per point. The
training split keeps the activations and cotangents in device memory,
~10 KB per point at 8 x 256 (:func:`alloc_stash`,
:func:`alloc_cotangents`).

The four MLP kernels take every width and depth of the JAX package's
envelope (:func:`kernel_supported`). Each has a resident route, whose
tiles stay in shared memory and whose weights' tensor maps ride in the
launch's parameters (u = 256, 512, 768 and up to :data:`MAX_LAYERS` layers
for the bf16 ones, up to 1280 for the int8 one), and a streamed route for
every other shape, in the same source, that reads each layer's input back
from device memory by TMA and the weights' maps from a device table built
once per packed state (:func:`mlp_table_layout`); the plans pick the route
by shape (:func:`ray_march_mlp_plan`, :func:`mlp_backward_plan`,
:func:`ray_march_mlp_int8_plan`). ``mlp_weight_grad`` splits a call of more
than :data:`MAX_WG_TASKS` arrays or :data:`MAX_WG_TILES` tiles over
launches (:func:`weight_grad_plan`) with the same bits.

Each kernel is reached through a :class:`KernelWrapper`: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version, and
``launches`` counts kernel launches only. The plain versions repeat the
kernels' arithmetic in PyTorch (bf16-rounded operands, float32 products
with TF32 off, the same float32 constants and operation order where it
matters), so the CPU tests hold them against the JAX package and
``chip_smoke.py`` holds the kernels against them on the card.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from keras_nerf_tpu_torch import spans
from keras_nerf_tpu_torch.ops.encoding import (
    _selection_constants,
    block_permutation,
    encoded_dim,
)
from keras_nerf_tpu_torch.kernels.ceiling import (
    mma_ceiling_cuda,
    mma_ceiling_plain,
)
from keras_nerf_tpu_torch.kernels.quantize import ray_march_mlp_int8_plain
from keras_nerf_tpu_torch.ops.rendering import RenderOutput, render_rays
from keras_nerf_tpu_torch.ops.sampling import (
    fma_f32,
    invert_cdf_of,
    merge_sorted,
    midpoints,
    sequential_cdf,
)

LANE = 128
D_HEAD = 16        # head cotangent columns: rgb 0..2 (sigma after features)
ENC_XYZ_OFF = 0    # xyz encoding block occupies lanes [0, 64)
ENC_DIR_OFF = 64   # dir encoding block occupies lanes [64, 128)
MAX_LAYERS = 16    # csrc/mlp.cuh: kMaxLayers, the resident kernels' arrays


def _f32(x: float) -> float:
    """A Python float rounded once to float32 (the value JAX computes with
    and the CUDA sources spell as a hex literal)."""
    return float(np.float32(x))


_LAST_DELTA = _f32(1e-10)
_HALF_PI = _f32(np.pi / 2)
_TWO_PI = _f32(2.0 * np.pi)
_INV_TWO_PI = _f32(1.0 / (2.0 * np.pi))
_SIN_COEFFS = tuple(_f32(c) for c in (
    2.16657012e-6, -1.93030430e-4, 8.31153094e-3, -1.66630582e-1,
    9.99983358e-1))


def kernel_supported(config, pos_emb_xyz: int,
                     pos_emb_dir: int) -> bool:
    """Static shape envelope of the kernels, the JAX package's
    (`ray_march.py:98-104`): ``dense_units`` a multiple of 256, any number
    of layers. Past the resident kernels' widths and depths the plans route
    a model to the streamed kernels (:func:`ray_march_mlp_plan`)."""
    u = config.dense_units
    return (u % LANE == 0 and (u // 2) % LANE == 0
            and encoded_dim(3, pos_emb_xyz) <= 64
            and encoded_dim(3, pos_emb_dir) <= 64)


@functools.lru_cache(maxsize=None)
def _enc128_constants(pos_emb_xyz: int, pos_emb_dir: int):
    """``b [6, 128]`` (one nonzero per column) and masks ``[3, 128]``: the
    xyz block-order encoding at lanes 0.., the dir one at lanes 64.."""
    bx, mx = _selection_constants(3, pos_emb_xyz, "block")
    bd, md = _selection_constants(3, pos_emb_dir, "block")
    n_x, n_d = bx.shape[1], bd.shape[1]
    b = np.zeros((6, LANE), np.float32)
    masks = np.zeros((3, LANE), np.float32)
    b[0:3, ENC_XYZ_OFF:ENC_XYZ_OFF + n_x] = bx
    b[3:6, ENC_DIR_OFF:ENC_DIR_OFF + n_d] = bd
    masks[:, ENC_XYZ_OFF:ENC_XYZ_OFF + n_x] = mx
    masks[:, ENC_DIR_OFF:ENC_DIR_OFF + n_d] = md
    return b, masks


# Constants are uploaded to a device once: a host-to-card copy waits for the
# stream, and every chunk needs them.
@functools.lru_cache(maxsize=None)
def _enc128_on(device: torch.device, pos_emb_xyz: int, pos_emb_dir: int):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _enc128_constants(pos_emb_xyz, pos_emb_dir))


@functools.lru_cache(maxsize=None)
def _block_permutation_on(device: torch.device, num_freqs: int):
    return torch.as_tensor(block_permutation(3, num_freqs), device=device)


def ray_encoding_coeffs(origin: torch.Tensor, direction: torch.Tensor,
                        pos_emb_xyz: int, pos_emb_dir: int):
    """Per-ray ``(base [R, 128], slope [R, 128], masks [3, 128])`` with
    ``rep = base + t * slope`` every encoding argument at depth ``t``
    (`ray_march.py:137-164`). Each column has one nonzero scale, so the
    products are formed elementwise in float32 — exact, and never TF32."""
    b, masks = _enc128_on(origin.device, pos_emb_xyz, pos_emb_dir)
    o = origin.to(torch.float32)
    d = direction.to(torch.float32)
    base = ((o[:, :, None] * b[None, 0:3]).sum(dim=1)
            + (d[:, :, None] * b[None, 3:6]).sum(dim=1))
    slope = (d[:, :, None] * b[None, 0:3]).sum(dim=1)
    return base, slope, masks


def pack_mlp_params(params, config, pos_emb_xyz: int,
                    pos_emb_dir: int) -> dict:
    """Reference-layout params -> the kernel layout of the JAX package's
    ``pack_mlp_params`` (`ray_march.py:232-327`), array for array: bf16
    weights, encoding rows permuted into block order inside ``[128, n]``
    matrices, the sigma column fused after the features (column ``u``),
    float32 biases ``[1, n]``."""
    u = config.dense_units
    if not kernel_supported(config, pos_emb_xyz, pos_emb_dir):
        raise ValueError(
            f"kernels require dense_units % {LANE} == 0, dense_units//2 % "
            f"{LANE} == 0 and encodings <= 64 dims (got units={u}, "
            f"layers={config.n_layers}, Lx={pos_emb_xyz}, Ld={pos_emb_dir})")
    dev = params["sigma"]["kernel"].device
    in_x = encoded_dim(3, pos_emb_xyz)
    in_d = encoded_dim(3, pos_emb_dir)
    perm_x = _block_permutation_on(dev, pos_emb_xyz)
    perm_d = _block_permutation_on(dev, pos_emb_dir)
    skip = set(config.skip_indices())
    last_skip = (config.n_layers - 1) in skip
    bf16, f32 = torch.bfloat16, torch.float32

    def enc128_rows(w_x=None, w_d=None, cols=None):
        out = torch.zeros((LANE, cols), dtype=f32, device=dev)
        if w_x is not None:
            out[ENC_XYZ_OFF:ENC_XYZ_OFF + in_x] = w_x[perm_x]
        if w_d is not None:
            out[ENC_DIR_OFF:ENC_DIR_OFF + in_d] = w_d[perm_d]
        return out

    def w16(x):
        return x.to(bf16).contiguous()

    def b32(x):
        return x.to(f32).reshape(1, -1).contiguous()

    trunk_w, trunk_enc_w, trunk_b = [], [], []
    for i, layer in enumerate(params["trunk"]):
        w = layer["kernel"]
        if i == 0:
            trunk_w.append(w16(enc128_rows(w_x=w, cols=u)))
            trunk_enc_w.append(None)
        elif (i - 1) in skip:
            trunk_w.append(w16(w[:u]))
            trunk_enc_w.append(w16(enc128_rows(w_x=w[u:], cols=u)))
        else:
            trunk_w.append(w16(w))
            trunk_enc_w.append(None)
        trunk_b.append(b32(layer["bias"]))

    w_sf_full = torch.cat([params["features"]["kernel"],
                           params["sigma"]["kernel"]], dim=1)
    w_sf_full = torch.nn.functional.pad(w_sf_full, (0, LANE - 1))
    if last_skip:
        w_sf, w_sf_enc = w_sf_full[:u], enc128_rows(w_x=w_sf_full[u:],
                                                    cols=u + LANE)
    else:
        w_sf, w_sf_enc = w_sf_full, None
    b_sf = torch.nn.functional.pad(
        torch.cat([params["features"]["bias"], params["sigma"]["bias"]]),
        (0, LANE - 1))
    w_rf = params["rgb_features"]["kernel"]
    w_rgb = torch.nn.functional.pad(params["rgb"]["kernel"], (0, LANE - 3))
    b_rgb = torch.nn.functional.pad(params["rgb"]["bias"], (0, LANE - 3))
    return {
        "trunk_w": trunk_w,
        "trunk_enc_w": trunk_enc_w,
        "trunk_b": trunk_b,
        "w_sf": w16(w_sf),
        "w_sf_enc": None if w_sf_enc is None else w16(w_sf_enc),
        "b_sf": b32(b_sf),
        "w_rf_top": w16(w_rf[:u]),
        "w_rf_enc": w16(enc128_rows(w_d=w_rf[u:], cols=u // 2)),
        "b_rf": b32(params["rgb_features"]["bias"]),
        "w_rgb": w16(w_rgb),
        "b_rgb": b32(b_rgb),
    }


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's reference).


def _bf16_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, float32 products and sums (the kernels' policy)."""
    return a.to(torch.float32) @ w.to(torch.float32)


def sin_poly(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's degree-9 sin on range-reduced arguments
    (`ray_march.py:875-890`), with its float32 coefficients and the Horner
    steps as FMAs — the form XLA compiles that kernel to on the CPU, which
    the CUDA kernel follows with ``__fmaf_rn``."""
    c9, c7, c5, c3, c1 = _SIN_COEFFS
    x2 = x * x
    p = fma_f32(c9, x2, c7)
    p = fma_f32(p, x2, c5)
    p = fma_f32(p, x2, c3)
    p = fma_f32(p, x2, c1)
    return x * p


def encode_points_f32(base: torch.Tensor, slope: torch.Tensor,
                      depths: torch.Tensor,
                      masks: torch.Tensor) -> torch.Tensor:
    """``[R, S, 128]`` float32 encodings of the points ``t = depths [R, S]``
    (`ray_march.py:1259-1280`, ``enc_f32``): ``rep = base + t slope``,
    +pi/2 on the cos lanes, 2 pi range reduction, :func:`sin_poly`; raw
    lanes keep ``rep``. ``rep`` and the reduction are single-rounding FMAs,
    as in the CUDA kernels (``csrc/encode.cuh``). The int8 tier quantizes
    these values; :func:`encode_points` rounds them to bf16."""
    rep = fma_f32(depths[..., None], slope[:, None, :], base[:, None, :])
    m_raw, m_sin, m_cos = masks[0], masks[1], masks[2]
    shifted = torch.where(m_cos != 0, rep + _HALF_PI, rep)
    reduced = fma_f32(-_TWO_PI, torch.round(shifted * _INV_TWO_PI), shifted)
    trig = torch.where((m_sin != 0) | (m_cos != 0), sin_poly(reduced),
                       torch.zeros_like(rep))
    return torch.where(m_raw != 0, rep, trig)


def encode_points(base: torch.Tensor, slope: torch.Tensor,
                  depths: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """``[R, S, 128]`` bf16 encodings of the points: :func:`encode_points_f32`
    rounded once to bf16, the input of the bf16 MLP."""
    return encode_points_f32(base, slope, depths, masks).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _enc128_columns_on(device: torch.device, pos_emb_xyz: int,
                       pos_emb_dir: int):
    """The one nonzero of each column of ``b`` (:func:`_enc128_constants`):
    its row (0 where the column is empty) and its value, and the masks as
    booleans."""
    b, masks = _enc128_constants(pos_emb_xyz, pos_emb_dir)
    rows = np.abs(b).argmax(axis=0)
    scale = b[rows, np.arange(LANE)]
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(scale, device=device),
            torch.as_tensor(masks != 0, device=device))


def encode_block128(positions: torch.Tensor, directions: torch.Tensor,
                    pos_emb_xyz: int = 10,
                    pos_emb_dir: int = 4) -> torch.Tensor:
    """``([P, 3], [P, 3]) -> [P, 128]`` bf16 block-order encodings, xyz at
    lanes 0.., view direction at lanes 64.. (`ray_march.py:107-134`).

    ``rep = [p, d] @ b`` has one nonzero term per column, so it is the one
    float32 product, exact as the reference's HIGHEST-precision dot; then
    ``rep``, ``sin(rep)`` or ``cos(rep)`` per lane with true sin and cos
    (not :func:`sin_poly`), rounded once to bf16."""
    rows, scale, masks = _enc128_columns_on(positions.device, pos_emb_xyz,
                                            pos_emb_dir)
    x6 = torch.cat([positions, directions], dim=-1).to(torch.float32)
    rep = x6[..., rows] * scale
    zero = torch.zeros((), dtype=torch.float32, device=rep.device)
    enc = torch.where(masks[0], rep, torch.where(
        masks[1], torch.sin(rep), torch.where(masks[2], torch.cos(rep),
                                              zero)))
    return enc.to(torch.bfloat16)


def ray_points(origin: torch.Tensor, direction: torch.Tensor,
               points: torch.Tensor):
    """``(positions [R*S, 3], directions [R*S, 3])`` of the depths ``points
    [R, S]`` along the rays ``[R, 3]`` (`engine.py:243-245`). ``o + d t``
    rounds once, as XLA's fused multiply-add does (ROADMAP C1)."""
    r, s = points.shape
    positions = fma_f32(direction[:, None, :], points[..., None],
                        origin[:, None, :])
    dirs = direction[:, None, :].expand(r, s, 3)
    return positions.reshape(r * s, 3), dirs.reshape(r * s, 3)


def _bf16_blocks(points: int, widths: list, device) -> list:
    """Contiguous bf16 ``[points, w]`` blocks of one allocation."""
    buf = torch.empty(points * sum(widths), dtype=torch.bfloat16,
                      device=device)
    views, off = [], 0
    for w in widths:
        views.append(buf[off:off + points * w].view(points, w))
        off += points * w
    return views


def alloc_stash(points: int, units: int, n_layers: int,
                device: torch.device, enc: torch.Tensor | None = None) -> dict:
    """The bf16 activations that ``ray_march_mlp`` keeps for the backward
    in its train mode, ``[P, width]`` blocks of one allocation:
    ``enc [P, 128]``, ``h`` (one ``[P, u]`` per trunk layer),
    ``features [P, u]``, ``rf [P, u / 2]`` — 5,120 B per point at 8 x 256.
    With ``enc`` given (``apply_mlp``'s stash mode) the stash's ``enc`` is
    that tensor, not a copy."""
    widths = [units] * n_layers + [units, units // 2]
    views = _bf16_blocks(points, ([] if enc is not None else [LANE])
                         + widths, device)
    if enc is None:
        enc, views = views[0], views[1:]
    return {"enc": enc, "h": views[:n_layers], "features": views[-2],
            "rf": views[-1]}


def ray_march_mlp_plain(packed: dict, base: torch.Tensor, slope: torch.Tensor,
                        depths: torch.Tensor, masks: torch.Tensor,
                        sigma_only: bool = False,
                        stash: dict | None = None) -> torch.Tensor:
    """Plain version of the ``ray_march_mlp`` kernel: ``[R*S, 4]``
    (sigmoid rgb, relu sigma) or ``[R*S]`` sigma (`_forward_core`). With
    ``stash`` (:func:`alloc_stash`, full mode only) it also stores every
    bf16 activation there: the train mode."""
    enc = encode_points(base, slope, depths, masks).reshape(-1, LANE)
    if stash is not None:
        if sigma_only:
            raise ValueError("the train mode (stash) runs the full MLP")
        stash["enc"].copy_(enc)
    return _mlp_plain(packed, enc, sigma_only, stash)


def _check_stash_enc(enc: torch.Tensor, stash: dict | None) -> None:
    if stash is not None and stash["enc"].data_ptr() != enc.data_ptr():
        raise ValueError("apply_mlp's stash must hold the input as its enc "
                         "block (alloc_stash(..., enc=enc))")


def apply_mlp_plain(packed: dict, enc: torch.Tensor,
                    stash: dict | None = None) -> torch.Tensor:
    """Plain version of the ``apply_mlp`` kernel (`fused_apply_mlp`,
    `ray_march.py:438-493`): ``enc [P, 128]`` bf16 -> ``[P, 4]`` float32
    (sigmoid rgb, relu sigma), the MLP of :func:`ray_march_mlp_plain`. With
    ``stash`` (whose ``enc`` is ``enc`` itself) it also stores the trunk
    activations, the features and rf: the recompute of T6."""
    _check_stash_enc(enc, stash)
    return _mlp_plain(packed, enc, False, stash)


def _mlp_plain(packed: dict, enc: torch.Tensor, sigma_only: bool,
               stash: dict | None) -> torch.Tensor:
    """`_forward_core` over ``enc [P, 128]`` bf16: bf16 operands, float32
    products and bias, relu and bf16 rounding between layers; ``stash``
    takes every activation after the encoding."""
    u = packed["trunk_b"][0].shape[1]
    h = enc
    for i, (w, w_enc, b) in enumerate(zip(packed["trunk_w"],
                                          packed["trunk_enc_w"],
                                          packed["trunk_b"])):
        acc = _bf16_mm(h, w)
        if w_enc is not None:
            acc = acc + _bf16_mm(enc, w_enc)
        h = torch.relu(acc + b).to(torch.bfloat16)
        if stash is not None:
            stash["h"][i].copy_(h)
    w_sf, w_sf_enc, b_sf = packed["w_sf"], packed["w_sf_enc"], packed["b_sf"]
    if sigma_only:
        sig = _bf16_mm(h, w_sf[:, u:u + 1])
        if w_sf_enc is not None:
            sig = sig + _bf16_mm(enc, w_sf_enc[:, u:u + 1])
        return torch.relu(sig + b_sf[:, u:u + 1])[:, 0]
    sf = _bf16_mm(h, w_sf[:, :u + 1])
    if w_sf_enc is not None:
        sf = sf + _bf16_mm(enc, w_sf_enc[:, :u + 1])
    sf = sf + b_sf[:, :u + 1]
    features = sf[:, :u].to(torch.bfloat16)
    sigma = torch.relu(sf[:, u])
    rf = (_bf16_mm(features, packed["w_rf_top"])
          + _bf16_mm(enc, packed["w_rf_enc"]) + packed["b_rf"]
          ).to(torch.bfloat16)
    if stash is not None:
        stash["features"].copy_(features)
        stash["rf"].copy_(rf)
    rgb = torch.sigmoid(_bf16_mm(rf, packed["w_rgb"][:, :3])
                        + packed["b_rgb"][:, :3])
    return torch.cat([rgb, sigma[:, None]], dim=1)


def ray_march_quadrature_plain(rgbs: torch.Tensor, t: torch.Tensor,
                               white_background: bool = False,
                               sigma_only: bool = False,
                               emit_weights: bool = True,
                               target: torch.Tensor | None = None,
                               loss_scale: float = 0.0):
    """Plain version of the ``ray_march_quadrature`` kernel
    (`_quadrature_fwd`, `_depth_lane3`): ``rgbs [R, S, 4]`` (or sigma
    ``[R, S]`` when ``sigma_only``), ``t [R, S]`` -> ``(image [R, 3],
    depth [R], weights [R, S] or None)``. Transmittance is
    ``exp(-exclusive cumsum(sigma delta))`` in float32; the last delta is
    1e-10. In sigma-only mode the image is zeros.

    With ``target [R, 3]`` (the ``with_grad`` mode, full only) it also
    returns the head cotangents of ``loss_scale * sum((image - target)^2)
    / 2`` — with ``loss_scale = 2 / (3 R_chunk)`` the gradient of the
    chunk's MSE (`:1345-1349`) — through `_quadrature_bwd` (`:1158`):
    ``d_rgb [R*S, 16]`` bf16, ``bf16(g_rgb rgb (1 - rgb))`` in columns 0..2
    and zeros after, and ``d_sigma [R*S]`` bf16, ``bf16(delta dL/dx
    [sigma > 0])`` with ``dL/dx_s = e_s T_s d_w_s - sum_{j>s} w_j d_w_j``.
    The clip's subgradient is 1 inside (0, 1), 0.5 at exactly 0 or 1, 0
    outside, as XLA's autodiff takes it."""
    r, s = t.shape
    sigma = rgbs if sigma_only else rgbs[..., 3]
    delta = torch.cat([t[:, 1:] - t[:, :-1],
                       torch.full_like(t[:, :1], _LAST_DELTA)], dim=1)
    x = sigma * delta
    excl = torch.cat([torch.zeros_like(x[:, :1]),
                      torch.cumsum(x[:, :-1], dim=1)], dim=1)
    e, trans = torch.exp(-x), torch.exp(-excl)
    weights = (1.0 - e) * trans
    depth = (weights * t).sum(dim=1)
    if sigma_only:
        image = torch.zeros((r, 3), dtype=t.dtype, device=t.device)
        pre_clip = image
    else:
        pre_clip = (weights[..., None] * rgbs[..., :3]).sum(dim=1)
        if white_background:
            pre_clip = pre_clip + (1.0 - weights.sum(dim=1))[:, None]
        image = torch.clamp(pre_clip, 0.0, 1.0)
    out = (image, depth, (weights if emit_weights else None))
    if target is None:
        return out
    if sigma_only:
        raise ValueError("the with_grad mode needs the colour: not "
                         "sigma_only")
    rgb = rgbs[..., :3]
    d_image = (image - target) * _f32(loss_scale)
    slope = clip_subgradient(pre_clip)
    d_pre = torch.where(slope == 1.0, d_image,
                        torch.where(slope == 0.5, 0.5 * d_image,
                                    torch.zeros_like(d_image)))
    d_w = (rgb * d_pre[:, None, :]).sum(dim=-1)
    if white_background:
        d_w = d_w - d_pre.sum(dim=-1)[:, None]
    v = weights * d_w
    incl_suffix = torch.flip(torch.cumsum(torch.flip(v, [1]), dim=1), [1])
    suffix = torch.cat([incl_suffix[:, 1:], torch.zeros_like(v[:, :1])],
                       dim=1)
    d_x = e * trans * d_w - suffix
    d_sigma = torch.where(sigma > 0.0, d_x * delta, torch.zeros_like(d_x))
    g_rgb = weights[..., None] * d_pre[:, None, :]
    d_rgb = torch.zeros((r * s, D_HEAD), dtype=torch.bfloat16,
                        device=t.device)
    d_rgb[:, :3] = (g_rgb * rgb * (1.0 - rgb)).reshape(r * s, 3)
    return (*out, d_rgb, d_sigma.reshape(r * s).to(torch.bfloat16))


def clip_subgradient(pre_clip: torch.Tensor) -> torch.Tensor:
    """The derivative of ``clip(x, 0, 1)`` that XLA's autodiff takes, per
    composite: 1 inside (0, 1), 0.5 at exactly 0 or 1, 0 outside (ROADMAP
    C5); float32, the shape of ``pre_clip``."""
    one = torch.ones_like(pre_clip)
    return torch.where((pre_clip > 0.0) & (pre_clip < 1.0), one,
                       torch.where((pre_clip == 0.0) | (pre_clip == 1.0),
                                   0.5 * one, 0.0 * one))


def alloc_cotangents(points: int, units: int, n_layers: int,
                     device: torch.device) -> dict:
    """The bf16 cotangents ``mlp_backward`` writes for ``mlp_weight_grad``,
    ``[P, width]`` blocks of one allocation: ``d_rf [P, u/2]``,
    ``d_sf [P, u + 16]`` (``d_features`` in columns ``:u``, ``d_sigma_pre``
    in column ``u``, zeros after) and ``d_pre`` (one ``[P, u]`` per trunk
    layer) — 4,896 B per point at 8 x 256. ``mlp_backward`` adds the
    quadrature's ``d_rgb [P, 16]`` under its name."""
    views = _bf16_blocks(points, [units // 2, units + D_HEAD]
                         + [units] * n_layers, device)
    return {"d_rf": views[0], "d_sf": views[1], "d_pre": views[2:]}


def output_head_cotangents(g: torch.Tensor, y: torch.Tensor):
    """T6's head step (`_mlp_bwd_kernel` :562-579): from the bf16 output
    cotangent ``g [P, 4]`` and the forward's ``y [P, 4]`` (sigmoid rgb,
    relu sigma), ``d_rgb [P, 16]`` bf16 with ``bf16(g_rgb rgb (1 - rgb))``
    in columns 0..2, and ``d_sigma [P]`` bf16, ``g_sigma`` where ``sigma >
    0`` and 0 elsewhere."""
    g = g.to(torch.float32)
    d_rgb = torch.zeros((g.shape[0], D_HEAD), dtype=torch.bfloat16,
                        device=g.device)
    d_rgb[:, :3] = g[:, :3] * y[:, :3] * (1.0 - y[:, :3])
    d_sigma = torch.where(y[:, 3] > 0.0, g[:, 3], torch.zeros_like(g[:, 3]))
    return d_rgb, d_sigma.to(torch.bfloat16)


def mlp_backward_plain(d_rgb: torch.Tensor, d_sigma: torch.Tensor,
                       packed: dict, stash: dict,
                       cots: dict | None = None,
                       from_output: bool = False) -> dict:
    """Plain version of the ``mlp_backward`` kernel: the dX chain of
    `_backward_core` (`:804-872`) from the head cotangents of
    ``ray_march_quadrature``'s with_grad mode. bf16 operands, float32
    products; ``d_rf``, ``d_features`` and each trunk layer's
    ``d_pre_i = bf16(d_h [h_i > 0])`` are rounded to bf16, ``d_h`` stays
    float32 between them. Writes (and returns) :func:`alloc_cotangents`.

    ``from_output=True`` is the output-head mode of T6: the first two
    arguments are then the output cotangent ``g [P, 4]`` bf16 and the
    forward's output ``y [P, 4]`` float32, and the head cotangents are
    :func:`output_head_cotangents` of them."""
    if from_output:
        d_rgb, d_sigma = output_head_cotangents(d_rgb, d_sigma)
    p = d_rgb.shape[0]
    u = packed["trunk_b"][0].shape[1]
    n = len(packed["trunk_w"])
    if cots is None:
        cots = alloc_cotangents(p, u, n, d_rgb.device)
    d_rf = _bf16_mm(d_rgb, packed["w_rgb"][:, :D_HEAD].T).to(torch.bfloat16)
    d_features = _bf16_mm(d_rf, packed["w_rf_top"].T).to(torch.bfloat16)
    d_sf = torch.zeros((p, u + D_HEAD), dtype=torch.bfloat16,
                       device=d_rgb.device)
    d_sf[:, :u] = d_features
    d_sf[:, u] = d_sigma
    cots["d_rgb"] = d_rgb
    cots["d_rf"].copy_(d_rf)
    cots["d_sf"].copy_(d_sf)
    d_h = _bf16_mm(d_sf, packed["w_sf"][:, :u + D_HEAD].T)
    for i in reversed(range(n)):
        h = stash["h"][i]
        d_pre = torch.where(h > 0, d_h, torch.zeros_like(d_h)).to(
            torch.bfloat16)
        cots["d_pre"][i].copy_(d_pre)
        if i > 0:
            d_h = _bf16_mm(d_pre, packed["trunk_w"][i].T)
    return cots


def weight_grad_tasks(stash: dict, cots: dict, grads: dict):
    """``(A, G, out, bias_out)`` per packed weight array: ``out[:K, :N] +=
    A^T G`` and ``bias_out[0, :N] += sum_p G`` over the points, with ``A
    [P, K]`` and ``G [P, N]`` bf16 (`_backward_core`'s ``dW``/``rowsum``,
    summed over the chunk as `_acc_out` (`:500`) does over the grid)."""
    tasks = []
    for i, (w, w_enc, b) in enumerate(zip(grads["trunk_w"],
                                          grads["trunk_enc_w"],
                                          grads["trunk_b"])):
        a_in = stash["enc"] if i == 0 else stash["h"][i - 1]
        tasks.append((a_in, cots["d_pre"][i], w, b))
        if w_enc is not None:
            tasks.append((stash["enc"], cots["d_pre"][i], w_enc, None))
    tasks.append((stash["h"][-1], cots["d_sf"], grads["w_sf"], grads["b_sf"]))
    if grads["w_sf_enc"] is not None:
        tasks.append((stash["enc"], cots["d_sf"], grads["w_sf_enc"], None))
    tasks.append((stash["features"], cots["d_rf"], grads["w_rf_top"],
                  grads["b_rf"]))
    tasks.append((stash["enc"], cots["d_rf"], grads["w_rf_enc"], None))
    tasks.append((stash["rf"], cots["d_rgb"], grads["w_rgb"], grads["b_rgb"]))
    return tasks


def mlp_weight_grad_plain(stash: dict, cots: dict, grads: dict) -> dict:
    """Plain version of the ``mlp_weight_grad`` kernel: adds ``dW = A^T G``
    (float32 products of the bf16 operands) and ``db = sum G`` of every
    packed array into the float32 accumulators ``grads`` (the packed
    layout of :func:`pack_mlp_params`), and returns them."""
    for a, g, out, bias in weight_grad_tasks(stash, cots, grads):
        n = g.shape[1]
        g32 = g.to(torch.float32)
        out[:, :n] += a.to(torch.float32).T @ g32
        if bias is not None:
            bias[0, :n] += g32.sum(dim=0)
    return grads


def sample_merge_plain(cp: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                       mp: torch.Tensor | None) -> torch.Tensor:
    """Plain version of the ``sample_merge`` kernel
    (`_sample_merge_prologue`, `ray_march.py:987-1099`): the sorted CDF
    source ``cp`` and bin weights ``w >= 0`` ``[R, s_c]``, sorted draws ``u
    [R, n]`` -> sorted depths. The draws invert the CDF of ``w`` over the
    edge-padded midpoints of ``cp`` (:func:`invert_cdf_of` on
    :func:`sequential_cdf`); then, by the merge partner ``mp``:

    * ``None`` (``s_m = 0``): the drawn depths alone, ``[R, n]``;
    * a sorted ``[R, s_m]`` tensor (``s_m > 0``): :func:`merge_sorted` with
      it, a partner depth before an equal drawn one, ``[R, s_m + n]``. The
      fine pass passes ``cp`` itself (the TPU kernel's ``s_m = -1``, which
      the same ranks give).

    The CDF is JAX's ``invert_cdf``'s, 0-prepended and inclusive, each
    prefix the one before plus a bin's share (the kernel sums it in the
    same order, so the two agree to the bit); the TPU prologue forms it as
    ``inclusive - pdf``, one float32 rounding apart."""
    fine = invert_cdf_of(u, midpoints(cp), sequential_cdf(w))
    return fine if mp is None else merge_sorted(mp, fine)


SAMPLE_MERGE_RAYS = 4   # rays (warps) a block of the sample_merge kernel


def sample_merge_plan(s_c: int, n: int, s_m: int) -> tuple[int, int]:
    """``(rays a block, dynamic shared bytes)`` of the ``sample_merge``
    kernel for ``s_c`` bins, ``n`` draws and ``s_m`` partner depths (0: no
    merge). Each ray's warp keeps the 0-prepended CDF and the edge-padded
    midpoints (``s_c + 1`` floats each) and, where it merges, the partner
    and the drawn depths, behind 3 floats that align the weights to 16
    bytes, rounded up to 4 floats (mirrors csrc/sample_merge.cu's
    ``ray_floats``); a ray that does not fit a block's shared memory
    raises."""
    if s_c < 2:
        raise ValueError("sample_merge needs at least 2 bins")
    floats = 3 + 2 * (s_c + 1) + (s_m + n if s_m > 0 else 0)
    per_ray = 4 * (-(-floats // 4) * 4)
    if per_ray > SMEM_PER_BLOCK:
        raise ValueError(
            f"sample_merge: {s_c} bins, {n} draws and {s_m} partner depths "
            f"need {per_ray} bytes of shared memory a ray, more than the "
            f"{SMEM_PER_BLOCK} of a block")
    rays = min(SAMPLE_MERGE_RAYS, SMEM_PER_BLOCK // per_ray)
    return rays, rays * per_ray


# --------------------------------------------------------------------------
# CUDA launches.


# The per-model arrays of struct MlpInt8Weights, in its order.
_INT8_HEAD_ARRAYS = (
    "w_feat", "u_feat", "b_feat", "w_sig", "u_sig", "b_sig", "w_feat_enc",
    "u_feat_enc", "w_sig_enc", "u_sig_enc", "enc_r_sf", "r_feat", "w_rf_top",
    "u_rf_top", "w_rf_enc", "u_rf_enc", "enc_r_rf", "b_rf", "r_rf", "w_rgb",
    "u_rgb", "b_rgb")


class _MlpWeights(ctypes.Structure):
    """Mirror of ``struct MlpWeights`` in csrc/ray_march_mlp.cu."""

    _fields_ = [
        ("trunk_w", ctypes.c_void_p * MAX_LAYERS),
        ("trunk_enc_w", ctypes.c_void_p * MAX_LAYERS),
        ("trunk_b", ctypes.c_void_p * MAX_LAYERS),
        ("w_sf", ctypes.c_void_p),
        ("w_sf_enc", ctypes.c_void_p),
        ("b_sf", ctypes.c_void_p),
        ("w_rf_top", ctypes.c_void_p),
        ("w_rf_enc", ctypes.c_void_p),
        ("b_rf", ctypes.c_void_p),
        ("w_rgb", ctypes.c_void_p),
        ("b_rgb", ctypes.c_void_p),
        ("n_layers", ctypes.c_int),
        ("units", ctypes.c_int),
    ]


def _check(t: torch.Tensor, name: str, dtype, device, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    return t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def _cdf_source_stride(cp: torch.Tensor, rays: int, s_c: int) -> int:
    """The row stride of the CDF source ``cp [rays, s_c]``: ``s_c`` for a
    contiguous tensor, 0 for one row broadcast to every ray (the occupancy
    render's probe-bin centres, ``expand`` of a row)."""
    if tuple(cp.shape) != (rays, s_c):
        raise ValueError(f"cp has shape {tuple(cp.shape)}, expected "
                         f"{(rays, s_c)}")
    if cp.stride(1) != 1 or cp.stride(0) not in (0, s_c):
        raise ValueError("cp must be contiguous, or one contiguous row "
                         "broadcast to every ray")
    return cp.stride(0)


def _sample_merge_cuda(cp, w, u, mp, lib=None):
    from keras_nerf_tpu_torch.kernels._build import load

    lib = lib or load()
    dev = w.device
    r, s_c = w.shape
    n = u.shape[1]
    s_m = 0 if mp is None else mp.shape[1]
    rays_per_block, smem = sample_merge_plan(s_c, n, s_m)
    f32 = torch.float32
    if cp.device != dev or cp.dtype != f32:
        raise TypeError(f"cp is {cp.dtype} on {cp.device}, expected {f32} "
                        f"on {dev}")
    cp_stride = _cdf_source_stride(cp, r, s_c)
    mp_ptr = (_check(mp, "mp", f32, dev, (r, s_m)) if s_m > 0 else None)
    out = torch.empty((r, n + s_m), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        _raise_on(lib.knt_sample_merge(
            cp.data_ptr(), cp_stride, _check(w, "w", f32, dev, (r, s_c)),
            _check(u, "u", f32, dev, (r, n)), mp_ptr, out.data_ptr(), r, s_c,
            n, s_m, rays_per_block, smem, _stream(dev)), "sample_merge")
    return out


def _mlp_pointers(packed: dict, device: torch.device) -> dict:
    """The device pointers of a packed dict's arrays (None where it has
    None), each array checked for its device, type, contiguity and shape:
    ``trunk_w``, ``trunk_enc_w`` and ``trunk_b`` as lists, then the heads
    of :data:`MLP_HEAD_ARRAYS`."""
    n = len(packed["trunk_w"])
    u = packed["trunk_b"][0].shape[1]
    if u % 256:
        raise ValueError(f"the MLP kernels take a multiple of 256 units "
                         f"(got {u})")
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"trunk_w": [], "trunk_enc_w": [], "trunk_b": []}
    for i in range(n):
        out["trunk_w"].append(_check(packed["trunk_w"][i], f"trunk_w[{i}]",
                                     bf16, device, (LANE if i == 0 else u,
                                                    u)))
        enc_w = packed["trunk_enc_w"][i]
        out["trunk_enc_w"].append(
            None if enc_w is None else
            _check(enc_w, f"trunk_enc_w[{i}]", bf16, device, (LANE, u)))
        out["trunk_b"].append(_check(packed["trunk_b"][i], f"trunk_b[{i}]",
                                     f32, device, (1, u)))
    shapes = {"w_sf": (bf16, (u, u + LANE)),
              "w_sf_enc": (bf16, (LANE, u + LANE)),
              "b_sf": (f32, (1, u + LANE)), "w_rf_top": (bf16, (u, u // 2)),
              "w_rf_enc": (bf16, (LANE, u // 2)), "b_rf": (f32, (1, u // 2)),
              "w_rgb": (bf16, (u // 2, LANE)), "b_rgb": (f32, (1, LANE))}
    for name in MLP_HEAD_ARRAYS:
        x = packed[name]
        if x is None and name != "w_sf_enc":
            raise ValueError(f"{name} is missing")
        dtype, shape = shapes[name]
        out[name] = None if x is None else _check(x, name, dtype, device,
                                                  shape)
    return out


def _mlp_struct(packed: dict, device: torch.device) -> _MlpWeights:
    """The resident kernels' ``MlpWeights``: at most :data:`MAX_LAYERS`
    layers (the plans route deeper models to the streamed kernels)."""
    ptrs = _mlp_pointers(packed, device)
    n = len(ptrs["trunk_w"])
    if n > MAX_LAYERS:
        raise ValueError(f"the resident MLP kernels take at most "
                         f"{MAX_LAYERS} layers (got {n})")
    s = _MlpWeights()
    for key in ("trunk_w", "trunk_enc_w", "trunk_b"):
        for i, x in enumerate(ptrs[key]):
            getattr(s, key)[i] = x
    for name in MLP_HEAD_ARRAYS:
        setattr(s, name, ptrs[name])
    s.n_layers = n
    s.units = packed["trunk_b"][0].shape[1]
    return s


# --------------------------------------------------------------------------
# The device tables of the streamed kernels.

MAP_BYTES = 128      # sizeof(CUtensorMap)
TABLE_HEAD_MAPS = 5  # csrc/mlp.cuh: kTableHeadMaps
# The heads of csrc/mlp.cuh's MlpHeads (and MlpWeights), in its order.
MLP_HEAD_ARRAYS = ("w_sf", "w_sf_enc", "b_sf", "w_rf_top", "w_rf_enc",
                   "b_rf", "w_rgb", "b_rgb")
# The maps of csrc/mlp.cuh's TableHead, in its order.
MLP_HEAD_MAPS = ("w_sf", "w_sf_enc", "w_rf_top", "w_rf_enc", "w_rgb")
I8_TABLE_HEAD_MAPS = 4  # csrc/ray_march_mlp_int8.cu: streamed::kHeadMaps
I8_HEAD_MAPS = ("w_feat", "w_feat_enc", "w_rf_top", "w_rf_enc")
# The per-layer pointer arrays of csrc/ray_march_mlp_int8.cu's I8Table.
I8_LAYER_POINTERS = ("trunk_u", "trunk_b", "trunk_r", "trunk_enc_u", "enc_r",
                     "trunk_enc_w")


def _table_layout(n_layers: int, head_maps: int, layer_pointers,
                  head_pointers) -> dict:
    """Byte offsets of a device table: ``2 n + head_maps`` tensor maps of
    128 bytes (``trunk`` and ``trunk_enc``, n each, then ``head_maps``),
    then n pointers for each of ``layer_pointers`` and the
    ``head_pointers``; ``bytes`` in all."""
    if n_layers < 1:
        raise ValueError(f"a table needs at least one layer (got "
                         f"{n_layers})")
    n = n_layers
    out = {"trunk": 0, "trunk_enc": MAP_BYTES * n,
           "head_maps": 2 * MAP_BYTES * n}
    off = MAP_BYTES * (2 * n + head_maps)
    for name in layer_pointers:
        out[name] = off
        off += 8 * n
    out["heads"] = off
    out["bytes"] = off + 8 * len(head_pointers)
    return out


def mlp_table_layout(n_layers: int) -> dict:
    """The layout of the device table that the streamed ``ray_march_mlp``
    and ``mlp_backward`` kernels read (csrc/mlp.cuh: ``MlpTable``,
    ``table_of``): the maps of ``trunk_w[i]`` and ``trunk_enc_w[i]``, then
    :data:`MLP_HEAD_MAPS`; the pointers ``trunk_b`` and ``trunk_enc_w`` per
    layer, then :data:`MLP_HEAD_ARRAYS`."""
    return _table_layout(n_layers, TABLE_HEAD_MAPS, ("trunk_b",
                                                     "trunk_enc_w"),
                         MLP_HEAD_ARRAYS)


def mlp_int8_table_layout(n_layers: int) -> dict:
    """The layout of the device table that the streamed
    ``ray_march_mlp_int8`` kernel reads (csrc/ray_march_mlp_int8.cu:
    ``I8Table``): the maps of the transposed ``trunk_w[i]`` and
    ``trunk_enc_w[i]``, then :data:`I8_HEAD_MAPS`'s; the pointers of
    :data:`I8_LAYER_POINTERS` per layer, then the ``I8Heads`` of
    ``_INT8_HEAD_ARRAYS``."""
    return _table_layout(n_layers, I8_TABLE_HEAD_MAPS, I8_LAYER_POINTERS,
                         _INT8_HEAD_ARRAYS)


class _MapSpec(ctypes.Structure):
    """Mirror of ``struct MapSpec`` in csrc/ray_march_mlp.cu."""

    _fields_ = [("base", ctypes.c_void_p),
                *((f, ctypes.c_int) for f in ("cols", "rows", "elem_bytes",
                                              "box_rows"))]


# Tables by the identity (address, shape, type) of every array they name: a
# table is a function of those alone, so a hit is always right, also for an
# address reused by another array of the same shape. A few packed states at
# a time (a step's two models, a render's, a calibration's) are live.
_TABLES: collections.OrderedDict = collections.OrderedDict()
_TABLE_CACHE = 16


def _identity(x):
    return None if x is None else (x.data_ptr(), tuple(x.shape), x.dtype)


def _device_table(maps, pointers, device: torch.device, lib) -> torch.Tensor:
    """A device table (:func:`_table_layout`): ``maps`` as ``(array or None,
    box_rows)``, each a 2-D array in boxes of 128 bytes x ``box_rows`` rows
    with the 128-byte swizzle (zeros for None); ``pointers`` arrays or
    None, in the layout's order. Encoded on the host
    (csrc/ray_march_mlp.cu: ``knt_encode_maps``) and copied to ``device``
    once per set of arrays: a later launch with the same arrays reuses it,
    with no copy."""
    key = (str(device), tuple((_identity(x), br) for x, br in maps),
           tuple(_identity(x) for x in pointers))
    table = _TABLES.get(key)
    if table is not None:
        _TABLES.move_to_end(key)
        return table
    specs = (_MapSpec * len(maps))()
    for spec, (x, box_rows) in zip(specs, maps):
        if x is not None:
            spec.base = x.data_ptr()
            spec.rows, spec.cols = x.shape
            spec.elem_bytes = x.element_size()
            spec.box_rows = box_rows
    map_bytes = MAP_BYTES * len(maps)
    host = np.zeros(map_bytes + 8 * len(pointers), np.uint8)
    _raise_on_mapped(lib.knt_encode_maps(ctypes.addressof(specs), len(maps),
                                         host.ctypes.data), "tensor maps")
    host[map_bytes:].view(np.uint64)[:] = [
        0 if x is None else x.data_ptr() for x in pointers]
    table = torch.from_numpy(host).to(device)
    _TABLES[key] = table
    while len(_TABLES) > _TABLE_CACHE:
        _TABLES.popitem(last=False)
    return table


def mlp_table_entries(packed: dict) -> tuple:
    """``(maps, pointers)`` of a packed state's device table, in the order
    of :func:`mlp_table_layout`: each map ``(array or None, box_rows)``, a
    [64 x 64] bf16 box that both the forward (MN-major weights) and the dX
    chain (K-major) read; each pointer an array or None."""
    maps = [(w, 64) for w in [*packed["trunk_w"], *packed["trunk_enc_w"],
                              *(packed[k] for k in MLP_HEAD_MAPS)]]
    pointers = [*packed["trunk_b"], *packed["trunk_enc_w"],
                *(packed[k] for k in MLP_HEAD_ARRAYS)]
    return maps, pointers


def _mlp_table(packed: dict, device: torch.device, lib) -> torch.Tensor:
    """The device table of a packed state, its arrays checked as for the
    resident kernels."""
    _mlp_pointers(packed, device)
    return _device_table(*mlp_table_entries(packed), device, lib)


def _planes(blocks, points: int, units: int, device, name: str) -> int:
    """The address of ``blocks`` (bf16 ``[points, units]`` each) read as one
    ``[len(blocks), points, units]`` array, as the streamed kernels read the
    stash's h (and features) and the cotangents' d_pre: each block must
    follow the one before, as :func:`alloc_stash` and
    :func:`alloc_cotangents` lay them out."""
    first = blocks[0].data_ptr()
    step = points * units * 2
    for i, b in enumerate(blocks):
        _check(b, f"{name}[{i}]", torch.bfloat16, device, (points, units))
        if b.data_ptr() != first + i * step:
            raise ValueError(f"the streamed MLP kernels read {name} as one "
                             f"[{len(blocks)}, P, {units}] array: each block "
                             f"must follow the one before (alloc_stash, "
                             f"alloc_cotangents)")
    return first


def _mlp_streamed(packed, device, lib, sigma_only=False, stash=None,
                  points=None, enc=None):
    """The streamed forward (``knt_mlp_streamed``): ``points = (base, slope,
    depths, masks)`` (``ray_march_mlp``'s modes) or ``enc`` (``apply_mlp``'s
    input mode), with or without a stash."""
    n, u = len(packed["trunk_w"]), packed["trunk_b"][0].shape[1]
    table = _mlp_table(packed, device, lib)
    f32, bf16 = torch.float32, torch.bfloat16
    if points is not None:
        base, slope, depths, masks = points
        r, s = depths.shape
        p = r * s
        args = (_check(base, "base", f32, device, (r, LANE)),
                _check(slope, "slope", f32, device, (r, LANE)),
                _check(depths, "depths", f32, device),
                _check(masks, "masks", f32, device, (3, LANE)), None)
    else:
        p, s = enc.shape[0], 1
        args = (None, None, None, None, enc.data_ptr())
    if p >= 2 ** 31:
        raise ValueError(f"the MLP kernels take fewer than 2^31 points "
                         f"(got {p})")
    enc_out = rf_out = None
    if stash is not None:
        x = _planes([*stash["h"], stash["features"]], p, u, device,
                    "stash h and features")
        if points is not None:
            enc_out = _check(stash["enc"], "stash enc", bf16, device,
                             (p, LANE))
        rf_out = _check(stash["rf"], "stash rf", bf16, device, (p, u // 2))
    else:
        scratch = torch.empty((2, p, u), dtype=bf16, device=device)
        x = scratch.data_ptr()
    out = torch.empty((p,) if sigma_only else (p, 4), dtype=f32,
                      device=device)
    with torch.cuda.device(device):
        _raise_on_mapped(lib.knt_mlp_streamed(
            table.data_ptr(), n, u, *args, out.data_ptr(), p, s,
            int(sigma_only), x, int(stash is not None), enc_out, rf_out,
            _stream(device)), "ray_march_mlp (streamed)")
    return out


class _MlpStash(ctypes.Structure):
    """Mirror of ``struct MlpStash`` in csrc/common.cuh."""

    _fields_ = [
        ("enc", ctypes.c_void_p),
        ("h", ctypes.c_void_p * MAX_LAYERS),
        ("features", ctypes.c_void_p),
        ("rf", ctypes.c_void_p),
    ]


class _MlpCotangents(ctypes.Structure):
    """Mirror of ``struct MlpCotangents`` in csrc/mlp_backward.cu."""

    _fields_ = [
        ("d_rf", ctypes.c_void_p),
        ("d_sf", ctypes.c_void_p),
        ("d_pre", ctypes.c_void_p * MAX_LAYERS),
    ]


class _WgTask(ctypes.Structure):
    """Mirror of ``struct WgTask`` in csrc/mlp_weight_grad.cu."""

    _fields_ = [
        ("a", ctypes.c_void_p),
        ("g", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("bias_out", ctypes.c_void_p),
        ("k", ctypes.c_int),
        ("n", ctypes.c_int),
        ("ldo", ctypes.c_int),
        ("poff", ctypes.c_int),
        ("bpoff", ctypes.c_int),
        ("reduce", ctypes.c_int),
    ]


class _WgTile(ctypes.Structure):
    """Mirror of ``struct WgTile`` in csrc/mlp_weight_grad.cu."""

    _fields_ = [(f, ctypes.c_int) for f in ("task", "m0", "n0", "nt")]


MAX_WG_TASKS = 40    # csrc/mlp_weight_grad.cu: kMaxTasks
MAX_WG_TILES = 256   # csrc/mlp_weight_grad.cu: kMaxTiles
WG_STEP = 64         # points per ring stage; slices start at its multiples
WG_TILE_K = 128      # output rows per block (two warpgroups of 64)
WG_SMS = 132         # the H100's SMs, a constant: the plan is one of shapes
WG_WAVES = 2         # blocks per SM the slices aim at
WG_MIN_STEPS = 16    # stages a slice holds at least


def _stash_struct(stash: dict, points: int, units: int, n_layers: int,
                  device: torch.device) -> _MlpStash:
    bf16 = torch.bfloat16
    s = _MlpStash()
    s.enc = _check(stash["enc"], "stash enc", bf16, device, (points, LANE))
    if len(stash["h"]) != n_layers:
        raise ValueError(f"stash holds {len(stash['h'])} trunk activations "
                         f"for {n_layers} layers")
    for i, h in enumerate(stash["h"]):
        s.h[i] = _check(h, f"stash h[{i}]", bf16, device, (points, units))
    s.features = _check(stash["features"], "stash features", bf16, device,
                        (points, units))
    s.rf = _check(stash["rf"], "stash rf", bf16, device,
                  (points, units // 2))
    return s


FWD_TILE_ELEMS = 128 * 256   # csrc/ray_march_mlp.cu: points x u of a tile (u = 256, 512)
FWD_STAGES = 3               # kStages: ring stages of weight slabs
FWD_STAGE_BYTES = 4 * 64 * 128  # [64 K x 256 N] bf16 as four 64 x 64 boxes
FWD_MAX_UNITS = 768          # kMaxUnits
FWD_FLOATS = 128 * 4 + FWD_MAX_UNITS + LANE + FWD_MAX_UNITS // 2 * 3  # kFloats

# The streamed kernels (the streamed namespaces of csrc/ray_march_mlp.cu,
# mlp_backward.cu and ray_march_mlp_int8.cu): 64 points a block, one
# consumer warpgroup, output columns in passes of 128, a ring of 3 stages
# of an activation slab ([64 points x 128 bytes]) and two weight boxes
# ([64 x 128 bytes] each).
STREAM_TILE = 64             # kTile
STREAM_STAGES = 3            # kStages
STREAM_PASS = 128            # kPass (kPart in the int8 kernel)
STREAM_STAGE_BYTES = 3 * STREAM_TILE * 128  # kStageBytes


def _check_units(kernel: str, units: int) -> None:
    if units < 256 or units % 256:
        raise ValueError(f"{kernel} takes dense_units a multiple of 256 (got "
                         f"{units}): the JAX package's envelope, dense_units "
                         f"and dense_units / 2 multiples of 128")


def _streamed_plan(units: int, resident_bytes: int) -> dict:
    """The streamed kernels' plan: ``resident_bytes`` of shared memory kept
    beside the ring (the encoding or head tile, partial sums, mbarriers)."""
    smem = 1024 + STREAM_STAGES * STREAM_STAGE_BYTES + resident_bytes
    return {"route": "streamed", "tile": STREAM_TILE, "split": "passes",
            "passes": units // STREAM_PASS, "stages": STREAM_STAGES,
            "stage_bytes": STREAM_STAGE_BYTES, "smem_bytes": smem,
            "blocks_per_sm": 2 if 2 * (smem + 1024) <= SMEM_PER_SM else 1}


def ray_march_mlp_plan(units: int, n_layers: int = 8) -> dict:
    """The route, tile and shared memory of the ``ray_march_mlp`` kernel
    (and of ``apply_mlp``, its input mode) for ``n_layers`` layers of
    ``units`` (mirrors csrc/ray_march_mlp.cu).

    ``route`` "resident" (u = 256, 512 or 768, at most :data:`MAX_LAYERS`
    layers): the activation tile stays in shared memory. ``tile``: points
    per block, 128 at u = 256 (the two consumer warpgroups take 64 rows
    each) and 64 at u = 512 and 768 (each takes half the columns, at 768 in
    ``passes`` of 128 columns); ``smem_bytes``: the activation tile
    (``tile`` x u bf16), the encoding tile (``tile`` x 128 bf16), the ring
    of weight stages, the heads' float32 columns and partial sums, the
    mbarriers and 1 KB of alignment.

    ``route`` "streamed" (any other multiple of 256, any depth): each
    product's output goes to device memory and the next reads it back, so
    ``smem_bytes`` (the ring, the encoding tile, the heads' partial sums,
    the mbarriers) does not grow with the width. Raises, naming the width,
    on one outside the JAX package's envelope."""
    _check_units("ray_march_mlp", units)
    if units > FWD_MAX_UNITS or n_layers > MAX_LAYERS:
        return _streamed_plan(units, STREAM_TILE * 2 * LANE
                              + 4 * 4 * STREAM_TILE
                              + 8 * (2 * STREAM_STAGES + 2))
    tile = 64 if units == 768 else FWD_TILE_ELEMS // units
    smem = (1024 + 2 * tile * units + tile * 2 * LANE
            + FWD_STAGES * FWD_STAGE_BYTES + 4 * FWD_FLOATS
            + 8 * (2 * FWD_STAGES + 1))
    return {"route": "resident", "tile": tile,
            "split": "rows" if units == 256 else "columns",
            "passes": 3 if units == 768 else 1, "stages": FWD_STAGES,
            "smem_bytes": smem}


def swizzled_offset(r: int, c: int, tile: int, elem_bytes: int = 2) -> int:
    """Byte offset of element ``(r, c)`` of a ``[tile x cols]`` tile of
    ``ray_march_mlp``'s shared memory (bf16, csrc/ray_march_mlp.cu:
    ``swz``) or, with ``elem_bytes`` 1, of ``ray_march_mlp_int8``'s code
    tiles (csrc/ray_march_mlp_int8.cu: ``swz``): boxes of ``tile`` rows of
    128 bytes, the 16-byte chunk of byte ``b = c * elem_bytes`` of row
    ``r`` stored at chunk ``(b // 16) % 8 ^ (r % 8)``."""
    b = c * elem_bytes
    return ((b >> 7) * tile * 128 + r * 128
            + ((((b >> 4) & 7) ^ (r & 7)) << 4) + (b & 15))


def _raise_on_mapped(err: int, name: str) -> None:
    if err < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed "
                           f"(CUresult {-err})")
    _raise_on(err, name)


def _ray_march_mlp_cuda(packed, base, slope, depths, masks,
                        sigma_only=False, stash=None, lib=None):
    """The ``ray_march_mlp`` launch; ``lib`` another build of its C entry
    point (``time_ray_march_mlp`` times a parent's kernel through it),
    else this package's library."""
    from keras_nerf_tpu_torch.kernels._build import load

    dev = base.device
    r, s = depths.shape
    f32 = torch.float32
    plan = ray_march_mlp_plan(packed["trunk_b"][0].shape[1],
                              len(packed["trunk_w"]))
    if stash is not None and sigma_only:
        raise ValueError("the train mode (stash) runs the full MLP")
    if plan["route"] == "streamed":
        return _mlp_streamed(packed, dev, load() if lib is None else lib,
                             sigma_only, stash, (base, slope, depths, masks))
    weights = _mlp_struct(packed, dev)
    lib = load() if lib is None else lib
    stash_s = None
    if stash is not None:
        stash_s = _stash_struct(stash, r * s, weights.units, weights.n_layers,
                                dev)
    shape = (r * s,) if sigma_only else (r * s, 4)
    out = torch.empty(shape, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        _raise_on_mapped(lib.knt_ray_march_mlp(
            ctypes.addressof(weights),
            _check(base, "base", f32, dev, (r, LANE)),
            _check(slope, "slope", f32, dev, (r, LANE)),
            _check(depths, "depths", f32, dev),
            _check(masks, "masks", f32, dev, (3, LANE)), out.data_ptr(), r, s,
            int(sigma_only),
            None if stash_s is None else ctypes.addressof(stash_s),
            _stream(dev)), "ray_march_mlp")
    return out


def _apply_mlp_cuda(packed, enc, stash=None, lib=None):
    """The ``apply_mlp`` launch; ``lib`` as for :func:`_ray_march_mlp_cuda`."""
    from keras_nerf_tpu_torch.kernels._build import load

    dev = enc.device
    p = enc.shape[0]
    plan = ray_march_mlp_plan(packed["trunk_b"][0].shape[1],
                              len(packed["trunk_w"]))
    _check(enc, "enc", torch.bfloat16, dev, (p, LANE))
    if enc.data_ptr() % 16:
        raise ValueError("apply_mlp reads enc by TMA: its data must be "
                         "16-byte aligned")
    if stash is not None:
        _check_stash_enc(enc, stash)
    if plan["route"] == "streamed":
        return _mlp_streamed(packed, dev, load() if lib is None else lib,
                             stash=stash, enc=enc)
    weights = _mlp_struct(packed, dev)
    lib = load() if lib is None else lib
    stash_s = None
    if stash is not None:
        stash_s = _stash_struct(stash, p, weights.units, weights.n_layers,
                                dev)
    out = torch.empty((p, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _raise_on_mapped(lib.knt_apply_mlp(
            ctypes.addressof(weights), enc.data_ptr(), out.data_ptr(), p,
            None if stash_s is None else ctypes.addressof(stash_s),
            _stream(dev)), "apply_mlp")
    return out


class _MlpInt8Weights(ctypes.Structure):
    """Mirror of ``struct MlpInt8Weights`` in csrc/ray_march_mlp_int8.cu."""

    _fields_ = [
        ("trunk_w", ctypes.c_void_p * MAX_LAYERS),
        ("trunk_u", ctypes.c_void_p * MAX_LAYERS),
        ("trunk_b", ctypes.c_void_p * MAX_LAYERS),
        ("trunk_r", ctypes.c_void_p * MAX_LAYERS),
        ("trunk_enc_w", ctypes.c_void_p * MAX_LAYERS),
        ("trunk_enc_u", ctypes.c_void_p * MAX_LAYERS),
        ("enc_r", ctypes.c_void_p * MAX_LAYERS),
        *((name, ctypes.c_void_p) for name in _INT8_HEAD_ARRAYS),
        ("n_layers", ctypes.c_int),
        ("units", ctypes.c_int),
    ]


def _mlp_int8_pointers(q: dict, device: torch.device) -> dict:
    """The device pointers of a :func:`quantize_packed` dict, each array
    checked for its device, type, contiguity and shape: per-layer lists
    (``trunk_w``, ``trunk_u``, ``trunk_b``, ``trunk_r``, ``trunk_enc_w``,
    ``trunk_enc_u``, ``enc_r``), then ``_INT8_HEAD_ARRAYS`` by name. The
    int8 weights' pointers are their ``[fan_out, fan_in]`` copies, the
    K-major operands of the kernel's products, made once per quantized
    state (:func:`~keras_nerf_tpu_torch.kernels.quantize.
    transposed_int8_weights`) and kept in ``q``."""
    from keras_nerf_tpu_torch.kernels.quantize import transposed_int8_weights

    n = len(q["trunk_w"])
    u = q["trunk_b"][0].shape[1]
    if u % 256:
        raise ValueError(f"ray_march_mlp_int8 takes a multiple of 256 units "
                         f"(got {u})")
    i8, f32 = torch.int8, torch.float32
    half = u // 2
    s = {k: [] for k in ("trunk_w", "trunk_u", "trunk_b", "trunk_r",
                         "trunk_enc_w", "trunk_enc_u", "enc_r")}

    def opt(x, name, dtype, shape):
        return None if x is None else _check(x, name, dtype, device, shape)

    for i in range(n):
        fan = LANE if i == 0 else u
        opt(q["trunk_w"][i], f"trunk_w[{i}]", i8, (fan, u))
        for key in ("trunk_u", "trunk_b", "trunk_r"):
            s[key].append(_check(q[key][i], f"{key}[{i}]", f32, device,
                                 (1, u)))
        opt(q["trunk_enc_w"][i], f"trunk_enc_w[{i}]", i8, (LANE, u))
        s["trunk_enc_u"].append(opt(q["trunk_enc_u"][i], f"trunk_enc_u[{i}]",
                                    f32, (1, u)))
        s["enc_r"].append(opt(q["enc_r"][i], f"enc_r[{i}]", f32, (1, LANE)))
        if i and (q["trunk_enc_w"][i] is None) != (q["enc_r"][i] is None):
            raise ValueError(f"layer {i}: trunk_enc_w and enc_r must both be "
                             f"given or both be None")
    if q["enc_r"][0] is None or q["trunk_enc_w"][0] is not None:
        raise ValueError("layer 0 reads the encoding through trunk_w[0] and "
                         "enc_r[0]")
    shapes = {"w_feat": (u, u), "w_sig": (u, LANE), "w_feat_enc": (LANE, u),
              "w_sig_enc": (LANE, LANE), "w_rf_top": (u, half),
              "w_rf_enc": (LANE, half), "w_rgb": (half, LANE),
              "u_feat": (1, u), "b_feat": (1, u), "r_feat": (1, u),
              "u_sig": (1, LANE), "b_sig": (1, LANE),
              "u_feat_enc": (1, u), "u_sig_enc": (1, LANE),
              "enc_r_sf": (1, LANE), "u_rf_top": (1, half),
              "u_rf_enc": (1, half), "enc_r_rf": (1, LANE), "b_rf": (1, half),
              "r_rf": (1, half), "u_rgb": (1, LANE), "b_rgb": (1, LANE)}
    last = ("w_feat_enc", "u_feat_enc", "w_sig_enc", "u_sig_enc", "enc_r_sf")
    if len({q[k] is None for k in last}) != 1:
        raise ValueError(f"{', '.join(last)} must all be given or all None")
    for name in _INT8_HEAD_ARRAYS:
        dtype = i8 if name.startswith("w_") else f32
        if q[name] is None and name not in last:
            raise ValueError(f"{name} is missing")
        s[name] = opt(q[name], name, dtype, shapes[name])
    # The pointers the kernel reads: the transposed copies of every int8
    # array checked above.
    t = transposed_int8_weights(q)
    s["trunk_w"] = [w.data_ptr() for w in t["trunk_w"]]
    s["trunk_enc_w"] = [None if w is None else w.data_ptr()
                        for w in t["trunk_enc_w"]]
    for name in _INT8_HEAD_ARRAYS:
        if name.startswith("w_"):
            s[name] = None if t[name] is None else t[name].data_ptr()
    return s


def _mlp_int8_struct(q: dict, device: torch.device) -> _MlpInt8Weights:
    """The resident kernel's ``MlpInt8Weights`` (at most
    :data:`MAX_LAYERS` layers) from :func:`_mlp_int8_pointers`."""
    ptrs = _mlp_int8_pointers(q, device)
    n = len(ptrs["trunk_w"])
    if n > MAX_LAYERS:
        raise ValueError(f"the resident ray_march_mlp_int8 kernel takes at "
                         f"most {MAX_LAYERS} layers (got {n})")
    s = _MlpInt8Weights()
    for key in ("trunk_w", "trunk_u", "trunk_b", "trunk_r", "trunk_enc_w",
                "trunk_enc_u", "enc_r"):
        for i, x in enumerate(ptrs[key]):
            getattr(s, key)[i] = x
    for name in _INT8_HEAD_ARRAYS:
        setattr(s, name, ptrs[name])
    s.n_layers = n
    s.units = q["trunk_b"][0].shape[1]
    return s


def mlp_int8_table_entries(q: dict) -> tuple:
    """``(maps, pointers)`` of a quantized state's device table, in the
    order of :func:`mlp_int8_table_layout`: the transposed int8 weights
    (made once per quantized state) in [64 rows x 128 K] boxes, and their
    pointers where the kernel reads a weight."""
    from keras_nerf_tpu_torch.kernels.quantize import transposed_int8_weights

    t = transposed_int8_weights(q)
    maps = [(w, 64) for w in [*t["trunk_w"], *t["trunk_enc_w"],
                              *(t[k] for k in I8_HEAD_MAPS)]]
    pointers = [x for key in I8_LAYER_POINTERS for x in
                (t["trunk_enc_w"] if key == "trunk_enc_w" else q[key])]
    pointers += [t[k] if k.startswith("w_") else q[k]
                 for k in _INT8_HEAD_ARRAYS]
    return maps, pointers


def _mlp_int8_table(q: dict, device: torch.device, lib) -> torch.Tensor:
    """The device table of a quantized state, its arrays checked as for the
    resident kernel."""
    _mlp_int8_pointers(q, device)
    return _device_table(*mlp_int8_table_entries(q), device, lib)


I8_TILE = 64         # csrc/ray_march_mlp_int8.cu: kTile, points per block
I8_KBOX = 128        # kKBox: K bytes of a swizzled row, one TMA box
I8_SLAB_BYTES = I8_TILE * I8_KBOX   # kSlabBytes: a 128-K slab of codes
I8_ENC_BYTES = I8_TILE * LANE * 4   # kEncBytes: the float32 encoding tile
I8_MAX_STAGES = 4    # kMaxStages
SMEM_PER_SM = 233472  # kSmemPerSm: 228 KB an SM, 1 KB of it per block


def ray_march_mlp_int8_plan(units: int, n_layers: int = 8) -> dict:
    """The route, tile, parts and shared memory of the
    ``ray_march_mlp_int8`` kernel for ``n_layers`` layers of ``units``
    (mirrors csrc/ray_march_mlp_int8.cu).

    ``route`` "resident" (u up to 1280, at most :data:`MAX_LAYERS` layers):
    the code tiles stay in shared memory. ``tile``: 64 points per block;
    ``part``: output columns a product takes at once, 128 up to u = 1024 and
    64 above; ``stages``: ring stages of ``[part x 128]`` int8 weights, 2
    where two blocks then share an SM (``blocks_per_sm``), else as many as
    fit, at most 4; ``smem_bytes``: 1 KB of alignment, the two ping-pong
    code tiles, the encoding's code tile and float32 tile, two parts'
    epilogue vectors (four float32 per column), and the ring with its
    mbarriers.

    ``route`` "streamed" (any other multiple of 256, any depth): the codes
    go through an int8 scratch in device memory, parts of 128 columns;
    ``smem_bytes`` (the ring, the encoding's code tile, the mbarriers) does
    not grow with the width. Raises, naming the width, on one outside the
    JAX package's envelope."""
    _check_units("ray_march_mlp_int8", units)
    part = 128 if units <= 1024 else 64
    fixed = (1024 + 2 * I8_TILE * units + I8_SLAB_BYTES + I8_ENC_BYTES
             + 2 * part * 16)
    stage = part * I8_KBOX + 16
    most = (SMEM_PER_BLOCK - fixed) // stage
    if most < 2 or n_layers > MAX_LAYERS:
        return {**_streamed_plan(units, I8_SLAB_BYTES
                                 + 8 * (2 * STREAM_STAGES + 1)),
                "part": STREAM_PASS}
    if 2 * (fixed + 2 * stage + 1024) <= SMEM_PER_SM:
        stages, blocks = 2, 2
    else:
        stages, blocks = min(I8_MAX_STAGES, most), 1
    return {"route": "resident", "tile": I8_TILE, "part": part,
            "stages": stages, "blocks_per_sm": blocks,
            "smem_bytes": fixed + stages * stage}


def _ray_march_mlp_int8_cuda(q, base, slope, depths, masks, sigma_only=False,
                             lib=None):
    """The ``ray_march_mlp_int8`` launch; ``lib`` another build of its C
    entry point (``time_ray_march_mlp_int8`` times a parent's kernel
    through it), else this package's library."""
    from keras_nerf_tpu_torch.kernels._build import load

    dev = base.device
    r, s = depths.shape
    f32 = torch.float32
    n, u = len(q["trunk_w"]), q["trunk_b"][0].shape[1]
    plan = ray_march_mlp_int8_plan(u, n)
    lib = load() if lib is None else lib
    args = (_check(base, "base", f32, dev, (r, LANE)),
            _check(slope, "slope", f32, dev, (r, LANE)),
            _check(depths, "depths", f32, dev),
            _check(masks, "masks", f32, dev, (3, LANE)))
    out = torch.empty((r * s,) if sigma_only else (r * s, 4), dtype=f32,
                      device=dev)
    if plan["route"] == "streamed":
        table = _mlp_int8_table(q, dev, lib)
        scratch = torch.empty((2, r * s, u), dtype=torch.int8, device=dev)
        with torch.cuda.device(dev):
            _raise_on_mapped(lib.knt_ray_march_mlp_int8_streamed(
                table.data_ptr(), n, u, *args, out.data_ptr(), r, s,
                int(sigma_only), scratch.data_ptr(), _stream(dev)),
                "ray_march_mlp_int8 (streamed)")
        return out
    weights = _mlp_int8_struct(q, dev)
    with torch.cuda.device(dev):
        _raise_on_mapped(lib.knt_ray_march_mlp_int8(
            ctypes.addressof(weights), *args, out.data_ptr(), r, s,
            int(sigma_only), _stream(dev)), "ray_march_mlp_int8")
    return out


QUAD_MAX_K = 8          # csrc/ray_march_quadrature.cu: kMaxK, samples a lane
QUAD_WINDOW = 32 * QUAD_MAX_K   # kWindow: the windowed route's step
# kMaxCarries: the with_grad mode keeps a float carry for every window but
# the last in shared memory, at most 2047 a ray (S <= 2^19), which at 16
# rays a block still fit beside their staging buffers.
QUAD_MAX_CARRIES = 2047
# Warps (rays) a block, by measurement (time_quadrature, NVIDIA H100 80GB
# HBM3): 8 in sigma-only mode, 4 where the colours go through the staging
# buffer (at [4096 x 192] 8 read 0.0060 ms a launch, 4 0.0056).
QUAD_RAYS_PER_BLOCK = {"sigma_only": 8, "colour": 4}


def quadrature_plan(s: int, with_grad: bool = False,
                    sigma_only: bool = False) -> dict:
    """The route and block shape of the ``ray_march_quadrature`` kernel for
    ``s`` samples a ray (mirrors csrc/ray_march_quadrature.cu): a warp a
    ray, each lane holding ``k = ceil(s / 32)`` consecutive samples in
    registers up to 256 samples (``route`` "registers", one window); above,
    ``k`` = 8 and the warp walks ``windows`` of 256 carrying the scan
    ("windowed"); no sample leaves the background alone. The with_grad
    mode keeps the carry in front of each window but the last in shared
    memory for its reverse walk, at most ``QUAD_MAX_CARRIES``: it takes 1
    to 2^19 samples and raises, by name, outside."""
    most = (QUAD_MAX_CARRIES + 1) * QUAD_WINDOW
    if s < 0 or with_grad and not 1 <= s <= most:
        raise ValueError(f"ray_march_quadrature's with_grad mode takes at "
                         f"most {most} samples per ray, and at "
                         f"least 1 (got {s})")
    k = max(1, min(QUAD_MAX_K, -(-s // 32)))
    windows = -(-s // (32 * k))
    return {"route": "registers" if windows <= 1 else "windowed", "k": k,
            "windows": windows, "rays_per_block": QUAD_RAYS_PER_BLOCK[
                "sigma_only" if sigma_only else "colour"]}


def _ray_march_quadrature_cuda(rgbs, t, white_background=False,
                               sigma_only=False, emit_weights=True,
                               target=None, loss_scale=0.0, lib=None,
                               rays_per_block=None):
    """The ``ray_march_quadrature`` launch, one kernel a call: it writes
    every output (the image's zeros in sigma-only mode too). ``lib``
    another build of its C entry points and ``rays_per_block`` another
    block shape (``time_quadrature`` times both), else this package's
    library and the plan's."""
    from keras_nerf_tpu_torch.kernels._build import load

    dev = t.device
    r, s = t.shape
    f32 = torch.float32
    if target is not None and sigma_only:
        raise ValueError("the with_grad mode needs the colour: not "
                         "sigma_only")
    plan = quadrature_plan(s, target is not None, sigma_only)
    rpb = plan["rays_per_block"] if rays_per_block is None else rays_per_block
    lib = load() if lib is None else lib
    rgbs_ptr = _check(rgbs, "rgbs", f32, dev,
                      (r, s) if sigma_only else (r, s, 4))
    if not sigma_only and rgbs_ptr % 16:
        raise ValueError("rgbs must be 16-byte aligned: the kernel reads a "
                         "sample's (r, g, b, sigma) as one float4")
    t_ptr = _check(t, "t", f32, dev)
    image = torch.empty((r, 3), dtype=f32, device=dev)
    depth = torch.empty((r,), dtype=f32, device=dev)
    weights = (torch.empty((r, s), dtype=f32, device=dev) if emit_weights
               else None)
    w_ptr = None if weights is None else weights.data_ptr()
    if target is None:
        with torch.cuda.device(dev):
            _raise_on(lib.knt_ray_march_quadrature(
                rgbs_ptr, t_ptr, image.data_ptr(), depth.data_ptr(), w_ptr,
                r, s, int(white_background), int(sigma_only), rpb,
                _stream(dev)), "ray_march_quadrature")
        return image, depth, weights
    d_rgb = torch.empty((r * s, D_HEAD), dtype=torch.bfloat16, device=dev)
    d_sigma = torch.empty((r * s,), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _raise_on(lib.knt_ray_march_quadrature_grad(
            rgbs_ptr, t_ptr, _check(target, "target", f32, dev, (r, 3)),
            image.data_ptr(), depth.data_ptr(), w_ptr, d_rgb.data_ptr(),
            d_sigma.data_ptr(), r, s, int(white_background),
            _f32(loss_scale), rpb, _stream(dev)), "ray_march_quadrature")
    return image, depth, weights, d_rgb, d_sigma


BWD_TILE_ELEMS = 128 * 256   # csrc/mlp_backward.cu: points x u of a tile (u = 256, 512)
BWD_STAGES = 3               # kStages: ring stages of weight slabs
BWD_STAGE_BYTES = 128 * 256  # one TMA box of [64 K x 256 rows] bf16
BWD_WIDE_STAGES = 2          # kWideStages: the ring at u = 768
BWD_WIDE_STAGE_BYTES = 128 * 128  # kWideStageBytes: [64 K x 128 rows]
SMEM_PER_BLOCK = 232448      # the H100's 227 KB of shared memory a block


def mlp_backward_plan(units: int, n_layers: int = 8) -> dict:
    """The route, tile and shared memory of the ``mlp_backward`` kernel for
    ``n_layers`` layers of ``units`` (mirrors csrc/mlp_backward.cu).

    ``route`` "resident" (u = 256, 512 or 768, at most :data:`MAX_LAYERS`
    layers): the cotangent and mask tiles stay in shared memory. ``tile``:
    points per block, 128 at u = 256 (the two consumer warpgroups take 64
    rows each) and 64 at u = 512 and 768 (each takes half the columns);
    ``stages`` of ``stage_bytes``: the ring of weight slabs, 3 of 32 KB, or
    2 of 16 KB at u = 768, where the cotangent and mask tiles take 96 KB
    each; ``smem_bytes``: those two tiles, the ring, the tile's
    ``d_sigma_pre`` (float32), the sigma column of ``w_sf`` (bf16), the
    mbarriers and 1 KB of alignment.

    ``route`` "streamed" (any other multiple of 256, any depth): each
    layer's cotangent, written to device memory for ``mlp_weight_grad``
    anyway, is read back as the next layer's input and the masks come from
    the stash, so ``smem_bytes`` (the ring, the head cotangent tile,
    ``d_sigma_pre``, the mbarriers) does not grow with the width. Raises,
    naming the width, on one outside the JAX package's envelope."""
    _check_units("mlp_backward", units)
    if units > 768 or n_layers > MAX_LAYERS:
        return _streamed_plan(units, STREAM_TILE * 128 + 4 * STREAM_TILE
                              + 8 * (2 * STREAM_STAGES + 1))
    wide = units == 768
    tile = 64 if wide else BWD_TILE_ELEMS // units
    stages, stage = ((BWD_WIDE_STAGES, BWD_WIDE_STAGE_BYTES) if wide
                     else (BWD_STAGES, BWD_STAGE_BYTES))
    smem = (1024 + 2 * 2 * tile * units + stages * stage + 4 * tile
            + 2 * units + 8 * (2 * stages + 2))
    return {"route": "resident", "tile": tile,
            "split": "rows" if units == 256 else "columns",
            "stages": stages, "stage_bytes": stage, "smem_bytes": smem}


def _mlp_backward_cuda(d_rgb, d_sigma, packed, stash, cots=None,
                       from_output=False, lib=None):
    """The ``mlp_backward`` launch; ``lib`` another build of its C entry
    points (``time_mlp_backward`` times a parent's kernel through it),
    else this package's library."""
    from keras_nerf_tpu_torch.kernels._build import load

    dev = d_rgb.device
    p = d_rgb.shape[0]
    u, n = packed["trunk_b"][0].shape[1], len(packed["trunk_w"])
    plan = mlp_backward_plan(u, n)
    lib = load() if lib is None else lib
    if cots is None:
        cots = alloc_cotangents(p, u, n, dev)
    if plan["route"] == "streamed":
        return _mlp_backward_streamed(d_rgb, d_sigma, packed, stash, cots,
                                      from_output, lib)
    weights = _mlp_struct(packed, dev)
    stash_s = _stash_struct(stash, p, u, n, dev)
    bf16 = torch.bfloat16
    ct = _MlpCotangents()
    ct.d_rf = _check(cots["d_rf"], "d_rf", bf16, dev, (p, u // 2))
    ct.d_sf = _check(cots["d_sf"], "d_sf", bf16, dev, (p, u + D_HEAD))
    for i in range(n):
        ct.d_pre[i] = _check(cots["d_pre"][i], f"d_pre[{i}]", bf16, dev,
                             (p, u))
    if from_output:
        g, y = d_rgb, d_sigma
        d_rgb = torch.empty((p, D_HEAD), dtype=bf16, device=dev)
        with torch.cuda.device(dev):
            err = lib.knt_mlp_backward_from_output(
                ctypes.addressof(weights), _check(g, "g", bf16, dev, (p, 4)),
                _check(y, "y", torch.float32, dev, (p, 4)), d_rgb.data_ptr(),
                ctypes.addressof(stash_s), ctypes.addressof(ct), p,
                _stream(dev))
    else:
        with torch.cuda.device(dev):
            err = lib.knt_mlp_backward(
                ctypes.addressof(weights),
                _check(d_rgb, "d_rgb", bf16, dev, (p, D_HEAD)),
                _check(d_sigma, "d_sigma", bf16, dev, (p,)),
                ctypes.addressof(stash_s), ctypes.addressof(ct), p,
                _stream(dev))
    _raise_on_mapped(err, "mlp_backward")
    cots["d_rgb"] = d_rgb
    return cots


def _mlp_backward_streamed(d_rgb, d_sigma, packed, stash, cots, from_output,
                           lib):
    """The streamed ``mlp_backward`` (``knt_mlp_backward_streamed``), both
    modes; the stash's h and the cotangents' d_pre each read as one
    ``[n, P, u]`` array."""
    dev = d_rgb.device
    p = d_rgb.shape[0]
    u, n = packed["trunk_b"][0].shape[1], len(packed["trunk_w"])
    if p >= 2 ** 31:
        raise ValueError(f"the MLP kernels take fewer than 2^31 points "
                         f"(got {p})")
    table = _mlp_table(packed, dev, lib)
    bf16 = torch.bfloat16
    h = _planes(stash["h"], p, u, dev, "stash h")
    d_pre = _planes(cots["d_pre"], p, u, dev, "d_pre")
    d_rf = _check(cots["d_rf"], "d_rf", bf16, dev, (p, u // 2))
    d_sf = _check(cots["d_sf"], "d_sf", bf16, dev, (p, u + D_HEAD))
    if from_output:
        g, y = d_rgb, d_sigma
        d_rgb = torch.empty((p, D_HEAD), dtype=bf16, device=dev)
        heads = (None, None, _check(g, "g", bf16, dev, (p, 4)),
                 _check(y, "y", torch.float32, dev, (p, 4)),
                 d_rgb.data_ptr())
    else:
        heads = (_check(d_rgb, "d_rgb", bf16, dev, (p, D_HEAD)),
                 _check(d_sigma, "d_sigma", bf16, dev, (p,)), None, None,
                 None)
    with torch.cuda.device(dev):
        _raise_on_mapped(lib.knt_mlp_backward_streamed(
            table.data_ptr(), n, u, *heads, h, d_rf, d_sf, d_pre, p,
            _stream(dev)), "mlp_backward (streamed)")
    cots["d_rgb"] = d_rgb
    return cots


def _wg_n_tiles(n: int) -> list:
    """``(n0, nt)`` of the N tiles of a task: 256-wide, then one of 128 or
    64 for the rest (a 16-wide tail takes a 64 tile whose columns past
    ``n`` are zeros)."""
    tiles, n0 = [], 0
    while n - n0 >= 256:
        tiles.append((n0, 256))
        n0 += 256
    rest = n - n0
    if rest > 128:
        tiles.append((n0, 256))
    elif rest > 64:
        tiles.append((n0, 128))
    elif rest > 0:
        tiles.append((n0, 64))
    return tiles


def weight_grad_plan(shapes, points: int) -> dict:
    """The blocks of the ``mlp_weight_grad`` kernel, a function of the
    shapes alone (so one input always gives one result, bit for bit).

    ``shapes``: ``(K, N, has_bias)`` per task, ``K`` a multiple of 128.
    Returns ``tiles`` (``(task, m0, n0, nt)``: rows ``m0 .. m0 + 127`` and
    columns ``n0 .. n0 + nt - 1`` below ``N``, the blocks of one slice, the
    two row tiles of one N tile side by side), the point slices (``slices``
    of ``chunk`` points, a multiple of :data:`WG_STEP`, from 0; ``bounds``
    their ``[begin, end)``, only the last ending at ``points``), each
    task's offsets into the float32 partial buffer (``poff``: ``slices x
    [K, N]``; ``bpoff``: then ``slices x [N]`` where it has a bias), the
    buffer's size ``partial_floats``, and the ``launches`` of the call
    (:func:`_wg_launches`): one, unless the call holds more than
    :data:`MAX_WG_TASKS` tasks or :data:`MAX_WG_TILES` tiles."""
    tiles = []
    for j, (k, n, _) in enumerate(shapes):
        if k % WG_TILE_K or n % 16 or k <= 0 or n <= 0:
            raise ValueError(f"mlp_weight_grad task {j}: K = {k} must be a "
                             f"multiple of {WG_TILE_K} and N = {n} of 16")
        for n0, nt in _wg_n_tiles(n):
            tiles += [(j, m0, n0, nt) for m0 in range(0, k, WG_TILE_K)]
    steps = max(1, -(-points // WG_STEP))
    want = -(-WG_WAVES * WG_SMS // len(tiles))
    slices = max(1, min(want, steps // WG_MIN_STEPS))
    per = -(-steps // slices)
    slices = -(-steps // per)
    chunk = per * WG_STEP
    poff, bpoff, off = [], [], 0
    for k, n, bias in shapes:
        poff.append(off)
        bpoff.append(off + slices * k * n)
        off += slices * (k * n + (n if bias else 0))
    return {"tiles": tiles, "slices": slices, "chunk": chunk,
            "bounds": [(s * chunk, min(points, (s + 1) * chunk))
                       for s in range(slices)],
            "poff": poff, "bpoff": bpoff, "partial_floats": off,
            "launches": _wg_launches(tiles)}


def _wg_launches(tiles) -> list:
    """The call's tiles split into launches of consecutive tiles, each with
    at most :data:`MAX_WG_TILES` tiles of at most :data:`MAX_WG_TASKS`
    tasks: ``{"tiles": (first, end), "tasks": [task, ...] (the table of the
    launch, in order), "reduce": [task, ...]}``, ``reduce`` the tasks whose
    last tile the launch holds, whose slices it adds into their
    accumulators. Each block's tile, slice and partial offsets are the
    plan's whatever the split, and a task is added up only after every
    launch that writes its partials, in slice order: one result, bit for
    bit."""
    last = {tl[0]: i for i, tl in enumerate(tiles)}
    launches, first, tasks = [], 0, []

    def close(end):
        launches.append({"tiles": (first, end), "tasks": tasks,
                         "reduce": [j for j in tasks
                                    if first <= last[j] < end]})

    for i, (task, *_) in enumerate(tiles):
        new = task not in tasks
        if i - first == MAX_WG_TILES or (new and len(tasks) == MAX_WG_TASKS):
            close(i)
            first, tasks, new = i, [], True
        if new:
            tasks = tasks + [task]
    close(len(tiles))
    return launches


def _mlp_weight_grad_cuda(stash, cots, grads):
    from keras_nerf_tpu_torch.kernels._build import load

    lib = load()
    tasks = weight_grad_tasks(stash, cots, grads)
    dev = stash["enc"].device
    p = stash["enc"].shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    for j, (a, g, out, _) in enumerate(tasks):
        if out.shape[0] != a.shape[1] or out.shape[1] < g.shape[1]:
            raise ValueError(f"mlp_weight_grad task {j}: A [P, {a.shape[1]}]"
                             f", G [P, {g.shape[1]}] and out "
                             f"{tuple(out.shape)} do not fit [K, >= N]")
    plan = weight_grad_plan([(a.shape[1], g.shape[1], bias is not None)
                             for a, g, _, bias in tasks], p)
    if plan["partial_floats"] >= 2 ** 31:
        raise ValueError("mlp_weight_grad: partial sums exceed 2^31 floats")
    rows = []
    for j, (a, g, out, bias) in enumerate(tasks):
        k, n = a.shape[1], g.shape[1]
        rows.append(dict(
            a=_check(a, f"A[{j}]", bf16, dev, (p, k)),
            g=_check(g, f"G[{j}]", bf16, dev, (p, n)),
            out=_check(out, f"out[{j}]", f32, dev),
            bias_out=(None if bias is None else
                      _check(bias, f"bias_out[{j}]", f32, dev,
                             (1, out.shape[1]))),
            k=k, n=n, ldo=out.shape[1], poff=plan["poff"][j],
            bpoff=plan["bpoff"][j]))
    partial = torch.empty((plan["partial_floats"],), dtype=f32, device=dev)
    for launch in plan["launches"]:
        local = {j: i for i, j in enumerate(launch["tasks"])}
        table = (_WgTask * len(local))(*(
            _WgTask(**rows[j], reduce=int(j in launch["reduce"]))
            for j in launch["tasks"]))
        first, end = launch["tiles"]
        tiles = (_WgTile * (end - first))(*(
            (local[j], m0, n0, nt) for j, m0, n0, nt in
            plan["tiles"][first:end]))
        with torch.cuda.device(dev):
            err = lib.knt_mlp_weight_grad(
                ctypes.addressof(table), len(local), ctypes.addressof(tiles),
                len(tiles), p, plan["slices"], plan["chunk"],
                partial.data_ptr(), _stream(dev))
        _raise_on_mapped(err, "mlp_weight_grad")
    return grads


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


class KernelWrapper:
    """One kernel's entry point: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors. ``launches`` counts kernel launches only (the
    plain version never touches it), and each launch also counts in the
    open spans' ``csrc_launches`` (``spans.csrc_launched``); ``source`` and
    ``replaces`` name the CUDA source and the TPU kernel it ports."""

    def __init__(self, name: str, plain, launch, source: str, replaces: str):
        self.name = name
        self.plain = plain
        self._launch = launch
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def __call__(self, *args, **kwargs):
        device = _first_tensor(args).device
        if device.type == "cpu":
            return self.plain(*args, **kwargs)
        if device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {device}")
        out = self._launch(*args, **kwargs)
        self.launches += 1
        spans.csrc_launched()
        return out

    def __repr__(self):
        return f"KernelWrapper({self.name}, launches={self.launches})"


_CSRC = "keras_nerf_tpu_torch/kernels/csrc/"
_TPU = "keras_nerf_tpu/kernels/ray_march.py"

# Each kernel replaces one part of the TPU's fused_train_chunk (:1384), named
# by the line of that part: _sample_merge_prologue, _forward_core (with the
# in-kernel encoding at :1259), _quadrature_fwd (with the sigma_only
# epilogue at :1296 and, with a target, _quadrature_bwd at :1158),
# _backward_core's dX chain and its dW sums (_acc_out).
sample_merge = KernelWrapper(
    "sample_merge", sample_merge_plain, _sample_merge_cuda,
    _CSRC + "sample_merge.cu", _TPU + ":987")
ray_march_mlp = KernelWrapper(
    "ray_march_mlp", ray_march_mlp_plain, _ray_march_mlp_cuda,
    _CSRC + "ray_march_mlp.cu", _TPU + ":369")
ray_march_quadrature = KernelWrapper(
    "ray_march_quadrature", ray_march_quadrature_plain,
    _ray_march_quadrature_cuda, _CSRC + "ray_march_quadrature.cu",
    _TPU + ":1102")
mlp_backward = KernelWrapper(
    "mlp_backward", mlp_backward_plain, _mlp_backward_cuda,
    _CSRC + "mlp_backward.cu", _TPU + ":804")
mlp_weight_grad = KernelWrapper(
    "mlp_weight_grad", mlp_weight_grad_plain, _mlp_weight_grad_cuda,
    _CSRC + "mlp_weight_grad.cu", _TPU + ":500")
# The TPU's fused_apply_mlp (T5), through ray_march_mlp.cu's input mode.
apply_mlp = KernelWrapper(
    "apply_mlp", apply_mlp_plain, _apply_mlp_cuda,
    _CSRC + "ray_march_mlp.cu", _TPU + ":438")
# The int8 trunk of fused_train_chunk(quantized=True) (T4).
ray_march_mlp_int8 = KernelWrapper(
    "ray_march_mlp_int8", ray_march_mlp_int8_plain, _ray_march_mlp_int8_cuda,
    _CSRC + "ray_march_mlp_int8.cu", "keras_nerf_tpu/kernels/quantize.py:248")
# The tensor-core ceiling probe (T7), on no path of the package.
mma_ceiling = KernelWrapper(
    "mma_ceiling", mma_ceiling_plain, mma_ceiling_cuda,
    _CSRC + "mma_ceiling.cu", "scripts/profile_mxu_ceiling.py:87")

KERNELS = (sample_merge, ray_march_mlp, ray_march_quadrature, mlp_backward,
           mlp_weight_grad, apply_mlp, ray_march_mlp_int8, mma_ceiling)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def fused_render_chunk(packed: dict, origin: torch.Tensor,
                       direction: torch.Tensor, points: torch.Tensor | None,
                       pos_emb_xyz: int = 10,
                       pos_emb_dir: int = 4, white_background: bool = False,
                       emit_weights: bool = True, sigma_only: bool = False,
                       sample_inputs: tuple | None = None,
                       quantized: bool = False):
    """One model's no-grad pass over a ray chunk through the kernels: the
    port's ``fused_train_chunk(with_grad=False)`` (`ray_march.py:1384`).
    The JAX package's ``fused_render_chunk`` is :func:`point_render_chunk`.

    Args:
      packed: :func:`pack_mlp_params` output (on the rays' device), or with
        ``quantized`` a :func:`~keras_nerf_tpu_torch.kernels.quantize.
        quantize_packed` dict: the int8 render tier, whose MLP is
        :data:`ray_march_mlp_int8` (`ray_march.py:1285-1290`).
      origin/direction: ``[R, 3]`` float32.
      points: ``[R, S]`` sorted depths, or None with ``sample_inputs``.
      sigma_only: density pass only (requires ``emit_weights``): the image
        comes back zero and the colour heads are skipped.
      sample_inputs: sample the depths in :data:`sample_merge` instead:
        ``(cp [R, s_c], w [R, s_c], u [R, n])`` draws from the coarse
        weights and merges with the coarse depths ``cp`` (``s_m = -1``);
        the TPU kernel's 4-tuple ``(cp, w, u, mp)`` names the merge partner
        apart from the CDF source (`ray_march.py:1439-1466`): ``None``
        merges nothing (``s_m = 0``, the occupancy render over probe bins),
        a sorted ``[R, s_m]`` tensor is merged in (``s_m > 0``). The
        3-tuple is the 4-tuple with ``mp = cp``.

    Returns ``(image [R, 3], depth [R], weights [R, S] or None)``.
    """
    if sigma_only and not emit_weights:
        raise ValueError("sigma_only is the coarse render pass: it emits "
                         "weights")
    points = _pass_points(points, sample_inputs)
    base, slope, masks = ray_encoding_coeffs(origin, direction, pos_emb_xyz,
                                             pos_emb_dir)
    mlp = ray_march_mlp_int8 if quantized else ray_march_mlp
    rgbs = mlp(packed, base, slope, points, masks, sigma_only=sigma_only)
    r, s = points.shape
    rgbs = rgbs.reshape((r, s) if sigma_only else (r, s, 4))
    return ray_march_quadrature(rgbs, points,
                                white_background=white_background,
                                sigma_only=sigma_only,
                                emit_weights=emit_weights)


def point_render_chunk(packed: dict, origin: torch.Tensor,
                       direction: torch.Tensor, points: torch.Tensor,
                       pos_emb_xyz: int = 10, pos_emb_dir: int = 4,
                       white_background: bool = False) -> RenderOutput:
    """No-grad render of a chunk through :data:`apply_mlp`: the port of the
    JAX package's ``fused_render_chunk`` (`ray_march.py:762-796`), whose
    name the port gives to the ray-march kernels' render pass.

    :func:`ray_points`, :func:`encode_block128`, ``apply_mlp``, then the
    reference quadrature ``render_rays``. ``points [R, S]`` sorted depths;
    returns ``RenderOutput(image [R, 3], depth [R], weights [R, S])``."""
    r, s = points.shape
    enc = encode_block128(*ray_points(origin, direction, points),
                          pos_emb_xyz, pos_emb_dir)
    out = apply_mlp(packed, enc)
    return render_rays(out[:, :3].reshape(r, s, 3), out[:, 3].reshape(r, s),
                       points, white_background=white_background)


def _pass_points(points, sample_inputs):
    if sample_inputs is not None:
        if points is not None:
            raise ValueError("pass points or sample_inputs, not both")
        if len(sample_inputs) not in (3, 4):
            raise ValueError("sample_inputs is (cp, w, u) or (cp, w, u, mp)")
        cp, wc, u = (x.to(torch.float32) for x in sample_inputs[:3])
        # A row broadcast to every ray (stride 0) is read as it is.
        if cp.stride(0) != 0:
            cp = cp.contiguous()
        wc, u = wc.contiguous(), u.contiguous()
        mp = sample_inputs[3] if len(sample_inputs) == 4 else cp
        if mp is not None:
            mp = mp.to(torch.float32).contiguous()
        points = sample_merge(cp, wc, u, mp)
    return points.to(torch.float32).contiguous()


def zero_grads(packed: dict) -> dict:
    """Float32 zeros in the layout of :func:`pack_mlp_params` (None where
    the packed dict has None): the accumulators of the packed gradient."""
    def z(x):
        return None if x is None else torch.zeros(
            x.shape, dtype=torch.float32, device=x.device)
    return {k: [z(x) for x in v] if isinstance(v, list) else z(v)
            for k, v in packed.items()}


# Sub-launch size of the training kernels: at 8 x 256 the stash and the
# cotangents take ~10 KB per point, so a 16384-ray fine chunk (3.1 M points,
# 31 GB) runs as three launches of about 1 M points each (10 GB).
MAX_TRAIN_POINTS = 1 << 20


def train_sub_launches(rays: int, samples: int) -> list[tuple]:
    """``(r0, r1)`` ray ranges of the training sub-launches: the fewest
    that keep each near :data:`MAX_TRAIN_POINTS` points, split evenly."""
    n = max(1, -(-rays * samples // MAX_TRAIN_POINTS))
    step = -(-rays // n)
    return [(r0, min(rays, r0 + step)) for r0 in range(0, rays, step)]


def fused_train_chunk(packed: dict, origin: torch.Tensor,
                      direction: torch.Tensor, points: torch.Tensor | None,
                      target: torch.Tensor, pos_emb_xyz: int = 10,
                      pos_emb_dir: int = 4, white_background: bool = False,
                      emit_weights: bool = True,
                      sample_inputs: tuple | None = None,
                      grads: dict | None = None):
    """One model's pass over a ray chunk through the kernels, with the
    packed gradient of the chunk's MSE: the port of the TPU's
    ``fused_train_chunk(with_grad=True)`` (`ray_march.py:1384`); its
    no-grad modes are :func:`fused_render_chunk`.

    For each sub-launch of whole rays (:func:`train_sub_launches`), in
    order:
    :data:`ray_march_mlp` in its train mode (forward, every bf16 activation
    kept), :data:`ray_march_quadrature` with the target (image, depth,
    weights and the head cotangents of the loss), :data:`mlp_backward` (the
    dX chain) and :data:`mlp_weight_grad` (dW and db, added into
    ``grads``). With ``sample_inputs``, :data:`sample_merge` runs once over
    the chunk first, in any of its three modes.

    Args:
      packed: :func:`pack_mlp_params` output.
      origin/direction: ``[R, 3]`` float32; ``target [R, 3]`` float32.
      points / sample_inputs: as in :func:`fused_render_chunk`.
      grads: float32 accumulators (:func:`zero_grads`) to add this chunk's
        gradient into; new zeros when None.

    Returns ``(image [R, 3], depth [R], weights [R, S] or None, grads)``:
    ``grads`` holds (plus what it held) the packed gradient of
    ``mean((clip(image) - target)^2)`` over the chunk (`:1345-1362`).
    """
    if target is None:
        raise ValueError("fused_train_chunk needs the target colours")
    points = _pass_points(points, sample_inputs)
    base, slope, masks = ray_encoding_coeffs(origin, direction, pos_emb_xyz,
                                             pos_emb_dir)
    target = target.to(torch.float32).contiguous()
    if grads is None:
        grads = zero_grads(packed)
    r, s = points.shape
    u = packed["trunk_b"][0].shape[1]
    n_layers = len(packed["trunk_w"])
    dev = points.device
    # The MSE cotangent 2 (image - target) / (3 R) of the WHOLE chunk.
    loss_scale = 2.0 / (3 * r)
    image = torch.empty((r, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((r,), dtype=torch.float32, device=dev)
    weights = (torch.empty((r, s), dtype=torch.float32, device=dev)
               if emit_weights else None)
    for r0, r1 in train_sub_launches(r, s):
        stash = alloc_stash((r1 - r0) * s, u, n_layers, dev)
        rgbs = ray_march_mlp(packed, base[r0:r1], slope[r0:r1],
                             points[r0:r1], masks, stash=stash)
        img, dep, w, d_rgb, d_sigma = ray_march_quadrature(
            rgbs.reshape(r1 - r0, s, 4), points[r0:r1], white_background,
            False, emit_weights, target=target[r0:r1], loss_scale=loss_scale)
        cots = mlp_backward(d_rgb, d_sigma, packed, stash)
        mlp_weight_grad(stash, cots, grads)
        image[r0:r1] = img
        depth[r0:r1] = dep
        if weights is not None:
            weights[r0:r1] = w
        del stash, rgbs, cots   # one sub-launch's workspace at a time
    return image, depth, weights, grads


def _mlp_backward_pass(packed: dict, enc: torch.Tensor, g: torch.Tensor,
                       grads: dict | None, forward, backward, weight_grad):
    if grads is None:
        grads = zero_grads(packed)
    u = packed["trunk_b"][0].shape[1]
    n_layers = len(packed["trunk_w"])
    for p0, p1 in train_sub_launches(enc.shape[0], 1):
        stash = alloc_stash(p1 - p0, u, n_layers, enc.device, enc=enc[p0:p1])
        y = forward(packed, enc[p0:p1], stash)
        cots = backward(g[p0:p1], y, packed, stash, from_output=True)
        weight_grad(stash, cots, grads)
        del stash, y, cots   # one sub-launch's workspace at a time
    return grads


def fused_mlp_backward(packed: dict, enc: torch.Tensor, g: torch.Tensor,
                       grads: dict | None = None) -> dict:
    """The packed parameter gradient of the MLP over encoded points for the
    output cotangent ``g [P, 4]`` bf16 (rgb 0..2, sigma 3): the port of the
    TPU's ``fused_mlp_backward`` (T6, `ray_march.py:518-654`).

    For each sub-launch of at most :data:`MAX_TRAIN_POINTS` points, in
    order: :data:`apply_mlp` with a stash (the forward recomputed, every
    bf16 activation kept), :data:`mlp_backward` in its output-head mode and
    :data:`mlp_weight_grad`, which adds dW and db into ``grads`` (new zeros
    when None) in a fixed order. Returns ``grads``."""
    return _mlp_backward_pass(packed, enc, g, grads, apply_mlp,
                              mlp_backward, mlp_weight_grad)


def fused_mlp_backward_plain(packed: dict, enc: torch.Tensor, g: torch.Tensor,
                             grads: dict | None = None) -> dict:
    """:func:`fused_mlp_backward` through the kernels' plain versions, on
    any device: the card's reference for it."""
    return _mlp_backward_pass(packed, enc, g, grads, apply_mlp.plain,
                              mlp_backward.plain, mlp_weight_grad.plain)


def _tree_leaves(tree) -> list:
    """Leaves of nested dicts (in sorted key order) and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _tree_rebuild(like, leaves):
    """``like``'s structure with the leaves taken in :func:`_tree_leaves`
    order from the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _tree_rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return [_tree_rebuild(v, leaves) for v in like]
    return next(leaves)


class _FusedPointForward(torch.autograd.Function):
    """Forward T5 (:data:`apply_mlp`), backward T6
    (:func:`fused_mlp_backward`, recomputing the forward), as the JAX
    package's custom_vjp (`ray_march.py:731-759`)."""

    @staticmethod
    def forward(ctx, spec, positions, directions, *leaves):
        config, pos_emb_xyz, pos_emb_dir, like = spec
        params = _tree_rebuild(like, iter(leaves))
        enc = encode_block128(positions, directions, pos_emb_xyz,
                              pos_emb_dir)
        packed = pack_mlp_params(params, config, pos_emb_xyz, pos_emb_dir)
        out = apply_mlp(packed, enc)
        ctx.save_for_backward(enc)
        ctx.packed, ctx.spec = packed, spec
        return out[:, :3].contiguous(), out[:, 3:4].contiguous()

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        (enc,) = ctx.saved_tensors
        config, pos_emb_xyz, pos_emb_dir, _ = ctx.spec
        p = enc.shape[0]
        zeros = enc.new_zeros((p, 1), dtype=torch.float32)
        if g_rgb is None:
            g_rgb = zeros.expand(p, 3)
        if g_sigma is None:
            g_sigma = zeros
        # bf16, as the TPU's cotangent tile (`:745-747`).
        g = torch.cat([g_rgb, g_sigma], dim=1).to(torch.bfloat16).contiguous()
        d_packed = fused_mlp_backward(ctx.packed, enc, g)
        d_params = unpack_grads(d_packed, config, pos_emb_xyz, pos_emb_dir)
        # Positions and directions are data: no cotangent (`:755-756`).
        return (None, None, None, *_tree_leaves(d_params))


def fused_point_forward(params: dict, positions: torch.Tensor,
                        directions: torch.Tensor, config,
                        pos_emb_xyz: int = 10, pos_emb_dir: int = 4):
    """Differentiable encoding + MLP over points: ``(params, positions
    [P, 3], directions [P, 3]) -> (rgb [P, 3], sigma [P, 1])`` float32, the
    port of the JAX package's ``fused_point_forward`` custom_vjp
    (`ray_march.py:711-759`).

    Forward: :func:`encode_block128`, :func:`pack_mlp_params`, then
    :data:`apply_mlp` (T5); ``enc`` and the packed weights are kept for the
    backward. Backward: the output cotangent rounded to bf16,
    :func:`fused_mlp_backward` (T6, which recomputes the forward rather than
    keep ~5 KB of activations per point in the autograd graph) and
    :func:`unpack_grads`. Positions and directions get no gradient."""
    leaves = _tree_leaves(params)
    spec = (config, pos_emb_xyz, pos_emb_dir, params)
    return _FusedPointForward.apply(spec, positions, directions, *leaves)


def unpack_grads(d_packed: dict, config, pos_emb_xyz: int,
                 pos_emb_dir: int) -> dict:
    """Packed-layout gradients -> the reference-layout parameter tree: the
    inverse of :func:`pack_mlp_params` array for array (`ray_march.py:
    657-708`), with the encoding rows taken back out of block order."""
    u = config.dense_units
    in_x = encoded_dim(3, pos_emb_xyz)
    in_d = encoded_dim(3, pos_emb_dir)
    dev = d_packed["w_sf"].device
    inv_x = torch.argsort(_block_permutation_on(dev, pos_emb_xyz))
    inv_d = torch.argsort(_block_permutation_on(dev, pos_emb_dir))
    skip = set(config.skip_indices())
    n = config.n_layers

    def unpack_xyz(rows128):
        return rows128[ENC_XYZ_OFF:ENC_XYZ_OFF + in_x][inv_x]

    def unpack_dir(rows128):
        return rows128[ENC_DIR_OFF:ENC_DIR_OFF + in_d][inv_d]

    trunk = []
    for i in range(n):
        if i == 0:
            kernel = unpack_xyz(d_packed["trunk_w"][0])
        elif (i - 1) in skip:
            kernel = torch.cat([d_packed["trunk_w"][i],
                                unpack_xyz(d_packed["trunk_enc_w"][i])])
        else:
            kernel = d_packed["trunk_w"][i]
        trunk.append({"kernel": kernel, "bias": d_packed["trunk_b"][i][0]})
    d_sf = d_packed["w_sf"]
    if (n - 1) in skip:
        d_sf = torch.cat([d_sf, unpack_xyz(d_packed["w_sf_enc"])])
    b_sf = d_packed["b_sf"][0]
    return {
        "trunk": trunk,
        "sigma": {"kernel": d_sf[:, u:u + 1], "bias": b_sf[u:u + 1]},
        "features": {"kernel": d_sf[:, :u], "bias": b_sf[:u]},
        "rgb_features": {
            "kernel": torch.cat([d_packed["w_rf_top"],
                                 unpack_dir(d_packed["w_rf_enc"])]),
            "bias": d_packed["b_rf"][0]},
        "rgb": {"kernel": d_packed["w_rgb"][:, :3],
                "bias": d_packed["b_rgb"][0, :3]},
    }


def bwd_dx_flop_per_point(config) -> int:
    """Unpadded FLOPs per point of the backward's dX products (those whose
    input is an activation; the encoding gets no cotangent): 8 x 256 gives
    1,115,392. The dW products equal the forward's FLOPs."""
    u = config.dense_units
    return (2 * 3 * (u // 2) + 2 * (u // 2) * u + 2 * (u + 1) * u
            + 2 * u * u * (config.n_layers - 1))


def padded_fwd_flop_per_point(config, sigma_only: bool = False) -> int:
    """Padded forward FLOPs per point: the products of the JAX package's
    Pallas forward against its packed layout (`ray_march.py:194-229`), the
    encoded input a 128-lane block and the heads lane-padded. The FLOP
    model behind the JAX package's MFU figures; :func:`fwd_flop_per_point`
    is the work the function needs. 8 x 256: 1,376,256 (1,114,112
    sigma-only)."""
    u = config.dense_units
    skip = set(config.skip_indices())
    last_skip = (config.n_layers - 1) in skip
    flops = 2 * LANE * u
    for i in range(1, config.n_layers):
        flops += 2 * u * u
        if i - 1 in skip:   # the layer after a skip concat reads the encoding
            flops += 2 * LANE * u
    if sigma_only:
        flops += 2 * u * LANE
        if last_skip:
            flops += 2 * LANE * LANE
        return flops
    flops += 2 * u * (u + LANE)
    if last_skip:
        flops += 2 * LANE * (u + LANE)
    half = u // 2
    flops += 2 * u * half + 2 * LANE * half + 2 * half * LANE
    return flops


def fwd_flop_per_point(config, pos_emb_xyz: int = 10,
                       pos_emb_dir: int = 4, sigma_only: bool = False) -> int:
    """Unpadded forward FLOPs per point (2 per multiply-add): the work the
    function needs, whatever padding the kernel computes. 8 x 256 with
    L = 10 / 4: 1,186,816 (982,528 sigma-only)."""
    u = config.dense_units
    in_x = encoded_dim(3, pos_emb_xyz)
    in_d = encoded_dim(3, pos_emb_dir)
    skip = set(config.skip_indices())
    flops, width = 0, in_x
    for i in range(config.n_layers):
        flops += 2 * width * u
        width = u + (in_x if i in skip else 0)
    flops += 2 * width  # sigma
    if sigma_only:
        return flops
    flops += 2 * width * u + 2 * (u + in_d) * (u // 2) + 2 * (u // 2) * 3
    return flops
