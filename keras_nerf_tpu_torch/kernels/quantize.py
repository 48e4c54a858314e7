"""The int8 render tier (port of ``keras_nerf_tpu/kernels/quantize.py``):
post-training W8A8 quantization of the NeRF MLP for novel-view rendering.

Scheme, as in the JAX package: SmoothQuant per-feature balancing ``m_k =
sqrt(act_amax_k / weight_amax_k)`` folded into the weights, a per-tensor
static scale for each activation and a per-output-channel scale for each
weight, calibrated once per checkpoint on scene points
(:func:`collect_act_amax`, :func:`quantize_packed`); int8 x int8 products
with exact int32 sums; a float32 epilogue per layer (dequantize, bias, relu,
requantize). The sigma and rgb heads stay float32 and the quadrature is
untouched. The layout follows :func:`~keras_nerf_tpu_torch.kernels.
ray_march.pack_mlp_params` array for array, with the fused sigma/features
matrix split into ``w_feat``/``w_sig`` at pack time.

:func:`ray_march_mlp_int8_plain` is the plain version of the
``ray_march_mlp_int8`` kernel (T4, ``forward_core_int8``), which
``kernels/ray_march.py`` wraps. Training and evaluation never use this tier.
"""

from __future__ import annotations

import torch


def _amax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.abs().amax(dim=dim)


def collect_act_amax(packed: dict, enc128: torch.Tensor, config) -> dict:
    """Per-feature activation amax over calibration points (`quantize.py:
    46-67`): of the bf16 block encoding ``enc128 [P, 128]`` and of every
    activation the bf16 forward keeps, read from :data:`apply_mlp`'s stash
    mode (the T5 kernel on a card, its plain version on the CPU): each trunk
    output ``h{i}``, ``features`` and ``rf``, as float32 ``[width]``
    vectors."""
    from keras_nerf_tpu_torch.kernels.ray_march import alloc_stash, apply_mlp

    stash = alloc_stash(enc128.shape[0], config.dense_units, config.n_layers,
                        enc128.device, enc=enc128)
    apply_mlp(packed, enc128, stash=stash)
    out = {"enc": _amax(enc128.float(), 0)}
    for i, h in enumerate(stash["h"]):
        out[f"h{i}"] = _amax(h.float(), 0)
    out["features"] = _amax(stash["features"].float(), 0)
    out["rf"] = _amax(stash["rf"].float(), 0)
    return out


def _quantize_matmul(w: torch.Tensor, s_in: torch.Tensor):
    """SmoothQuant-fold one product (`quantize.py:70-84`): ``(Wq int8
    [fan, out], dequantization u [1, out], input requantization r
    [1, fan])``, float32, with ``x @ W ~= (round(x r) @ Wq) u`` for ``|x|
    <~ s_in``. Rows of W that are all zero (padding) get ``r = 0``."""
    w = w.float()
    w_amax = _amax(w, 1)
    valid = w_amax > 0
    m = torch.sqrt(torch.clamp(s_in, min=1e-8) / torch.clamp(w_amax, min=1e-8))
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    s_t = torch.clamp(torch.where(valid, s_in / m, zero).amax(), min=1e-8)
    r = torch.where(valid, 127.0 / (m * s_t), zero)
    w_eff = w * (m * (s_t / 127.0))[:, None]
    u = torch.clamp(_amax(w_eff, 0), min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w_eff / u), -127, 127).to(torch.int8)
    return wq, u[None, :], r[None, :]


def quantize_packed(packed: dict, act_amax: dict, config) -> dict:
    """A :func:`pack_mlp_params` dict -> the int8 render layout
    (`quantize.py:87-172`), the JAX package's keys: int8 weights, float32
    ``[1, n]`` scales, biases passed through. The last layer is a skip
    layer when ``packed["w_sf_enc"]`` is not None."""
    n = config.n_layers
    u_units = config.dense_units
    last_skip = packed["w_sf_enc"] is not None

    trunk_w, trunk_u, trunk_r = [], [], [None] * n
    trunk_enc_w, trunk_enc_u, enc_r = [], [], []
    for i in range(n):
        s_in = act_amax["enc"] if i == 0 else act_amax[f"h{i - 1}"]
        wq, uu, r = _quantize_matmul(packed["trunk_w"][i], s_in)
        trunk_w.append(wq)
        trunk_u.append(uu)
        # r codes this product's INPUT: the encoding for layer 0 (enc_r[0]),
        # h_{i-1} otherwise, kept on the layer that makes it.
        if i == 0:
            enc_r.append(r)
        else:
            trunk_r[i - 1] = r
            enc_r.append(None)
        if packed["trunk_enc_w"][i] is not None:
            ewq, euu, er = _quantize_matmul(packed["trunk_enc_w"][i],
                                            act_amax["enc"])
            trunk_enc_w.append(ewq)
            trunk_enc_u.append(euu)
            enc_r[i] = er
        else:
            trunk_enc_w.append(None)
            trunk_enc_u.append(None)

    # The sigma/features head is folded as one product (one requantization
    # of h_{n-1}), then split: int32 sums are exact, so the two products
    # over the split columns equal the fused one.
    w_sf_q, u_sf, r_last = _quantize_matmul(packed["w_sf"],
                                            act_amax[f"h{n - 1}"])
    trunk_r[n - 1] = r_last
    b_sf = packed["b_sf"]
    out = {
        "trunk_w": trunk_w, "trunk_u": trunk_u, "trunk_b": packed["trunk_b"],
        "trunk_r": trunk_r,
        "trunk_enc_w": trunk_enc_w, "trunk_enc_u": trunk_enc_u,
        "enc_r": enc_r,
        "w_feat": w_sf_q[:, :u_units].contiguous(),
        "u_feat": u_sf[:, :u_units].contiguous(),
        "b_feat": b_sf[:, :u_units].contiguous(),
        "w_sig": w_sf_q[:, u_units:].contiguous(),
        "u_sig": u_sf[:, u_units:].contiguous(),
        "b_sig": b_sf[:, u_units:].contiguous(),
        "w_feat_enc": None, "u_feat_enc": None,
        "w_sig_enc": None, "u_sig_enc": None, "enc_r_sf": None,
    }
    if last_skip:
        w_sf_enc_q, u_sf_enc, out["enc_r_sf"] = _quantize_matmul(
            packed["w_sf_enc"], act_amax["enc"])
        out["w_feat_enc"] = w_sf_enc_q[:, :u_units].contiguous()
        out["w_sig_enc"] = w_sf_enc_q[:, u_units:].contiguous()
        out["u_feat_enc"] = u_sf_enc[:, :u_units].contiguous()
        out["u_sig_enc"] = u_sf_enc[:, u_units:].contiguous()

    # rgb_features: the features' product and the direction encoding's.
    out["w_rf_top"], out["u_rf_top"], out["r_feat"] = _quantize_matmul(
        packed["w_rf_top"], act_amax["features"])
    out["w_rf_enc"], out["u_rf_enc"], out["enc_r_rf"] = _quantize_matmul(
        packed["w_rf_enc"], act_amax["enc"])
    out["b_rf"] = packed["b_rf"]
    # The rgb head reads rf, which is linear (signed, no relu).
    out["w_rgb"], out["u_rgb"], out["r_rf"] = _quantize_matmul(
        packed["w_rgb"], act_amax["rf"])
    out["b_rgb"] = packed["b_rgb"]
    return out


# The int8 weight arrays of a quantize_packed dict besides the trunk's.
INT8_WEIGHTS = ("w_feat", "w_sig", "w_feat_enc", "w_sig_enc", "w_rf_top",
                "w_rf_enc", "w_rgb")


def transposed_int8_weights(q: dict) -> dict:
    """The ``[fan_out, fan_in]`` copies of ``q``'s int8 weights, the K-major
    operands of the ``ray_march_mlp_int8`` kernel's products (``wgmma``
    takes no transpose for 8-bit types): made on the first call and kept in
    ``q["transposed"]``, so one quantized state is transposed once, not at
    every launch. They live in memory only: no checkpoint holds them, and
    ``q``'s own arrays are never changed after they are made."""
    t = q.get("transposed")
    if t is None:
        def tr(x):
            return None if x is None else x.t().contiguous()

        t = {"trunk_w": [tr(w) for w in q["trunk_w"]],
             "trunk_enc_w": [tr(w) for w in q["trunk_enc_w"]]}
        t.update({name: tr(q[name]) for name in INT8_WEIGHTS})
        q["transposed"] = t
    return t


def _quant_act(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """float32 activation -> int8 codes (held as float32 integers):
    ``clip(round(x r), -127, 127)``, ties to even as ``jnp.round``."""
    return torch.clamp(torch.round(x * r), -127.0, 127.0)


def _doti8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 sum of code products, as float32 (``torch.matmul``
    has no int8 path on the CPU): the float64 sums of integers below 2^53
    are exact, and the cast to float32 rounds to nearest even, as the
    kernels' and JAX's int32 -> float32 conversions do; it is exact for
    fan-ins up to 1024 (|sum| <= 127^2 x fan-in < 2^24)."""
    return (a.double() @ w.double()).float()


def forward_core_int8(q: dict, enc: torch.Tensor, sigma_only: bool = False):
    """The int8 forward over ``enc [T, 128]`` float32 block encodings
    (`quantize.py:248-308`): ``(rgb_pre [T, 3] or None, sigma_pre [T])``,
    float32 and before their activations. Each epilogue in the JAX order,
    one rounding per step: ``acc u``, ``+ acc_enc u_enc``, ``+ b``."""
    hq = None
    for i in range(len(q["trunk_w"])):
        xq = _quant_act(enc, q["enc_r"][0]) if i == 0 else hq
        acc = _doti8(xq, q["trunk_w"][i]) * q["trunk_u"][i]
        if i > 0 and q["trunk_enc_w"][i] is not None:
            eq = _quant_act(enc, q["enc_r"][i])
            acc = acc + _doti8(eq, q["trunk_enc_w"][i]) * q["trunk_enc_u"][i]
        h = torch.relu(acc + q["trunk_b"][i])
        hq = _quant_act(h, q["trunk_r"][i])

    last_enc = q["w_sig_enc"] is not None
    eq_last = _quant_act(enc, q["enc_r_sf"]) if last_enc else None
    sigma_pre = _doti8(hq, q["w_sig"][:, :1]) * q["u_sig"][:, :1]
    if last_enc:
        sigma_pre = sigma_pre + (_doti8(eq_last, q["w_sig_enc"][:, :1])
                                 * q["u_sig_enc"][:, :1])
    sigma_pre = (sigma_pre + q["b_sig"][:, :1])[:, 0]
    if sigma_only:
        return None, sigma_pre

    features = _doti8(hq, q["w_feat"]) * q["u_feat"]
    if last_enc:
        features = features + (_doti8(eq_last, q["w_feat_enc"])
                               * q["u_feat_enc"])
    features = features + q["b_feat"]
    fq = _quant_act(features, q["r_feat"])
    eq = _quant_act(enc, q["enc_r_rf"])
    # rgb_features is linear: no relu before the rgb head.
    rf = (_doti8(fq, q["w_rf_top"]) * q["u_rf_top"]
          + _doti8(eq, q["w_rf_enc"]) * q["u_rf_enc"] + q["b_rf"])
    rfq = _quant_act(rf, q["r_rf"])
    rgb_pre = _doti8(rfq, q["w_rgb"][:, :3]) * q["u_rgb"][:, :3] \
        + q["b_rgb"][:, :3]
    return rgb_pre, sigma_pre


def ray_march_mlp_int8_plain(q: dict, base: torch.Tensor, slope: torch.Tensor,
                             depths: torch.Tensor, masks: torch.Tensor,
                             sigma_only: bool = False) -> torch.Tensor:
    """Plain version of the ``ray_march_mlp_int8`` kernel (T4): the float32
    encoding of the points ``depths [R, S]`` (:func:`encode_points_f32`,
    the bf16 kernel's encoding before its rounding) through
    :func:`forward_core_int8`; ``[R*S, 4]`` (sigmoid rgb, relu sigma) or
    ``[R*S]`` relu sigma, as ``ray_march_mlp``."""
    from keras_nerf_tpu_torch.kernels.ray_march import encode_points_f32

    enc = encode_points_f32(base, slope, depths, masks).flatten(0, 1)
    rgb_pre, sigma_pre = forward_core_int8(q, enc, sigma_only)
    sigma = torch.relu(sigma_pre)
    if sigma_only:
        return sigma
    return torch.cat([torch.sigmoid(rgb_pre), sigma[:, None]], dim=1)
