"""The NeRF radiance-field MLP (port of ``keras_nerf_tpu/models/mlp.py``).

Parameters stay in the reference layout (`models/mlp.py:69-103` of the JAX
package): a dict with ``trunk`` (a list of ``{"kernel" [fan_in, fan_out],
"bias" [fan_out]}``), ``sigma``, ``features``, ``rgb_features`` and ``rgb``,
float32 tensors. :func:`apply_mlp` is the reference forward (float32, or
bf16 products under mixed precision); the kernel path (``kernels/ray_march.py``) reads a packed bf16 copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    n_layers: int = 8
    dense_units: int = 256
    skip_layer: int = 4

    def skip_indices(self) -> tuple[int, ...]:
        return tuple(i for i in range(self.n_layers)
                     if i % self.skip_layer == 0 and i > 0)


def _dense_init(generator: torch.Generator, fan_in: int, fan_out: int,
                device) -> Params:
    """Glorot-uniform kernel, zero bias (Keras Dense defaults)."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand((fan_in, fan_out), generator=generator,
                   dtype=torch.float32, device=generator.device)
    return {"kernel": (u * (2 * limit) - limit).to(device),
            "bias": torch.zeros(fan_out, dtype=torch.float32, device=device)}


def init_mlp(generator: torch.Generator, config: MLPConfig, in_xyz: int,
             in_dir: int, device=None) -> Params:
    """Random reference-layout parameters drawn from ``generator`` (placed
    on ``device``, by default the generator's)."""
    device = generator.device if device is None else device
    skip = set(config.skip_indices())
    trunk = []
    width = in_xyz
    for i in range(config.n_layers):
        trunk.append(_dense_init(generator, width, config.dense_units, device))
        width = config.dense_units + (in_xyz if i in skip else 0)
    u = config.dense_units
    return {
        "trunk": trunk,
        "sigma": _dense_init(generator, width, 1, device),
        "features": _dense_init(generator, width, u, device),
        "rgb_features": _dense_init(generator, u + in_dir, u // 2, device),
        "rgb": _dense_init(generator, u // 2, 3, device),
    }


def _dense(x: torch.Tensor, p: Params, dtype: torch.dtype) -> torch.Tensor:
    return x @ p["kernel"].to(dtype) + p["bias"].to(dtype)


def apply_mlp(params: Params, enc_xyz: torch.Tensor, enc_dir: torch.Tensor,
              config: MLPConfig, compute_dtype: torch.dtype = torch.float32
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward: ``(enc_xyz [..., Dx], enc_dir [..., Dd]) -> (rgb [..., 3],
    sigma [..., 1])`` in float32 (`keras_nerf/model/nerf/mlp.py:29-50`).
    The activations, kernels and biases are cast to ``compute_dtype`` and
    every product and activation runs in it (``bfloat16`` is the JAX
    package's mixed precision, `models/mlp.py:106-139`); float32 by
    default, where callers on the card keep TF32 off. The parameters stay
    float32 and receive float32 gradients."""
    skip = set(config.skip_indices())
    inputs = enc_xyz.to(compute_dtype)
    x = inputs
    for i, layer in enumerate(params["trunk"]):
        x = torch.relu(_dense(x, layer, compute_dtype))
        if i in skip:
            x = torch.cat([x, inputs], dim=-1)
    sigma = torch.relu(_dense(x, params["sigma"], compute_dtype))
    features = torch.cat([_dense(x, params["features"], compute_dtype),
                          enc_dir.to(compute_dtype)], dim=-1)
    rgb_features = _dense(features, params["rgb_features"], compute_dtype)
    rgb = torch.sigmoid(_dense(rgb_features, params["rgb"], compute_dtype))
    return rgb.to(torch.float32), sigma.to(torch.float32)


def param_count(params: Params) -> int:
    """The number of parameters of a tree of tensors or arrays
    (`models/mlp.py:144-145`)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return math.prod(params.shape)
