"""Volume-rendering quadrature (port of ``keras_nerf_tpu/ops/rendering.py``).

The reference (float32) path's semantics: the last delta is padded with
``epsilon = 1e-10`` and the transmittance is the exclusive cumulative
product of ``1 - alpha + epsilon`` (`keras_nerf/model/nerf/utils.py:17-58`).
The kernel path's quadrature (``kernels/ray_march.py``) uses
``exp(-exclusive cumsum)`` instead, as the TPU kernel does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderOutput(NamedTuple):
    image: torch.Tensor    # [..., 3]
    depth: torch.Tensor    # [...]
    weights: torch.Tensor  # [..., S]


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i] = prod(x[..., :i])``, ``out[..., 0] == 1``."""
    inclusive = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(x[..., :1]), inclusive[..., :-1]],
                     dim=-1)


def render_rays(
    rgb: torch.Tensor,
    sigma: torch.Tensor,
    sample_points: torch.Tensor,
    *,
    white_background: bool = False,
    epsilon: float = 1e-10,
) -> RenderOutput:
    """``rgb [..., S, 3]``, ``sigma [..., S(, 1)]``, ``sample_points
    [..., S]`` -> image ``[..., 3]``, depth ``[...]``, weights ``[..., S]``."""
    if sigma.ndim == rgb.ndim:
        sigma = sigma[..., 0]
    dtype = sample_points.dtype
    sigma = sigma.to(dtype)

    delta = sample_points[..., 1:] - sample_points[..., :-1]
    pad = torch.full_like(sample_points[..., :1], epsilon)
    delta = torch.cat([delta, pad], dim=-1)

    alpha = 1.0 - torch.exp(-sigma * delta)
    transmittance = exclusive_cumprod(1.0 - alpha + epsilon)
    weights = alpha * transmittance

    image = torch.sum(weights[..., None] * rgb.to(dtype), dim=-2)
    depth = torch.sum(weights * sample_points, dim=-1)
    if white_background:
        image = image + (1.0 - torch.sum(weights, dim=-1))[..., None]
    return RenderOutput(image=clip01(image), depth=depth, weights=weights)


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``x`` clipped to ``[0, 1]`` with ``jnp.clip``'s gradient: 1 inside,
    0.5 at exactly 0 or 1 (``lax.max``/``lax.min`` split ties), 0 outside.
    ``torch.clamp`` passes 1 at the bounds, which an empty ray on a white
    background reaches exactly."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)
