"""Coarse + fine rendering engine, no-grad render path (port of
``keras_nerf_tpu/models/engine.py``).

``render_image_batch`` chunks the rays (the JAX package's ``lax.scan``
becomes a Python loop over chunks) and renders each chunk twice: a coarse
pass over the stratified depths, then a fine pass over the coarse depths
merged with ``n_fine`` inverse-CDF samples of the coarse weights
(`keras_nerf/model/nerf/nerf.py:175-304`).

Two paths, chosen by the tri-state ``NeRFConfig.use_kernels`` (the
counterpart of ``use_pallas``, `engine.py:452-466`):

* kernels (``True``; ``None`` on a card, and on the CPU when the
  architecture fits their envelope):
  ``kernels/ray_march.py:fused_render_chunk`` — bf16 MLP operands with
  float32 accumulation, float32 encoding and quadrature;
* reference (``False``): float32 ``apply_mlp`` + ``render_rays``.

The fine draws ``u`` are injected: per-chunk ``[R, n_fine]`` tensors, or a
``torch.Generator`` that makes them with :func:`sorted_uniforms`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch

from keras_nerf_tpu_torch.kernels.ray_march import (
    fused_render_chunk,
    kernel_supported,
    pack_mlp_params,
)
from keras_nerf_tpu_torch.models.mlp import MLPConfig, apply_mlp
from keras_nerf_tpu_torch.ops.encoding import (
    encode_position_and_directions,
    encoded_dim,
)
from keras_nerf_tpu_torch.ops.rendering import RenderOutput, render_rays
from keras_nerf_tpu_torch.ops.sampling import (
    invert_cdf,
    merge_sorted,
    midpoints,
    sorted_uniforms,
)

Params = dict


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Model + rendering hyperparameters of the render path."""

    n_coarse: int = 64
    n_fine: int = 128
    pos_emb_xyz: int = 10
    pos_emb_dir: int = 4
    n_layers: int = 8
    dense_units: int = 256
    skip_layer: int = 4
    white_background: bool = False
    use_kernels: bool | None = None

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig(n_layers=self.n_layers,
                         dense_units=self.dense_units,
                         skip_layer=self.skip_layer)

    @property
    def in_xyz(self) -> int:
        return encoded_dim(3, self.pos_emb_xyz)

    @property
    def in_dir(self) -> int:
        return encoded_dim(3, self.pos_emb_dir)

    def to_model_config(self) -> dict:
        """The 7-key ``model_config.json`` payload (`nerf.py:47-55`)."""
        return {k: getattr(self, k) for k in (
            "n_coarse", "n_fine", "pos_emb_xyz", "pos_emb_dir", "n_layers",
            "dense_units", "skip_layer")}

    @classmethod
    def from_model_config(cls, config: dict, **overrides) -> "NeRFConfig":
        return cls(**{**config, **overrides})


def resolve_use_kernels(config: NeRFConfig, device: torch.device) -> bool:
    """``True``: kernels (packing raises outside their envelope);
    ``False``: reference. ``None``: kernels on a card, so an architecture
    outside the envelope raises there rather than giving way to the
    reference; on the CPU, kernels when the architecture fits."""
    if config.use_kernels is None:
        if torch.device(device).type == "cuda":
            return True
        return kernel_supported(config.mlp, config.pos_emb_xyz,
                                config.pos_emb_dir)
    return config.use_kernels


def render_chunk(params: Params, origin: torch.Tensor,
                 direction: torch.Tensor, coarse_points: torch.Tensor,
                 config: NeRFConfig, u: torch.Tensor | None = None,
                 coarse_weights: torch.Tensor | None = None):
    """Reference (float32) render of one chunk through one MLP. With
    ``coarse_weights`` (and draws ``u``) this is the fine pass: sample and
    merge, then render. Returns ``(RenderOutput, depths used)``."""
    if coarse_weights is not None:
        fine_points = invert_cdf(u, midpoints(coarse_points), coarse_weights)
        points = merge_sorted(coarse_points, fine_points)
    else:
        points = coarse_points
    enc_xyz, enc_dir = encode_position_and_directions(
        origin, direction, points, config.pos_emb_xyz, config.pos_emb_dir)
    rgb, sigma = apply_mlp(params, enc_xyz, enc_dir, config.mlp)
    out = render_rays(rgb, sigma, points,
                      white_background=config.white_background)
    return out, points


def render_chunk_pair(coarse_params: Params, fine_params: Params,
                      origin: torch.Tensor, direction: torch.Tensor,
                      coarse_points: torch.Tensor, u: torch.Tensor,
                      config: NeRFConfig):
    """Coarse pass then weight-guided fine pass (`nerf.py:218-227`)."""
    out_c, _ = render_chunk(coarse_params, origin, direction, coarse_points,
                            config)
    out_f, _ = render_chunk(fine_params, origin, direction, coarse_points,
                            config, u=u, coarse_weights=out_c.weights)
    return out_c, out_f


def _fused_chunk_pair(packed_c: dict, packed_f: dict, origin: torch.Tensor,
                      direction: torch.Tensor, coarse_points: torch.Tensor,
                      u: torch.Tensor, config: NeRFConfig,
                      with_weights: bool = True, coarse_image: bool = True):
    """Coarse pass (sigma-only when its image is unused) then the fine pass
    with in-kernel sampling off the coarse weights (`engine.py:496-571`,
    render modes)."""
    kw = dict(pos_emb_xyz=config.pos_emb_xyz, pos_emb_dir=config.pos_emb_dir,
              white_background=config.white_background)
    out_c = fused_render_chunk(packed_c, origin, direction, coarse_points,
                               sigma_only=not coarse_image, **kw)
    out_f = fused_render_chunk(packed_f, origin, direction, None,
                               emit_weights=with_weights,
                               sample_inputs=(coarse_points, out_c[2], u),
                               **kw)
    return out_c, out_f


def _chunk_draws(fine_draws, num_chunks: int, rays_per_chunk: int,
                 n_fine: int, device: torch.device):
    if isinstance(fine_draws, torch.Generator):
        return [sorted_uniforms(fine_draws, (rays_per_chunk,), n_fine)
                for _ in range(num_chunks)]
    draws = list(fine_draws)
    if len(draws) != num_chunks:
        raise ValueError(f"got {len(draws)} fine-draw tensors for "
                         f"{num_chunks} chunks")
    for d in draws:
        if tuple(d.shape) != (rays_per_chunk, n_fine):
            raise ValueError(f"fine draws must be [{rays_per_chunk}, "
                             f"{n_fine}] per chunk, got {tuple(d.shape)}")
    return [torch.as_tensor(d, dtype=torch.float32, device=device)
            for d in draws]


@torch.no_grad()
def render_image_batch(coarse_params: Params, fine_params: Params, rays,
                       fine_draws: torch.Generator | Sequence[torch.Tensor],
                       config: NeRFConfig, ray_chunks: int,
                       with_weights: bool = True,
                       coarse_image: bool = True) -> tuple[dict, dict]:
    """Full-image chunked render (`engine.py:290-382`).

    Args:
      rays: ``(origin [B,H,W,3], direction [B,H,W,3], points [B,H,W,Nc])``.
      fine_draws: a ``torch.Generator`` on the rays' device, or one sorted
        ``[ray_chunks, n_fine]`` draw tensor per chunk.
      with_weights: include per-sample ``weights`` in the dicts (skipped by
        the fine kernel pass when False).
      coarse_image: False declares the coarse image unused: it comes back
        zero and the kernel path's coarse pass is sigma-only.

    Returns ``(coarse, fine)`` dicts of ``image [B,H,W,3]``,
    ``depth [B,H,W]`` and, when ``with_weights``, ``weights [B,H,W,S]``.
    """
    origin, direction, points = rays
    b, h, w = origin.shape[:3]
    num_rays = b * h * w
    ray_chunks = min(ray_chunks, num_rays)
    if num_rays % ray_chunks:
        raise ValueError(f"ray_chunks {ray_chunks} must divide num_rays "
                         f"{num_rays}")
    num_chunks = num_rays // ray_chunks
    o = origin.reshape(num_chunks, ray_chunks, 3)
    d = direction.reshape(num_chunks, ray_chunks, 3)
    t = points.reshape(num_chunks, ray_chunks, config.n_coarse)
    draws = _chunk_draws(fine_draws, num_chunks, ray_chunks, config.n_fine,
                         origin.device)

    outs_c, outs_f = [], []
    if resolve_use_kernels(config, origin.device):
        packed_c = pack_mlp_params(coarse_params, config.mlp,
                                   config.pos_emb_xyz, config.pos_emb_dir)
        packed_f = pack_mlp_params(fine_params, config.mlp,
                                   config.pos_emb_xyz, config.pos_emb_dir)
        for i in range(num_chunks):
            out_c, out_f = _fused_chunk_pair(
                packed_c, packed_f, o[i], d[i], t[i], draws[i], config,
                with_weights=with_weights, coarse_image=coarse_image)
            outs_c.append(RenderOutput(*out_c))
            outs_f.append(RenderOutput(*out_f))
    else:
        for i in range(num_chunks):
            out_c, out_f = render_chunk_pair(coarse_params, fine_params,
                                             o[i], d[i], t[i], draws[i],
                                             config)
            if not coarse_image:
                out_c = out_c._replace(image=torch.zeros_like(out_c.image))
            outs_c.append(out_c)
            outs_f.append(out_f)

    def unchunk(outs: list[RenderOutput]) -> dict:
        res = {"image": torch.cat([x.image for x in outs]).reshape(b, h, w, 3),
               "depth": torch.cat([x.depth for x in outs]).reshape(b, h, w)}
        if with_weights and outs[0].weights is not None:
            weights = torch.cat([x.weights for x in outs])
            res["weights"] = weights.reshape(b, h, w, weights.shape[-1])
        return res

    return unchunk(outs_c), unchunk(outs_f)
