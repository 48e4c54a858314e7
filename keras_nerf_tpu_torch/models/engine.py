"""Coarse + fine NeRF engine: rendering, training and evaluation steps
(port of ``keras_nerf_tpu/models/engine.py``).

``render_image_batch`` and ``train_step`` chunk the rays (the JAX package's
``lax.scan`` becomes a Python loop over chunks) and run each chunk twice: a
coarse pass over the stratified depths, then a fine pass over the coarse
depths merged with ``n_fine`` inverse-CDF samples of the coarse weights
(`keras_nerf/model/nerf/nerf.py:175-473`). The fine loss never reaches the
coarse parameters: the fine pass samples from the coarse weights as data.

Two paths, chosen by the tri-state ``NeRFConfig.use_kernels`` (the
counterpart of ``use_pallas``, `engine.py:452-466`):

* kernels (``True``; ``None`` on a card, and on the CPU when the
  architecture fits their envelope): ``kernels/ray_march.py`` —
  ``fused_render_chunk`` to render, ``fused_train_chunk`` to train with the
  MSE, whose packed gradients are accumulated over the chunks and unpacked
  once; bf16 MLP operands with float32 accumulation, float32 encoding and
  quadrature. A callable loss trains by torch autograd per chunk through
  ``render_chunk``'s kernel branch, ``fused_point_forward`` (forward T5,
  backward T6) and ``render_rays``;
* reference (``False``): float32 ``apply_mlp`` + ``render_rays``, and
  torch autograd per chunk for training.

The int8 render tier (:func:`quantize_render_params`, then
``render_image_batch(packed_q=...)``) runs on the kernel path only: both
passes through ``ray_march_mlp_int8`` (T4); the reference path ignores it.
The opt-in fast render (``NeRFConfig.fast_render``) renders the fine pass on
its importance samples alone, on both paths and in both precisions.

The occupancy-train tier (``train_step(occupancy=...)``) trains the fine
pass on depths drawn inside a baked occupancy grid instead of the coarse
weights' importance samples; the coarse pass trains as before.

The fine draws ``u`` are injected: per-chunk ``[R, n_fine]`` tensors
(``[R, n_samples]`` in the occupancy tier), or a ``torch.Generator`` that
makes them with :func:`sorted_uniforms`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Sequence
from typing import NamedTuple

import numpy as np
import torch

from keras_nerf_tpu_torch import spans
from keras_nerf_tpu_torch.kernels.quantize import (
    collect_act_amax,
    quantize_packed,
    transposed_int8_weights,
)
from keras_nerf_tpu_torch.kernels.ray_march import (
    encode_block128,
    fused_point_forward,
    fused_render_chunk,
    fused_train_chunk,
    kernel_supported,
    pack_mlp_params,
    ray_points,
    unpack_grads,
    zero_grads,
)
from keras_nerf_tpu_torch.models.mlp import MLPConfig, apply_mlp, init_mlp
from keras_nerf_tpu_torch.ops.encoding import (
    encode_position_and_directions,
    encoded_dim,
)
from keras_nerf_tpu_torch.ops import occupancy as occ_mod
from keras_nerf_tpu_torch.ops.metrics import psnr, ssim
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
    # The reference path's matmul precision (`engine.py:75`): "float32", or
    # "bfloat16" for --mixed_precision. The kernels' precision is their
    # own (bf16 operands, float32 accumulation) and ignores it.
    compute_dtype: str = "float32"
    use_kernels: bool | None = None
    # Opt-in fast render (`engine.py:86-94`), inference only: the fine pass
    # renders ``fast_render`` importance samples of the coarse weights
    # alone, without the coarse depths merged in, so a ray costs n_coarse +
    # fast_render points instead of n_coarse + (n_coarse + n_fine). 0 = off
    # (the exact math); training, evaluation and the int8 calibration zero
    # it.
    fast_render: int = 0

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig(n_layers=self.n_layers,
                         dense_units=self.dense_units,
                         skip_layer=self.skip_layer)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

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
    """Differentiable render of one chunk through one MLP
    (`engine.py:201-258`). With ``coarse_weights`` (and draws ``u``) this is
    the fine pass: sample and merge, then render; with ``fast_render > 0``
    the ``[R, fast_render]`` draws' depths alone, unmerged. When
    :func:`resolve_use_kernels` is true the points go through
    ``fused_point_forward`` (T5 forward, T6 backward), else through the
    ``apply_mlp`` in ``config.dtype``. Returns ``(RenderOutput, depths
    used)``."""
    if coarse_weights is not None:
        # The coarse weights are data here: the fine loss never reaches the
        # coarse parameters (`nerf.py:390-417`).
        points = invert_cdf(u, midpoints(coarse_points),
                            coarse_weights.detach())
        if config.fast_render <= 0:
            points = merge_sorted(coarse_points, points)
    else:
        points = coarse_points
    if resolve_use_kernels(config, origin.device):
        # Positions and directions are data here, as in the kernel's
        # contract: no cotangent reaches them.
        positions, dirs = ray_points(origin, direction, points)
        rgb, sigma = fused_point_forward(
            params, positions, dirs, config.mlp, config.pos_emb_xyz,
            config.pos_emb_dir)
        rgb = rgb.reshape(*points.shape, 3)
        sigma = sigma.reshape(*points.shape, 1)
    else:
        enc_xyz, enc_dir = encode_position_and_directions(
            origin, direction, points, config.pos_emb_xyz,
            config.pos_emb_dir)
        rgb, sigma = apply_mlp(params, enc_xyz, enc_dir, config.mlp,
                               config.dtype)
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
                      with_weights: bool = True, coarse_image: bool = True,
                      target: torch.Tensor | None = None,
                      grads: tuple = (None, None), quantized: bool = False,
                      fine_sample_inputs: tuple | None = None):
    """Coarse pass then the fine pass with in-kernel sampling off the
    coarse weights (`engine.py:496-571`). Without ``target`` these are the
    render modes (the coarse pass sigma-only when its image is unused;
    with ``fast_render > 0`` the fine pass renders ``sample_merge``'s
    no-merge mode, the draws' depths alone);
    ``quantized`` renders with the int8 dicts of
    :func:`quantize_render_params` as ``packed_c``/``packed_f``. With
    ``target`` they are the train modes: each pass adds the packed
    gradient of its chunk MSE into its accumulator of ``grads`` and sees
    only its own packed weights, and the fine pass emits no weights.
    ``fine_sample_inputs`` (train modes) replaces the fine pass's sampling
    inputs: the occupancy tier's ``(bin_mids, occ, u, partner or None)``;
    the coarse pass then emits no weights, which nothing reads."""
    kw = dict(pos_emb_xyz=config.pos_emb_xyz, pos_emb_dir=config.pos_emb_dir,
              white_background=config.white_background)
    if target is None:
        out_c = fused_render_chunk(packed_c, origin, direction, coarse_points,
                                   sigma_only=not coarse_image,
                                   quantized=quantized, **kw)
        fine_in = (coarse_points, out_c[2], u)
        if config.fast_render > 0:
            # The fast render samples in the kernel too: partner None is the
            # no-merge mode, JAX's sample_pdf_sorted of the coarse weights
            # (`engine.py:547-553`) up to the CDF's summation order.
            fine_in += (None,)
        out_f = fused_render_chunk(packed_f, origin, direction, None,
                                   emit_weights=with_weights,
                                   sample_inputs=fine_in,
                                   quantized=quantized, **kw)
        return out_c, out_f
    if quantized:
        raise ValueError("the int8 tier renders only: it has no gradients")
    out_c = fused_train_chunk(packed_c, origin, direction, coarse_points,
                              target, grads=grads[0],
                              emit_weights=fine_sample_inputs is None, **kw)
    if fine_sample_inputs is None:
        fine_sample_inputs = (coarse_points, out_c[2], u)
    out_f = fused_train_chunk(packed_f, origin, direction, None, target,
                              emit_weights=False,
                              sample_inputs=fine_sample_inputs,
                              grads=grads[1], **kw)
    return out_c, out_f


def _chunk_draws(fine_draws, num_chunks: int, rays_per_chunk: int,
                 n_fine: int, device: torch.device):
    """One sorted ``[rays_per_chunk, n_fine]`` draw tensor per chunk: made
    by the generator ``fine_draws``, or its own tensors checked."""
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
                       coarse_image: bool = True,
                       packed_q: tuple | None = None) -> tuple[dict, dict]:
    """Full-image chunked render (`engine.py:290-382`).

    Args:
      rays: ``(origin [B,H,W,3], direction [B,H,W,3], points [B,H,W,Nc])``.
      fine_draws: a ``torch.Generator`` on the rays' device, or one sorted
        ``[ray_chunks, n_fine]`` draw tensor per chunk (``[ray_chunks,
        fast_render]`` when ``config.fast_render > 0``).
      with_weights: include per-sample ``weights`` in the dicts (skipped by
        the fine kernel pass when False).
      coarse_image: False declares the coarse image unused: it comes back
        zero and the kernel path's coarse pass is sigma-only.
      packed_q: ``(coarse, fine)`` int8 dicts of
        :func:`quantize_render_params`: the int8 render tier, whose passes
        run through ``ray_march_mlp_int8`` (kernel path only; the reference
        path ignores it, as the JAX package's XLA path does).

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
    draws = _chunk_draws(fine_draws, num_chunks, ray_chunks,
                         config.fast_render or config.n_fine, origin.device)

    outs_c, outs_f = [], []
    if resolve_use_kernels(config, origin.device):
        if packed_q is not None:
            packed_c, packed_f = packed_q
        else:
            with spans.span("engine.pack"):
                packed_c, packed_f = (
                    pack_mlp_params(p, config.mlp, config.pos_emb_xyz,
                                    config.pos_emb_dir)
                    for p in (coarse_params, fine_params))
        for i in range(num_chunks):
            with spans.span("engine.chunk"):
                out_c, out_f = _fused_chunk_pair(
                    packed_c, packed_f, o[i], d[i], t[i], draws[i], config,
                    with_weights=with_weights, coarse_image=coarse_image,
                    quantized=packed_q is not None)
            outs_c.append(RenderOutput(*out_c))
            outs_f.append(RenderOutput(*out_f))
    else:
        for i in range(num_chunks):
            with spans.span("engine.chunk"):
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


@torch.no_grad()
def quantize_render_params(coarse_params: Params, fine_params: Params, rays,
                           fine_draws: torch.Generator | torch.Tensor,
                           config: NeRFConfig, n_calib_rays: int = 1024):
    """Calibrate and quantize both MLPs for the int8 render tier
    (`engine.py:385-442`); returns ``(coarse_q, fine_q)`` for
    :func:`render_image_batch`'s ``packed_q``.

    Runs once per checkpoint, outside the per-frame loop. At most
    ``n_calib_rays`` rays of ``rays``, taken with the ceil stride so that
    they span the image (contiguous leading rays are background only and
    mis-calibrate), go through the float32 reference path for the coarse
    weights, then :func:`invert_cdf` and :func:`merge_sorted` for the fine
    depths; the coarse model is calibrated on the stratified points and the
    fine one on the merged points, the distributions each renders.
    :func:`collect_act_amax` reads the ranges from ``apply_mlp``'s stash
    (T5 on a card) over :func:`encode_block128` of the points.

    Args:
      fine_draws: a ``torch.Generator`` on the rays' device, or the sorted
        draws ``[n_calib, n_fine]`` themselves (JAX's key is not portable).
    """
    config = dataclasses.replace(config, fast_render=0)
    origin, direction, points = rays
    num_rays = origin[..., 0].numel()
    # Ceil stride: floor would fall back to contiguous leading rays whenever
    # num_rays < 2 n_calib_rays, and drop the bottom of the image otherwise.
    stride = max(1, -(-num_rays // n_calib_rays))
    o, d, t = (x.reshape(num_rays, -1)[::stride][:n_calib_rays].contiguous()
               for x in (origin, direction, points))
    n = o.shape[0]
    out_c, _ = render_chunk(coarse_params, o, d, t,
                            dataclasses.replace(config, use_kernels=False))
    if isinstance(fine_draws, torch.Generator):
        u = sorted_uniforms(fine_draws, (n,), config.n_fine)
    else:
        u = torch.as_tensor(fine_draws, dtype=torch.float32, device=o.device)
        if tuple(u.shape) != (n, config.n_fine):
            raise ValueError(f"calibration draws must be [{n}, "
                             f"{config.n_fine}], got {tuple(u.shape)}")
    fine_points = merge_sorted(t, invert_cdf(u, midpoints(t), out_c.weights))
    out = []
    for params, pts in ((coarse_params, t), (fine_params, fine_points)):
        packed = pack_mlp_params(params, config.mlp, config.pos_emb_xyz,
                                 config.pos_emb_dir)
        # o + d t rounded twice, as the JAX package's block_enc (`:428-432`)
        # computes it (unlike render_chunk's single-rounding ray_points).
        pos = o[:, None, :] + d[:, None, :] * pts[..., None]
        enc = encode_block128(pos.reshape(-1, 3),
                              d[:, None, :].expand(pos.shape).reshape(-1, 3),
                              config.pos_emb_xyz, config.pos_emb_dir)
        q = quantize_packed(packed, collect_act_amax(packed, enc, config.mlp),
                            config.mlp)
        if q["w_feat"].is_cuda:
            transposed_int8_weights(q)  # the kernel's operands, once
        out.append(q)
    return tuple(out)


# --------------------------------------------------------------------------
# Training and evaluation.


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts/lists (None leaves pass
    through when ``fn`` accepts them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of nested dicts/lists, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def _leaf_paths(tree, prefix: str = ""):
    """``(path, leaf)`` pairs, the path as JAX's ``keystr`` without quotes
    (``[trunk][0][kernel]``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{prefix}[{k}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _group_mean(tree, group):
    """``tree``'s leaves averaged over ``group``'s ranks: one all-reduce of
    one flat buffer (JAX's ``pmean``)."""
    leaves = tree_leaves(tree)
    flat = torch.cat([x.reshape(-1) for x in leaves])
    group.all_reduce_(flat).div_(group.size)
    parts = iter(flat.split([x.numel() for x in leaves]))
    return tree_map(lambda x: next(parts).view_as(x), tree)


def _metrics_mean(metrics: dict, group) -> dict:
    """0-d metric tensors averaged over ``group``'s ranks, in one
    all-reduce."""
    keys = list(metrics)
    values = torch.stack([metrics[k].to(torch.float32) for k in keys])
    group.all_reduce_(values).div_(group.size)
    return dict(zip(keys, values.unbind()))


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(x))
                          for x in tree_leaves(tree)))


class TrainState(NamedTuple):
    """Two parameter trees, two optimizer states and the step count
    (`engine.py:133-140`)."""

    coarse_params: Params
    fine_params: Params
    coarse_opt: dict
    fine_opt: dict
    step: int


def init_params(generator: torch.Generator, config: NeRFConfig,
                device=None) -> tuple[Params, Params]:
    """Independent coarse and fine parameter trees, drawn in that order."""
    return tuple(init_mlp(generator, config.mlp, config.in_xyz,
                          config.in_dir, device) for _ in range(2))


def exponential_lr(learning_rate: float, lr_final: float,
                   decay_steps: int) -> Callable[[int], float]:
    """``optax.exponential_decay(learning_rate, max(decay_steps, 1),
    lr_final / learning_rate, end_value=lr_final)`` (`engine.py:151-161`):
    ``lr * rate ** (count / steps)`` in float32, held at ``lr`` for
    ``count <= 0`` and clipped at ``lr_final``."""
    steps = max(int(decay_steps), 1)
    rate = lr_final / learning_rate
    f32 = np.float32

    def schedule(count: int) -> float:
        if count <= 0 or rate == 0:
            return learning_rate
        value = float(f32(learning_rate)
                      * np.power(f32(rate), f32(count) / f32(steps)))
        return max(value, lr_final) if rate < 1.0 else min(value, lr_final)

    return schedule


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax's ``adam`` (bias-corrected, ``eps`` outside the square root,
    ``eps_root = 0``) or ``sgd`` (no momentum), as plain tensor updates.

    The state is a dict: ``count``, ``mu`` and ``nu`` (trees shaped like the
    parameters) for Adam; ``schedule_count`` when the learning rate is a
    schedule. Counts are Python ints, so an update never waits for the
    card. ``utils/convert.py`` maps the state to and from optax's."""

    name: str
    learning_rate: float | Callable[[int], float]
    b1, b2, eps = 0.9, 0.999, 1e-8     # optax.adam's defaults

    def init(self, params: Params) -> dict:
        state = {}
        if self.name == "adam":
            state = {"count": 0, "mu": tree_map(torch.zeros_like, params),
                     "nu": tree_map(torch.zeros_like, params)}
        if callable(self.learning_rate):
            state["schedule_count"] = 0
        return state

    def update(self, grads: Params, state: dict,
               params: Params) -> tuple[Params, dict]:
        """``(new params, new state)``; the inputs are left as they are."""
        state = dict(state)
        lr = self.learning_rate
        if callable(lr):
            lr = lr(state["schedule_count"])
            state["schedule_count"] += 1
        updates = grads
        if self.name == "adam":
            b1, b2 = self.b1, self.b2
            count = state["count"] + 1
            mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads,
                          state["mu"])
            nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                          state["nu"])
            c1 = float(np.float32(1) - np.float32(b1) ** count)
            c2 = float(np.float32(1) - np.float32(b2) ** count)
            updates = tree_map(
                lambda m, v: (m / c1) / (torch.sqrt(v / c2) + self.eps),
                mu, nu)
            state.update(count=count, mu=mu, nu=nu)
        step = -float(np.float32(lr))
        return tree_map(lambda p, u: p + step * u, params, updates), state


def make_optimizer(optimizer: str, learning_rate=1e-3) -> Optimizer:
    """``"adam"`` or ``"sgd"`` (`engine.py:164-183`); ``learning_rate`` may
    be a schedule (:func:`exponential_lr`)."""
    name = optimizer.lower()
    if name not in ("adam", "sgd"):
        raise ValueError(f"optimizer {optimizer!r} is not ported yet (the "
                         f"JAX package's others are queued in ROADMAP.md); "
                         f"use 'adam' or 'sgd'")
    return Optimizer(name, learning_rate)


def init_train_state(generator: torch.Generator, config: NeRFConfig,
                     optimizer: Optimizer, device=None) -> TrainState:
    coarse, fine = init_params(generator, config, device)
    return TrainState(coarse, fine, optimizer.init(coarse),
                      optimizer.init(fine), 0)


def mse_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Scalar MSE with the Keras argument order (`engine.py:445-449`)."""
    return torch.mean(torch.square(y_pred - y_true))


def _use_fused_train(config: NeRFConfig, loss_fn, device) -> bool:
    """The fused T3 path (`fused_train_chunk`, whose kernels form the MSE
    cotangent themselves) trains when the kernels are on, the architecture
    fits them and the loss is the default MSE (`engine.py:469-478`); any
    other callable trains by autograd through ``render_chunk``."""
    return (resolve_use_kernels(config, device)
            and loss_fn in (None, mse_loss)
            and kernel_supported(config.mlp, config.pos_emb_xyz,
                                 config.pos_emb_dir))


def _batch_metrics(images_c, images_f, target, loss_c, loss_f) -> dict:
    """Coarse/fine x loss/psnr/ssim, PSNR and SSIM averaged over the batch
    images (`engine.py:574-584`)."""
    return {
        "coarse_loss": loss_c,
        "coarse_psnr": torch.mean(psnr(images_c, target)),
        "coarse_ssim": torch.mean(ssim(images_c, target)),
        "fine_loss": loss_f,
        "fine_psnr": torch.mean(psnr(images_f, target)),
        "fine_ssim": torch.mean(ssim(images_f, target)),
    }


def _chunked_batch(batch, config: NeRFConfig, ray_chunks: int):
    images, (origin, direction, points) = batch
    b, h, w = images.shape[:3]
    num_rays = b * h * w
    if ray_chunks > num_rays or num_rays % ray_chunks:
        raise ValueError(f"ray_chunks {ray_chunks} must divide the rays of "
                         f"the batch ({num_rays})")
    n = num_rays // ray_chunks
    return (origin.reshape(n, ray_chunks, 3),
            direction.reshape(n, ray_chunks, 3),
            points.reshape(n, ray_chunks, config.n_coarse),
            images[..., :3].reshape(n, ray_chunks, 3).to(torch.float32))


def _occupancy_bins(occupancy: tuple, origin: torch.Tensor,
                    direction: torch.Tensor, occ_grid: torch.Tensor | None,
                    rows: torch.Tensor | None):
    """A chunk's probe bins ``(bin_mids, occ)``, each ``[R, n_probe]``: the
    cached rows when given, else the grid probed along the rays (the same
    centres, so the two are bit for bit one step; `engine.py:688-696`)."""
    _, n_probe, near, far, aabb, _ = occupancy
    if rows is not None:
        return occ_mod.cached_probe_bins(rows, near, far, n_probe)
    return occ_mod.occupancy_along_rays(origin, direction, occ_grid, near,
                                        far, n_probe, aabb)


def _fused_grads(state: TrainState, chunks, draws, config: NeRFConfig,
                 occupancy: tuple | None = None, bins=None):
    """The fused MSE path: pack once, add every chunk's packed gradients
    into two accumulators, unpack once (`engine.py:712-753`). With
    ``occupancy``, ``bins(i, o, d)`` gives chunk ``i``'s probe bins and the
    fine pass samples its depths from them in ``sample_merge``: with the
    stratified coarse depths as partner when the tier merges (``s_m > 0``),
    without partner otherwise (``s_m = 0``)."""
    enc = (config.pos_emb_xyz, config.pos_emb_dir)
    with spans.span("engine.pack"):
        packed_c = pack_mlp_params(state.coarse_params, config.mlp, *enc)
        packed_f = pack_mlp_params(state.fine_params, config.mlp, *enc)
        acc = (zero_grads(packed_c), zero_grads(packed_f))
    images = ([], [])
    for i, (o, d, t, tgt, u) in enumerate(zip(*chunks, draws)):
        with spans.span("engine.chunk"):
            fine_in = None
            if occupancy is not None:
                fine_in = (*bins(i, o, d), u, t if occupancy[5] else None)
            outs = _fused_chunk_pair(packed_c, packed_f, o, d, t, u, config,
                                     target=tgt, grads=acc,
                                     fine_sample_inputs=fine_in)
        for img, out in zip(images, outs):
            img.append(out[0])
    with spans.span("engine.pack"):
        grads = tuple(unpack_grads(a, config.mlp, *enc) for a in acc)
    return grads, images


def _autograd_grads(state: TrainState, chunks, draws, config: NeRFConfig,
                    loss_fn, occupancy: tuple | None = None, bins=None):
    """Torch autograd per chunk over ``render_chunk_pair`` of ``loss_fn``'s
    coarse + fine loss; ``.grad`` sums the chunks (`engine.py:754-787`).
    The kernel branch of ``render_chunk`` (T5/T6) or the float32
    reference. With ``occupancy`` the coarse pass renders as without it,
    and the fine pass renders the depths :func:`sample_occupied` draws
    from chunk ``i``'s probe bins ``bins(i, o, d)``, rank-merged with the
    stratified depths when the tier merges; it reads no coarse weights."""
    params = tuple(tree_map(lambda x: x.detach().requires_grad_(True), p)
                   for p in (state.coarse_params, state.fine_params))
    images = ([], [])
    for i, (o, d, t, tgt, u) in enumerate(zip(*chunks, draws)):
        with spans.span("engine.chunk"):
            with spans.span("engine.forward"):
                if occupancy is None:
                    outs = render_chunk_pair(*params, o, d, t, u, config)
                else:
                    fine = occ_mod.sample_occupied(u, *bins(i, o, d))
                    if occupancy[5]:
                        fine = merge_sorted(t, fine)
                    outs = (render_chunk(params[0], o, d, t, config)[0],
                            render_chunk(params[1], o, d, fine, config)[0])
                loss = sum(loss_fn(tgt, out.image) for out in outs)
            with spans.span("engine.backward"):
                loss.backward()
        for img, out in zip(images, outs):
            img.append(out.image.detach())
    grads = tuple(tree_map(lambda x: x.grad, p) for p in params)
    return grads, images


def train_step(state: TrainState, batch,
               fine_draws: torch.Generator | Sequence[torch.Tensor],
               optimizer: Optimizer, config: NeRFConfig,
               ray_chunks: int, loss_fn=None, occupancy: tuple | None = None,
               occ_grid: torch.Tensor | None = None,
               occ_rows: torch.Tensor | None = None, group=None,
               debug_grads: bool = False) -> tuple[TrainState, dict]:
    """One optimizer step over one batch of whole-image rays
    (`engine.py:587-833`, `nerf.py:332-473`).

    Per chunk, each model's loss and its gradient; gradients summed over
    the chunks and scaled by ``1 / num_chunks``; one update per model.
    Metrics are 0-d tensors on the rays' device (nothing waits for the
    card): the six of :func:`_batch_metrics` (losses are the means of the
    chunk losses) plus ``coarse_grad_norm`` and ``fine_grad_norm``.

    Args:
      batch: ``(images [B, H, W, 3 or 4], (origin, direction, points))``.
      fine_draws: a ``torch.Generator`` on the rays' device, or one sorted
        ``[ray_chunks, n_fine]`` draw tensor per chunk (``[ray_chunks,
        n_samples]`` with ``occupancy``).
      loss_fn: ``loss(y_true, y_pred) -> scalar`` applied per chunk;
        :func:`mse_loss` by default, which the fused T3 path trains
        (:func:`_use_fused_train`).
      occupancy: ``(n_samples, n_probe, near, far, aabb, merge)`` turns on
        the opt-in occupancy-train tier (`engine.py:672-787`): the fine
        pass trains on ``n_samples`` depths drawn uniformly over the
        occupied probe bins of ``occ_grid`` (``[G, G, G]``, baked outside
        the step) along each ray, rank-merged with the stratified coarse
        depths when ``merge`` is set (so free space stays supervised),
        instead of the coarse weights' importance samples; the coarse pass
        trains exactly as without it.
      occ_rows: ``[num_rays, n_probe]`` uint8 probe rows of this batch's
        rays (``ops.occupancy.probe_rows_for_poses``), the probe-row cache
        tier: used in place of probing ``occ_grid``, which it then needs
        not; the same step bit for bit.
      group: a ``parallel.Group``: this is one rank's step of synchronous
        data parallelism (`engine.py:796-798,831-832`). ``batch`` is the
        rank's share and ``fine_draws`` its own; each model's averaged
        gradients are all-reduced as one flat buffer and divided by the
        world size before the update, the gradient norms are those of the
        all-reduced gradients and the metrics are averaged over the ranks
        last, so every rank returns the same state and metrics.
      debug_grads: add one gradient norm per parameter tensor,
        ``grad_norm/{coarse,fine}[path]`` as JAX names them
        (`engine.py:823-830`).
    """
    if loss_fn is None:
        loss_fn = mse_loss
    config = dataclasses.replace(config, fast_render=0)
    images = batch[0]
    chunks = _chunked_batch(batch, config, ray_chunks)
    num_chunks = chunks[0].shape[0]
    device = chunks[0].device
    bins = None
    if occupancy is not None:
        if occ_grid is None and occ_rows is None:
            raise ValueError("occupancy training needs occ_grid or the "
                             "cached occ_rows")
        rows = (None if occ_rows is None else torch.as_tensor(
            occ_rows, device=device).reshape(num_chunks, ray_chunks, -1))

        def bins(i, o, d):
            return _occupancy_bins(occupancy, o, d, occ_grid,
                                   None if rows is None else rows[i])
    draws = _chunk_draws(fine_draws, num_chunks, ray_chunks,
                         config.n_fine if occupancy is None else occupancy[0],
                         device)
    if _use_fused_train(config, loss_fn, device):
        grads, (imgs_c, imgs_f) = _fused_grads(state, chunks, draws, config,
                                               occupancy, bins)
    else:
        grads, (imgs_c, imgs_f) = _autograd_grads(state, chunks, draws,
                                                  config, loss_fn, occupancy,
                                                  bins)
    inv = 1.0 / num_chunks
    grads_c, grads_f = (tree_map(lambda g: g * inv, x) for x in grads)
    if group is not None:
        grads_c, grads_f = (_group_mean(g, group) for g in (grads_c, grads_f))
    target = chunks[3]
    # The reported losses are loss_fn's of the chunk images (`:768-769`).
    loss_c, loss_f = (torch.stack([loss_fn(tgt, img) for tgt, img in
                                   zip(target, imgs)]).mean()
                      for imgs in (imgs_c, imgs_f))
    with spans.span("engine.update"):
        coarse, opt_c = optimizer.update(grads_c, state.coarse_opt,
                                         state.coarse_params)
    with spans.span("engine.update"):
        fine, opt_f = optimizer.update(grads_f, state.fine_opt,
                                       state.fine_params)
    new_state = TrainState(coarse, fine, opt_c, opt_f, state.step + 1)
    shape = images.shape[:3] + (3,)
    metrics = _batch_metrics(torch.cat(imgs_c).reshape(shape),
                             torch.cat(imgs_f).reshape(shape),
                             target.reshape(shape), loss_c, loss_f)
    metrics["coarse_grad_norm"] = global_norm(grads_c)
    metrics["fine_grad_norm"] = global_norm(grads_f)
    if debug_grads:
        for name, g in (("coarse", grads_c), ("fine", grads_f)):
            for path, leaf in _leaf_paths(g):
                metrics[f"grad_norm/{name}{path}"] = torch.sqrt(
                    torch.sum(torch.square(leaf)))
    if group is not None:
        metrics = _metrics_mean(metrics, group)
    return new_state, metrics


@torch.no_grad()
def eval_step(state: TrainState, batch,
              fine_draws: torch.Generator | Sequence[torch.Tensor],
              config: NeRFConfig, ray_chunks: int, loss_fn=None, group=None,
              gather_images: bool = False) -> dict:
    """Chunked render without weights, then the six metrics over the whole
    images, the losses by ``loss_fn`` (:func:`mse_loss` by default;
    `engine.py:836-878`); 0-d tensors on the rays' device.

    With a ``parallel.Group`` the batch is this rank's share: the ranks'
    metrics are averaged; with ``gather_images`` (height bands) the bands
    of both images and of the target are all-gathered into whole images
    first, so PSNR and SSIM are whole-image numbers."""
    if loss_fn is None:
        loss_fn = mse_loss
    config = dataclasses.replace(config, fast_render=0)
    images, rays = batch
    target = images[..., :3].to(torch.float32)
    out_c, out_f = render_image_batch(state.coarse_params, state.fine_params,
                                      rays, fine_draws, config, ray_chunks,
                                      with_weights=False)
    img_c, img_f = out_c["image"], out_f["image"]
    if gather_images and group is not None:
        img_c, img_f, target = (group.all_gather(x, 1)
                                for x in (img_c, img_f, target))
    metrics = _batch_metrics(img_c, img_f, target, loss_fn(target, img_c),
                             loss_fn(target, img_f))
    if group is not None:
        metrics = _metrics_mean(metrics, group)
    return metrics
