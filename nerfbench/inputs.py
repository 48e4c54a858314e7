"""Inputs made on the device from the seed: the weights, the orbit's rays
and depths, and the fine pass's draws. The same seed gives the same
tensors on the same device; each is made in a few large calls."""

from __future__ import annotations

import math

import numpy as np
import torch

from nerfbench import flops, scene


def derive_seeds(seed: int, n: int = 8) -> list[int]:
    """``n`` independent 63-bit seeds from the run's ``--seed`` (any
    non-negative integer)."""
    words = np.random.SeedSequence(int(seed)).generate_state(2 * n, np.uint32)
    return [int(words[2 * i]) << 31 ^ int(words[2 * i + 1]) for i in range(n)]


def leaf_specs(cfg: dict) -> list[tuple[tuple, tuple[int, int]]]:
    """``(path, (fan_in, fan_out))`` of every dense layer of one MLP, in the
    reference layout: the trunk, then sigma, features, rgb features and
    rgb."""
    u = cfg["dense_units"]
    in_x = flops.encoded_dim(cfg["pos_emb_xyz"])
    in_d = flops.encoded_dim(cfg["pos_emb_dir"])
    skip = flops.skip_layers(cfg)
    specs, width = [], in_x
    for i in range(cfg["n_layers"]):
        specs.append((("trunk", i), (width, u)))
        width = u + (in_x if i in skip else 0)
    specs += [(("sigma",), (width, 1)), (("features",), (width, u)),
              (("rgb_features",), (u + in_d, u // 2)),
              (("rgb",), (u // 2, 3))]
    return specs


def make_params(generator: torch.Generator, cfg: dict,
                sigma_bias: float = 0.0) -> dict:
    """One MLP's float32 parameters, ``{"trunk": [{"kernel", "bias"}, ...],
    "sigma", "features", "rgb_features", "rgb"}``: Glorot-uniform kernels
    (Keras's default) from one draw of the generator, zero biases but the
    density's, which is ``sigma_bias``."""
    specs = leaf_specs(cfg)
    sizes = [a * b for _, (a, b) in specs]
    device = generator.device
    u = torch.rand(sum(sizes), generator=generator, device=device)
    params: dict = {"trunk": []}
    for (path, (fan_in, fan_out)), flat in zip(specs, u.split(sizes)):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        layer = {"kernel": (flat * (2 * limit) - limit).view(fan_in, fan_out),
                 "bias": torch.zeros(fan_out, device=device)}
        if path[0] == "trunk":
            params["trunk"].append(layer)
        else:
            params[path[0]] = layer
    params["sigma"]["bias"] += sigma_bias
    return params


def sorted_draws(generator: torch.Generator, shape: tuple,
                 n: int) -> torch.Tensor:
    """``[*shape, n]`` ascending uniform draws in (0, 1): normalized
    partial sums of ``n + 1`` exponential spacings (the law of ``n``
    sorted uniforms, made sorted)."""
    e = torch.empty((*shape, n + 1), device=generator.device)
    e.exponential_(generator=generator)
    s = torch.cumsum(e, dim=-1)
    return s[..., :-1] / s[..., -1:]


def stratified_depths(generator: torch.Generator, shape: tuple, n: int,
                      near: float, far: float) -> torch.Tensor:
    """``[*shape, n]`` depths, one uniform draw in each of ``n`` equal
    strata centred on ``linspace(near, far, n)``, clamped to [near, far]."""
    device = generator.device
    centres = torch.linspace(near, far, n, device=device)
    step = (far - near) / n
    jitter = torch.rand((*shape, n), generator=generator, device=device)
    return torch.clamp(centres + (jitter - 0.5) * step, near, far)


def camera_rays(c2w: torch.Tensor, h: int, w: int, focal: float):
    """``(origin, direction)``, each ``[h, w, 3]`` float32 on ``c2w``'s
    device; pixel ``(x, y)`` at camera coordinates ``((x - W/2) / f,
    -(y - H/2) / f, -1)``, directions of unit length."""
    device = c2w.device
    y, x = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                          torch.arange(w, device=device, dtype=torch.float32),
                          indexing="ij")
    cam = torch.stack([(x - w * 0.5) / focal, -(y - h * 0.5) / focal,
                       -torch.ones_like(x)], dim=-1)
    rot = c2w[:3, :3]
    direction = (cam[..., None, :] * rot).sum(-1)
    direction = direction / torch.linalg.vector_norm(direction, dim=-1,
                                                     keepdim=True)
    origin = c2w[:3, 3].expand(h, w, 3)
    return origin, direction


def orbit_inputs(cfg: dict, traffic: dict, generator: torch.Generator):
    """Per orbit pose ``((origin, direction, points), draws)``: the rays
    ``[1, H, W, 3]``, stratified depths ``[1, H, W, n_coarse]`` and sorted
    fine draws ``[chunks, ray_chunks, n_fine]`` for the render's chunks."""
    wh = cfg["img_wh"]
    focal = scene.focal_from_fov(traffic["fov"], wh)
    chunk = cfg["render_ray_chunks"]
    n_chunks = wh * wh // chunk
    device = generator.device
    out = []
    for c2w in scene.orbit_poses(traffic):
        c2w = torch.as_tensor(c2w, device=device)
        origin, direction = camera_rays(c2w, wh, wh, focal)
        points = stratified_depths(generator, (1, wh, wh), cfg["n_coarse"],
                                   cfg["near"], cfg["far"])
        draws = sorted_draws(generator, (n_chunks, chunk), cfg["n_fine"])
        out.append(((origin[None].contiguous(), direction[None].contiguous(),
                     points), draws))
    return out
