"""The operations a NeRF step and a frame need, counted from the sizes of
the model (2 FLOP a multiply-add), whatever padding a kernel computes or
work it repeats, and the peak they are held against.

Per point of the 8 x 256 MLP with L = 10 / 4: the forward 1,186,816 FLOP
(982,528 for density alone), the backward's dX products 1,115,392 (the
encoding takes no cotangent) and its dW products as many as the forward,
so a training point costs 3,489,024 FLOP.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense bf16 on the tensor cores (NVIDIA's data sheet).
PEAK_BF16_FLOPS = 989e12


def encoded_dim(num_freqs: int) -> int:
    """Width of a 3-vector's encoding: the raw value, then a sine and a
    cosine per frequency."""
    return 3 * (1 + 2 * num_freqs)


def skip_layers(cfg: dict) -> set[int]:
    """Trunk layers whose output is concatenated with the encoded position
    (keras_nerf's ``i % skip_layer == 0 and i > 0``)."""
    return {i for i in range(cfg["n_layers"])
            if i % cfg["skip_layer"] == 0 and i > 0}


def fwd_flop_per_point(cfg: dict, sigma_only: bool = False) -> int:
    u = cfg["dense_units"]
    in_x = encoded_dim(cfg["pos_emb_xyz"])
    in_d = encoded_dim(cfg["pos_emb_dir"])
    skip = skip_layers(cfg)
    flops, width = 0, in_x
    for i in range(cfg["n_layers"]):
        flops += 2 * width * u
        width = u + (in_x if i in skip else 0)
    flops += 2 * width                      # sigma
    if sigma_only:
        return flops
    flops += 2 * width * u                  # features
    flops += 2 * (u + in_d) * (u // 2)      # rgb features
    flops += 2 * (u // 2) * 3               # rgb
    return flops


def bwd_dx_flop_per_point(cfg: dict) -> int:
    """The backward's products whose input is an activation: the rgb head,
    the rgb features (not their direction rows), sigma and features
    together, and every trunk layer but the first (not the encoding rows
    after a skip)."""
    u = cfg["dense_units"]
    return (2 * 3 * (u // 2) + 2 * (u // 2) * u + 2 * (u + 1) * u
            + 2 * u * u * (cfg["n_layers"] - 1))


def train_flop_per_point(cfg: dict) -> int:
    return 2 * fwd_flop_per_point(cfg) + bwd_dx_flop_per_point(cfg)


def train_flop_per_ray(cfg: dict) -> int:
    """A training ray: the coarse pass on its stratified depths and the
    fine pass on those merged with the importance samples, each forward
    and backward."""
    points = 2 * cfg["n_coarse"] + cfg["n_fine"]
    return points * train_flop_per_point(cfg)


def render_flop_per_ray(cfg: dict) -> int:
    """A rendered ray: the coarse pass for density alone, then the fine
    pass whole."""
    n_c, n_f = cfg["n_coarse"], cfg["n_fine"]
    return (n_c * fwd_flop_per_point(cfg, sigma_only=True)
            + (n_c + n_f) * fwd_flop_per_point(cfg))
