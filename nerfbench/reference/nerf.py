"""A plain coarse + fine NeRF in PyTorch, after keras_nerf
(naufalso/keras_nerf: ``model/nerf/mlp.py``, ``nerf.py``, ``utils.py``)
and Mildenhall et al. 2020 (arXiv:2003.08934), written out again here.

* Encoding: the raw coordinate, then ``sin(2^l x), cos(2^l x)`` for each
  frequency ``l`` (no pi), interleaved.
* MLP: ``n_layers`` dense layers with relu; after each layer ``i > 0``
  with ``i % skip_layer == 0`` the encoded position is concatenated; then
  ``sigma = relu(dense)``, ``features = dense`` (no activation),
  ``rgb_features = dense([features, encoded direction])`` (no activation)
  and ``rgb = sigmoid(dense)``.
* Quadrature: ``alpha = 1 - exp(-sigma delta)``, the last delta 1e-10,
  transmittance the exclusive product of ``1 - alpha + 1e-10``; a white
  background adds ``1 - sum(weights)``; the image is clipped to [0, 1] with
  half the gradient at exactly 0 or 1.
* Fine sampling: keras_nerf's ``sample_pdf`` over the coarse weights plus
  1e-5, a 0-prepended CDF against the midpoints of the coarse depths
  repeated at the end, brackets found by ``searchsorted`` (right), a
  denominator under 1e-5 taken as 1; the samples merged with the coarse
  depths and sorted. The coarse weights are data to the fine pass.
* Loss: the mean over every ray's three channels of the squared or
  absolute error, for each model, the two summed; Adam as optax's
  (``eps`` outside the square root).

Matrix products run in float32 with TF32 off. ``precision="fp8"`` rounds
every product's two operands (and the cotangent in the backward) to
float8 e4m3 with a per-tensor scale: the control that must fail the
comparison (int8 with a per-tensor scale moved the first step's images
less than float8 on the CPU, so float8 is the control).
"""

from __future__ import annotations

import contextlib

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def exact_matmul():
    """Float32 products without TF32 inside the block."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 and back, scaled so that its largest
    magnitude lands on e4m3's largest (448)."""
    scale = 448.0 / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8MatMul(torch.autograd.Function):
    """``a @ w`` with both operands, and the cotangent in the backward,
    rounded by :func:`round_fp8`."""

    @staticmethod
    def forward(ctx, a, w):
        qa, qw = round_fp8(a), round_fp8(w)
        ctx.save_for_backward(qa, qw)
        return qa @ qw

    @staticmethod
    def backward(ctx, g):
        qa, qw = ctx.saved_tensors
        qg = round_fp8(g)
        return qg @ qw.T, qa.T @ qg


def _matmul(precision: str):
    if precision == "float32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8MatMul.apply
    raise ValueError(f"unknown precision {precision!r}")


def encode(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    parts = [x]
    for level in range(num_freqs):
        s = x * (2.0 ** level)
        parts += [torch.sin(s), torch.cos(s)]
    return torch.cat(parts, dim=-1)


def mlp(params: dict, enc_xyz: torch.Tensor, enc_dir: torch.Tensor,
        cfg: dict, mm, sigma_only: bool = False):
    """``([P, Dx], [P, Dd]) -> (rgb [P, 3] or None, sigma [P])``."""

    def dense(x, layer):
        return mm(x, layer["kernel"]) + layer["bias"]

    x = enc_xyz
    for i, layer in enumerate(params["trunk"]):
        x = torch.relu(dense(x, layer))
        if i > 0 and i % cfg["skip_layer"] == 0:
            x = torch.cat([x, enc_xyz], dim=-1)
    sigma = torch.relu(dense(x, params["sigma"]))[:, 0]
    if sigma_only:
        return None, sigma
    features = dense(x, params["features"])
    rgb_features = dense(torch.cat([features, enc_dir], dim=-1),
                         params["rgb_features"])
    return torch.sigmoid(dense(rgb_features, params["rgb"])), sigma


def clip01(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 1]; PyTorch's binary max and min split the gradient at a
    tie, so a value of exactly 0 or 1 passes half of it."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)


def composite(rgb, sigma, t, white_background: bool):
    """``(image [R, 3] or None, depth [R], weights [R, S])`` of the samples
    at depths ``t [R, S]``."""
    delta = torch.cat([t[:, 1:] - t[:, :-1],
                       torch.full_like(t[:, :1], 1e-10)], dim=1)
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    weights = alpha * trans
    depth = (weights * t).sum(dim=1)
    if rgb is None:
        return None, depth, weights
    image = (weights[..., None] * rgb).sum(dim=1)
    if white_background:
        image = image + (1.0 - weights.sum(dim=1))[:, None]
    return clip01(image), depth, weights


def sample_pdf(u: torch.Tensor, t: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Depths for the draws ``u [R, N]`` from the coarse weights ``[R, S]``
    at the coarse depths ``t [R, S]``."""
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    bins = torch.cat([mids, mids[:, -1:], mids[:, -1:]], dim=1)   # [R, S+1]
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(dim=1, keepdim=True), dim=1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=1)   # [R, S+1]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=cdf.shape[1] - 1)
    cdf_lo, cdf_hi = cdf.gather(1, below), cdf.gather(1, above)
    bin_lo, bin_hi = bins.gather(1, below), bins.gather(1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)


def render_pass(params: dict, origin, direction, t, cfg: dict, mm,
                sigma_only: bool = False):
    """One model over the depths ``t [R, S]`` of rays ``[R, 3]``."""
    r, s = t.shape
    pos = origin[:, None, :] + direction[:, None, :] * t[..., None]
    dirs = direction[:, None, :].expand(r, s, 3)
    enc_xyz = encode(pos.reshape(r * s, 3), cfg["pos_emb_xyz"])
    enc_dir = encode(dirs.reshape(r * s, 3), cfg["pos_emb_dir"])
    rgb, sigma = mlp(params, enc_xyz, enc_dir, cfg, mm, sigma_only)
    rgb = None if rgb is None else rgb.reshape(r, s, 3)
    return composite(rgb, sigma.reshape(r, s), t, cfg["white_background"])


def fine_depths(t, u, coarse_weights):
    fine = sample_pdf(u, t, coarse_weights.detach())
    return torch.sort(torch.cat([t, fine], dim=1), dim=1).values


@torch.no_grad()
def render(coarse: dict, fine: dict, origin, direction, t, u, cfg: dict,
           precision: str = "float32", block: int = 8192):
    """The fine image ``[R, 3]`` and depth ``[R]`` of rays ``[R, 3]`` with
    coarse depths ``t [R, n_coarse]`` and draws ``u [R, n_fine]``, in
    blocks of ``block`` rays."""
    mm = _matmul(precision)
    images, depths = [], []
    with exact_matmul():
        for i in range(0, origin.shape[0], block):
            sl = slice(i, i + block)
            o, d, tc = origin[sl], direction[sl], t[sl]
            _, _, w = render_pass(coarse, o, d, tc, cfg, mm, sigma_only=True)
            tf = fine_depths(tc, u[sl], w)
            image, depth, _ = render_pass(fine, o, d, tf, cfg, mm)
            images.append(image)
            depths.append(depth)
    return torch.cat(images), torch.cat(depths)


def leaves(params) -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of a parameter tree (dicts and lists), in order."""
    if isinstance(params, dict):
        return [(f"{k}.{p}" if p else k, x) for k in params
                for p, x in leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [(f"{i}.{p}" if p else str(i), x)
                for i, v in enumerate(params) for p, x in leaves(v)]
    return [("", params)]


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def loss_terms(image, target, loss: str):
    if loss == "mse":
        return torch.square(image - target)
    if loss == "l1":
        return torch.abs(image - target)
    raise ValueError(f"unknown loss {loss!r}")


def gradients(coarse: dict, fine: dict, target, origin, direction, t, u,
              cfg: dict, loss: str, precision: str = "float32",
              block: int = 2048, keep=None):
    """``((coarse loss, fine loss), (coarse grads, fine grads), (coarse
    image, fine image))`` of one batch of rays ``[R, ...]`` with targets
    ``[R, 3]``: each loss the mean of its per-channel terms over the rays,
    in blocks of ``block`` rays. ``keep``, a boolean ``[R]``, trains on
    those rays alone (a planted fault)."""
    mm = _matmul(precision)
    params = [_map(lambda x: x.detach().clone().requires_grad_(True), p)
              for p in (coarse, fine)]
    rays = torch.arange(origin.shape[0], device=origin.device)
    if keep is not None:
        rays = rays[keep]
    n = rays.numel() * 3
    totals = [0.0, 0.0]
    images = ([], [])
    with exact_matmul():
        for i in range(0, rays.numel(), block):
            sl = rays[i:i + block]
            o, d, tc, tgt = origin[sl], direction[sl], t[sl], target[sl]
            img_c, _, w = render_pass(params[0], o, d, tc, cfg, mm)
            img_f, _, _ = render_pass(params[1], o, d,
                                      fine_depths(tc, u[sl], w), cfg, mm)
            parts = [loss_terms(img, tgt, loss).sum() / n
                     for img in (img_c, img_f)]
            (parts[0] + parts[1]).backward()
            for k, img in enumerate((img_c, img_f)):
                totals[k] += float(parts[k].detach())
                images[k].append(img.detach())
    grads = [_map(lambda x: x.grad, p) for p in params]
    return (tuple(totals), tuple(grads),
            tuple(torch.cat(x) for x in images))


def adam(params: dict, grads: dict, state: dict | None, lr: float,
         b1: float = ADAM_B1, b2: float = ADAM_B2):
    """One Adam step: ``(new params, new state)``."""
    if state is None:
        state = {"count": 0, "mu": _map(torch.zeros_like, params),
                 "nu": _map(torch.zeros_like, params)}
    count = state["count"] + 1
    mu = _map(lambda g, m: b1 * m + (1 - b1) * g, grads, state["mu"])
    nu = _map(lambda g, v: b2 * v + (1 - b2) * g * g, grads, state["nu"])
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    new = _map(lambda p, m, v: p - lr * (m / c1) / (torch.sqrt(v / c2)
                                                    + ADAM_EPS),
               params, mu, nu)
    return new, {"count": count, "mu": mu, "nu": nu}


def pose_rays(c2w: torch.Tensor, h: int, w: int, focal: float):
    """``(origin, direction)`` ``[h, w, 3]`` of a camera-to-world ``[4,
    4]``: pixel ``(x, y)`` at ``((x - W/2) / f, -(y - H/2) / f, -1)`` in the
    camera, rotated, of unit length."""
    device = c2w.device
    y, x = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float64),
                          torch.arange(w, device=device, dtype=torch.float64),
                          indexing="ij")
    cam = torch.stack([(x - w * 0.5) / focal, -(y - h * 0.5) / focal,
                       -torch.ones_like(x)], dim=-1)
    rot = c2w[:3, :3].to(torch.float64)
    direction = (cam[..., None, :] * rot).sum(-1)
    direction = direction / torch.linalg.vector_norm(direction, dim=-1,
                                                     keepdim=True)
    origin = c2w[:3, 3].to(torch.float64).expand(h, w, 3)
    return origin.to(torch.float32), direction.to(torch.float32)
