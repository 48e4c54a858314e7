"""Occupancy-grid accelerated novel-view rendering, opt-in (port of
``keras_nerf_tpu/ops/occupancy.py``).

* :func:`bake_occupancy_grid` evaluates the trained fine model's density
  on a dense voxel grid over the scene's box (:func:`model_density_fn`:
  ``encode_block128`` and the ``apply_mlp`` kernel on the kernel path) and
  thresholds and dilates it into a binary occupancy volume;
* :func:`occupancy_along_rays` probes ``n_probe`` uniform bins per ray and
  gathers the containing voxel's occupancy: a ``[R, D]`` weight field;
* :func:`sample_occupied` inverts that field with the fine pass's
  inverse-CDF sampling, so that every MLP sample lands in occupied space;
* :func:`probe_rows_for_poses` probes every ray of a set of views once
  against a fixed grid: the occupancy-train tier's probe-row cache.

:func:`render_image_batch_occ` then evaluates only ``n_samples`` fine-model
points per ray; the coarse pass disappears. On the kernel path each chunk's
depths are drawn inside the ``sample_merge`` kernel in its no-merge mode
(``sample_inputs=(bin_mids, occ, u, None)``), then rendered through
``ray_march_mlp`` (or the int8 ``ray_march_mlp_int8``) and
``ray_march_quadrature``. Empty rays get a uniform spread (weights + 1e-5)
and render background.

This changes the math against the reference, which always runs the dense
coarse march, so it is opt-in for novel views. The occupancy-train tier
(``engine.train_step(occupancy=...)``, ``NeRF.compile(occupancy_train=G)``)
trains the fine pass on grid-placed depths the same way; evaluation never
uses the grid. The quality cost is measured in ``docs/QUALITY.md``.
"""

from __future__ import annotations

import functools
from collections.abc import Callable, Sequence

import torch

from keras_nerf_tpu_torch.ops.sampling import (
    invert_cdf_of,
    midpoints,
    sequential_cdf,
    sorted_uniforms,
)

# The Blender ``nerf_synthetic`` cameras orbit at radius ~4 looking at the
# origin with near/far 2..6: the object sits well inside [-2, 2]^3.
DEFAULT_AABB = ((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0))

# Points per apply_mlp launch of the bake (`ops/occupancy.py:127`).
DENSITY_CHUNK = 262144


def _bounds(aabb, device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.tensor(aabb[i], dtype=torch.float32, device=device)
                 for i in (0, 1))


# The per-chunk constants of the probe are uploaded to a device once: a
# host-to-card copy waits for the stream, so making them per chunk would
# hold the host until the card had finished the chunk before.
@functools.lru_cache(maxsize=None)
def _probe_constants_on(aabb: tuple, near: float, far: float, n_probe: int,
                        device: torch.device):
    return (probe_bin_mids(near, far, n_probe, device),
            *_bounds(aabb, device))


def grid_coordinates(grid_size: int, aabb=DEFAULT_AABB,
                     device=None) -> torch.Tensor:
    """Voxel-centre world coordinates ``[G, G, G, 3]`` float32, as
    ``lo + ((hi - lo) (i + 0.5)) / G`` in the JAX package's order."""
    lo, hi = _bounds(aabb, device)
    i = torch.arange(grid_size, dtype=torch.float32, device=device) + 0.5
    axes = [lo[a] + (hi[a] - lo[a]) * i / grid_size for a in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def dilate_occupancy(occ: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Binary dilation of ``[G, G, G]`` over the 6-neighbourhood: each voxel
    takes the max of itself and its face neighbours, nothing wrapping
    around the grid's faces. Covers thin surfaces between voxel centres and
    the half-probe-bin placement error of :func:`sample_occupied`."""
    for _ in range(iterations):
        shifted = [occ]
        for axis in range(3):
            up = torch.roll(occ, 1, dims=axis)
            up.narrow(axis, 0, 1).zero_()
            down = torch.roll(occ, -1, dims=axis)
            down.narrow(axis, occ.shape[axis] - 1, 1).zero_()
            shifted += [up, down]
        occ = torch.stack(shifted).amax(dim=0)
    return occ


def bake_occupancy_grid(density_fn: Callable[[torch.Tensor], torch.Tensor],
                        grid_size: int = 128, aabb=DEFAULT_AABB,
                        sigma_threshold: float = 1.0, dilate: int = 1,
                        device=None) -> torch.Tensor:
    """Evaluate ``density_fn([N, 3]) -> sigma [N]`` at the voxel centres
    (on ``device``) and threshold into a binary ``[G, G, G]`` float32
    volume, then dilate it ``dilate`` times.

    ``sigma_threshold`` is in raw density units: a voxel contributes alpha
    ``1 - exp(-sigma delta)`` per unit step, so 1.0 marks anything with
    non-negligible absorption at the scene's length scale."""
    coords = grid_coordinates(grid_size, aabb, device).reshape(-1, 3)
    sigma = density_fn(coords).reshape(grid_size, grid_size, grid_size)
    occ = (sigma > sigma_threshold).to(torch.float32)
    if dilate > 0:
        occ = dilate_occupancy(occ, dilate)
    return occ


def model_density_fn(params: dict, config, *, chunk: int = DENSITY_CHUNK):
    """The model's ``positions [N, 3] -> sigma [N]`` (the view direction,
    fixed at ``(0, 0, -1)``, does not reach sigma), without gradients, in
    host-side chunks of ``chunk`` points.

    Kernel path (:func:`~keras_nerf_tpu_torch.models.engine.
    resolve_use_kernels` of the parameters' device): ``encode_block128``
    and the ``apply_mlp`` kernel (T5) over weights packed once; reference
    path: ``apply_mlp`` in ``config.dtype`` with the encoding at ``t = 0``."""
    from keras_nerf_tpu_torch.kernels.ray_march import (
        apply_mlp,
        encode_block128,
        pack_mlp_params,
    )
    from keras_nerf_tpu_torch.models import engine
    from keras_nerf_tpu_torch.models.mlp import apply_mlp as apply_mlp_ref
    from keras_nerf_tpu_torch.ops.encoding import (
        encode_position_and_directions,
    )

    device = params["sigma"]["kernel"].device
    use_kernels = engine.resolve_use_kernels(config, device)
    packed = (pack_mlp_params(params, config.mlp, config.pos_emb_xyz,
                              config.pos_emb_dir) if use_kernels else None)

    def one_chunk(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        if use_kernels:
            enc = encode_block128(p, d, config.pos_emb_xyz,
                                  config.pos_emb_dir)
            return apply_mlp(packed, enc)[:, 3]
        enc_xyz, enc_dir = encode_position_and_directions(
            p, d, torch.zeros((p.shape[0], 1), dtype=p.dtype, device=device),
            config.pos_emb_xyz, config.pos_emb_dir)
        _, sigma = apply_mlp_ref(params, enc_xyz[:, 0], enc_dir[:, 0],
                                 config.mlp, config.dtype)
        return sigma[:, 0]

    @torch.no_grad()
    def density(positions: torch.Tensor) -> torch.Tensor:
        positions = positions.to(torch.float32).contiguous()
        dirs = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32,
                            device=positions.device).expand(positions.shape)
        return torch.cat([one_chunk(positions[i:i + chunk],
                                    dirs[i:i + chunk])
                          for i in range(0, positions.shape[0], chunk)])

    return density


def probe_bin_mids(near: float, far: float, n_probe: int,
                   device=None) -> torch.Tensor:
    """Centres ``[n_probe]`` of the uniform probe bins on ``[near, far]``:
    the depths :func:`occupancy_along_rays` probes at. The edges are
    ``jnp.linspace``'s, ``near (1 - i / D) + far i / D`` with the last edge
    ``far``, in the float32 arithmetic XLA compiles it to: ``c`` the float32
    reciprocal of ``D``, then ``fma(i, far c, near (1 - i c))``, so that
    the centres are the JAX package's bit for bit."""
    f32, f64 = torch.float32, torch.float64
    i = torch.arange(n_probe, dtype=f32, device=device)
    c = torch.tensor(1.0 / n_probe, dtype=f32, device=device)
    start = torch.tensor(near, dtype=f32, device=device)
    stop = torch.tensor(far, dtype=f32, device=device)
    # The float64 product of two float32 values is exact: one rounding.
    head = (i.to(f64) * (stop * c).to(f64) + (start * (1 - i * c)).to(f64))
    edges = torch.cat([head.to(f32), stop[None]])
    return 0.5 * (edges[1:] + edges[:-1])


# Probe points a chunk of probe_rows_for_poses makes at most: its float32
# [k, H W, n_probe, 3] temporary stays near 100 MB.
PROBE_ROWS_POINTS = 1 << 23


@torch.no_grad()
def probe_rows_for_poses(poses, focal: float, occ_grid: torch.Tensor, *,
                         image_height: int, image_width: int, near: float,
                         far: float, n_probe: int,
                         aabb=DEFAULT_AABB) -> torch.Tensor:
    """The probe-row cache (`ops/occupancy.py:175-206`): ``[N, 4, 4]``
    poses -> ``[N, H W, n_probe]`` uint8 occupancy rows against the FIXED
    grid ``occ_grid``, on the grid's device.

    A ray's origin and direction depend only on its pose (only the
    stratified depths are jittered), and the grid is constant between
    re-bakes, so each image's probe rows are a constant that the training
    step can gather instead of probing (``engine.train_step(occ_rows=)``);
    uint8 is exact for a binary grid. The rays are
    :func:`~keras_nerf_tpu_torch.data.rays.generate_rays`', probed by
    :func:`occupancy_along_rays`, in chunks of whole images of at most
    :data:`PROBE_ROWS_POINTS` probe points."""
    from keras_nerf_tpu_torch.data.rays import generate_rays

    device = occ_grid.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=device)
    pixels = image_height * image_width
    rows = torch.empty((poses.shape[0], pixels, n_probe), dtype=torch.uint8,
                       device=device)
    step = max(1, PROBE_ROWS_POINTS // (pixels * n_probe))
    for i in range(0, poses.shape[0], step):
        rays = [generate_rays(c2w, image_height, image_width, focal)
                for c2w in poses[i:i + step]]
        o = torch.cat([r[0].reshape(-1, 3) for r in rays])
        d = torch.cat([r[1].reshape(-1, 3) for r in rays])
        _, occ = occupancy_along_rays(o, d, occ_grid, near, far, n_probe,
                                      aabb)
        rows[i:i + len(rays)] = occ.reshape(len(rays), pixels, n_probe).to(
            torch.uint8)
    return rows


def cached_probe_bins(rows: torch.Tensor, near: float, far: float,
                      n_probe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe bins of cached rows ``[R, n_probe]``: ``(bin_mids``
    broadcast to every ray, the rows as float32``)``, the same tensors
    :func:`occupancy_along_rays` gives for the rays the rows were probed
    from (the same centres, bit for bit)."""
    mids = _probe_constants_on(DEFAULT_AABB, float(near), float(far),
                               n_probe, rows.device)[0]
    return mids.expand(rows.shape), rows.to(torch.float32)


def occupancy_along_rays(origin: torch.Tensor, direction: torch.Tensor,
                         occ_grid: torch.Tensor, near: float, far: float,
                         n_probe: int, aabb=DEFAULT_AABB):
    """Probe ``n_probe`` uniform bins per ray and gather the occupancy of
    the voxel that holds each bin's centre.

    Args:
      origin/direction: ``[R, 3]`` float32.
      occ_grid: ``[G, G, G]`` binary floats (:func:`bake_occupancy_grid`).

    Returns ``(bin_mids [R, n_probe], occ [R, n_probe])``: the centres
    broadcast to every ray (a view, row stride 0, which ``sample_merge``
    reads as it is), and the
    occupancy, 0 for points outside the box. ``o + d mid`` rounds twice
    and the voxel index is ``floor(((p - lo) / (hi - lo)) G)``, as in the
    JAX package; the gather is one flat index."""
    g = occ_grid.shape[0]
    aabb = tuple(tuple(float(v) for v in row) for row in aabb)
    mids, lo, hi = _probe_constants_on(aabb, float(near), float(far),
                                       n_probe, origin.device)
    pts = origin[:, None, :] + direction[:, None, :] * mids[None, :, None]
    idx = torch.floor((pts - lo) / (hi - lo) * g).to(torch.int64)
    inside = ((idx >= 0) & (idx < g)).all(dim=-1)
    idx = idx.clamp(0, g - 1)
    flat = (idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]
    occ = occ_grid.reshape(-1)[flat]
    occ = torch.where(inside, occ, torch.zeros_like(occ))
    return mids.expand(occ.shape), occ


def sample_occupied(draws: torch.Generator | torch.Tensor,
                    bin_mids: torch.Tensor, occ: torch.Tensor,
                    n_samples: int | None = None) -> torch.Tensor:
    """Sorted depths per ray, uniform over the occupied bins: the inverse
    CDF of the occupancy indicator (+1e-5, so an empty ray gets a uniform
    spread). ``draws`` are the sorted uniforms ``[R, n]``, or a
    ``torch.Generator`` that makes ``n_samples`` of them per ray.

    As in the JAX package, the D occupancy bins are the weights over the
    D - 1 interior midpoints of ``bin_mids``."""
    if isinstance(draws, torch.Generator):
        draws = sorted_uniforms(draws, (bin_mids.shape[0],), n_samples)
    # The sequential CDF gives the JAX package's depths bit for bit: through
    # the encoding's highest frequencies one ulp of a depth moves the
    # density visibly.
    return invert_cdf_of(draws, midpoints(bin_mids), sequential_cdf(occ))


@torch.no_grad()
def render_image_batch_occ(fine_params: dict, rays, occ_grid: torch.Tensor,
                           fine_draws: torch.Generator | Sequence[torch.Tensor],
                           config, near: float = 2.0, far: float = 6.0,
                           n_samples: int = 64, n_probe: int = 64,
                           ray_chunks: int = 8192, aabb=DEFAULT_AABB,
                           packed_q: dict | None = None) -> dict:
    """Whole-image occupancy render with the FINE model alone: ``{"image"
    [B, H, W, 3], "depth" [B, H, W]}`` from ``n_samples`` MLP points per
    ray, all placed in occupied space (`ops/occupancy.py:307-380`).

    Args:
      rays: ``(origin, direction[, points])``, each ``[B, H, W, .]``; the
        stratified points are not used (the grid replaces the coarse pass
        and the importance sampling).
      fine_draws: a ``torch.Generator`` on the rays' device, or one sorted
        ``[ray_chunks, n_samples]`` draw tensor per chunk.
      packed_q: the int8 FINE weights dict (``quantize_render_params``'s
        second item): the int8 tier composed with the grid (kernel path
        only; the reference path ignores it).

    On the kernel path the weights are packed once outside the chunk loop
    and every chunk samples its depths in the ``sample_merge`` kernel (no
    merge) at any ``n_probe`` and ``n_samples``; the reference path draws
    them with :func:`sample_occupied` and renders through the float32
    ``render_chunk``.
    """
    from keras_nerf_tpu_torch.kernels.ray_march import (
        fused_render_chunk,
        pack_mlp_params,
    )
    from keras_nerf_tpu_torch.models import engine

    origin, direction = rays[0], rays[1]
    b, h, w = origin.shape[:3]
    num_rays = b * h * w
    ray_chunks = min(ray_chunks, num_rays)
    if num_rays % ray_chunks:
        raise ValueError(f"ray_chunks {ray_chunks} must divide num_rays "
                         f"{num_rays}")
    nch = num_rays // ray_chunks
    o = origin.reshape(nch, ray_chunks, 3)
    d = direction.reshape(nch, ray_chunks, 3)
    draws = engine._chunk_draws(fine_draws, nch, ray_chunks, n_samples,
                                origin.device)
    kernels = engine.resolve_use_kernels(config, origin.device)
    packed = None
    if kernels and packed_q is None:
        packed = pack_mlp_params(fine_params, config.mlp, config.pos_emb_xyz,
                                 config.pos_emb_dir)
    images, depths = [], []
    for i in range(nch):
        mids, occ = occupancy_along_rays(o[i], d[i], occ_grid, near, far,
                                         n_probe, aabb)
        if kernels:
            image, depth, _ = fused_render_chunk(
                packed if packed_q is None else packed_q, o[i], d[i], None,
                pos_emb_xyz=config.pos_emb_xyz,
                pos_emb_dir=config.pos_emb_dir,
                white_background=config.white_background, emit_weights=False,
                sample_inputs=(mids, occ, draws[i], None),
                quantized=packed_q is not None)
        else:
            out, _ = engine.render_chunk(
                fine_params, o[i], d[i],
                sample_occupied(draws[i], mids, occ), config)
            image, depth = out.image, out.depth
        images.append(image)
        depths.append(depth)
    return {"image": torch.cat(images).reshape(b, h, w, 3),
            "depth": torch.cat(depths).reshape(b, h, w)}
