"""Stratified and hierarchical (inverse-CDF) sampling along rays (port of
``keras_nerf_tpu/ops/sampling.py``).

Randomness comes from explicit ``torch.Generator`` objects. JAX's threefry
stream cannot be reproduced here, so parity tests hand both packages the
same draws (:func:`invert_cdf` takes them directly).
"""

from __future__ import annotations

import torch



def fma_f32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding: the float64 product of two
    float32 values is exact, so only the sum rounds (then once more to
    float32, which agrees with a true FMA but for rare double-rounding
    ties)."""
    f64 = torch.float64
    a, b, c = (x.to(f64) if isinstance(x, torch.Tensor) else x
               for x in (a, b, c))
    return (a * b + c).to(torch.float32)


def stratified_sample_points(
    generator: torch.Generator,
    batch_shape: tuple[int, ...],
    n_samples: int,
    near: float,
    far: float,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Jittered linspace depths ``[*batch_shape, n_samples]`` in
    ``[near, far]`` (`keras_nerf/data/rays.py:116-127`), on the generator's
    device."""
    device = generator.device
    t = torch.linspace(near, far, n_samples, dtype=dtype, device=device)
    interval = (far - near) / n_samples
    noise = torch.rand((*batch_shape, n_samples), generator=generator,
                       dtype=dtype, device=device) * interval - interval / 2
    return torch.clamp(t + noise, near, far)


def batched_searchsorted_right(cdf: torch.Tensor,
                               u: torch.Tensor) -> torch.Tensor:
    """``searchsorted(cdf, u, side="right")`` for every leading index:
    ``cdf [..., S]`` sorted along its last axis, queries ``u [..., N]``;
    int32 ``[..., N]`` indices in ``0..S``, each the count of CDF entries
    ``<= u`` (`ops/sampling.py:48-60`)."""
    le = cdf[..., None, :] <= u[..., :, None]               # [..., N, S]
    return le.sum(dim=-1, dtype=torch.int32)


def sample_pdf(generator: torch.Generator, mid_points: torch.Tensor,
               weights: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Inverse-CDF depths ``[..., n_samples]``, NOT sorted, from unsorted
    uniform draws of ``generator`` over bins ``mid_points [..., S]`` with
    weights ``[..., S+1]`` (the full coarse weights, `nerf.py:186-187`;
    `ops/sampling.py:63-87`, `keras_nerf/model/nerf/utils.py:61-97`)."""
    u = torch.rand((*mid_points.shape[:-1], n_samples), generator=generator,
                   dtype=mid_points.dtype, device=mid_points.device)
    return invert_cdf(u, mid_points, weights)


def invert_cdf(u: torch.Tensor, mid_points: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF depths for the draws ``u [..., N]`` over bins
    ``mid_points [..., S-1]`` with weights ``[..., S]``.

    Same math as the JAX version (`ops/sampling.py:119-153`): weights
    +1e-5, a 0-prepended CDF, masked max/min brackets, midpoints edge-padded
    to the CDF's length, and the ``denom < 1e-5 -> 1`` clamp.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    return invert_cdf_of(u, mid_points, torch.cumsum(pdf, dim=-1))


def sequential_cdf(weights: torch.Tensor) -> torch.Tensor:
    """The inclusive CDF ``[..., S]`` of ``weights + 1e-5``, the total and
    every prefix summed bin after bin in float32 (``torch.cumsum``
    accumulates in float64 on the CPU, ``torch.sum`` pairwise): each
    prefix is the one before plus the bin's share, so the CDF never steps
    down. The ``sample_merge`` kernel sums in the same order."""
    w = weights + 1e-5
    total = torch.zeros_like(w[..., 0])
    for i in range(w.shape[-1]):
        total = total + w[..., i]
    pdf = w / total[..., None]
    acc = torch.zeros_like(total)
    cdf = []
    for i in range(w.shape[-1]):
        acc = acc + pdf[..., i]
        cdf.append(acc)
    return torch.stack(cdf, -1)


def invert_cdf_of(u: torch.Tensor, mid_points: torch.Tensor,
                  cdf: torch.Tensor) -> torch.Tensor:
    """:func:`invert_cdf` from the inclusive CDF ``[..., S]`` of the
    weights (+1e-5) on: the draws ``u [..., N]`` -> depths."""
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    inf = torch.tensor(float("inf"), dtype=cdf.dtype, device=cdf.device)
    le = cdf[..., :, None] <= u[..., None, :]          # [..., S+1, N]
    cdf_b = cdf[..., :, None]
    cdf_below = torch.where(le, cdf_b, -inf).amax(dim=-2)
    cdf_above = torch.where(le, inf, cdf_b).amin(dim=-2)
    cdf_above = torch.where(torch.isinf(cdf_above), cdf[..., -1:], cdf_above)

    pad = cdf.shape[-1] - mid_points.shape[-1]
    mids_pad = torch.cat([mid_points] + [mid_points[..., -1:]] * pad, dim=-1)
    mids_b = mids_pad[..., :, None]
    bins_below = torch.where(le, mids_b, -inf).amax(dim=-2)
    bins_above = torch.where(le, inf, mids_b).amin(dim=-2)
    bins_above = torch.where(torch.isinf(bins_above), mids_pad[..., -1:],
                             bins_above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sorted_uniforms(generator: torch.Generator, batch_shape: tuple[int, ...],
                    n_samples: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[*batch_shape, n_samples]`` ascending uniform draws: the normalized
    partial sums of ``n + 1`` iid Exp(1) spacings (the distribution of
    ``n`` sorted uniforms, produced already sorted)."""
    exp = torch.empty((*batch_shape, n_samples + 1), dtype=dtype,
                      device=generator.device).exponential_(
                          generator=generator)
    s = torch.cumsum(exp, dim=-1)
    return s[..., :-1] / s[..., -1:]


def sample_pdf_sorted(generator: torch.Generator, mid_points: torch.Tensor,
                      weights: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Sorted inverse-CDF samples (sorted draws through :func:`invert_cdf`)."""
    u = sorted_uniforms(generator, tuple(mid_points.shape[:-1]), n_samples,
                        dtype=mid_points.dtype)
    return invert_cdf(u, mid_points, weights)


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge per-ray SORTED ``a [..., M]`` and ``b [..., N]`` into a sorted
    ``[..., M+N]``: every element's slot is its index plus the count of the
    other array ahead of it; an ``a`` element precedes an equal ``b`` one
    (`ops/sampling.py:212-219`)."""
    m, n = a.shape[-1], b.shape[-1]
    le = (a[..., :, None] <= b[..., None, :]).to(torch.int64)   # [..., M, N]
    rank_a = torch.arange(m, device=a.device) + (n - le.sum(dim=-1))
    rank_b = torch.arange(n, device=a.device) + le.sum(dim=-2)
    out = torch.zeros((*a.shape[:-1], m + n), dtype=a.dtype, device=a.device)
    out.scatter_(-1, rank_a, a)
    out.scatter_(-1, rank_b, b)
    return out


def midpoints(sample_points: torch.Tensor) -> torch.Tensor:
    """``0.5 * (t[..., 1:] + t[..., :-1])`` (`nerf.py:182-183`)."""
    return 0.5 * (sample_points[..., 1:] + sample_points[..., :-1])
