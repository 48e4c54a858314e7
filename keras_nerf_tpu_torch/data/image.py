"""Image loading and alpha compositing (a copy of
``keras_nerf_tpu/data/image.py``, kept here so the port never imports the
JAX package; PIL is imported where an image is read).

Host-side replacement for the reference's TF ``ImageLoader``
(`keras_nerf/data/image.py:5-35`): read PNG -> float32 RGBA in [0, 1], resize
with antialiasing, composite RGB over a white or black background using the
alpha channel, re-append alpha, clip.

Runs on the host with PIL + NumPy (the dataset is ~100 images per split —
decode cost is trivial and images are cached as one contiguous array). The
reference's resize takes ``(width, height)`` where TF expects
``(height, width)`` (`image.py:22-23`) — benign for its square-only inputs; we
are H/W-correct (SURVEY.md §7 "known quirks").
"""

from __future__ import annotations

import numpy as np

RESIZE_METHODS = ("lanczos", "antialias-bilinear")


def _triangle_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``[out, in]`` row-normalized triangle-kernel resampling weights.

    Matches ``tf.image.resize(..., method='bilinear', antialias=True)`` /
    ``jax.image.resize``: half-pixel sample centers, kernel support scaled by
    ``max(1, in/out)`` so downscales are antialiased (the reference's resize,
    `keras_nerf/data/image.py:22-23`). Parity-pinned against tf.image.resize
    in the JAX package's ``tests/parity/test_reference_parity.py``.
    """
    scale = out_size / in_size
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=1, keepdims=True)
    return (weights / np.maximum(total, 1e-12)).astype(np.float32)


def resize_antialias_bilinear(
    image: np.ndarray, out_height: int, out_width: int
) -> np.ndarray:
    """Separable antialiased bilinear resize of ``[H, W, C]`` float pixels,
    numerically matching ``tf.image.resize(antialias=True)`` (the reference's
    filter) so real-dataset PSNR comparisons are input-identical."""
    wh = _triangle_weight_matrix(image.shape[0], out_height)
    ww = _triangle_weight_matrix(image.shape[1], out_width)
    out = np.einsum("oh,hwc->owc", wh, image.astype(np.float32))
    return np.einsum("ow,hwc->hoc", ww, out)


def load_image(
    path: str,
    image_height: int,
    image_width: int,
    white_background: bool = False,
    resize_method: str = "lanczos",
) -> np.ndarray:
    """Load one PNG -> ``[H, W, 4]`` float32 RGBA in [0, 1], composited.

    ``resize_method``: ``"lanczos"`` (default, PIL high-quality) or
    ``"antialias-bilinear"`` (bit-parity with the reference's
    ``tf.image.resize(..., antialias=True)``, `image.py:22-23`).

    Reference: `keras_nerf/data/image.py:18-35`.
    """
    if resize_method not in RESIZE_METHODS:
        raise ValueError(
            f"resize_method {resize_method!r}; options: {RESIZE_METHODS}")
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGBA")
        if im.size == (image_width, image_height):
            rgba = np.asarray(im, dtype=np.float32) / 255.0
        elif resize_method == "lanczos":
            im = im.resize((image_width, image_height),
                           Image.Resampling.LANCZOS)
            rgba = np.asarray(im, dtype=np.float32) / 255.0
        else:
            rgba = resize_antialias_bilinear(
                np.asarray(im, dtype=np.float32) / 255.0,
                image_height, image_width)

    alpha = rgba[..., 3:4]
    rgb = rgba[..., :3]
    background = 1.0 if white_background else 0.0
    rgb = alpha * rgb + (1.0 - alpha) * background
    out = np.concatenate([rgb, alpha], axis=-1)
    return np.clip(out, 0.0, 1.0)


def load_images(
    paths: list[str],
    image_height: int,
    image_width: int,
    white_background: bool = False,
    resize_method: str = "lanczos",
) -> np.ndarray:
    """Load a list of PNGs into one ``[N, H, W, 4]`` float32 array."""
    out = np.empty((len(paths), image_height, image_width, 4), dtype=np.float32)
    for i, p in enumerate(paths):
        out[i] = load_image(p, image_height, image_width, white_background,
                            resize_method)
    return out
