"""Tensor ops: encoding, quadrature, sampling, image metrics, and the
occupancy-grid render (whose kernel-path functions import the kernels when
they run)."""

from keras_nerf_tpu_torch.ops.encoding import (
    block_permutation,
    encode_position_and_directions,
    encoded_dim,
    positional_encoding,
    positional_encoding_block,
)
from keras_nerf_tpu_torch.ops.metrics import mse, psnr, ssim
from keras_nerf_tpu_torch.ops.occupancy import (
    DEFAULT_AABB,
    bake_occupancy_grid,
    dilate_occupancy,
    grid_coordinates,
    model_density_fn,
    occupancy_along_rays,
    probe_bin_mids,
    probe_rows_for_poses,
    render_image_batch_occ,
    sample_occupied,
)
from keras_nerf_tpu_torch.ops.rendering import RenderOutput, render_rays
from keras_nerf_tpu_torch.ops.sampling import (
    batched_searchsorted_right,
    invert_cdf,
    merge_sorted,
    midpoints,
    sample_pdf,
    sample_pdf_sorted,
    sorted_uniforms,
    stratified_sample_points,
)

__all__ = [
    "DEFAULT_AABB", "RenderOutput", "bake_occupancy_grid",
    "batched_searchsorted_right", "block_permutation", "dilate_occupancy",
    "encode_position_and_directions", "encoded_dim", "grid_coordinates",
    "invert_cdf", "merge_sorted", "midpoints", "model_density_fn", "mse",
    "occupancy_along_rays", "positional_encoding",
    "positional_encoding_block", "probe_bin_mids", "probe_rows_for_poses",
    "psnr", "render_image_batch_occ", "render_rays", "sample_occupied",
    "sample_pdf", "sample_pdf_sorted", "sorted_uniforms", "ssim",
    "stratified_sample_points",
]
