"""Pure tensor ops: encoding, quadrature, sampling, image metrics."""

from keras_nerf_tpu_torch.ops.encoding import (
    block_permutation,
    encode_position_and_directions,
    encoded_dim,
    positional_encoding,
    positional_encoding_block,
)
from keras_nerf_tpu_torch.ops.metrics import mse, psnr, ssim
from keras_nerf_tpu_torch.ops.rendering import RenderOutput, render_rays
from keras_nerf_tpu_torch.ops.sampling import (
    invert_cdf,
    merge_sorted,
    midpoints,
    sample_pdf_sorted,
    sorted_uniforms,
    stratified_sample_points,
)

__all__ = [
    "RenderOutput", "block_permutation", "encode_position_and_directions",
    "encoded_dim", "invert_cdf", "merge_sorted", "midpoints", "mse",
    "positional_encoding", "positional_encoding_block", "psnr",
    "render_rays", "sample_pdf_sorted", "sorted_uniforms", "ssim",
    "stratified_sample_points",
]
