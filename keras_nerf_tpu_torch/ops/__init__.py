"""Pure tensor ops: encoding, quadrature, sampling."""

from keras_nerf_tpu_torch.ops.encoding import (
    block_permutation,
    encode_position_and_directions,
    encoded_dim,
    positional_encoding,
    positional_encoding_block,
)
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
    "encoded_dim", "invert_cdf", "merge_sorted", "midpoints",
    "positional_encoding", "positional_encoding_block", "render_rays",
    "sample_pdf_sorted", "sorted_uniforms", "stratified_sample_points",
]
