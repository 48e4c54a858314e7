"""Hand-written CUDA kernels for the H100 (``csrc/``), their wrappers and
their plain PyTorch versions."""

from keras_nerf_tpu_torch.kernels.ray_march import (
    KERNELS,
    apply_mlp,
    encode_block128,
    fused_mlp_backward,
    fused_point_forward,
    fused_render_chunk,
    fused_train_chunk,
    kernel_supported,
    mlp_backward,
    mlp_weight_grad,
    mma_ceiling,
    pack_mlp_params,
    point_render_chunk,
    ray_encoding_coeffs,
    ray_march_mlp,
    ray_march_mlp_int8,
    ray_march_quadrature,
    reset_launch_counts,
    sample_merge,
    unpack_grads,
    zero_grads,
)

__all__ = [
    "KERNELS", "apply_mlp", "encode_block128", "fused_mlp_backward",
    "fused_point_forward", "fused_render_chunk", "fused_train_chunk",
    "kernel_supported", "mlp_backward", "mlp_weight_grad", "mma_ceiling",
    "pack_mlp_params", "point_render_chunk", "ray_encoding_coeffs",
    "ray_march_mlp", "ray_march_mlp_int8", "ray_march_quadrature",
    "reset_launch_counts", "sample_merge",
    "unpack_grads", "zero_grads",
]
