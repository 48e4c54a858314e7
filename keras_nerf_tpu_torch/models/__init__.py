"""Models: the MLP, the render engine and the NeRF class."""

from keras_nerf_tpu_torch.models.engine import (
    NeRFConfig,
    render_chunk,
    render_chunk_pair,
    render_image_batch,
    resolve_use_kernels,
)
from keras_nerf_tpu_torch.models.mlp import MLPConfig, apply_mlp, init_mlp
from keras_nerf_tpu_torch.models.nerf import NeRF

__all__ = [
    "MLPConfig", "NeRF", "NeRFConfig", "apply_mlp", "init_mlp",
    "render_chunk", "render_chunk_pair", "render_image_batch",
    "resolve_use_kernels",
]
