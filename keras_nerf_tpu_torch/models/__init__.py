"""Models: the MLP, the engine (render, train and eval steps) and the NeRF
class."""

from keras_nerf_tpu_torch.models.engine import (
    NeRFConfig,
    Optimizer,
    TrainState,
    eval_step,
    exponential_lr,
    init_params,
    init_train_state,
    make_optimizer,
    mse_loss,
    render_chunk,
    render_chunk_pair,
    render_image_batch,
    resolve_use_kernels,
    train_step,
)
from keras_nerf_tpu_torch.models.mlp import (
    MLPConfig,
    apply_mlp,
    init_mlp,
    param_count,
)
from keras_nerf_tpu_torch.models.nerf import NeRF

__all__ = [
    "MLPConfig", "NeRF", "NeRFConfig", "Optimizer", "TrainState",
    "apply_mlp", "eval_step", "exponential_lr", "init_mlp", "init_params",
    "init_train_state", "make_optimizer", "mse_loss", "param_count",
    "render_chunk", "render_chunk_pair", "render_image_batch",
    "resolve_use_kernels", "train_step",
]
