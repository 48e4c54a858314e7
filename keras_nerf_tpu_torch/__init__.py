"""keras_nerf_tpu_torch: the PyTorch / CUDA port of keras_nerf_tpu.

The JAX package ``keras_nerf_tpu`` is the reference; this package computes
the same functions in PyTorch, with the TPU's Pallas kernels rewritten as
CUDA kernels for the H100 (``kernels/``). It imports neither JAX nor any
module of the JAX package. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from keras_nerf_tpu_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
