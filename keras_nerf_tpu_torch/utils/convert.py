"""Parameter interchange with the JAX package, as numpy trees.

``params_from_jax`` takes a reference-layout parameter tree whose leaves
are numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side, or a
checkpoint read by ``utils/checkpoint.py``) and returns the same tree of
float32 torch tensors; ``params_to_jax`` is its inverse. Both packages then
compute the same function from the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    """Nested dicts/lists of numpy arrays -> the same nesting of float32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def params_to_jax(tree):
    """Inverse of :func:`params_from_jax`: tensors -> float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy()
