"""Read the JAX package's checkpoints (``keras_nerf_tpu/utils/checkpoint.py``).

A checkpoint directory holds ``model_config.json`` (the 7 reference keys)
and ``coarse.msgpack`` / ``fine.msgpack``: flax's state-dict form of the
reference-layout parameter tree (lists become dicts keyed "0", "1", …)
serialized with msgpack, each array an ext type 1 holding
``(shape, dtype name, raw bytes)``. This reader needs only the ``msgpack``
package, imported when a checkpoint is read.
"""

from __future__ import annotations

import json
import os

import numpy as np

from keras_nerf_tpu_torch.models.engine import NeRFConfig
from keras_nerf_tpu_torch.utils.convert import params_from_jax

COARSE_WEIGHTS = "coarse.msgpack"
FINE_WEIGHTS = "fine.msgpack"
MODEL_CONFIG = "model_config.json"

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def load_model_config(path: str, **overrides) -> NeRFConfig:
    """``model_config.json`` -> :class:`NeRFConfig` (`nerf.py:66-76`)."""
    with open(os.path.join(path, MODEL_CONFIG)) as f:
        return NeRFConfig.from_model_config(json.load(f), **overrides)


def has_weights(path: str) -> bool:
    """Both weight files exist."""
    return (os.path.exists(os.path.join(path, COARSE_WEIGHTS))
            and os.path.exists(os.path.join(path, FINE_WEIGHTS)))


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(
            shape)
        return arr[()] if code == _EXT_NPSCALAR else arr
    return msgpack.ExtType(code, data)


def _lists_from_state_dict(tree):
    """flax stores lists as dicts keyed "0".."n-1"; turn them back."""
    if isinstance(tree, dict):
        tree = {k: _lists_from_state_dict(v) for k, v in tree.items()}
        if tree and all(k.isdigit() for k in tree):
            return [tree[str(i)] for i in range(len(tree))]
    return tree


def read_msgpack_tree(file_path: str):
    """One flax-serialized msgpack file -> a tree of numpy arrays."""
    import msgpack

    with open(file_path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _lists_from_state_dict(tree)


def load_params(path: str, device="cuda"):
    """``(coarse, fine)`` reference-layout parameter trees of float32
    tensors on ``device``."""
    return tuple(
        params_from_jax(read_msgpack_tree(os.path.join(path, name)), device)
        for name in (COARSE_WEIGHTS, FINE_WEIGHTS))
