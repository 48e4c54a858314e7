"""Checkpoints in the JAX package's format (``keras_nerf_tpu/utils/
checkpoint.py``), read and written.

A checkpoint directory holds ``model_config.json`` (the 7 reference keys),
``coarse.msgpack`` / ``fine.msgpack`` (flax's state-dict form of the
reference-layout parameter tree: lists become dicts keyed "0", "1", …,
serialized with msgpack, each array an ext type 1 holding ``(shape, dtype
name, raw bytes)``), and, from a training run, ``optimizer.msgpack`` (both
optimizer states in optax's layout and the step) and ``train_config.json``
(the training hyperparameters, for resume). Either package resumes the
other's run. Only the ``msgpack`` package is needed, imported when a file is
read or written.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from keras_nerf_tpu_torch.models.engine import (
    NeRFConfig,
    TrainState,
    tree_leaves,
)
from keras_nerf_tpu_torch.utils.convert import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
    state_dict_form,
)

COARSE_WEIGHTS = "coarse.msgpack"
FINE_WEIGHTS = "fine.msgpack"
OPTIMIZER_STATE = "optimizer.msgpack"
MODEL_CONFIG = "model_config.json"
TRAIN_CONFIG = "train_config.json"

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def load_model_config(path: str, **overrides) -> NeRFConfig:
    """``model_config.json`` -> :class:`NeRFConfig` (`nerf.py:66-76`)."""
    with open(os.path.join(path, MODEL_CONFIG)) as f:
        return NeRFConfig.from_model_config(json.load(f), **overrides)


def load_train_config(path: str) -> dict | None:
    """``train_config.json``, or None where the checkpoint has none."""
    p = os.path.join(path, TRAIN_CONFIG)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def warn_train_config_mismatch(path: str, current: dict) -> list[str]:
    """Warn once per training hyperparameter that differs from the one the
    checkpoint was written with; the current value stays in force. Returns
    the differing keys (`checkpoint.py:101-123`)."""
    saved = load_train_config(path)
    if saved is None:
        return []
    mismatched = [k for k, v in current.items() if k in saved
                  and saved[k] != v]
    for key in mismatched:
        logging.warning(
            "resume hyperparameter mismatch: %s was %r when the checkpoint "
            "in %s was written, but this run uses %r — continuing with %r",
            key, saved[key], path, current[key], current[key])
    return mismatched


def has_weights(path: str) -> bool:
    """Both weight files exist."""
    return (os.path.exists(os.path.join(path, COARSE_WEIGHTS))
            and os.path.exists(os.path.join(path, FINE_WEIGHTS)))


def maybe_import_reference(path: str) -> bool:
    """Where ``path`` holds a reference ``.h5`` artifact and no msgpack
    weights, convert it in place (:mod:`~keras_nerf_tpu_torch.utils.
    import_h5`; `checkpoint.py:133-150`). Returns True if it converted.
    Without ``h5py`` the conversion raises an error that names it."""
    if has_weights(path):
        return False
    from keras_nerf_tpu_torch.utils.import_h5 import (
        find_h5_pair, import_reference_model)

    if find_h5_pair(path) is None:
        return False
    logging.info("found reference .h5 checkpoint in %s; importing", path)
    import_reference_model(path)
    return True


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


def _ext_pack(x):
    import msgpack

    if isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
        code = _EXT_NDARRAY if isinstance(x, np.ndarray) else _EXT_NPSCALAR
        return msgpack.ExtType(code, msgpack.packb(
            (arr.shape, arr.dtype.name, arr.tobytes("C")),
            use_bin_type=True))
    raise TypeError(f"cannot serialize {type(x)}")


def write_msgpack_tree(file_path: str, tree) -> None:
    """A tree of numpy arrays -> one msgpack file as flax writes it."""
    import msgpack

    data = msgpack.packb(state_dict_form(tree), default=_ext_pack,
                         strict_types=True)
    with open(file_path, "wb") as f:
        f.write(data)


def load_params(path: str, device=None):
    """``(coarse, fine)`` reference-layout parameter trees of float32
    tensors on ``device`` (the card unless the caller says otherwise)."""
    return tuple(
        params_from_jax(read_msgpack_tree(os.path.join(path, name)), device)
        for name in (COARSE_WEIGHTS, FINE_WEIGHTS))


def load_weights(path: str, target_coarse, target_fine):
    """Both parameter trees from ``path``, refused unless each has its
    target's layout, as float32 tensors on the targets' device
    (`checkpoint.py:153-159`)."""
    device = tree_leaves(target_coarse)[0].device
    loaded = load_params(path, device)
    for name, got, want in zip(("coarse", "fine"), loaded,
                               (target_coarse, target_fine)):
        if not _same_layout(got, want):
            raise ValueError(f"{name} weights in {path} do not have the "
                             "target's layout")
    return loaded


def save_model(path: str, state: TrainState, config: NeRFConfig,
               weights_only: bool = False, include_optimizer: bool = True,
               train_config: dict | None = None) -> None:
    """Config, weights and optimizer state to ``path``
    (`checkpoint.py:50-83`). ``weights_only`` keeps an existing
    ``model_config.json`` (the periodic save, `callback.py:220-222`)."""
    os.makedirs(path, exist_ok=True)
    if not weights_only:
        with open(os.path.join(path, MODEL_CONFIG), "w") as f:
            json.dump(config.to_model_config(), f)
    if train_config is not None:
        with open(os.path.join(path, TRAIN_CONFIG), "w") as f:
            json.dump(train_config, f)
    write_msgpack_tree(os.path.join(path, COARSE_WEIGHTS),
                       params_to_jax(state.coarse_params))
    write_msgpack_tree(os.path.join(path, FINE_WEIGHTS),
                       params_to_jax(state.fine_params))
    if include_optimizer:
        write_msgpack_tree(os.path.join(path, OPTIMIZER_STATE), {
            "coarse": opt_state_to_jax(state.coarse_opt),
            "fine": opt_state_to_jax(state.fine_opt),
            "step": np.asarray(state.step, dtype=np.int32)})


def _same_layout(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_layout(a[k], b[k])
                                            for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_same_layout, a, b))
    if hasattr(a, "shape") and hasattr(b, "shape"):
        return tuple(a.shape) == tuple(b.shape)
    return type(a) is type(b)


def load_train_state(path: str, template: TrainState,
                     device=None) -> TrainState:
    """Weights, and the optimizer state where the checkpoint has one of
    the template's layout (another optimizer or schedule resumes with the
    template's fresh state, with a warning; `checkpoint.py:162-188`)."""
    coarse, fine = load_params(path, device)
    opt_c, opt_f, step = template.coarse_opt, template.fine_opt, template.step
    opt_path = os.path.join(path, OPTIMIZER_STATE)
    if os.path.exists(opt_path):
        saved = read_msgpack_tree(opt_path)
        loaded = [opt_state_from_jax(saved[k], device)
                  for k in ("coarse", "fine")]
        if all(_same_layout(a, b) for a, b in
               zip(loaded, (template.coarse_opt, template.fine_opt))):
            opt_c, opt_f = loaded
            step = int(np.asarray(saved["step"]))
        else:
            logging.warning(
                "optimizer state in %s does not match the compiled "
                "optimizer; resuming with fresh optimizer state", opt_path)
    return TrainState(coarse, fine, opt_c, opt_f, step)
