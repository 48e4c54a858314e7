"""Import reference-trained Keras ``.h5`` checkpoints (port of
``keras_nerf_tpu/utils/import_h5.py``).

The reference's trained artifact is a directory of ``model_config.json`` +
``coarse.h5`` + ``fine.h5`` (`keras_nerf/model/nerf/nerf.py:45-64`, weight
files from Keras ``save_weights``). This module reads those files into
reference-layout parameter trees of float32 numpy arrays (the interchange
form of :mod:`keras_nerf_tpu_torch.utils.convert`) and, through
:func:`import_reference_model`, writes the msgpack checkpoint both
packages load.

Two HDF5 layouts exist:

* **legacy Keras 2** (what the reference, written for TF 2.9, produces):
  root attr ``layer_names``; a group per Dense layer, named as the
  reference names them (``layer_{i}``, ``sigma``, ``features``,
  ``rgb_features``, ``rgb``, `mlp.py:11-27`), whose ``weight_names`` attr
  points at its ``<name>/kernel:0`` and ``<name>/bias:0`` datasets. Read
  with ``h5py`` alone.
* **Keras 3** (``.weights.h5``): keyed by structure, without the layer
  names. Loaded into a live reference model (TensorFlow and the reference
  ``keras_nerf`` package) and read by layer name
  (:func:`params_from_keras_model`).

``h5py`` and TensorFlow are imported when a file is read; a missing one
raises an error that names it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np

from keras_nerf_tpu_torch.models.engine import NeRFConfig
from keras_nerf_tpu_torch.models.mlp import MLPConfig

Params = dict[str, Any]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading or writing a Keras .h5 checkpoint needs the 'h5py' "
            f"package, which is not installed ({e}); convert the model on "
            "a machine that has h5py and copy the msgpack checkpoint "
            "over") from e
    return h5py


def _expected_shapes(config: MLPConfig, in_xyz: int, in_dir: int) -> dict:
    """Layer name -> the kernel shape the architecture expects."""
    skip = set(config.skip_indices())
    u = config.dense_units
    shapes = {}
    width = in_xyz
    for i in range(config.n_layers):
        shapes[f"layer_{i}"] = (width, u)
        width = u + (in_xyz if i in skip else 0)
    shapes["sigma"] = (width, 1)
    shapes["features"] = (width, u)
    shapes["rgb_features"] = (u + in_dir, u // 2)
    shapes["rgb"] = (u // 2, 3)
    return shapes


def _assemble(weights: dict[str, tuple[np.ndarray, np.ndarray]],
              config: MLPConfig, in_xyz: int, in_dir: int) -> Params:
    """``{layer_name: (kernel, bias)}`` -> the reference-layout tree,
    refused by layer name where a layer is missing or its shape is not the
    architecture's."""
    expected = _expected_shapes(config, in_xyz, in_dir)
    missing = sorted(set(expected) - set(weights))
    if missing:
        raise ValueError(f"h5 checkpoint is missing layers: {missing}")
    for name, shape in expected.items():
        kernel, bias = weights[name]
        if tuple(kernel.shape) != shape or bias.shape != (shape[1],):
            raise ValueError(
                f"layer '{name}': kernel {tuple(kernel.shape)} / bias "
                f"{tuple(bias.shape)} do not match the architecture's "
                f"{shape} (check model_config.json)")

    def dense(name):
        kernel, bias = weights[name]
        return {"kernel": np.asarray(kernel, np.float32),
                "bias": np.asarray(bias, np.float32)}

    return {
        "trunk": [dense(f"layer_{i}") for i in range(config.n_layers)],
        "sigma": dense("sigma"),
        "features": dense("features"),
        "rgb_features": dense("rgb_features"),
        "rgb": dense("rgb"),
    }


def _decode(name) -> str:
    return name.decode() if isinstance(name, bytes) else str(name)


def is_legacy_h5(path: str) -> bool:
    """True if ``path`` is a legacy Keras-2 weights file (by layer name)."""
    with _h5py().File(path, "r") as f:
        return "layer_names" in f.attrs


def params_from_legacy_h5(path: str, config: MLPConfig, in_xyz: int,
                          in_dir: int) -> Params:
    """One MLP's tree from a legacy Keras-2 ``save_weights`` file: the root
    ``layer_names`` attr lists the layers, each group's ``weight_names``
    its datasets (`hdf5_format.save_weights_to_hdf5_group`)."""
    weights: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    with _h5py().File(path, "r") as f:
        if "layer_names" not in f.attrs:
            raise ValueError(
                f"{path} is not a legacy Keras-2 weights file (no "
                "'layer_names' attr); for Keras-3 .weights.h5 files load "
                "them through the reference model and use "
                "params_from_keras_model")
        for raw in f.attrs["layer_names"]:
            name = _decode(raw)
            group = f[name]
            kernel = bias = None
            for wraw in group.attrs.get("weight_names", []):
                wname = _decode(wraw)
                arr = np.asarray(group[wname])
                leaf = wname.rsplit("/", 1)[-1]
                if leaf.startswith("kernel"):
                    kernel = arr
                elif leaf.startswith("bias"):
                    bias = arr
            if kernel is not None and bias is not None:
                weights[name] = (kernel, bias)
    return _assemble(weights, config, in_xyz, in_dir)


def params_from_keras_model(model, config: MLPConfig, in_xyz: int,
                            in_dir: int) -> Params:
    """One MLP's tree from a live reference ``NeRFMLP`` (any Keras
    version), by layer name."""
    weights = {}
    for layer in model.layers:
        vals = layer.get_weights()
        if len(vals) == 2:
            weights[layer.name] = (vals[0], vals[1])
    return _assemble(weights, config, in_xyz, in_dir)


def _load_via_reference_model(path: str, config: NeRFConfig) -> Params:
    """A Keras-3 file: build the reference ``NeRFMLP``, ``load_weights``
    and read it by layer name. Needs TensorFlow and the reference
    package."""
    try:
        import tensorflow as tf
        from keras_nerf.model.nerf.mlp import NeRFMLP
    except ImportError as e:
        raise ImportError(
            f"{path} is a Keras-3 weights file; importing it requires "
            "TensorFlow and the reference 'keras_nerf' package on "
            f"sys.path ({e})") from e

    model = NeRFMLP(n_layers=config.n_layers, dense_units=config.dense_units,
                    skip_layer=config.skip_layer)
    # The variables take the reference's build shapes (`nerf.py:116-130`;
    # only the last dimensions matter).
    model([tf.zeros((1, 1, config.in_xyz)), tf.zeros((1, 1, config.in_dir))])
    model.load_weights(path)
    return params_from_keras_model(model, config.mlp, config.in_xyz,
                                   config.in_dir)


def params_from_h5(path: str, config: NeRFConfig) -> Params:
    """One MLP's tree from an ``.h5`` weights file of either layout."""
    if is_legacy_h5(path):
        return params_from_legacy_h5(path, config.mlp, config.in_xyz,
                                     config.in_dir)
    return _load_via_reference_model(path, config)


def find_h5_pair(model_dir: str) -> tuple[str, str] | None:
    """The reference artifact's weight files in ``model_dir``, if there:
    ``coarse.h5``/``fine.h5`` (`nerf.py:63-64`), or Keras 3's
    ``coarse.weights.h5``/``fine.weights.h5``."""
    for suffix in (".h5", ".weights.h5"):
        c = os.path.join(model_dir, "coarse" + suffix)
        f = os.path.join(model_dir, "fine" + suffix)
        if os.path.exists(c) and os.path.exists(f):
            return c, f
    return None


def import_reference_model(model_dir: str, out_dir: str | None = None
                           ) -> NeRFConfig:
    """Convert a reference artifact directory (``model_config.json``, the
    7-key contract of `nerf.py:47-55`, and the ``.h5`` pair) into the
    msgpack checkpoint, written to ``out_dir`` (by default ``model_dir``,
    beside the originals). Returns the parsed config."""
    from keras_nerf_tpu_torch.utils import checkpoint

    config_path = os.path.join(model_dir, checkpoint.MODEL_CONFIG)
    with open(config_path) as f:
        config = NeRFConfig.from_model_config(json.load(f))
    pair = find_h5_pair(model_dir)
    if pair is None:
        raise FileNotFoundError(
            f"no coarse/fine .h5 weight files found in {model_dir}")
    coarse = params_from_h5(pair[0], config)
    fine = params_from_h5(pair[1], config)

    out_dir = out_dir or model_dir
    os.makedirs(out_dir, exist_ok=True)
    out_config = os.path.join(out_dir, checkpoint.MODEL_CONFIG)
    if os.path.abspath(out_config) != os.path.abspath(config_path):
        shutil.copyfile(config_path, out_config)
    checkpoint.write_msgpack_tree(
        os.path.join(out_dir, checkpoint.COARSE_WEIGHTS), coarse)
    checkpoint.write_msgpack_tree(
        os.path.join(out_dir, checkpoint.FINE_WEIGHTS), fine)
    return config
