"""Export checkpoints to the reference's Keras ``.h5`` artifact (port of
``keras_nerf_tpu/utils/export_h5.py``).

The inverse of :mod:`keras_nerf_tpu_torch.utils.import_h5`: a msgpack
checkpoint directory becomes the layout the reference's ``NeRF.load_model``
reads, ``model_config.json`` + ``coarse.h5`` + ``fine.h5``
(`keras_nerf/model/nerf/nerf.py:45-76`), so a model trained by the port
loads back into the TF implementation. The weight files take the legacy
Keras-2 ``save_weights`` layout (root attr ``layer_names``; a group per
layer whose ``weight_names`` attr points at ``<name>/kernel:0`` and
``<name>/bias:0``), which TF 2.9's ``load_weights`` expects. Needs
``h5py`` alone.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from keras_nerf_tpu_torch.models.engine import NeRFConfig
from keras_nerf_tpu_torch.utils.import_h5 import _assemble, _h5py

Params = dict[str, Any]


def _layer_items(params: Params, n_layers: int):
    """``(layer_name, kernel, bias)`` in the reference's layer order
    (`keras_nerf/model/nerf/mlp.py:11-27`)."""
    for i in range(n_layers):
        layer = params["trunk"][i]
        yield f"layer_{i}", layer["kernel"], layer["bias"]
    for name in ("sigma", "features", "rgb_features", "rgb"):
        yield name, params[name]["kernel"], params[name]["bias"]


def write_legacy_h5(path: str, params: Params, n_layers: int) -> None:
    """One MLP's tree (numpy arrays) as a legacy Keras-2 weights file."""
    names = [name for name, _, _ in _layer_items(params, n_layers)]
    with _h5py().File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [n.encode() for n in names], dtype="S64")
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.9.0"
        for name, kernel, bias in _layer_items(params, n_layers):
            g = f.create_group(name)
            wnames = [f"{name}/kernel:0", f"{name}/bias:0"]
            g.attrs["weight_names"] = np.array(
                [w.encode() for w in wnames], dtype="S96")
            g.create_dataset(wnames[0],
                             data=np.asarray(kernel, dtype=np.float32))
            g.create_dataset(wnames[1],
                             data=np.asarray(bias, dtype=np.float32))


def export_reference_model(model_dir: str, out_dir: str | None = None
                           ) -> NeRFConfig:
    """Convert the msgpack checkpoint in ``model_dir`` into the reference's
    ``model_config.json`` + ``coarse.h5`` + ``fine.h5``, written to
    ``out_dir`` (by default ``model_dir``, beside the originals). Each
    tree is checked against the architecture first. Returns the config."""
    from keras_nerf_tpu_torch.utils import checkpoint

    config = checkpoint.load_model_config(model_dir)
    trees = []
    for name in (checkpoint.COARSE_WEIGHTS, checkpoint.FINE_WEIGHTS):
        tree = checkpoint.read_msgpack_tree(os.path.join(model_dir, name))
        named = _layer_items(tree, len(tree["trunk"]))
        trees.append(_assemble({n: (k, b) for n, k, b in named},
                               config.mlp, config.in_xyz, config.in_dir))

    out_dir = out_dir or model_dir
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, checkpoint.MODEL_CONFIG), "w") as f:
        json.dump(config.to_model_config(), f)
    for stem, tree in zip(("coarse", "fine"), trees):
        write_legacy_h5(os.path.join(out_dir, f"{stem}.h5"), tree,
                        config.n_layers)
    return config
