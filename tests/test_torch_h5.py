"""The port's ``.h5`` interop (``keras_nerf_tpu_torch/utils/import_h5.py``,
``export_h5.py``, ``checkpoint.maybe_import_reference`` / ``load_weights``
and the two ``python -m`` converters) against the JAX package, on the CPU.

A legacy Keras-2 ``.h5`` pair is written here with ``h5py`` from
JAX-initialised weights, at 3 x 64 and 8 x 256. Every comparison is bit
for bit: the trees read, the msgpack checkpoint written (read back by
JAX's ``load_train_state``), export by one package and import by the
other, and the inference CLI's frames from an ``.h5`` directory against
the frames the port renders from JAX's converted checkpoint. A wrong
architecture is refused by name, a missing ``h5py`` raises an error that
names it, and the Keras-3 ``.weights.h5`` case runs through TensorFlow and
a stand-in for the reference's ``NeRFMLP`` (its layer names) where
TensorFlow imports.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import json
import os
import shutil
import sys
import types

import h5py
import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.utils import checkpoint as jckpt
from keras_nerf_tpu.utils import export_h5 as jexport
from keras_nerf_tpu.utils import import_h5 as jimport
from keras_nerf_tpu_torch import export_reference_h5, import_reference_h5
from keras_nerf_tpu_torch import inference
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.utils import checkpoint as tckpt
from keras_nerf_tpu_torch.utils import export_h5 as texport
from keras_nerf_tpu_torch.utils import import_h5 as timport

SHAPES = {"3x64": dict(n_layers=3, dense_units=64, skip_layer=2),
          "8x256": dict(n_layers=8, dense_units=256, skip_layer=4)}


def _jax_config(shape):
    return jengine.NeRFConfig(n_coarse=8, n_fine=8, **SHAPES[shape])


def _write_h5(path, params, n_layers):
    """The legacy Keras-2 ``save_weights`` layout, written with h5py alone:
    root ``layer_names``, a group a layer with its ``weight_names``."""
    names = [f"layer_{i}" for i in range(n_layers)] + [
        "sigma", "features", "rgb_features", "rgb"]
    layers = list(params["trunk"]) + [params[n] for n in names[n_layers:]]
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in names])
        for name, layer in zip(names, layers):
            g = f.create_group(name)
            wnames = [f"{name}/kernel:0", f"{name}/bias:0"]
            g.attrs["weight_names"] = np.array([w.encode() for w in wnames])
            g.create_dataset(wnames[0], data=np.asarray(layer["kernel"]))
            g.create_dataset(wnames[1], data=np.asarray(layer["bias"]))


def _artifact(root, shape, seed=0):
    """A reference artifact directory: ``model_config.json`` and the
    ``.h5`` pair of JAX-initialised weights; returns (dir, coarse, fine)."""
    cfg = _jax_config(shape)
    coarse, fine = (jax.tree.map(np.asarray, p) for p in
                    jengine.init_params(jax.random.PRNGKey(seed), cfg))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "model_config.json"), "w") as f:
        json.dump(cfg.to_model_config(), f)
    _write_h5(os.path.join(root, "coarse.h5"), coarse, cfg.n_layers)
    _write_h5(os.path.join(root, "fine.h5"), fine, cfg.n_layers)
    return str(root), coarse, fine


def _assert_trees_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_params_from_h5_equal_jax(tmp_path, shape):
    root, coarse, fine = _artifact(tmp_path / "ref", shape)
    jcfg = _jax_config(shape)
    tcfg = tengine.NeRFConfig(**jcfg.to_model_config())
    assert timport.find_h5_pair(root) == jimport.find_h5_pair(root)
    for name, want in (("coarse", coarse), ("fine", fine)):
        path = os.path.join(root, f"{name}.h5")
        assert timport.is_legacy_h5(path) and jimport.is_legacy_h5(path)
        got = timport.params_from_h5(path, tcfg)
        _assert_trees_equal(got, jimport.params_from_h5(path, jcfg))
        _assert_trees_equal(got, want)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_import_writes_msgpack_jax_loads(tmp_path, shape):
    """``import_reference_model`` (and its CLI) write a checkpoint JAX's
    ``load_train_state`` reads to the ``.h5`` weights, bit for bit; the
    port's ``load_weights`` reads it too."""
    root, coarse, fine = _artifact(tmp_path / "ref", shape)
    out = str(tmp_path / "out")
    import_reference_h5.main(["--model_dir", root, "--output_dir", out])
    jcfg = _jax_config(shape)
    with open(os.path.join(out, "model_config.json")) as f:
        assert json.load(f) == jcfg.to_model_config()
    opt = jengine.make_optimizer("adam", 1e-3)
    template = jengine.init_train_state(jax.random.PRNGKey(9), jcfg, opt)
    state = jckpt.load_train_state(out, template)
    _assert_trees_equal(state.coarse_params, coarse)
    _assert_trees_equal(state.fine_params, fine)
    tcfg = tengine.NeRFConfig(**jcfg.to_model_config())
    targets = tengine.init_params(torch.Generator().manual_seed(1), tcfg,
                                  "cpu")
    got = tckpt.load_weights(out, *targets)
    for g, want in zip(got, (coarse, fine)):
        _assert_trees_equal(jax.tree.map(lambda x: x.numpy(), g), want)
    wrong = tengine.init_params(torch.Generator().manual_seed(1),
                                tengine.NeRFConfig(n_layers=2), "cpu")
    with pytest.raises(ValueError, match="coarse weights .* layout"):
        tckpt.load_weights(out, *wrong)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_export_and_import_across_packages(tmp_path, shape):
    """Port export -> JAX import and JAX export -> port import, each equal
    to the checkpoint it came from, bit for bit."""
    root, coarse, fine = _artifact(tmp_path / "ref", shape)
    ckpt = str(tmp_path / "ckpt")
    jimport.import_reference_model(root, ckpt)

    port_h5 = str(tmp_path / "port_h5")
    export_reference_h5.main(["--model_dir", ckpt, "--output_dir", port_h5])
    back = str(tmp_path / "port_then_jax")
    jimport.import_reference_model(port_h5, back)

    jax_h5 = str(tmp_path / "jax_h5")
    jexport.export_reference_model(ckpt, jax_h5)
    forth = str(tmp_path / "jax_then_port")
    timport.import_reference_model(jax_h5, forth)

    for out in (back, forth):
        for name, want in ((jckpt.COARSE_WEIGHTS, coarse),
                           (jckpt.FINE_WEIGHTS, fine)):
            _assert_trees_equal(
                tckpt.read_msgpack_tree(os.path.join(out, name)), want)
    for name in ("coarse.h5", "fine.h5"):
        cfg = _jax_config(shape)
        _assert_trees_equal(
            jimport.params_from_h5(os.path.join(port_h5, name), cfg),
            jimport.params_from_h5(os.path.join(jax_h5, name), cfg))


@pytest.mark.parametrize("change, match", [
    (dict(n_layers=4), r"missing layers: \['layer_3'\]"),
    (dict(dense_units=32), r"layer 'layer_0': kernel \(63, 64\)"),
])
def test_wrong_architecture_refused_by_name(tmp_path, change, match):
    """A ``model_config.json`` that is not the ``.h5`` files' architecture:
    both packages refuse it with the same message, naming the layer."""
    root, _, _ = _artifact(tmp_path / "ref", "3x64")
    cfg = {**_jax_config("3x64").to_model_config(), **change}
    with open(os.path.join(root, "model_config.json"), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match=match) as mine:
        timport.import_reference_model(root, str(tmp_path / "a"))
    with pytest.raises(ValueError, match=match) as theirs:
        jimport.import_reference_model(root, str(tmp_path / "b"))
    assert str(mine.value) == str(theirs.value)
    ckpt = str(tmp_path / "ckpt")
    _artifact(tmp_path / "ok", "3x64")
    jimport.import_reference_model(str(tmp_path / "ok"), ckpt)
    with open(os.path.join(ckpt, "model_config.json"), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match=match):
        texport.export_reference_model(ckpt, str(tmp_path / "c"))


def test_missing_h5py_raises_naming_it(tmp_path, monkeypatch):
    root, _, _ = _artifact(tmp_path / "ref", "3x64")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="'h5py'"):
        tckpt.maybe_import_reference(root)
    with pytest.raises(ImportError, match="'h5py'"):
        inference.main(["--model_dirs", root, "--device", "cpu"])
    assert not tckpt.has_weights(root)
    # A directory with msgpack weights, or without an .h5 pair, needs none.
    assert not tckpt.maybe_import_reference(str(tmp_path))


def _gif_frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in
                ImageSequence.Iterator(im)]


def test_inference_cli_converts_h5_in_place_and_renders_jax_frame(
        tmp_path):
    """``python -m keras_nerf_tpu_torch.inference --device cpu`` on a
    directory holding only the ``.h5`` artifact (16^2, 3 x 64): converts it
    in place, and its frames (image and depth GIFs) are the port's frames
    from JAX's conversion of the same artifact, 0 max abs error."""
    root, coarse, fine = _artifact(tmp_path / "ref", "3x64", seed=3)
    converted = str(tmp_path / "jax_converted")
    jimport.import_reference_model(root, converted)
    flags = ["--img_wh", "16", "--output_freq", "180", "--ray_chunks", "256",
             "--white_bg", "--device", "cpu", "--name", "orbit"]
    inference.main(["--model_dirs", root, "--output_dir",
                    str(tmp_path / "a"), *flags])
    assert tckpt.has_weights(root)
    for name in (jckpt.COARSE_WEIGHTS, jckpt.FINE_WEIGHTS):
        _assert_trees_equal(tckpt.read_msgpack_tree(os.path.join(root, name)),
                            tckpt.read_msgpack_tree(
                                os.path.join(converted, name)))
    inference.main(["--model_dirs", converted, "--output_dir",
                    str(tmp_path / "b"), *flags])
    for gif in ("orbit.gif", "orbit_depth.gif"):
        got, want = (_gif_frames(tmp_path / d / gif) for d in "ab")
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            err = np.abs(g.astype(np.int16) - w.astype(np.int16)).max()
            print(f"\n{gif}: max abs error {err} (budget 0)")
            assert err == 0


def _stand_in_reference(tf):
    """A module ``keras_nerf.model.nerf.mlp`` whose ``NeRFMLP`` has the
    reference's Dense layer names and call (`mlp.py:11-27`), for the
    Keras-3 path, which builds the reference model by that name."""

    class NeRFMLP(tf.keras.Model):
        def __init__(self, n_layers, dense_units, skip_layer):
            super().__init__()
            self.skip = skip_layer
            self.trunk = [tf.keras.layers.Dense(
                dense_units, activation="relu", name=f"layer_{i}")
                for i in range(n_layers)]
            self.sigma = tf.keras.layers.Dense(1, activation="relu",
                                               name="sigma")
            self.features = tf.keras.layers.Dense(dense_units,
                                                  name="features")
            self.rgb_features = tf.keras.layers.Dense(
                dense_units // 2, name="rgb_features")
            self.rgb = tf.keras.layers.Dense(3, activation="sigmoid",
                                             name="rgb")

        def call(self, inputs):
            xyz, direction = inputs
            x = xyz
            for i, layer in enumerate(self.trunk):
                x = layer(x)
                if i % self.skip == 0 and i > 0:
                    x = tf.concat([x, xyz], axis=-1)
            sigma = self.sigma(x)
            x = tf.concat([self.features(x), direction], axis=-1)
            return self.rgb(self.rgb_features(x)), sigma

    module = types.ModuleType("keras_nerf.model.nerf.mlp")
    module.NeRFMLP = NeRFMLP
    return module


def test_keras3_weights_file_through_tensorflow(tmp_path, monkeypatch):
    """Where TensorFlow imports: a Keras-3 ``.weights.h5`` pair (no layer
    names in the file) converts through the reference model in both
    packages to the same trees, bit for bit, equal to the model's own
    weights by layer name."""
    tf = pytest.importorskip("tensorflow")
    ref = _stand_in_reference(tf)
    for name in ("keras_nerf", "keras_nerf.model", "keras_nerf.model.nerf"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "keras_nerf.model.nerf.mlp", ref)
    jcfg = _jax_config("3x64")
    tcfg = tengine.NeRFConfig(**jcfg.to_model_config())
    tf.keras.utils.set_random_seed(7)
    root = tmp_path / "k3"
    root.mkdir()
    with open(root / "model_config.json", "w") as f:
        json.dump(jcfg.to_model_config(), f)
    models = {}
    for name in ("coarse", "fine"):
        model = ref.NeRFMLP(jcfg.n_layers, jcfg.dense_units, jcfg.skip_layer)
        model([tf.zeros((1, 1, jcfg.in_xyz)), tf.zeros((1, 1, jcfg.in_dir))])
        model.save_weights(str(root / f"{name}.weights.h5"))
        models[name] = model
    path = str(root / "coarse.weights.h5")
    assert not timport.is_legacy_h5(path)
    got = timport.params_from_h5(path, tcfg)
    _assert_trees_equal(got, jimport.params_from_h5(path, jcfg))
    _assert_trees_equal(got, timport.params_from_keras_model(
        models["coarse"], tcfg.mlp, tcfg.in_xyz, tcfg.in_dir))
    out = str(tmp_path / "out")
    timport.import_reference_model(str(root), out)
    _assert_trees_equal(
        tckpt.read_msgpack_tree(os.path.join(out, jckpt.FINE_WEIGHTS)),
        jimport.params_from_keras_model(models["fine"], jcfg.mlp,
                                        jcfg.in_xyz, jcfg.in_dir))
    shutil.rmtree(out)
