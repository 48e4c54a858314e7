"""Checkpoints and GIFs of the port against the JAX package.

The port's msgpack files (``keras_nerf_tpu_torch/utils/checkpoint.py``)
read back with flax's deserializer, leaf for leaf, on the trees flax
writes: a parameter tree, an Adam state with its int count, nested empty
dicts; the port rewrites a file the JAX package wrote byte for byte (the
two packages resume each other's runs in ``test_torch_train.py``). The
GIF writer's files read back with PIL.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.utils import checkpoint as jckpt
from keras_nerf_tpu_torch.inference import gif_frames, write_gifs
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.utils import checkpoint as tckpt
from keras_nerf_tpu_torch.utils.convert import (
    opt_state_to_jax,
    state_dict_form,
)

CFG = jengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=3, dense_units=256,
                         skip_layer=2)


def _params_tree():
    pc, _ = jengine.init_params(jax.random.PRNGKey(0), CFG)
    return jax.tree.map(np.asarray, pc)


def _adam_tree():
    cfg = tengine.NeRFConfig(**CFG.to_model_config())
    opt = tengine.make_optimizer(
        "adam", tengine.exponential_lr(1e-3, 1e-5, 100))
    state = tengine.init_train_state(torch.Generator().manual_seed(0), cfg,
                                     opt, device="cpu")
    state = state._replace(coarse_opt={**state.coarse_opt, "count": 7,
                                       "schedule_count": 7})
    return {"coarse": opt_state_to_jax(state.coarse_opt),
            "fine": opt_state_to_jax(state.fine_opt),
            "step": np.asarray(7, dtype=np.int32)}


TREES = {
    "params": _params_tree,
    "adam_state": _adam_tree,
    "nested_empty": lambda: {"0": {}, "1": {"a": {}, "b": {"c": {}}},
                             "w": np.arange(6, dtype=np.float32)
                             .reshape(2, 3),
                             "n": np.float32(1.5), "i": np.int64(-3)},
}


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(TREES))
def test_written_files_read_back_with_flax(name, tmp_path):
    """What ``write_msgpack_tree`` writes, flax's ``msgpack_restore`` reads
    as the same tree, dtypes and empty dicts included; the port reading it
    back and writing again gives the same file."""
    tree = TREES[name]()
    path = str(tmp_path / "tree.msgpack")
    tckpt.write_msgpack_tree(path, tree)
    with open(path, "rb") as f:
        got = f.read()
    _assert_same_tree(state_dict_form(tree),
                      serialization.msgpack_restore(got))
    again = str(tmp_path / "again.msgpack")
    tckpt.write_msgpack_tree(again, tckpt.read_msgpack_tree(path))
    with open(again, "rb") as f:
        assert f.read() == got


def test_port_reads_what_the_jax_package_writes(tmp_path):
    state = jengine.init_train_state(jax.random.PRNGKey(4), CFG,
                                     jengine.make_optimizer("adam"))
    jckpt.save_model(str(tmp_path), state, CFG)
    coarse = tckpt.read_msgpack_tree(str(tmp_path / tckpt.COARSE_WEIGHTS))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray,
                                                 state.coarse_params)),
                    jax.tree.leaves(coarse)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    opt = tckpt.read_msgpack_tree(str(tmp_path / tckpt.OPTIMIZER_STATE))
    assert int(np.asarray(opt["step"])) == 0
    assert int(np.asarray(opt["coarse"][0]["count"])) == 0
    # What the port writes back is the same file, byte for byte.
    fine = str(tmp_path / tckpt.FINE_WEIGHTS)
    with open(fine, "rb") as f:
        data = f.read()
    back = str(tmp_path / "back.msgpack")
    tckpt.write_msgpack_tree(back, tckpt.read_msgpack_tree(fine))
    with open(back, "rb") as f:
        assert f.read() == data


def test_gif_writer_reads_back_with_pil(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(3, 12, 10, 3)).astype(np.float32)
    depths = rng.uniform(2, 6, size=(3, 12, 10)).astype(np.float32)
    frames, depth_frames = gif_frames(images, depths)
    path = write_gifs(frames, depth_frames, str(tmp_path), "orbit")
    for name in ("orbit.gif", "orbit_depth.gif"):
        with Image.open(tmp_path / name) as gif:
            assert gif.format == "GIF" and gif.size == (10, 12)
            assert gif.n_frames == 3
            for i in range(3):
                gif.seek(i)
                assert gif.info["duration"] == 50
            assert gif.info.get("loop") == 0
    assert path == str(tmp_path / "orbit.gif")
