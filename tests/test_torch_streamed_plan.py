"""The envelope and the streamed routes of the MLP kernels, on the CPU
(ROADMAP C12).

The port's kernels take every width and depth that the JAX package's
kernels take (`keras_nerf_tpu/kernels/ray_march.py:98-104`): ``dense_units``
a multiple of 256 and any number of layers. Past the resident kernels'
widths and 16 layers the plans route a model to the streamed kernels,
which read the weights' tensor maps and pointers from a device table built
once per packed state (``csrc/mlp.cuh``: ``MlpTable``;
``csrc/ray_march_mlp_int8.cu``: ``I8Table``). Here: the envelope against
JAX's, ``pack_mlp_params`` at wide and deep shapes, the tables' layouts
against the sources, and ``mlp_weight_grad``'s split of a call with more
than 40 tasks or 256 tiles into launches, which must leave every sum as a
single launch would make it, bit for bit.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from keras_nerf_tpu.kernels import ray_march as jrm
from keras_nerf_tpu.models import mlp as jmlp
from keras_nerf_tpu_torch.kernels import quantize as tq
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRFConfig, init_mlp
from keras_nerf_tpu_torch.models.mlp import MLPConfig

CSRC = Path(trm.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("n_layers", [1, 8, 16, 17, 40])
@pytest.mark.parametrize("units", range(128, 4096 + 1, 128))
def test_kernel_supported_is_the_jax_packages(units, n_layers):
    cfg_j = jmlp.MLPConfig(n_layers=n_layers, dense_units=units,
                           skip_layer=4)
    cfg_t = MLPConfig(n_layers=n_layers, dense_units=units, skip_layer=4)
    for lx, ld in ((10, 4), (10, 10), (11, 4)):
        assert trm.kernel_supported(cfg_t, lx, ld) == \
            jrm.kernel_supported(cfg_j, lx, ld), (lx, ld)


def _packed(units, n_layers, skip, seed=0):
    cfg = NeRFConfig(n_layers=n_layers, dense_units=units, skip_layer=skip)
    params = init_mlp(torch.Generator().manual_seed(seed), cfg.mlp,
                      cfg.in_xyz, cfg.in_dir)
    return cfg, trm.pack_mlp_params(params, cfg.mlp, 10, 4)


@pytest.mark.parametrize("units,n_layers,skip", [
    (1024, 3, 1), (2048, 2, 1), (256, 17, 4), (256, 40, 4)])
def test_pack_mlp_params_and_the_plans_take_every_width_and_depth(
        units, n_layers, skip):
    cfg, packed = _packed(units, n_layers, skip)
    assert len(packed["trunk_w"]) == n_layers
    assert packed["w_sf"].shape == (units, units + trm.LANE)
    for plan in (trm.ray_march_mlp_plan, trm.mlp_backward_plan):
        assert plan(units, n_layers)["route"] == "streamed"
    # The resident int8 kernel holds its code tiles up to u = 1280.
    assert trm.ray_march_mlp_int8_plan(units, n_layers)["route"] == (
        "resident" if units <= 1280 and n_layers <= 16 else "streamed")


def _source_int(path, name):
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m is not None, name
    return int(m.group(1))


@pytest.mark.parametrize("n_layers", [1, 16, 17, 40])
def test_mlp_table_layout_is_the_sources(n_layers):
    """``MlpTable`` (``csrc/mlp.cuh:table_of``): 2 n + 5 maps of 128 bytes,
    then n biases, n encoding-weight pointers, the 8 heads; every map
    64-byte aligned (TMA reads a map in device memory only so), the
    pointers 8-byte aligned, nothing overlapping; and the entries of a
    packed state at those offsets."""
    n = n_layers
    lay = trm.mlp_table_layout(n)
    assert _source_int(CSRC / "mlp.cuh", "kTableHeadMaps") == \
        trm.TABLE_HEAD_MAPS == len(trm.MLP_HEAD_MAPS) == 5
    assert (lay["trunk"], lay["trunk_enc"], lay["head_maps"]) == (
        0, 128 * n, 256 * n)
    maps_end = 128 * (2 * n + 5)
    assert lay["trunk_b"] == maps_end and maps_end % 64 == 0
    assert lay["trunk_enc_w"] == maps_end + 8 * n
    assert lay["heads"] == maps_end + 16 * n
    assert lay["bytes"] == lay["heads"] + 8 * len(trm.MLP_HEAD_ARRAYS)
    _, packed = _packed(256, n, 4)
    maps, pointers = trm.mlp_table_entries(packed)
    assert 128 * len(maps) == maps_end
    assert 128 * len(maps) + 8 * len(pointers) == lay["bytes"]
    for i in range(n):
        assert maps[i][0] is packed["trunk_w"][i]
        assert maps[n + i][0] is packed["trunk_enc_w"][i]
        assert pointers[i] is packed["trunk_b"][i]
        assert pointers[n + i] is packed["trunk_enc_w"][i]
    for j, name in enumerate(trm.MLP_HEAD_MAPS):
        assert maps[2 * n + j][0] is packed[name]
    for j, name in enumerate(trm.MLP_HEAD_ARRAYS):
        assert pointers[2 * n + j] is packed[name]
    skips = {i + 1 for i in MLPConfig(n_layers=n, skip_layer=4)
             .skip_indices() if i + 1 < n}
    assert {i for i in range(n) if maps[n + i][0] is not None} == skips


@pytest.mark.parametrize("n_layers", [1, 16, 17, 40])
def test_mlp_int8_table_layout_is_the_sources(n_layers):
    """``I8Table`` (``csrc/ray_march_mlp_int8.cu``): 2 n + 4 maps, then six
    per-layer pointer arrays and the 22 head arrays (the transposed int8
    weights where the kernel reads a weight)."""
    n = n_layers
    src = CSRC / "ray_march_mlp_int8.cu"
    assert _source_int(src, "kHeadMaps") == trm.I8_TABLE_HEAD_MAPS == 4
    assert _source_int(src, "kLayerPointers") == len(trm.I8_LAYER_POINTERS)
    lay = trm.mlp_int8_table_layout(n)
    maps_end = 128 * (2 * n + 4)
    for j, name in enumerate(trm.I8_LAYER_POINTERS):
        assert lay[name] == maps_end + 8 * n * j
    assert lay["heads"] == maps_end + 48 * n
    assert lay["bytes"] == lay["heads"] + 8 * 22
    cfg, packed = _packed(256, n, 4)
    enc = torch.zeros(64, trm.LANE, dtype=torch.bfloat16)
    q = tq.quantize_packed(packed, tq.collect_act_amax(packed, enc, cfg.mlp),
                           cfg.mlp)
    maps, pointers = trm.mlp_int8_table_entries(q)
    t = q["transposed"]
    assert 128 * len(maps) + 8 * len(pointers) == lay["bytes"]
    for i in range(n):
        assert maps[i][0] is t["trunk_w"][i]
        assert pointers[5 * n + i] is t["trunk_enc_w"][i]
        assert pointers[i] is q["trunk_u"][i]
    assert pointers[6 * n] is t["w_feat"]
    assert pointers[-1] is q["b_rgb"]


def _mlp_shapes(units, n_layers, skip):
    cfg = MLPConfig(n_layers=n_layers, dense_units=units, skip_layer=skip)
    skips = set(cfg.skip_indices())
    shapes = []
    for i in range(n_layers):
        shapes.append((trm.LANE if i == 0 else units, units, True))
        if i > 0 and (i - 1) in skips:
            shapes.append((trm.LANE, units, False))
    shapes.append((units, units + trm.D_HEAD, True))
    if (n_layers - 1) in skips:
        shapes.append((trm.LANE, units + trm.D_HEAD, False))
    shapes += [(units, units // 2, True), (trm.LANE, units // 2, False),
               (units // 2, trm.D_HEAD, True)]
    return shapes


@pytest.mark.parametrize("units,n_layers,skip", [
    (256, 40, 4), (2048, 3, 1), (8192, 3, 1), (256, 8, 4)])
def test_weight_grad_launches_split_a_call_as_one_launch_would_sum_it(
        units, n_layers, skip):
    """A deep model (53 tasks) or a wide one (about 490 tiles at 2048,
    2,000 in one task at 8192) needs several launches: each holds at most
    40 tasks and 256 tiles, the launches together hold the plan's tiles in
    its order, each task is reduced once, by the launch with its last
    tile, and the partial offsets are the single plan's."""
    shapes = _mlp_shapes(units, n_layers, skip)
    plan = trm.weight_grad_plan(shapes, 2048 * 192)
    launches = plan["launches"]
    assert len(launches) == (1 if (units, n_layers) == (256, 8) else
                             len(launches)) >= 1
    if len(shapes) > trm.MAX_WG_TASKS or len(plan["tiles"]) > \
            trm.MAX_WG_TILES:
        assert len(launches) > 1
    tiles, reduced = [], []
    for launch in launches:
        first, end = launch["tiles"]
        part = plan["tiles"][first:end]
        assert 0 < len(part) <= trm.MAX_WG_TILES
        assert len(launch["tasks"]) <= trm.MAX_WG_TASKS
        assert launch["tasks"] == list(dict.fromkeys(j for j, *_ in part))
        tiles += part
        reduced += launch["reduce"]
        for j in launch["reduce"]:
            assert max(i for i, tl in enumerate(plan["tiles"])
                       if tl[0] == j) < end
    assert tiles == plan["tiles"]
    assert sorted(reduced) == list(range(len(shapes)))
    whole = trm.weight_grad_plan(shapes, 2048 * 192)
    assert {k: whole[k] for k in ("poff", "bpoff", "slices", "chunk")} == \
        {k: plan[k] for k in ("poff", "bpoff", "slices", "chunk")}


def _emulate(plan, a_list, g_list):
    """The kernel's sums as it makes them, in float32: each block (tile,
    slice) sums its slice's points into a partial; each launch's reduce
    adds a task's slices, in slice order, where the launch reduces it."""
    partial = np.full(plan["partial_floats"], np.nan, np.float32)
    outs = [np.zeros((a.shape[1], g.shape[1]), np.float32)
            for a, g in zip(a_list, g_list)]
    bias = [np.zeros(g.shape[1], np.float32) for g in g_list]
    for launch in plan["launches"]:
        first, end = launch["tiles"]
        for s, (b0, b1) in enumerate(plan["bounds"]):
            for j, m0, n0, nt in plan["tiles"][first:end]:
                a, g = a_list[j], g_list[j]
                k, n = a.shape[1], g.shape[1]
                n1 = min(n, n0 + nt)
                acc = a[b0:b1, m0:m0 + 128].T @ g[b0:b1, n0:n1]
                blk = partial[plan["poff"][j] + s * k * n:][:k * n]
                blk.reshape(k, n)[m0:m0 + 128, n0:n1] = acc
                if m0 == 0:
                    partial[plan["bpoff"][j] + s * n + n0:][:n1 - n0] = \
                        g[b0:b1, n0:n1].sum(0, dtype=np.float32)
        for j in launch["reduce"]:
            k, n = outs[j].shape
            for s in range(plan["slices"]):
                outs[j] += partial[plan["poff"][j] + s * k * n:][:k * n] \
                    .reshape(k, n)
                bias[j] += partial[plan["bpoff"][j] + s * n:][:n]
    return outs, bias


def test_weight_grad_split_gives_the_single_launchs_bits(monkeypatch):
    """The emulated kernel over one launch, then with the launch limits cut
    to 2 tasks and 2 tiles (four launches, one task's six tiles across
    three of them): every accumulator bit for bit the same, and none read a
    partial that no block wrote."""
    rng = np.random.default_rng(0)
    shapes = [(128, 64, True), (384, 304, True), (128, 16, True)]
    p = 3 * 16 * trm.WG_STEP    # three slices
    a_list = [rng.normal(size=(p, k)).astype(np.float32)
              for k, _, _ in shapes]
    g_list = [rng.normal(size=(p, n)).astype(np.float32)
              for _, n, _ in shapes]
    one = trm.weight_grad_plan(shapes, p)
    assert len(one["launches"]) == 1 and one["slices"] > 1
    want = _emulate(one, a_list, g_list)
    monkeypatch.setattr(trm, "MAX_WG_TASKS", 2)
    monkeypatch.setattr(trm, "MAX_WG_TILES", 2)
    split = trm.weight_grad_plan(shapes, p)
    assert len(split["launches"]) == 4
    assert any(len(x["reduce"]) < len(x["tasks"]) for x in split["launches"])
    got = _emulate(split, a_list, g_list)
    for x, y in zip(got[0] + got[1], want[0] + want[1]):
        assert np.isfinite(x).all()
        assert np.array_equal(x, y)
