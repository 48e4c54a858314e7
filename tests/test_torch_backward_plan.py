"""The tile and shared-memory plan of the ``mlp_backward`` kernel, on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``). What it
takes is decided in Python by :func:`mlp_backward_plan`, which mirrors
``csrc/mlp_backward.cu``. Its resident route (u = 256, 512 and 768, up to
16 layers): a block of 128 points at u = 256 and 64 at u = 512, whose
cotangent and mask tiles are 64 KB each, beside a ring of three 32 KB
weight slabs; at u = 768 64 points, tiles of 96 KB and a ring of two 16 KB
slabs; within the H100's 227 KB of shared memory a block. Its streamed
route (every other multiple of 256, any depth: ROADMAP C12): 64 points,
each layer's cotangent read back from device memory, the same shared
memory at every width. A width outside the JAX package's envelope raises,
naming the width, before anything is built or launched.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import re
from pathlib import Path

import pytest
import torch

from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRFConfig, init_mlp

SOURCE = (Path(trm.__file__).resolve().parent / "csrc" /
          "mlp_backward.cu").read_text()


def _constant(name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m is not None, name
    return m.group(1).split("//")[0].strip()


@pytest.mark.parametrize("units,tile,split", [(256, 128, "rows"),
                                              (512, 64, "columns"),
                                              (768, 64, "columns")])
def test_plan_fits_the_tiles_in_227_kb(units, tile, split):
    plan = trm.mlp_backward_plan(units)
    assert plan["route"] == "resident"
    assert plan["tile"] == tile and plan["split"] == split
    assert (plan["stages"], plan["stage_bytes"]) == (
        (2, 16384) if units == 768 else (3, 32768))
    # The cotangent tile and the mask tile: 64 KB of bf16 each (96 KB at
    # u = 768).
    assert 2 * plan["tile"] * units == (96 if units == 768 else 64) * 1024
    ring = plan["stages"] * plan["stage_bytes"]
    assert plan["smem_bytes"] >= 2 * 64 * 1024 + ring + 1024
    assert plan["smem_bytes"] <= trm.SMEM_PER_BLOCK == 227 * 1024


@pytest.mark.parametrize("units", [0, 128, 384, 640, 1000])
def test_plan_refuses_other_widths_by_name(units):
    # Outside the JAX package's envelope: not a multiple of 256.
    with pytest.raises(ValueError, match=rf"dense_units a multiple of 256 "
                                         rf"\(got {units}\)"):
        trm.mlp_backward_plan(units)


def _streamed_constants() -> dict:
    body = SOURCE[SOURCE.index("namespace streamed {"):]
    env = {}
    for name in ("kTile", "kStages", "kABytes", "kStageBytes", "kPass",
                 "kSmemBytes"):
        m = re.search(rf"constexpr int {name} = ([^;]+);", body)
        assert m is not None, name
        env[name] = eval(" ".join(m.group(1).split("//")[0].split()), {},
                         env)
    return env


# (units, layers): the widths the resident tiles cannot hold (1024 refused
# before the streamed route), up to 8192, and depths past 16 layers.
@pytest.mark.parametrize("units,n_layers", [
    (1024, 8), (1536, 8), (2048, 3), (8192, 3), (256, 17), (256, 40),
    (768, 17)])
def test_plan_streams_wider_and_deeper_models(units, n_layers):
    plan = trm.mlp_backward_plan(units, n_layers)
    env = _streamed_constants()
    assert plan["route"] == "streamed"
    assert (plan["tile"], plan["stages"], plan["stage_bytes"]) == (
        env["kTile"], env["kStages"], env["kStageBytes"]) == (64, 3, 24576)
    assert plan["passes"] == units // env["kPass"]
    assert plan["smem_bytes"] == env["kSmemBytes"] <= trm.SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] == 2


@pytest.mark.parametrize("name,mirror", [
    ("kStages", "BWD_STAGES"), ("kTileElems", "BWD_TILE_ELEMS"),
    ("kStageBytes", "BWD_STAGE_BYTES"), ("kWideStages", "BWD_WIDE_STAGES"),
    ("kWideStageBytes", "BWD_WIDE_STAGE_BYTES")])
def test_plan_mirrors_the_kernel_source(name, mirror):
    env = {"kBoxRows": int(_constant("kBoxRows")),
           "kWideBoxRows": int(_constant("kWideBoxRows"))}
    assert eval(_constant(name), {}, env) == getattr(trm, mirror)


@pytest.mark.parametrize("units", [256, 512, 768])
def test_plan_bytes_are_the_kernel_sources_formula(units):
    m = re.search(r"constexpr int smem_bytes\(int tile, int units, int stages, "
                  r"int stage_bytes\) \{\s*return ([^;]+);", SOURCE)
    assert m is not None
    plan = trm.mlp_backward_plan(units)
    env = {"tile": plan["tile"], "units": units, "stages": plan["stages"],
           "stage_bytes": plan["stage_bytes"]}
    assert eval(" ".join(m.group(1).split()), {}, env) == plan["smem_bytes"]


def test_kernel_source_checks_the_same_limit():
    assert "232448" in SOURCE
    assert trm.SMEM_PER_BLOCK == 232448


def test_wrapper_refuses_a_width_before_building_or_launching(monkeypatch):
    """On CUDA tensors the wrapper checks the plan before it loads the
    library; its launch function raises here too, on the CPU, where no
    compiler exists, so the check comes first."""
    # 384 is outside the JAX package's envelope, so pack_mlp_params refuses
    # it too: let it pack one.
    monkeypatch.setattr(trm, "kernel_supported", lambda *a: True)
    cfg = NeRFConfig(n_layers=2, dense_units=384, skip_layer=1)
    params = init_mlp(torch.Generator().manual_seed(0), cfg.mlp, cfg.in_xyz,
                      cfg.in_dir)
    packed = trm.pack_mlp_params(params, cfg.mlp, 10, 4)
    stash = trm.alloc_stash(8, 384, 2, torch.device("cpu"))
    d_rgb = torch.zeros((8, trm.D_HEAD), dtype=torch.bfloat16)
    d_sigma = torch.zeros(8, dtype=torch.bfloat16)
    before = trm.mlp_backward.launches
    with pytest.raises(ValueError, match="384"):
        trm._mlp_backward_cuda(d_rgb, d_sigma, packed, stash)
    assert trm.mlp_backward.launches == before
