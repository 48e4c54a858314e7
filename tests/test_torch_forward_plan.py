"""The tile and shared-memory plan of the ``ray_march_mlp`` kernel (and of
``apply_mlp``, its input mode), on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``). What it
takes is decided in Python by :func:`ray_march_mlp_plan`, which mirrors
``csrc/ray_march_mlp.cu``. Its resident route (u = 256, 512 and 768, up to
16 layers): a block of 128 points at u = 256 and 64 at u = 512 and 768,
whose activation tile is 64 KB (96 KB at 768), beside the encoding tile and
a ring of three 32 KB weight stages, within the H100's 227 KB of shared
memory a block. Its streamed route (every other multiple of 256, any
depth: ROADMAP C12): 64 points, each product's output through device
memory, so shared memory does not grow with the width. A width outside the
JAX package's envelope raises, naming the width, before anything is built
or launched. The tiles' 128-byte swizzled layout is mirrored by
:func:`swizzled_offset`, held here against the layout ``wgmma`` reads.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from keras_nerf_tpu_torch.kernels import _build
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRFConfig, init_mlp

SOURCE = (Path(trm.__file__).resolve().parent / "csrc" /
          "ray_march_mlp.cu").read_text()


def _constant(name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m is not None, name
    return m.group(1).split("//")[0].strip()


def _constants() -> dict:
    env = {"kEncLanes": trm.LANE}
    for name in ("kBox", "kMaxUnits", "kStages", "kStageBytes",
                 "kTileElems", "kFloats"):
        env[name] = eval(_constant(name), {}, env)
    return env


def _streamed_constants() -> dict:
    """The constants of the source's streamed route (its own namespace)."""
    body = SOURCE[SOURCE.index("namespace streamed {"):]
    env = {"kEncLanes": trm.LANE, "kBox": _constants()["kBox"]}
    for name in ("kTile", "kStages", "kABytes", "kStageBytes", "kPass",
                 "kConsumers", "kThreads", "kSmemBytes"):
        m = re.search(rf"constexpr int {name} = ([^;]+);", body)
        assert m is not None, name
        env[name] = eval(" ".join(m.group(1).split("//")[0].split()), {},
                         env)
    return env


@pytest.mark.parametrize("units,tile,split", [(256, 128, "rows"),
                                              (512, 64, "columns"),
                                              (768, 64, "columns")])
def test_plan_fits_the_tiles_in_227_kb(units, tile, split):
    plan = trm.ray_march_mlp_plan(units)
    assert plan["route"] == "resident"
    assert plan["tile"] == tile and plan["split"] == split
    assert plan["stages"] == 3
    assert plan["passes"] == (3 if units == 768 else 1)
    # The activation tile: 64 KB of bf16 (96 KB at u = 768); the encoding
    # tile beside it.
    assert plan["tile"] * units * 2 == (96 if units == 768 else 64) * 1024
    enc = plan["tile"] * trm.LANE * 2
    ring = plan["stages"] * trm.FWD_STAGE_BYTES
    assert plan["smem_bytes"] >= 64 * 1024 + enc + ring + 1024
    assert plan["smem_bytes"] <= trm.SMEM_PER_BLOCK == 227 * 1024


@pytest.mark.parametrize("units", [0, 128, 384, 640, 1000])
def test_plan_refuses_other_widths_by_name(units):
    # Outside the JAX package's envelope: not a multiple of 256.
    with pytest.raises(ValueError, match=rf"dense_units a multiple of 256 "
                                         rf"\(got {units}\)"):
        trm.ray_march_mlp_plan(units)


# (units, layers): the widths the resident tile cannot hold (1024 refused
# before the streamed route), up to 8192, and depths past the resident
# kernel's 16 layers of tensor maps.
_STREAMED = [(1024, 8), (1536, 8), (2048, 3), (8192, 3), (256, 17),
             (256, 40), (768, 17)]


@pytest.mark.parametrize("units,n_layers", _STREAMED)
def test_plan_streams_wider_and_deeper_models(units, n_layers):
    plan = trm.ray_march_mlp_plan(units, n_layers)
    env = _streamed_constants()
    assert plan["route"] == "streamed"
    assert plan["tile"] == env["kTile"] == 64
    assert plan["passes"] == units // env["kPass"]
    assert plan["stages"] == env["kStages"]
    assert plan["stage_bytes"] == env["kStageBytes"] == 24 * 1024
    # The same shared memory at every width: the ring, the encoding tile,
    # the heads' sums; two blocks an SM.
    assert plan["smem_bytes"] == env["kSmemBytes"] <= trm.SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] == 2
    assert 2 * (plan["smem_bytes"] + 1024) <= trm.SMEM_PER_SM


def test_plan_keeps_the_resident_route_up_to_16_layers():
    for units in (256, 512, 768):
        assert trm.ray_march_mlp_plan(units, 16)["route"] == "resident"
        assert trm.ray_march_mlp_plan(units, 17)["route"] == "streamed"


@pytest.mark.parametrize("name,mirror", [
    ("kStages", "FWD_STAGES"), ("kTileElems", "FWD_TILE_ELEMS"),
    ("kStageBytes", "FWD_STAGE_BYTES"), ("kFloats", "FWD_FLOATS")])
def test_plan_mirrors_the_kernel_source(name, mirror):
    assert _constants()[name] == getattr(trm, mirror)


@pytest.mark.parametrize("units", [256, 512, 768])
def test_plan_bytes_are_the_kernel_sources_formula(units):
    m = re.search(r"constexpr int smem_bytes\(int tile, int units\) \{\s*"
                  r"return ([^;]+);", SOURCE)
    assert m is not None
    plan = trm.ray_march_mlp_plan(units)
    env = {**_constants(), "tile": plan["tile"], "units": units}
    assert eval(" ".join(m.group(1).split()), {}, env) == plan["smem_bytes"]


def test_kernel_source_checks_the_same_limit():
    assert "232448" in SOURCE
    assert trm.SMEM_PER_BLOCK == 232448


@pytest.mark.parametrize("name,mirror", [
    ("kTile", "STREAM_TILE"), ("kStages", "STREAM_STAGES"),
    ("kPass", "STREAM_PASS"), ("kStageBytes", "STREAM_STAGE_BYTES")])
def test_streamed_plan_mirrors_the_kernel_source(name, mirror):
    assert _streamed_constants()[name] == getattr(trm, mirror)


def _wide_inputs(units=384, points=8):
    cfg = NeRFConfig(n_layers=2, dense_units=units, skip_layer=1)
    g = torch.Generator().manual_seed(0)
    packed = trm.pack_mlp_params(init_mlp(g, cfg.mlp, cfg.in_xyz,
                                          cfg.in_dir), cfg.mlp, 10, 4)
    o = torch.zeros(points, 3)
    d = torch.nn.functional.normalize(torch.randn(points, 3, generator=g),
                                      dim=-1)
    t = torch.sort(torch.rand(points, 4, generator=g) * 4 + 2, -1).values
    base, slope, masks = trm.ray_encoding_coeffs(o, d, 10, 4)
    enc = trm.encode_block128(*trm.ray_points(o, d, t))
    return packed, base, slope, t, masks, enc


@pytest.mark.parametrize("entry", ["ray_march_mlp", "apply_mlp"])
def test_wrapper_refuses_a_width_before_building_or_launching(monkeypatch,
                                                              entry):
    """The launch functions check the plan before they load the library:
    called here on the CPU, where no compiler exists, they raise on the
    width and never reach the build."""
    def no_build():
        raise AssertionError("the library was loaded before the width check")

    monkeypatch.setattr(_build, "load", no_build)
    # 384 is outside the JAX package's envelope (384 / 2 is not a multiple
    # of 128), so pack_mlp_params refuses it too: let it pack one.
    monkeypatch.setattr(trm, "kernel_supported", lambda *a: True)
    packed, base, slope, t, masks, enc = _wide_inputs()
    before = (trm.ray_march_mlp.launches, trm.apply_mlp.launches)
    with pytest.raises(ValueError, match="384"):
        if entry == "ray_march_mlp":
            trm._ray_march_mlp_cuda(packed, base, slope, t, masks)
        else:
            trm._apply_mlp_cuda(packed, enc)
    assert (trm.ray_march_mlp.launches, trm.apply_mlp.launches) == before


def _swz_source_expr() -> str:
    m = re.search(r"__device__ __forceinline__ int swz\(int r, int c\) \{\s*"
                  r"return ([^;]+);", SOURCE)
    assert m is not None
    return " ".join(m.group(1).split())


def test_swizzled_offset_mirrors_the_kernel_source():
    expr = _swz_source_expr()
    for tile in (128, 64):
        for r in range(tile):
            for c in range(0, 512, 2):
                assert eval(expr, {}, {"kTile": tile, "r": r, "c": c}) == \
                    trm.swizzled_offset(r, c, tile), (tile, r, c)


@pytest.mark.parametrize("tile,cols", [(128, 128), (64, 128), (128, 256),
                                       (64, 512)])
def test_prologue_stores_land_where_the_kmajor_sw128_layout_reads(tile,
                                                                   cols):
    """The prologue's stores, emulated thread by thread: consumer thread
    ``ct`` of 256 takes steps ``v = ct, ct + 256, ...`` and stores the 16
    bytes of lanes ``c .. c + 7`` of row ``r`` (``r, c = v // (cols / 8),
    8 (v % (cols / 8))``) at ``swizzled_offset(r, c, tile)``. The K-major
    128-byte swizzled layout that ``wgmma`` reads (``csrc/gmma.cuh``) keeps
    64-column boxes of ``tile`` rows of 128 bytes, each box 1024-byte
    aligned, and XORs the 16-byte chunk bits (4-6) of an address with its
    row bits (7-9). Every lane of every row must land at the byte that
    layout reads it from, and the stores must cover the tile once."""
    owner = np.full(tile * cols * 2, -1, dtype=np.int64)
    chunks = cols // 8
    for ct in range(256):
        for v in range(ct, tile * chunks, 256):
            r, c = v // chunks, (v % chunks) * 8
            off = trm.swizzled_offset(r, c, tile)
            assert off % 16 == 0
            for e in range(8):
                lane = c + e
                linear = r * 128 + (lane % 64) * 2
                want = ((lane // 64) * tile * 128
                        + (linear ^ (((linear >> 7) & 7) << 4)))
                assert off + 2 * e == want, (r, lane)
                assert (owner[want:want + 2] == -1).all(), (r, lane)
                owner[want:want + 2] = r * cols + lane
    assert (owner >= 0).all()
