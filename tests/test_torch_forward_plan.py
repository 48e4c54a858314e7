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
memory, so shared memory does not grow with the width. Its persistent
route (the no-grad ray-march modes at u = 256): a block an SM walking
128-point tiles, the activations in registers as the next product's A
operand, a ring of four stages and two encoding tiles. A width outside the
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


# ---- the persistent route: the no-grad ray-march modes at u = 256 ----------

def _persistent_constants() -> dict:
    """The constants of the source's persistent route (its own namespace)."""
    body = SOURCE[SOURCE.index("namespace persistent {"):]
    env = {"kEncLanes": trm.LANE, "kBox": _constants()["kBox"]}
    for name in ("kTile", "kUnits", "kHalf", "kStages", "kStageBytes",
                 "kEncBytes", "kEncoders", "kFloats", "kSmemBytes"):
        m = re.search(rf"constexpr int {name} = ([^;]+);", body)
        assert m is not None, name
        env[name] = eval(" ".join(m.group(1).split("//")[0].split()), {},
                         env)
    return env


# (units, layers): the widths and depths of both other routes.
_ROUTES = [(256, 8), (256, 3), (256, 16), (256, 17), (256, 40), (512, 8),
           (768, 8), (768, 16), (1024, 8), (2048, 3)]


@pytest.mark.parametrize("units,n_layers", _ROUTES)
def test_plan_takes_the_persistent_route_only_for_no_grad_calls_at_256(
        units, n_layers):
    """Persistent for a call without a stash whose encoding the kernel
    builds (sigma-only and full modes), at u = 256 and at most 16 layers;
    the train mode, apply_mlp (its input mode) and every other width and
    depth keep the route they had."""
    old = trm.ray_march_mlp_plan(units, n_layers)
    assert old["route"] in ("resident", "streamed")
    new = trm.ray_march_mlp_plan(units, n_layers, no_grad=True)
    if units == 256 and n_layers <= trm.MAX_LAYERS:
        assert new["route"] == "persistent"
        assert new["tile"] == 128 and new["split"] == "rows"
    else:
        assert new == old


def test_persistent_plan_fits_in_227_kb_and_mirrors_the_source():
    env = _persistent_constants()
    plan = trm.ray_march_mlp_plan(256, 8, no_grad=True)
    assert plan["tile"] == env["kTile"] == trm.PERSIST_TILE == 128
    assert env["kUnits"] == trm.PERSIST_UNITS == 256
    assert plan["stages"] == env["kStages"] == trm.PERSIST_STAGES == 8
    assert env["kStageBytes"] == trm.PERSIST_STAGE_BYTES == 64 * 128 * 2
    assert env["kFloats"] == trm.PERSIST_FLOATS
    # Each product in two halves of 128 columns; the ring (a whole
    # 256-wide product's K for both halves), two encoding tiles, the heads'
    # columns: no activation tile.
    assert env["kUnits"] == 2 * env["kHalf"] == 256
    assert env["kStages"] * 64 == 2 * env["kUnits"]
    assert env["kEncBytes"] == 128 * trm.LANE * 2
    assert plan["smem_bytes"] == env["kSmemBytes"] == trm.PERSIST_SMEM
    assert plan["smem_bytes"] >= (8 * trm.PERSIST_STAGE_BYTES
                                  + 2 * env["kEncBytes"] + 1024)
    assert plan["smem_bytes"] <= trm.SMEM_PER_BLOCK == 232448
    # Warps 1-3 build the encoding: whole 16-lane rows of chunks a step.
    assert env["kEncoders"] == 96 and env["kEncoders"] % 16 == 0


@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("points", [1, 127, 128, 129, 305, 3200, 131 * 128,
                                    132 * 128, 132 * 128 + 1, 133 * 128 - 1,
                                    4096 * 64, 3200 * 192, 4096 * 192 + 17])
def test_persistent_walk_visits_every_tile_once(points, sms):
    """Block b of min(tiles, SMs) walks tiles b, b + grid, ...: together
    every tile of the call exactly once, and no two blocks' counts differ
    by more than one."""
    walk = trm.persistent_tiles(points, sms)
    tiles = -(-points // 128)
    assert len(walk) == min(tiles, sms)
    seen = sorted(t for block in walk for t in block)
    assert seen == list(range(tiles))
    counts = [len(block) for block in walk]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    for b, block in enumerate(walk):
        assert block[0] == b
        assert all(y - x == len(walk) for x, y in zip(block, block[1:]))


def test_route_of_a_call_follows_its_mode():
    """The wrappers count a launch under the route its arguments take:
    ray_march_mlp without a stash persistent (or the route it is given),
    with one resident; apply_mlp resident at u = 256. A route that cannot
    run the call raises before anything is built."""
    packed, base, slope, t, masks, enc = _fwd_cpu_inputs()
    args = (packed, base, slope, t, masks)
    assert trm._ray_march_mlp_route(*args) == "persistent"
    assert trm._ray_march_mlp_route(*args, sigma_only=True) == "persistent"
    assert trm._ray_march_mlp_route(*args, route="resident") == "resident"
    assert trm._ray_march_mlp_route(*args, stash={}) == "resident"
    assert trm._apply_mlp_route(packed, enc) == "resident"
    assert trm._apply_mlp_route(packed, enc, stash={}) == "resident"
    with pytest.raises(ValueError, match="persistent"):
        trm._ray_march_mlp_cuda(*args, stash={}, route="persistent")
    with pytest.raises(ValueError, match="streamed"):
        trm._ray_march_mlp_cuda(*args, route="streamed")


def _fwd_cpu_inputs(points=8):
    cfg = NeRFConfig()
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


def test_accumulators_packed_in_order_are_the_next_products_a_registers():
    """The persistent kernel's epilogue writes bf16 pair (j, h) of a thread's
    m64nNk16 accumulators, columns 8 j + 2 q, + 1 of row g + 8 h, to its A
    register 2 j + h (csrc/gmma.cuh's two layouts, g = 16 (t / 32) + (t %
    32) / 4, q = t % 4). Emulated for every thread of the warpgroup, the A
    registers of k16 step k (a[4 k .. 4 k + 3]: rows g, g + 8 by columns
    2 q, 8 + 2 q of the step) read back the whole 64 x 256 tile in place."""
    tile = np.arange(64 * 256).reshape(64, 256)
    got = np.full_like(tile, -1)
    for t in range(128):
        g, q = 16 * (t // 32) + (t % 32) // 4, t % 4
        a = {}
        for j in range(32):           # accumulators d[4 j + 2 h + e]
            for h in range(2):
                pair = (tile[g + 8 * h, 8 * j + 2 * q],
                        tile[g + 8 * h, 8 * j + 2 * q + 1])
                a[2 * j + h] = pair
        for k in range(16):           # A registers of step k
            for i, (row, col) in enumerate([(g, 2 * q), (g + 8, 2 * q),
                                            (g, 8 + 2 * q),
                                            (g + 8, 8 + 2 * q)]):
                lo, hi = a[4 * k + i]
                assert got[row, 16 * k + col] == -1
                got[row, 16 * k + col] = lo
                got[row, 16 * k + col + 1] = hi
    assert (got == tile).all()
