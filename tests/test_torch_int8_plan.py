"""The plan and the integer arithmetic of the ``ray_march_mlp_int8`` kernel
(T4 on ``wgmma`` s8), on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``). What it
takes is decided in Python by :func:`ray_march_mlp_int8_plan`, which
mirrors ``csrc/ray_march_mlp_int8.cu``: 64 points per block, output
columns in parts of 128 (64 above u = 1024), two ping-pong int8 code tiles
of 64 x u, the encoding's float32 tile and code tile, two parts' epilogue
vectors, and a ring of int8 weight stages: 2 where two blocks then share
an SM (u = 256), else as many as fit, at most 4. Every multiple of 256 from
256 to 1280 fits the H100's 227 KB a block (the resident route, up to 16
layers); wider or deeper models take the streamed route (ROADMAP C12: the
codes through an int8 scratch in device memory, the same shared memory at
every width); a width outside the JAX package's envelope raises, naming
it, before anything is built or launched. The code tiles' 128-byte
swizzled layout is mirrored by ``swizzled_offset(..., elem_bytes=1)`` and
held against the layout ``wgmma`` reads. The epilogue's two float32 tricks
(an exact int32 -> float32 conversion and the requantization by adding
1.5 x 2^23) are emulated in numpy against the plain version's arithmetic.
The int8 weights' K-major copies are made once per quantized state.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from keras_nerf_tpu_torch.kernels import _build
from keras_nerf_tpu_torch.kernels import quantize as tq
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRFConfig, init_mlp

SOURCE = (Path(trm.__file__).resolve().parent / "csrc" /
          "ray_march_mlp_int8.cu").read_text()
WIDTHS = [256, 512, 768, 1024, 1280]


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m is not None, name
    return m.group(1).split("//")[0].strip()


def _constants() -> dict:
    env = {"kEncLanes": trm.LANE}
    for name in ("kTile", "kKBox", "kSlabBytes", "kEncBytes", "kMaxStages",
                 "kSmemPerBlock", "kSmemPerSm"):
        env[name] = eval(_constant(name), {}, env)
    return env


def _function(name: str) -> str:
    """The return expression of ``constexpr int name(...)``, as Python."""
    m = re.search(rf"constexpr int {name}\([^)]*\) \{{\s*return ([^;]+);",
                  SOURCE)
    assert m is not None, name
    return _python(" ".join(m.group(1).split()))


def _python(expr: str) -> str:
    """A C++ expression of ints as Python: ``c ? a : b`` chains (right
    associative, no ``?`` inside ``a``) as conditionals, ``/`` as ``//``."""
    expr = expr.replace("/", "//")
    if "?" not in expr:
        return expr
    cond, rest = expr.split("?", 1)
    a, b = rest.split(":", 1)
    return f"({a.strip()}) if ({cond.strip()}) else ({_python(b.strip())})"


def _source_plan(u: int) -> dict:
    """The kernel source's own formulas, evaluated at width ``u``."""
    env = _constants()

    def fn(name):
        return lambda *args: eval(_function(name), {}, {
            **env, **dict(zip(("u", "stages"), args)), **funcs})

    funcs = {name: fn(name) for name in (
        "part_of", "fixed_bytes", "stage_bytes", "smem_bytes", "most_stages",
        "stages_of")}
    stages = funcs["stages_of"](u)
    return {"part": funcs["part_of"](u), "stages": stages,
            "smem_bytes": funcs["smem_bytes"](u, stages)}


@pytest.mark.parametrize("units", WIDTHS)
def test_plan_fits_227_kb_at_every_width(units):
    plan = trm.ray_march_mlp_int8_plan(units)
    assert plan["route"] == "resident"
    assert plan["tile"] == 64
    assert plan["part"] == (128 if units <= 1024 else 64)
    assert 2 <= plan["stages"] <= 4
    # Both ping-pong code tiles, the encoding's float32 and code tiles and
    # the ring, within the H100's 227 KB; two blocks share an SM at 256.
    ring = plan["stages"] * plan["part"] * 128
    assert plan["smem_bytes"] >= 2 * 64 * units + 64 * 128 * 5 + ring + 1024
    assert plan["smem_bytes"] <= trm.SMEM_PER_BLOCK == 227 * 1024
    blocks = plan["blocks_per_sm"]
    assert blocks == (2 if units == 256 else 1)
    assert blocks * (plan["smem_bytes"] + 1024) <= trm.SMEM_PER_SM


@pytest.mark.parametrize("units", [0, 128, 384, 640, 1000])
def test_plan_refuses_other_widths_by_name(units):
    # Outside the JAX package's envelope: not a multiple of 256.
    with pytest.raises(ValueError, match=rf"ray_march_mlp_int8 takes "
                                         rf"dense_units .*\(got {units}\)"):
        trm.ray_march_mlp_int8_plan(units)


def _streamed_constants() -> dict:
    body = SOURCE[SOURCE.index("namespace streamed {"):]
    env = _constants()
    for name in ("kStages", "kPart", "kStageBytes", "kSmemBytes"):
        m = re.search(rf"constexpr int {name} = ([^;]+);", body)
        assert m is not None, name
        env[name] = eval(" ".join(m.group(1).split("//")[0].split()), {},
                         env)
    return env


# (units, layers): 1536 (refused before the streamed route: the resident
# code tiles and two stages no longer fit), up to 8192, and depths past 16.
@pytest.mark.parametrize("units,n_layers", [
    (1536, 8), (2048, 3), (8192, 3), (256, 17), (256, 40), (1280, 17)])
def test_plan_streams_wider_and_deeper_models(units, n_layers):
    plan = trm.ray_march_mlp_int8_plan(units, n_layers)
    env = _streamed_constants()
    assert plan["route"] == "streamed"
    assert (plan["tile"], plan["part"], plan["stages"]) == (
        env["kTile"], env["kPart"], env["kStages"]) == (64, 128, 3)
    assert plan["stage_bytes"] == env["kStageBytes"] == trm.STREAM_STAGE_BYTES
    assert plan["smem_bytes"] == env["kSmemBytes"] <= trm.SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] == 2


@pytest.mark.parametrize("name,mirror", [
    ("kTile", "I8_TILE"), ("kKBox", "I8_KBOX"),
    ("kSlabBytes", "I8_SLAB_BYTES"), ("kEncBytes", "I8_ENC_BYTES"),
    ("kMaxStages", "I8_MAX_STAGES"), ("kSmemPerBlock", "SMEM_PER_BLOCK"),
    ("kSmemPerSm", "SMEM_PER_SM")])
def test_plan_mirrors_the_kernel_source(name, mirror):
    assert _constants()[name] == getattr(trm, mirror)


@pytest.mark.parametrize("units", WIDTHS + [1536])
def test_plan_is_the_kernel_sources_formula(units):
    """Part width, stages and bytes from the source's own constexpr
    functions; at 1536 the source too finds fewer than two stages."""
    want = _source_plan(units)
    if units == 1536:
        assert want["stages"] < 2
        return
    plan = trm.ray_march_mlp_int8_plan(units)
    assert {k: plan[k] for k in want} == want


def test_wrapper_refuses_a_width_before_building_or_launching(monkeypatch):
    """The launch function checks the plan before it quantizes anything or
    loads the library: called here on the CPU, where no compiler exists, it
    raises on the width and never reaches the build."""
    def no_build():
        raise AssertionError("the library was loaded before the width check")

    monkeypatch.setattr(_build, "load", no_build)
    u = 640   # outside the JAX package's envelope
    q = {"trunk_w": [None], "trunk_b": [torch.zeros(1, u)]}
    base = slope = torch.zeros(2, trm.LANE)
    before = trm.ray_march_mlp_int8.launches
    with pytest.raises(ValueError, match="640"):
        trm._ray_march_mlp_int8_cuda(q, base, slope, torch.zeros(2, 4),
                                     torch.zeros(3, trm.LANE))
    assert trm.ray_march_mlp_int8.launches == before


def _swz_expr() -> str:
    m = re.search(r"__device__ __forceinline__ int swz\(int r, int k\) \{\s*"
                  r"return ([^;]+);", SOURCE)
    assert m is not None
    return " ".join(m.group(1).split())


def test_int8_swizzled_offset_mirrors_the_kernel_source():
    expr = _swz_expr()
    env = _constants()
    for r in range(64):
        for k in range(0, 1280):
            assert eval(expr, {}, {**env, "r": r, "k": k}) == \
                trm.swizzled_offset(r, k, 64, elem_bytes=1), (r, k)


@pytest.mark.parametrize("cols", [128, 256, 1280])
def test_codes_land_where_the_kmajor_sw128_layout_reads(cols):
    """Every code (r, k) of a [64 x cols] int8 tile, stored at
    ``swizzled_offset(r, k, 64, 1)``, lands where the K-major 128-byte
    swizzled layout that ``wgmma`` reads keeps it (``csrc/gmma.cuh``:
    128-column boxes of 64 rows of 128 bytes, each 1024-byte aligned, the
    16-byte chunk bits 4-6 of an address XOR-ed with its row bits 7-9), and
    the stores cover the tile once. A pair (k, k + 1), k even, is one 16-bit
    store: both bytes in one chunk."""
    owner = np.full(64 * cols, -1, dtype=np.int64)
    for r in range(64):
        for k in range(cols):
            off = trm.swizzled_offset(r, k, 64, elem_bytes=1)
            linear = r * 128 + k % 128
            want = (k // 128) * 64 * 128 + (linear ^ (((linear >> 7) & 7)
                                                      << 4))
            assert off == want, (r, k)
            assert owner[off] == -1
            owner[off] = r * cols + k
            if k % 2 == 0:
                assert trm.swizzled_offset(r, k + 1, 64, 1) == off + 1
    assert (owner >= 0).all()


def _f32(x):
    return np.float32(x)


def test_requantization_by_the_float_add_matches_the_plain_rounding():
    """The kernel's quant_bits: clip x r to [lo, 127] (lo = -127, or 0 for
    a relu folded in, r >= 0), add 1.5 x 2^23 in float32, read the code from
    the sum's bits; against the plain version's clip(round(x r)) (ties to
    even) after relu, on random values, exact ties and saturating values."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0, 40, 20000), np.arange(-130, 131) + 0.5,
        np.arange(-130, 131), [1e30, -1e30, 0.0, -0.0, 126.5, -126.5]]
    ).astype(np.float32)
    for r in (_f32(1.0), _f32(0.37), _f32(2.5), _f32(0.0)):
        for relu in (False, True):
            y = x * r
            lo = _f32(0.0) if relu else _f32(-127.0)
            t = np.minimum(np.maximum(y, lo), _f32(127.0)) + _f32(12582912.0)
            assert t.dtype == np.float32
            got = t.view(np.int32) - 0x4B400000
            ref = torch.as_tensor(x)
            if relu:
                ref = torch.relu(ref)
            want = tq._quant_act(ref, torch.tensor(float(r))).numpy()
            np.testing.assert_array_equal(got, want.astype(np.int32))
            # The low byte the kernel stores is the code's two's complement.
            np.testing.assert_array_equal(
                (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8),
                want.astype(np.int8))


def test_small_sums_convert_to_float_exactly_by_the_float_add():
    """The kernel's sum_to_float<true>: bits (x + 0x4B400000) as float32,
    minus 1.5 x 2^23, is float32(x) for |x| < 2^22, which every sum of at
    most 256 products of codes is (127^2 x 256 < 2^22)."""
    assert 127 * 127 * 256 < 2 ** 22
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(-2 ** 22 + 1, 2 ** 22, 50000),
                        [0, 1, -1, 2 ** 22 - 1, -(2 ** 22) + 1,
                         127 * 127 * 256, -127 * 127 * 256]]).astype(np.int32)
    got = (x + np.int32(0x4B400000)).view(np.float32) - _f32(12582912.0)
    np.testing.assert_array_equal(got, x.astype(np.float32))


def _quantized(units=256, n_layers=3, skip=2):
    cfg = NeRFConfig(n_layers=n_layers, dense_units=units, skip_layer=skip)
    g = torch.Generator().manual_seed(0)
    packed = trm.pack_mlp_params(init_mlp(g, cfg.mlp, cfg.in_xyz, cfg.in_dir),
                                 cfg.mlp, 10, 4)
    enc = torch.randn(64, trm.LANE, generator=g).to(torch.bfloat16)
    return tq.quantize_packed(packed, tq.collect_act_amax(packed, enc,
                                                          cfg.mlp), cfg.mlp)


def test_transposed_weights_are_made_once_per_quantized_state():
    """Two launches' structures point at the same K-major copies, made at
    the first and kept in the state: every int8 array, transposed."""
    q = _quantized()
    assert "transposed" not in q
    cpu = torch.device("cpu")
    first = trm._mlp_int8_struct(q, cpu)
    t = q["transposed"]
    second = trm._mlp_int8_struct(q, cpu)
    assert tq.transposed_int8_weights(q) is t
    for name in ("w_feat", "w_sig", "w_feat_enc", "w_sig_enc", "w_rf_top",
                 "w_rf_enc", "w_rgb"):
        assert getattr(first, name) == getattr(second, name), name
        if q[name] is None:
            assert t[name] is None and getattr(first, name) is None
            continue
        assert getattr(first, name) == t[name].data_ptr()
        assert torch.equal(t[name], q[name].t())
    for i, w in enumerate(q["trunk_w"]):
        assert first.trunk_w[i] == second.trunk_w[i] == \
            t["trunk_w"][i].data_ptr()
        assert torch.equal(t["trunk_w"][i], w.t())
    assert q["w_sig_enc"] is not None    # the last layer skips: all sites


def test_calibration_makes_the_transposes_only_for_the_card():
    """``quantize_render_params`` makes the copies with the state on a card
    (where the kernel reads them), not on the CPU, whose plain version
    reads the arrays as they are."""
    from keras_nerf_tpu_torch.models import engine

    cfg = NeRFConfig(n_coarse=4, n_fine=4, n_layers=2, skip_layer=4)
    g = torch.Generator().manual_seed(0)
    pc, pf = engine.init_params(g, cfg)
    r = 8
    o = torch.zeros(r, 3)
    d = torch.nn.functional.normalize(torch.randn(r, 3, generator=g), dim=-1)
    t = torch.sort(torch.rand(r, 4, generator=g) * 4 + 2, -1).values
    qs = engine.quantize_render_params(pc, pf, (o, d, t), g, cfg,
                                       n_calib_rays=8)
    assert all("transposed" not in q for q in qs)
