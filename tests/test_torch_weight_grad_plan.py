"""The tile-and-slice plan of the ``mlp_weight_grad`` kernel, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
what decides which block sums what is :func:`weight_grad_plan`, in Python.
These tests hold it to the kernel's contract at the shapes of the packed
MLPs: every output element of every task is covered by exactly one block
per slice, the slices split ``[0, P)`` in order at multiples of the
64-point stage (only the last ending at ``P``), the partial buffer's
offsets do not overlap, and the plan is a function of the shapes alone. An
emulation of the blocks' sums over the plan (float32 products of the bf16
operands, partials added in slice order) is held against
``mlp_weight_grad_plain`` at relative norm 1e-6: the same products summed
in another order.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import numpy as np
import pytest
import torch

from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRFConfig, init_mlp


def _packed(units=256, n_layers=8, skip=4):
    cfg = NeRFConfig(n_layers=n_layers, dense_units=units, skip_layer=skip)
    params = init_mlp(torch.Generator().manual_seed(0), cfg.mlp, cfg.in_xyz,
                      cfg.in_dir)
    return cfg, trm.pack_mlp_params(params, cfg.mlp, 10, 4)


def _inputs(points, units=256, n_layers=8, skip=4, seed=0):
    """Random bf16 stash and cotangents (numpy draws) in the layout the
    training kernels write, with zero padding where the kernels write
    zeros (d_sf past column u, d_rgb past column 2)."""
    cfg, packed = _packed(units, n_layers, skip)
    rng = np.random.default_rng(seed)
    stash = trm.alloc_stash(points, units, n_layers, torch.device("cpu"))
    cots = trm.alloc_cotangents(points, units, n_layers, torch.device("cpu"))
    views = [stash["enc"], *stash["h"], stash["features"], stash["rf"],
             cots["d_rf"], cots["d_sf"], *cots["d_pre"]]
    for v in views:
        v.copy_(torch.from_numpy(rng.standard_normal(v.shape,
                                                     dtype=np.float32)))
    cots["d_sf"][:, units + 1:] = 0
    d_rgb = torch.zeros((points, trm.D_HEAD), dtype=torch.bfloat16)
    d_rgb[:, :3] = torch.from_numpy(rng.standard_normal((points, 3),
                                                        dtype=np.float32))
    cots["d_rgb"] = d_rgb
    return packed, stash, cots


def _shapes(units=256, n_layers=8, skip=4):
    packed, stash, cots = _inputs(1, units, n_layers, skip)
    tasks = trm.weight_grad_tasks(stash, cots, trm.zero_grads(packed))
    return [(a.shape[1], g.shape[1], b is not None) for a, g, _, b in tasks]


# (units, layers, skip, points): the training launches of a 2048-ray chunk
# (coarse 64, fine 192 samples), a sub-launch, ragged counts below and past
# a stage, and the wider MLP whose d_sf is 528 wide.
CASES = [(256, 8, 4, 2048 * 64), (256, 8, 4, 2048 * 192),
         (256, 8, 4, 1 << 20), (256, 8, 4, 50), (256, 8, 4, 64),
         (256, 8, 4, 8192 + 17), (256, 3, 1, 32768), (512, 8, 4, 4096 + 1),
         (512, 8, 4, 300_000)]


@pytest.mark.parametrize("units,n_layers,skip,points", CASES)
def test_plan_covers_every_output_once_per_slice(units, n_layers, skip,
                                                 points):
    shapes = _shapes(units, n_layers, skip)
    plan = trm.weight_grad_plan(shapes, points)
    cover = [np.zeros((k, n), np.int32) for k, n, _ in shapes]
    for task, m0, n0, nt in plan["tiles"]:
        assert m0 % trm.WG_TILE_K == 0 and n0 % 64 == 0
        assert nt in (64, 128, 256)
        cover[task][m0:m0 + trm.WG_TILE_K, n0:n0 + nt] += 1
    for j, c in enumerate(cover):
        assert c.shape == (shapes[j][0], shapes[j][1])
        assert (c == 1).all(), f"task {j}"
    assert len(plan["tiles"]) <= trm.MAX_WG_TILES


@pytest.mark.parametrize("units,n_layers,skip,points", CASES)
def test_plan_slices_split_the_points_in_order(units, n_layers, skip,
                                               points):
    plan = trm.weight_grad_plan(_shapes(units, n_layers, skip), points)
    bounds = plan["bounds"]
    assert len(bounds) == plan["slices"] >= 1
    assert plan["chunk"] % trm.WG_STEP == 0
    assert bounds[0][0] == 0 and bounds[-1][1] == points
    for (b0, e0), (b1, _) in zip(bounds, bounds[1:]):
        assert e0 == b1 and e0 - b0 == plan["chunk"]
    for b, e in bounds:
        assert b % trm.WG_STEP == 0 and e > b
    # Few enough slices that each holds a run of stages, enough blocks to
    # fill the card's waves when the points allow it.
    steps = -(-points // trm.WG_STEP)
    assert plan["slices"] == 1 or steps // plan["slices"] >= \
        trm.WG_MIN_STEPS
    assert len(plan["tiles"]) * plan["slices"] <= \
        trm.WG_WAVES * trm.WG_SMS + len(plan["tiles"])


@pytest.mark.parametrize("units,n_layers,skip,points", CASES)
def test_plan_partial_offsets_do_not_overlap(units, n_layers, skip, points):
    shapes = _shapes(units, n_layers, skip)
    plan = trm.weight_grad_plan(shapes, points)
    s = plan["slices"]
    spans = []
    for (k, n, bias), po, bo in zip(shapes, plan["poff"], plan["bpoff"]):
        spans.append((po, po + s * k * n))
        if bias:
            spans.append((bo, bo + s * n))
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == plan["partial_floats"]
    for (_, e0), (b1, _) in zip(spans, spans[1:]):
        assert e0 == b1


def test_plan_is_a_function_of_the_shapes_alone():
    shapes = _shapes()
    a = trm.weight_grad_plan(shapes, 2048 * 192)
    b = trm.weight_grad_plan([tuple(x) for x in shapes], 2048 * 192)
    assert a == b
    # Other values, the same shapes: the same tasks and plan.
    _, s1, c1 = _inputs(96, seed=1)
    packed, s2, c2 = _inputs(96, seed=2)
    t1 = trm.weight_grad_tasks(s1, c1, trm.zero_grads(packed))
    t2 = trm.weight_grad_tasks(s2, c2, trm.zero_grads(packed))
    sh1 = [(x.shape[1], g.shape[1], bb is not None) for x, g, _, bb in t1]
    sh2 = [(x.shape[1], g.shape[1], bb is not None) for x, g, _, bb in t2]
    assert sh1 == sh2
    assert trm.weight_grad_plan(sh1, 96) == trm.weight_grad_plan(sh2, 96)


def test_plan_rejects_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        trm.weight_grad_plan([(96, 256, True)], 1000)
    with pytest.raises(ValueError):
        trm.weight_grad_plan([(128, 24, False)], 1000)


def _emulate(stash, cots, grads):
    """The kernel's sums over its plan: per slice and block, float32
    products of the bf16 operands over the block's rows and columns (TMA's
    zeros past P and N add nothing), stored at the plan's offsets; then the
    slices added in slice order into ``grads``."""
    tasks = trm.weight_grad_tasks(stash, cots, grads)
    p = stash["enc"].shape[0]
    shapes = [(a.shape[1], g.shape[1], b is not None) for a, g, _, b in tasks]
    plan = trm.weight_grad_plan(shapes, p)
    partial = torch.full((plan["partial_floats"],), float("nan"))
    for s, (p0, p1) in enumerate(plan["bounds"]):
        for j, m0, n0, nt in plan["tiles"]:
            a, g, _, bias = tasks[j]
            k, n = a.shape[1], g.shape[1]
            n1 = min(n, n0 + nt)
            a_t = a[p0:p1, m0:m0 + trm.WG_TILE_K].float()
            g_t = g[p0:p1, n0:n1].float()
            out = partial[plan["poff"][j] + s * k * n:][:k * n].view(k, n)
            out[m0:m0 + trm.WG_TILE_K, n0:n1] = a_t.T @ g_t
            if bias is not None and m0 == 0:
                partial[plan["bpoff"][j] + s * n + n0:][:n1 - n0] = \
                    g_t.sum(0)
    for j, (a, g, out, bias) in enumerate(tasks):
        k, n = a.shape[1], g.shape[1]
        acc = torch.zeros(k * n)
        bacc = torch.zeros(n)
        for s in range(plan["slices"]):
            acc += partial[plan["poff"][j] + s * k * n:][:k * n]
            if bias is not None:
                bacc += partial[plan["bpoff"][j] + s * n:][:n]
        out[:, :n] += acc.view(k, n)
        if bias is not None:
            bias[0, :n] += bacc
    return grads


@pytest.mark.parametrize("units,points", [(256, 50), (256, 2 * 1024 + 17),
                                          (512, 1100)])
def test_emulated_plan_sums_match_the_plain_version(units, points):
    torch.backends.cuda.matmul.allow_tf32 = False
    packed, stash, cots = _inputs(points, units)
    got = _emulate(stash, cots, trm.zero_grads(packed))
    want = trm.mlp_weight_grad_plain(stash, cots, trm.zero_grads(packed))
    plan = trm.weight_grad_plan(
        [(a.shape[1], g.shape[1], b is not None) for a, g, _, b in
         trm.weight_grad_tasks(stash, cots, want)], points)
    if points > trm.WG_STEP * trm.WG_MIN_STEPS * 2:
        assert plan["slices"] > 1
    for key in want:
        gs = got[key] if isinstance(got[key], list) else [got[key]]
        ws = want[key] if isinstance(want[key], list) else [want[key]]
        for x, y in zip(gs, ws):
            if y is None:
                assert x is None
                continue
            assert torch.isfinite(x).all(), key
            rel = float((x - y).norm() / y.norm().clamp_min(1e-30))
            assert rel <= 1e-6, (key, rel)
