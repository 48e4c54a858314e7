"""The port's data parallelism (``keras_nerf_tpu_torch.parallel``) against
the JAX package's ``shard_map`` steps, on the CPU.

JAX's sharded functions run on the 2- and 4-device meshes of the fake CPU
devices that ``tests/conftest.py`` sets up; the port's ranks run as
threads of this process, each with its own ``ProcessGroupGloo`` over one
``HashStore`` (every group has a 60 s timeout and every thread is joined
with one, so a rank that raises fails the test instead of hanging it).
Rank ``i`` is fed the draws of JAX's ``fold_in(key, i)``, split per chunk
as JAX's step splits them. Budgets:

* reference path against JAX's XLA step: losses rtol 1e-5, gradients (the
  SGD lr 1 parameter change) relative max 1e-4 per leaf
  (`tests/test_torch_train.py`);
* kernel path (the plain versions) against JAX's fused step, its Pallas
  kernels in interpret mode inside ``shard_map`` itself: losses rtol 0.03, gradients relative norm 0.03
  and relative max 0.12 per leaf (the T3 budgets);
* evaluation metrics: relative 1e-4;
* renders on the reference path: images atol 1e-5 (`test_data_parallel.py`),
  depths atol 1e-4 (`test_data_parallel.py:test_sharded_render_fast_tiers`).

The reference path's cases take the encoding of JAX's own data-parallel
tests (``pos_emb_xyz`` 4, ``pos_emb_dir`` 2): the fine pass's depths carry
the CDF's float32 rounding (ROADMAP C13, within 254 ulp of JAX's), and at
10 frequencies the first layer's encoding multiplies a depth's error by
2^9. One unsharded reference step of a 2 x 8 x 8 batch through a ball
differs from JAX's by up to 6.6e-3 relative in the fine first layer's
gradient at 10 frequencies, which no sharded step can undercut.
:func:`test_sharded_step_is_the_mean_of_the_shards_steps` holds the
sharding itself at 10 frequencies, on such rays, against the port's own
unsharded steps.

Run with ``-s`` to see each reading beside its budget.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import datetime
import threading
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from keras_nerf_tpu.models import NeRF as JaxNeRF
from keras_nerf_tpu.models import engine as jengine
from keras_nerf_tpu.ops import occupancy as jocc
from keras_nerf_tpu.ops.sampling import sorted_uniforms as jax_sorted_uniforms
from keras_nerf_tpu import parallel as jdp
from keras_nerf_tpu_torch import parallel as tdp
from keras_nerf_tpu_torch.models import NeRF
from keras_nerf_tpu_torch.models import engine as tengine
from keras_nerf_tpu_torch.ops import occupancy as tocc
from keras_nerf_tpu_torch.utils.convert import params_from_jax, params_to_jax

pytestmark = pytest.mark.skipif(
    jax.device_count() < 4, reason="needs 4 (fake) JAX devices")

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_TIMEOUT = 120.0
CHUNK = 16
LOSS_RTOL_REF, GRAD_REL_MAX_REF = 1e-5, 1e-4
GRAD_REL_NORM, GRAD_REL_MAX, LOSS_RTOL = 0.03, 0.12, 0.03
RENDER_ATOL = {"image": 1e-5, "depth": 1e-4, "weights": 1e-5}
NEAR, FAR = 2.0, 6.0


def run_in_threads(n: int, fn):
    """``fn(group)`` on ``n`` thread ranks of one gloo group; the results
    in rank order. Re-raises the first rank's exception."""
    store = dist.PrefixStore(uuid.uuid4().hex, dist.HashStore())
    results, errors = [None] * n, [None] * n

    def body(rank):
        try:
            group = tdp.make_group(n, "gloo", rank, store, device="cpu",
                                   timeout=GROUP_TIMEOUT)
            try:
                results[rank] = fn(group)
            finally:
                group.close()
        except BaseException as e:   # re-raised below, in the test thread
            errors[rank] = e

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    for e in errors:
        if e is not None:
            raise e
    return results


def _report(what, reading, budget):
    print(f"\n{what}: {reading:.3e} (budget {budget:g})")
    assert reading <= budget, what


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12),
            np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _assert_grads(label, got, want, rel_norm, rel_max):
    worst = (0.0, 0.0)
    for model, a, b in zip(("coarse", "fine"), got, want):
        for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(b),
                                jax.tree.leaves(a)):
            rn, rm = _rel(y, x)
            assert rn <= rel_norm and rm <= rel_max, (
                label, model, jax.tree_util.keystr(path), rn, rm)
            worst = (max(worst[0], rn), max(worst[1], rm))
    _report(f"{label}: worst leaf relative norm", worst[0], rel_norm)
    _report(f"{label}: worst leaf relative max", worst[1], rel_max)


def _jcfg(use_pallas, units=64, n_layers=3, skip=2):
    enc = {} if use_pallas else dict(pos_emb_xyz=4, pos_emb_dir=2)
    return jengine.NeRFConfig(
        n_coarse=8, n_fine=8, n_layers=n_layers, dense_units=units,
        skip_layer=skip, white_background=True, **enc,
        compute_dtype="bfloat16" if use_pallas else "float32",
        use_pallas=use_pallas)


def _port_cfg(jcfg):
    return tengine.NeRFConfig(**jcfg.to_model_config(),
                              white_background=jcfg.white_background,
                              use_kernels=bool(jcfg.use_pallas))


def _batch(b, h, w, n_coarse, seed=0, ball=False):
    """Rays from (0, 0, 4) in random directions, or with ``ball`` from near
    it looking down -z, most through the occupancy cases' ball."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, h, w, 4)).astype(np.float32)
    o = np.zeros((b, h, w, 3), np.float32)
    o[..., 2] = 4.0
    if ball:
        o[..., :2] += rng.uniform(-0.5, 0.5, (b, h, w, 2)).astype(np.float32)
        d = np.float32([0.0, 0.0, -1.0]) + rng.normal(0, 0.35, (b, h, w, 3))
    else:
        d = rng.normal(size=(b, h, w, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = np.sort(rng.uniform(NEAR, FAR, (b, h, w, n_coarse)), -1).astype(
        np.float32)
    return images, (o, d, t)


def _rank_draws(key, rank, n_chunks, n, fold=None):
    """Rank ``rank``'s per-chunk draws: JAX's ``fold_in(key, rank)`` split
    per chunk (and folded once more with ``fold`` in the occupancy
    step)."""
    keys = jax.random.split(jax.random.fold_in(key, rank), n_chunks)
    if fold is not None:
        keys = [jax.random.fold_in(k, fold) for k in keys]
    return [np.array(jax_sorted_uniforms(k, (CHUNK,), n)) for k in keys]


def _port_state(s0, opt):
    p = [params_from_jax(jax.tree.map(np.asarray, x), "cpu")
         for x in (s0.coarse_params, s0.fine_params)]
    return tengine.TrainState(p[0], p[1], opt.init(p[0]), opt.init(p[1]), 0)


def _clone(state):
    return tengine.TrainState(*(tengine.tree_map(
        lambda x: x.clone() if torch.is_tensor(x) else x, part)
        for part in state[:4]), state.step)


def _grads(s0, s1, tree=lambda p: p):
    return [jax.tree.map(lambda a, b: np.asarray(a, np.float64)
                         - np.asarray(b, np.float64), tree(p), tree(q))
            for p, q in ((s0.coarse_params, s1.coarse_params),
                         (s0.fine_params, s1.fine_params))]


def _torch_batch(images, rays):
    return torch.as_tensor(images), tuple(torch.as_tensor(x) for x in rays)


def _sharded_steps(jcfg, world, shard_rays, b, h, w, loss_fn=None,
                   occupancy=None, grid=None, seed=0):
    """One SGD (lr 1) step of JAX's ``sharded_train_step`` on a ``world``
    mesh and of the port's on ``world`` thread ranks, from the same state,
    global batch and per-rank draws: ``(jax metrics, port metrics of every
    rank, jax grads, port grads of rank 0)``."""
    opt_j = jengine.make_optimizer("sgd", 1.0)
    s0 = jengine.init_train_state(jax.random.PRNGKey(seed), jcfg, opt_j)
    images, rays = _batch(b, h, w, jcfg.n_coarse, seed=seed + 1,
                          ball=occupancy is not None)
    key = jax.random.PRNGKey(5)
    mesh = jdp.make_mesh(world)
    step = jax.jit(jdp.sharded_train_step(
        mesh, opt_j, jcfg, ray_chunks=CHUNK, occupancy=occupancy,
        loss_fn=loss_fn[0] if loss_fn else None, shard_rays=shard_rays))
    args = (jdp.replicate(s0, mesh), jdp.shard_batch(
        (jnp.asarray(images), tuple(map(jnp.asarray, rays))), mesh,
        shard_rays), key)
    if occupancy is not None:
        args += (jdp.replicate(jnp.asarray(grid), mesh),)
    s1, m_j = step(*args)
    rays_per_rank = b * h * w // world
    n_draw = jcfg.n_fine if occupancy is None else occupancy[0]
    draws = [_rank_draws(key, r, rays_per_rank // CHUNK, n_draw,
                         fold=None if occupancy is None else 7)
             for r in range(world)]
    opt_t = tengine.make_optimizer("sgd", 1.0)
    t0 = _port_state(s0, opt_t)
    cfg = _port_cfg(jcfg)

    def rank_step(group):
        state = tdp.replicate(_clone(t0), group)
        share = tdp.shard_batch(_torch_batch(images, rays), group,
                                shard_rays)
        step_t = tdp.sharded_train_step(
            group, opt_t, cfg, CHUNK, loss_fn=loss_fn[1] if loss_fn else None,
            occupancy=occupancy)
        kw = {} if grid is None else {"occ_grid": torch.as_tensor(grid)}
        return step_t(state, share, [torch.as_tensor(u) for u in
                                     draws[group.rank]], **kw)

    outs = run_in_threads(world, rank_step)
    for state, _ in outs[1:]:
        for a, c in zip(tengine.tree_leaves(state[:2]),
                        tengine.tree_leaves(outs[0][0][:2])):
            assert torch.equal(a, c), "the ranks' states differ"
    metrics = [{k: float(v) for k, v in m.items()} for _, m in outs]
    return (m_j, metrics, _grads(s0, s1),
            _grads(t0, outs[0][0], params_to_jax))


def _check_step(m_j, m_t, g_j, g_t, label, loss_rtol, rel_norm, rel_max):
    for m in m_t[1:]:
        assert m == m_t[0], "the ranks' metrics differ"
    for k in ("coarse_loss", "fine_loss"):
        _report(f"{label} {k}, relative", abs(m_t[0][k] - float(m_j[k]))
                / abs(float(m_j[k])), loss_rtol)
    _assert_grads(label, g_t, g_j, rel_norm, rel_max)
    assert set(m_t[0]) == set(m_j)


@pytest.mark.parametrize("world,shard_rays", [(2, False), (4, False),
                                              (2, True), (4, True)])
def test_reference_step_matches_jax_sharded_step(world, shard_rays):
    """The float32 reference path against JAX's XLA ``sharded_train_step``
    (batch-sharded: one 8 x 8 image a rank; ``shard_rays``: height bands of
    one 16 x 8 image)."""
    b, h = (world, 8) if not shard_rays else (1, 16)
    m_j, m_t, g_j, g_t = _sharded_steps(_jcfg(False), world, shard_rays,
                                        b, h, 8)
    _check_step(m_j, m_t, g_j, g_t, f"reference step, {world} ranks, "
                f"shard_rays {shard_rays}", LOSS_RTOL_REF, np.inf,
                GRAD_REL_MAX_REF)


@pytest.mark.parametrize("shard_rays", [False, True])
def test_kernel_step_matches_jax_fused_sharded_step(shard_rays):
    """The kernel path (the plain versions of T3) against JAX's fused step
    (its Pallas kernels in interpret mode) under ``shard_map``, 2 ranks."""
    jcfg = _jcfg(True, units=256, n_layers=2, skip=4)
    b, h = (2, 4) if not shard_rays else (1, 8)
    m_j, m_t, g_j, g_t = _sharded_steps(jcfg, 2, shard_rays, b, h, 4)
    _check_step(m_j, m_t, g_j, g_t, f"kernel step, 2 ranks, shard_rays "
                f"{shard_rays}", LOSS_RTOL, GRAD_REL_NORM, GRAD_REL_MAX)


def test_l1_step_under_a_group_matches_jax():
    """A callable loss (L1) under a group: the port's autograd through the
    kernel path's plain versions (T5, T6) against JAX's sharded step
    through its kernels in interpret mode, 2 ranks."""
    jcfg = _jcfg(True, units=256, n_layers=2, skip=4)
    loss = (lambda y, p: jnp.mean(jnp.abs(p - y)),
            lambda y, p: torch.mean(torch.abs(p - y)))
    m_j, m_t, g_j, g_t = _sharded_steps(jcfg, 2, False, 2, 4, 4,
                                        loss_fn=loss)
    _check_step(m_j, m_t, g_j, g_t, "l1 step, 2 ranks", LOSS_RTOL,
                GRAD_REL_NORM, GRAD_REL_MAX)


def test_sharded_step_is_the_mean_of_the_shards_steps():
    """The sharding itself at the kernels' encoding (10 and 4 frequencies),
    on rays through a ball, reference path: the 2-rank step's parameter
    change is the mean of the two shards' unsharded steps' (SGD, lr 1),
    fed each rank's draws, up to float32 rounding."""
    cfg = tengine.NeRFConfig(n_coarse=8, n_fine=8, n_layers=3, dense_units=64,
                             skip_layer=2, white_background=True,
                             use_kernels=False)
    opt = tengine.make_optimizer("sgd", 1.0)
    t0 = tengine.init_train_state(torch.Generator().manual_seed(0), cfg, opt)
    images, rays = _batch(2, 8, 8, 8, seed=1, ball=True)
    batch = _torch_batch(images, rays)
    draws = [[torch.sort(torch.rand(CHUNK, 8, generator=torch.Generator()
                                    .manual_seed(10 * r + i)), -1).values
              for i in range(4)] for r in range(2)]

    def rank_step(group):
        share = tdp.shard_batch(batch, group)
        return tdp.sharded_train_step(group, opt, cfg, CHUNK)(
            _clone(t0), share, draws[group.rank])[0]

    got = run_in_threads(2, rank_step)[0]
    solo = [tengine.train_step(_clone(t0), tuple(
        (x[r:r + 1] if i == 0 else tuple(y[r:r + 1] for y in x))
        for i, x in enumerate(batch)), draws[r], opt, cfg, CHUNK)[0]
        for r in range(2)]
    worst = 0.0
    for p0, p, q0, q1 in zip(tengine.tree_leaves(t0[:2]),
                             tengine.tree_leaves(got[:2]),
                             tengine.tree_leaves(solo[0][:2]),
                             tengine.tree_leaves(solo[1][:2])):
        want = ((p0 - q0) + (p0 - q1)).double() / 2
        worst = max(worst, _rel((p0 - p).double().numpy(), want.numpy())[1])
    _report("sharded step against the mean of the shards' steps, worst "
            "leaf relative max", worst, 1e-5)


def _grid(g=16, radius=1.2, seed=0):
    c = (np.arange(g) + 0.5) / g * 4.0 - 2.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    occ = (x * x + y * y + z * z < radius * radius).astype(np.float32)
    holes = np.random.default_rng(seed).uniform(size=occ.shape) < 0.3
    return np.where(holes, 0.0, occ).astype(np.float32)


def test_occupancy_step_under_a_group_matches_jax():
    """The occupancy-train step (merged) under a group, reference path,
    against JAX's sharded occupancy step with the grid replicated."""
    spec = (8, 16, NEAR, FAR, jocc.DEFAULT_AABB, True)
    m_j, m_t, g_j, g_t = _sharded_steps(_jcfg(False), 2, False, 2, 8, 8,
                                        occupancy=spec, grid=_grid())
    _check_step(m_j, m_t, g_j, g_t, "occupancy step, 2 ranks",
                LOSS_RTOL_REF, np.inf, GRAD_REL_MAX_REF)


@pytest.mark.parametrize("shard_rays", [False, True])
def test_eval_step_matches_jax_sharded_eval(shard_rays):
    """Batch-sharded: the mean of the ranks' metrics; ``shard_rays``: the
    bands gathered into whole images before PSNR and SSIM."""
    jcfg = _jcfg(False)
    s0 = jengine.init_train_state(jax.random.PRNGKey(3), jcfg,
                                  jengine.make_optimizer("sgd", 1.0))
    b, h, w = (2, 8, 8) if not shard_rays else (1, 16, 8)
    images, rays = _batch(b, h, w, jcfg.n_coarse, seed=4)
    key = jax.random.PRNGKey(6)
    mesh = jdp.make_mesh(2)
    m_j = jax.jit(jdp.sharded_eval_step(mesh, jcfg, CHUNK,
                                        shard_rays=shard_rays))(
        jdp.replicate(s0, mesh), jdp.shard_batch(
            (jnp.asarray(images), tuple(map(jnp.asarray, rays))), mesh,
            shard_rays), key)
    t0 = _port_state(s0, tengine.make_optimizer("sgd", 1.0))
    n_chunks = b * h * w // 2 // CHUNK

    def rank_eval(group):
        share = tdp.shard_batch(_torch_batch(images, rays), group,
                                shard_rays)
        draws = [torch.as_tensor(u) for u in
                 _rank_draws(key, group.rank, n_chunks, jcfg.n_fine)]
        return tdp.sharded_eval_step(group, _port_cfg(jcfg), CHUNK,
                                     shard_rays=shard_rays)(t0, share, draws)

    outs = run_in_threads(2, rank_eval)
    assert set(outs[0]) == set(m_j)
    for k in m_j:
        _report(f"eval {k}, shard_rays {shard_rays}, relative",
                abs(float(outs[0][k]) - float(m_j[k]))
                / max(abs(float(m_j[k])), 1e-12), 1e-4)
        assert float(outs[0][k]) == float(outs[1][k])


def test_sharded_render_bands_match_jax():
    """``sharded_render`` (height bands, all-gathered) against JAX's, batch
    1, on 2 and 4 ranks."""
    jcfg = _jcfg(False)
    coarse, fine = jengine.init_params(jax.random.PRNGKey(0), jcfg)
    _, rays = _batch(1, 16, 8, jcfg.n_coarse, seed=7)
    key = jax.random.PRNGKey(3)
    pc, pf = (params_from_jax(jax.tree.map(np.asarray, p), "cpu")
              for p in (coarse, fine))
    for world in (2, 4):
        mesh = jdp.make_mesh(world)
        want_c, want_f = jax.jit(jdp.sharded_render(mesh, jcfg, CHUNK))(
            coarse, fine, tuple(map(jnp.asarray, rays)), key)
        n_chunks = 16 * 8 // world // CHUNK

        def rank_render(group):
            draws = [torch.as_tensor(u) for u in _rank_draws(
                key, group.rank, n_chunks, jcfg.n_fine)]
            return tdp.sharded_render(group, _port_cfg(jcfg), CHUNK)(
                pc, pf, tuple(map(torch.as_tensor, rays)), draws)

        outs = run_in_threads(world, rank_render)
        for got, want in zip(outs[0], (want_c, want_f)):
            assert set(got) == set(want)
            for k in want:
                assert got[k].shape == want[k].shape
                _report(f"render {k}, {world} ranks, max abs", float(
                    np.abs(got[k].numpy() - np.asarray(want[k])).max()),
                    RENDER_ATOL[k])
        assert torch.equal(outs[0][1]["image"], outs[-1][1]["image"])


def test_sharded_render_occ_bands_match_jax():
    jcfg = _jcfg(False)
    _, fine = jengine.init_params(jax.random.PRNGKey(1), jcfg)
    _, rays = _batch(1, 16, 8, jcfg.n_coarse, seed=8, ball=True)
    key = jax.random.PRNGKey(9)
    grid = _grid()
    mesh = jdp.make_mesh(2)
    want = jax.jit(jdp.sharded_render_occ(mesh, jcfg, CHUNK, n_samples=8,
                                          n_probe=16))(
        fine, tuple(map(jnp.asarray, rays)), jnp.asarray(grid), key)
    pf = params_from_jax(jax.tree.map(np.asarray, fine), "cpu")

    def rank_render(group):
        draws = [torch.as_tensor(u) for u in _rank_draws(
            key, group.rank, 16 * 8 // 2 // CHUNK, 8)]
        return tdp.sharded_render_occ(group, _port_cfg(jcfg), CHUNK,
                                      n_samples=8, n_probe=16)(
            pf, tuple(map(torch.as_tensor, rays)), torch.as_tensor(grid),
            draws)

    got = run_in_threads(2, rank_render)[0]
    assert float(got["image"].std()) > 0.01
    for k in ("image", "depth"):
        _report(f"occupancy render {k}, max abs", float(np.abs(
            got[k].numpy() - np.asarray(want[k])).max()), RENDER_ATOL[k])


def test_replicate_broadcasts_rank_0_and_shard_batch_splits():
    def body(group):
        tree = {"a": torch.full((3,), float(group.rank)),
                "b": [torch.arange(4).reshape(2, 2).t() * (group.rank + 1)],
                "n": group.rank}
        tdp.replicate(tree, group)
        images = torch.arange(4 * 6 * 2 * 4, dtype=torch.float32).reshape(
            4, 6, 2, 4)
        rays = (images[..., :3], images[..., :3], images)
        by_batch = tdp.shard_batch((images, rays), group)
        by_band = tdp.shard_batch((images, rays), group, shard_rays=True)
        return tree, by_batch, by_band

    outs = run_in_threads(2, body)
    for r, (tree, by_batch, by_band) in enumerate(outs):
        assert torch.equal(tree["a"], torch.zeros(3))
        assert torch.equal(tree["b"][0], torch.arange(4).reshape(2, 2).t())
        assert tree["n"] == r          # not a tensor: left as it is
        assert by_batch[0].shape == (2, 6, 2, 4)
        assert by_batch[0][0, 0, 0, 0] == r * 2 * 6 * 2 * 4
        assert by_band[0].shape == (4, 3, 2, 4)
        assert by_band[0][0, 0, 0, 0] == r * 3 * 2 * 4


def test_make_group_refusals_match_jax():
    with pytest.raises(ValueError, match="do not divide into 3 slices") as e:
        tdp.make_group(4, "gloo", 0, n_slices=3)
    with pytest.raises(ValueError) as theirs:
        jdp.make_mesh(4, n_slices=3)
    assert str(e.value) == str(theirs.value)
    with pytest.raises(ValueError, match="device\\(s\\) are available"):
        jdp.make_mesh(jax.device_count() + 1)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="device\\(s\\) are available"):
            tdp.make_group(1, None, 0, device="cuda")
        with pytest.raises(ValueError, match="card\\(s\\) are visible"):
            tdp.world_size(1, "cuda")
    with pytest.raises(ValueError, match="rank 2 outside"):
        tdp.make_group(2, "gloo", 2)
    with pytest.raises(ValueError, match="backend"):
        tdp.make_group(1, "mpi", 0)
    with pytest.raises(ValueError, match="NCCL backend needs CUDA"):
        tdp.make_group(1, "nccl", 0, device="cpu")
    assert tdp.world_size(0, "cpu") == 1 and tdp.world_size(3, "cpu") == 3
    one = tdp.make_group(1)
    assert (one.rank, one.size, one.backend) == (0, 1, "gloo")
    t = torch.arange(3.0)
    assert torch.equal(one.all_reduce_(t), torch.arange(3.0))
    assert torch.equal(one.all_gather(t, 0), t)
    one.close()


TINY = dict(n_coarse=8, n_fine=8, pos_emb_xyz=4, pos_emb_dir=2, n_layers=2,
            dense_units=16, skip_layer=1)


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, image_height=8, shard_rays=True, pixel_sampling=True),
    dict(batch_size=1, image_height=9, shard_rays=True),
    dict(batch_size=3, image_height=8),
    dict(batch_size=2, image_height=8, occupancy_train=8,
         occupancy_train_cache=True),
])
def test_compile_refusals_match_jax_by_message(kw):
    """JAX's four refusals under a mesh (`nerf.py:132-158,236-240`) and the
    port's under a group, message for message."""
    kw = dict(kw, image_width=8, ray_chunks=16)
    with pytest.raises(ValueError) as theirs:
        JaxNeRF(**TINY).compile(mesh=jdp.make_mesh(2), **kw)
    # A group is never reached by a refused compile: no peer is needed.
    group = tdp.Group(None, 0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError) as port:
        NeRF(**TINY).compile(device="cpu", group=group, **kw)
    assert str(port.value) == str(theirs.value)


def test_nerf_compile_under_a_group_renders_in_bands():
    """``NeRF.compile(group=)``: the state broadcast from rank 0 (rank 1
    starts from other weights), ``predict_and_render_images`` and
    ``render_occupancy`` in bands gathered whole on every rank, equal to
    one rank's render fed the same draws; the bake broadcast."""
    rays = tuple(torch.as_tensor(x) for x in _batch(1, 16, 8, 8, seed=2)[1])

    def draws(rank, n, n_chunks):
        g = torch.Generator().manual_seed(100 + rank)
        return [torch.sort(torch.rand(CHUNK, n, generator=g), -1).values
                for _ in range(n_chunks)]

    def body(group):
        model = NeRF(**TINY).compile(
            batch_size=1, image_height=16, image_width=8, ray_chunks=CHUNK,
            is_training=False, device="cpu", seed=group.rank,
            use_kernels=False, group=group)
        _, fine = model.predict_and_render_images(
            rays, fine_draws=draws(group.rank, 8, 4))
        model.bake_occupancy(grid_size=8, sigma_threshold=0.0)
        occ = model.render_occupancy(rays, fine_draws=draws(group.rank, 8, 4),
                                     n_samples=8, n_probe=8)
        return model, fine, occ

    outs = run_in_threads(2, body)
    model = outs[0][0]
    solo = NeRF(**TINY).compile(batch_size=1, image_height=16, image_width=8,
                                ray_chunks=CHUNK, is_training=False,
                                device="cpu", seed=0, use_kernels=False)
    assert solo.ray_chunks == CHUNK and model.ray_chunks == CHUNK
    _, fine = solo.predict_and_render_images(
        rays, fine_draws=draws(0, 8, 4) + draws(1, 8, 4))
    solo.bake_occupancy(grid_size=8, sigma_threshold=0.0)
    occ = solo.render_occupancy(rays, fine_draws=draws(0, 8, 4)
                                + draws(1, 8, 4), n_samples=8, n_probe=8)
    for _, got_f, got_occ in outs:
        assert torch.equal(got_f["image"], fine["image"])
        assert torch.equal(got_occ["image"], occ["image"])
    assert torch.equal(outs[1][0].occ_grid, solo.occ_grid)
    assert outs[1][0].is_chief is False and model.is_chief


def test_eval_of_a_batch_the_ranks_do_not_divide_runs_whole():
    """``NeRF.evaluate`` under a 2-rank group of 3-image batches, which the
    ranks do not divide: each rank evaluates the whole batch with the
    ungrouped model's draws (`nerf.py:321-329,480-486`), so every rank
    reads the ungrouped model's metrics; a batch they divide is sharded
    and averaged over the ranks."""
    def batches(b):
        return [_torch_batch(*_batch(b, 4, 8, 8, seed=12))]

    kw = dict(batch_size=2, image_height=4, image_width=8, ray_chunks=CHUNK,
              device="cpu", seed=5, use_kernels=False)
    solo = NeRF(**TINY).compile(**kw)
    want = solo.evaluate(batches(3))

    def body(group):
        model = NeRF(**TINY).compile(group=group, **kw)
        return model.evaluate(batches(3)), model.evaluate(batches(2))

    outs = run_in_threads(2, body)
    for whole, sharded in outs:
        assert whole == want
        assert sharded == outs[0][1]
        assert all(np.isfinite(v) for v in sharded.values())


def test_loader_sharding_keeps_global_batches_the_model_shares(tmp_path):
    """``load_dataset(sharding=BatchSharding(group, shard_rays))``: every
    rank loads the global batch the ungrouped loader draws (the same order
    and jitter on every rank), and ``shard_batch`` takes the rank's share
    of it, by batch or by height band, as a grouped ``NeRF`` does; a
    sharding of another kind (JAX's) is refused."""
    from keras_nerf_tpu_torch.data import DatasetLoader
    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

    scene = write_synthetic_scene(str(tmp_path), image_wh=8, n_train=2,
                                  n_val=1, n_test=1)
    loader = DatasetLoader(scene, device="cpu")
    with pytest.raises(NotImplementedError, match="BatchSharding"):
        loader.load_dataset(1, 8, 8, 2.0, 6.0, 4,
                            sharding=jdp.batch_sharding(jdp.make_mesh(2)))
    whole = next(iter(loader.load_dataset(2, 8, 8, 2.0, 6.0, 4)[0]))
    for rank in range(2):
        group = tdp.Group(None, rank, 2, torch.device("cpu"), "gloo")
        for shard_rays in (False, True):
            train = loader.load_dataset(
                2, 8, 8, 2.0, 6.0, 4,
                sharding=tdp.BatchSharding(group, shard_rays))[0]
            images, rays = next(iter(train))
            assert torch.equal(images, whole[0])
            for got_r, want_r in zip(rays, whole[1]):
                assert torch.equal(got_r, want_r)
            share = tdp.shard_batch((images, rays), group, shard_rays)
            assert share[0].shape == ((2, 4, 8, 4) if shard_rays
                                      else (1, 8, 8, 4))
            lo = 4 * rank if shard_rays else rank
            want = (images[:, lo:lo + 4] if shard_rays
                    else images[lo:lo + 1])
            assert torch.equal(share[0], want)
