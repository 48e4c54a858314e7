"""ROADMAP C15's emulation (``keras_nerf_tpu_torch/tpu_rays.py``) against
the JAX package on the CPU.

``tpu_default_rays`` is JAX's ``generate_rays`` with the rotation and the
camera vectors cast to ``jnp.bfloat16`` and the einsum's
``preferred_element_type=float32`` (what a DEFAULT-precision TPU dot does
with float32 operands), within ``ULP_BUDGET`` float32 ulps of each
component; the pixel error of such rays against exact float64 rays over
20 poses of the spheres fixture's orbit, printed with ``-s``, is the
0.165 px mean (0.155 median, 0.412 p99, 0.577 max) that C15's hypothesis
rests on. ``tpu_random_ray_batch`` (the pixel sampler's rays) is JAX's
``sample_random_ray_batch`` with its ``rij,rj->ri`` einsum so cast, within
the same budget, on the same draws. ``python -m keras_nerf_tpu_torch.tpu_rays
[train_single|aabb_demo] -- <flags>`` runs with these rays for the whole
run (whole images, pixel sampling, the occupancy probe-row cache) and puts
the defaults back after.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.data.rays import camera_plane_directions
from keras_nerf_tpu_torch import aabb_demo, tpu_rays
from keras_nerf_tpu_torch import train_single as port_cli
from keras_nerf_tpu_torch.data import loader
from keras_nerf_tpu_torch.data import rays as port_rays
from keras_nerf_tpu_torch.data.rays import (generate_ray_batch,
                                            sample_random_ray_batch)
from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene
from keras_nerf_tpu_torch.data.utils import get_focal_from_fov, pose_spherical
from keras_nerf_tpu_torch.ops.occupancy import (occupancy_along_rays,
                                                probe_rows_for_poses)

# The products of bf16 operands are exact in float32; what is left is the
# order of the two float32 additions and the norm's rounding.
ULP_BUDGET = 2
FOV = 0.6911112070083618   # the fixture's camera_angle_x
# C15's statistics (px), to the digits stated.
C15_STATS = {"mean": 0.165, "median": 0.155, "p99": 0.412, "max": 0.577}


def _fixture_poses(n=20, seed=0):
    """The first ``n`` train poses of the spheres fixture (its writer's
    draws, ``write_synthetic_scene(seed=0)``)."""
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        theta = float(rng.uniform(0.0, 360.0))
        phi = float(rng.uniform(-60.0, -10.0))
        poses.append(np.asarray(pose_spherical(theta, phi, 4.0), np.float32))
    return poses


def _error_px(c2w, h, w, focal):
    """``[H, W]`` angle, in pixels at ``focal``, between the rays of
    bfloat16 operands (summed in float64) and the exact float64 rays."""
    c2w = torch.as_tensor(c2w, dtype=torch.float64)
    cam = torch.as_tensor(np.array(camera_plane_directions(h, w, focal)),
                          dtype=torch.float64)
    exact = cam @ c2w[:3, :3].T
    rounded = (tpu_rays.bf16_round(cam.float()).double()
               @ tpu_rays.bf16_round(c2w[:3, :3].float()).double().T)
    exact = exact / exact.norm(dim=-1, keepdim=True)
    rounded = rounded / rounded.norm(dim=-1, keepdim=True)
    # acos loses digits near 1: the angle from the chord.
    chord = (exact - rounded).norm(dim=-1)
    return 2.0 * torch.asin(chord / 2.0) * focal


def _jax_tpu_rays(c2w, h, w, focal):
    cam = camera_plane_directions(h, w, focal)
    d = jnp.einsum("ij,hwj->hwi", jnp.asarray(c2w)[:3, :3].astype(
        jnp.bfloat16), cam.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32)
    return np.asarray(d / jnp.linalg.norm(d, axis=-1, keepdims=True))


def test_tpu_default_rays_match_jax_bf16_einsum():
    focal = get_focal_from_fov(FOV, 128)
    worst = 0.0
    errs = []
    for c2w in _fixture_poses():
        origin, got = tpu_rays.tpu_default_rays(torch.as_tensor(c2w), 128,
                                                128, focal)
        want = _jax_tpu_rays(c2w, 128, 128, focal)
        ulps = np.abs(got.numpy() - want) / np.spacing(np.abs(want))
        worst = max(worst, float(ulps.max()))
        np.testing.assert_array_equal(origin.numpy(),
                                      np.broadcast_to(c2w[:3, 3], want.shape))
        errs.append(_error_px(c2w, 128, 128, focal).numpy().ravel())
    e = np.concatenate(errs)
    stats = {"mean": e.mean(), "median": np.median(e),
             "p99": np.percentile(e, 99), "max": e.max()}
    print(f"\ntpu_default_rays against JAX's bf16 einsum, 20 poses x 128^2: "
          f"worst {worst:.1f} ulps (budget {ULP_BUDGET}); pixel error of "
          f"bf16 operands against exact rays: " + ", ".join(
              f"{k} {v:.4f} px" for k, v in stats.items()))
    assert worst <= ULP_BUDGET
    for k, v in C15_STATS.items():
        assert abs(stats[k] - v) <= 5e-4, (k, stats[k])


def test_tpu_ray_batch_keeps_the_default_draws():
    """Origins and depths are ``generate_ray_batch``'s bit for bit (the same
    generator draws), only the directions are rounded."""
    poses = np.stack(_fixture_poses(3))
    focal = get_focal_from_fov(FOV, 16)
    kw = dict(image_height=16, image_width=16, focal=focal, near=2.0,
              far=6.0, n_samples=8)
    o, d, t = tpu_rays.tpu_ray_batch(poses, torch.Generator().manual_seed(3),
                                     **kw)
    o2, d2, t2 = generate_ray_batch(poses, torch.Generator().manual_seed(3),
                                    **kw)
    assert torch.equal(o, o2) and torch.equal(t, t2)
    assert not torch.equal(d, d2)
    for i, c2w in enumerate(poses):
        np.testing.assert_array_equal(
            d[i].numpy(), tpu_rays.tpu_default_rays(c2w, 16, 16, focal)[1])


def test_cli_trains_with_tpu_rays_then_restores_the_loader(tmp_path,
                                                           monkeypatch):
    scene = write_synthetic_scene(str(tmp_path / "scene"), image_wh=16,
                                  n_train=2, n_val=1, n_test=1)
    calls = []
    batch = tpu_rays.tpu_ray_batch

    def counted(*args, **kwargs):
        calls.append(1)
        return batch(*args, **kwargs)

    monkeypatch.setattr(tpu_rays, "tpu_ray_batch", counted)
    default = loader.generate_ray_batch
    tpu_rays.main(["--", "--device", "cpu", "--data_dir", scene, "--img_wh",
                   "16", "--num_coarse_samples", "8", "--num_fine_samples",
                   "8", "--num_layers", "2", "--num_units", "16",
                   "--skip_layer", "1", "--white_bg", "--num_epochs", "1",
                   "--ray_chunks", "128", "--log_dir", str(tmp_path / "logs"),
                   "--model_dirs", str(tmp_path / "model")])
    assert loader.generate_ray_batch is default
    # Train (2), val (1), test (1), the monitor's batches: all TPU rays.
    assert len(calls) >= 4
    assert (tmp_path / "model" / "lego" / "fine.msgpack").exists()
    _assert_defaults_restored()


GENERATE_RAYS = port_rays.generate_rays


def _assert_defaults_restored():
    assert loader.generate_ray_batch is generate_ray_batch
    assert loader.sample_random_ray_batch is sample_random_ray_batch
    assert port_rays.generate_rays is GENERATE_RAYS


def _ulps(got, want):
    return float((np.abs(got - want) / np.spacing(np.abs(want))).max())


def test_tpu_random_ray_batch_matches_jax_bf16_einsum():
    """The pixel sampler's rays (`keras_nerf_tpu/data/rays.py:147`) over
    the 20 fixture poses, one 128^2 batch of draws: directions within
    ``ULP_BUDGET`` of JAX's einsum on bfloat16 operands, and the pixels,
    origins and depths the default sampler's bit for bit."""
    poses = np.stack(_fixture_poses())
    focal = get_focal_from_fov(FOV, 128)
    rng = np.random.default_rng(7)
    images = rng.uniform(size=(20, 128, 128, 4)).astype(np.float32)
    r = 128 * 128
    flat = rng.integers(0, 20 * r, size=r)
    points = np.sort(rng.uniform(2.0, 6.0, size=(r, 4)), axis=-1).astype(
        np.float32)
    kw = dict(batch=1, image_height=128, image_width=128, focal=focal,
              near=2.0, far=6.0, n_samples=4, flat=torch.as_tensor(flat),
              points=torch.as_tensor(points))
    args = (torch.as_tensor(images), torch.as_tensor(poses))
    pix, (o, d, t) = tpu_rays.tpu_random_ray_batch(*args, **kw)
    pix0, (o0, d0, t0) = sample_random_ray_batch(*args, **kw)
    assert torch.equal(pix, pix0) and torch.equal(o, o0)
    assert torch.equal(t, t0) and not torch.equal(d, d0)

    img, py, px = flat // r, (flat // 128) % 128, flat % 128
    cam = jnp.stack([(px.astype(np.float32) - 64.0) / focal,
                     -((py.astype(np.float32) - 64.0) / focal),
                     -jnp.ones(r, jnp.float32)], axis=-1)
    want = jnp.einsum("rij,rj->ri",
                      jnp.asarray(poses)[img][:, :3, :3].astype(jnp.bfloat16),
                      cam.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    want = np.asarray(want / jnp.linalg.norm(want, axis=-1, keepdims=True))
    worst = _ulps(d.reshape(r, 3).numpy(), want)
    print(f"\ntpu_random_ray_batch against JAX's bf16 einsum, 16384 "
          f"pixel-sampled rays over 20 poses: worst {worst:.1f} ulps "
          f"(budget {ULP_BUDGET})")
    assert worst <= ULP_BUDGET


def test_probe_rows_take_tpu_rays_inside_the_swap():
    """JAX's probe-row cache is made from its ``generate_rays``
    (`keras_nerf_tpu/ops/occupancy.py:197-203`), so on a TPU from the
    TPU's rays: inside ``swapped`` the port's rows are those of
    ``tpu_default_rays``, outside those of ``generate_rays``."""
    poses = np.stack(_fixture_poses(3))
    focal = get_focal_from_fov(FOV, 32)
    grid = (torch.rand((16, 16, 16), generator=torch.Generator()
                       .manual_seed(0)) < 0.5).float()
    kw = dict(image_height=32, image_width=32, near=2.0, far=6.0,
              n_probe=16)

    def rows_of(make_rays):
        out = []
        for c2w in poses:
            o, d = make_rays(torch.as_tensor(c2w), 32, 32, focal)
            out.append(occupancy_along_rays(o.reshape(-1, 3),
                                            d.reshape(-1, 3), grid, 2.0, 6.0,
                                            16)[1].to(torch.uint8))
        return torch.stack(out)

    with tpu_rays.swapped():
        inside = probe_rows_for_poses(poses, focal, grid, **kw)
    outside = probe_rows_for_poses(poses, focal, grid, **kw)
    _assert_defaults_restored()
    assert torch.equal(inside, rows_of(tpu_rays.tpu_default_rays))
    assert torch.equal(outside, rows_of(port_rays.generate_rays))
    assert not torch.equal(inside, outside)


def test_swapped_restores_the_defaults_after_an_error():
    with pytest.raises(RuntimeError, match="inside"):
        with tpu_rays.swapped():
            assert loader.sample_random_ray_batch is (
                tpu_rays.tpu_random_ray_batch)
            assert port_rays.generate_rays is tpu_rays.tpu_default_rays
            raise RuntimeError("inside")
    _assert_defaults_restored()


def test_cli_pixel_sampling_trains_with_tpu_rays(tmp_path, monkeypatch):
    scene = write_synthetic_scene(str(tmp_path / "scene"), image_wh=16,
                                  n_train=2, n_val=1, n_test=1)
    calls = []
    batch = tpu_rays.tpu_random_ray_batch

    def counted(*args, **kwargs):
        calls.append(1)
        return batch(*args, **kwargs)

    monkeypatch.setattr(tpu_rays, "tpu_random_ray_batch", counted)
    tpu_rays.main(["train_single", "--", "--device", "cpu", "--data_dir",
                   scene, *TINY, "--pixel_sampling", "--num_epochs", "2",
                   "--log_dir", str(tmp_path / "logs"),
                   "--model_dirs", str(tmp_path / "model")])
    _assert_defaults_restored()
    # Two epochs of the 2-image train split at batch 1.
    assert len(calls) == 4
    assert (tmp_path / "model" / "lego" / "fine.msgpack").exists()


TINY = ["--img_wh", "16", "--num_coarse_samples", "8", "--num_fine_samples",
        "8", "--num_layers", "2", "--num_units", "16", "--skip_layer", "1",
        "--white_bg", "--ray_chunks", "128"]


def test_aabb_demo_runs_on_tpu_rays_then_restores_the_loader(tmp_path,
                                                             monkeypatch):
    """``tpu_rays aabb_demo`` evaluates on the TPU's rays (every test
    batch through ``tpu_ray_batch``): its record is the demo's own inside
    ``swapped``, and differs from the one on exact rays."""
    scene = write_synthetic_scene(str(tmp_path / "scene"), image_wh=16,
                                  n_train=2, n_val=1, n_test=2, scale=2.0)
    port_cli.main(["--device", "cpu", "--data_dir", scene, *TINY,
                   "--near", "4", "--far", "12", "--num_epochs", "1",
                   "--log_dir", str(tmp_path / "logs"),
                   "--model_dirs", str(tmp_path / "model")])
    flags = ["--model_path", str(tmp_path / "model" / "lego"), "--data_dir",
             scene, "--img_wh", "16", "--white_bg", "--ray_chunks", "256",
             "--occ_grid", "16", "--aabb", "-4", "-4", "-4", "4", "4", "4",
             "--device", "cpu"]
    calls = []
    batch = tpu_rays.tpu_ray_batch

    def counted(*args, **kwargs):
        calls.append(1)
        return batch(*args, **kwargs)

    monkeypatch.setattr(tpu_rays, "tpu_ray_batch", counted)
    record = tpu_rays.main(["aabb_demo", "--", *flags])
    _assert_defaults_restored()
    assert len(calls) == 2    # the two test images, each read once
    exact = aabb_demo.main(flags)
    with tpu_rays.swapped():
        again = aabb_demo.main(flags)
    assert record == again
    assert record["exact_psnr"] != exact["exact_psnr"] or (
        record["occ_correct_aabb_psnr"] != exact["occ_correct_aabb_psnr"])
