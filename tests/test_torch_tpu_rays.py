"""ROADMAP C15's emulation (``keras_nerf_tpu_torch/tpu_rays.py``) against
the JAX package on the CPU.

``tpu_default_rays`` is JAX's ``generate_rays`` with the rotation and the
camera vectors cast to ``jnp.bfloat16`` and the einsum's
``preferred_element_type=float32`` (what a DEFAULT-precision TPU dot does
with float32 operands), within ``ULP_BUDGET`` float32 ulps of each
component; the pixel error of such rays against exact float64 rays over
20 poses of the spheres fixture's orbit, printed with ``-s``, is the
0.165 px mean (0.155 median, 0.412 p99, 0.577 max) that C15's hypothesis
rests on. ``python -m keras_nerf_tpu_torch.tpu_rays -- <flags>`` trains
with these rays for the whole run and puts the loader back after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.data.rays import camera_plane_directions
from keras_nerf_tpu_torch import tpu_rays
from keras_nerf_tpu_torch.data import loader
from keras_nerf_tpu_torch.data.rays import generate_ray_batch
from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene
from keras_nerf_tpu_torch.data.utils import get_focal_from_fov, pose_spherical

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
    with pytest.raises(SystemExit, match="--pixel_sampling"):
        tpu_rays.main(["--", "--pixel_sampling"])
