"""The port's data modules against the JAX package's: the synthetic scene,
image loading, and the loader's rays. Ray tracing and image code are numpy
copies (exact); rays are float32 on both sides (atol 1e-6)."""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.data import DatasetLoader as JaxLoader
from keras_nerf_tpu.data import rays as jrays
from keras_nerf_tpu.data import synthetic as jsyn
from keras_nerf_tpu.data.utils import pose_spherical as jpose
from keras_nerf_tpu_torch.data import DatasetLoader, NeRFDataset
from keras_nerf_tpu_torch.data import rays as trays
from keras_nerf_tpu_torch.data import synthetic as tsyn
from keras_nerf_tpu_torch.data.image import (
    load_image,
    resize_antialias_bilinear,
)

RAY_ATOL = 1e-6


@pytest.mark.parametrize("scene,supersample", [("spheres", 1),
                                               ("spheres", 2), ("hard", 1)])
def test_render_pose_matches_jax(scene, supersample):
    c2w = jpose(40.0, -30.0, 4.0)
    want = jsyn.render_pose(c2w, 24, supersample, scene=scene)
    got = tsyn.render_pose(c2w, 24, supersample, scene=scene)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (24, 24, 4) and got[..., 3].max() == 1.0


def test_written_scene_matches_jax_and_loads_identically(tmp_path):
    kw = dict(image_wh=12, n_train=2, n_val=1, n_test=1, seed=4)
    tsyn.write_synthetic_scene(str(tmp_path / "port"), **kw)
    jsyn.write_synthetic_scene(str(tmp_path / "jax"), **kw)
    for split in ("train", "val", "test"):
        assert ((tmp_path / "port" / f"transforms_{split}.json").read_text()
                == (tmp_path / "jax" / f"transforms_{split}.json").read_text())
    for white in (True, False):
        for method in ("lanczos", "antialias-bilinear"):
            path = str(tmp_path / "port" / "train" / "r_0.png")
            from keras_nerf_tpu.data.image import load_image as jload
            np.testing.assert_array_equal(
                load_image(path, 8, 8, white, method),
                jload(path, 8, 8, white, method))


def test_resize_matches_jax():
    from keras_nerf_tpu.data.image import resize_antialias_bilinear as jres

    img = np.random.default_rng(0).uniform(size=(20, 16, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(resize_antialias_bilinear(img, 7, 9),
                                  jres(img, 7, 9))


def test_rays_for_a_pose_match_jax():
    c2w = jpose(120.0, -20.0, 4.0)
    o_j, d_j = jrays.generate_rays(jnp.asarray(c2w), 6, 10, 11.5)
    o_t, d_t = trays.generate_rays(torch.as_tensor(c2w), 6, 10, 11.5)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=RAY_ATOL)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=RAY_ATOL)


def test_loader_batches_match_jax(tmp_path):
    """Same scene, same split (val: not shuffled): the port's batches carry
    JAX's pixels and rays; depths are stratified in [near, far]."""
    scene = tsyn.write_synthetic_scene(str(tmp_path), image_wh=16,
                                       n_train=3, n_val=2, n_test=1)
    kw = dict(batch_size=1, image_width=16, image_height=16, near=2.0,
              far=6.0, n_sample=8, seed=0)
    _, val_t, _ = DatasetLoader(scene, True, device="cpu").load_dataset(**kw)
    _, val_j, _ = JaxLoader(scene, True).load_dataset(**kw)
    batches_t, batches_j = list(val_t), list(val_j)
    assert len(batches_t) == len(batches_j) == 2
    for (img_t, rays_t), (img_j, rays_j) in zip(batches_t, batches_j):
        np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
        for a, b in zip(rays_t[:2], rays_j[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=RAY_ATOL)
        t = rays_t[2].numpy()
        assert t.shape == (1, 16, 16, 8)
        assert t.min() >= 2.0 and t.max() <= 6.0
        assert np.all(np.diff(t, axis=-1) >= 0)


def test_loader_shuffles_by_seed_and_epoch(tmp_path):
    scene = tsyn.write_synthetic_scene(str(tmp_path), image_wh=8, n_train=6,
                                       n_val=1, n_test=1)
    kw = dict(batch_size=2, image_width=8, image_height=8, near=2.0, far=6.0,
              n_sample=4, seed=1)

    def epochs(n):
        train = DatasetLoader(scene, device="cpu").load_dataset(**kw)[0]
        return [[(b[0].clone(), b[1][2].clone()) for b in train]
                for _ in range(n)]

    first, second = epochs(2), epochs(2)
    assert len(first[0]) == 3          # 6 images, batches of 2
    for a, b in zip(first, second):    # one seed: the same run
        for (ia, ta), (ib, tb) in zip(a, b):
            assert torch.equal(ia, ib) and torch.equal(ta, tb)
    seen = torch.cat([i for i, _ in first[0]])     # every image once
    assert seen.shape[0] == 6 and len({float(x.sum()) for x in seen}) == 6
    assert not torch.equal(first[0][0][1], first[1][0][1])


def test_loader_refuses_what_is_not_ported(tmp_path):
    scene = tsyn.write_synthetic_scene(str(tmp_path), image_wh=8, n_train=1,
                                       n_val=1, n_test=1)
    loader = DatasetLoader(scene, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loader.load_dataset(1, 8, 8, 2.0, 6.0, 4, sharding=object())


def test_random_ray_batch_and_rebatch():
    g = torch.Generator().manual_seed(0)
    images, (o, d, t) = tsyn.random_ray_batch(2, 4, 5, 8, g)
    assert images.shape == (2, 4, 5, 4) and t.shape == (2, 4, 5, 8)
    np.testing.assert_allclose(torch.linalg.vector_norm(d, dim=-1).numpy(),
                               1.0, atol=1e-6)
    assert float(o[..., 2].min()) == 4.0
    assert bool((t[..., 1:] >= t[..., :-1]).all())
    ds = NeRFDataset(np.zeros((3, 4, 4, 4), np.float32),
                     np.stack([np.eye(4, dtype=np.float32)] * 3), focal=2.0,
                     near=2.0, far=6.0, n_samples=4, batch_size=2,
                     shuffle=False, device="cpu")
    assert len(ds) == 1 and len(ds.rebatch(1)) == 3
    with pytest.raises(ValueError):
        NeRFDataset(np.zeros((3, 4, 4, 4)), np.zeros((2, 4, 4)), focal=2.0,
                    near=2.0, far=6.0, n_samples=4, batch_size=1,
                    shuffle=False, device="cpu")
    assert jax.devices()[0].platform == "cpu"
