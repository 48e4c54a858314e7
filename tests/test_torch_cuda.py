"""The CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test skips (the ``cuda_device`` fixture decides at run
time, so every process collects the same tests). Tolerances as in
``chip_smoke.py``: sample_merge 1e-6 (same float32 operations in the same
order), ray_march_mlp 3e-2 (bf16 activations rounded after sums taken in
another order), ray_march_quadrature 1e-4 (float32 scan order).
"""

import pytest
import torch

from keras_nerf_tpu_torch.inference import ORBIT, render_orbit
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRF, NeRFConfig, init_mlp
from keras_nerf_tpu_torch.ops import sorted_uniforms

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _chunk(device, r=512, s_c=64, n_fine=128, n_layers=8, skip=4, seed=0):
    cfg = NeRFConfig(n_coarse=s_c, n_fine=n_fine, n_layers=n_layers,
                     skip_layer=skip)
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_mlp(g, cfg.mlp, cfg.in_xyz, cfg.in_dir)
    packed = trm.pack_mlp_params(params, cfg.mlp, 10, 4)
    o = torch.zeros(r, 3, device=device)
    o[:, 2] = 4.0
    d = torch.nn.functional.normalize(
        torch.randn(r, 3, generator=g, device=device), dim=-1)
    t = torch.sort(torch.rand(r, s_c, generator=g, device=device) * 4 + 2,
                   dim=-1).values
    u = sorted_uniforms(g, (r,), n_fine)
    return packed, o, d, t, u


@pytest.mark.parametrize("n_layers,skip", [(8, 4), (3, 1)])
@pytest.mark.parametrize("sigma_only", [True, False])
def test_ray_march_mlp_matches_plain(cuda_device, n_layers, skip,
                                     sigma_only):
    packed, o, d, t, _ = _chunk(cuda_device, n_layers=n_layers, skip=skip)
    base, slope, masks = trm.ray_encoding_coeffs(o, d, 10, 4)
    before = trm.ray_march_mlp.launches
    got = trm.ray_march_mlp(packed, base, slope, t, masks,
                            sigma_only=sigma_only)
    torch.cuda.synchronize()
    assert trm.ray_march_mlp.launches == before + 1
    want = trm.ray_march_mlp_plain(packed, base, slope, t, masks,
                                   sigma_only=sigma_only)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 3e-2


@pytest.mark.parametrize("sigma_only,white_bg", [(True, False),
                                                 (False, True),
                                                 (False, False)])
def test_ray_march_quadrature_matches_plain(cuda_device, sigma_only,
                                            white_bg):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    r, s = 300, 192
    t = torch.sort(torch.rand(r, s, generator=g, device=cuda_device) * 4 + 2,
                   dim=-1).values
    rgbs = torch.rand(r, s, 4, generator=g, device=cuda_device)
    rgbs[..., 3] *= 5
    inp = rgbs[..., 3].contiguous() if sigma_only else rgbs
    got = trm.ray_march_quadrature(inp, t, white_bg, sigma_only, True)
    want = trm.ray_march_quadrature_plain(inp, t, white_bg, sigma_only, True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.parametrize("s_c,n_fine", [(64, 128), (24, 16)])
def test_sample_merge_matches_plain(cuda_device, s_c, n_fine):
    _, _, _, t, u = _chunk(cuda_device, s_c=s_c, n_fine=n_fine)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    w = torch.rand(t.shape, generator=g, device=cuda_device) ** 3
    got = trm.sample_merge(t, w, u)
    want = trm.sample_merge_plain(t, w, u)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-6
    assert bool((got[:, 1:] >= got[:, :-1]).all())


def test_wrappers_raise_on_bad_inputs(cuda_device):
    packed, o, d, t, u = _chunk(cuda_device, r=64)
    with pytest.raises(TypeError):
        trm.sample_merge(t.double(), t.double(), u.double())
    with pytest.raises(ValueError):
        trm.sample_merge(t[:, ::2], t[:, ::2], u)   # not contiguous


def test_render_path_launches_every_kernel(cuda_device):
    nerf = NeRF(config=NeRFConfig(n_layers=8)).compile(
        image_height=64, image_width=64, ray_chunks=1024,
        white_background=True, device="cuda", seed=0)

    trm.reset_launch_counts()
    images, depths = render_orbit(nerf, [0.0, 90.0], img_wh=64, **ORBIT)
    chunks = 2 * 64 * 64 // 1024
    assert [k.launches for k in trm.KERNELS] == [chunks, 2 * chunks,
                                                 2 * chunks]
    assert images.shape == (2, 64, 64, 3)
    assert (images >= 0).all() and (images <= 1).all()


def test_default_render_outside_the_kernel_envelope_raises(cuda_device):
    # 128 units do not fit the kernels; the card never gives way to the
    # float32 reference path unless use_kernels=False asks for it.
    nerf = NeRF(config=NeRFConfig(n_layers=2, dense_units=128)).compile(
        image_height=16, image_width=16, ray_chunks=256, device="cuda",
        seed=0)
    trm.reset_launch_counts()
    with pytest.raises(ValueError, match="kernels require"):
        render_orbit(nerf, [0.0], img_wh=16, **ORBIT)
    assert [k.launches for k in trm.KERNELS] == [0, 0, 0]
