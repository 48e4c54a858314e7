"""Guards of the port: no JAX inside it, the card as the default device, and
kernel wrappers that never launch (or count) on a CPU tensor."""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from keras_nerf_tpu_torch import DEFAULT_DEVICE, resolve_device
from keras_nerf_tpu_torch.kernels import KERNELS, _build
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import (
    NeRF,
    NeRFConfig,
    init_mlp,
    resolve_use_kernels,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import keras_nerf_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import keras_nerf_tpu_torch.inference
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib", "flax",
                                            "optax", "keras_nerf_tpu.")))
bad += [n for n in sys.modules if n == "keras_nerf_tpu"]
print("BAD", bad)
print("MODULES", len([n for n in sys.modules
                      if n.startswith("keras_nerf_tpu_torch")]))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
    n_modules = int(proc.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 20


def test_default_device_is_cuda_and_missing_card_raises():
    assert DEFAULT_DEVICE == "cuda"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
        with pytest.raises(RuntimeError):
            NeRF(config=NeRFConfig(n_layers=2)).compile()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_wrapper_calls_use_the_plain_version_and_count_nothing():
    trm.reset_launch_counts()
    cfg = NeRFConfig(n_coarse=8, n_fine=8, n_layers=2)
    params = init_mlp(torch.Generator().manual_seed(0), cfg.mlp, cfg.in_xyz,
                      cfg.in_dir)
    packed = trm.pack_mlp_params(params, cfg.mlp, 10, 4)
    g = torch.Generator().manual_seed(1)
    o = torch.zeros(4, 3)
    o[:, 2] = 4.0
    d = torch.nn.functional.normalize(torch.randn(4, 3, generator=g), dim=-1)
    t = torch.sort(torch.rand(4, 8, generator=g) * 4 + 2, dim=-1).values
    u = torch.sort(torch.rand(4, 8, generator=g), dim=-1).values
    coarse = trm.fused_render_chunk(packed, o, d, t, sigma_only=True)
    fine = trm.fused_render_chunk(packed, o, d, None,
                                  sample_inputs=(t, coarse[2], u))
    assert fine[0].shape == (4, 3) and fine[2].shape == (4, 16)
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    # The wrapper ran exactly the plain function.
    base, slope, masks = trm.ray_encoding_coeffs(o, d, 10, 4)
    torch.testing.assert_close(
        trm.ray_march_mlp(packed, base, slope, t, masks),
        trm.ray_march_mlp_plain(packed, base, slope, t, masks),
        rtol=0, atol=0)
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_cpu_train_step_launches_nothing():
    trm.reset_launch_counts()
    cfg = NeRFConfig(n_coarse=8, n_fine=8, n_layers=2, white_background=True)
    nerf = NeRF(config=cfg).compile(image_height=4, image_width=8,
                                    ray_chunks=16, device="cpu", seed=0)
    g = torch.Generator().manual_seed(2)
    rays = (torch.tensor([0.0, 0.0, 4.0]).expand(1, 4, 8, 3),
            torch.nn.functional.normalize(torch.randn(1, 4, 8, 3,
                                                      generator=g), dim=-1),
            torch.sort(torch.rand(1, 4, 8, 8, generator=g) * 4 + 2,
                       -1).values)
    metrics = nerf.train_step((torch.rand(1, 4, 8, 4, generator=g), rays))
    assert resolve_use_kernels(nerf.config, torch.device("cpu"))
    assert metrics["fine_grad_norm"] > 0
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_camera_rays_and_params_take_the_callers_device():
    """Neither default falls back to the CPU: camera vectors take the
    caller's device, parameters default to the card."""
    import inspect

    import numpy as np

    from keras_nerf_tpu_torch.data.rays import camera_plane_directions
    from keras_nerf_tpu_torch.utils.convert import params_from_jax

    device = inspect.signature(camera_plane_directions).parameters["device"]
    assert device.default is inspect.Parameter.empty
    with pytest.raises(TypeError):
        camera_plane_directions(4, 4, 2.0)
    assert camera_plane_directions(4, 4, 2.0, "cpu").device.type == "cpu"
    tree = {"w": [np.ones((2, 2), np.float32)]}
    assert params_from_jax(tree, "cpu")["w"][0].device.type == "cpu"
    if torch.cuda.is_available():
        assert params_from_jax(tree)["w"][0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            params_from_jax(tree)


@pytest.mark.parametrize("units,device,want", [
    (256, "cuda", True), (128, "cuda", True),
    (256, "cpu", True), (128, "cpu", False)])
def test_default_use_kernels_never_gives_way_on_a_card(units, device, want):
    # 128 units lie outside the kernels' envelope: on a card the default
    # still takes the kernel path, where packing raises.
    cfg = NeRFConfig(n_layers=2, dense_units=units)
    assert resolve_use_kernels(cfg, torch.device(device)) is want
    for explicit in (True, False):
        cfg = dataclasses.replace(cfg, use_kernels=explicit)
        assert resolve_use_kernels(cfg, torch.device(device)) is explicit


def test_callable_loss_takes_the_kernel_branch_and_mse_the_fused_path():
    """On a card (a CUDA-typed device; no card needed), the default MSE
    trains through the fused T3 path and any other callable through
    render_chunk's kernel branch, fused_point_forward (T5/T6)."""
    from keras_nerf_tpu_torch.models.engine import _use_fused_train, mse_loss

    cuda = torch.device("cuda")
    cfg = NeRFConfig(n_layers=2)
    assert resolve_use_kernels(cfg, cuda)
    assert _use_fused_train(cfg, mse_loss, cuda)
    assert _use_fused_train(cfg, None, cuda)
    assert not _use_fused_train(cfg, lambda y, p: (p - y).abs().mean(), cuda)
    # Outside the kernels' envelope neither gives way: render_chunk's kernel
    # branch packs the weights, and packing raises.
    small = NeRFConfig(n_layers=2, dense_units=128)
    assert resolve_use_kernels(small, cuda)
    assert not _use_fused_train(small, mse_loss, cuda)
    assert not _use_fused_train(dataclasses.replace(cfg, use_kernels=False),
                                mse_loss, cuda)


def test_wrappers_refuse_other_devices():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        trm.sample_merge(x, x, x, x)


def _int8_inputs(device="cpu"):
    """A quantized 2-layer model and a chunk of 4 rays x 8 depths."""
    from keras_nerf_tpu_torch.kernels.quantize import (
        collect_act_amax,
        quantize_packed,
    )

    cfg = NeRFConfig(n_coarse=8, n_fine=8, n_layers=2)
    params = init_mlp(torch.Generator().manual_seed(0), cfg.mlp, cfg.in_xyz,
                      cfg.in_dir)
    packed = trm.pack_mlp_params(params, cfg.mlp, 10, 4)
    g = torch.Generator().manual_seed(1)
    o = torch.zeros(4, 3)
    o[:, 2] = 4.0
    d = torch.nn.functional.normalize(torch.randn(4, 3, generator=g), dim=-1)
    t = torch.sort(torch.rand(4, 8, generator=g) * 4 + 2, dim=-1).values
    enc = trm.encode_block128(*trm.ray_points(o, d, t))
    q = quantize_packed(packed, collect_act_amax(packed, enc, cfg.mlp),
                        cfg.mlp)
    return q, trm.ray_encoding_coeffs(o, d, 10, 4), t


def test_new_wrappers_use_the_plain_version_on_the_cpu_and_count_nothing():
    """ray_march_mlp_int8 (T4) and mma_ceiling (T7): a CPU tensor runs the
    plain version, bit for bit, and counts no launch."""
    from keras_nerf_tpu_torch.kernels import ceiling

    trm.reset_launch_counts()
    q, (base, slope, masks), t = _int8_inputs()
    for sigma_only in (False, True):
        torch.testing.assert_close(
            trm.ray_march_mlp_int8(q, base, slope, t, masks,
                                   sigma_only=sigma_only),
            trm.ray_march_mlp_int8.plain(q, base, slope, t, masks,
                                         sigma_only=sigma_only),
            rtol=0, atol=0)
    ws, bs, seed = ceiling.make_inputs(1, 128, "cpu")
    torch.testing.assert_close(trm.mma_ceiling(ws, bs, seed, 64, 1, "epi"),
                               trm.mma_ceiling.plain(ws, bs, seed, 64, 1,
                                                     "epi"), rtol=0, atol=0)
    assert trm.ray_march_mlp_int8.launches == trm.mma_ceiling.launches == 0
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_new_wrappers_refuse_other_devices():
    from keras_nerf_tpu_torch.kernels import ceiling

    from keras_nerf_tpu_torch.models.engine import tree_map

    q, (base, slope, masks), t = _int8_inputs()
    q = tree_map(lambda x: None if x is None else x.to("meta"), q)
    with pytest.raises(ValueError, match="unsupported device"):
        trm.ray_march_mlp_int8(q, *(x.to("meta")
                                    for x in (base, slope, t, masks)))
    ws, bs, seed = ceiling.make_inputs(1, 128, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        trm.mma_ceiling([w.to("meta") for w in ws], bs, seed, 64, 1)


def test_kernels_name_their_sources_and_tpu_counterparts():
    for k in KERNELS:
        assert os.path.exists(os.path.join(REPO, k.source)), k.source
        path, line = k.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            text = f.readlines()[int(line) - 1]
        # The TPU kernel's function, or the probe's pallas_call.
        assert text.startswith("def ") or "pl.pallas_call(" in text, \
            k.replaces
    assert {p.name for p in _build.sources()} == {
        os.path.basename(k.source) for k in KERNELS}


def test_build_raises_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_build_key_follows_the_sources(monkeypatch, tmp_path):
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    key = _build.source_hash()
    assert key == _build.source_hash()
    (tmp_path / "sample_merge.cu").write_text(
        (tmp_path / "sample_merge.cu").read_text() + "\n// edit\n")
    assert _build.source_hash() != key


NO_IMAGEIO = """
import importlib, pkgutil, sys, tempfile
sys.modules["imageio"] = None      # any import of it now raises
import numpy as np, torch
import keras_nerf_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from keras_nerf_tpu_torch.inference import gif_frames, write_gifs
from keras_nerf_tpu_torch.models import NeRFConfig, engine
from keras_nerf_tpu_torch.utils import checkpoint
cfg = NeRFConfig(n_layers=2)
opt = engine.make_optimizer("adam")
state = engine.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                device="cpu")
d = tempfile.mkdtemp()
checkpoint.save_model(d, state, cfg)
back = checkpoint.load_train_state(d, state, "cpu")
assert torch.equal(back.fine_params["sigma"]["kernel"],
                   state.fine_params["sigma"]["kernel"])
frames, depths = gif_frames(np.zeros((2, 4, 4, 3), np.float32),
                            np.ones((2, 4, 4), np.float32))
write_gifs(frames, depths, d, "orbit")
assert "keras_nerf_tpu_torch.ops.occupancy" in sys.modules
bad = sorted(n for n in sys.modules
             if n in ("jax", "keras_nerf_tpu")
             or n.startswith(("jax.", "jaxlib", "flax", "optax",
                              "keras_nerf_tpu.", "imageio.")))
print("BAD", bad)
"""


def test_port_needs_no_imageio():
    """With ``imageio`` unimportable, every module of the port (the
    occupancy ops among them) imports, a checkpoint round-trips and both
    GIFs are written; nothing of JAX is imported."""
    proc = subprocess.run([sys.executable, "-c", NO_IMAGEIO],
                          cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout


def test_sample_merge_modes_use_the_plain_version_on_the_cpu():
    """Each mode of sample_merge on CPU tensors is its plain version, bit
    for bit, and counts no launch; a sample_inputs tuple of another length
    raises."""
    trm.reset_launch_counts()
    g = torch.Generator().manual_seed(4)
    cp = torch.sort(torch.rand(6, 16, generator=g) * 4 + 2, -1).values
    w = (torch.rand(6, 16, generator=g) > 0.5).float()
    u = torch.sort(torch.rand(6, 8, generator=g), -1).values
    for mp in (cp, None, cp[:, ::2].contiguous()):
        torch.testing.assert_close(trm.sample_merge(cp, w, u, mp),
                                   trm.sample_merge_plain(cp, w, u, mp),
                                   rtol=0, atol=0)
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    with pytest.raises(ValueError, match="sample_inputs"):
        trm._pass_points(None, (cp, w))
