"""The user-facing NeRF model, render path (port of
``keras_nerf_tpu/models/nerf.py``): construct from hyperparameters, a
:class:`NeRFConfig` or a checkpoint directory, ``compile`` for a device and
image shape, then ``predict_and_render_images``."""

from __future__ import annotations

import logging
from collections.abc import Sequence

import torch

from keras_nerf_tpu_torch.device import resolve_device
from keras_nerf_tpu_torch.models import engine
from keras_nerf_tpu_torch.models.engine import NeRFConfig
from keras_nerf_tpu_torch.models.mlp import init_mlp
from keras_nerf_tpu_torch.utils import checkpoint


class NeRF:
    """Coarse + fine NeRF (reference `nerf.py:11`), inference only."""

    def __init__(self, n_coarse: int = 64, n_fine: int = 128,
                 pos_emb_xyz: int = 10, pos_emb_dir: int = 4,
                 n_layers: int = 8, dense_units: int = 256,
                 skip_layer: int = 4, model_path: str | None = None,
                 config: NeRFConfig | None = None):
        self.model_path = model_path
        if model_path is not None:
            self.config = checkpoint.load_model_config(model_path)
        elif config is not None:
            self.config = config
        else:
            self.config = NeRFConfig(
                n_coarse=n_coarse, n_fine=n_fine, pos_emb_xyz=pos_emb_xyz,
                pos_emb_dir=pos_emb_dir, n_layers=n_layers,
                dense_units=dense_units, skip_layer=skip_layer)
        self.coarse_params = None
        self.fine_params = None
        self.device = None

    def compile(self, batch_size: int = 1, image_height: int = 128,
                image_width: int = 128, ray_chunks: int = 1024,
                white_background: bool = False, device="cuda",
                use_kernels: bool | None = None, seed: int = 42):
        """Fix shapes and device; load the checkpoint's weights (or draw
        random ones from ``seed``). ``ray_chunks`` is clamped to the rays
        of one batch and must divide them (`nerf.py:78-114`)."""
        self.device = resolve_device(device)
        self.config = NeRFConfig(**{**self.config.to_model_config(),
                                    "white_background": white_background,
                                    "use_kernels": use_kernels})
        self.batch_size = batch_size
        self.image_height = image_height
        self.image_width = image_width
        num_rays = batch_size * image_height * image_width
        self.ray_chunks = min(ray_chunks, num_rays)
        if num_rays % self.ray_chunks:
            raise ValueError(f"ray_chunks {self.ray_chunks} must divide the "
                             f"number of rays {num_rays}")
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed + 1)
        if self.model_path is not None:
            self.load_model(self.model_path)
        elif self.coarse_params is None:
            init = torch.Generator(device=self.device)
            init.manual_seed(seed)
            cfg = self.config
            self.coarse_params = init_mlp(init, cfg.mlp, cfg.in_xyz,
                                          cfg.in_dir)
            self.fine_params = init_mlp(init, cfg.mlp, cfg.in_xyz,
                                        cfg.in_dir)
        return self

    def load_model(self, path: str):
        """Restore architecture and weights from a checkpoint directory
        written by ``keras_nerf_tpu``; runtime options are kept."""
        if self.device is None:
            raise RuntimeError("call compile() first")
        old = self.config
        self.config = checkpoint.load_model_config(
            path, white_background=old.white_background,
            use_kernels=old.use_kernels)
        self.model_path = path
        logging.info("Loading NeRF weights from %s", path)
        self.coarse_params, self.fine_params = checkpoint.load_params(
            path, self.device)

    def predict_and_render_images(
            self, rays, with_weights: bool = True, coarse_image: bool = True,
            fine_draws: torch.Generator | Sequence[torch.Tensor] | None = None
    ) -> tuple[dict, dict]:
        """Render ``rays = (origin, direction, points)`` into ``(coarse,
        fine)`` dicts (`nerf.py:229-304`). ``with_weights=False`` drops the
        per-sample weights; ``coarse_image=False`` skips the coarse colour
        heads (coarse image zero) — the orbit renderer uses both."""
        if self.coarse_params is None:
            raise RuntimeError("call compile() first")
        rays = tuple(torch.as_tensor(x, dtype=torch.float32,
                                     device=self.device) for x in rays)
        return engine.render_image_batch(
            self.coarse_params, self.fine_params, rays,
            self._generator if fine_draws is None else fine_draws,
            self.config, self.ray_chunks, with_weights=with_weights,
            coarse_image=coarse_image)
