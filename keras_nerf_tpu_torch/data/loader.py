"""Blender ``nerf_synthetic`` datasets as batches of whole images (port of
``keras_nerf_tpu/data/loader.py``).

Every PNG of a split is decoded once into one host array
(:mod:`keras_nerf_tpu_torch.data.image`); poses come from
``transforms_{split}.json`` (``.png`` appended to each ``file_path``,
`keras_nerf/data/loader.py:35-53`). Each batch ships ``[B, H, W, 4]`` pixels
to the device and generates its rays and stratified depths there
(:func:`~keras_nerf_tpu_torch.data.rays.generate_ray_batch`).

Randomness comes from ``torch.Generator``s seeded from ``seed`` and the
epoch, so a run (and a resumed run) repeats: a full permutation of the train
split every epoch (on the host), and the depth jitter (on the device).
Batches drop the remainder (`loader.py:101-107`). With ``pixel_sampling``
the train split is a :class:`RayBatchDataset`: every batch draws its rays
at random (image, pixel) pairs across all of its images.

With ``sharding`` (a ``parallel.BatchSharding``, JAX's ``sharding=``,
`loader.py:64,117-119,192-193`) the batches stay global: every rank builds
the same global batch from the same seeded order and draws, on its group's
device, and the model compiled with that group takes the rank's share of
it (``NeRF.compile(group=...)``).
"""

from __future__ import annotations

import json
import logging
import os
from collections.abc import Iterator

import numpy as np
import torch

from keras_nerf_tpu_torch.data.image import load_images
from keras_nerf_tpu_torch.data.rays import (
    generate_ray_batch,
    sample_random_ray_batch,
)
from keras_nerf_tpu_torch.data.utils import get_focal_from_fov
from keras_nerf_tpu_torch.device import resolve_device


def _epoch_seed(seed: int, epoch: int, stream: int) -> int:
    return (int(seed) << 24) + (int(epoch) << 1) + stream


class NeRFDataset:
    """One split. Iterating yields ``(images [B, H, W, 4], (origin
    [B, H, W, 3], direction [B, H, W, 3], points [B, H, W, N]))`` float32
    tensors on ``device`` (`loader.py:100`); ``last_indices`` holds the
    indices of the images of the batch last yielded, in batch order (the
    occupancy probe-row cache reads them, ``NeRF._run_train_step``)."""

    def __init__(self, images: np.ndarray, poses: np.ndarray, *,
                 focal: float, near: float, far: float, n_samples: int,
                 batch_size: int, shuffle: bool, seed: int = 42,
                 device="cuda"):
        if images.shape[0] != poses.shape[0]:
            raise ValueError(
                f"images ({images.shape[0]}) and poses ({poses.shape[0]}) "
                "must have the same leading dimension")
        self.images = np.asarray(images, dtype=np.float32)
        self.poses = np.asarray(poses, dtype=np.float32)
        self.focal = float(focal)
        self.near = float(near)
        self.far = float(far)
        self.n_samples = int(n_samples)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.image_height = images.shape[1]
        self.image_width = images.shape[2]
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._epoch = 0
        self.last_indices = None

    def __len__(self) -> int:
        return self.images.shape[0] // self.batch_size

    @property
    def num_examples(self) -> int:
        return self.images.shape[0]

    def __iter__(self) -> Iterator:
        epoch = self._epoch
        self._epoch += 1
        n = self.num_examples
        if self.shuffle:
            order = torch.Generator().manual_seed(
                _epoch_seed(self.seed, epoch, 0))
            perm = torch.randperm(n, generator=order).numpy()
        else:
            perm = np.arange(n)
        jitter = torch.Generator(device=self.device)
        jitter.manual_seed(_epoch_seed(self.seed, epoch, 1))
        for b in range(len(self)):
            idx = perm[b * self.batch_size:(b + 1) * self.batch_size]
            self.last_indices = idx
            images = torch.as_tensor(self.images[idx], device=self.device)
            rays = generate_ray_batch(
                self.poses[idx], jitter, image_height=self.image_height,
                image_width=self.image_width, focal=self.focal,
                near=self.near, far=self.far, n_samples=self.n_samples)
            yield images, rays

    def rebatch(self, batch_size: int) -> "NeRFDataset":
        """The same images and poses with another batch size."""
        return NeRFDataset(
            self.images, self.poses, focal=self.focal, near=self.near,
            far=self.far, n_samples=self.n_samples, batch_size=batch_size,
            shuffle=self.shuffle, seed=self.seed, device=self.device)

    def take(self, count: int) -> list:
        """The first ``count`` batches of a fresh epoch."""
        out = []
        for i, batch in enumerate(self):
            if i >= count:
                break
            out.append(batch)
        return out


class RayBatchDataset:
    """The pixel-sampling train split (``--pixel_sampling``,
    `loader.py:142-195`): every batch holds ``batch_size * H * W`` rays at
    random (image, pixel) pairs across ALL the split's images
    (:func:`~keras_nerf_tpu_torch.data.rays.sample_random_ray_batch`), in
    the whole-image batch's shapes, so the engine needs no change. An epoch
    is ``len(self)`` batches: as many rays as one pass over every pixel.

    The images and poses stay on ``device``, where each batch is drawn;
    the draws come from a ``torch.Generator`` there, seeded from ``seed``
    and the epoch."""

    # Batches are scrambled pixels, not images: windowed metrics (SSIM)
    # over them are not meaningful; NeRF.fit warns (loss and PSNR exact).
    PIXELWISE_METRICS_ONLY = True

    def __init__(self, images: np.ndarray, poses: np.ndarray, *,
                 focal: float, near: float, far: float, n_samples: int,
                 batch_size: int, seed: int = 42, device="cuda"):
        if images.shape[0] != poses.shape[0]:
            raise ValueError(
                f"images ({images.shape[0]}) and poses ({poses.shape[0]}) "
                "must have the same leading dimension")
        self.device = resolve_device(device)
        self.images = torch.as_tensor(np.asarray(images, dtype=np.float32),
                                      device=self.device)
        self.poses = torch.as_tensor(np.asarray(poses, dtype=np.float32),
                                     device=self.device)
        self.focal = float(focal)
        self.near = float(near)
        self.far = float(far)
        self.n_samples = int(n_samples)
        self.batch_size = int(batch_size)
        self.image_height = images.shape[1]
        self.image_width = images.shape[2]
        self.seed = int(seed)
        self._epoch = 0

    def __len__(self) -> int:
        return max(1, self.images.shape[0] // self.batch_size)

    @property
    def num_examples(self) -> int:
        return self.images.shape[0]

    def __iter__(self) -> Iterator:
        draws = torch.Generator(device=self.device)
        draws.manual_seed(_epoch_seed(self.seed, self._epoch, 2))
        self._epoch += 1
        for _ in range(len(self)):
            yield sample_random_ray_batch(
                self.images, self.poses, draws, batch=self.batch_size,
                image_height=self.image_height,
                image_width=self.image_width, focal=self.focal,
                near=self.near, far=self.far, n_samples=self.n_samples)


class DatasetLoader:
    """A Blender scene directory as ``(train, val, test)`` datasets
    (`keras_nerf/data/loader.py:13-113`)."""

    def __init__(self, data_dir: str, white_background: bool = False,
                 resize_method: str = "lanczos", device="cuda"):
        self.data_dir = data_dir
        self.white_background = white_background
        self.resize_method = resize_method
        self.device = device

    def _load_split(self, subset: str):
        with open(os.path.join(self.data_dir,
                               f"transforms_{subset}.json")) as f:
            config = json.load(f)
        paths = [os.path.join(self.data_dir, f"{frame['file_path']}.png")
                 for frame in config["frames"]]
        poses = np.asarray([frame["transform_matrix"]
                            for frame in config["frames"]], dtype=np.float32)
        return config["camera_angle_x"], paths, poses

    def load_dataset(self, batch_size: int, image_width: int,
                     image_height: int, near: float, far: float,
                     n_sample: int, seed: int = 42, sharding=None,
                     pixel_sampling: bool = False) -> list:
        """``[train, val, test]``; the train split is shuffled, and split
        ``i`` draws from ``seed + i`` (`loader.py:227-275`). With
        ``pixel_sampling`` the train split is a :class:`RayBatchDataset`;
        validation and test stay whole images. ``sharding`` places every
        split's batches on its group's device (see the module docstring)."""
        from keras_nerf_tpu_torch.parallel import BatchSharding

        if sharding is not None and not isinstance(sharding, BatchSharding):
            raise NotImplementedError(
                f"sharding must be a parallel.BatchSharding; a "
                f"{type(sharding).__name__} (such as the JAX package's "
                f"NamedSharding) has no counterpart in the port (ROADMAP.md, "
                f"A13)")
        device = self.device if sharding is None else sharding.group.device
        datasets = []
        for split_idx, subset in enumerate(["train", "val", "test"]):
            fov, paths, poses = self._load_split(subset)
            images = load_images(paths, image_height, image_width,
                                 self.white_background, self.resize_method)
            kw = dict(focal=get_focal_from_fov(fov, image_width), near=near,
                      far=far, n_samples=n_sample, batch_size=batch_size,
                      seed=seed + split_idx, device=device)
            if pixel_sampling and subset == "train":
                datasets.append(RayBatchDataset(images, poses, **kw))
            else:
                datasets.append(NeRFDataset(images, poses,
                                            shuffle=(subset == "train"),
                                            **kw))
            logging.info("Loaded %s dataset. %d images.", subset, len(paths))
        return datasets
