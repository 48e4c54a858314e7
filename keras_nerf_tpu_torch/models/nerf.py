"""The user-facing NeRF model (port of ``keras_nerf_tpu/models/nerf.py``):
construct from hyperparameters, a :class:`NeRFConfig` or a checkpoint
directory, ``compile`` for a device, image shape and optimizer, then
``fit``/``evaluate`` or ``predict_and_render_images`` (or, opt-in,
``bake_occupancy`` then ``render_occupancy``); ``save_model`` writes the JAX
package's checkpoint format. The state is an explicit
:class:`~keras_nerf_tpu_torch.models.engine.TrainState`. Training has two
opt-in tiers: ``compile(occupancy_train=G)`` (the fine pass on depths
inside a G^3 grid that ``fit`` re-bakes from the live fine model, with an
optional probe-row cache) and ``pixel_sampling`` (rays drawn across all
views, ``data.RayBatchDataset``).

Across cards: ``compile(group=...)`` with a ``parallel.Group`` makes this
one rank of synchronous data parallelism (JAX's ``compile(mesh=...)``):
the state is broadcast from rank 0, every step trains on the rank's share
of the global batch and averages the gradients over the group, renders
run in height bands gathered into whole images, and rank 0 alone logs and
writes checkpoints while the others wait at a barrier."""

from __future__ import annotations

import logging
import math
from collections.abc import Sequence

import torch

from keras_nerf_tpu_torch.device import resolve_device
from keras_nerf_tpu_torch.models import engine
from keras_nerf_tpu_torch.models.engine import NeRFConfig
from keras_nerf_tpu_torch.utils import checkpoint


class MeanTracker:
    """Running mean over an epoch (`tf.keras.metrics.Mean` stand-in)."""

    def __init__(self):
        self.total, self.count = 0.0, 0

    def update(self, value: float):
        self.total += float(value)
        self.count += 1

    def result(self) -> float:
        return self.total / max(self.count, 1)

    def reset(self):
        self.total, self.count = 0.0, 0


class NeRF:
    """Coarse + fine NeRF with chunked training (reference `nerf.py:11`)."""

    METRIC_NAMES = ("coarse_loss", "coarse_psnr", "coarse_ssim",
                    "fine_loss", "fine_psnr", "fine_ssim")

    def __init__(self, n_coarse: int = 64, n_fine: int = 128,
                 pos_emb_xyz: int = 10, pos_emb_dir: int = 4,
                 n_layers: int = 8, dense_units: int = 256,
                 skip_layer: int = 4, model_path: str | None = None,
                 config: NeRFConfig | None = None,
                 compute_dtype: str = "float32"):
        """``compute_dtype`` is the reference path's matmul precision
        (``"bfloat16"`` for ``--mixed_precision``); ``config`` keeps its
        own."""
        self.model_path = model_path
        if model_path is not None:
            self.config = checkpoint.load_model_config(
                model_path, compute_dtype=compute_dtype)
        elif config is not None:
            self.config = config
        else:
            self.config = NeRFConfig(
                n_coarse=n_coarse, n_fine=n_fine, pos_emb_xyz=pos_emb_xyz,
                pos_emb_dir=pos_emb_dir, n_layers=n_layers,
                dense_units=dense_units, skip_layer=skip_layer,
                compute_dtype=compute_dtype)
        self.state: engine.TrainState | None = None
        self.device = None
        self.group = None
        self._train_config = None
        self.occ_grid: torch.Tensor | None = None
        self._occ_aabb = None
        self.occupancy_train = 0
        self._occ_train_grid: torch.Tensor | None = None
        self._occ_probe_cache: torch.Tensor | None = None

    @property
    def coarse_params(self):
        return None if self.state is None else self.state.coarse_params

    @property
    def fine_params(self):
        return None if self.state is None else self.state.fine_params

    # ------------------------------------------------------------------ setup

    def compile(self, optimizer: str = "adam", loss="mse",
                batch_size: int = 1, image_height: int = 128,
                image_width: int = 128, ray_chunks: int = 1024,
                white_background: bool = False, is_training: bool = True,
                learning_rate: float = 1e-3, lr_final: float = 0.0,
                lr_decay_steps: int = 0, seed: int = 42, device="cuda",
                use_kernels: bool | None = None, fast_render: int = 0,
                quantized_render: bool = False, occupancy_train: int = 0,
                occupancy_train_samples: int = 64,
                occupancy_train_merge: bool = True,
                occupancy_train_warmup: int = 2,
                occupancy_train_update: int = 1,
                occupancy_train_threshold: float = 1.0,
                occupancy_train_probe: int = 64,
                occupancy_train_until: int = 0,
                occupancy_train_dilate: int = 1,
                occupancy_train_cache: bool = False,
                pixel_sampling: bool = False, near: float = 2.0,
                far: float = 6.0, group=None, shard_rays: bool = False,
                debug_grads: bool = False, debug_nans: bool = False):
        """Fix shapes, device and optimizer; restore the checkpoint's
        weights and optimizer state, or draw random weights from ``seed``
        (`nerf.py:79-354`). ``ray_chunks`` is clamped to the rays of one
        batch and must divide them. ``lr_final > 0`` with
        ``lr_decay_steps > 0`` decays the learning rate exponentially.
        ``loss`` is ``"mse"``, None or a callable ``loss(y_true, y_pred) ->
        scalar``, applied per chunk in training and to the whole images in
        evaluation (`nerf.py:106-115`).

        ``fast_render = K > 0`` opts :meth:`predict_and_render_images` into
        the fast render (``NeRFConfig.fast_render``): the fine pass renders
        K importance samples alone (`nerf.py:85-121`). Training and
        evaluation keep the exact math, the int8 calibration too, and the
        occupancy render ignores it. It composes with ``quantized_render``.

        ``quantized_render`` opts :meth:`predict_and_render_images` into
        the int8 render tier, calibrated on its first rays
        (:meth:`_ensure_packed_q`); training and evaluation are untouched.
        It needs the kernel path: with ``use_kernels=False`` (or on the CPU
        with an architecture outside the kernels' envelope) it is ignored
        with a warning, as the JAX package does (`nerf.py:337-348`); on a
        card it always runs the int8 kernel.

        ``occupancy_train = G > 0`` opts training into the occupancy tier
        (`nerf.py:247-310`, :meth:`_maybe_update_occupancy_train`): from
        epoch ``occupancy_train_warmup`` on, ``fit`` bakes a G^3 grid from
        the live fine model (density above ``occupancy_train_threshold``,
        dilated ``occupancy_train_dilate`` times over [-2, 2]^3) every
        ``occupancy_train_update`` epochs, and each step's fine pass trains
        on ``occupancy_train_samples`` depths inside it over
        ``occupancy_train_probe`` probe bins on ``[near, far]``, merged
        with the stratified depths unless ``occupancy_train_merge`` is
        False; from epoch ``occupancy_train_until`` (if > 0) on, exact
        steps again. ``occupancy_train_cache`` keeps every train image's
        probe rows per bake (``ops.occupancy.probe_rows_for_poses``) and
        gathers them instead of probing; it refuses ``pixel_sampling``,
        whose batches are no images. ``pixel_sampling`` records that the
        train split is a ``RayBatchDataset`` (the training configuration
        and ``fit``'s SSIM warning).

        ``group`` (a ``parallel.Group``) makes this model one rank of data
        parallelism (`nerf.py:127-171,276-329`): ``batch_size`` is the
        global batch, split along its leading axis (it must divide over
        the ranks), or with ``shard_rays`` along every image's height;
        ``ray_chunks`` is per rank. Batches given to ``train_step``,
        ``test_step`` and ``fit`` are global, the same on every rank, and
        each rank takes its share here (``parallel.shard_batch``);
        evaluation batches that the ranks do not divide run whole on
        every rank.
        ``debug_grads`` adds one gradient norm per parameter tensor to
        the step metrics, and warns by name of a dead or non-finite one;
        ``debug_nans`` raises at once when a step's loss or gradients are
        not finite."""
        if callable(loss):
            self.loss_fn = loss
        elif loss in ("mse", None):
            self.loss_fn = engine.mse_loss
        else:
            raise ValueError(f"unsupported loss: {loss!r} (pass 'mse' or a "
                             f"callable loss(y_true, y_pred) -> scalar)")
        self.device = resolve_device(device)
        self.config = NeRFConfig(**{**self.config.to_model_config(),
                                    "white_background": white_background,
                                    "compute_dtype": self.config.compute_dtype,
                                    "use_kernels": use_kernels,
                                    "fast_render": int(fast_render)})
        self.batch_size = batch_size
        self.image_height = image_height
        self.image_width = image_width
        self.num_rays = batch_size * image_height * image_width
        # Under a group the step sees one rank's rays, and ray_chunks is
        # per rank (`nerf.py:127-171`), with JAX's refusals.
        self.group = group
        n = 1 if group is None else group.size
        self.shard_rays = bool(shard_rays) and group is not None
        if self.shard_rays and pixel_sampling:
            raise ValueError(
                "--shard_rays cannot compose with --pixel_sampling "
                "(pixel batches have no image-height axis; use plain DP)")
        if self.shard_rays and image_height % n != 0:
            raise ValueError(
                f"image_height {image_height} must divide across {n} mesh "
                f"devices under --shard_rays (the image HEIGHT axis is "
                f"sharded)")
        if is_training and not self.shard_rays and batch_size % n != 0:
            raise ValueError(
                f"batch_size {batch_size} must divide across {n} mesh "
                f"devices (the global image batch is sharded along its "
                f"leading axis; pass shard_rays=True to split the "
                f"image-height axis instead)")
        if self.num_rays % n != 0:
            raise ValueError(f"global num_rays {self.num_rays} must divide "
                             f"across {n} mesh devices")
        per_rank_rays = self.num_rays // n
        self.ray_chunks = min(ray_chunks, per_rank_rays)
        if per_rank_rays % self.ray_chunks:
            raise ValueError(f"ray_chunks {self.ray_chunks} must divide the "
                             f"number of rays {per_rank_rays}")
        self.debug_grads = bool(debug_grads)
        self.debug_nans = bool(debug_nans)
        # The occupancy tier's schedule and step (`nerf.py:247-310`); a
        # compile starts without a grid or a cache.
        self.occupancy_train = int(occupancy_train) if is_training else 0
        self._occ_train_grid = None
        self._occ_probe_cache = None
        self.occupancy_train_cache = (bool(occupancy_train_cache)
                                      and self.occupancy_train > 0)
        if self.occupancy_train_cache and group is not None:
            raise ValueError(
                "--occupancy_train_cache is a single-device tier (the "
                "cache indexes whole images; under a mesh use the "
                "plain grid probe)")
        if self.occupancy_train_cache and pixel_sampling:
            raise ValueError(
                "--occupancy_train_cache cannot compose with "
                "--pixel_sampling (pixel batches scramble the per-image "
                "rays the cache is keyed by)")
        if self.occupancy_train > 0:
            from keras_nerf_tpu_torch.ops.occupancy import DEFAULT_AABB

            self._occ_train_cfg = dict(
                grid_size=self.occupancy_train,
                warmup=max(0, int(occupancy_train_warmup)),
                update=max(1, int(occupancy_train_update)),
                threshold=float(occupancy_train_threshold),
                until=max(0, int(occupancy_train_until)),
                dilate=max(0, int(occupancy_train_dilate)))
            self._occ_spec = (int(occupancy_train_samples),
                              int(occupancy_train_probe), float(near),
                              float(far), DEFAULT_AABB,
                              bool(occupancy_train_merge))
        if is_training:
            # Every knob that moves convergence (`nerf.py:180-199`), so that
            # a resume with other flags warns by name.
            self._train_config = {
                "optimizer": optimizer, "learning_rate": float(learning_rate),
                "lr_final": float(lr_final),
                "lr_decay_steps": int(lr_decay_steps),
                "white_background": bool(white_background),
                "pixel_sampling": bool(pixel_sampling),
                "num_coarse_samples": self.config.n_coarse,
                "num_fine_samples": self.config.n_fine,
                "pos_emb_xyz": self.config.pos_emb_xyz,
                "pos_emb_dir": self.config.pos_emb_dir,
                "occupancy_train": int(occupancy_train),
                "occupancy_train_samples": int(occupancy_train_samples),
                "occupancy_train_merge": bool(occupancy_train_merge),
                "occupancy_train_warmup": int(occupancy_train_warmup),
                "occupancy_train_update": int(occupancy_train_update),
                "occupancy_train_until": int(occupancy_train_until),
                "occupancy_train_dilate": int(occupancy_train_dilate),
                "occupancy_train_cache": bool(occupancy_train_cache)}
            if self.model_path is not None and self.state is None:
                checkpoint.warn_train_config_mismatch(self.model_path,
                                                      self._train_config)
        lr = learning_rate
        if lr_final > 0.0 and lr_decay_steps > 0:
            lr = engine.exponential_lr(learning_rate, lr_final,
                                       lr_decay_steps)
        self.optimizer = engine.make_optimizer(optimizer, lr)
        if self.state is None:
            init = torch.Generator(device=self.device).manual_seed(seed)
            state = engine.init_train_state(init, self.config, self.optimizer)
            if self.model_path is not None:
                logging.info("Loading NeRF weights from %s", self.model_path)
                state = checkpoint.load_train_state(self.model_path, state,
                                                    self.device)
            self.state = state
        if group is not None:
            from keras_nerf_tpu_torch.parallel import replicate

            replicate(self.state, group)
        self._seed = seed
        # Each rank draws its own fine samples (JAX folds the device index
        # into the key); rank 0 draws what an ungrouped model draws.
        self._generator = self._rank_generator(seed + 1)
        self._train_draws = self._rank_generator(seed + 2)
        self.quantized_render = bool(quantized_render)
        if (self.quantized_render
                and not engine.resolve_use_kernels(self.config, self.device)):
            logging.warning("quantized_render requires the kernel render "
                            "path; flag ignored")
            self.quantized_render = False
        self._packed_q = None
        self._packed_q_state = None
        self.metrics = {n: MeanTracker() for n in self.METRIC_NAMES}
        self.val_metrics = {n: MeanTracker() for n in self.METRIC_NAMES}
        return self

    def _require_compiled(self):
        if self.state is None:
            raise RuntimeError("call compile() first")

    @property
    def is_chief(self) -> bool:
        """True on the one process that logs and writes files: rank 0 of
        the group, or the only process."""
        return self.group is None or self.group.rank == 0

    def _rank_generator(self, seed: int) -> torch.Generator:
        from keras_nerf_tpu_torch.parallel import rank_seed

        rank = 0 if self.group is None else self.group.rank
        return torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, rank))

    def _shard(self, batch):
        from keras_nerf_tpu_torch.parallel import shard_batch

        return shard_batch(batch, self.group, self.shard_rays)

    def _bake_replicated(self, density, grid_size, aabb, threshold, dilate):
        """``bake_occupancy_grid`` of ``density``; under a group baked on
        rank 0 alone and broadcast (`nerf.py:419-421`)."""
        from keras_nerf_tpu_torch.ops import occupancy as occ_mod

        if self.is_chief:
            grid = occ_mod.bake_occupancy_grid(
                density, grid_size, aabb, threshold, dilate=dilate,
                device=self.device)
        else:
            grid = torch.empty((grid_size,) * 3, dtype=torch.float32,
                               device=self.device)
        if self.group is not None:
            self.group.broadcast_(grid)
        return grid

    def _on_device(self, batch):
        images, rays = batch
        return (torch.as_tensor(images, dtype=torch.float32,
                                device=self.device),
                tuple(torch.as_tensor(x, dtype=torch.float32,
                                      device=self.device) for x in rays))

    def _eval_draws(self, whole: bool = False) -> torch.Generator:
        """The same fine draws for every evaluation (JAX's fixed eval key),
        this rank's own unless ``whole`` (a batch every rank evaluates
        alike)."""
        if whole:
            return torch.Generator(device=self.device).manual_seed(
                self._seed + 3)
        return self._rank_generator(self._seed + 3)

    # ------------------------------------------------------------------ steps

    def _train_step(self, batch, fine_draws=None, indices=None) -> dict:
        """One step; the metrics stay 0-d tensors on the device. Once the
        occupancy tier has a grid the step is the occupancy step
        (warm-up and pre-bake epochs run the exact step); with the
        probe-row cache and the batch's image ``indices`` it gathers the
        cached rows instead of probing the grid (`nerf.py:366-383`).
        Under a group the rank trains on its share of the global batch."""
        kw = {}
        if self.occupancy_train > 0 and self._occ_train_grid is not None:
            kw = dict(occupancy=self._occ_spec, occ_grid=self._occ_train_grid)
            if self._occ_probe_cache is not None and indices is not None:
                rows = self._occ_probe_cache[torch.as_tensor(
                    indices, device=self._occ_probe_cache.device)]
                kw["occ_rows"] = rows.reshape(-1, rows.shape[-1])
        batch = self._on_device(batch)
        if self.group is not None:
            batch = self._shard(batch)
        self.state, metrics = engine.train_step(
            self.state, batch,
            self._train_draws if fine_draws is None else fine_draws,
            self.optimizer, self.config, self.ray_chunks, self.loss_fn,
            group=self.group, debug_grads=self.debug_grads, **kw)
        if self.debug_nans:
            self._raise_on_nans(metrics)
        return metrics

    def _raise_on_nans(self, metrics: dict):
        """``--debug_nans``: a non-finite loss or gradient norm raises (the
        reference's per-gradient ``assert_all_finite``, `nerf.py:380-382`);
        this waits for the step."""
        for name in ("coarse_loss", "fine_loss", "coarse_grad_norm",
                     "fine_grad_norm"):
            value = float(metrics[name])
            if not math.isfinite(value):
                raise FloatingPointError(
                    f"debug_nans: {name} = {value} at step {self.state.step}")

    def _maybe_update_occupancy_train(self, epoch: int, train_dataset=None):
        """(Re-)bake the training grid from the live fine model at the
        start of ``epoch`` (`nerf.py:385-430`): nothing before the warm-up
        epoch; then a bake every ``occupancy_train_update`` epochs (the
        model sharpens, the grid follows); from ``occupancy_train_until``
        on, no grid (exact steps). With the cache, every train image's
        probe rows are rebuilt against each new grid."""
        if self.occupancy_train <= 0:
            return
        cfg = self._occ_train_cfg
        if cfg["until"] > 0 and epoch >= cfg["until"]:
            if self._occ_train_grid is not None:
                logging.info(
                    "occupancy-train: epoch %d >= --occupancy_train_until "
                    "%d; exact steps for the remaining epochs", epoch,
                    cfg["until"])
                self._occ_train_grid = None
                self._occ_probe_cache = None
            return
        if epoch < cfg["warmup"]:
            return
        if (self._occ_train_grid is not None
                and (epoch - cfg["warmup"]) % cfg["update"] != 0):
            return
        from keras_nerf_tpu_torch.ops import occupancy as occ_mod

        density = occ_mod.model_density_fn(self.fine_params, self.config)
        grid = self._bake_replicated(density, cfg["grid_size"],
                                     occ_mod.DEFAULT_AABB, cfg["threshold"],
                                     cfg["dilate"])
        if self._occ_train_grid is None and self.is_chief:
            logging.info("occupancy-train: first grid baked at epoch %d "
                         "(%d^3, %.1f%% occupied)", epoch, cfg["grid_size"],
                         100.0 * float(grid.mean()))
        self._occ_train_grid = grid
        if self.occupancy_train_cache:
            self._occ_probe_cache = self._build_probe_cache(grid,
                                                            train_dataset)

    def _build_probe_cache(self, grid, train_dataset):
        """Every train image's probe rows against ``grid``, ``[N, H W,
        n_probe]`` uint8 on the device (`nerf.py:432-449`); None, with a
        warning, for a dataset without poses (the steps then probe)."""
        if train_dataset is None or not hasattr(train_dataset, "poses"):
            logging.warning(
                "occupancy_train_cache: train dataset does not expose "
                "poses/focal; falling back to per-step grid probing")
            return None
        from keras_nerf_tpu_torch.ops import occupancy as occ_mod

        _, probe, near, far, aabb, _ = self._occ_spec
        return occ_mod.probe_rows_for_poses(
            train_dataset.poses, train_dataset.focal, grid,
            image_height=self.image_height, image_width=self.image_width,
            near=near, far=far, n_probe=probe, aabb=aabb)

    def _record(self, trackers: dict, metrics: dict, where: str) -> dict:
        """Add ``metrics`` to ``trackers`` and warn of a zero or non-finite
        gradient norm, naming the parameter tensor under ``debug_grads``
        (`nerf.py:451-465`)."""
        for k, v in metrics.items():
            if k in trackers:
                trackers[k].update(v)
        if not self.is_chief:
            return metrics
        for name in ("coarse_grad_norm", "fine_grad_norm"):
            g = metrics.get(name)
            if g is not None and (g == 0.0 or not math.isfinite(g)):
                logging.warning("%s = %s %s", name, g, where)
        for k, v in metrics.items():
            if k.startswith("grad_norm/") and (v == 0.0
                                               or not math.isfinite(v)):
                logging.warning("dead/non-finite gradient in %s (norm = %s) "
                                "%s", k[len("grad_norm/"):], v, where)
        return metrics

    def train_step(self, batch, fine_draws=None,
                   indices=None) -> dict[str, float]:
        """One gradient step; returns the six metrics and both gradient
        norms as floats (`nerf.py:332-473`). ``indices``, the batch's image
        indices, let the step gather the probe-row cache's rows."""
        self._require_compiled()
        metrics = {k: float(v) for k, v in
                   self._train_step(batch, fine_draws, indices).items()}
        return self._record(self.metrics, metrics,
                            f"at step {self.state.step}")

    def _eval_step(self, batch, fine_draws=None) -> dict:
        """One evaluation. Under a group the rank's share of a global batch
        that the ranks divide, or, where they do not divide it, the whole
        batch on every rank with the same draws and no collective
        (`nerf.py:321-329,480-486`)."""
        batch = self._on_device(batch)
        draws, chunks, kw = self._eval_draws(), self.ray_chunks, {}
        if self.group is not None:
            dim = 1 if self.shard_rays else 0
            if batch[0].shape[dim] % self.group.size:
                draws = self._eval_draws(whole=True)
                chunks = min(chunks, self.image_height * self.image_width)
            else:
                batch = self._shard(batch)
                kw = dict(group=self.group, gather_images=self.shard_rays)
        return engine.eval_step(
            self.state, batch, draws if fine_draws is None else fine_draws,
            self.config, chunks, self.loss_fn, **kw)

    def test_step(self, batch, fine_draws=None) -> dict[str, float]:
        """Full chunked render plus the six metrics (`nerf.py:475-497`)."""
        self._require_compiled()
        metrics = {k: float(v) for k, v in
                   self._eval_step(batch, fine_draws).items()}
        return self._record(self.val_metrics, metrics, "in evaluation")

    def evaluate(self, dataset) -> dict[str, float]:
        """Mean metrics of :meth:`test_step` over a dataset."""
        self._require_compiled()
        for tracker in self.val_metrics.values():
            tracker.reset()
        n = 0
        for batch in dataset:
            self.test_step(batch)
            n += 1
        if n == 0:
            raise ValueError("evaluate: dataset yielded no batches")
        return {k: t.result() for k, t in self.val_metrics.items()}

    @staticmethod
    def _fetch(pending: list[dict]) -> list[dict]:
        """Per-step metric tensors -> floats, in one copy from the device."""
        if not pending:
            return []
        keys = list(pending[0])
        values = torch.stack([torch.stack([m[k].float() for k in keys])
                              for m in pending]).cpu().tolist()
        return [dict(zip(keys, row)) for row in values]

    # -------------------------------------------------------------------- fit

    def fit(self, train_dataset, validation_data=None, epochs: int = 1,
            initial_epoch: int = 0, callbacks=(), verbose: bool = True):
        """Keras-style epoch loop (`nerf.py:665-786`). Callbacks get
        ``set_model(self)``, ``on_train_batch_end(batch, logs)`` and
        ``on_epoch_end(epoch, logs)`` with the train means and their
        ``val_`` twins. Step metrics stay on the device and reach the host
        once per epoch (`nerf.py:686-692`), unless a verbose callback wants
        them every batch. Each epoch starts with the occupancy tier's bake
        schedule (:meth:`_maybe_update_occupancy_train`). Returns one logs
        dict per epoch."""
        self._require_compiled()
        for cb in callbacks:
            if hasattr(cb, "set_model"):
                cb.set_model(self)
        # Pixel-sampling batches are scrambled (image, pixel) draws: the
        # windowed train SSIM is over no images (`nerf.py:679-686`).
        if (getattr(train_dataset, "PIXELWISE_METRICS_ONLY", False)
                and self.is_chief):
            logging.warning(
                "pixel-sampling mode: train coarse_ssim/fine_ssim are "
                "computed over scrambled pixel batches — ignore them "
                "(val_*_ssim remain whole-image and meaningful)")
        eager = any(hasattr(cb, "on_train_batch_end")
                    and getattr(cb, "verbose", True) for cb in callbacks)
        history = []
        for epoch in range(initial_epoch, epochs):
            self._maybe_update_occupancy_train(epoch, train_dataset)
            for tracker in (*self.metrics.values(),
                            *self.val_metrics.values()):
                tracker.reset()
            pending = []
            for batch_idx, batch in enumerate(train_dataset):
                indices = getattr(train_dataset, "last_indices", None)
                if eager:
                    logs = self.train_step(batch, indices=indices)
                    for cb in callbacks:
                        if hasattr(cb, "on_train_batch_end"):
                            cb.on_train_batch_end(batch_idx, logs)
                else:
                    pending.append(self._train_step(batch, indices=indices))
            for batch_idx, logs in enumerate(self._fetch(pending)):
                self._record(self.metrics, logs,
                             f"(epoch {epoch} batch {batch_idx})")
                for cb in callbacks:
                    if hasattr(cb, "on_train_batch_end"):
                        cb.on_train_batch_end(batch_idx, logs)
            if validation_data is not None:
                val = self._fetch([self._eval_step(batch)
                                   for batch in validation_data])
                for logs in val:
                    self._record(self.val_metrics, logs, "in validation")
            logs = {k: t.result() for k, t in self.metrics.items()}
            logs.update({f"val_{k}": t.result()
                         for k, t in self.val_metrics.items()})
            history.append(logs)
            if verbose and self.is_chief:
                logging.info("epoch %d: %s", epoch, " ".join(
                    f"{k}={v:.4f}" for k, v in logs.items()))
            for cb in callbacks:
                if hasattr(cb, "on_epoch_end"):
                    cb.on_epoch_end(epoch, logs)
        return history

    # ----------------------------------------------------------- persistence

    def save_model(self, path: str, weights_only: bool = False):
        """Config JSON, both weight files and the optimizer state
        (`nerf.py:790-797`), readable by ``keras_nerf_tpu``. Under a group
        rank 0 writes and every rank returns once it has."""
        self._require_compiled()
        if self.is_chief:
            checkpoint.save_model(path, self.state, self.config,
                                  weights_only=weights_only,
                                  train_config=self._train_config)
        if self.group is not None:
            self.group.barrier()

    def load_model(self, path: str):
        """Restore architecture, weights and optimizer state from a
        checkpoint directory (`nerf.py:799-822`). The runtime options the
        checkpoint does not record (``white_background``, ``use_kernels``,
        ``fast_render``) are kept; the baked occupancy grid, which belongs
        to the old weights, is dropped (the int8 calibration follows the
        state object by itself)."""
        self._require_compiled()
        old = self.config
        self.config = checkpoint.load_model_config(
            path, white_background=old.white_background,
            use_kernels=old.use_kernels, fast_render=old.fast_render)
        self.model_path = path
        logging.info("Loading NeRF weights from %s", path)
        self.state = checkpoint.load_train_state(path, self.state,
                                                 self.device)
        self.occ_grid = None
        self._occ_aabb = None

    def predict_and_render_images(
            self, rays, with_weights: bool = True, coarse_image: bool = True,
            fine_draws: torch.Generator | Sequence[torch.Tensor] | None = None
    ) -> tuple[dict, dict]:
        """Render ``rays = (origin, direction, points)`` into ``(coarse,
        fine)`` dicts (`nerf.py:229-304`). ``with_weights=False`` drops the
        per-sample weights; ``coarse_image=False`` skips the coarse colour
        heads (coarse image zero) — the orbit renderer uses both. The fine
        pass follows ``compile(fast_render=)``; ``fine_draws`` tensors are
        then ``[ray_chunks, fast_render]``. Under a group each rank renders
        its height band of ``rays`` (``fine_draws`` then those of the
        band's chunks) and every rank returns the whole images
        (``parallel.sharded_render``; `nerf.py:499-534`)."""
        self._require_compiled()
        rays = tuple(torch.as_tensor(x, dtype=torch.float32,
                                     device=self.device) for x in rays)
        if self.quantized_render:
            self._ensure_packed_q(rays, torch.Generator(
                device=self.device).manual_seed(self._seed + 4))
        if self.group is not None:
            from keras_nerf_tpu_torch.parallel import sharded_render

            render = sharded_render(self.group, self.config, self.ray_chunks,
                                    with_weights=with_weights,
                                    coarse_image=coarse_image,
                                    quantized=self.quantized_render)
            return render(self.coarse_params, self.fine_params, rays,
                          self._generator if fine_draws is None
                          else fine_draws, self._packed_q)
        return engine.render_image_batch(
            self.coarse_params, self.fine_params, rays,
            self._generator if fine_draws is None else fine_draws,
            self.config, self.ray_chunks, with_weights=with_weights,
            coarse_image=coarse_image,
            packed_q=self._packed_q if self.quantized_render else None)

    def _ensure_packed_q(self, rays, fine_draws):
        """Calibrate and quantize the int8 render weights once per state
        object (`nerf.py:536-554`), on this call's rays (strided over the
        image, :func:`engine.quantize_render_params`) with the calibration
        draws ``fine_draws``. Any weight change (a train step, a checkpoint
        load) replaces ``self.state`` and so calibrates again. Under a
        group rank 0's int8 weights are broadcast to the others."""
        if self._packed_q is not None and self._packed_q_state is self.state:
            return
        self._packed_q = engine.quantize_render_params(
            self.coarse_params, self.fine_params, rays, fine_draws,
            self.config)
        if self.group is not None:
            from keras_nerf_tpu_torch.parallel import replicate

            replicate(self._packed_q, self.group)
        self._packed_q_state = self.state
        if self.is_chief:
            logging.info("quantized_render: int8 weights calibrated")

    # ------------------------------------------------ occupancy-grid rendering

    def bake_occupancy(self, grid_size: int = 64, sigma_threshold: float = 1.0,
                       dilate: int = 1, aabb=None) -> torch.Tensor:
        """Bake a binary ``[G, G, G]`` occupancy grid from the FINE model's
        density over ``aabb`` (``ops/occupancy.py``; `nerf.py:558-582`):
        one ``apply_mlp`` launch per 262,144 voxels on the kernel path.
        Logs the occupied share; :meth:`render_occupancy` renders with it.
        Under a group rank 0 bakes and broadcasts the grid."""
        self._require_compiled()
        from keras_nerf_tpu_torch.ops import occupancy as occ_mod

        if aabb is None:
            aabb = occ_mod.DEFAULT_AABB
        aabb = tuple(tuple(float(v) for v in row) for row in aabb)
        density = occ_mod.model_density_fn(self.fine_params, self.config)
        self.occ_grid = self._bake_replicated(density, grid_size, aabb,
                                              sigma_threshold, dilate)
        self._occ_aabb = aabb
        if self.is_chief:
            logging.info("Baked %d^3 occupancy grid: %.1f%% occupied",
                         grid_size, 100.0 * float(self.occ_grid.mean()))
        return self.occ_grid

    def render_occupancy(
            self, rays,
            fine_draws: torch.Generator | Sequence[torch.Tensor] | None = None,
            near: float = 2.0, far: float = 6.0, n_samples: int = 64,
            n_probe: int = 64) -> dict:
        """Occupancy-accelerated render of ``rays = (origin, direction,
        points)`` with the FINE model alone, ``n_samples`` MLP points per
        ray inside occupied space: ``{"image", "depth"}`` (`nerf.py:
        584-626`). Needs :meth:`bake_occupancy` first. Compiled with
        ``quantized_render=True``, the fine MLP runs the int8 kernel
        (calibrated once per state on these rays, as
        :meth:`predict_and_render_images` does): the two tiers compose.
        Under a group in height bands, as :meth:`predict_and_render_images`
        renders (``parallel.sharded_render_occ``)."""
        self._require_compiled()
        if self.occ_grid is None:
            raise RuntimeError("call bake_occupancy() before "
                               "render_occupancy()")
        from keras_nerf_tpu_torch.ops import occupancy as occ_mod

        rays = tuple(torch.as_tensor(x, dtype=torch.float32,
                                     device=self.device) for x in rays)
        packed_q = None
        if self.quantized_render:
            self._ensure_packed_q(rays, torch.Generator(
                device=self.device).manual_seed(self._seed + 4))
            packed_q = self._packed_q[1]
        if self.group is not None:
            from keras_nerf_tpu_torch.parallel import sharded_render_occ

            render = sharded_render_occ(
                self.group, self.config, self.ray_chunks, near=near, far=far,
                n_samples=n_samples, n_probe=n_probe, aabb=self._occ_aabb,
                quantized=packed_q is not None)
            return render(self.fine_params, rays, self.occ_grid,
                          self._generator if fine_draws is None
                          else fine_draws, packed_q)
        return occ_mod.render_image_batch_occ(
            self.fine_params, rays, self.occ_grid,
            self._generator if fine_draws is None else fine_draws,
            self.config, near=near, far=far, n_samples=n_samples,
            n_probe=n_probe, ray_chunks=self.ray_chunks,
            aabb=self._occ_aabb, packed_q=packed_q)
