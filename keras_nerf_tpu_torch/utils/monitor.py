"""Training monitor: ``log.csv``, PNG render panels, a checkpoint every
epoch, and epoch-level resume (port of ``keras_nerf_tpu/utils/monitor.py``,
after the reference's ``NeRFTrainMonitor``,
`keras_nerf/model/nerf/callback.py:8-226`).

* ``log.csv``: ``epoch``, the six train metrics and their ``val_`` twins,
  one row every ``update_freq`` epochs, the header once; an existing file
  sets ``last_epoch`` and the loss histories (every row is read);
* every ``update_freq`` epochs: a 2 x 5 panel (coarse/fine image and depth,
  ground truth, log-scale loss curves) per image of a fixed batch as
  ``test_{i}_{epoch}.png`` and a 1 x 5 panel of a fresh batch as
  ``test_sample_{i}_{epoch}.png``; verbose mode adds per-batch
  ``debug_{i}_{batch}.png``. matplotlib is imported for the first panel;
  where it is missing the panels are skipped, with one logged line;
* the checkpoint goes to ``{log_dir}/model`` (the full config at epoch 0,
  weights and optimizer state after).

Under a model compiled with a group, the monitor runs on every rank: its
renders are the banded, collective ones, so every rank takes part in them,
and rank 0 alone draws the panels and writes ``log.csv`` and the
checkpoint while the others wait.
"""

from __future__ import annotations

import importlib.util
import logging
import os
from csv import DictReader, DictWriter

import numpy as np


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class NeRFTrainMonitor:
    """Callback of :meth:`NeRF.fit` (`callback.py:8`)."""

    def __init__(self, dataset, log_dir: str, batch_size: int,
                 update_freq: int = 1, verbose: bool = False):
        self.dataset = dataset
        self.log_dir = log_dir
        self.batch_size = batch_size
        self.update_freq = update_freq
        self.verbose = verbose
        self.model = None
        self._plt = None
        # Decided alike on every rank, since the panels' renders are
        # collective under a group.
        self._panels = importlib.util.find_spec("matplotlib") is not None
        if not self._panels:
            logging.info("matplotlib is not installed: the monitor writes "
                         "log.csv and checkpoints, no PNG panels")

        self.log_model_dir = os.path.join(log_dir, "model")
        os.makedirs(self.log_model_dir, exist_ok=True)
        self.coarse_log_list: list[float] = []
        self.val_coarse_log_list: list[float] = []
        self.fine_log_list: list[float] = []
        self.val_fine_log_list: list[float] = []
        self.coarse_log_list_batch: list[float] = []
        self.fine_log_list_batch: list[float] = []

        self.last_epoch = 0
        self.log_csv = os.path.join(log_dir, "log.csv")
        if os.path.exists(self.log_csv):
            with open(self.log_csv) as f:
                for row in DictReader(f):
                    self.coarse_log_list.append(float(row["coarse_loss"]))
                    self.val_coarse_log_list.append(
                        float(row["val_coarse_loss"]))
                    self.fine_log_list.append(float(row["fine_loss"]))
                    self.val_fine_log_list.append(float(row["val_fine_loss"]))
                    self.last_epoch = int(row["epoch"])
            if self.coarse_log_list:
                self.last_epoch += 1
            logging.info("Resuming monitor at epoch %d", self.last_epoch)

        if self.dataset.num_examples < batch_size:
            logging.warning("monitor dataset has %d images < batch_size %d; "
                            "rebatching", self.dataset.num_examples,
                            batch_size)
            self.dataset = self.dataset.rebatch(self.dataset.num_examples)
            self.batch_size = self.dataset.num_examples
        batches = self.dataset.take(1)
        if not batches:
            raise ValueError("monitor dataset yielded no batches")
        images, self.rays = batches[0]
        self.images = _numpy(images)
        self._fresh_iter = iter(self.dataset)
        next(self._fresh_iter, None)

    def set_model(self, model):
        self.model = model

    # ---------------------------------------------------------------- panels

    def _pyplot(self):
        if self._plt is None:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            self._plt = plt
        return self._plt

    def _chief(self) -> bool:
        return getattr(self.model, "is_chief", True)

    def _panel_row(self, fig, gs, row, coarse, fine, gt, i):
        titles = ["Coarse Image", "Coarse Depth", "Fine Image", "Fine Depth",
                  "Ground Truth"]
        arrays = [_numpy(coarse["image"][i]), _numpy(coarse["depth"][i]),
                  _numpy(fine["image"][i]), _numpy(fine["depth"][i]), gt[i]]
        for col, (title, arr) in enumerate(zip(titles, arrays)):
            ax = fig.add_subplot(gs[row, col])
            if arr.ndim == 2:
                ax.imshow(arr, cmap="inferno")
            else:
                ax.imshow(np.clip(arr, 0, 1))
            ax.set_title(title)
            ax.axis("off")

    def _curves(self, fig, gs, curves, title):
        ax = fig.add_subplot(gs[1, :])
        for values, color, style, label in curves:
            ax.plot(values, color=color, linestyle=style, label=label)
        ax.legend()
        ax.set_yscale("log")
        ax.set_title(title)

    def _save_panels(self, rays, images, name, curves=None, title=""):
        if not self._panels:
            return
        coarse, fine = self.model.predict_and_render_images(rays)
        if not self._chief():
            return
        plt = self._pyplot()
        for i in range(min(self.batch_size, images.shape[0])):
            fig = plt.figure(figsize=(20, 10 if curves else 5))
            gs = fig.add_gridspec(2 if curves else 1, 5)
            self._panel_row(fig, gs, 0, coarse, fine, images[..., :3], i)
            if curves:
                self._curves(fig, gs, curves, title)
            fig.savefig(os.path.join(self.log_dir, name.format(i=i)))
            plt.close(fig)

    # ------------------------------------------------------------- callbacks

    def on_train_batch_end(self, batch: int, logs: dict):
        if not self.verbose or self.model is None:
            return
        self.coarse_log_list_batch.append(logs["coarse_loss"])
        self.fine_log_list_batch.append(logs["fine_loss"])
        self._save_panels(self.rays, self.images, f"debug_{{i}}_{batch}.png",
                          [(self.coarse_log_list_batch, "blue", "solid",
                            "Coarse Train Loss"),
                           (self.fine_log_list_batch, "orange", "solid",
                            "Fine Train Loss")], f"Loss Batch Plot: {batch}")

    def on_epoch_end(self, epoch: int, logs: dict):
        if self.model is None:
            return
        self.coarse_log_list.append(logs["coarse_loss"])
        self.val_coarse_log_list.append(logs["val_coarse_loss"])
        self.fine_log_list.append(logs["fine_loss"])
        self.val_fine_log_list.append(logs["val_fine_loss"])
        if epoch % self.update_freq != 0:
            self.coarse_log_list_batch, self.fine_log_list_batch = [], []
            return

        self._save_panels(self.rays, self.images, f"test_{{i}}_{epoch}.png", [
            (self.coarse_log_list, "blue", "solid", "Coarse Train Loss"),
            (self.val_coarse_log_list, "blue", "dashed", "Coarse Val Loss"),
            (self.fine_log_list, "orange", "solid", "Fine Train Loss"),
            (self.val_fine_log_list, "orange", "dashed", "Fine Val Loss")],
            f"Loss Plot: {epoch}")
        fresh = next(self._fresh_iter, None)
        if fresh is None:
            self._fresh_iter = iter(self.dataset)
            fresh = next(self._fresh_iter, None)
        if fresh is not None:
            self._save_panels(fresh[1], _numpy(fresh[0]),
                              f"test_sample_{{i}}_{epoch}.png")

        if self._chief():
            write_header = (not os.path.exists(self.log_csv)
                            or os.path.getsize(self.log_csv) == 0)
            with open(self.log_csv, "a") as f:
                row = {"epoch": epoch, **logs}
                writer = DictWriter(f, row.keys())
                if write_header:
                    writer.writeheader()
                writer.writerow(row)

        self.model.save_model(self.log_model_dir, weights_only=(epoch != 0))
        self.coarse_log_list_batch, self.fine_log_list_batch = [], []
