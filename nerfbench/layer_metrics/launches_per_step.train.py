"""Kernels, copies and fills on the card a training step: the profiler's
device activities over the traced stretch's steps."""

from nerfbench.layer_metrics import _stretch


def read(stretch):
    return _stretch.launches_per_unit(stretch, "train")
