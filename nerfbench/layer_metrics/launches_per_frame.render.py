"""Kernels, copies and fills on the card a frame: the profiler's device
activities over the traced stretch's frames."""

from nerfbench.layer_metrics import _stretch


def read(stretch):
    return _stretch.launches_per_unit(stretch, "render")
