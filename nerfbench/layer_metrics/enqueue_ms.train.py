"""Host ms a training step spends in the program: the mean duration of the
port's `fit.step` spans (`NeRF.fit`, around each step's enqueue) over the
traced stretch."""

from nerfbench.layer_metrics import _spans


def read(stretch):
    return _spans.mean_ms(stretch, "train", "fit.step")
