"""Host ms a training step spends enqueueing Adam: the port's
`engine.update` spans (one `Optimizer.update` a model) inside its
`fit.step` spans, over the traced stretch's steps."""

from nerfbench.layer_metrics import _spans


def read(stretch):
    return _spans.ms_per_unit(stretch, "train", "engine.update", "fit.step")
