"""The port's own kernels (kernels/csrc) launched a training step: the
`csrc_launches` count of its `fit.step` spans, the `KernelWrapper` calls
inside each, averaged over the traced stretch."""

from nerfbench.layer_metrics import _spans


def read(stretch):
    return _spans.launches_per_unit(stretch, "train", "fit.step")
