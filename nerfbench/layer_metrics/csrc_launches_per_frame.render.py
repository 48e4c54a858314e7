"""The port's own kernels (kernels/csrc) launched a frame: the
`csrc_launches` count of its `render.call` spans, the `KernelWrapper` calls
inside each, averaged over the traced stretch."""

from nerfbench.layer_metrics import _spans


def read(stretch):
    return _spans.launches_per_unit(stretch, "render", "render.call")
