"""The MLP kernels' share of their roofline: the model's FLOPs at the
bf16 peak over the device time of the kernels that _stretch.MLP_KERNELS
names, in the traced stretch."""

from nerfbench.layer_metrics import _stretch


def read(stretch):
    return _stretch.mlp_roofline_pct(stretch, "render")
