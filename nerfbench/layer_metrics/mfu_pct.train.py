"""The whole step's share of the card's bf16 peak: the model's FLOPs
(nerfbench/flops.py: unpadded, no recompute) over its wall time at 989
TFLOP/s, the wall of the plain stretch just before the traced one, which
the profiler does not slow."""

from nerfbench.layer_metrics import _stretch


def read(stretch):
    return _stretch.mfu_pct(stretch, "train")
