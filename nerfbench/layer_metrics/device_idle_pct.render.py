"""100 minus the union of the card's operation spans a unit (the traced
stretch's), as a share of a unit's wall time in the plain stretch just
before it, which the profiler does not slow."""

from nerfbench.layer_metrics import _stretch


def read(stretch):
    return _stretch.idle_pct(stretch, "render")
