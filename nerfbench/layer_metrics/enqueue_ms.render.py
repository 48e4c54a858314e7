"""Host ms a frame spends in the program: the mean duration of the port's
`render.call` spans (`NeRF.predict_and_render_images`) over the traced
stretch."""

from nerfbench.layer_metrics import _spans


def read(stretch):
    return _spans.mean_ms(stretch, "render", "render.call")
