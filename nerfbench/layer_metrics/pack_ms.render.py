"""Host ms a frame spends packing both MLPs' weights for the kernels: the
port's `engine.pack` spans (`render_image_batch`) inside its `render.call`
spans, over the traced stretch's frames."""

from nerfbench.layer_metrics import _spans


def read(stretch):
    return _spans.ms_per_unit(stretch, "render", "engine.pack",
                              "render.call")
