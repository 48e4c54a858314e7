"""Host ms a batch in the port's loader: the mean duration of its
`data.batch` spans (`NeRFDataset`: the upload and the rays, up to the
batch's hand-over) over the traced stretch."""

from nerfbench.layer_metrics import _spans


def read(stretch):
    return _spans.mean_ms(stretch, "train", "data.batch")
