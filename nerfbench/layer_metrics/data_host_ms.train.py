"""Host milliseconds inside the port's NeRFDataset iterator a batch (the
image's upload and the rays), the mean over every batch of the window."""


def read(stretch):
    if stretch is None or stretch.get("kind") != "train":
        return None
    times = stretch.get("data_host_s") or []
    return 1e3 * sum(times) / len(times) if times else None
