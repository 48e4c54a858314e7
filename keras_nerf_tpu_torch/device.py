"""Device resolution: the card is the default, the CPU only on request.

Every entry point of the package takes ``device="cuda"`` by default. The CPU
runs only when a caller passes ``device="cpu"`` (the tests do); asking for
``cuda`` on a machine without a card raises instead of falling back.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev
