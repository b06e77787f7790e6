"""The device an entry point runs on: the card, unless the caller asks for
the CPU."""
from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device with no card present
    raises: an entry point never falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pencil_tpu_torch runs on a CUDA device (an NVIDIA card) by "
            "default and none is available; pass device='cpu' for the "
            "plain PyTorch path on the CPU")
    return dev
