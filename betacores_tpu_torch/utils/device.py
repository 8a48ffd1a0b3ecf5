"""Where an entry point runs: the card unless the caller asks for another
device."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device``, or the card when None. Without CUDA the card raises: an
    entry point never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev
