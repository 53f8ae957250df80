"""Where the port's entry points run: the card, unless asked otherwise."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``. Entry points default to CUDA and
    raise when no card is visible, instead of carrying on on the CPU;
    the CPU is used only when the caller asks for it by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: repro_torch runs on the GPU; pass "
            "device='cpu' (--device cpu on the command line) to run on the CPU"
        )
    return dev
