"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``, raising when it names a CUDA device
    and no card is present (entry points never fall back to the CPU on
    their own; callers that want the CPU pass ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available "
            f"(pass device='cpu' to run the plain torch versions)")
    return dev
