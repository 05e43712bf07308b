"""The one place that resolves a ``device=`` argument.

Entry points that create tensors default to the card. There is no CPU
default: without CUDA the caller must ask for the CPU explicitly, so a
run that was meant for the GPU never carries on quietly on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU"
        )
    return dev
