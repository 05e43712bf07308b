"""numpy <-> torch, without loss.

numpy has no bfloat16 of its own: arrays that carry one (``ml_dtypes``'
``bfloat16``, as JAX hands them out) cross through float32, which holds
every bfloat16 value exactly, and are narrowed again on the torch side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def to_torch(array, *, device=None, dtype=None) -> torch.Tensor:
    """A numpy-convertible array as a tensor on ``device``."""
    dev = resolve_device(device)
    a = np.asarray(array)
    bf16 = a.dtype.name == "bfloat16"
    if bf16:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a, order="C")).to(dev)
    if bf16:
        t = t.to(torch.bfloat16)
    return t if dtype is None else t.to(dtype)


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a numpy array (bf16 widened to f32)."""
    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
