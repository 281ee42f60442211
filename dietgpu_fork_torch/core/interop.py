"""Bit-exact hand-over of uint32 rows between numpy and the port.

The port carries uint32 bit patterns as ``torch.int32`` tensors; these two
functions reinterpret, never convert, so data and archives cross between
the port, the JAX package and the NumPy oracle unchanged.
"""

from __future__ import annotations

import numpy as np
import torch


def rows_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 ndarray -> int32 tensor holding the same bits, on ``device``."""
    a = np.ascontiguousarray(a)
    if a.dtype != np.uint32:
        raise TypeError(f"expected uint32, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def rows_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 ndarray holding the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected torch.int32, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
