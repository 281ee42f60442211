"""Bit-exact hand-over of data between numpy and the port.

The port carries uint32 bit patterns as ``torch.int32`` tensors, archives
as ``torch.uint8`` rows and floats as torch float tensors; these functions
reinterpret, never convert, so data and archives cross between the port,
the JAX package and the NumPy oracle unchanged.
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


_WORD_INT = {2: np.int16, 4: np.int32, 8: np.int64}


def bytes_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """uint8 ndarray (an archive row or a matrix of them) -> torch.uint8
    tensor with the same bytes, on ``device``."""
    a = np.ascontiguousarray(a)
    if a.dtype != np.uint8:
        raise TypeError(f"expected uint8, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def bytes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch.uint8 tensor -> uint8 ndarray with the same bytes."""
    if t.dtype != torch.uint8:
        raise TypeError(f"expected torch.uint8, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy()


def floats_from_words(words: np.ndarray, dtype: torch.dtype,
                      device="cpu") -> torch.Tensor:
    """Unsigned float words (uint16, uint32 or uint64 ndarray) -> a torch
    tensor of ``dtype`` (float16, bfloat16, float32 or float64) holding
    the same bits."""
    words = np.ascontiguousarray(words)
    np_int = _WORD_INT[words.itemsize]
    t = torch.from_numpy(words.view(np_int).copy()).view(dtype)
    if t.element_size() != words.itemsize:
        raise TypeError(f"{words.dtype} words do not fit {dtype}")
    return t.to(device)

