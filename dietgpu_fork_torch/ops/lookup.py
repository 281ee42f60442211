"""Table lookups: kernel K14 and its plain versions.

The counterpart of the JAX package's ``ops/pallas/lookup.py``, the gather
primitive of its portable walks:

* ``chunked_lookup(tables, idx)``: tables int32[B, H], idx int32[B, N]
  -> out[b, n] = tables[b, clamp(idx[b, n], 0, H - 1)];
* ``rowwise_lookup(tables, idx)``: the same with one table per row,
  tables int32[R, H], idx int32[R, K], K <= 128.

Both send CUDA tensors to the kernels (``csrc/lookup.cu``) and CPU tensors
to the plain versions, a clamp and one ``torch.gather``. The port's own
walks (``ops/rans_decode.py``, ``ops/rans_encode.py``) keep their gathers.
"""

from __future__ import annotations

import torch

from ..core.config import use_kernels
from ..runtime import cuda_kernels as K

ROWWISE_MAX_K = 128


def _check_lookup_args(tables, idx, max_k=None):
    for name, t in (("tables", tables), ("idx", idx)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D torch.int32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tables.shape[0] != idx.shape[0]:
        raise ValueError(f"{tables.shape[0]} tables for {idx.shape[0]} rows")
    if tables.shape[1] < 1:
        raise ValueError("tables must not be empty")
    if max_k is not None and idx.shape[1] > max_k:
        raise ValueError(f"at most {max_k} indices a row, got {idx.shape[1]}")
    if tables.device != idx.device:
        raise ValueError("tables and idx must lie on one device")


def chunked_lookup(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tables int32[B, H] (u32 values), idx int32[B, N] -> int32[B, N],
    each index clamped into [0, H)."""
    _check_lookup_args(tables, idx)
    if use_kernels(idx):
        return K.chunked_lookup(tables, idx)
    return chunked_lookup_plain(tables, idx)


def chunked_lookup_plain(tables, idx):
    """Plain PyTorch version of K14's chunked lookup; runs on any device."""
    _check_lookup_args(tables, idx)
    return _gather(tables, idx)


def rowwise_lookup(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tables int32[R, H], idx int32[R, K] with K <= 128 -> int32[R, K]:
    each row gathers from its own table, indices clamped into [0, H)."""
    _check_lookup_args(tables, idx, ROWWISE_MAX_K)
    if use_kernels(idx):
        return K.rowwise_lookup(tables, idx)
    return rowwise_lookup_plain(tables, idx)


def rowwise_lookup_plain(tables, idx):
    """Plain PyTorch version of K14's rowwise lookup; runs on any device."""
    _check_lookup_args(tables, idx, ROWWISE_MAX_K)
    return _gather(tables, idx)


def _gather(tables, idx):
    safe = idx.to(torch.int64).clamp(0, tables.shape[1] - 1)
    return torch.gather(tables, 1, safe)
