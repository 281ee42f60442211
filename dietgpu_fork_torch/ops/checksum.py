"""Batched XOR byte checksum, in plain PyTorch on any device.

A port of the JAX package's ``ops/checksum.py``: the reference checksum is
the XOR of all input bytes (GpuChecksum.cuh:26-93). The JAX package
computes it outside any Pallas kernel; on the card the port's kernels do
(K1, K5 and K8 fold it in the pass that counts the bytes, and K8's
checksum-only form checks decoded bytes, ``histogram.checksum_rows``),
and these folds are their plain versions' contract. torch has no XOR
reduction, so a row is folded in halves with ``^`` until one column is
left; u32 values are int64 carriers (``bitops``), so no fold goes
through an int32 arithmetic shift.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .bitops import M32


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of each row of a 2-D integer tensor -> [B]."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = F.pad(x, (0, 1))
        x = x[:, 0::2] ^ x[:, 1::2]
    if x.shape[1] == 0:
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    return x[:, 0]


def mask_packed_bytes(x: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """Zero all bytes at positions >= nbytes[b] of u32 rows (int64
    carriers)."""
    W = x.shape[1]
    wpos = torch.arange(W, dtype=torch.int64, device=x.device)[None, :]
    c = (nbytes.to(torch.int64)[:, None] - 4 * wpos).clamp(0, 4)
    return x & (((1 << (8 * c)) - 1) & M32)


def checksum_packed(x: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """XOR of the first nbytes[b] bytes of each u32 row (int64 carriers):
    XOR the masked words, then fold the four byte positions
    (the JAX package's ``ops/checksum.py:45-53``). Returns int64[B] in
    [0, 255]."""
    w = _xor_fold(mask_packed_bytes(x, nbytes))
    w = w ^ (w >> 16)
    return (w ^ (w >> 8)) & 0xFF


def checksum_batched(data_u8: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """data_u8: uint8[B, S]; sizes: [B] valid byte counts. Returns int64[B],
    the XOR of each row's first sizes[b] bytes."""
    if data_u8.dtype != torch.uint8 or data_u8.dim() != 2:
        raise TypeError("data_u8 must be a 2-D torch.uint8 tensor")
    pos = torch.arange(data_u8.shape[1], device=data_u8.device)
    keep = pos[None, :] < sizes.to(device=data_u8.device, dtype=torch.int64)[:, None]
    return _xor_fold(torch.where(keep, data_u8, 0)).to(torch.int64)
