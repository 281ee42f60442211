"""Batched 256-bin byte histograms with the XOR checksum of the same bytes:
kernel K8 and its plain version.

A port of the JAX package's ``ops/histogram.py`` (``histogram_batched``
over u8 rows, ``histogram_packed`` over u32 rows). Only each member's
first ``sizes[b]`` bytes are counted: the kernel never reads the padding,
where the JAX package's MXU kernel counts it into bin 0 and subtracts it
afterwards (``histogram_mxu.py:175-177``).

``byte_hist`` sends a CUDA tensor to K8 (``csrc/byte_hist.cu``), which
folds the checksum of the bytes it counts in the same read (the
reference's ``checksumBatch`` + ``ansHistogramBatch`` in one pass), and a
CPU tensor to ``byte_hist_plain``: a row-offset ``torch.bincount`` over
the bytes below ``sizes[b]``, and ``checksum_batched``.

``checksum_rows`` is the checksum alone: a CUDA tensor goes to K8's
checksum-only form, which reads each row's live bytes once, in place,
whatever the rows' base and stride; a CPU tensor to ``checksum_batched``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.config import use_kernels
from ..core.constants import NUM_SYMBOLS
from ..runtime import cuda_kernels as K
from .checksum import checksum_batched


def _check_hist_args(rows: torch.Tensor, sizes: torch.Tensor) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError("rows must be a 2-D torch.uint8 tensor")
    if sizes.dim() != 1 or sizes.shape[0] != rows.shape[0]:
        raise TypeError(f"sizes must have shape [{rows.shape[0]}]")
    if sizes.device != rows.device:
        raise ValueError("rows and sizes must lie on one device")


def byte_hist(rows: torch.Tensor,
              sizes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows: uint8[B, S]; sizes: [B] byte counts (clipped to S). Returns
    (hist int32[B, 256] of each row's first sizes[b] bytes, csum int32[B]
    their XOR)."""
    _check_hist_args(rows, sizes)
    if not use_kernels(rows):
        return byte_hist_plain(rows, sizes)
    sizes = sizes.to(torch.int64).clamp(0, rows.shape[1]).to(torch.int32)
    # K8 takes 16 B aligned rows of a 16 B multiple
    if rows.shape[1] % 16:
        rows = F.pad(rows, (0, -rows.shape[1] % 16))
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        rows = rows.contiguous().clone()
    return K.byte_hist(rows, sizes)


def checksum_rows(rows: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """rows: uint8[B, S]; sizes: [B] byte counts (clipped to [0, S]).
    Returns int64[B], the XOR of each row's first sizes[b] bytes."""
    _check_hist_args(rows, sizes)
    if not use_kernels(rows):
        return checksum_batched(rows, sizes)
    if rows.shape[1] > 1 and rows.stride(1) != 1:
        rows = rows.contiguous()
    sizes = sizes.to(torch.int64).clamp(0, rows.shape[1])
    return K.byte_hist(rows, sizes, False)[1]


def byte_hist_plain(rows: torch.Tensor, sizes: torch.Tensor, hist: bool = True, /):
    """Plain PyTorch version of K8; runs on any device. hist False, as in
    the kernel's wrapper, returns (None, csum int64)."""
    _check_hist_args(rows, sizes)
    if not hist:
        return None, checksum_batched(rows, sizes)
    B, S = rows.shape
    dev = rows.device
    keep = (torch.arange(S, device=dev)[None, :]
            < sizes.to(torch.int64)[:, None])
    idx = rows.to(torch.int64) + NUM_SYMBOLS * torch.arange(
        B, dtype=torch.int64, device=dev)[:, None]
    hist = torch.bincount(idx[keep], minlength=B * NUM_SYMBOLS)
    return (hist.reshape(B, NUM_SYMBOLS).to(torch.int32),
            checksum_batched(rows, sizes).to(torch.int32))


def histogram_batched(data_u8: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """data_u8: uint8[B, S]; sizes: [B]. Returns int32[B, 256]."""
    return byte_hist(data_u8, sizes)[0]


def histogram_packed(data32: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Byte histogram of u32-packed rows (torch.int32 [B, W], little-endian
    bytes); sizes in bytes. Returns int32[B, 256]."""
    if data32.dtype != torch.int32 or data32.dim() != 2:
        raise TypeError("data32 must be a 2-D torch.int32 tensor")
    return byte_hist(data32.contiguous().view(torch.uint8), sizes)[0]
