"""16-bit float split and join (fp16, bf16), with the split's byte
histogram and XOR checksum: kernel K1 and its plain version.

Layouts (little-endian bytes within each u32 word, as in the archive and
in the JAX package's ``ops/float_split.py:80-91``):

* exponent plane: the high byte of each float (bf16 after a rotate-left
  by 1 within 16 bits, which moves the sign into the raw byte), 4 floats
  per word;
* raw section: the low byte of each float, 4 per word, bytes >= n zeroed.

``split16_hist`` sends a CUDA tensor to the kernel
(``csrc/split16_hist.cu``) and a CPU tensor to ``split16_hist_plain``,
built from the JAX package's ``split_packed`` + ``histogram_packed`` +
``checksum_packed`` + ``mask_packed_bytes``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.config import use_kernels
from ..core.constants import NUM_SYMBOLS
from ..runtime import cuda_kernels as K
from .bitops import M32, from_u32, to_u32


def _rotl16x2(x):
    return ((x << 1) & 0xFFFEFFFE) | ((x >> 15) & 0x00010001)


def _rotr16x2(x):
    return ((x >> 1) & 0x7FFF7FFF) | ((x << 15) & 0x80008000)


def _b(x, k):
    return (x >> (8 * k)) & 0xFF


def _pack4(b0, b1, b2, b3):
    return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)


def unpack_bytes(x: torch.Tensor) -> torch.Tensor:
    """u32 words (int64 carriers) [..., W] -> bytes (int64) [..., 4W]."""
    return torch.stack([_b(x, k) for k in range(4)], dim=-1).flatten(-2)


def mask_packed_bytes(x: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """Zero all bytes at positions >= nbytes[b] of u32 rows (int64
    carriers)."""
    W = x.shape[1]
    wpos = torch.arange(W, dtype=torch.int64, device=x.device)[None, :]
    c = (nbytes.to(torch.int64)[:, None] - 4 * wpos).clamp(0, 4)
    return x & (((1 << (8 * c)) - 1) & M32)


def histogram_packed(x: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of the first nbytes[b] bytes of each u32 row."""
    by = unpack_bytes(x)
    pos = torch.arange(by.shape[1], dtype=torch.int64, device=x.device)
    valid = (pos[None, :] < nbytes.to(torch.int64)[:, None]).to(torch.int64)
    hist = torch.zeros((x.shape[0], NUM_SYMBOLS), dtype=torch.int64,
                       device=x.device)
    return hist.scatter_add_(1, by, valid)


def checksum_packed(x: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """XOR of the first nbytes[b] bytes of each u32 row: XOR the masked
    words, then fold the four byte positions (ops/checksum.py:45-53)."""
    w = torch.nn.functional.pad(mask_packed_bytes(x, nbytes), (0, 1))
    while w.shape[1] > 1:
        if w.shape[1] % 2:
            w = torch.nn.functional.pad(w, (0, 1))
        w = w[:, 0::2] ^ w[:, 1::2]
    w = w[:, 0]
    w = w ^ (w >> 16)
    return (w ^ (w >> 8)) & 0xFF


def _check_split_args(data32, n):
    if data32.dtype != torch.int32 or data32.dim() != 2:
        raise TypeError("data32 must be a 2-D torch.int32 tensor of u32 words")
    if not data32.is_contiguous():
        raise ValueError("data32 must be contiguous")
    if data32.shape[1] % 2:
        raise ValueError(f"data32 needs an even row width, got {data32.shape[1]}")
    if n.dtype != torch.int32 or n.shape != (data32.shape[0],):
        raise TypeError("n must be torch.int32 of shape [B]")
    if not n.is_contiguous():
        raise ValueError("n must be contiguous")
    if n.device != data32.device:
        raise ValueError("data32 and n must lie on one device")


def split16_hist(
    data32: torch.Tensor, n: torch.Tensor, bf16: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split u32-packed 16-bit float rows.

    data32: int32[B, W32] (u32 words, W32 even); n: int32[B] float counts.
    Returns (exp int32[B, W32/2], raw int32[B, W32/2] with bytes >= n
    zeroed, hist int32[B, 256] over the first n exponent bytes, csum
    int32[B]: the XOR of the first 2n input bytes).
    """
    _check_split_args(data32, n)
    if use_kernels(data32):
        return K.split16_hist(data32, n, bf16)
    return split16_hist_plain(data32, n, bf16)


def split16_hist_plain(data32, n, bf16: bool):
    """Plain PyTorch version of K1; runs on any device."""
    _check_split_args(data32, n)
    x = to_u32(data32)
    r = _rotl16x2(x) if bf16 else x
    we, wo = r[:, 0::2], r[:, 1::2]
    exp = _pack4((we >> 8) & 0xFF, we >> 24, (wo >> 8) & 0xFF, wo >> 24)
    raw = _pack4(we & 0xFF, (we >> 16) & 0xFF, wo & 0xFF, (wo >> 16) & 0xFF)
    n64 = n.to(torch.int64)
    raw = mask_packed_bytes(raw, n64)
    hist = histogram_packed(exp, n64)
    csum = checksum_packed(x, 2 * n64)
    return from_u32(exp), from_u32(raw), hist.to(torch.int32), csum.to(torch.int32)


def join16(exp_bytes: torch.Tensor, raw_bytes: torch.Tensor, bf16: bool):
    """Join exponent and raw bytes (int64, same shape [..., 2m]) into u32
    words (int64) [..., m] holding two 16-bit floats each: the inverse of
    the split (float_split.py:193-202)."""
    v = raw_bytes | (exp_bytes << 8)
    w = v[..., 0::2] | (v[..., 1::2] << 16)
    return _rotr16x2(w) if bf16 else w
