"""The sparse codec's nonzero bitmap: kernel K9 and its plain version.

A port of the JAX package's ``ops/pallas/bitmap_pack.py``
(``pack_bitmap16/32/64_tpu``) together with the tail mask the JAX
``models/sparse.py:224-232`` applies after it. Float f of a member is
nonzero when its word is not all zero bits: an integer compare, so -0.0
is nonzero, and an fp64 float is nonzero when either u32 half is.

Bitmap words are the archive's: byte k of word w holds floats
32w + 8k .. 32w + 8k + 7, the first of them in bit 7 (MSB first per byte,
GpuSparseFloatCompress.cuh:64-113). Bits of floats at or past n[b] are 0,
and the row is zero up to ``bitmap_words(S_cap)``, the bitmap section of a
member at the rows' capacity.

``pack_bitmap`` sends a CUDA tensor to K9 (``csrc/bitmap_pack.cu``) and a
CPU tensor to ``pack_bitmap_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.config import use_kernels
from ..core.constants import FLOAT_WORD_SIZE, FloatType, sparse_bitmap_bytes
from ..runtime import cuda_kernels as K
from .bitops import from_u32, to_u32


def bitmap_words(n):
    """u32 words of the 16 B aligned bitmap section of n floats; n an int
    or an int64 tensor, n >= 0."""
    return sparse_bitmap_bytes(n) // 4


def floats_capacity(W32: int, ft: FloatType) -> int:
    """Floats that rows of W32 u32 words hold."""
    return 4 * W32 // FLOAT_WORD_SIZE[FloatType(ft)]


def float_items(x: torch.Tensor, ft: FloatType) -> torch.Tensor:
    """u32 rows (int64 carriers) [B, W] -> the words of each float,
    [B, S, k] int64: k = 1 (a u16 or u32 word per float) or 2 (fp64's
    (lo, hi) pair)."""
    B, W = x.shape
    ws = FLOAT_WORD_SIZE[FloatType(ft)]
    if ws == 2:
        return torch.stack([x & 0xFFFF, x >> 16], dim=-1).reshape(B, -1, 1)
    if ws == 4:
        return x[:, :, None]
    return x[:, : W // 2 * 2].reshape(B, -1, 2)


def items_to_words(items: torch.Tensor, ft: FloatType) -> torch.Tensor:
    """The inverse of ``float_items``: [B, S, k] -> int32[B, ceil(S ws / 4)],
    a 16-bit row of odd S padded with a zero half."""
    B = items.shape[0]
    if FLOAT_WORD_SIZE[FloatType(ft)] == 2:
        h = items[..., 0]
        if h.shape[1] % 2:
            h = F.pad(h, (0, 1))
        return from_u32(h[:, 0::2] | (h[:, 1::2] << 16))
    return from_u32(items.reshape(B, -1))


def bits_below(n: torch.Tensor, W: int) -> torch.Tensor:
    """[B, W] int64 masks of the bits of floats < n[b] in MSB-first bitmap
    words (the JAX package's ``sparse.py:224-232``)."""
    wpos = torch.arange(W, dtype=torch.int64, device=n.device)[None, :]
    r = (n.to(torch.int64)[:, None] - 32 * wpos).clamp(0, 32)
    fb = 8 * (r >> 3)  # bits of the fully valid bytes
    part = ((0xFF << (8 - (r & 7))) & 0xFF) << fb
    return ((1 << fb) - 1) | part


def _check_pack_args(data32, n):
    if data32.dtype != torch.int32 or data32.dim() != 2:
        raise TypeError("data32 must be a 2-D torch.int32 tensor of u32 words")
    if n.dim() != 1 or n.shape[0] != data32.shape[0]:
        raise TypeError(f"n must have shape [{data32.shape[0]}]")
    if n.device != data32.device:
        raise ValueError("data32 and n must lie on one device")


def pack_bitmap(data32: torch.Tensor, n: torch.Tensor,
                float_type: FloatType) -> torch.Tensor:
    """data32: int32[B, W32] u32-packed floats of float_type; n: [B] float
    counts. Returns the archive's bitmap words, int32[B,
    bitmap_words(S_cap)] with S_cap = 4 W32 / word size."""
    _check_pack_args(data32, n)
    ft = FloatType(float_type)
    if not use_kernels(data32):
        return pack_bitmap_plain(data32, n, ft)
    S_cap = floats_capacity(data32.shape[1], ft)
    n32 = n.to(torch.int64).clamp(0, S_cap).to(torch.int32).contiguous()
    return K.pack_bitmap(data32.contiguous(), n32, ft)


def pack_bitmap_plain(data32, n, float_type):
    """Plain PyTorch version of K9; runs on any device."""
    _check_pack_args(data32, n)
    ft = FloatType(float_type)
    B, W32 = data32.shape
    S_cap = floats_capacity(W32, ft)
    BW = bitmap_words(S_cap)
    nz = (float_items(to_u32(data32), ft)[:, :S_cap] != 0).any(dim=-1)
    nz = F.pad(nz.to(torch.int64), (0, 32 * BW - S_cap)).reshape(B, BW, 32)
    shift = torch.arange(32, device=data32.device) ^ 7  # float 8k+j -> bit 8k+7-j
    words = (nz << shift).sum(dim=-1)
    return from_u32(words & bits_below(n, BW))
