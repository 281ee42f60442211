"""Compaction and expansion of float rows by their nonzero bitmap, and the
rank scan both read: kernels K10, K11 and K15 and their plain versions.

A port of the JAX package's ``ops/pallas/sparse_stream.py``:

    compact:  packed[rank(f)] = row[f]   for each float f whose bit is set
    expand:   out[f] = bit f ? nz[rank(f)] : 0

where rank(f) is the count of set bits before f. Bitmaps are the
archive's MSB-first words (``ops/bitmap_pack.py``), read as they are: the
JAX package's ``bitrev8_words`` pass has no counterpart. The rank of a
float is ``ranks[w] + (set bits of word w below it)`` with
``ranks = word_ranks(bm32, n)``: the exclusive scan of the per-word
popcounts, which the JAX package computes in XLA inside its compaction and
expansion (``sparse_stream.py:280-283``, ``:430-432``), with one column
more that holds the total. Compaction and expansion take ranks that are
their bitmap's ``word_ranks``.

Rows: a 16-bit float is a u16 item, two per u32 word, item 2j in the low
half of word j; an fp32 float one word; an fp64 float a (lo, hi) word
pair. ``compact_by_bitmap`` writes the 16-bit stream in its packed-pairs
form directly (the TPU's ``_pack_pairs_kernel`` step has no counterpart)
and zero past the nonzeros; ``expand_by_bitmap`` writes zero at every
float at or past n[b] (the JAX package's ``mask_packed_bytes`` after the
expansion).

All three send CUDA tensors to their kernels (``csrc/word_ranks.cu``,
``csrc/sparse_compact.cu``, ``csrc/sparse_expand.cu``) and CPU tensors to
the plain versions.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.config import use_kernels
from ..core.constants import FLOAT_WORD_SIZE, FloatType
from ..runtime import cuda_kernels as K
from .bitmap_pack import bits_below, float_items, floats_capacity, items_to_words
from .bitops import popcount32, to_u32


def _check_ranks_args(bm32, n):
    _check_rows("bm32", bm32)
    if n.dim() != 1 or n.shape[0] != bm32.shape[0] or n.device != bm32.device:
        raise TypeError(f"n must have shape [{bm32.shape[0]}] on the bitmap's device")


def word_ranks(bm32: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """bm32: int32[B, BW] MSB-first bitmap words; n: [B] float counts.
    Returns int32[B, BW + 1]: column w holds the set bits of floats < n[b]
    in words before w, so the last column is each member's nonzero count."""
    _check_ranks_args(bm32, n)
    if not use_kernels(bm32):
        return word_ranks_plain(bm32, n)
    return K.word_ranks(bm32.contiguous(), n.to(torch.int64).contiguous())


def word_ranks_plain(bm32, n):
    """Plain PyTorch version of K15; runs on any device."""
    _check_ranks_args(bm32, n)
    pc = popcount32(to_u32(bm32) & bits_below(n, bm32.shape[1]))
    return F.pad(torch.cumsum(pc, dim=1, dtype=torch.int32), (1, 0))


def _unpack_bits(bm32: torch.Tensor, S: int) -> torch.Tensor:
    """bool[B, S]: bit f of MSB-first bitmap words, 0 past the words."""
    NW = -(-S // 32)
    x = to_u32(bm32[:, :NW])
    if x.shape[1] < NW:
        x = F.pad(x, (0, NW - x.shape[1]))
    shift = torch.arange(32, device=bm32.device) ^ 7
    return ((x[:, :, None] >> shift) & 1).reshape(x.shape[0], -1)[:, :S] != 0


def _ranks(bits: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """int64[B, S]: ranks[w] + the set bits of word w below each float."""
    B, S = bits.shape
    NW = -(-S // 32)
    b = F.pad(bits.to(torch.int64), (0, 32 * NW - S)).reshape(B, NW, 32)
    below = torch.cumsum(b, dim=-1) - b
    return (ranks[:, :NW, None].to(torch.int64) + below).reshape(B, -1)[:, :S]


def _check_rows(name, t, B=None):
    if t.dtype != torch.int32 or t.dim() != 2:
        raise TypeError(f"{name} must be a 2-D torch.int32 tensor")
    if B is not None and t.shape[0] != B:
        raise TypeError(f"{name} must have {B} rows")


def _check_bitmap(bm32, ranks, B, S, dev):
    _check_rows("bm32", bm32, B)
    _check_rows("ranks", ranks, B)
    if 32 * bm32.shape[1] < S:
        raise ValueError(f"bm32 needs at least {-(-S // 32)} words per row")
    if ranks.shape[1] != bm32.shape[1] + 1:
        raise ValueError("ranks needs one column more than bm32")
    if bm32.device != dev or ranks.device != dev:
        raise ValueError("rows, bitmap and ranks must lie on one device")


def compact_by_bitmap(
    data32: torch.Tensor, bm32: torch.Tensor, ranks: torch.Tensor,
    float_type: FloatType,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """data32: int32[B, W32] u32-packed floats; bm32, ranks: the bitmap of
    the floats to keep and its ``word_ranks``. Returns (packed int32[B,
    ceil(S_cap ws / 4)], the kept floats in order and zero after them;
    nnz int32[B]) with S_cap = 4 W32 / word size."""
    ft = FloatType(float_type)
    _check_rows("data32", data32)
    S_cap = floats_capacity(data32.shape[1], ft)
    _check_bitmap(bm32, ranks, data32.shape[0], S_cap, data32.device)
    if not use_kernels(data32):
        return compact_by_bitmap_plain(data32, bm32, ranks, ft)
    return K.compact_by_bitmap(data32.contiguous(), bm32.contiguous(),
                               ranks.contiguous(), ft)


def compact_by_bitmap_plain(data32, bm32, ranks, float_type):
    """Plain PyTorch version of K10; runs on any device."""
    ft = FloatType(float_type)
    _check_rows("data32", data32)
    B, W32 = data32.shape
    S_cap = floats_capacity(W32, ft)
    _check_bitmap(bm32, ranks, B, S_cap, data32.device)
    items = float_items(to_u32(data32), ft)[:, :S_cap]
    bits = _unpack_bits(bm32, S_cap)
    slot = _ranks(bits, ranks)
    # floats that are not kept go to a dump column past the row
    idx = torch.where(bits & (slot >= 0) & (slot < S_cap), slot, S_cap)
    k = items.shape[2]
    out = torch.zeros((B, S_cap + 1, k), dtype=torch.int64, device=data32.device)
    out.scatter_(1, idx[:, :, None].expand(-1, -1, k), items)
    return items_to_words(out[:, :S_cap], ft), ranks[:, -1]


def _expand_shapes(nz32, ft: FloatType, out_floats: int):
    """(output words, output float slots, nonzero items per nz32 row)."""
    ws = FLOAT_WORD_SIZE[ft]
    OW = -(-out_floats * ws // 4)
    return OW, 4 * OW // ws, floats_capacity(nz32.shape[1], ft)


def _check_expand_args(nz32, bm32, ranks, n, out_floats, ft):
    _check_rows("nz32", nz32)
    B = nz32.shape[0]
    if out_floats < 0:
        raise ValueError("out_floats must be >= 0")
    _, OS, NZcap = _expand_shapes(nz32, ft, out_floats)
    if NZcap < 1:
        raise ValueError("nz32 rows must hold at least one float")
    _check_bitmap(bm32, ranks, B, OS, nz32.device)
    if n.dim() != 1 or n.shape[0] != B or n.device != nz32.device:
        raise TypeError(f"n must have shape [{B}] on the rows' device")


def expand_by_bitmap(
    nz32: torch.Tensor, bm32: torch.Tensor, ranks: torch.Tensor,
    n: torch.Tensor, out_floats: int, float_type: FloatType,
) -> torch.Tensor:
    """nz32: int32[B, NW] u32-packed nonzero floats in order; bm32, ranks:
    their bitmap and its ``word_ranks``; n: [B] float counts. Returns
    int32[B, ceil(out_floats ws / 4)]: float f < min(n[b], out_floats) is
    nz[rank(f)] where its bit is set, every other float 0. A rank past the
    row reads its last float."""
    ft = FloatType(float_type)
    _check_expand_args(nz32, bm32, ranks, n, out_floats, ft)
    if not use_kernels(nz32):
        return expand_by_bitmap_plain(nz32, bm32, ranks, n, out_floats, ft)
    n32 = n.to(torch.int64).clamp(0, out_floats).to(torch.int32).contiguous()
    return K.expand_by_bitmap(nz32.contiguous(), bm32.contiguous(),
                              ranks.contiguous(), n32, out_floats, ft)


def expand_by_bitmap_plain(nz32, bm32, ranks, n, out_floats: int, float_type):
    """Plain PyTorch version of K11; runs on any device."""
    ft = FloatType(float_type)
    _check_expand_args(nz32, bm32, ranks, n, out_floats, ft)
    _, OS, NZcap = _expand_shapes(nz32, ft, out_floats)
    items = float_items(to_u32(nz32), ft)[:, :NZcap]
    pos = torch.arange(OS, dtype=torch.int64, device=nz32.device)[None, :]
    live = pos < n.to(torch.int64).clamp(0, out_floats)[:, None]
    bits = _unpack_bits(bm32, OS) & live
    idx = _ranks(bits, ranks).clamp(0, NZcap - 1)
    k = items.shape[2]
    vals = torch.gather(items, 1, idx[:, :, None].expand(-1, -1, k))
    return items_to_words(torch.where(bits[:, :, None], vals, 0), ft)
