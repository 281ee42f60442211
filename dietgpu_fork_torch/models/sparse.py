"""Sparse float codec: a nonzero bitmap, then the dense float codec on the
nonzero floats.

A port of the JAX package's ``models/sparse.py`` (the reference's
floatCompressSparseDevice / floatDecompressSparseDevice,
GpuSparseFloatCompress.cuh:253-446, GpuSparseFloatDecompress.cuh:183-353):

* compress: K9 packs each member's bitmap -> K15 scans its ranks
  (``word_ranks``) -> K10 compacts the nonzero floats -> the dense
  ``float_compress_core`` on (packed, nnz) -> one K3 merge assembles each
  member's archive;
* decompress: sanitise the header's float count -> one K3 merge stages the
  bitmaps -> the dense ``float_decompress_core`` at each member's word
  offset ``4 + bitmap_words(n)`` -> K15 scans the ranks -> K11 expands
  the nonzero floats and zeroes the rest.

Archive layout per member (u32 words): the sparse header (4: the float
count n, then zeros; no magic), the bitmap (``bitmap_words(n)``: MSB first
per byte, 16 B aligned), the dense float archive of the nnz nonzero floats
(``models/float_codec.py``; a v2 container when native and nnz >= 2^20).
Like the JAX package and the oracle, and unlike the CUDA reference's scan
(GpuSparseFloatCompress.cuh:170-184), the dense archive holds exactly the
nonzero floats.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.constants import (
    DEFAULT_PROB_BITS,
    FloatType,
    max_sparse_float_compressed_size,
)
from ..ops.bitmap_pack import (
    bitmap_words,
    floats_capacity,
    pack_bitmap,
    pack_bitmap_plain,
)
from ..ops.bitops import from_u32
from ..ops.merge import runs_merge, runs_merge_plain
from ..ops.sparse_stream import (
    compact_by_bitmap,
    compact_by_bitmap_plain,
    expand_by_bitmap,
    expand_by_bitmap_plain,
    word_ranks,
    word_ranks_plain,
)
from ..utils.profiling import span, spanned
from .float_codec import (
    _check_type,
    archive_layout,
    float_compress_core,
    float_decompress_core,
)


def _dense_offset(n):
    """Word offset of the dense float archive in a sparse member of n
    floats (n >= 0): past the 4-word header and the bitmap."""
    return 4 + bitmap_words(n)


def dense_base(comp32: torch.Tensor) -> torch.Tensor:
    """int64[B]: where each member's dense archive starts as its float count
    places it before any check (a negative count as 0), in comp32's rows
    (int32[B, CW]): the reads of the layout and the float type."""
    return _dense_offset(comp32[:, 0].to(torch.int64).clamp(min=0))


def sparse_float_compress_core(
    data32: torch.Tensor,
    n: torch.Tensor,
    float_type: FloatType,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    native: bool = True,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress u32-packed float rows (int32[B, W32], as
    ``float_compress_core`` takes them) holding n[b] floats each.

    Returns (out32 int32[B, 4 + bitmap_words(S_cap) + the dense row
    width], the archives, zero past comp_bytes; comp_bytes int64[B]), with
    S_cap = 4 W32 / word size. native and plain as in
    ``float_compress_core``.
    """
    ft = _check_type(float_type)
    dev = data32.device
    data32 = data32.contiguous()
    B, W32 = data32.shape
    S_cap = floats_capacity(W32, ft)
    n64 = n.to(device=dev, dtype=torch.int64)
    with span("sync:sparse.count_check"):
        bad = bool(((n64 < 0) | (n64 > S_cap)).any())
    if bad:
        raise ValueError(f"float counts must lie in [0, {S_cap}]")

    with span("stage:sparse.bitmap"):
        pack = pack_bitmap_plain if plain else pack_bitmap
        bm32 = pack(data32, n64.to(torch.int32), ft)
    with span("stage:sparse.ranks"):
        ranks = (word_ranks_plain if plain else word_ranks)(bm32, n64)
    with span("stage:sparse.compact"):
        compact = compact_by_bitmap_plain if plain else compact_by_bitmap
        packed, nnz = compact(data32, bm32, ranks, ft)
    dense32, dense_bytes = float_compress_core(
        packed, nnz, ft, prob_bits, use_checksum, native, plain)

    with span("stage:sparse.assemble"):
        # [header | bitmap | dense archive] per member, in one merge
        BW, DW = bm32.shape[1], dense32.shape[1]
        CWs = 4 + BW + DW
        zeros = torch.zeros_like(n64)
        hdr = from_u32(torch.stack([n64, zeros, zeros, zeros], dim=1))
        dense_off = _dense_offset(n64)
        bmw = dense_off - 4
        b_ar = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
        dst = b_ar * CWs + torch.stack([zeros, zeros + 4, dense_off], dim=1)
        with span("sync:sparse.merge_refs"):
            ref = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev).expand(B, -1)
        with span("sync:sparse.merge_strides"):
            strides = torch.tensor([4, BW, DW], device=dev)
        off = b_ar * strides
        lens = torch.stack([zeros + 4, bmw, dense_bytes >> 2], dim=1)
        merge = runs_merge_plain if plain else runs_merge
        out = merge(
            [hdr.reshape(-1), bm32.reshape(-1), dense32.reshape(-1)],
            dst.reshape(-1), ref.reshape(-1), off.reshape(-1), lens.reshape(-1),
            B * CWs,
        ).reshape(B, CWs)
        return out, 4 * dense_off + dense_bytes


@spanned("model:sparse.sparse_float_decompress_core")
def sparse_float_decompress_core(
    comp32: torch.Tensor,
    out_floats: int,
    float_type: FloatType,
    prob_bits: int = DEFAULT_PROB_BITS,
    capacities: Optional[torch.Tensor] = None,
    verify_checksum: bool = False,
    native: Optional[bool] = True,
    plain: bool = False,
):
    """Decompress sparse float archives (int32[B, CW] rows).

    Returns (words32 int32[B, ceil(out_floats ws / 4)], zero past n and for
    failed members; success bool[B]; n int64[B]; the dense archive's
    checksum int64[B]; the checksum of the decoded nonzero floats, int64[B],
    zeros unless verify_checksum). A member fails, raising nothing, on a
    float count that does not fit its row, on n above its capacity (default
    out_floats), or when its dense archive fails. native and plain as in
    ``float_decompress_core``; None reads the layout at each dense archive
    where the unchecked count places it (``dense_base``), so every member
    votes, even one whose count fails the header's checks.
    """
    ft = _check_type(float_type)
    dev = comp32.device
    comp32 = comp32.contiguous()
    B, CW = comp32.shape
    with span("stage:sparse.header"):
        raw_off = dense_base(comp32)
        if native is None:
            native = archive_layout(comp32, raw_off, ft)
        # the header has no magic: a count whose sections cannot fit the row
        # fails the member before it sizes anything
        n = comp32[:, 0].to(torch.int64)
        sane = (n >= 0) & (raw_off + 4 <= CW)
        n = torch.where(sane, n, 0)
        if capacities is None:
            capacities = torch.full((B,), out_floats, dtype=torch.int64, device=dev)
        success = sane & (n <= capacities.to(device=dev, dtype=torch.int64))

        dense_off = _dense_offset(n)
        bmw = dense_off - 4
        BW = max(bitmap_words(out_floats), 1)
        b_ar = torch.arange(B, dtype=torch.int64, device=dev)
        merge = runs_merge_plain if plain else runs_merge
        bm32 = merge(
            [comp32.reshape(-1)], b_ar * BW,
            torch.zeros(B, dtype=torch.int32, device=dev), b_ar * CW + 4,
            bmw.clamp(max=BW), B * BW,
        ).reshape(B, BW)
    nz32, dsuccess, _, csum_arch, csum_got = float_decompress_core(
        comp32, dense_off, out_floats, ft, prob_bits, capacities,
        verify_checksum, native, plain)
    success = success & dsuccess

    with span("stage:sparse.ranks"):
        # a failed member expands nothing: it decodes to zeros
        n_ok = torch.where(success, n, 0)
        ranks = (word_ranks_plain if plain else word_ranks)(bm32, n_ok)
    with span("stage:sparse.expand"):
        expand = expand_by_bitmap_plain if plain else expand_by_bitmap
        words32 = expand(nz32, bm32, ranks, n_ok, out_floats, ft)
    return words32, success, n, csum_arch, csum_got


@spanned("model:sparse.sparse_float_compress_padded")
def sparse_float_compress_padded(
    data32: torch.Tensor,
    n: torch.Tensor,
    float_type: FloatType,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    out_bytes: Optional[int] = None,
    native: bool = True,
    plain: bool = False,
):
    """Byte-row wrapper with the reference's getMaxSparseFloatCompressedSize
    output-buffer contract: (comp uint8[B, max(4 CWs, out_bytes)], zero
    padded; comp_bytes int64[B])."""
    ft = _check_type(float_type)
    out32, comp_bytes = sparse_float_compress_core(
        data32, n, ft, prob_bits, use_checksum, native, plain)
    comp = out32.view(torch.uint8)
    cb = (max_sparse_float_compressed_size(ft, floats_capacity(data32.shape[1], ft))
          if out_bytes is None else out_bytes)
    if comp.shape[1] < cb:
        comp = F.pad(comp, (0, cb - comp.shape[1]))
    return comp, comp_bytes
