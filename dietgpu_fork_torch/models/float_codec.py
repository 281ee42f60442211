"""Float codec (fp16, bf16, fp32, fp64) over row-stream or classic ANS:
compress and decompress of u32-packed float rows.

A port of the JAX package's ``models/float_codec.py``:

* compress: split + histogram + checksum (K1 for 16-bit, K5 for fp32 and
  fp64) -> table build -> K2 rANS encode into row or block streams (one
  launch for both fp64 planes) -> one K3 merge placing the float header,
  the raw sections and the ANS archives' runs into each member's archive
  row;
* decompress, fused (the default for 16-bit types and fp32): float header
  parse -> ANS parse and validation -> K4 (16-bit) or K12 (fp32) decodes
  and joins into float words, reading the streams, the states and the raw
  section(s) from the archive in place (the JAX package's fused
  branches): no K3 merge; fp32 members that fail are failed before K12,
  which zeroes them, so no select follows;
* decompress, two-pass (the default for fp64, ``fused=False`` for the
  others): float header parse -> per plane, ANS parse,
  validation and a K6 decode to bytes (in place) -> K7 (fp32, fp64) or
  K13 (16-bit) joins the planes with the raw sections read from the
  archive in place, below each member's count (0 for a failed member):
  no staging merge and no select, where the JAX package's two-pass branch
  stages the sections with a merge and selects after the join;
* verify_checksum XORs each member's decoded bytes (the JAX package's
  ``float_codec.py:453-457``) with one K8 launch in its checksum-only
  form, reading the live bytes of the decoded rows in place.

Archive layout per member (u32 words): float header (8; word 4 holds the
first ANS archive's byte size for fp64), raw section 1, raw section 2
(fp32, fp64), one ANS archive per exponent plane. Sections are 16 B
aligned; native (row-stream) members with n >= FLOAT_ALIGN_MIN use the v2
container, where each raw section starts on a 128-word boundary; classic
archives are always v1 containers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.constants import (
    DEFAULT_PROB_BITS,
    FLOAT_ALIGN_MIN,
    FLOAT_MAGIC,
    FLOAT_NUM_COMP_SEGMENTS,
    FLOAT_SECTION_ALIGN_BYTES,
    FLOAT_VERSION,
    FLOAT_VERSION_ALIGNED,
    FLOAT_WORD_SIZE,
    FloatType,
    max_float_compressed_size,
)
from ..ops.bitmap_pack import floats_capacity
from ..ops.bitops import from_u32, to_i32, to_u32
from ..ops.checksum import checksum_packed
from ..ops.float_split import (
    join16_at,
    join16_at_plain,
    join_wide_at,
    join_wide_at_plain,
    split16_hist,
    split16_hist_plain,
    split_wide_hist,
    split_wide_hist_plain,
)
from ..ops.histogram import checksum_rows
from ..ops.merge import runs_merge, runs_merge_plain
from ..utils.profiling import span, spanned
from .ans import (
    SRC_META,
    SRC_PAIRS,
    SRC_STREAMS,
    _tight_bytes,
    ans_decode_core,
    ans_decode_join16_core,
    ans_decode_join32_core,
    ans_encode_sections,
    read_layout,
)

FLOAT_MAGIC_VERSION = (FLOAT_MAGIC << 16) | FLOAT_VERSION
FLOAT_MAGIC_VERSION2 = (FLOAT_MAGIC << 16) | FLOAT_VERSION_ALIGNED
_FLOAT16_TYPES = (FloatType.FLOAT16, FloatType.BFLOAT16)
# merge sources of the compress-side archive merge, after the ANS ones:
# the float headers, then the raw sections
_SRC_HDR, _SRC_RAW = 3, 4


def _align_section(words):
    """v2 containers start each raw section on a 512 B boundary."""
    a = FLOAT_SECTION_ALIGN_BYTES // 4
    return (words + a - 1) // a * a


def _section_word_counts(n, ft: FloatType):
    """u32 words of a member's two raw sections, each 16 B aligned (the
    JAX package's ``float_codec.py:73-84``); ints or tensors."""
    def r(x, m):
        return (x + m - 1) // m * m
    if ft in _FLOAT16_TYPES:
        return r(n, 16) // 4, n * 0
    if ft == FloatType.FLOAT32:
        return r(n, 8) // 2, r(n, 16) // 4
    return r(n, 4), r(n, 8) // 2


def _sections(n, is_al, ft: FloatType):
    """The placement of a float archive's sections for n floats (int64[B])
    in v2 (is_al, bool[B]) or v1 containers: ((o_s1, o_s2, o_ans), the word
    offsets from the archive's start of raw section 1, raw section 2 and
    the first ANS archive; (s1w, s2w), the sections' word counts). 16-bit
    types have no section 2: their o_ans is o_s2."""
    s1w, s2w = _section_word_counts(n, ft)
    o_s1 = torch.where(is_al, 128, 8)
    o_s2 = o_s1 + torch.where(is_al, _align_section(s1w), s1w)
    o_ans = (o_s2 if ft in _FLOAT16_TYPES
             else o_s2 + torch.where(is_al, _align_section(s2w), s2w))
    return (o_s1, o_s2, o_ans), (s1w, s2w)


def _check_type(float_type) -> FloatType:
    ft = FloatType(float_type)
    if ft not in FLOAT_WORD_SIZE:
        raise ValueError(f"unsupported float type {ft.name}")
    return ft


def archive_row_words(W32: int, float_type: FloatType) -> int:
    """Archive row width CWf (u32 words) for inputs of W32 words (padded
    for the type), the JAX package's ``float_codec.py:176-192``."""
    ft = FloatType(float_type)
    S_cap = 4 * W32 // FLOAT_WORD_SIZE[ft]
    s1w_cap, s2w_cap = _section_word_counts(S_cap, ft)
    tight = (4 * (8 + s1w_cap + s2w_cap + 3 * 128)
             + FLOAT_NUM_COMP_SEGMENTS[ft] * _tight_bytes(S_cap))
    CWf = min(max_float_compressed_size(ft, S_cap), tight) // 4
    return -(-CWf // 128) * 128


@spanned("model:float_codec.float_compress_core")
def float_compress_core(
    data32: torch.Tensor,
    n: torch.Tensor,
    float_type: FloatType,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    native: bool = True,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress u32-packed float rows.

    data32: int32[B, W32] packed float words (u32 bits; an fp64 float is a
    (lo, hi) word pair); n: int[B] float counts (n[b] <= the row's
    capacity). Returns (out32 int32[B, CWf], the archives, zero past
    comp_bytes; comp_bytes int64[B]). native picks the row-stream ANS
    layout, else the classic one. plain=True runs every kernel's plain
    PyTorch version wherever the tensors lie (to hold the kernels against
    them on the card).
    """
    ft = _check_type(float_type)
    dev = data32.device
    with span("stage:float_codec.split"):
        # the split takes whole groups of 4 floats: FLOAT_WORD_SIZE words each
        req = FLOAT_WORD_SIZE[ft]
        if data32.shape[1] % req:
            data32 = F.pad(data32, (0, req - data32.shape[1] % req))
        data32 = data32.contiguous()
        B, W32 = data32.shape
        S_cap = floats_capacity(W32, ft)
        P = FLOAT_NUM_COMP_SEGMENTS[ft]
        n64 = n.to(device=dev, dtype=torch.int64)
        with span("sync:float_codec.count_check"):
            bad = bool(((n64 < 0) | (n64 > S_cap)).any())
        if bad:
            raise ValueError(f"float counts must lie in [0, {S_cap}]")
        n32 = n64.to(torch.int32)

        if ft in _FLOAT16_TYPES:
            split = split16_hist_plain if plain else split16_hist
            exp, raw, hist, csum_f = split(data32, n32, ft == FloatType.BFLOAT16)
            secs = [raw]
        else:
            if data32.data_ptr() % 16:  # K5 loads 16 B per group of floats
                data32 = data32.clone()
            split = split_wide_hist_plain if plain else split_wide_hist
            exp, sec1, sec2, hist, csum_f = split(data32, n32, ft)
            secs = [sec1, sec2]
        # a section run copies a 16 B multiple of words: give every section row
        # a 16 B multiple of zero-padded width so no run reads into the next row
        secs = [F.pad(s, (0, -s.shape[1] % 4)) if s.shape[1] % 4 else s
                for s in secs]
        csum = to_u32(csum_f) if use_checksum else torch.zeros_like(n64)

    # one encode for every plane: plane p of member b is member p*B + b
    seg = ans_encode_sections(exp, n32.repeat(P), prob_bits, hist=hist,
                              s_bytes=S_cap, native=native, plain=plain)
    seg_bytes = seg.comp_bytes.reshape(P, B)

    with span("stage:float_codec.assemble"):
        # v2 containers hold native members only: classic archives are v1
        is_al = (n64 >= FLOAT_ALIGN_MIN) & native
        (o_s1, o_s2, o_ans), sec_w = _sections(n64, is_al, ft)
        sec_dst, sec_w = [o_s1, o_s2][: len(secs)], sec_w[: len(secs)]
        plane_dst = [o_ans]  # the first ANS archive follows the sections
        for p in range(P):
            plane_dst.append(plane_dst[-1] + (seg_bytes[p] >> 2))
        end = plane_dst.pop()

        zeros = torch.zeros_like(n64)
        first_seg = seg_bytes[0] if P > 1 else zeros
        hdr = torch.stack(
            [torch.where(is_al, FLOAT_MAGIC_VERSION2, FLOAT_MAGIC_VERSION), n64,
             zeros + (int(ft) | (int(use_checksum) << 4)), csum, first_seg, zeros,
             zeros, zeros],
            dim=1,
        )

        # one merge places every member's header, raw sections and ANS runs, in
        # destination order within each member's archive row; the ANS runs
        # index the first three sources
        srcs = [None] * 3 + [from_u32(hdr).reshape(-1)] + [s.reshape(-1) for s in secs]
        srcs[SRC_META] = seg.meta.reshape(-1)
        srcs[SRC_PAIRS] = seg.pairs.reshape(-1)
        srcs[SRC_STREAMS] = seg.streams.reshape(-1)
        CWf = archive_row_words(W32, ft)
        b_ar = torch.arange(B, dtype=torch.int64, device=dev)[:, None]

        def planes(t):  # [P*B, k] -> [B, P*k], plane-major per member
            return torch.cat(list(t.reshape(P, B, -1)), dim=1)

        with span("sync:float_codec.merge_refs"):
            fixed_ref = torch.tensor(
                [_SRC_HDR] + [_SRC_RAW + i for i in range(len(secs))],
                dtype=torch.int32, device=dev)
        dst = torch.cat([zeros[:, None]] + [d[:, None] for d in sec_dst]
                        + [planes(torch.cat(plane_dst)[:, None] + seg.dst)], dim=1)
        ref = torch.cat([fixed_ref.expand(B, -1), planes(seg.src_ref)], dim=1)
        off = torch.cat([b_ar * 8] + [b_ar * s.shape[1] for s in secs]
                        + [planes(seg.src_off)], dim=1)
        lens = torch.cat([zeros[:, None] + 8] + [w[:, None] for w in sec_w]
                         + [planes(seg.lens)], dim=1)
        merge = runs_merge_plain if plain else runs_merge
        out = merge(
            srcs, (dst + b_ar * CWf).reshape(-1), ref.reshape(-1), off.reshape(-1),
            lens.reshape(-1), B * CWf,
        ).reshape(B, CWf)
        return out, 4 * end


@spanned("model:float_codec.float_decompress_core")
def float_decompress_core(
    comp32: torch.Tensor,
    base32: torch.Tensor,
    out_floats: int,
    float_type: FloatType,
    prob_bits: int = DEFAULT_PROB_BITS,
    capacities: Optional[torch.Tensor] = None,
    verify_checksum: bool = False,
    native: Optional[bool] = True,
    plain: bool = False,
    fused: Optional[bool] = None,
):
    """Decompress float archives at per-member word offsets base32 of
    comp32's rows (int32[B, CW]).

    Returns (words32 int32[B, OW], zero past n and for failed members, with
    OW = ceil(out_floats / 2) for 16-bit types and 4E (fp32) or 8E (fp64)
    for E = max(ceil(out_floats / 4), 1); success bool[B]; n int64[B]; the
    archive's checksum int64[B]; the checksum of the decoded bytes, int64[B],
    zeros unless verify_checksum). A member fails, raising nothing, on a
    wrong header, a failed ANS validation, or n above its capacity (default
    out_floats). native: the embedded ANS layout; None reads it from the
    archives (``archive_layout``). plain=True as in float_compress_core.
    fused picks the decode formulation: True decodes and joins in one kernel (K4 for 16-bit types,
    K12 for fp32; fp64 has none and raises ValueError), False decodes the
    exponent planes to bytes and joins in a second pass (K6, then K13 or
    K7), None the fused decode wherever the type has one, two-pass for
    fp64 (on the H100 a fused fp32 decompress of 123,456,789 floats takes
    less device time than the two passes). Every choice returns the same
    words.
    """
    ft = _check_type(float_type)
    if fused is None:
        fused = ft != FloatType.FLOAT64
    if fused and ft == FloatType.FLOAT64:
        raise ValueError("fp64 has no fused decode: pass fused=False or None")
    with span("stage:float_codec.header"):
        dev = comp32.device
        comp32 = comp32.contiguous()
        B, CW = comp32.shape
        base = base32.to(device=dev, dtype=torch.int64)
        if native is None:
            native = archive_layout(comp32, base, ft)

        idx = (base[:, None] + torch.arange(8, dtype=torch.int64, device=dev)).clamp(0, CW - 1)
        hdr = to_u32(torch.gather(comp32, 1, idx))
        n = to_i32(hdr[:, 1])
        csum_arch = hdr[:, 3]
        first_seg = to_i32(hdr[:, 4])
        is_al = hdr[:, 0] == FLOAT_MAGIC_VERSION2
        valid = (
            ((hdr[:, 0] == FLOAT_MAGIC_VERSION) | is_al)
            & ((hdr[:, 2] & 0xF) == int(ft))
            & (n >= 0)
        )
        if FLOAT_NUM_COMP_SEGMENTS[ft] > 1:
            # the second archive must not start before the first
            valid = valid & (first_seg >= 0)
        n = torch.where(valid, n, 0)
        first_seg = torch.where(valid, first_seg, 0)
        is_al = is_al & valid
        if capacities is None:
            capacities = torch.full((B,), out_floats, dtype=torch.int64, device=dev)
        success = valid & (n <= capacities.to(device=dev, dtype=torch.int64))

        (o_s1, o_s2, o_ans), _ = _sections(n, is_al, ft)
        ans_base = base + o_ans
        b_ar = torch.arange(B, dtype=torch.int64, device=dev)
        abs_base = b_ar * CW + base
        E = max(-(-out_floats // 4), 1)

    # the fused decodes read the raw sections in place: per 4096-float
    # block 1024 raw words (16-bit), or 2048 sec1 and 1024 sec2 words (fp32)
    if fused and ft == FloatType.FLOAT32:
        # the members that fail here fail in the decode too, which zeroes
        # them and writes 4E words: no widening, no select
        words32, success, _, _ = ans_decode_join32_core(
            comp32, ans_base, abs_base + o_s1, abs_base + o_s2,
            torch.where(success, n, -1), out_floats, prob_bits, capacities,
            native, plain,
        )
    elif fused:
        words32, ok, psize, _ = ans_decode_join16_core(
            comp32, ans_base, abs_base + o_s1, out_floats, prob_bits,
            ft == FloatType.BFLOAT16, capacities, native, plain,
        )
        success = success & ok & (psize == n)
        # the words are zero past n; one select zeroes failed members
        words32 = torch.where(success[:, None], words32, 0)
    else:
        # one decode per exponent plane; the second archive starts
        # first_seg bytes after the first
        planes = []
        for p in range(FLOAT_NUM_COMP_SEGMENTS[ft]):
            plane, ok, psize, _ = ans_decode_core(
                comp32, ans_base + p * (first_seg >> 2), out_floats, prob_bits,
                capacities, native, plain,
            )
            if plane.shape[1] < E:  # out_floats == 0
                plane = F.pad(plane, (0, E - plane.shape[1]))
            planes.append(plane)
            success = success & ok & (psize == n)
        # K7 or K13 reads the raw sections from the archive in place, below
        # each member's count, which is 0 for a failed member: no staging,
        # no select
        with span("stage:float_codec.join"):
            count = torch.where(success, n, 0)
            if ft in _FLOAT16_TYPES:
                join16 = join16_at_plain if plain else join16_at
                words32 = join16(comp32, planes[0], abs_base + o_s1, count, ft)
                # 2E words, cut to ceil(out_floats / 2)
                words32 = words32[:, : -(-out_floats // 2)].contiguous()
            else:
                join = join_wide_at_plain if plain else join_wide_at
                words32 = join(comp32, planes, abs_base + o_s1, abs_base + o_s2,
                               count, ft)
    return (words32, success, n, csum_arch,
            _decoded_checksum(words32, n, ft, verify_checksum, plain))


def _decoded_checksum(words32, n, ft: FloatType, verify: bool, plain: bool):
    """XOR of the first n floats' bytes of each decoded row, or zeros: one
    read of those bytes in place (K8's checksum-only form on the card), or
    the plain fold where plain."""
    if not verify:
        return torch.zeros_like(n)
    with span("stage:float_codec.verify"):
        nbytes = n * FLOAT_WORD_SIZE[ft]
        if plain:
            return checksum_packed(to_u32(words32), nbytes)
        return checksum_rows(words32.view(torch.uint8), nbytes)


@spanned("model:float_codec.float_compress_padded")
def float_compress_padded(
    data32: torch.Tensor,
    n: torch.Tensor,
    float_type: FloatType,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    out_bytes: Optional[int] = None,
    native: bool = True,
    plain: bool = False,
):
    """Byte-row wrapper with the reference's getMaxFloatCompressedSize
    output-buffer contract: (comp uint8[B, max(4 CWf, out_bytes)], zero
    padded; comp_bytes int64[B])."""
    ft = _check_type(float_type)
    out32, comp_bytes = float_compress_core(
        data32, n, ft, prob_bits, use_checksum, native, plain
    )
    comp = out32.view(torch.uint8)
    cb = (max_float_compressed_size(ft, floats_capacity(data32.shape[1], ft))
          if out_bytes is None else out_bytes)
    if comp.shape[1] < cb:
        comp = F.pad(comp, (0, cb - comp.shape[1]))
    return comp, comp_bytes


def archive_layout(comp32: torch.Tensor, base32: torch.Tensor, float_type) -> bool:
    """The ANS layout of the float archives at word offsets base32 (int64[B])
    of comp32's rows (int32[B, CW]), as ``ans.read_layout`` reads it (and
    raises). Each member's first ANS archive is placed from its header
    words 0-1 as they stand, unchecked (a negative count as 0): a garbage
    row reads some word, which does not vote."""
    ft = FloatType(float_type)
    base = base32.to(device=comp32.device, dtype=torch.int64)
    k = torch.arange(2, dtype=torch.int64, device=comp32.device)
    words = torch.gather(comp32, 1, (base[:, None] + k).clamp(0, comp32.shape[1] - 1))
    is_al = to_u32(words[:, 0]) == FLOAT_MAGIC_VERSION2
    (_, _, o_ans), _ = _sections(words[:, 1].to(torch.int64).clamp(min=0), is_al, ft)
    return read_layout(comp32, base + o_ans)


def archive_float_type(comp32: torch.Tensor, base32: torch.Tensor) -> FloatType:
    """The float type in member 0's float header, at word base32[0] of
    comp32's row 0 (clamped): one read to the host. Raises ValueError on a
    word that names no type."""
    i = (base32[:1].to(device=comp32.device, dtype=torch.int64) + 2).clamp(
        0, comp32.shape[1] - 1)
    with span("sync:float_codec.float_type"):
        return FloatType(int(comp32[0, i]) & 0xF)


def float_get_compressed_info(comp_u8: torch.Tensor):
    """Header read: (sizes in floats, float types, stored checksums), each
    int64[B] (GpuFloatInfo.cuh:18-62)."""
    h = to_u32(comp_u8[:, :16].contiguous().view(torch.int32))
    return h[:, 1], h[:, 2] & 0xF, h[:, 3]
