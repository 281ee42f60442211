"""ANS archives in both layouts: assembly runs on compress, header parse
and validation on decompress (the decode then reads the streams and states
from the archive in place), and the byte-row entry points.

A port of the JAX package's ``models/ans.py``. An ANS archive is
[header 8 | pdf 128 | states 32*nb | blockWords 2*round2(nb) | streams], in
u32 words. The classic layout (magic 0xD00D, the CUDA reference's) has one
stream per block, each 16 B aligned, and blockWords.y holds the block's
start. The row-stream layout (0xDB0D) has one stream per row of 4 blocks,
16 B aligned per row, and blockWords.y holds the row's start, repeated
across its 4 blocks. Header word 4 holds prob_bits | use_checksum << 4, and
word 5 the XOR checksum of the input bytes when it is used. The encoder
returns the archive as runs for the caller's merge; the decoder validates
every archive-supplied count before it reaches a kernel, folding a failure
into the member's ``success`` (never a trap).

Metadata arithmetic is int64 on the inputs' device; u32 values are int64
carriers (``ops.bitops``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.config import use_kernels
from ..core.constants import (
    ANS_MAGIC,
    ANS_MAGIC_NATIVE,
    ANS_VERSION,
    BLOCK_SIZE,
    DEFAULT_PROB_BITS,
    MAX_BLOCK_WORDS32,
    MAX_ROW_WORDS32,
    WARP_SIZE,
    max_compressed_size,
)
from ..ops.bitops import from_u32, to_i32, to_u32
from ..ops.checksum import checksum_packed
from ..ops.histogram import byte_hist, byte_hist_plain, checksum_rows
from ..ops.merge import runs_merge, runs_merge_plain
from ..ops.rans_decode import decode_at, decode_at_plain
from ..ops.rans_encode import (
    encode_blocks,
    encode_blocks_plain,
    encode_rows,
    encode_rows_plain,
)
from ..ops.table import ans_table, ans_table_plain, build_decode_table_batched
from ..runtime import cuda_kernels as K
from ..utils.profiling import span

ANS_MAGIC_VERSION = (ANS_MAGIC << 16) | ANS_VERSION
ANS_MAGIC_NATIVE_VERSION = (ANS_MAGIC_NATIVE << 16) | ANS_VERSION
META_WORDS = 136  # header (8) + packed pdf table (128)

# source indices of EncodedRuns.src_ref
SRC_META, SRC_PAIRS, SRC_STREAMS = 0, 1, 2


class EncodedRuns(NamedTuple):
    """An encoded batch as merge runs (see ``ans_encode_sections``)."""

    meta: torch.Tensor  # int32[B, 136 + 32*NB]: header, pdf, states
    pairs: torch.Tensor  # int32[B, 2*NB]: blockWords (x, y)
    # int32[B, NSEG, MAXW]: row streams (NSEG = NR, MAXW = MAX_ROW_WORDS32)
    # or block streams (NB, MAX_BLOCK_WORDS32)
    streams: torch.Tensor
    dst: torch.Tensor  # int64[B, 2 + NSEG], relative to the archive start
    src_ref: torch.Tensor  # int32[B, 2 + NSEG]: SRC_META, SRC_PAIRS, SRC_STREAMS
    src_off: torch.Tensor  # int64[B, 2 + NSEG], into the flattened source
    lens: torch.Tensor  # int64[B, 2 + NSEG]
    comp_bytes: torch.Tensor  # int64[B]


def _ceil_div(a, b):
    return -(-a // b)


def _layout(nb: torch.Tensor):
    """Per-member u32 offsets of blockWords and of the streams."""
    bw_off = META_WORDS + 32 * nb
    data_off = bw_off + 2 * (_ceil_div(nb, 2) * 2)
    return bw_off, data_off


def ans_encode_sections(
    x32: torch.Tensor,
    sizes: torch.Tensor,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    hist: Optional[torch.Tensor] = None,
    s_bytes: Optional[int] = None,
    hist_totals: Optional[torch.Tensor] = None,
    native: bool = True,
    plain: bool = False,
) -> EncodedRuns:
    """Encode byte rows into ANS archives, returned as runs.

    x32: int32[B, W] packed bytes; sizes: int32[B] byte counts; s_bytes:
    the rows' byte capacity, which fixes NB (default 4W). hist: optional
    caller-supplied int32[B, 256] byte histograms of the first sizes[b]
    bytes, which skip the statistics pass (GpuANSCodec.h:82-84); they are
    normalised against sizes, or against hist_totals where given. Without
    hist, one K8 launch counts the bytes and folds their checksum. One K17
    launch builds every member's encode table (``ops.table.ans_table``).
    use_checksum writes the XOR of the input bytes into header word 5.
    native picks the row-stream layout, else the classic one. plain=True
    runs every kernel's plain version wherever the tensors lie.
    """
    dev = x32.device
    B, W = x32.shape
    S = 4 * W if s_bytes is None else s_bytes
    NB = max(1, _ceil_div(S, BLOCK_SIZE))
    NR = _ceil_div(NB, 4)
    sizes64 = sizes.to(torch.int64)

    with span("stage:ans.encode"):
        # whole blocks: 16 B aligned rows for K8 and K2
        xp = F.pad(x32, (0, NB * (BLOCK_SIZE // 4) - W))
        csum = torch.zeros_like(sizes64)
        rows = xp.view(torch.uint8)
        if hist is None:
            hist, csum_k = (byte_hist_plain if plain else byte_hist)(rows, sizes64)
            if use_checksum:
                csum = csum_k.to(torch.int64)
        elif use_checksum:
            csum = (checksum_packed(to_u32(x32), sizes64) if plain
                    else checksum_rows(rows, sizes64))
    with span("stage:ans.table"):
        totals = sizes64 if hist_totals is None else hist_totals.to(torch.int64)
        packed, magic, pdf = (ans_table_plain if plain else ans_table)(
            hist, totals, prob_bits)
    with span("stage:ans.encode"):
        if native:
            encode = encode_rows_plain if plain else encode_rows
        else:
            encode = encode_blocks_plain if plain else encode_blocks
        states, streams, num_words = encode(
            xp, sizes.to(torch.int32), packed, magic, prob_bits
        )

    with span("stage:ans.runs"):
        nb = _ceil_div(sizes64, BLOCK_SIZE)
        blk = torch.arange(NB, dtype=torch.int64, device=dev)[None, :]
        live = blk < nb[:, None]
        if native:
            # 16 B aligned exclusive prefix per row of 4 blocks; blockWords.y
            # holds the row start, repeated across the row's blocks
            nw4 = F.pad(num_words.to(torch.int64), (0, 4 * NR - NB)).reshape(B, NR, 4)
            seg_words = nw4.sum(dim=2)
            aligned = (seg_words + 7) // 8 * 8
            incl = torch.cumsum(aligned, dim=1)
            seg_prefix = incl - aligned
            prefix = seg_prefix.repeat_interleave(4, dim=1)[:, :NB]
            seg = torch.arange(NR, dtype=torch.int64, device=dev)[None, :]
            seg_live = seg < _ceil_div(nb, 4)[:, None]
            NSEG, MAXW = NR, MAX_ROW_WORDS32
        else:
            # 16 B aligned exclusive prefix of the per-block word counts
            seg_words = num_words.to(torch.int64)
            aligned = (seg_words + 7) // 8 * 8
            incl = torch.cumsum(aligned, dim=1)
            seg_prefix = prefix = incl - aligned
            seg, seg_live = blk, live
            NSEG, MAXW = NB, MAX_BLOCK_WORDS32
        total_words = incl[:, -1]

        uncomp_w = (sizes64[:, None] - blk * BLOCK_SIZE).clamp(0, BLOCK_SIZE)
        zeros = torch.zeros_like(sizes64)
        hdr8 = torch.stack(
            [zeros + (ANS_MAGIC_NATIVE_VERSION if native else ANS_MAGIC_VERSION),
             nb, sizes64, total_words,
             zeros + (prob_bits | (int(use_checksum) << 4)), csum, zeros, zeros],
            dim=1,
        )
        bw_off, data_off = _layout(nb)
        comp_bytes = 4 * data_off + 2 * total_words

        probs16 = pdf[:, 0::2] | (pdf[:, 1::2] << 16)
        meta = torch.cat(
            [from_u32(hdr8), from_u32(probs16), states.reshape(B, NB * WARP_SIZE)],
            dim=1,
        )
        bw_x = (uncomp_w << 16) | num_words.to(torch.int64)
        pairs = from_u32(torch.stack(
            [torch.where(live, bw_x, 0), torch.where(live, prefix, 0)], dim=2
        ).reshape(B, 2 * NB))

        b_ar = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
        dst = torch.cat(
            [torch.zeros_like(b_ar), bw_off[:, None],
             data_off[:, None] + (seg_prefix >> 1)], dim=1)
        with span("sync:ans.run_refs"):
            src_ref = torch.cat(
                [torch.full((B, 1), SRC_META), torch.full((B, 1), SRC_PAIRS),
                 torch.full((B, NSEG), SRC_STREAMS)], dim=1).to(torch.int32).to(dev)
        src_off = torch.cat(
            [b_ar * meta.shape[1], b_ar * pairs.shape[1],
             (b_ar * NSEG + seg) * MAXW], dim=1)
        lens = torch.cat(
            [(META_WORDS + 32 * nb)[:, None], (2 * nb)[:, None],
             torch.where(seg_live, (seg_words + 1) >> 1, 0)], dim=1)
        return EncodedRuns(meta, pairs, streams, dst, src_ref, src_off, lens,
                           comp_bytes)


def _tight_bytes(S: int) -> int:
    """Bytes of an ANS archive row for S input bytes: metadata plus fully
    incompressible streams for NB blocks, at most the reference's
    ``max_compressed_size`` (the JAX package's ``models/ans.py:278-283``)."""
    NB = max(1, _ceil_div(S, BLOCK_SIZE))
    need = (4 * META_WORDS + 128 * NB + 8 * ((NB + 1) // 2 * 2)
            + 4 * MAX_BLOCK_WORDS32 * NB)
    return min(max_compressed_size(S), _ceil_div(need, 16) * 16)


def ans_encode_core(
    x32: torch.Tensor,
    sizes: torch.Tensor,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    hist: Optional[torch.Tensor] = None,
    s_bytes: Optional[int] = None,
    hist_totals: Optional[torch.Tensor] = None,
    native: bool = True,
    plain: bool = False,
):
    """Compress byte rows to ANS archives in u32 words; arguments as
    ``ans_encode_sections``. Returns (out32 int32[B, tight / 4], zero past
    each archive; comp_bytes int64[B])."""
    B, W = x32.shape
    S = 4 * W if s_bytes is None else s_bytes
    seg = ans_encode_sections(x32, sizes, prob_bits, use_checksum, hist, S,
                              hist_totals, native, plain)
    out_words = _tight_bytes(S) // 4
    row0 = torch.arange(B, dtype=torch.int64, device=x32.device)[:, None] * out_words
    merge = runs_merge_plain if plain else runs_merge
    out = merge(
        [seg.meta.reshape(-1), seg.pairs.reshape(-1), seg.streams.reshape(-1)],
        (seg.dst + row0).reshape(-1), seg.src_ref.reshape(-1),
        seg.src_off.reshape(-1), seg.lens.reshape(-1), B * out_words,
    )
    return out.reshape(B, out_words), seg.comp_bytes


def ans_encode_padded(
    x_u8: torch.Tensor,
    sizes: torch.Tensor,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    hist: Optional[torch.Tensor] = None,
    out_bytes: Optional[int] = None,
    hist_totals: Optional[torch.Tensor] = None,
    native: bool = True,
    plain: bool = False,
):
    """Byte-row wrapper around ``ans_encode_core`` with the reference's
    ``max_compressed_size`` output-buffer contract: x_u8 uint8[B, S]
    -> (comp uint8[B, max(tight, out_bytes)], zero padded; comp_bytes
    int64[B]). Bytes at or past sizes[b] are never read into the archive."""
    if x_u8.dtype != torch.uint8 or x_u8.dim() != 2:
        raise TypeError("x_u8 must be a 2-D torch.uint8 tensor")
    S = x_u8.shape[1]
    x_u8 = F.pad(x_u8, (0, -S % 4)) if S % 4 else x_u8.contiguous()
    out32, comp_bytes = ans_encode_core(
        x_u8.view(torch.int32), sizes, prob_bits, use_checksum, hist, S,
        hist_totals, native, plain,
    )
    comp = out32.view(torch.uint8)
    cb = max_compressed_size(S) if out_bytes is None else out_bytes
    if comp.shape[1] < cb:
        comp = F.pad(comp, (0, cb - comp.shape[1]))
    return comp, comp_bytes


class ParsedANS(NamedTuple):
    """Where the decode reads a batch's archives, in place: word offsets
    into the archive rows flattened (``comp32.reshape(-1)``)."""

    # int64[B, NR] (row layout) or [B, NB] (classic): each stream's first
    # word and its length in words, 0 for dead streams
    seg_off: torch.Tensor
    seg_len: torch.Tensor
    comp_w: torch.Tensor  # int32[B, NB]
    uncomp_w: torch.Tensor  # int32[B, NB]
    state_off: torch.Tensor  # int64[B]: block 0's 32 states (block b's at + 32 b)
    pdf: torch.Tensor  # int64[B, 256]
    success: torch.Tensor  # bool[B]
    n: torch.Tensor  # int64[B] decoded byte counts (0 where invalid)
    csum: torch.Tensor  # int64[B] the header's checksum word
    # int32[B, 2^prob_bits]: the decode table of pdf (``ans_parse`` sets it)
    lut: Optional[torch.Tensor] = None


def _ans_parse(
    comp32: torch.Tensor,
    base32: torch.Tensor,
    out_capacity: int,
    capacities: Optional[torch.Tensor],
    prob_bits: int,
    native: bool = True,
) -> ParsedANS:
    """Parse and validate the ANS headers at per-member word offsets base32
    of comp32's rows, and locate the states and the streams (one per row of
    4 blocks if native, else one per block) for the decode to read in
    place. The blockWords come in one indexed read.

    A wrong magic or prob_bits, an inconsistent block count, an extent past
    the row, or blockWords that break the format fail the member (size
    reported 0, its streams empty) instead of trapping
    (the JAX package's ``models/ans.py:369-377, 431-487``)."""
    dev = comp32.device
    B, CW = comp32.shape
    NB = max(1, _ceil_div(out_capacity, BLOCK_SIZE))
    NR = _ceil_div(NB, 4)
    base = base32.to(torch.int64)

    def row_gather(idx):  # idx int64[B, k] relative to base
        i = (base[:, None] + idx).clamp(0, CW - 1)
        return to_u32(torch.gather(comp32, 1, i))

    k8 = torch.arange(8, dtype=torch.int64, device=dev).expand(B, 8)
    hdr = row_gather(k8)
    nb_arch = to_i32(hdr[:, 1])
    n = to_i32(hdr[:, 2])
    total_w = to_i32(hdr[:, 3])
    csum = hdr[:, 5]

    magic_ok = hdr[:, 0] == (
        ANS_MAGIC_NATIVE_VERSION if native else ANS_MAGIC_VERSION)
    pb_ok = (hdr[:, 4] & 0xF) == prob_bits
    struct_ok = (n >= 0) & (total_w >= 0) & (nb_arch == _ceil_div(n, BLOCK_SIZE))
    _, data_off_arch = _layout(nb_arch.clamp(0, 1 << 24))
    fits = base + data_off_arch + ((total_w + 1) >> 1) <= CW
    valid = magic_ok & pb_ok & struct_ok & fits
    n = torch.where(valid, n, 0)
    nb_arch = torch.where(valid, nb_arch, 0)
    if capacities is None:
        capacities = torch.full((B,), out_capacity, dtype=torch.int64, device=dev)
    success = valid & (n <= capacities.to(torch.int64))

    pw = row_gather(8 + torch.arange(128, dtype=torch.int64, device=dev).expand(B, 128))
    pdf = torch.stack([pw & 0xFFFF, pw >> 16], dim=2).reshape(B, 256)

    nb = torch.minimum(nb_arch, torch.full_like(nb_arch, NB))
    blk = torch.arange(NB, dtype=torch.int64, device=dev)[None, :]
    live = (blk < nb[:, None]) & success[:, None]

    flat = comp32.reshape(-1)
    abs_base = torch.arange(B, dtype=torch.int64, device=dev) * CW + base
    bw_off, data_off = _layout(nb_arch)
    # the blockWords of blocks below nb, read clamped into the archive words
    k2 = torch.arange(2 * NB, dtype=torch.int64, device=dev)[None, :]
    i2 = ((abs_base + bw_off)[:, None] + k2).clamp(0, flat.numel() - 1)
    bw = torch.where(k2 < 2 * nb[:, None], to_u32(flat[i2]), 0).reshape(B, NB, 2)

    bx, by = bw[:, :, 0], bw[:, :, 1]
    uncomp_w = torch.where(live, bx >> 16, 0)
    comp_w = torch.where(live, bx & 0xFFFF, 0)
    starts = torch.where(live, to_i32(by), 0)

    # blockWords must match the format before they locate streams:
    # uncomp_w EQUAL to the header-derived fill (so outputs are zero past n
    # by construction), comp_w within the worst case, extents inside total
    uw_expect = (n[:, None] - blk * BLOCK_SIZE).clamp(0, BLOCK_SIZE)
    blk_ok = ~live | (
        (comp_w <= 2 * MAX_BLOCK_WORDS32)
        & (uncomp_w == uw_expect)
        & (starts >= 0)
        & (starts + comp_w <= total_w[:, None])
    )
    success = success & blk_ok.all(dim=1)
    live = live & success[:, None]
    comp_w = torch.where(live, comp_w, 0)
    uncomp_w = torch.where(live, uncomp_w, 0)
    starts = torch.where(live, starts, 0)

    if native:
        # one stream per row of 4 blocks; the row's start is repeated in
        # each of its blocks' blockWords.y, so take the first. A row sums 4
        # blocks' counts, so the per-block extent check does not cover it
        seg_words = F.pad(comp_w, (0, 4 * NR - NB)).reshape(B, NR, 4).sum(dim=2)
        seg_starts = starts[:, 0::4]
        success = success & (seg_starts + seg_words <= total_w[:, None]).all(dim=1)
    else:
        seg_words, seg_starts = comp_w, starts
    dead = ~success[:, None]
    seg_words = torch.where(dead, 0, seg_words)
    seg_starts = torch.where(dead, 0, seg_starts)
    comp_w = torch.where(dead, 0, comp_w)
    uncomp_w = torch.where(dead, 0, uncomp_w)
    return ParsedANS(
        (abs_base + data_off)[:, None] + (seg_starts >> 1), (seg_words + 1) >> 1,
        comp_w.to(torch.int32), uncomp_w.to(torch.int32), abs_base + META_WORDS,
        pdf, success, n, csum,
    )


def _expect_sizes(p: ParsedANS, n: torch.Tensor) -> ParsedANS:
    """p with each member whose decoded size is not n (int64[B]; -1 fails
    the member) failed and its streams and blocks emptied, as the parse
    leaves a member it fails: the decode writes zeros for it."""
    ok = p.success & (p.n == n)
    dead = ~ok[:, None]
    return p._replace(
        seg_len=torch.where(dead, 0, p.seg_len), comp_w=torch.where(dead, 0, p.comp_w),
        uncomp_w=torch.where(dead, 0, p.uncomp_w), success=ok)


def ans_parse_plain(comp32, base32, out_capacity, capacities, prob_bits,
                    native=True, expect_n=None) -> ParsedANS:
    """K16's contract: ``_ans_parse``, then ``_expect_sizes`` where expect_n
    (int64[B]) is given, then the decode table of the pdf
    (``build_decode_table_batched``) as the result's lut."""
    p = _ans_parse(comp32, base32, out_capacity, capacities, prob_bits, native)
    if expect_n is not None:
        p = _expect_sizes(p, expect_n)
    return p._replace(lut=from_u32(build_decode_table_batched(p.pdf, prob_bits)))


def ans_parse(comp32, base32, out_capacity, capacities, prob_bits,
              native=True, expect_n=None) -> ParsedANS:
    """The parse, the expected-size check and the decode table of every
    member (``ans_parse_plain``'s result): one launch of K16 for a CUDA
    tensor (``csrc/ans_parse.cu``), the plain version for a CPU tensor.
    comp32 int32[B, CW] contiguous; base32, capacities and expect_n [B] of
    any integer type (capacities and expect_n may be None)."""
    if not use_kernels(comp32):
        return ans_parse_plain(comp32, base32, out_capacity, capacities,
                               prob_bits, native, expect_n)

    def i64(t):
        return None if t is None else t.to(device=comp32.device,
                                            dtype=torch.int64).contiguous()

    return ParsedANS(*K.ans_parse(comp32, i64(base32), out_capacity,
                                  i64(capacities), prob_bits, native,
                                  i64(expect_n)))


def _ans_decode(comp32, base32, out_capacity, capacities, prob_bits, native,
                plain, raw_off=None, sec2_off=None, bf16=False, expect_n=None):
    """Parse, then one in-place decode of every member; the epilogue as
    ``ops.rans_decode.decode_at``'s. expect_n: fail the members whose
    decoded size is not this before the decode (``_expect_sizes``).
    Returns (out, ParsedANS)."""
    with span("stage:ans.parse"):
        p = (ans_parse_plain if plain else ans_parse)(
            comp32, base32, out_capacity, capacities, prob_bits, native, expect_n)
    with span("stage:ans.decode"):
        decode = decode_at_plain if plain else decode_at
        out = decode(comp32.reshape(-1), p.seg_off, p.seg_len, p.comp_w,
                     p.uncomp_w, p.state_off, p.lut, prob_bits, raw_off=raw_off,
                     sec2_off=sec2_off, bf16=bf16, rows=native)
    return out, p


def read_layout(comp32: torch.Tensor, word_off: torch.Tensor) -> bool:
    """The layout of the ANS archives at word offsets word_off (int64[B],
    clamped into the rows) of comp32's rows (int32[B, CW]): True for
    row-stream (ANS_MAGIC_NATIVE), False for classic (ANS_MAGIC). One
    gather of each member's magic and one read of B words to the host.
    Raises ValueError on a batch that mixes the layouts (one staging shape
    per call). A word that holds neither magic (a garbage row) does not
    vote: the decode folds it into the member's failure."""
    i = word_off.to(torch.int64).clamp(0, comp32.shape[1] - 1)
    magic = torch.gather(comp32, 1, i[:, None])[:, 0]
    with span("sync:ans.layout"):
        magic = (to_u32(magic) >> 16).cpu()
    is_nat = magic == ANS_MAGIC_NATIVE
    if bool(is_nat.any()) and bool((magic == ANS_MAGIC).any()):
        raise ValueError(
            "batch mixes classic (0xD00D) and native (0xDB0D) ANS layouts; "
            "decompress them in separate calls or pass native= explicitly"
        )
    return bool(is_nat.any())


def ans_decode_core(
    comp32: torch.Tensor,
    base32: torch.Tensor,
    out_capacity: int,
    prob_bits: int = DEFAULT_PROB_BITS,
    capacities: Optional[torch.Tensor] = None,
    native: bool = True,
    plain: bool = False,
):
    """Decode the ANS archives (row-stream if native, else classic) at word
    offsets base32 of comp32's rows into packed bytes (the JAX package's
    ``models/ans.py:515-568``).

    Returns (out32 int32[B, ceil(out_capacity / 4)], zero past each
    member's size and all zero for failed members; success bool[B];
    n int64[B]; csum int64[B])."""
    comp32 = comp32.contiguous()
    out, p = _ans_decode(comp32, base32, out_capacity, capacities, prob_bits,
                         native, plain)
    B, NB = p.comp_w.shape
    OW = _ceil_div(out_capacity, 4)
    out32 = out.reshape(B, NB * (BLOCK_SIZE // 4))[:, :OW]
    return torch.where(p.success[:, None], out32, 0), p.success, p.n, p.csum


def ans_decode_join16_core(
    comp32: torch.Tensor,
    base32: torch.Tensor,
    raw_off: torch.Tensor,
    out_floats: int,
    prob_bits: int,
    bf16: bool,
    capacities: Optional[torch.Tensor] = None,
    native: bool = True,
    plain: bool = False,
):
    """Decode the exponent-plane ANS archives at word offsets base32 and
    join them with the raw section that starts at word raw_off (int64[B])
    of ``comp32.reshape(-1)``, 1024 words a block, into 16-bit floats.

    Returns (words32 int32[B, ceil(out_floats / 2)], success bool[B],
    n int64[B], csum int64[B]). words32 is not masked by success: the float
    codec applies its combined success."""
    comp32 = comp32.contiguous()
    out, p = _ans_decode(comp32, base32, out_floats, capacities, prob_bits,
                         native, plain, raw_off=raw_off, bf16=bf16)
    B, NB = p.comp_w.shape
    OW = _ceil_div(2 * out_floats, 4)
    return out.reshape(B, NB * 2048)[:, :OW], p.success, p.n, p.csum


def ans_decode_join32_core(
    comp32: torch.Tensor,
    base32: torch.Tensor,
    sec1_off: torch.Tensor,
    sec2_off: torch.Tensor,
    expect_n: torch.Tensor,
    out_floats: int,
    prob_bits: int,
    capacities: Optional[torch.Tensor] = None,
    native: bool = True,
    plain: bool = False,
):
    """Decode the fp32 exponent-plane ANS archives at word offsets base32
    and join them with the raw sections that start at words sec1_off
    (low-u16 pairs, 2048 words a block) and sec2_off (third bytes, 1024
    words a block), int64[B] each, of ``comp32.reshape(-1)``, into fp32
    words (the JAX package's ``models/ans.py:608-640``). A member whose
    decoded size is not expect_n (int64[B]; -1 fails it) fails before the
    decode, which writes zeros for it.

    Returns (words32 int32[B, 4E] for E = max(ceil(out_floats / 4), 1), zero
    past each member's size and for failed members; success bool[B];
    n int64[B]; csum int64[B])."""
    comp32 = comp32.contiguous()
    out, p = _ans_decode(comp32, base32, out_floats, capacities, prob_bits,
                         native, plain, raw_off=sec1_off, sec2_off=sec2_off,
                         expect_n=expect_n)
    B, NB = p.comp_w.shape
    # the blocks' words are zero past each block's count, and NB blocks
    # hold at least 4E words
    OW = 4 * max(_ceil_div(out_floats, 4), 1)
    return (out.reshape(B, NB * BLOCK_SIZE)[:, :OW].contiguous(), p.success,
            p.n, p.csum)


def ans_decode_padded(
    comp_u8: torch.Tensor,
    out_capacity: int,
    prob_bits: int = DEFAULT_PROB_BITS,
    capacities: Optional[torch.Tensor] = None,
    native: Optional[bool] = True,
    plain: bool = False,
):
    """Byte-row wrapper around ``ans_decode_core``: archives at the starts
    of comp_u8's rows (uint8[B, C]) -> (out uint8[B, out_capacity], zero
    past each member's size; success bool[B]; n int64[B]; csum int64[B]).
    native=None reads the layout from the archives (``read_layout``)."""
    if comp_u8.dtype != torch.uint8 or comp_u8.dim() != 2:
        raise TypeError("comp_u8 must be a 2-D torch.uint8 tensor")
    C = comp_u8.shape[1]
    comp_u8 = F.pad(comp_u8, (0, -C % 4)) if C % 4 else comp_u8.contiguous()
    comp32 = comp_u8.view(torch.int32)
    base = torch.zeros(comp32.shape[0], dtype=torch.int64, device=comp32.device)
    if native is None:
        native = read_layout(comp32, base)
    out32, success, n, csum = ans_decode_core(
        comp32, base, out_capacity, prob_bits, capacities, native, plain)
    return out32.contiguous().view(torch.uint8)[:, :out_capacity], success, n, csum


def ans_get_compressed_info(comp_u8: torch.Tensor):
    """Decoded sizes and stored checksums (int64[B] each) from the archive
    headers at the starts of comp_u8's rows (GpuANSInfo.cuh:16-37)."""
    hdr = to_u32(comp_u8[:, :32].contiguous().view(torch.int32))
    return hdr[:, 2], hdr[:, 5]
