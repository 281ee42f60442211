"""rANS decode: kernel K6 (to packed bytes), kernel K4 (fused with the
16-bit float join), kernel K12 (fused with the fp32 join), each in the
row-stream (0xDB0D) and the classic (0xD00D) layout, and their plain
versions, which share one walk.

Row layout: each row of 4 blocks shares one reverse cursor over its
stream. The walk is bottom-aligned (block iteration k = i - (128 - nsteps)
at step i), so every active block of a row undoes the same encode step and
the stream's reverse order is one suffix count over the row's 128 lanes
(the JAX package's ``ops/rans_decode.py:135``, ``decode_blocks_rows``).
Classic layout: each block has its own stream and cursor, the same walk
over a group of one block (the JAX package's ``ops/rans_decode.py:40``,
``decode_blocks``, whose top-aligned schedule visits the same positions).
Symbols at or past a block's decoded count are 0.

The decode reads the archive in place: ``decode_at`` takes the archive's
u32 words and, for each stream, its first word and length; for each
member, where block 0's states lie (block b's at + 32 b) and, fused, where
its raw sections lie. A stream read below its first word takes that word,
one at or past its length gives 0, and every other read outside the words
is clamped into them: the walk sees what a staging copy would hold.
``decode_at_plain`` stages with the plain merge and runs the walk; it is
the kernels' contract. Epilogues (chosen by the offsets given):

* none: the symbols packed into u32 words, the contract of
  ``decode_blocks_rows`` / ``decode_blocks`` and of the Pallas
  ``decode_blocks_fused2`` with ``row_stream=True`` / ``False`` (K6);
* ``raw_off``: each exponent byte joined with its raw byte
  (``float_split.py:193-202``): out = raw | sym << 8, rotated right by 1
  within 16 bits for bf16 (K4);
* ``raw_off`` (sec1) and ``sec2_off``: each exponent byte joined with the
  float's low 16 bits and third byte (the Pallas ``decode_join32_fused``,
  mode JOIN_F32): out = ror1(low16 | third << 16 | sym << 24) (K12).

The staged forms (``decode_rows``, ``decode_blocks``, ``decode_join16``,
``decode_join16_blocks``, ``decode_join32``, ``decode_join32_blocks``)
take start-aligned staged tensors; they lay them end to end and call
``decode_at``. Their ``*_plain`` twins run the walk on the staged tensors
directly, as the JAX functions do. CUDA tensors go to the kernels
(``csrc/rans_decode_rows.cu``), CPU tensors to the plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.config import use_kernels
from ..core.constants import (
    ANS_MIN_STATE,
    BLOCK_SIZE,
    MAX_BLOCK_WORDS32,
    MAX_ROW_WORDS32,
    STEPS_PER_BLOCK,
    VALID_PROB_BITS,
    WARP_SIZE,
    FloatType,
)
from ..runtime import cuda_kernels as K
from .bitops import M32, from_u32, to_u32
from .float_split import join16, join_wide_plain, pack_bytes, unpack_bytes
from .merge import runs_merge_plain

# the longest stream the decode reads, in u32 words: the worst-case row or
# block (MAX_ROW_WORDS32, MAX_BLOCK_WORDS32) plus slack; a longer length
# is cut to it
ROW_STREAM_CAP = MAX_ROW_WORDS32 + 8
BLOCK_STREAM_CAP = MAX_BLOCK_WORDS32 + 8
# the kernel wrapper of each (epilogue, layout): epilogue 0 bytes, 1 the
# 16-bit join, 2 the fp32 join; layout True rows, False classic
_WRAPPERS = {
    (0, True): "decode_rows", (0, False): "decode_blocks",
    (1, True): "decode_join16", (1, False): "decode_join16_blocks",
    (2, True): "decode_join32", (2, False): "decode_join32_blocks",
}


def _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits,
                       raw32=None, group: int = 4, sec2=None):
    if prob_bits not in VALID_PROB_BITS:
        raise ValueError(f"prob_bits must be one of {VALID_PROB_BITS}")
    if streams.dim() != 3:
        raise TypeError("streams must be [B, streams, SW]")
    B, NR, _ = streams.shape
    if comp_w.dim() != 2 or comp_w.shape[0] != B:
        raise TypeError("comp_w must be [B, NB]")
    NB = comp_w.shape[1]
    if NR != -(-NB // group):
        raise ValueError(f"{NR} streams for {NB} blocks in groups of {group}")
    checks = [
        ("streams", streams, streams.shape),
        ("comp_w", comp_w, (B, NB)),
        ("uncomp_w", uncomp_w, (B, NB)),
        ("states", states, (B, NB, WARP_SIZE)),
        ("lut", lut, (B, 1 << prob_bits)),
    ]
    if sec2 is not None:
        checks += [("sec1", raw32, (B, NB, BLOCK_SIZE // 2)),
                   ("sec2", sec2, (B, NB, BLOCK_SIZE // 4))]
    elif raw32 is not None:
        checks.append(("raw32", raw32, (B, NB, BLOCK_SIZE // 4)))
    for name, t, shape in checks:
        if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
            raise TypeError(f"{name} must be torch.int32 of shape {tuple(shape)}")
        if t.device != streams.device:
            raise ValueError("all inputs must lie on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_at_args(words, seg_off, seg_len, comp_w, uncomp_w, state_off, lut,
                   prob_bits, group, raw_off, sec2_off):
    if prob_bits not in VALID_PROB_BITS:
        raise ValueError(f"prob_bits must be one of {VALID_PROB_BITS}")
    if words.dtype != torch.int32 or words.dim() != 1 or words.numel() == 0:
        raise TypeError("words must be a non-empty 1-D torch.int32 tensor")
    if comp_w.dim() != 2:
        raise TypeError("comp_w must be [B, NB]")
    if sec2_off is not None and raw_off is None:
        raise ValueError("the fp32 join takes raw_off (sec1) with sec2_off")
    B, NB = comp_w.shape
    NSEG = -(-NB // group)
    checks = [
        ("words", words, torch.int32, words.shape),
        ("seg_off", seg_off, torch.int64, (B, NSEG)),
        ("seg_len", seg_len, torch.int64, (B, NSEG)),
        ("comp_w", comp_w, torch.int32, (B, NB)),
        ("uncomp_w", uncomp_w, torch.int32, (B, NB)),
        ("state_off", state_off, torch.int64, (B,)),
        ("lut", lut, torch.int32, (B, 1 << prob_bits)),
    ]
    for name, t in (("raw_off", raw_off), ("sec2_off", sec2_off)):
        if t is not None:
            checks.append((name, t, torch.int64, (B,)))
    for name, t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != tuple(shape):
            raise TypeError(f"{name} must be {dt} of shape {tuple(shape)}")
        if t.device != words.device:
            raise ValueError("all inputs must lie on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def decode_at(words, seg_off, seg_len, comp_w, uncomp_w, state_off, lut,
              prob_bits: int, rows: bool = True, raw_off=None, sec2_off=None,
              bf16: bool = False) -> torch.Tensor:
    """Decode every block of a batch from the archive words in place.

    words: int32[N] archive words (u32); seg_off / seg_len: int64[B, NSEG]
    each stream's first word in ``words`` and its length in words (one
    stream per row of 4 blocks if rows, else per block; 0 for dead ones);
    comp_w / uncomp_w: int32[B, NB] per-block u16 word and byte counts
    (uncomp_w <= 4096; 0 for dead blocks); state_off: int64[B] the word of
    block 0's 32 states; lut: int32[B, 2^prob_bits] from
    ``build_decode_table_batched``. raw_off: int64[B], the word of block 0's
    raw words (1024 a block: the 16-bit join), or of its sec1 words (2048
    a block) with sec2_off: int64[B], block 0's sec2 words (1024 a block:
    the fp32 join). Returns int32[B, NB, 1024] packed bytes, [B, NB, 2048]
    16-bit floats or [B, NB, 4096] fp32 words, zero past each block's
    count.
    """
    _check_at_args(words, seg_off, seg_len, comp_w, uncomp_w, state_off, lut,
                   prob_bits, 4 if rows else 1, raw_off, sec2_off)
    args = (words, seg_off, seg_len, comp_w, uncomp_w, state_off, lut,
            prob_bits, raw_off, sec2_off, bool(bf16))
    if use_kernels(words):
        epi = (raw_off is not None) + (sec2_off is not None)
        return getattr(K, _WRAPPERS[epi, bool(rows)])(*args)
    return decode_at_plain(*args, rows=rows)


def decode_at_plain(words, seg_off, seg_len, comp_w, uncomp_w, state_off, lut,
                    prob_bits: int, raw_off=None, sec2_off=None,
                    bf16: bool = False, rows: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the in-place decode (K4, K6, K12 in either
    layout); runs on any device. Stages each stream, cut to the stream cap,
    into a row one word wider than the cap, the states and the raw
    sections with the plain merge, then runs the walk."""
    group = 4 if rows else 1
    _check_at_args(words, seg_off, seg_len, comp_w, uncomp_w, state_off, lut,
                   prob_bits, group, raw_off, sec2_off)
    B, NB = comp_w.shape
    cap = ROW_STREAM_CAP if rows else BLOCK_STREAM_CAP
    streams = _stage(words, seg_off.reshape(-1),
                     seg_len.clamp(0, cap).reshape(-1), cap + 1).reshape(B, -1, cap + 1)
    states = _stage(words, state_off, 32 * NB).reshape(B, NB, WARP_SIZE)
    sym = _walk(streams, comp_w, uncomp_w, states, lut, prob_bits, group)
    if raw_off is None:
        return from_u32(pack_bytes(sym))
    if sec2_off is None:
        raw32 = _stage(words, raw_off, NB * (BLOCK_SIZE // 4))
        return _join(sym, uncomp_w, raw32.reshape(B, NB, -1), bf16)
    sec1 = _stage(words, raw_off, NB * (BLOCK_SIZE // 2))
    sec2 = _stage(words, sec2_off, NB * (BLOCK_SIZE // 4))
    return _join32(sym, uncomp_w, sec1.reshape(B, NB, -1), sec2.reshape(B, NB, -1))


def _stage(words, starts, counts, width=None):
    """int32[n, width]: row i holds counts[i] words of ``words`` from
    starts[i] (reads clamped into them), then zeros. counts: a tensor, or
    one int that is also the width."""
    n = starts.shape[0]
    dev = words.device
    if not isinstance(counts, torch.Tensor):
        width = counts
        counts = torch.full((n,), counts, dtype=torch.int64, device=dev)
    return runs_merge_plain(
        [words], torch.arange(n, dtype=torch.int64, device=dev) * width,
        torch.zeros(n, dtype=torch.int32, device=dev), starts, counts,
        n * width,
    ).reshape(n, width)


def _as_archive(streams, states, sections, cap: int):
    """Staged tensors laid end to end as archive words, for ``decode_at``:
    (words, seg_off and seg_len over the staged rows, state_off, the
    members' offsets of each section). Each staged row is one stream."""
    B, NSEG, SW = streams.shape
    if SW > cap:
        raise ValueError(f"staged streams of {SW} words pass the {cap}-word "
                         "stream cap")
    dev = streams.device
    parts = [streams, states, *sections]
    words = torch.cat([p.reshape(-1) for p in parts])
    starts, at = [], 0
    b = torch.arange(B, dtype=torch.int64, device=dev)
    for p in parts:
        starts.append(at + b * (p.numel() // B))
        at += p.numel()
    seg_off = (torch.arange(B * NSEG, dtype=torch.int64, device=dev) * SW
               ).reshape(B, NSEG)
    seg_len = torch.full((B, NSEG), SW, dtype=torch.int64, device=dev)
    return words, seg_off, seg_len, starts[1], starts[2:]


def decode_rows(streams, comp_w, uncomp_w, states, lut,
                prob_bits: int) -> torch.Tensor:
    """Decode every block of a batch into packed bytes.

    streams: int32[B, NR, SW] start-aligned staged row streams (u16 pairs);
    comp_w / uncomp_w: int32[B, NB] per-block u16 word and byte counts
    (uncomp_w <= 4096; 0 for dead blocks); states: int32[B, NB, 32]; lut:
    int32[B, 2^prob_bits] from ``build_decode_table_batched``. Returns
    int32[B, NB, 1024]: four bytes per word, zero past each block's count.
    """
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits)
    words, so, sl, st, _ = _as_archive(streams, states, [], ROW_STREAM_CAP)
    return decode_at(words, so, sl, comp_w, uncomp_w, st, lut, prob_bits)


def decode_rows_plain(streams, comp_w, uncomp_w, states, lut,
                      prob_bits: int) -> torch.Tensor:
    """Plain PyTorch version of K6; runs on any device."""
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits)
    sym = _walk(streams, comp_w, uncomp_w, states, lut, prob_bits, 4)
    return from_u32(pack_bytes(sym))


def decode_blocks(streams, comp_w, uncomp_w, states, lut,
                  prob_bits: int) -> torch.Tensor:
    """As ``decode_rows``, over per-block streams: streams int32[B, NB, SW]
    start-aligned staged block streams."""
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits,
                       group=1)
    words, so, sl, st, _ = _as_archive(streams, states, [], BLOCK_STREAM_CAP)
    return decode_at(words, so, sl, comp_w, uncomp_w, st, lut, prob_bits,
                     rows=False)


def decode_blocks_plain(streams, comp_w, uncomp_w, states, lut,
                        prob_bits: int) -> torch.Tensor:
    """Plain PyTorch version of K6's classic layout; runs on any device."""
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits,
                       group=1)
    sym = _walk(streams, comp_w, uncomp_w, states, lut, prob_bits, 1)
    return from_u32(pack_bytes(sym))


def decode_join16(streams, comp_w, uncomp_w, states, lut, raw32,
                  prob_bits: int, bf16: bool) -> torch.Tensor:
    """Decode every block of a batch and join it into 16-bit floats.

    Arguments as ``decode_rows``, plus raw32: int32[B, NB, 1024]
    block-major raw-section words. Returns int32[B, NB, 2048]: two floats
    per word, zero past each block's count.
    """
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits, raw32)
    words, so, sl, st, (ro,) = _as_archive(streams, states, [raw32],
                                           ROW_STREAM_CAP)
    return decode_at(words, so, sl, comp_w, uncomp_w, st, lut, prob_bits,
                     raw_off=ro, bf16=bf16)


def decode_join16_plain(streams, comp_w, uncomp_w, states, lut, raw32,
                        prob_bits: int, bf16: bool) -> torch.Tensor:
    """Plain PyTorch version of K4's row layout; runs on any device."""
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits, raw32)
    sym = _walk(streams, comp_w, uncomp_w, states, lut, prob_bits, 4)
    return _join(sym, uncomp_w, raw32, bf16)


def decode_join16_blocks(streams, comp_w, uncomp_w, states, lut, raw32,
                         prob_bits: int, bf16: bool) -> torch.Tensor:
    """As ``decode_join16``, over per-block streams: streams
    int32[B, NB, SW] start-aligned staged block streams."""
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits,
                       raw32, group=1)
    words, so, sl, st, (ro,) = _as_archive(streams, states, [raw32],
                                           BLOCK_STREAM_CAP)
    return decode_at(words, so, sl, comp_w, uncomp_w, st, lut, prob_bits,
                     rows=False, raw_off=ro, bf16=bf16)


def decode_join16_blocks_plain(streams, comp_w, uncomp_w, states, lut, raw32,
                               prob_bits: int, bf16: bool) -> torch.Tensor:
    """Plain PyTorch version of K4's classic layout; runs on any device."""
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits,
                       raw32, group=1)
    sym = _walk(streams, comp_w, uncomp_w, states, lut, prob_bits, 1)
    return _join(sym, uncomp_w, raw32, bf16)


def decode_join32(streams, comp_w, uncomp_w, states, lut, sec1, sec2,
                  prob_bits: int) -> torch.Tensor:
    """Decode every block of a batch and join it into fp32 words.

    Arguments as ``decode_rows``, plus sec1: int32[B, NB, 2048] block-major
    low-u16 pairs and sec2: int32[B, NB, 1024] block-major third bytes.
    Returns int32[B, NB, 4096]: one float per word, zero past each block's
    count.
    """
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits,
                       sec1, sec2=sec2)
    words, so, sl, st, (o1, o2) = _as_archive(streams, states, [sec1, sec2],
                                              ROW_STREAM_CAP)
    return decode_at(words, so, sl, comp_w, uncomp_w, st, lut, prob_bits,
                     raw_off=o1, sec2_off=o2)


def decode_join32_plain(streams, comp_w, uncomp_w, states, lut, sec1, sec2,
                        prob_bits: int) -> torch.Tensor:
    """Plain PyTorch version of K12's row layout; runs on any device."""
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits,
                       sec1, sec2=sec2)
    sym = _walk(streams, comp_w, uncomp_w, states, lut, prob_bits, 4)
    return _join32(sym, uncomp_w, sec1, sec2)


def decode_join32_blocks(streams, comp_w, uncomp_w, states, lut, sec1, sec2,
                         prob_bits: int) -> torch.Tensor:
    """As ``decode_join32``, over per-block streams: streams
    int32[B, NB, SW] start-aligned staged block streams."""
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits,
                       sec1, group=1, sec2=sec2)
    words, so, sl, st, (o1, o2) = _as_archive(streams, states, [sec1, sec2],
                                              BLOCK_STREAM_CAP)
    return decode_at(words, so, sl, comp_w, uncomp_w, st, lut, prob_bits,
                     rows=False, raw_off=o1, sec2_off=o2)


def decode_join32_blocks_plain(streams, comp_w, uncomp_w, states, lut, sec1,
                               sec2, prob_bits: int) -> torch.Tensor:
    """Plain PyTorch version of K12's classic layout; runs on any device."""
    _check_decode_args(streams, comp_w, uncomp_w, states, lut, prob_bits,
                       sec1, group=1, sec2=sec2)
    sym = _walk(streams, comp_w, uncomp_w, states, lut, prob_bits, 1)
    return _join32(sym, uncomp_w, sec1, sec2)


def _keep(uncomp_w, dev):
    """bool[B, NB, 4096]: positions below each block's count."""
    p = torch.arange(BLOCK_SIZE, dtype=torch.int64, device=dev)
    return p < uncomp_w.to(torch.int64)[..., None]


def _join(sym, uncomp_w, raw32, bf16: bool) -> torch.Tensor:
    raw = torch.where(_keep(uncomp_w, sym.device), unpack_bytes(to_u32(raw32)), 0)
    return from_u32(join16(sym, raw, bf16))


def _join32(sym, uncomp_w, sec1, sec2) -> torch.Tensor:
    """The fp32 join of ``join_wide_plain`` per block, zero past the count."""
    B, NB, _ = sym.shape
    words = join_wide_plain(
        [from_u32(pack_bytes(sym)).reshape(B * NB, BLOCK_SIZE // 4)],
        sec1.reshape(B * NB, -1), sec2.reshape(B * NB, -1), FloatType.FLOAT32,
    ).reshape(B, NB, BLOCK_SIZE)
    return torch.where(_keep(uncomp_w, sym.device), words, 0)


def _walk(streams, comp_w, uncomp_w, states, lut, prob_bits: int, group: int):
    """The decode walk over every stream of `group` consecutive blocks (4:
    the row layout, 1: the classic one). Returns the symbols, int64
    [B, NB, 4096], 0 at positions at or past each block's count."""
    dev = streams.device
    B, NR, SW = streams.shape
    NB = comp_w.shape[1]
    NB4 = group * NR
    S = STEPS_PER_BLOCK

    def pad4(a):  # [B, NB, ...] -> [B, NB4, ...]
        return F.pad(a, [0, 0] * (a.dim() - 2) + [0, NB4 - NB])

    uw = pad4(uncomp_w.to(torch.int64)).reshape(B, NR, group)
    cw = pad4(comp_w.to(torch.int64)).reshape(B, NR, group)
    r = ((uw - 1) % WARP_SIZE) + 1  # tail group width
    nsteps = (uw + WARP_SIZE - 1) // WARP_SIZE
    st = to_u32(pad4(states)).reshape(B, NR, group * WARP_SIZE)
    ptr = cw.sum(dim=2)
    lut64 = to_u32(lut)
    rows = to_u32(streams)
    lanes = torch.arange(WARP_SIZE, dtype=torch.int64, device=dev)
    smask = (1 << prob_bits) - 1

    syms = []
    for i in range(S):
        k = i - (S - nsteps)
        active = (k >= 0) & (uw > 0)
        valid = (
            active[..., None] & ((k[..., None] > 0) | (lanes < r[..., None]))
        ).reshape(B, NR, group * WARP_SIZE)
        ent = torch.gather(lut64, 1, (st & smask).reshape(B, -1)).reshape(st.shape)
        syms.append(ent & 0xFF)
        pdf = (ent >> 8) & 0xFFF
        st = torch.where(valid, (pdf * (st >> prob_bits) + (ent >> 20)) & M32, st)
        read = valid & (st < ANS_MIN_STATE)
        # reads of lanes >= l in the stream: the reverse of the
        # blocks-then-lanes order
        suffix = read.flip(2).to(torch.int64).cumsum(2).flip(2)
        idx16 = ptr[..., None] - suffix
        w32 = torch.gather(rows, 2, (idx16 >> 1).clamp(0, SW - 1))
        val = torch.where((idx16 & 1) == 1, w32 >> 16, w32 & 0xFFFF)
        st = torch.where(read, ((st << 16) + val) & M32, st)
        ptr = ptr - read.sum(dim=2)

    # step i decoded positions 32 * (127 - i) + lane of every block
    sym = (
        torch.stack(syms).flip(0)
        .reshape(S, B, NR, group, WARP_SIZE)
        .permute(1, 2, 3, 0, 4)
        .reshape(B, NB4, BLOCK_SIZE)[:, :NB]
    )
    p = torch.arange(BLOCK_SIZE, dtype=torch.int64, device=dev)
    return torch.where(p < uncomp_w.to(torch.int64)[..., None], sym, 0)
