"""Plain PyTorch reference of the archive format: a decoder written from
the format's description, which imports nothing of the program.

It reads what the program's compress returned, checks every field the
format fixes, decodes every ANS stream with its own rANS walk and joins the
floats back, so that a wrong archive shows even where the program's own
decoder would agree with it. It runs on the archives' device.

The format, in little-endian u32 words:

* ANS archive: header [magic, blocks, symbols, stream u16 words,
  prob_bits | checksum flag << 4, checksum, 0, 0], 256 u16 probabilities
  summing to 2^prob_bits, 32 final states a block, a (x, y) pair a block
  (x = uncoded bytes << 16 | coded u16 words, y = the u16 offset of its
  stream) padded to an even count of blocks, then the streams. Each block
  of 4096 bytes is coded by 32 interleaved rANS states (state l codes byte
  32 s + l at step s; states start at 2^15 and stay below 2^31; before
  coding, a state at or above pdf << (31 - prob_bits) writes its low 16
  bits). Layout 0xDB0D ("rows"): the blocks of each row of 4 share one
  stream, step-major, then blocks, then lanes ascending, and y repeats the
  row's offset. Layout 0xD00D ("classic"): a stream a block. Streams start
  on 16 B boundaries.
* Float archive: header [0xF00F0001 or 0xF00F0002 (v2), floats,
  type | checksum flag << 4, checksum (XOR of the input bytes), bytes of
  the first ANS archive (fp64), 0, 0, 0], the raw sections, then one ANS
  archive per exponent plane (two for fp64). Sections are 16 B aligned;
  a v2 archive (rows layout, at least 2^20 floats) starts at word 128 and
  puts each section on a 128-word boundary. After a rotate left by 1:
  16-bit floats keep the high byte as exponent and the low byte raw;
  fp32 the top byte, the low 16 bits (sec1) and byte 2 (sec2); fp64 the
  top two bytes as two planes, the low word (sec1) and bits 32-47 (sec2).
  fp16 is not rotated.
* Sparse archive: [floats, 0, 0, 0], the nonzero bitmap (MSB first per
  byte, 16 B aligned), then the float archive of the nonzero floats in
  order. A float is nonzero when any of its bits is set.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import torch

BLOCK = 4096
LANES = 32
STEPS = BLOCK // LANES
STATE_MIN = 1 << 15
META_WORDS = 8 + 128
MAX_BLOCK_U16 = 2 * 1280
ANS_ROWS = 0xDB0D0001
ANS_CLASSIC = 0xD00D0001
FLOAT_V1 = 0xF00F0001
FLOAT_V2 = 0xF00F0002
V2_MIN_FLOATS = 1 << 20
M32 = 0xFFFFFFFF

TYPE_CODE = {torch.float16: 1, torch.bfloat16: 2, torch.float32: 3,
             torch.float64: 4}
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


class Faults:
    """Counts of the format checks that failed, by name."""

    def __init__(self):
        self.counts: Dict[str, int] = collections.Counter()

    def check(self, ok, what: str) -> None:
        bad = int((~ok).sum()) if isinstance(ok, torch.Tensor) else int(not ok)
        if bad:
            self.counts[what] += bad

    @property
    def total(self) -> int:
        return sum(self.counts.values())


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & M32


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _up(a: int, b: int) -> int:
    return _ceil(a, b) * b


def float_bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as int64, zero-extended."""
    ws = t.element_size()
    b = t.contiguous().reshape(-1).view(_BITS[ws]).to(torch.int64)
    return b if ws == 8 else b & ((1 << (8 * ws)) - 1)


def xor_bytes(t: torch.Tensor) -> int:
    """XOR of every byte of t."""
    u8 = t.contiguous().reshape(-1).view(torch.uint8)
    w = torch.nn.functional.pad(u8, (0, -u8.numel() % 8)).view(torch.int64)
    while w.numel() > 1:
        if w.numel() % 2:
            w = torch.nn.functional.pad(w, (0, 1))
        w = w[0::2] ^ w[1::2]
    v = int(w[0]) if w.numel() else 0
    out = 0
    for k in range(8):
        out ^= (v >> (8 * k)) & 0xFF
    return out


# ---------------------------------------------------------------------------
# ANS archives
# ---------------------------------------------------------------------------


class _Archive:
    """Where one ANS archive's parts lie, as the format fixes them."""

    def __init__(self, base: int, n: int):
        self.base, self.n = base, n
        self.nb = max(1, _ceil(n, BLOCK)) if n else 0
        self.bw_off = META_WORDS + 32 * self.nb
        self.data_off = self.bw_off + 2 * _up(self.nb, 2)
        self.nbytes = 0


def _parse_ans(flat: torch.Tensor, archives: Sequence[_Archive], prob_bits: int,
               flags: int, faults: Faults):
    """Check every archive's header, table and block pairs. Returns the
    layout, the decode tables int64[A, 2^prob_bits] (symbol | pdf << 8 |
    cdf << 20) and each archive's per-block coded u16 words (a list of
    int64 tensors); sets each archive's byte size."""
    dev = flat.device
    hdr_idx = torch.tensor([[a.base + k for k in range(8)] for a in archives],
                           dtype=torch.int64, device=dev)
    hdrs = _u32(flat[hdr_idx.clamp(0, flat.numel() - 1)]).tolist()
    magics = {h[0] for h in hdrs}
    faults.check(magics <= {ANS_ROWS, ANS_CLASSIC} and len(magics) == 1,
                 "ans_magic")
    rows = hdrs[0][0] != ANS_CLASSIC
    words = []
    for a, h in zip(archives, hdrs):
        faults.check(h[1] == a.nb, "ans_blocks")
        faults.check(h[2] == a.n, "ans_symbols")
        faults.check(h[4] == flags, "ans_flags")
        faults.check(h[5] == 0 and h[6] == 0 and h[7] == 0, "ans_reserved")
        k = torch.arange(2 * _up(a.nb, 2), dtype=torch.int64, device=dev)
        bw = _u32(flat[(a.base + a.bw_off + k).clamp(0, flat.numel() - 1)])
        bx, by = bw[0::2], bw[1::2]
        blk = torch.arange(bx.numel(), dtype=torch.int64, device=dev)
        uw = (a.n - BLOCK * blk).clamp(0, BLOCK) * (blk < a.nb)
        faults.check((bx >> 16) == uw, "ans_block_bytes")
        cw = bx & 0xFFFF
        faults.check((cw <= MAX_BLOCK_U16) & ((blk < a.nb) | (cw == 0)),
                     "ans_block_words")
        g = 4 if rows else 1
        seg = torch.nn.functional.pad(cw, (0, -cw.numel() % g)).reshape(-1, g).sum(1)
        aligned = (seg + 7) // 8 * 8
        start = torch.cumsum(aligned, 0) - aligned
        want_y = start.repeat_interleave(g)[: by.numel()] * (blk < a.nb)
        faults.check(by == want_y, "ans_block_offsets")
        total = int(aligned.sum())
        faults.check(h[3] == total, "ans_stream_words")
        a.nbytes = 4 * a.data_off + 2 * total
        words.append(cw[: a.nb])
    pw = _u32(flat[torch.stack([a.base + 8 + torch.arange(128, device=dev)
                                for a in archives]).clamp(0, flat.numel() - 1)])
    pdf = torch.stack([pw & 0xFFFF, pw >> 16], dim=2).reshape(len(archives), 256)
    faults.check(pdf.sum(1) == (1 << prob_bits), "ans_probabilities")
    cdf = torch.cumsum(pdf, 1)
    slots = torch.arange(1 << prob_bits, dtype=torch.int64, device=dev)
    sym = torch.searchsorted(cdf, slots.expand(len(archives), -1).contiguous(),
                             right=True).clamp(max=255)
    lut = sym | (torch.gather(pdf, 1, sym) << 8) | (torch.gather(cdf - pdf, 1, sym) << 20)
    return rows, lut, words


def decode_ans(flat: torch.Tensor, archives: Sequence[_Archive], prob_bits: int,
               flags: int, faults: Faults) -> List[torch.Tensor]:
    """Decode ANS archives at word offsets of flat (the u32 words of the
    archives' matrix, int32) into their symbols, uint8[n] each, checking
    that every stream is read exactly to its start and every state ends
    where the coder starts."""
    dev = flat.device
    rows, lut, cwords = _parse_ans(flat, archives, prob_bits, flags, faults)
    g = 4 if rows else 1
    starts, lens, uws, states, tabs = [], [], [], [], []
    for i, (a, cw) in enumerate(zip(archives, cwords)):
        nr = _ceil(a.nb, g)
        cwp = torch.nn.functional.pad(cw, (0, nr * g - a.nb)).reshape(nr, g)
        seg = cwp.sum(1)
        aligned = (seg + 7) // 8 * 8
        starts.append(2 * (a.base + a.data_off) + torch.cumsum(aligned, 0) - aligned)
        lens.append(seg)
        blk = torch.arange(nr * g, dtype=torch.int64, device=dev)
        uws.append((a.n - BLOCK * blk).clamp(0, BLOCK).reshape(nr, g))
        k = torch.arange(32 * nr * g, dtype=torch.int64, device=dev)
        st = _u32(flat[(a.base + META_WORDS + k).clamp(0, flat.numel() - 1)])
        states.append(torch.where(k < 32 * a.nb, st, STATE_MIN).reshape(nr, g * LANES))
        tabs.append(torch.full((nr,), i << prob_bits, dtype=torch.int64, device=dev))
    start, ptr = torch.cat(starts), torch.cat(lens)
    uw, st, tab = torch.cat(uws), torch.cat(states), torch.cat(tabs)[:, None]
    R = st.shape[0]
    lut_flat = lut.reshape(-1)
    lane = torch.arange(LANES, dtype=torch.int64, device=dev)
    mask = (1 << prob_bits) - 1
    syms = torch.empty((STEPS, R, g * LANES), dtype=torch.uint8, device=dev)
    under = torch.zeros(R, dtype=torch.bool, device=dev)
    last = flat.numel() - 1
    for s in reversed(range(STEPS)):
        valid = ((LANES * s + lane)[None, None, :] < uw[:, :, None]).reshape(R, -1)
        slot = st & mask
        ent = lut_flat[tab + slot]
        syms[s] = (ent & 0xFF).to(torch.uint8)
        st = torch.where(valid, ((ent >> 8) & 0xFFF) * (st >> prob_bits) + slot
                         - (ent >> 20), st)
        read = valid & (st < STATE_MIN)
        # the step's words lie blocks then lanes ascending: read backwards
        idx = ptr[:, None] - read.flip(1).cumsum(1).flip(1)
        under |= (read & (idx < 0)).any(1)
        pos = start[:, None] + idx.clamp(min=0)
        w = _u32(flat[(pos >> 1).clamp(0, last)])
        st = torch.where(read, (st << 16) | ((w >> (16 * (pos & 1))) & 0xFFFF), st)
        ptr = ptr - read.sum(1)
    faults.check(~under, "ans_stream_overrun")
    faults.check(ptr == 0, "ans_stream_unread")
    faults.check(st == STATE_MIN, "ans_final_state")
    by_pos = syms.reshape(STEPS, R, g, LANES).permute(1, 2, 0, 3).reshape(-1)
    out, r0 = [], 0
    for a in archives:
        nr = _ceil(a.nb, g)
        out.append(by_pos[r0 * g * BLOCK: r0 * g * BLOCK + a.n])
        r0 += nr
    return out


# ---------------------------------------------------------------------------
# Float and sparse archives
# ---------------------------------------------------------------------------


def _sections(n: int, ws: int) -> Tuple[int, int]:
    """u32 words of the two raw sections of n floats of ws bytes."""
    if ws == 2:
        return _up(n, 16) // 4, 0
    if ws == 4:
        return _up(n, 8) // 2, _up(n, 16) // 4
    return _up(n, 4), _up(n, 8) // 2


def _join(ws: int, bf16: bool, planes, sec1: torch.Tensor, sec2: torch.Tensor):
    """The floats' bits (int64) from their exponent planes and sections."""
    if ws == 2:
        v = (planes[0] << 8) | sec1
        return (((v >> 1) | (v << 15)) & 0xFFFF) if bf16 else v
    if ws == 4:
        v = (planes[0] << 24) | (sec2 << 16) | sec1
        return ((v >> 1) | (v << 31)) & M32
    v = (planes[0] << 56) | (planes[1] << 48) | (sec2 << 32) | sec1
    return ((v >> 1) & 0x7FFFFFFFFFFFFFFF) | (v << 63)


def _section(u8: torch.Tensor, byte_off: int, n: int, width: int) -> torch.Tensor:
    """n little-endian unsigned values of width bytes from byte_off."""
    end = min(byte_off + n * width, u8.numel())
    raw = torch.nn.functional.pad(u8[byte_off:end], (0, byte_off + n * width - end))
    if width == 1:
        return raw.to(torch.int64)
    return raw.view(_BITS[width]).to(torch.int64) & ((1 << (8 * width)) - 1)


def check_float_archives(comp: torch.Tensor, bases: Sequence[int],
                         members: Sequence[torch.Tensor], prob_bits: int,
                         checksum: bool, faults: Faults):
    """Check float archives at word offsets ``bases`` of the flattened
    archive matrix against the floats each must hold. Returns (floats
    whose decoded bits differ from the member's, each archive's end as a
    word offset)."""
    dev = comp.device
    u8 = comp.contiguous().reshape(-1)
    flat = u8.view(torch.int32)
    dtype = members[0].dtype
    ws = members[0].element_size()
    planes_n = 2 if ws == 8 else 1
    hdr_idx = torch.tensor([[b + k for k in range(8)] for b in bases],
                           dtype=torch.int64, device=dev)
    hdrs = _u32(flat[hdr_idx.clamp(0, flat.numel() - 1)]).tolist()
    archives, secs = [], []
    for b, h, t in zip(bases, hdrs, members):
        n = t.numel()
        faults.check(h[0] in (FLOAT_V1, FLOAT_V2), "float_magic")
        faults.check(h[1] == n, "float_count")
        faults.check(h[2] == TYPE_CODE[dtype] | (int(checksum) << 4), "float_type")
        faults.check(h[3] == (xor_bytes(t) if checksum else 0), "float_checksum")
        faults.check(h[5] == 0 and h[6] == 0 and h[7] == 0, "float_reserved")
        v2 = h[0] == FLOAT_V2
        s1w, s2w = _sections(n, ws)
        o1 = 128 if v2 else 8
        o2 = o1 + (_up(s1w, 128) if v2 else s1w)
        o3 = o2 + (_up(s2w, 128) if v2 else s2w)
        secs.append((b + o1, b + o2))
        archives.append(_Archive(b + o3, n))
        if planes_n == 2:
            faults.check(h[4] % 4 == 0 and h[4] > 0, "float_plane_offset")
            archives.append(_Archive(b + o3 + h[4] // 4, n))
        else:
            faults.check(h[4] == 0, "float_plane_offset")
    decoded = decode_ans(flat, archives, prob_bits, prob_bits, faults)
    rows = _u32(flat[archives[0].base]).item() == ANS_ROWS
    mismatch, ends = 0, []
    for i, (b, t, (p1, p2)) in enumerate(zip(bases, members, secs)):
        n = t.numel()
        arch = archives[planes_n * i: planes_n * (i + 1)]
        faults.check(hdrs[i][0] == (FLOAT_V2 if rows and n >= V2_MIN_FLOATS else FLOAT_V1),
                     "float_version")
        if planes_n == 2:
            faults.check(hdrs[i][4] == arch[0].nbytes, "float_plane_offset")
        planes = [d.to(torch.int64) for d in decoded[planes_n * i: planes_n * (i + 1)]]
        if ws == 2:
            sec1, sec2 = _section(u8, 4 * p1, n, 1), None
        elif ws == 4:
            sec1, sec2 = _section(u8, 4 * p1, n, 2), _section(u8, 4 * p2, n, 1)
        else:
            sec1, sec2 = _section(u8, 4 * p1, n, 4), _section(u8, 4 * p2, n, 2)
        got = _join(ws, dtype == torch.bfloat16, planes, sec1, sec2)
        mismatch += int((got != float_bits(t)).sum())
        ends.append(arch[-1].base + _ceil(arch[-1].nbytes, 4))
    return mismatch, ends


def nonzero_bitmap(t: torch.Tensor) -> torch.Tensor:
    """The sparse bitmap's bytes of a member: uint8[ceil(n / 8)]."""
    nz = (float_bits(t) != 0).to(torch.int64)
    nz = torch.nn.functional.pad(nz, (0, -nz.numel() % 8)).reshape(-1, 8)
    weights = 1 << torch.arange(7, -1, -1, device=t.device)
    return (nz * weights).sum(1).to(torch.uint8)


def check_batch(comp: torch.Tensor, comp_bytes: Sequence[int],
                members: Sequence[torch.Tensor], prob_bits: int,
                checksum: bool, sparse: bool, faults: Faults) -> int:
    """Check the archive matrix that a compress of ``members`` returned
    (uint8[B, C], each archive in its row, zero past its comp_bytes).
    Returns the floats whose decode from the archive differs from the
    member; counts every broken format rule in faults."""
    B, C = comp.shape
    faults.check(B == len(members) and C % 4 == 0, "archive_matrix")
    if B != len(members) or C % 4:
        return sum(t.numel() for t in members)
    CW = C // 4
    if not sparse:
        mismatch, ends = check_float_archives(
            comp, [b * CW for b in range(B)], members, prob_bits, checksum, faults)
    else:
        flat = comp.reshape(-1).view(torch.int32)
        heads = _u32(flat[torch.tensor([[b * CW + k for k in range(4)] for b in range(B)],
                                       device=comp.device)]).tolist()
        bases, dense = [], []
        for b, (h, t) in enumerate(zip(heads, members)):
            n = t.numel()
            faults.check(h[0] == n and h[1:] == [0, 0, 0], "sparse_header")
            bmw = _up(_ceil(n, 8), 16) // 4
            want = torch.nn.functional.pad(nonzero_bitmap(t), (0, 4 * bmw - _ceil(n, 8)))
            got = comp[b, 16: 16 + 4 * bmw]
            faults.check(got.numel() == want.numel() and bool(torch.equal(got, want)),
                         "sparse_bitmap")
            bases.append(b * CW + 4 + bmw)
            dense.append(t[float_bits(t) != 0])
        mismatch, ends = check_float_archives(
            comp, bases, dense, prob_bits, checksum, faults)
    for b, (end, cb) in enumerate(zip(ends, comp_bytes)):
        faults.check(4 * (end - b * CW) == cb, "archive_size")
        faults.check(not bool(comp[b, cb:].any()), "archive_padding")
    return mismatch
