"""16-bit float codec (fp16, bf16) over row-stream ANS: compress and
decompress of u32-packed float rows.

A port of the JAX package's ``models/float_codec.py`` for fp16/bf16 with
``native=True``:

* compress: K1 split + histogram + checksum -> table build -> K2 rANS
  encode into row streams -> one K3 merge placing the float header, the raw
  section and the ANS archive's runs into each member's archive row;
* decompress: float header parse -> K3 stages the raw section block-major
  -> ANS parse, validation and two K3 staging merges -> K4 decodes and
  joins into float words (the JAX package's fused 16-bit branch).

Archive layout per member (u32 words): float header (8), raw section
(round_up(n, 16) bytes), ANS archive. Members with n >= FLOAT_ALIGN_MIN use
the v2 container: the raw section starts at word 128 and is padded to 128
words. fp32, fp64, the classic 0xD00D layout and the decode-side checksum
are not in this port yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.constants import (
    BLOCK_SIZE,
    DEFAULT_PROB_BITS,
    FLOAT_ALIGN_MIN,
    FLOAT_MAGIC,
    FLOAT_SECTION_ALIGN_BYTES,
    FLOAT_VERSION,
    FLOAT_VERSION_ALIGNED,
    FloatType,
    MAX_BLOCK_WORDS32,
    max_compressed_size,
    max_float_compressed_size,
)
from ..ops.bitops import from_u32, to_i32, to_u32
from ..ops.float_split import split16_hist, split16_hist_plain
from ..ops.merge import runs_merge, runs_merge_plain
from .ans import (
    META_WORDS,
    SRC_META,
    SRC_PAIRS,
    SRC_STREAMS,
    ans_decode_join16_core,
    ans_encode_sections,
)

FLOAT_MAGIC_VERSION = (FLOAT_MAGIC << 16) | FLOAT_VERSION
FLOAT_MAGIC_VERSION2 = (FLOAT_MAGIC << 16) | FLOAT_VERSION_ALIGNED
_FLOAT16_TYPES = (FloatType.FLOAT16, FloatType.BFLOAT16)
# merge sources of the compress-side archive merge, after the ANS ones
_SRC_HDR, _SRC_RAW = 3, 4


def _align_section(words):
    """v2 containers start each raw section on a 512 B boundary."""
    a = FLOAT_SECTION_ALIGN_BYTES // 4
    return (words + a - 1) // a * a


def _raw_words(n):
    """u32 words of a 16-bit member's raw section (round_up(n, 16) bytes)."""
    return (n + 15) // 16 * 4


def _check_type(float_type, native: bool) -> FloatType:
    ft = FloatType(float_type)
    if ft not in _FLOAT16_TYPES:
        raise NotImplementedError(f"{ft.name} is not in the port yet")
    if not native:
        raise NotImplementedError("the classic 0xD00D layout is not in the port yet")
    return ft


def archive_row_words(W32: int) -> int:
    """Archive row width CWf (u32 words) for inputs of W32 words (even),
    the JAX package's ``float_codec.py:176-192``."""
    S_cap = 2 * W32
    NBp = max(1, -(-S_cap // BLOCK_SIZE))
    ans_tight = min(
        max_compressed_size(S_cap),
        -(-(4 * META_WORDS + 128 * NBp + 8 * ((NBp + 1) // 2 * 2)
            + 4 * MAX_BLOCK_WORDS32 * NBp) // 16) * 16,
    )
    tight = 4 * (8 + _raw_words(S_cap) + 3 * 128) + ans_tight
    CWf = min(max_float_compressed_size(FloatType.BFLOAT16, S_cap), tight) // 4
    return -(-CWf // 128) * 128


def float_compress_core(
    data32: torch.Tensor,
    n: torch.Tensor,
    float_type: FloatType,
    prob_bits: int = DEFAULT_PROB_BITS,
    use_checksum: bool = False,
    native: bool = True,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress u32-packed 16-bit float rows.

    data32: int32[B, W32] packed float words (u32 bits); n: int[B] float
    counts (n[b] <= 2 * W32). Returns (out32 int32[B, CWf], the archives,
    zero past comp_bytes; comp_bytes int64[B]). plain=True runs every
    kernel's plain PyTorch version wherever the tensors lie (to hold the
    kernels against them on the card).
    """
    ft = _check_type(float_type, native)
    bf16 = ft == FloatType.BFLOAT16
    dev = data32.device
    if data32.shape[1] % 2:
        data32 = F.pad(data32, (0, 1))
    data32 = data32.contiguous()
    B, W32 = data32.shape
    S_cap = 2 * W32
    n64 = n.to(device=dev, dtype=torch.int64)
    if bool(((n64 < 0) | (n64 > S_cap)).any()):
        raise ValueError(f"float counts must lie in [0, {S_cap}]")
    n32 = n64.to(torch.int32)

    split = split16_hist_plain if plain else split16_hist
    exp, raw, hist, csum_f = split(data32, n32, bf16)
    # a member's raw section is round_up(n, 16) bytes: give every raw row a
    # 16 B multiple of zero-padded width so no run reads into the next row
    if raw.shape[1] % 4:
        raw = F.pad(raw, (0, 4 - raw.shape[1] % 4))
    csum = to_u32(csum_f) if use_checksum else torch.zeros_like(n64)

    seg = ans_encode_sections(exp, n32, hist, prob_bits, S_cap, plain=plain)

    s1w = _raw_words(n64)
    is_al = n64 >= FLOAT_ALIGN_MIN
    o_s1 = torch.where(is_al, 128, 8)
    o2 = o_s1 + torch.where(is_al, _align_section(s1w), s1w)
    end = o2 + (seg.comp_bytes >> 2)

    zeros = torch.zeros_like(n64)
    hdr = torch.stack(
        [torch.where(is_al, FLOAT_MAGIC_VERSION2, FLOAT_MAGIC_VERSION), n64,
         zeros + (int(ft) | (int(use_checksum) << 4)), csum, zeros, zeros,
         zeros, zeros],
        dim=1,
    )

    # one merge places every member's header, raw section and ANS runs, in
    # destination order within each member's archive row; the ANS runs
    # index the first three sources
    srcs = [None] * 5
    srcs[SRC_META] = seg.meta.reshape(-1)
    srcs[SRC_PAIRS] = seg.pairs.reshape(-1)
    srcs[SRC_STREAMS] = seg.streams.reshape(-1)
    srcs[_SRC_HDR] = from_u32(hdr).reshape(-1)
    srcs[_SRC_RAW] = raw.reshape(-1)
    CWf = archive_row_words(W32)
    b_ar = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    dst = torch.cat([zeros[:, None], o_s1[:, None], o2[:, None] + seg.dst], dim=1)
    hdr_raw = torch.tensor([_SRC_HDR, _SRC_RAW], dtype=torch.int32, device=dev)
    ref = torch.cat([hdr_raw.expand(B, 2), seg.src_ref], dim=1)
    off = torch.cat([b_ar * 8, b_ar * raw.shape[1], seg.src_off], dim=1)
    lens = torch.cat([zeros[:, None] + 8, s1w[:, None], seg.lens], dim=1)
    merge = runs_merge_plain if plain else runs_merge
    out = merge(
        srcs, (dst + b_ar * CWf).reshape(-1), ref.reshape(-1), off.reshape(-1),
        lens.reshape(-1), B * CWf,
    ).reshape(B, CWf)
    return out, 4 * end


def float_decompress_core(
    comp32: torch.Tensor,
    base32: torch.Tensor,
    out_floats: int,
    float_type: FloatType,
    prob_bits: int = DEFAULT_PROB_BITS,
    capacities: Optional[torch.Tensor] = None,
    verify_checksum: bool = False,
    native: bool = True,
    plain: bool = False,
):
    """Decompress 16-bit float archives at per-member word offsets base32
    of comp32's rows (int32[B, CW]).

    Returns (words32 int32[B, ceil(out_floats / 2)], zero past n and for
    failed members; success bool[B]; n int64[B]; the archive's checksum
    int64[B]; the computed checksum, zeros). A member fails, raising
    nothing, on a wrong header, a failed ANS validation, or n above its
    capacity (default out_floats). plain=True as in float_compress_core.
    """
    ft = _check_type(float_type, native)
    if verify_checksum:
        raise NotImplementedError("verify_checksum is not in the port yet")
    dev = comp32.device
    comp32 = comp32.contiguous()
    B, CW = comp32.shape
    base = base32.to(device=dev, dtype=torch.int64)

    idx = (base[:, None] + torch.arange(8, dtype=torch.int64, device=dev)).clamp(0, CW - 1)
    hdr = to_u32(torch.gather(comp32, 1, idx))
    n = to_i32(hdr[:, 1])
    csum_arch = hdr[:, 3]
    is_al = hdr[:, 0] == FLOAT_MAGIC_VERSION2
    valid = (
        ((hdr[:, 0] == FLOAT_MAGIC_VERSION) | is_al)
        & ((hdr[:, 2] & 0xF) == int(ft))
        & (n >= 0)
    )
    n = torch.where(valid, n, 0)
    is_al = is_al & valid
    if capacities is None:
        capacities = torch.full((B,), out_floats, dtype=torch.int64, device=dev)
    success = valid & (n <= capacities.to(device=dev, dtype=torch.int64))

    s1w = _raw_words(n)
    o_s1 = torch.where(is_al, 128, 8)
    ans_base = base + o_s1 + torch.where(is_al, _align_section(s1w), s1w)

    # raw section staged block-major: 1024 words per 4096-float block
    NB = max(1, -(-out_floats // BLOCK_SIZE))
    b_ar = torch.arange(B, dtype=torch.int64, device=dev)
    merge = runs_merge_plain if plain else runs_merge
    raw32 = merge(
        [comp32.reshape(-1)],
        b_ar * (NB * 1024),
        torch.zeros(B, dtype=torch.int32, device=dev),
        b_ar * CW + base + o_s1,
        s1w.clamp(max=NB * 1024),
        B * NB * 1024,
    ).reshape(B, NB, 1024)

    words32, ok, psize, _ = ans_decode_join16_core(
        comp32, ans_base, raw32, out_floats, prob_bits,
        ft == FloatType.BFLOAT16, capacities, plain=plain,
    )
    success = success & ok & (psize == n)
    words32 = torch.where(success[:, None], words32, 0)
    return words32, success, n, csum_arch, torch.zeros_like(n)
