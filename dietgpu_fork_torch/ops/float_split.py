"""Float split and join, with the split's byte histograms and XOR
checksum: kernels K1 (16-bit split), K5 (fp32/fp64 split), K7 (fp32/fp64
join), K13 (16-bit join) and their plain versions.

Layouts (little-endian bytes within each u32 word, as in the archive and
in the JAX package's portable ``ops/float_split.py:16-23, 80-115``):

* fp16/bf16: exponent plane = the high byte of each float (bf16 after a
  rotate-left by 1 within 16 bits, which moves the sign into the raw
  byte), 4 floats per word; raw section = the low byte, 4 per word.
* fp32, after a rotate-left by 1 of each word: exponent plane = the top
  byte, 4 floats per word; sec1 = the low 16 bits, 2 floats per word;
  sec2 = the third byte, 4 floats per word.
* fp64, a (lo, hi) u32 pair per float, rotated left by 1 across the pair:
  exp0 = the top byte of v_hi, exp1 = the next byte, each 4 floats per
  word; sec1 = v_lo, one word per float; sec2 = the low 16 bits of v_hi,
  2 floats per word.

Raw-section bytes at or past a member's count are zeroed by the split
with histogram; ``split_packed`` (the split alone, K1 and K5 without
histogram: the JAX package's ``split_packed``) keeps them, capacity-sized.

``split16_hist``, ``split_wide_hist``, ``split16``, ``split_wide``,
``join_wide``, ``join_wide_at``, ``join16_rows`` and ``join16_at`` send
CUDA tensors to the kernels (``csrc/split16_hist.cu``,
``csrc/split_wide_hist.cu``, ``csrc/join_wide.cu``) and CPU tensors to
their plain versions, built from the JAX package's ``split_packed`` +
``histogram_packed`` + ``checksum_packed`` + ``mask_packed_bytes``, and
``join_packed``. ``join_wide`` and ``join16_rows`` take the raw sections
as tensors; ``join_wide_at`` and ``join16_at`` (the archive modes of K7
and K13, the two-pass decodes) read them from the archive in place and
join only the floats below a per-member count.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.config import use_kernels
from ..core.constants import FLOAT_WORD_SIZE, FloatType
from ..runtime import cuda_kernels as K
from .bitops import M32, from_u32, to_u32
from .checksum import checksum_packed, mask_packed_bytes
from .histogram import byte_hist_plain


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


def pack_bytes(by: torch.Tensor) -> torch.Tensor:
    """Bytes (int64) [..., 4W] -> u32 words (int64 carriers) [..., W]."""
    return _pack4(*by.unflatten(-1, (-1, 4)).unbind(-1))


def _halves(x: torch.Tensor) -> torch.Tensor:
    """u32 words (int64) [..., W] -> their 16-bit halves [..., 2W], low
    half first."""
    return torch.stack([x & 0xFFFF, x >> 16], dim=-1).flatten(-2)


def _hist(x: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """int32[B, 256] histogram of the first nbytes[b] bytes of u32 rows
    (int64 carriers), by K8's plain version."""
    return byte_hist_plain(from_u32(x).view(torch.uint8), nbytes)[0]


def _check_split_args(data32, n, row_mult: int = 2):
    """row_mult: the words of one group of 4 floats (one exponent-plane
    word), which is the float's byte width."""
    _check_rows(data32, row_mult)
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
    exp, raw = _split16(x, bf16)
    n64 = n.to(torch.int64)
    raw = mask_packed_bytes(raw, n64)
    hist = _hist(exp, n64)
    csum = checksum_packed(x, 2 * n64)
    return from_u32(exp), from_u32(raw), hist, csum.to(torch.int32)


def _split16(x, bf16: bool):
    """u32 rows (int64) -> (exponent plane, raw section), int64 words."""
    r = _rotl16x2(x) if bf16 else x
    we, wo = r[:, 0::2], r[:, 1::2]
    exp = _pack4((we >> 8) & 0xFF, we >> 24, (wo >> 8) & 0xFF, wo >> 24)
    raw = _pack4(we & 0xFF, (we >> 16) & 0xFF, wo & 0xFF, (wo >> 16) & 0xFF)
    return exp, raw


def _check_rows(data32, row_mult: int):
    if data32.dtype != torch.int32 or data32.dim() != 2:
        raise TypeError("data32 must be a 2-D torch.int32 tensor of u32 words")
    if not data32.is_contiguous():
        raise ValueError("data32 must be contiguous")
    if data32.shape[1] % row_mult:
        raise ValueError(
            f"data32 needs a row width that is a multiple of {row_mult}, "
            f"got {data32.shape[1]}")


def split16(data32: torch.Tensor, bf16: bool):
    """Split u32-packed 16-bit float rows, capacity-sized: data32
    int32[B, W32] (W32 even) -> (exp, raw), each int32[B, W32/2]. No
    histogram, checksum or tail mask."""
    _check_rows(data32, 2)
    if use_kernels(data32):
        return K.split16(data32, bf16)
    return split16_plain(data32, bf16)


def split16_plain(data32, bf16: bool):
    """Plain PyTorch version of K1 without histogram; runs on any device."""
    _check_rows(data32, 2)
    return tuple(from_u32(t) for t in _split16(to_u32(data32), bf16))


def join16(exp_bytes: torch.Tensor, raw_bytes: torch.Tensor, bf16: bool):
    """Join exponent and raw bytes (int64, same shape [..., 2m]) into u32
    words (int64) [..., m] holding two 16-bit floats each: the inverse of
    the split (float_split.py:193-202)."""
    v = raw_bytes | (exp_bytes << 8)
    w = v[..., 0::2] | (v[..., 1::2] << 16)
    return _rotr16x2(w) if bf16 else w


def _wide_type(float_type) -> FloatType:
    ft = FloatType(float_type)
    if ft not in (FloatType.FLOAT32, FloatType.FLOAT64):
        raise ValueError(f"{ft.name} is not fp32 or fp64")
    return ft


def split_wide_hist(data32: torch.Tensor, n: torch.Tensor, float_type):
    """Split u32-packed fp32 or fp64 rows.

    data32: int32[B, W32] (W32 % 4 == 0 for fp32, % 8 for fp64; fp64 floats
    are (lo, hi) word pairs); n: int32[B] float counts. Returns
    (exp int32[P*B, E], plane p of member b in row p*B + b, with P = 1 and
    E = W32/4 for fp32, P = 2 and E = W32/8 for fp64; sec1 int32[B, W32/2];
    sec2 int32[B, W32/4], both zero at bytes past the member's count; hist
    int32[P*B, 256] over the first n bytes of each plane; csum int32[B],
    the XOR of the first n*ws input bytes).
    """
    ft = _wide_type(float_type)
    _check_split_args(data32, n, FLOAT_WORD_SIZE[ft])
    if use_kernels(data32):
        return K.split_wide_hist(data32, n, ft)
    return split_wide_hist_plain(data32, n, ft)


def split_wide_hist_plain(data32, n, float_type):
    """Plain PyTorch version of K5; runs on any device."""
    ft = _wide_type(float_type)
    _check_split_args(data32, n, FLOAT_WORD_SIZE[ft])
    x = to_u32(data32)
    n64 = n.to(torch.int64)
    planes, sec1, sec2 = _split_wide(x, ft)
    nb1, nb2 = (2 * n64, n64) if ft == FloatType.FLOAT32 else (4 * n64, 2 * n64)
    hist = torch.cat([_hist(p, n64) for p in planes])
    csum = checksum_packed(x, FLOAT_WORD_SIZE[ft] * n64)
    return (
        from_u32(torch.cat(planes)),
        from_u32(mask_packed_bytes(sec1, nb1)),
        from_u32(mask_packed_bytes(sec2, nb2)),
        hist,
        csum.to(torch.int32),
    )


def _split_wide(x, ft: FloatType):
    """u32 rows (int64) -> (planes, sec1, sec2), int64 words."""
    if ft == FloatType.FLOAT32:
        r = ((x << 1) | (x >> 31)) & M32
        w = [r[:, k::4] for k in range(4)]
        planes = [_pack4(*(wk >> 24 for wk in w))]
        sec1 = (r[:, 0::2] & 0xFFFF) | ((r[:, 1::2] & 0xFFFF) << 16)
        sec2 = _pack4(*(_b(wk, 2) for wk in w))
        return planes, sec1, sec2
    lo, hi = x[:, 0::2], x[:, 1::2]
    v_hi = ((hi << 1) | (lo >> 31)) & M32
    v_lo = ((lo << 1) | (hi >> 31)) & M32
    h = [v_hi[:, k::4] for k in range(4)]
    planes = [_pack4(*(hk >> 24 for hk in h)),
              _pack4(*(_b(hk, 2) for hk in h))]
    sec2 = (v_hi[:, 0::2] & 0xFFFF) | ((v_hi[:, 1::2] & 0xFFFF) << 16)
    return planes, v_lo, sec2


def split_wide(data32: torch.Tensor, float_type):
    """Split u32-packed fp32 or fp64 rows, capacity-sized: data32 as
    ``split_wide_hist`` -> (exp int32[P*B, E], sec1, sec2) as there, with
    no histogram, checksum or tail mask."""
    ft = _wide_type(float_type)
    _check_rows(data32, FLOAT_WORD_SIZE[ft])
    if use_kernels(data32):
        return K.split_wide(data32, ft)
    return split_wide_plain(data32, ft)


def split_wide_plain(data32, float_type):
    """Plain PyTorch version of K5 without histograms; runs on any device."""
    ft = _wide_type(float_type)
    _check_rows(data32, FLOAT_WORD_SIZE[ft])
    planes, sec1, sec2 = _split_wide(to_u32(data32), ft)
    return from_u32(torch.cat(planes)), from_u32(sec1), from_u32(sec2)


def _split_packed(data32, float_type, s16, swide):
    ft = FloatType(float_type)
    if ft in (FloatType.FLOAT16, FloatType.BFLOAT16):
        exp, raw = s16(data32, ft == FloatType.BFLOAT16)
        return [exp], [raw]
    exp, sec1, sec2 = swide(data32, ft)
    P = 2 if ft == FloatType.FLOAT64 else 1
    return list(exp.reshape(P, data32.shape[0], exp.shape[1])), [sec1, sec2]


def split_packed(data32: torch.Tensor, float_type):
    """Split u32-packed float rows into (exponent planes, raw sections), the
    JAX package's ``split_packed``: capacity-sized, with content past a
    member's count kept (callers mask or ignore it). data32: int32[B, W32]
    with W32 % 2 == 0 (fp16, bf16), % 4 (fp32) or % 8 (fp64). Planes:
    [exp] or, for fp64, [exp0, exp1], each int32[B, W32 / (2 word size)];
    sections: [raw] int32[B, W32/2] for 16-bit types, [sec1 int32[B, W32/2],
    sec2 int32[B, W32/4]] for fp32 and fp64."""
    return _split_packed(data32, float_type, split16, split_wide)


def split_packed_plain(data32, float_type):
    """``split_packed`` by the plain versions; runs on any device."""
    return _split_packed(data32, float_type, split16_plain, split_wide_plain)


def _check_join16_args(exp, raw):
    for name, t in (("exp", exp), ("raw", raw)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D torch.int32 tensor")
        if t.stride(1) != 1:
            raise ValueError(f"{name} rows must be contiguous")
    B, E = exp.shape
    if raw.shape[0] != B or raw.shape[1] < E:
        raise ValueError(f"raw needs shape [{B}, >= {E}], got {tuple(raw.shape)}")
    if raw.device != exp.device:
        raise ValueError("exp and raw must lie on one device")


def join16_rows(exp: torch.Tensor, raw: torch.Tensor, bf16: bool):
    """Join 16-bit exponent planes and raw sections into float words, the
    inverse of ``split16``: exp int32[B, E], raw int32 rows of at least E
    words (only the first E read; rows need contiguous words, not contiguous
    tensors) -> int32[B, 2E]."""
    _check_join16_args(exp, raw)
    if use_kernels(exp):
        return K.join16_rows(exp, raw, bf16)
    return join16_rows_plain(exp, raw, bf16)


def join16_rows_plain(exp, raw, bf16: bool):
    """Plain PyTorch version of K13; runs on any device."""
    _check_join16_args(exp, raw)
    E = exp.shape[1]
    return from_u32(join16(unpack_bytes(to_u32(exp)),
                           unpack_bytes(to_u32(raw[:, :E])), bf16))


def _check_join16_at_args(comp32, plane, r_off, count, float_type):
    ft = FloatType(float_type)
    if ft not in (FloatType.FLOAT16, FloatType.BFLOAT16):
        raise ValueError(f"{ft.name} is not a 16-bit float type")
    if comp32.dtype != torch.int32 or comp32.dim() != 2 or not comp32.is_contiguous():
        raise TypeError("comp32 must be a contiguous 2-D torch.int32 tensor")
    if comp32.numel() == 0:
        raise ValueError("comp32 must not be empty")
    if plane.dtype != torch.int32 or plane.dim() != 2 or plane.stride(1) != 1:
        raise TypeError("plane must be a 2-D torch.int32 tensor with contiguous rows")
    B, E = plane.shape
    if E == 0:
        raise ValueError("the exponent plane must not be empty")
    for name, t in (("r_off", r_off), ("count", count)):
        if t.dtype != torch.int64 or t.shape != (B,) or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous torch.int64 of shape [{B}]")
    if any(t.device != comp32.device for t in (plane, r_off, count)):
        raise ValueError("all inputs must lie on one device")
    return ft


def join16_at(comp32: torch.Tensor, plane: torch.Tensor, r_off: torch.Tensor,
              count: torch.Tensor, float_type) -> torch.Tensor:
    """K13 reading the raw section from the archive in place: the join of
    ``join16_rows`` with member b's raw section starting at word r_off[b]
    (int64[B]) of ``comp32.reshape(-1)``, any 4 B phase, words past the
    archive's ends read as its end words (clamped).

    plane: int32[B, E] with contiguous rows; count: int64[B] floats to
    join; float_type: fp16 or bf16. Returns int32[B, 2E]: the joined floats
    below count[b], zeros from it on (the high half of a word that the
    count cuts too); nothing of a float at or past its count is read.
    """
    ft = _check_join16_at_args(comp32, plane, r_off, count, float_type)
    if use_kernels(comp32):
        return K.join16_at(comp32, plane, r_off, count, ft)
    return join16_at_plain(comp32, plane, r_off, count, ft)


def join16_at_plain(comp32, plane, r_off, count, float_type):
    """Plain PyTorch version of K13 in archive mode; runs on any device:
    gathers the raw section at capacity width with the clamp, joins, then
    zeroes the floats at or past the count."""
    ft = _check_join16_at_args(comp32, plane, r_off, count, float_type)
    flat = comp32.reshape(-1)
    B, E = plane.shape
    idx = r_off[:, None] + torch.arange(E, dtype=torch.int64, device=flat.device)
    raw = flat[idx.clamp(0, flat.numel() - 1)]
    out = to_u32(join16_rows_plain(plane, raw, ft == FloatType.BFLOAT16))
    keep = torch.arange(4 * E, dtype=torch.int64, device=flat.device) < count[:, None]
    mask = (torch.where(keep[:, 0::2], 0xFFFF, 0)
            | torch.where(keep[:, 1::2], 0xFFFF0000, 0))
    return from_u32(out & mask)


def _check_join_args(planes, sec1, sec2, ft):
    P = 2 if ft == FloatType.FLOAT64 else 1
    if len(planes) != P:
        raise ValueError(f"{ft.name} takes {P} exponent plane(s)")
    B, E = planes[0].shape
    k1, k2 = (2, 1) if P == 1 else (4, 2)
    for name, t, w in [("exp", p, E) for p in planes] + [
            ("sec1", sec1, k1 * E), ("sec2", sec2, k2 * E)]:
        if t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D torch.int32 tensor")
        if t.shape[0] != B or t.shape[1] < w:
            raise ValueError(f"{name} needs shape [{B}, >= {w}], got {tuple(t.shape)}")
        if t.stride(1) != 1:
            raise ValueError(f"{name} rows must be contiguous")
        if t.device != planes[0].device:
            raise ValueError("all inputs must lie on one device")
    if E == 0:
        raise ValueError("the exponent planes must not be empty")


def join_wide(planes: Sequence[torch.Tensor], sec1: torch.Tensor,
              sec2: torch.Tensor, float_type) -> torch.Tensor:
    """Join fp32 or fp64 planes and raw sections back into float words:
    the inverse of ``split_wide_hist``.

    planes: [exp] (fp32) or [exp0, exp1] (fp64), each int32[B, E]; sec1,
    sec2: int32 rows of at least 2E, E words (fp32) or 4E, 2E (fp64),
    only those first words read. Rows need contiguous words, not
    contiguous tensors. Returns int32[B, 4E] (fp32) or [B, 8E] (fp64);
    words are zero wherever every input byte of their float is.
    """
    ft = _wide_type(float_type)
    _check_join_args(list(planes), sec1, sec2, ft)
    if use_kernels(sec1):
        return K.join_wide(list(planes), sec1, sec2, ft)
    return join_wide_plain(planes, sec1, sec2, ft)


def join_wide_plain(planes, sec1, sec2, float_type):
    """Plain PyTorch version of K7; runs on any device."""
    ft = _wide_type(float_type)
    _check_join_args(list(planes), sec1, sec2, ft)
    return _join_wide(planes, sec1, sec2, ft)


def _check_join_at_args(comp32, planes, s1_off, s2_off, count, ft):
    P = 2 if ft == FloatType.FLOAT64 else 1
    if len(planes) != P:
        raise ValueError(f"{ft.name} takes {P} exponent plane(s)")
    if comp32.dtype != torch.int32 or comp32.dim() != 2 or not comp32.is_contiguous():
        raise TypeError("comp32 must be a contiguous 2-D torch.int32 tensor")
    if comp32.numel() == 0:
        raise ValueError("comp32 must not be empty")
    B, E = planes[0].shape
    if E == 0:
        raise ValueError("the exponent planes must not be empty")
    for p in planes:
        if p.dtype != torch.int32 or p.shape != (B, E) or p.stride(1) != 1:
            raise TypeError(f"planes must be int32[{B}, {E}] with contiguous rows")
    for name, t in (("s1_off", s1_off), ("s2_off", s2_off), ("count", count)):
        if t.dtype != torch.int64 or t.shape != (B,) or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous torch.int64 of shape [{B}]")
    if any(t.device != comp32.device for t in (*planes, s1_off, s2_off, count)):
        raise ValueError("all inputs must lie on one device")


def join_wide_at(comp32: torch.Tensor, planes: Sequence[torch.Tensor],
                 s1_off: torch.Tensor, s2_off: torch.Tensor,
                 count: torch.Tensor, float_type) -> torch.Tensor:
    """K7 reading the raw sections from the archive in place: the join of
    ``join_wide`` with sec1 and sec2 of member b starting at words
    s1_off[b] and s2_off[b] (int64[B]) of ``comp32.reshape(-1)``, any 4 B
    phase, words past the archive's ends read as its end words (clamped).

    planes: [exp] or [exp0, exp1], int32[B, E] with contiguous rows; count:
    int64[B] floats to join. Returns int32[B, 4E] (fp32) or [B, 8E] (fp64):
    the joined floats below count[b], zeros from it on; nothing of a float
    at or past its count is read.
    """
    ft = _wide_type(float_type)
    planes = list(planes)
    _check_join_at_args(comp32, planes, s1_off, s2_off, count, ft)
    if use_kernels(comp32):
        return K.join_wide_at(comp32, planes, s1_off, s2_off, count, ft)
    return join_wide_at_plain(comp32, planes, s1_off, s2_off, count, ft)


def join_wide_at_plain(comp32, planes, s1_off, s2_off, count, float_type):
    """Plain PyTorch version of K7 in archive mode; runs on any device:
    gathers each section at capacity width with the clamp, joins, then
    zeroes the floats at or past the count."""
    ft = _wide_type(float_type)
    planes = list(planes)
    _check_join_at_args(comp32, planes, s1_off, s2_off, count, ft)
    flat = comp32.reshape(-1)
    B, E = planes[0].shape
    k1, k2 = (2, 1) if ft == FloatType.FLOAT32 else (4, 2)

    def gather(off, width):
        idx = off[:, None] + torch.arange(width, dtype=torch.int64, device=flat.device)
        return flat[idx.clamp(0, flat.numel() - 1)]

    out = _join_wide(planes, gather(s1_off, k1 * E), gather(s2_off, k2 * E), ft)
    keep = torch.arange(4 * E, dtype=torch.int64, device=flat.device) < count[:, None]
    if ft == FloatType.FLOAT64:  # two words a float
        keep = keep.repeat_interleave(2, dim=1)
    return torch.where(keep, out, 0)


def _join_wide(planes, sec1, sec2, ft: FloatType):
    E = planes[0].shape[1]
    e = [unpack_bytes(to_u32(p)) for p in planes]  # one byte per float
    if ft == FloatType.FLOAT32:
        low = _halves(to_u32(sec1[:, : 2 * E]))
        third = unpack_bytes(to_u32(sec2[:, :E]))
        r = low | (third << 16) | (e[0] << 24)
        out = ((r >> 1) | (r << 31)) & M32
    else:
        v_lo = to_u32(sec1[:, : 4 * E])
        v_hi = _halves(to_u32(sec2[:, : 2 * E])) | (e[1] << 16) | (e[0] << 24)
        lo = ((v_lo >> 1) | (v_hi << 31)) & M32
        hi = ((v_hi >> 1) | (v_lo << 31)) & M32
        out = torch.stack([lo, hi], dim=-1).flatten(-2)
    return from_u32(out)
