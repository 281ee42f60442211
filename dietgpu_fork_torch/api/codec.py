"""User-facing batch codec API on torch tensors, mirroring the reference's
PyTorch custom ops (TORCH_LIBRARY(dietgpu), DietGpu.cpp:921-978):

  max_float_compressed_output_size / max_float_compressed_size
  max_any_compressed_output_size / max_any_compressed_size
  compress_data / compress_data_split_size / compress_data_simple
  decompress_data / decompress_data_split_size / decompress_data_simple

plus ``decompress_data_device``. A port of the JAX package's
``api/codec.py``: the same entry points, arguments, archive bytes and
matrix shapes, on lists of torch tensors. Every tensor a call returns lies
on its input's device; on a CUDA tensor the data never leaves the card,
and only metadata (sizes, magics, float types, success flags, checksums)
is read back to the host. Each compress and decompress entry returns the
reference's temp-memory high-water estimate (``runtime/stack_memory.py``).

The archive layout: ``native=None`` picks the row-stream layout on a CUDA
tensor and the classic one (the CUDA reference's) on a CPU tensor, as the
JAX package picks native on the TPU only. On decompress it passes to the
models, which read the layout from the archives. ``sparse=True`` runs the
sparse float codec (``models/sparse.py``) wherever the JAX API takes it: a
nonzero bitmap ahead of a dense archive of the nonzero floats.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import use_kernels
from ..core.constants import (
    DEFAULT_PROB_BITS,
    FLOAT_WORD_SIZE,
    FloatType,
    max_compressed_size,
    max_float_compressed_size,
    max_sparse_float_compressed_size,
)
from ..models.ans import (
    ans_decode_padded,
    ans_encode_padded,
    ans_get_compressed_info,
    read_layout,
)
from ..models.float_codec import (
    archive_float_type,
    archive_layout,
    float_compress_padded,
    float_decompress_core,
    float_get_compressed_info,
)
from ..models.sparse import (
    dense_base,
    sparse_float_compress_padded,
    sparse_float_decompress_core,
)
from ..ops.bitops import to_u32
from ..ops.histogram import checksum_rows
from ..ops.merge import runs_merge
from ..runtime import stack_memory as sm
from ..utils.profiling import span, spanned

_DTYPE_TO_FT = {
    torch.float16: FloatType.FLOAT16,
    torch.bfloat16: FloatType.BFLOAT16,
    torch.float32: FloatType.FLOAT32,
    torch.float64: FloatType.FLOAT64,
}
_FT_TO_DTYPE = {v: k for k, v in _DTYPE_TO_FT.items()}
# a signed integer type of each float's width, to move float bits
_WORD_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def float_type_of(x) -> FloatType:
    """FloatType of a torch dtype or of a tensor's dtype."""
    dt = x if isinstance(x, torch.dtype) else x.dtype
    if dt not in _DTYPE_TO_FT:
        raise ValueError(f"unsupported float dtype {dt}")
    return _DTYPE_TO_FT[dt]


def dtype_of(ft: FloatType) -> torch.dtype:
    return _FT_TO_DTYPE[FloatType(ft)]


@dataclasses.dataclass
class DecompressStatus:
    """Mirrors ANSDecodeStatus / FloatDecompressStatus
    (GpuANSCodec.h:45-59, GpuFloatCodec.h:85-99)."""

    ok: bool = True
    error: str = "none"
    error_info: List[Tuple[int, str]] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# Sizing queries (DietGpu.cpp:128-153)
# ---------------------------------------------------------------------------


def max_float_compressed_output_size(ts: Sequence[torch.Tensor]) -> Tuple[int, int]:
    ft = float_type_of(ts[0])
    max_elems = max((t.numel() for t in ts), default=0)
    return len(ts), max_float_compressed_size(ft, max_elems)


def max_any_compressed_output_size(ts: Sequence[torch.Tensor]) -> Tuple[int, int]:
    max_bytes = max((t.numel() * t.element_size() for t in ts), default=0)
    return len(ts), max_compressed_size(max_bytes)


max_float_compressed_size = max_float_compressed_size  # re-export
max_sparse_float_compressed_size = max_sparse_float_compressed_size
max_any_compressed_size = max_compressed_size


# ---------------------------------------------------------------------------
# Packing, on the inputs' device
# ---------------------------------------------------------------------------


def _device_of(ts: Sequence[torch.Tensor]) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all batch members must lie on one device")
    return dev


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    if not t.numel():  # an empty tensor may carry any stride
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    return t.contiguous().reshape(-1).view(torch.uint8)


def _pack_byte_rows(ts: Sequence[torch.Tensor], row_bytes: int):
    """Members -> (uint8[B, max(4, round_up(row_bytes, 4))] zero-padded
    rows, int32[B] byte counts), on the members' device."""
    dev = _device_of(ts)
    row_bytes = max(4, -(-row_bytes // 4) * 4)
    buf = torch.zeros((len(ts), row_bytes), dtype=torch.uint8, device=dev)
    sizes = []
    for i, t in enumerate(ts):
        b = _as_bytes(t)
        buf[i, : b.numel()] = b
        sizes.append(b.numel())
    with span("sync:api.row_sizes"):
        return buf, torch.tensor(sizes, dtype=torch.int32, device=dev)


def pack_split_rows(x_flat: torch.Tensor, split_sizes: Sequence[int]):
    """Ragged-to-padded packing for the split-size convention, on the
    input's device: one 1-D tensor -> (rows [B, max split] zero padded,
    int32[B] split sizes)."""
    dev = x_flat.device
    split = torch.tensor([int(s) for s in split_sizes], dtype=torch.int64)
    offs = torch.cumsum(split, 0) - split
    S = int(split.max()) if split.numel() else 1
    with span("sync:api.split_sizes"):
        offs_d, split_d = offs.to(dev), split.to(dev)
        split32 = split.to(device=dev, dtype=torch.int32)
    cols = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    idx = (offs_d[:, None] + cols).clamp(0, x_flat.numel() - 1)
    rows = x_flat.reshape(-1)[idx]
    keep = cols < split_d[:, None]
    return (torch.where(keep, rows, torch.zeros((), dtype=rows.dtype, device=dev)),
            split32)


def _rows_to_words32(rows: torch.Tensor) -> torch.Tensor:
    """[B, S] rows of any type -> int32[B, ceil(S * itemsize / 4)] with the
    same bytes, zero padded."""
    u8 = rows.contiguous().view(torch.uint8)
    if u8.shape[1] % 4:
        u8 = F.pad(u8, (0, -u8.shape[1] % 4))
    return u8.view(torch.int32)


# ---------------------------------------------------------------------------
# Compress (DietGpu.cpp:161-528)
# ---------------------------------------------------------------------------


@spanned("api:compress_data")
def compress_data(
    compress_as_float: bool,
    ts: Sequence[torch.Tensor],
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    sparse: bool = False,
    histogram=None,
    native: Optional[bool] = None,
):
    """Batch compress. Returns (comp uint8[B, maxCompSize], zero padded past
    each member's size; sizes int64[B], both on the inputs' device;
    temp_mem_estimate).

    histogram: optional [B, 256] caller-supplied byte histograms for raw
    ANS, which skip the statistics pass (GpuANSCodec.h:82-84). native: the
    archive layout; None picks row-stream on CUDA and classic on the CPU.
    sparse: the sparse float codec (floats only; raw ANS ignores it)."""
    if not len(ts):
        raise ValueError("empty batch")
    if native is None:
        native = use_kernels(ts[0])
    if histogram is not None and compress_as_float:
        raise ValueError(
            "caller-supplied histograms apply to raw ANS only (the float "
            "codec derives per-plane histograms inside its fused split)"
        )
    if compress_as_float:
        ft = float_type_of(ts[0])
        if any(float_type_of(t) != ft for t in ts):
            raise ValueError("all batch members must share a dtype")
        max_elems = max(max(t.numel() for t in ts), 1)
        with span("stage:api.pack_rows"):
            buf, _ = _pack_byte_rows(ts, max_elems * FLOAT_WORD_SIZE[ft])
            with span("sync:api.float_counts"):
                sizes = torch.tensor([t.numel() for t in ts], dtype=torch.int32,
                                     device=buf.device)
        compress = sparse_float_compress_padded if sparse else float_compress_padded
        comp, comp_bytes = compress(
            buf.view(torch.int32), sizes, ft, prob_bits, checksum, native=native)
        temp = sm.float_compress_temp_size(len(ts), max_elems, ft)
    else:
        max_bytes = max(max(t.numel() * t.element_size() for t in ts), 1)
        with span("stage:api.pack_rows"):
            buf, sizes = _pack_byte_rows(ts, max_bytes)
        hist = None
        if histogram is not None:
            if isinstance(histogram, np.ndarray):  # numpy has uint32, torch not
                histogram = torch.from_numpy(histogram.astype(np.int64))
            with span("sync:api.histogram"):
                hist = histogram.to(device=buf.device, dtype=torch.int64)
        comp, comp_bytes = ans_encode_padded(
            buf, sizes, prob_bits, checksum, hist, native=native)
        temp = sm.ans_encode_temp_size(len(ts), max_bytes)
    return comp, comp_bytes, temp


@spanned("api:compress_data_split_size")
def compress_data_split_size(
    compress_as_float: bool,
    t: torch.Tensor,
    split_sizes: Sequence[int],
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    native: Optional[bool] = None,
):
    """One contiguous input + host split sizes (element counts), packed into
    rows on its device. Interior raw-ANS splits must be 4-byte aligned
    (kANSRequiredAlignment, DietGpu.cpp:376-384). Returns as
    ``compress_data``."""
    if native is None:
        native = use_kernels(t)
    split = [int(s) for s in split_sizes]
    if any(s <= 0 for s in split):
        raise ValueError("split sizes must be positive")
    if compress_as_float:
        ft = float_type_of(t)
        words = t.contiguous().reshape(-1).view(_WORD_INT[FLOAT_WORD_SIZE[ft]])
        with span("stage:api.pack_rows"):
            rows, sizes = pack_split_rows(words, split)
        comp, comp_bytes = float_compress_padded(
            _rows_to_words32(rows), sizes, ft, prob_bits, checksum,
            native=native)
        temp = sm.float_compress_temp_size(len(split), max(split), ft)
    else:
        if any(s % 4 for s in split[:-1]):
            raise ValueError("interior raw-ANS splits must be 4-byte aligned")
        item = t.element_size()
        byte_sizes = [s * item for s in split]
        with span("stage:api.pack_rows"):
            rows, sizes = pack_split_rows(_as_bytes(t), byte_sizes)
            if rows.shape[1] % 4:
                rows = F.pad(rows, (0, -rows.shape[1] % 4))
        comp, comp_bytes = ans_encode_padded(
            rows, sizes, prob_bits, checksum, native=native)
        temp = sm.ans_encode_temp_size(len(split), max(byte_sizes))
    return comp, comp_bytes, temp


@spanned("api:compress_data_simple")
def compress_data_simple(
    compress_as_float: bool,
    ts: Sequence[torch.Tensor],
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    sparse: bool = False,
    native: Optional[bool] = None,
) -> List[torch.Tensor]:
    """Exact-size archives, one uint8 tensor per member
    (DietGpu.cpp:474-528)."""
    comp, comp_bytes, _ = compress_data(
        compress_as_float, ts, checksum, prob_bits, sparse, native=native
    )
    with span("stage:api.outputs"):
        with span("sync:api.simple_sizes"):
            comp_bytes = comp_bytes.tolist()
        return [comp[i, :cb].clone() for i, cb in enumerate(comp_bytes)]


# ---------------------------------------------------------------------------
# Decompress (DietGpu.cpp:536-917)
# ---------------------------------------------------------------------------


def _comp_matrix(comps: Union[Sequence[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Archives -> one uint8[B, C] matrix (C % 4 == 0) on their device."""
    if isinstance(comps, torch.Tensor) and comps.dim() == 2:
        if comps.dtype != torch.uint8:
            raise TypeError("archives must be torch.uint8")
        C = comps.shape[1]
        return F.pad(comps, (0, -C % 4)) if C % 4 else comps.contiguous()
    comps = list(comps)
    with span("stage:api.pack_rows"):
        buf, _ = _pack_byte_rows(comps, max(c.numel() for c in comps))
    return buf


def _float_bases(m32: torch.Tensor, sparse: bool) -> torch.Tensor:
    """int64[B] word offsets of the float archives in the rows: 0, or where
    each sparse member's count places its dense archive."""
    if sparse:
        return dense_base(m32)
    return torch.zeros(m32.shape[0], dtype=torch.int64, device=m32.device)


def _float_type_from(m: torch.Tensor, dtype, sparse: bool = False) -> FloatType:
    """The float type of ``dtype``, or else of member 0's float header."""
    if dtype is not None:
        return float_type_of(dtype)
    m32 = m.view(torch.int32)[:1]
    return archive_float_type(m32, _float_bases(m32, sparse))


def detect_native_layout(
    compress_as_float: bool,
    m: torch.Tensor,
    sparse: bool = False,
    float_type: Optional[FloatType] = None,
) -> bool:
    """The layout of the archives' (embedded) ANS archives: True for
    row-stream, False for classic, as decompress reads it with
    ``native=None`` (``models.ans.read_layout``: one copy of B words to the
    host; raises on a batch that mixes layouts; a garbage row does not
    vote). sparse: float archives behind a sparse header and bitmap."""
    m32 = _comp_matrix(m).view(torch.int32)
    base = _float_bases(m32, sparse and compress_as_float)
    if not compress_as_float:
        return read_layout(m32, base)
    ft = (archive_float_type(m32, base) if float_type is None
          else FloatType(float_type))
    return archive_layout(m32, base, ft)


@spanned("stage:api.status")
def _checksum_status(ok, arch, got) -> DecompressStatus:
    status = DecompressStatus()
    with span("sync:api.status"):
        ok, arch, got = (x.cpu().tolist() for x in (ok, arch, got))
    for i, (o, a, g) in enumerate(zip(ok, arch, got)):
        if not o:
            # decode itself failed; its computed checksum is meaningless
            status.ok = False
            status.error = "decode_failed"
            status.error_info.append((i, "member failed to decompress"))
        elif a != g:
            status.ok = False
            status.error = "checksum_mismatch"
            status.error_info.append(
                (i, f"expected checksum {a:#x} got {g:#x}"))
    return status


def _decode_rows(compress_as_float, m, cap, caps, dtype, checksum, prob_bits,
                 native, sparse=False):
    """Decode a matrix of archives into rows: (rows, zero past each
    member's bytes: int32[B, W] float words or uint8[B, cap] bytes; sizes
    int64[B]; success bool[B]; status or None; temp; float type or None),
    all tensors on m's device."""
    B = m.shape[0]
    caps_t = None
    if caps is not None:
        with span("sync:api.caps"):
            caps_t = torch.tensor(caps, dtype=torch.int64, device=m.device)
    if compress_as_float:
        ft = _float_type_from(m, dtype, sparse)
        if sparse:
            rows, success, sizes, ca, cg = sparse_float_decompress_core(
                m.view(torch.int32), max(cap, 1), ft, prob_bits, caps_t,
                checksum, native)
        else:
            rows, success, sizes, ca, cg = float_decompress_core(
                m.view(torch.int32),
                torch.zeros(B, dtype=torch.int64, device=m.device),
                max(cap, 1), ft, prob_bits, caps_t, checksum, native)
        temp = sm.float_decompress_temp_size(B, cap, ft, prob_bits)
    else:
        ft = None
        rows, success, sizes, ca = ans_decode_padded(
            m, max(cap, 1), prob_bits, caps_t, native)
        cg = checksum_rows(rows, sizes) if checksum else None
        temp = sm.ans_decode_temp_size(B, prob_bits)
    status = _checksum_status(success, ca, cg) if checksum else None
    return rows, sizes, success, status, temp, ft


@spanned("api:decompress_data")
def decompress_data(
    compress_as_float: bool,
    comps: Union[Sequence[torch.Tensor], torch.Tensor],
    out_capacities: Sequence[int],
    dtype=None,
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    sparse: bool = False,
    native: Optional[bool] = None,
):
    """Batch decompress into capacity-bounded outputs.

    comps: the uint8[B, C] matrix of ``compress_data`` or a list of archive
    tensors. Returns (list of 1-D tensors on the archives' device, sliced
    to the decoded size, of ``dtype`` for floats and uint8 for raw ANS;
    sizes int64[B] and success bool[B] on the host; status;
    temp_mem_estimate). Raises RuntimeError on a checksum mismatch when
    checksum=True, like the torch binding (DietGpu.cpp:623-626). native:
    the archive layout; None reads it from the archives. sparse: archives
    of the sparse float codec."""
    m = _comp_matrix(comps)
    caps = [int(c) for c in out_capacities]
    cap = max(caps) if caps else 1
    rows, sizes, success, status, temp, ft = _decode_rows(
        compress_as_float, m, cap, caps, dtype, checksum, prob_bits, native,
        sparse)
    with span("stage:api.outputs"):
        with span("sync:api.sizes"):
            sizes_h, success_h = sizes.cpu(), success.cpu()
        if compress_as_float:
            ws = FLOAT_WORD_SIZE[ft]
            u8 = rows.view(torch.uint8)
            outs = [u8[i, : min(int(s), c) * ws].view(dtype_of(ft)).clone()
                    for i, (s, c) in enumerate(zip(sizes_h.tolist(), caps))]
        else:
            outs = [rows[i, : min(int(s), c)].clone()
                    for i, (s, c) in enumerate(zip(sizes_h.tolist(), caps))]
    status = status or DecompressStatus()
    if checksum and not status.ok:
        raise RuntimeError(f"decompression checksum mismatch: {status.error_info}")
    return outs, sizes_h, success_h, status, temp


@spanned("api:decompress_data_device")
def decompress_data_device(
    compress_as_float: bool,
    comps: Union[Sequence[torch.Tensor], torch.Tensor],
    out_capacity: int,
    dtype=None,
    prob_bits: int = DEFAULT_PROB_BITS,
    sparse: bool = False,
    native: Optional[bool] = None,
):
    """Decompress with no host round trip of the data or the sizes: returns
    (rows on the archives' device, zero padded past each member's decoded
    bytes: int32[B, W] u32-packed float words, or uint8[B, out_capacity]
    for raw ANS; sizes int64[B] and success bool[B] on the device).
    ``out_capacity`` (elements) bounds every member."""
    m = _comp_matrix(comps)
    rows, sizes, success, _, _, _ = _decode_rows(
        compress_as_float, m, out_capacity, None, dtype, False, prob_bits,
        native, sparse)
    return rows, sizes, success


def _ragged_concat(rows32: torch.Tensor, byte_lens: Sequence[int]) -> torch.Tensor:
    """Concatenate the first byte_lens[i] bytes of each u32-packed row
    (int32[B, Wcap], zero past them) into one int32[ceil(total / 4)] tensor
    on the rows' device, with one K3 merge.

    Every member starts at an even byte offset (float words are >= 2 B;
    interior raw-ANS splits are 4 B aligned), so each output word is either
    inside one member, a word-aligned run of the member's row (offset % 4
    == 0) or of the row shifted by 16 bits (offset % 4 == 2), or a seam
    word straddling two members, a 1-word run of a small gathered source
    (the JAX package's ``api/codec.py:595-662``)."""
    dev = rows32.device
    B, Wcap = rows32.shape
    lens = np.asarray(byte_lens, np.int64)
    offs = np.zeros(B + 1, np.int64)
    offs[1:] = np.cumsum(lens)
    OW = max(-(-int(offs[-1]) // 4), 1)
    a = offs[:-1] % 4
    if (a % 2).any():
        raise ValueError("split members must start on even byte offsets")
    w_start = -(-offs[:-1] // 4)
    w_end = offs[1:] // 4
    w_end[-1] = OW  # the tail partial word reads the row's zero padding
    body_len = np.maximum(w_end - w_start, 0)
    row_off = np.arange(B, dtype=np.int64) * Wcap
    seam_i = np.nonzero(a == 2)[0]  # members that start mid-word (never 0)
    nseam = seam_i.size

    srcs = [rows32.reshape(-1)]
    if nseam:
        u8 = rows32.view(torch.uint8)
        # the row shifted down by 16 bits: word k = bytes 4k+2 .. 4k+5
        shifted = torch.cat([u8[:, 2:], torch.zeros_like(u8[:, :2])], dim=1)
        srcs.append(shifted.contiguous().view(torch.int32).reshape(-1))
        # seam = the last u16 of member i-1 | the first u16 of member i
        last = (seam_i - 1) * (4 * Wcap) + lens[seam_i - 1] - 2
        first = seam_i * (4 * Wcap)
        idx = np.stack([last, last + 1, first, first + 1], axis=1)
        with span("sync:api.concat_runs"):
            idx = torch.from_numpy(idx).to(dev)
        seams = u8.reshape(-1)[idx]
        srcs.append(seams.contiguous().view(torch.int32).reshape(-1))
    dst = np.concatenate([w_start, offs[seam_i] // 4])
    ref = np.concatenate([(a == 2).astype(np.int64), np.full(nseam, 2)])
    off = np.concatenate([row_off, np.arange(nseam, dtype=np.int64)])
    ln = np.concatenate([body_len, np.ones(nseam, np.int64)])
    # by destination, a zero-length run before the run that starts there
    order = np.lexsort((ln, dst))

    def t(x, dt=torch.int64):
        with span("sync:api.concat_runs"):
            return torch.from_numpy(np.ascontiguousarray(x[order])).to(dev, dt)

    return runs_merge(srcs, t(dst), t(ref, torch.int32), t(off), t(ln), OW)


@spanned("api:decompress_data_split_size")
def decompress_data_split_size(
    compress_as_float: bool,
    comps: Union[Sequence[torch.Tensor], torch.Tensor],
    out_split_sizes: Sequence[int],
    dtype=None,
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    native: Optional[bool] = None,
):
    """Decompress into ONE contiguous tensor on the archives' device with
    per-member split sizes (element counts); decoded sizes must match
    exactly (DietGpu.cpp:685-825). Returns (out, a 1-D tensor of ``dtype``
    for floats (float64 included) or uint8 for raw ANS; sizes; success;
    status; temp_mem_estimate)."""
    m = _comp_matrix(comps)
    split = [int(s) for s in out_split_sizes]
    if len(split) != m.shape[0]:
        raise ValueError("split count != batch size")
    if any(s <= 0 for s in split):
        raise ValueError("split sizes must be positive")
    if not compress_as_float and any(s % 4 for s in split[:-1]):
        raise ValueError("interior raw-ANS splits must be 4-byte aligned")
    rows, sizes, success, status, temp, ft = _decode_rows(
        compress_as_float, m, max(split), split, dtype, checksum, prob_bits,
        native)
    with span("stage:api.outputs"):
        with span("sync:api.sizes"):
            sizes_h, success_h = sizes.cpu(), success.cpu()
        for i, s in enumerate(split):
            if not bool(success_h[i]):
                raise RuntimeError(f"member {i}: decompression failed")
            if int(sizes_h[i]) != s:
                raise RuntimeError(
                    f"member {i}: decoded size {int(sizes_h[i])} != expected {s}")
        status = status or DecompressStatus()
        if checksum and not status.ok:
            raise RuntimeError(f"decompression checksum mismatch: {status.error_info}")
        ws = FLOAT_WORD_SIZE[ft] if compress_as_float else 1
        rows32 = rows if compress_as_float else _rows_to_words32(rows)
        flat = _ragged_concat(rows32, [s * ws for s in split])
        out = flat.view(torch.uint8)[: sum(split) * ws]
        if compress_as_float:
            out = out.view(dtype_of(ft))
        return out, sizes_h, success_h, status, temp


@spanned("api:decompress_data_simple")
def decompress_data_simple(
    compress_as_float: bool,
    comps: Union[Sequence[torch.Tensor], torch.Tensor],
    checksum: bool = False,
    prob_bits: int = DEFAULT_PROB_BITS,
    sparse: bool = False,
) -> List[torch.Tensor]:
    """Read the archive headers for sizes and types, then decompress
    (DietGpu.cpp:827-917). A sparse archive holds its float count in its
    first word, and its float header past its own bitmap."""
    m = _comp_matrix(comps)
    if compress_as_float:
        sizes = (to_u32(m.view(torch.int32)[:, 0]) if sparse
                 else float_get_compressed_info(m)[0])
        dt = dtype_of(_float_type_from(m, None, sparse))
    else:
        sizes, _ = ans_get_compressed_info(m)
        dt = None
    with span("sync:api.simple_sizes"):
        sizes = sizes.tolist()
    outs, _, success, _, _ = decompress_data(
        compress_as_float, m, sizes, dt, checksum, prob_bits, sparse)
    if not bool(success.all()):
        raise RuntimeError("decompression failed")
    return outs
