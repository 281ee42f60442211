"""The port's hand-written CUDA kernels: build, load, launch, count.

The sources in ``dietgpu_fork_torch/csrc/*.cu`` have a plain C interface.
At first use each is compiled with ``nvcc`` for ``sm_90a`` (Hopper), one
process per source, all started together; the objects are linked into one
shared library under ``dietgpu_fork_torch/build/``, named by a hash of the
sources, the headers they share (``csrc/*.cuh``) and the flags, and loaded
with ctypes. Nothing is built or loaded when
this module is imported.

Each wrapper takes CUDA tensors that the op modules (``ops/*.py``) have
already checked, allocates its outputs with torch and launches through
``_launch``: on the current stream of the tensors' device, with that device
current; it raises if the launch failed and adds one to the wrapper's entry
of ``launches``. Each is spanned ``kernel:<its name>`` while a profiler
runs (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

from ..core.constants import (
    BLOCK_SIZE,
    FLOAT_WORD_SIZE,
    MAX_BLOCK_WORDS32,
    MAX_ROW_WORDS32,
    NUM_SYMBOLS,
    VALID_PROB_BITS,
    WARP_SIZE,
    FloatType,
    sparse_bitmap_bytes,
)
from ..utils.profiling import spanned

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = (
    "split16_hist.cu",
    "rans_encode_rows.cu",
    "runs_merge.cu",
    "rans_decode_rows.cu",
    "split_wide_hist.cu",
    "join_wide.cu",
    "byte_hist.cu",
    "bitmap_pack.cu",
    "sparse_compact.cu",
    "sparse_expand.cu",
    "lookup.cu",
    "word_ranks.cu",
    "ans_parse.cu",
    "ans_table.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches of each kernel since the last reset_launches().
launches: Dict[str, int] = {
    "split16_hist": 0,
    "rans_encode_rows": 0,
    "runs_merge": 0,
    "rans_decode_join16": 0,
    "split_wide_hist": 0,
    "rans_decode_rows": 0,
    "join_wide": 0,
    "join_wide_at": 0,
    "byte_hist": 0,
    "rans_encode_blocks": 0,
    "rans_decode_blocks": 0,
    "rans_decode_join16_blocks": 0,
    "bitmap_pack": 0,
    "sparse_compact": 0,
    "sparse_expand": 0,
    "rans_decode_join32": 0,
    "rans_decode_join32_blocks": 0,
    "join16": 0,
    "join16_at": 0,
    "split16": 0,
    "split_wide": 0,
    "chunked_lookup": 0,
    "rowwise_lookup": 0,
    "word_ranks": 0,
    "ans_parse": 0,
    "ans_table": 0,
}

# What the last build did: seconds spent in nvcc (0.0 when the library was
# already built) and the compiler's report (registers, shared memory).
build_info: Dict[str, object] = {"seconds": 0.0, "log": "", "path": None}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> Path:
    """The library's path, named by a hash of the flags, the sources and
    the headers they share."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [CSRC / s for s in SOURCES] + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libdgt_kernels_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    srcs = [CSRC / s for s in SOURCES]
    out = _library_path()
    if out.exists():
        return out
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [work / f"{s.stem}.o" for s in srcs]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for s, o in zip(srcs, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    build_info["log"] = "".join(logs)
    failed = [(s.name, p.returncode, log)
              for s, p, log in zip(srcs, procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} (code {rc}):\n{log}" for name, rc, log in failed))
    tmp = work / out.name
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    build_info["seconds"] = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"linking failed with code {res.returncode}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _lib
    if _lib is not None:
        return _lib
    path = _build()
    lib = ctypes.CDLL(str(path))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sigs = {
        "dgt_split16_hist": [P, L, L, P, I, P, P, P, P, P],
        "dgt_rans_encode_rows": [P, P, P, P, L, L, I, P, P, P, P],
        "dgt_runs_merge": [P, P, I, P, P, P, P, L, P, L, P],
        "dgt_rans_decode": [I, I, P, L, P, P, P, P, P, P, I, P, P, L, L, I, P, P],
        "dgt_split_wide_hist": [P, L, L, P, I, P, P, P, P, P, P],
        "dgt_join": [P, L, P, L, P, P, L, P, P, L, L, P, L, L, I, I, P, P],
        "dgt_byte_hist": [P, L, L, P, P, P, P],
        "dgt_byte_checksum": [P, L, L, L, P, P, P],
        "dgt_rans_encode_blocks": [P, P, P, P, L, L, I, P, P, P, P],
        "dgt_bitmap_pack": [P, L, L, L, P, L, I, P, P],
        "dgt_sparse_compact": [P, L, L, L, P, P, L, I, P, L, P],
        "dgt_sparse_expand": [P, L, L, L, P, P, L, P, I, P, L, P],
        "dgt_split16": [P, L, L, I, P, P, P],
        "dgt_split_wide": [P, L, L, I, P, P, P, P],
        "dgt_chunked_lookup": [P, L, L, P, L, P, P],
        "dgt_rowwise_lookup": [P, L, L, P, L, P, P],
        "dgt_rans_encode_ctas_per_sm": [I],
        "dgt_word_ranks": [P, L, L, P, P, L, P, P],
        "dgt_ans_parse": [P, L, L, P, P, L, P, I, I, L,
                          P, P, P, P, P, P, P, P, P, P, P],
        "dgt_ans_table": [P, L, L, P, I, P, P, P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.dgt_error_string.argtypes = [ctypes.c_int]
    lib.dgt_error_string.restype = ctypes.c_char_p
    build_info["path"] = str(path)
    _lib = lib
    return lib


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.dgt_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(counter: str, entry: str, t: torch.Tensor, *args) -> None:
    """One call of the library's C entry ``entry`` with args, on the
    current stream of t's device and with that device current: raises if
    the launch failed, and adds one to ``launches[counter]``."""
    lib = library()
    with torch.cuda.device(t.device):
        err = getattr(lib, entry)(*args, _stream(t))
    _check(lib, err, counter)
    launches[counter] += 1


def _cuda_only(*ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_cuda:
            raise ValueError("the CUDA kernels take CUDA tensors only")


def _batch_ok(B: int) -> None:
    if not 0 < B < 65536:
        raise ValueError(f"batch {B} outside the kernels' grid range [1, 65535]")


@spanned("kernel:split16_hist")
def split16_hist(data32: torch.Tensor, n: torch.Tensor, bf16: bool):
    """K1 launch; arguments as ``ops.float_split.split16_hist``."""
    _cuda_only(data32, n)
    B, W32 = data32.shape
    _batch_ok(B)
    dev = data32.device
    exp = torch.empty((B, W32 // 2), dtype=torch.int32, device=dev)
    raw = torch.empty((B, W32 // 2), dtype=torch.int32, device=dev)
    hist = torch.zeros((B, NUM_SYMBOLS), dtype=torch.int32, device=dev)
    csum = torch.zeros((B,), dtype=torch.int32, device=dev)
    _launch("split16_hist", "dgt_split16_hist", data32, data32.data_ptr(), B,
            W32, n.data_ptr(), int(bf16), exp.data_ptr(), raw.data_ptr(),
            hist.data_ptr(), csum.data_ptr())
    return exp, raw, hist, csum


def _encode(fn: str, counter: str, x32, sizes, packed, magic, prob_bits: int,
            classic: bool):
    _cuda_only(x32, sizes, packed, magic)
    B, W = x32.shape
    _batch_ok(B)
    NB = W // 1024
    NR = -(-NB // 4)
    dev = x32.device
    states = torch.empty((B, NB, WARP_SIZE), dtype=torch.int32, device=dev)
    shape = (B, NB, MAX_BLOCK_WORDS32) if classic else (B, NR, MAX_ROW_WORDS32)
    streams = torch.empty(shape, dtype=torch.int32, device=dev)
    num_words = torch.empty((B, NB), dtype=torch.int32, device=dev)
    _launch(counter, fn, x32, x32.data_ptr(), sizes.data_ptr(),
            packed.data_ptr(), magic.data_ptr(), B, NB, prob_bits,
            states.data_ptr(), streams.data_ptr(), num_words.data_ptr())
    return states, streams, num_words


@spanned("kernel:encode_rows")
def encode_rows(x32, sizes, packed, magic, prob_bits: int):
    """K2 launch, row layout; arguments as ``ops.rans_encode.encode_rows``."""
    return _encode("dgt_rans_encode_rows", "rans_encode_rows", x32, sizes,
                   packed, magic, prob_bits, classic=False)


@spanned("kernel:encode_blocks")
def encode_blocks(x32, sizes, packed, magic, prob_bits: int):
    """K2 launch, classic layout; arguments as
    ``ops.rans_encode.encode_blocks``."""
    return _encode("dgt_rans_encode_blocks", "rans_encode_blocks", x32, sizes,
                   packed, magic, prob_bits, classic=True)


def encode_ctas_per_sm(classic: bool) -> int:
    """K2's CTAs resident on one SM of the current device, in the classic
    or the row layout (the CUDA occupancy calculator)."""
    n = library().dgt_rans_encode_ctas_per_sm(int(classic))
    if n < 0:
        _check(library(), -n, "rans_encode occupancy")
    return n


MAX_MERGE_SOURCES = 8  # K3 takes its sources by value


@spanned("kernel:runs_merge")
def runs_merge(srcs: Sequence[torch.Tensor], dst, ref, off, lens, out_len: int):
    """K3 launch; arguments as ``ops.merge.runs_merge``. The source
    pointers and lengths go to the kernel by value: no device copy."""
    srcs: List[torch.Tensor] = list(srcs)
    _cuda_only(dst, ref, off, lens, *srcs)
    if not 0 < len(srcs) <= MAX_MERGE_SOURCES:
        raise ValueError(f"runs_merge takes 1 to {MAX_MERGE_SOURCES} sources, "
                         f"not {len(srcs)}")
    dev = dst.device
    out = torch.empty((out_len,), dtype=torch.int32, device=dev)
    if out_len == 0:
        return out
    ptrs = (ctypes.c_void_p * MAX_MERGE_SOURCES)(*[s.data_ptr() for s in srcs])
    src_len = (ctypes.c_longlong * MAX_MERGE_SOURCES)(*[s.numel() for s in srcs])
    _launch("runs_merge", "dgt_runs_merge", dst, ctypes.addressof(ptrs),
            ctypes.addressof(src_len), len(srcs), dst.data_ptr(), ref.data_ptr(),
            off.data_ptr(), lens.data_ptr(), dst.shape[0], out.data_ptr(), out_len)
    return out


# the decode epilogues of dgt_rans_decode: K6, K4, K12
_BYTES, _JOIN16, _JOIN32 = 0, 1, 2


def _decode(counter: str, epi: int, classic: bool, words, seg_off, seg_len,
            comp_w, uncomp_w, state_off, lut, prob_bits: int, raw_off,
            sec2_off, bf16: bool):
    """One launch of the in-place decode walk (K6, K4 or K12, row or
    classic layout); arguments as ``ops.rans_decode.decode_at``."""
    if (raw_off is None) != (epi == _BYTES) or (sec2_off is None) != (epi != _JOIN32):
        raise ValueError(f"{counter} takes {('no', 'the raw', 'the sec1 and sec2')[epi]}"
                         " section offsets")
    extra = tuple(t for t in (raw_off, sec2_off) if t is not None)
    _cuda_only(words, seg_off, seg_len, comp_w, uncomp_w, state_off, lut, *extra)
    B, NB = comp_w.shape
    _batch_ok(B)
    dev = words.device
    out = torch.empty((B, NB, 1024 << epi), dtype=torch.int32, device=dev)
    _launch(counter, "dgt_rans_decode", words, epi, int(classic),
            words.data_ptr(), words.numel(), seg_off.data_ptr(),
            seg_len.data_ptr(), comp_w.data_ptr(), uncomp_w.data_ptr(),
            state_off.data_ptr(), lut.data_ptr(), prob_bits,
            None if raw_off is None else raw_off.data_ptr(),
            None if sec2_off is None else sec2_off.data_ptr(), B, NB,
            int(bf16), out.data_ptr())
    return out


# The six decode wrappers take the arguments of ``ops.rans_decode.decode_at``
# in its order: (words, seg_off, seg_len, comp_w, uncomp_w, state_off, lut,
# prob_bits, raw_off, sec2_off, bf16), with None for the offsets their
# epilogue does not read.

@spanned("kernel:decode_rows")
def decode_rows(*args):
    """K6 launch, row layout."""
    return _decode("rans_decode_rows", _BYTES, False, *args)


@spanned("kernel:decode_blocks")
def decode_blocks(*args):
    """K6 launch, classic layout."""
    return _decode("rans_decode_blocks", _BYTES, True, *args)


@spanned("kernel:decode_join16")
def decode_join16(*args):
    """K4 launch, row layout."""
    return _decode("rans_decode_join16", _JOIN16, False, *args)


@spanned("kernel:decode_join16_blocks")
def decode_join16_blocks(*args):
    """K4 launch, classic layout."""
    return _decode("rans_decode_join16_blocks", _JOIN16, True, *args)


@spanned("kernel:decode_join32")
def decode_join32(*args):
    """K12 launch, row layout."""
    return _decode("rans_decode_join32", _JOIN32, False, *args)


@spanned("kernel:decode_join32_blocks")
def decode_join32_blocks(*args):
    """K12 launch, classic layout."""
    return _decode("rans_decode_join32_blocks", _JOIN32, True, *args)


def _aligned(t: torch.Tensor, nbytes: int, name: str) -> None:
    """Each row of t must start on an nbytes boundary (vector accesses)."""
    row_bytes = t.element_size() * t.stride(0)
    if t.data_ptr() % nbytes or (t.shape[0] > 1 and row_bytes % nbytes):
        raise ValueError(f"{name} rows must start on {nbytes} B boundaries")


@spanned("kernel:split_wide_hist")
def split_wide_hist(data32: torch.Tensor, n: torch.Tensor, float_type):
    """K5 launch; arguments as ``ops.float_split.split_wide_hist``."""
    _cuda_only(data32, n)
    fp64 = FloatType(float_type) == FloatType.FLOAT64
    B, W32 = data32.shape
    _batch_ok(B)
    _aligned(data32, 16, "data32")
    P, E = (2, W32 // 8) if fp64 else (1, W32 // 4)
    dev = data32.device
    exp = torch.empty((P * B, E), dtype=torch.int32, device=dev)
    sec1 = torch.empty((B, W32 // 2), dtype=torch.int32, device=dev)
    sec2 = torch.empty((B, W32 // 4), dtype=torch.int32, device=dev)
    hist = torch.zeros((P * B, NUM_SYMBOLS), dtype=torch.int32, device=dev)
    csum = torch.zeros((B,), dtype=torch.int32, device=dev)
    _launch("split_wide_hist", "dgt_split_wide_hist", data32, data32.data_ptr(),
            B, W32, n.data_ptr(), int(fp64), exp.data_ptr(), sec1.data_ptr(),
            sec2.data_ptr(), hist.data_ptr(), csum.data_ptr())
    return exp, sec1, sec2, hist, csum


@spanned("kernel:split16")
def split16(data32: torch.Tensor, bf16: bool):
    """K1 launch without histogram; arguments as ``ops.float_split.split16``."""
    _cuda_only(data32)
    B, W32 = data32.shape
    _batch_ok(B)
    dev = data32.device
    exp = torch.empty((B, W32 // 2), dtype=torch.int32, device=dev)
    raw = torch.empty((B, W32 // 2), dtype=torch.int32, device=dev)
    _launch("split16", "dgt_split16", data32, data32.data_ptr(), B, W32,
            int(bf16), exp.data_ptr(), raw.data_ptr())
    return exp, raw


@spanned("kernel:split_wide")
def split_wide(data32: torch.Tensor, float_type):
    """K5 launch without histograms; arguments as
    ``ops.float_split.split_wide``."""
    _cuda_only(data32)
    fp64 = FloatType(float_type) == FloatType.FLOAT64
    B, W32 = data32.shape
    _batch_ok(B)
    _aligned(data32, 16, "data32")
    P, E = (2, W32 // 8) if fp64 else (1, W32 // 4)
    dev = data32.device
    exp = torch.empty((P * B, E), dtype=torch.int32, device=dev)
    sec1 = torch.empty((B, W32 // 2), dtype=torch.int32, device=dev)
    sec2 = torch.empty((B, W32 // 4), dtype=torch.int32, device=dev)
    _launch("split_wide", "dgt_split_wide", data32, data32.data_ptr(), B, W32,
            int(fp64), exp.data_ptr(), sec1.data_ptr(), sec2.data_ptr())
    return exp, sec1, sec2


def _join(counter: str, float_type, planes, sec1, sec2, nwords: int, s1, s2,
          count):
    """One launch of the join (K7 for fp32 and fp64, K13 for 16-bit types).
    Tensor mode: s1 and s2 are the sections' row strides (ints) and count
    is None; archive mode: they are int64[B] word offsets into sec1 == sec2
    == the archive of nwords words, and count int64[B]. 16-bit types have
    one section: their callers pass it as sec2 too, and s2 is not read."""
    ft = FloatType(float_type)
    ws = FLOAT_WORD_SIZE[ft]
    B, E = planes[0].shape
    _batch_ok(B)
    exp1 = planes[1] if ws == 8 else planes[0]
    dev = sec1.device
    out = torch.empty((B, ws * E), dtype=torch.int32, device=dev)
    if E == 0:
        return out
    at = count is not None
    _launch(counter, "dgt_join", sec1, planes[0].data_ptr(), planes[0].stride(0),
            exp1.data_ptr(), exp1.stride(0), sec1.data_ptr(), sec2.data_ptr(),
            nwords, s1.data_ptr() if at else None,
            s2.data_ptr() if at else None, 0 if at else s1, 0 if at else s2,
            count.data_ptr() if at else None, B, E, ws,
            int(ft == FloatType.BFLOAT16), out.data_ptr())
    return out


_NO_CLAMP = (1 << 63) - 1


@spanned("kernel:join16_rows")
def join16_rows(exp: torch.Tensor, raw: torch.Tensor, bf16: bool):
    """K13 launch, tensor mode; arguments as ``ops.float_split.join16_rows``."""
    _cuda_only(exp, raw)
    ft = FloatType.BFLOAT16 if bf16 else FloatType.FLOAT16
    return _join("join16", ft, [exp], raw, raw, _NO_CLAMP, raw.stride(0), 0,
                 None)


@spanned("kernel:join16_at")
def join16_at(comp32, plane, r_off, count, float_type):
    """K13 launch, archive mode; arguments as ``ops.float_split.join16_at``."""
    _cuda_only(comp32, plane, r_off, count)
    return _join("join16_at", float_type, [plane], comp32, comp32,
                 comp32.numel(), r_off, r_off, count)


@spanned("kernel:join_wide")
def join_wide(planes, sec1, sec2, float_type):
    """K7 launch, tensor mode; arguments as ``ops.float_split.join_wide``."""
    _cuda_only(*planes, sec1, sec2)
    return _join("join_wide", float_type, planes, sec1, sec2, _NO_CLAMP,
                 sec1.stride(0), sec2.stride(0), None)


@spanned("kernel:join_wide_at")
def join_wide_at(comp32, planes, s1_off, s2_off, count, float_type):
    """K7 launch, archive mode; arguments as
    ``ops.float_split.join_wide_at``."""
    _cuda_only(comp32, *planes, s1_off, s2_off, count)
    return _join("join_wide_at", float_type, planes, comp32, comp32,
                 comp32.numel(), s1_off, s2_off, count)


@spanned("kernel:byte_hist")
def byte_hist(rows: torch.Tensor, sizes: torch.Tensor, hist: bool = True, /):
    """K8 launch; arguments as ``ops.histogram.byte_hist``, with sizes in
    [0, S]. With hist, rows are 16 B aligned and of a 16 B multiple, sizes
    int32, and it returns (hist, csum int32). hist False, positional only,
    launches the checksum-only form: rows are read in place at any base
    and row stride, each row's bytes contiguous, sizes int64, and it
    returns (None, csum int64) with no histogram made."""
    _cuda_only(rows, sizes)
    B, S = rows.shape
    _batch_ok(B)
    dev = rows.device
    if hist:
        _aligned(rows, 16, "rows")
        if S % 16:
            raise ValueError("rows must hold a multiple of 16 bytes")
        counts = torch.zeros((B, NUM_SYMBOLS), dtype=torch.int32, device=dev)
    elif S > 1 and rows.stride(1) != 1:
        raise ValueError("each row's bytes must be contiguous")
    csum = torch.zeros((B,), dtype=torch.int32 if hist else torch.int64,
                       device=dev)
    if hist:
        _launch("byte_hist", "dgt_byte_hist", rows, rows.data_ptr(), B, S,
                sizes.data_ptr(), counts.data_ptr(), csum.data_ptr())
        return counts, csum
    _launch("byte_hist", "dgt_byte_checksum", rows, rows.data_ptr(), B,
            rows.stride(0), S, sizes.data_ptr(), csum.data_ptr())
    return None, csum


def _rows_i32(t: torch.Tensor, shape, name: str) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be int32 of shape {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@spanned("kernel:pack_bitmap")
def pack_bitmap(data32: torch.Tensor, n: torch.Tensor, float_type):
    """K9 launch; arguments as ``ops.bitmap_pack.pack_bitmap``, with n
    int32."""
    _cuda_only(data32, n)
    B, W32 = data32.shape
    _batch_ok(B)
    ws = FLOAT_WORD_SIZE[FloatType(float_type)]
    _rows_i32(data32, (B, W32), "data32")
    _rows_i32(n, (B,), "n")
    s_cap = 4 * W32 // ws
    bw = sparse_bitmap_bytes(s_cap) // 4
    out = torch.empty((B, bw), dtype=torch.int32, device=data32.device)
    _launch("bitmap_pack", "dgt_bitmap_pack", data32, data32.data_ptr(), B,
            W32, s_cap, n.data_ptr(), bw, ws, out.data_ptr())
    return out


RANK_TILE_WORDS = 4096  # bitmap words a CTA of K15 scans (csrc/word_ranks.cu)


@spanned("kernel:word_ranks")
def word_ranks(bm32: torch.Tensor, n: torch.Tensor):
    """K15 launch (two passes behind one C entry); arguments as
    ``ops.sparse_stream.word_ranks``, with n int64."""
    _cuda_only(bm32, n)
    B = bm32.shape[0] if bm32.dim() == 2 else -1
    _batch_ok(B)
    BW = bm32.shape[1]
    _rows_i32(bm32, (B, BW), "bm32")
    if n.dtype != torch.int64 or tuple(n.shape) != (B,) or not n.is_contiguous():
        raise ValueError(f"n must be contiguous int64 of shape ({B},)")
    if 32 * BW >= 1 << 31:
        raise ValueError(f"{BW} bitmap words: ranks past int32")
    dev = bm32.device
    tiles = B * max(1, -(-BW // RANK_TILE_WORDS))
    tsum = torch.empty((tiles,), dtype=torch.int32, device=dev)
    out = torch.empty((B, BW + 1), dtype=torch.int32, device=dev)
    _launch("word_ranks", "dgt_word_ranks", bm32, bm32.data_ptr(), B, BW,
            n.data_ptr(), tsum.data_ptr(), tiles, out.data_ptr())
    return out


@spanned("kernel:compact_by_bitmap")
def compact_by_bitmap(data32: torch.Tensor, bm32: torch.Tensor,
                      ranks: torch.Tensor, float_type):
    """K10 launch; arguments and results as
    ``ops.sparse_stream.compact_by_bitmap``."""
    _cuda_only(data32, bm32, ranks)
    B, W32 = data32.shape
    _batch_ok(B)
    ws = FLOAT_WORD_SIZE[FloatType(float_type)]
    BW = bm32.shape[1] if bm32.dim() == 2 else -1
    _rows_i32(data32, (B, W32), "data32")
    _rows_i32(bm32, (B, BW), "bm32")
    _rows_i32(ranks, (B, BW + 1), "ranks")
    s_cap = 4 * W32 // ws
    if s_cap > 32 * BW:
        raise ValueError(f"{BW} bitmap words cannot cover {s_cap} floats")
    ow = -(-s_cap * ws // 4)
    out = torch.empty((B, ow), dtype=torch.int32, device=data32.device)
    _launch("sparse_compact", "dgt_sparse_compact", data32, data32.data_ptr(), B,
            W32, s_cap, bm32.data_ptr(), ranks.data_ptr(), BW, ws,
            out.data_ptr(), ow)
    return out, ranks[:, -1]


@spanned("kernel:expand_by_bitmap")
def expand_by_bitmap(nz32: torch.Tensor, bm32: torch.Tensor,
                     ranks: torch.Tensor, n: torch.Tensor, out_floats: int,
                     float_type):
    """K11 launch; arguments as ``ops.sparse_stream.expand_by_bitmap``, with
    n in [0, out_floats]."""
    _cuda_only(nz32, bm32, ranks, n)
    B, NZW = nz32.shape
    _batch_ok(B)
    ws = FLOAT_WORD_SIZE[FloatType(float_type)]
    BW = bm32.shape[1] if bm32.dim() == 2 else -1
    _rows_i32(nz32, (B, NZW), "nz32")
    _rows_i32(bm32, (B, BW), "bm32")
    _rows_i32(ranks, (B, BW + 1), "ranks")
    _rows_i32(n, (B,), "n")
    nz_cap = 4 * NZW // ws
    ow = -(-out_floats * ws // 4)
    if out_floats < 0 or nz_cap < 1 or 4 * ow // ws > 32 * BW:
        raise ValueError(f"bad shapes: {out_floats} floats out of {nz_cap} "
                         f"nonzero slots and {BW} bitmap words")
    out = torch.empty((B, ow), dtype=torch.int32, device=nz32.device)
    _launch("sparse_expand", "dgt_sparse_expand", nz32, nz32.data_ptr(), B, NZW,
            nz_cap, bm32.data_ptr(), ranks.data_ptr(), BW, n.data_ptr(), ws,
            out.data_ptr(), ow)
    return out


@spanned("kernel:chunked_lookup")
def chunked_lookup(tables: torch.Tensor, idx: torch.Tensor):
    """K14 launch, one table per member; arguments as
    ``ops.lookup.chunked_lookup``."""
    _cuda_only(tables, idx)
    B, H = tables.shape
    _batch_ok(B)
    N = idx.shape[1]
    out = torch.empty((B, N), dtype=torch.int32, device=idx.device)
    if N == 0:
        return out
    _launch("chunked_lookup", "dgt_chunked_lookup", idx, tables.data_ptr(), B,
            H, idx.data_ptr(), N, out.data_ptr())
    return out


@spanned("kernel:rowwise_lookup")
def rowwise_lookup(tables: torch.Tensor, idx: torch.Tensor):
    """K14 launch, one table per row; arguments as
    ``ops.lookup.rowwise_lookup``."""
    _cuda_only(tables, idx)
    R, H = tables.shape
    K = idx.shape[1]
    out = torch.empty((R, K), dtype=torch.int32, device=idx.device)
    if R == 0 or K == 0:
        return out
    _launch("rowwise_lookup", "dgt_rowwise_lookup", idx, tables.data_ptr(), R,
            H, idx.data_ptr(), K, out.data_ptr())
    return out


@spanned("kernel:ans_parse")
def ans_parse(comp32: torch.Tensor, base: torch.Tensor, out_capacity: int,
              caps, prob_bits: int, native: bool, expect_n):
    """K16 launch; arguments as ``models.ans.ans_parse_plain``, with base,
    caps and expect_n contiguous int64[B] (caps and expect_n may be None).
    Returns the fields of ``models.ans.ParsedANS`` in its order, the decode
    table last."""
    opt = tuple(t for t in (caps, expect_n) if t is not None)
    _cuda_only(comp32, base, *opt)
    if comp32.dtype != torch.int32 or comp32.dim() != 2 or comp32.numel() == 0:
        raise TypeError("comp32 must be a non-empty 2-D torch.int32 tensor")
    if not comp32.is_contiguous():
        raise ValueError("comp32 must be contiguous")
    B, CW = comp32.shape
    _batch_ok(B)
    for name, t in (("base", base), ("caps", caps), ("expect_n", expect_n)):
        if t is None:
            continue
        if t.dtype != torch.int64 or tuple(t.shape) != (B,) or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int64 of shape ({B},)")
        if t.device != comp32.device:
            raise ValueError("all inputs must lie on one device")
    if prob_bits not in VALID_PROB_BITS:
        raise ValueError(f"prob_bits must be one of {VALID_PROB_BITS}")
    NB = max(1, -(-out_capacity // BLOCK_SIZE))
    NSEG = -(-NB // 4) if native else NB
    dev = comp32.device

    def empty(shape, dtype=torch.int64):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = (empty((B, NSEG)), empty((B, NSEG)), empty((B, NB), torch.int32),
           empty((B, NB), torch.int32), empty((B,)), empty((B, NUM_SYMBOLS)),
           empty((B,), torch.bool), empty((B,)), empty((B,)),
           empty((B, 1 << prob_bits), torch.int32))
    _launch("ans_parse", "dgt_ans_parse", comp32, comp32.data_ptr(), B, CW,
            base.data_ptr(), None if caps is None else caps.data_ptr(),
            out_capacity, None if expect_n is None else expect_n.data_ptr(),
            prob_bits, int(native), NB, *[t.data_ptr() for t in out])
    return out


@spanned("kernel:ans_table")
def ans_table(hist: torch.Tensor, totals: torch.Tensor, prob_bits: int):
    """K17 launch; arguments as ``ops.table.ans_table_plain``, with hist
    int32[B, 256] (each row's counts contiguous, its rows at any stride: an
    expanded row is read in place) and totals contiguous int64[B]. Returns
    (packed int32[B, 256], magic int32[B, 256], pdf int64[B, 256])."""
    _cuda_only(hist, totals)
    if (hist.dtype != torch.int32 or hist.dim() != 2
            or hist.shape[1] != NUM_SYMBOLS):
        raise TypeError(f"hist must be torch.int32 of shape [B, {NUM_SYMBOLS}]")
    if hist.stride(1) != 1:
        raise ValueError("each row of hist must be contiguous")
    B = hist.shape[0]
    _batch_ok(B)
    if (totals.dtype != torch.int64 or tuple(totals.shape) != (B,)
            or not totals.is_contiguous()):
        raise TypeError(f"totals must be contiguous int64 of shape ({B},)")
    if totals.device != hist.device:
        raise ValueError("hist and totals must lie on one device")
    if prob_bits not in VALID_PROB_BITS:
        raise ValueError(f"prob_bits must be one of {VALID_PROB_BITS}")
    dev = hist.device
    packed = torch.empty((B, NUM_SYMBOLS), dtype=torch.int32, device=dev)
    magic = torch.empty((B, NUM_SYMBOLS), dtype=torch.int32, device=dev)
    pdf = torch.empty((B, NUM_SYMBOLS), dtype=torch.int64, device=dev)
    _launch("ans_table", "dgt_ans_table", hist, hist.data_ptr(), B,
            hist.stride(0), totals.data_ptr(), prob_bits, packed.data_ptr(),
            magic.data_ptr(), pdf.data_ptr())
    return packed, magic, pdf
