#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dietgpu_fork_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the sixteen CUDA kernels (K1-K16, thirteen sources)
   from ``dietgpu_fork_torch/csrc`` (nvcc, sm_90a, one process per
   source), printing the build time, ptxas's register, shared-memory and
   spill report, and K2's CTAs an SM;
2. drives each main path once with every kernel wrapper recording its
   calls, then holds each kernel and mode against its plain PyTorch
   version on the recorded inputs (the main path's own shapes), bit for
   bit, and times both with CUDA events, beside the kernel's bound (the
   bytes its calls must move at 3.35 TB/s; for the in-place decode the
   streams, live states and raw bytes it reads of the archive, and for
   the archive modes of K7 and K13 the section and plane bytes below each
   count, not the whole archive tensor) and, where one PyTorch call
   computes the same function, that call's time;
3. drives the main paths, each with the launch counters reset just before
   and read just after, and checks the round trip, the archive against the
   all-plain path's archive, cross-decoding both ways, and that every
   kernel of the path ran. The paths, prob_bits 10, batch 1, 16Mi N(0,1)
   floats:
   - ``float_compress_core`` then ``float_decompress_core`` in bf16, fp32
     and fp64, native row-stream layout;
   - A: the API (``api.codec.compress_data`` / ``decompress_data``) on the
     bf16 tensor, checksum on, the default layout (native on the card),
     whose archive must equal ``float_compress_core``'s;
   - B: raw ANS through the API on the same 32 MiB as bytes, checksum on;
   - C: A and B in the classic 0xD00D layout, and fp32 classic;
   - S: the sparse float codec through the API (``sparse=True``) at the
     reference sparse benchmark's largest cell, 5 x 15,000,000 floats, half
     of them exact zeros over N(0,1), prob_bits 9, checksum on, default
     layout, in bf16, fp32 and fp64;
   - the decode formulations, each on the archive of its core path's input
     made at set-up, so a run is the decode alone: FP32-twopass and
     BF16-twopass (``float_decompress_core(..., fused=False)``: K6 then K7
     or K13 reading the raw sections from the archive in place, no K3),
     native and classic; each must equal the default (fused: K12, K4)
     decode of the same archive, and the fp32 and 16-bit default paths
     above must launch neither K7's archive mode nor K13;
   - O, the ops with no TPU path (``OpsPhase``): ``split_packed`` (K1 and
     K5 without histogram) of each type's 16Mi input and the join back
     (K13, K7 in tensor mode), ``chunked_lookup`` and ``rowwise_lookup``
     (K14) with indices past both ends of the tables;
   - P, the distributed layer (``dietgpu_fork_torch.parallel``) through
     NCCL in a world of one (``nccl_world_of_one``: no other backend is
     tried), classic archives, data made from seeds with numpy (``ParallelPhase``):
     the sharded float codec on 8 members of 2Mi bf16 and fp32 floats
     (``shard_batch``, ``float_compress_sharded``,
     ``float_decompress_sharded``, ``global_compressed_sizes``), the
     shared-table raw ANS on 8 rows of 4 MiB of exponential bytes,
     ``compressed_all_gather`` of 16Mi bf16, fp32, fp64 and of 16Mi fp32 of
     random bits (which must ride raw), ``compressed_reduce_scatter`` and
     ``compressed_all_reduce`` of a 16Mi fp32 and a 16Mi bf16 addend, and
     ``compressed_ppermute`` of 16Mi bf16 along [(0, 0)]; each output must
     equal its input bit for bit, each archive the direct call's
     (``float_compress_padded`` / ``ans_encode_padded`` classic), and every
     byte, flag and wire word the all-plain run's; then ``utils.profiling``
     (a trace around one all-gather, ``timed``);
4. links the port to the JAX reference without JAX: the archive of a fixed
   v2-container input of each type must hash to its ``GOLDEN_V2_SHA256``
   entry, a classic bf16 and a classic raw-ANS archive to their
   ``GOLDEN_SHA256`` entries, and two sparse archives (fp32 native with a
   v2 dense part, bf16 classic) to their ``GOLDEN_SPARSE_SHA256`` entries;
   the CPU tests hold each equal to the NumPy oracle's archive;
5. holds K3 to its plain version on ragged runs that exercise its tiles
   (``phase_k3_ragged``), K2 in both layouts and K14 rowwise to theirs on
   edge inputs (``phase_encode_edges``: prob_bits 9 and 11, ragged sizes
   with dead blocks in the last row, rows only 4 B aligned, uniform bytes,
   single-symbol members, a block past the classic cap under the row cap;
   rowwise rows not a multiple of 8, 1, 5 and 128 indices a row, indices
   past both ends), K9, K15, K10 and K11 to theirs in bf16, fp32 and fp64 on
   ragged sparse batches (``phase_sparse_edges``: members around the tiles,
   one across 3 of K15's tiles, nnz 0, nnz = n and n = 0, counts ending
   mid-byte and mid-word, rows off 16 B boundaries, a 16-bit run starting
   at an odd slot, ranks past K11's nonzero row), the in-place decode at
   archive offsets that are not 16 B aligned (``phase_misaligned``: bf16
   and fp32 fused and two-pass, fp64 two-pass, both layouts), and K5 (with
   and without histograms) and K7 (archive and tensor modes) in fp32 and
   fp64 (``phase_wide_edges``: counts around both kernels' tiles, 0,
   inside a plane word and past the row, N(0,1) and one-bin fp64 data,
   sections at every word phase and past the archive's end), and K1 (with
   and without histogram) in bf16 and fp16 (``phase_split16_edges``: rows
   8 B past a 16 B boundary, bases 4 and 8 B past one, counts inside a
   word and a chunk, around K1's tile and at the row's capacity, N(0,1) and
   one-bin data), K13 in both modes in bf16 and fp16
   (``phase_join16_edges``: counts around its tile, inside a word and past
   the row, sections at word phases 1-3 with v1 and v2 offsets, output rows
   8 B past a 16 B boundary) and K8 (``phase_hist_edges``: one-valued rows
   of 65535, 65536 and 65537 bytes and two tiles, a ragged batch of sizes
   and a row width no multiple of 16), K8's checksum-only form against the
   torch folds (``phase_checksum_edges``: the decoded rows' widths and
   strides, 16-bit, fp32, fp64 and raw, rows 4-12 B past a 16 B boundary,
   sizes 0, 1, 15, 16, 17, the row and past it), and K16, the ANS parse,
   to its plain version on every field and the decode table
   (``phase_parse_edges``: both layouts, prob_bits 9-11, a ragged batch
   at word offsets with one member broken by each failure rule of the
   parse, expect_n, pdfs that sum short or to zero); checks that a core or two-pass
   round trip makes at most ``K3_MAX_LAUNCHES`` K3 launches
   (phase 3: the compress merge);
   round-trips a ragged bf16 batch of 128 members and ragged fp32 and
   fp64 batches of 64 members, each of up to 128Ki floats; then D, the
   reference's large batch, 128 x 512Ki bf16 through the API; E, the
   split-size API on one 16Mi bf16 tensor in ragged members, back to one
   contiguous CUDA tensor; F, a flipped raw byte in A's archive, which
   ``decompress_data(..., checksum=True)`` must refuse with RuntimeError;
   then, for the sparse codec, one classic fp32 member of 4Mi floats at 90%
   zeros and a ragged batch of 64 bf16 members, each against the all-plain
   archive and round-tripped;
6. times compress and decompress of each main path (3 warm-ups, median of
   10) on the kernel path, and the all-plain path (median of 3); each
   decode formulation in turns with the default one on the same archive;
   K8's checksum-only form at the sparse fp64 verify's shape (5 rows of
   30M words, about 7.5M live fp64 each) beside its bound and the torch
   fold it replaces (``time_checksum_form``); K16 at each benchmark cell's
   shapes (``time_parse``: held to the plain version on the calls one
   decompress_data makes, its launches counted, its device time a call
   against PARSE_MAX_MS and its bound); each function of phase P on
   its own, with its raw and wire MiB.

``python3 chip_smoke.py --profile`` instead profiles each main path's
compress and decompress, each decode formulation's decompress, each S
path's rank scan alone (K15, and the plain version, which is how the
scan ran before K15), phase O's run, each of its lookups alone and their
library calls, phase P's bf16 all-gather and fp32 all-reduce, K1 alone
with and without histogram on N(0,1) and one-bin bf16 data, K8 alone on 32 MiB of N(0,1) bf16 bytes and of one byte value
(``profile_paths``: the top device ops and every ``csrc`` kernel's device
time), then times the host work of K14 rowwise's wrapper piece by piece
(``wrapper_breakdown``), and prints no result.

It exits non-zero, printing no result, when CUDA or NCCL is not available
or any phase fails. The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from dietgpu_fork_torch.api import codec as C
from dietgpu_fork_torch.core.constants import FLOAT_WORD_SIZE, FloatType
from dietgpu_fork_torch.core.interop import (
    floats_from_words,
    rows_from_numpy,
    rows_to_numpy,
)
from dietgpu_fork_torch.models.ans import (
    ans_decode_padded,
    ans_encode_core,
    ans_encode_padded,
    ans_parse,
    ans_parse_plain,
)
from dietgpu_fork_torch.models.float_codec import (
    float_compress_core,
    float_compress_padded,
    float_decompress_core,
)
from dietgpu_fork_torch.models.sparse import (
    sparse_float_compress_core,
    sparse_float_compress_padded,
    sparse_float_decompress_core,
)
from dietgpu_fork_torch.ops.bitmap_pack import (
    bitmap_words,
    pack_bitmap,
    pack_bitmap_plain,
)
from dietgpu_fork_torch.ops.bitops import to_u32
from dietgpu_fork_torch.ops.checksum import checksum_batched, checksum_packed
from dietgpu_fork_torch.ops.float_split import (
    join16_at,
    join16_at_plain,
    join16_rows,
    join16_rows_plain,
    join_wide,
    join_wide_at,
    join_wide_at_plain,
    join_wide_plain,
    split16,
    split16_hist,
    split16_hist_plain,
    split16_plain,
    split_packed,
    split_wide,
    split_wide_hist,
    split_wide_hist_plain,
    split_wide_plain,
)
from dietgpu_fork_torch.ops.histogram import byte_hist, byte_hist_plain, checksum_rows
from dietgpu_fork_torch.ops.lookup import (
    ROWWISE_MAX_K,
    _check_lookup_args,
    chunked_lookup,
    chunked_lookup_plain,
    rowwise_lookup,
    rowwise_lookup_plain,
)
from dietgpu_fork_torch.ops.merge import runs_merge, runs_merge_plain
from dietgpu_fork_torch.ops.rans_decode import decode_at_plain
from dietgpu_fork_torch.ops.rans_encode import (
    encode_blocks,
    encode_blocks_plain,
    encode_rows,
    encode_rows_plain,
)
from dietgpu_fork_torch.ops.sparse_stream import (
    _unpack_bits,
    compact_by_bitmap,
    compact_by_bitmap_plain,
    expand_by_bitmap,
    expand_by_bitmap_plain,
    word_ranks,
    word_ranks_plain,
)
from dietgpu_fork_torch.ops.table import ans_table, ans_table_plain
from dietgpu_fork_torch.parallel import collectives as CO
from dietgpu_fork_torch.parallel import sharded as SH
from dietgpu_fork_torch.runtime import cuda_kernels as K
from dietgpu_fork_torch.utils import profiling

BF16, FP32, FP64 = FloatType.BFLOAT16, FloatType.FLOAT32, FloatType.FLOAT64
FP16 = FloatType.FLOAT16
# sha256 of the archive (its first comp_bytes bytes) of golden_input(ft):
# prob_bits 10, native, n = 2^20 + 4097 (a v2 container with a partial row
# and a partial block). tests/test_torch_float_codec.py (bf16) and
# tests/test_torch_float_wide.py (fp32, fp64) hold each equal to the NumPy
# oracle's archive and to the port's plain path.
GOLDEN_V2_SHA256 = {
    BF16: "2c86d4f6df30a86ff682c2a72844d01e1e331bf950bb78618e60bef1474355cf",
    FP32: "515251ff1df004ebfb0ad4e24e08e6e735bd5cf7784c6666408d2fa4e940607c",
    FP64: "f352defde63561233416f642fac10fb0b35902887d7fc6986e88cb4028818f7c",
}
# sha256 of the classic (0xD00D) archives of the same bf16 input: through
# the float codec, and as raw bytes through raw ANS with the checksum on.
# tests/test_torch_classic.py holds both equal to the NumPy oracle's
# (float_compress and ans_encode) and to the port's plain path.
GOLDEN_SHA256 = {
    "bf16_classic": "3da3fe253d879977414b663fa9550514d037eacf3bb494d140c4b6510bd16ec9",
    "raw_classic": "6346a842581fe1b56a5208729aaef57ab36c2e45f852b45709ce10e2428de17d",
}
# sha256 of the sparse archives (their first comp_bytes bytes) of
# golden_sparse_input(key), prob_bits 10: fp32 native, whose nnz >= 2^20
# nonzero floats make the dense part a v2 container, and bf16 classic.
# tests/test_torch_sparse.py holds each equal to the NumPy oracle's
# archive and to the port's plain path.
GOLDEN_SPARSE_SHA256 = {
    "fp32_native": "0e6f4d2491532667839e5c5aca9e6782a2a22fd43d9e2d4b597e66015c5569ed",
    "bf16_classic": "8cd5c7421b41fb7e44482fe76beea3617dad32d249439a0f088b767a79d68a81",
}
# key: (float type, native, n, share of zeros)
GOLDEN_SPARSE = {
    "fp32_native": (FP32, True, 1_250_000, 0.1),
    "bf16_classic": (BF16, False, (1 << 20) + 4097, 0.5),
}
GOLDEN_N = (1 << 20) + 4097
MAIN_N = 1 << 24
# phase S: the reference sparse benchmark's largest cell
# (bench/sparse_float_benchmark.py:4-6,42-53,136-138,158)
S_COUNT, S_N, S_ZEROS, S_PROB_BITS = 5, 15_000_000, 0.5, 9
D_COUNT, D_N = 128, 1 << 19  # phase D: the reference's large batch
PROB_BITS = 10
_WORD_DTYPE = {BF16: np.uint16, FP32: np.uint32, FP64: np.uint64}
_TORCH_DTYPE = {BF16: torch.bfloat16, FP32: torch.float32, FP64: torch.float64}

# main paths: the float codec's in bf16, fp32 and fp64, and the API's
P_BF16, P_FP32, P_FP64 = BF16.name, FP32.name, FP64.name
P_A, P_B = "A:api-bf16", "B:api-raw"
P_CF, P_CR, P_C32 = "C:api-bf16-classic", "C:api-raw-classic", "C:api-fp32-classic"
P_S16, P_S32, P_S64 = "S:api-sparse-bf16", "S:api-sparse-fp32", "S:api-sparse-fp64"
P_S = (P_S16, P_S32, P_S64)
# the decode formulations that are not the default: two-pass fp32 (K6 + K7)
# and bf16 (K6 + K13), both in archive mode, on the fp32 and bf16 core
# archives, native and classic; phase O, the ops with no TPU path
P_F32T, P_F32TC = "FP32-twopass", "FP32-twopass-classic"
P_B16T, P_B16TC = "BF16-twopass", "BF16-twopass-classic"
P_O = "O:ops"
# phase P, the distributed layer on NCCL in a world of one (classic
# archives): the sharded float codec in bf16 and fp32, the shared-table raw
# ANS, and the compressed collectives
P_SH16, P_SH32, P_TAB = "P:sharded-bf16", "P:sharded-fp32", "P:shared-table"
P_G16, P_G32, P_G64 = "P:all-gather-bf16", "P:all-gather-fp32", "P:all-gather-fp64"
P_GRAW = "P:all-gather-raw"
P_RS32, P_RS16 = "P:reduce-scatter-fp32", "P:reduce-scatter-bf16"
P_AR32, P_AR16 = "P:all-reduce-fp32", "P:all-reduce-bf16"
P_PP16 = "P:ppermute-bf16"
# the P paths of each kernel: K1 and K4 classic on 16-bit data; K5 on fp32
# and fp64, K12 classic on fp32, K6 classic and K7 on fp64 (the raw gather
# is fp32: its archive is made, not sent, and the raw words it receives go
# through the decode, which fails them); K8 on the shared table
P_16 = (P_SH16, P_G16, P_RS16, P_AR16, P_PP16)
P_DEC32 = (P_SH32, P_G32, P_GRAW, P_RS32, P_AR32)
P_WIDE_DEC = P_DEC32 + (P_G64,)
P_ALL = P_16 + P_WIDE_DEC + (P_TAB,)
# every path that encodes an ANS archive: all but phase O and the decode
# formulations, whose archives are made at set-up
P_ENCODE = (P_BF16, P_FP32, P_FP64, P_A, P_B, P_CF, P_CR, P_C32) + P_S + P_ALL
# every path that decodes an ANS archive: all but phase O
P_DECODE = ((P_BF16, P_FP32, P_FP64, P_A, P_B, P_CF, P_CR, P_C32) + P_S
            + (P_F32T, P_F32TC, P_B16T, P_B16TC) + P_ALL)
# phase P's sizes: the sharded codec's members, the shared table's byte
# rows (the reference ANSTest.cu's exponential law, lambda P_LAMBDA)
P_MEMBERS, P_MEMBER_N, P_TABLE_BYTES, P_LAMBDA = 8, 1 << 21, 1 << 22, 8.0
# phase O's lookups: the bf16 decode's LUT against one index per float, and
# one row-walk step's stream reads (a staged row each, 128 lanes)
O_LUT, O_ROWS, O_ROW_WORDS, O_LANES = 1024, 1024, 5120, 128

# K2's edge inputs (``encode_edge_bytes``): EDGE_NB blocks a member, so 5
# rows, the last with one live block and 3 dead warps.
# tests/test_torch_encode_edges.py holds the plain versions to the JAX
# package's encode_blocks_rows / encode_blocks on the same inputs.
EDGE_NB = 17
EDGE_CASES = ("ragged", "uniform", "single", "overflow")
EDGE_PROB_BITS = (9, 11)
# K14 rowwise edges: (rows, indices a row, idx 16 B aligned), tables of
# EDGE_H words, indices past both ends
EDGE_LOOKUPS = ((1027, 1, True), (1027, 5, True), (1027, 128, True),
                (13, 128, False))
EDGE_H = 37
# K15, K10 and K11 edges (``sparse_edge_inputs``): members around the tiles
# of K10 and K11 (16 KiB of floats: 8192 16-bit, 4096 fp32, 2048 fp64) and
# of K15 (4096 bitmap words, 131072 floats), as (floats, share of zeros).
# Counts end mid-byte (1, 8191, 8193, 3 x 8192 + 17, 300,005) and on a
# byte inside a word (8200, 5000); 300,005 floats span 3 of K15's tiles;
# then nnz = n, nnz = 0 and n = 0. tests/test_torch_sparse_edges.py holds
# the plain versions to a NumPy oracle and to the JAX package's
# compact_by_bitmap / expand_by_bitmap on the same inputs.
SPARSE_EDGE_CASES = ("ragged", "overread", "aligned")
SPARSE_EDGE_MEMBERS = ((1, 0.5), (8191, 0.5), (8193, 0.5), (3 * 8192 + 17, 0.5),
                       (300_005, 0.5), (8200, 0.0), (5000, 1.0), (0, 0.5))
SPARSE_EDGE_ALIGNED = ((16384, 0.9), (8192, 0.5), (16, 0.5), (16383, 0.9))
SPARSE_EDGE_NZ_WORDS = 600  # overread: K11's nonzero rows, short of the nnz

# the plain version of the six decode wrappers (K4, K6, K12), which take
# decode_at's arguments in its order
_AT_ROWS = functools.partial(decode_at_plain, rows=True)
_AT_BLOCKS = functools.partial(decode_at_plain, rows=False)
# K3 launches a round trip may make on the core paths and the 16-bit
# two-pass decodes: the compress merge only (the latter's is made at
# set-up, so their counted decode must launch none); every decode reads
# its raw sections from the archive in place (K4, K12, and K7's and K13's
# archive modes)
K3_MAX_LAUNCHES = {P_BF16: 1, P_FP32: 1, P_FP64: 1, P_B16T: 1, P_B16TC: 1,
                   P_F32T: 1, P_F32TC: 1}
# K5 and K7 edges (``wide_edge_inputs``): counts around the tiles of K5
# (8192 fp32 / 4096 fp64 floats) and K7 (4096 / 2048) and inside a plane
# word, one past the row's floats; rows of WIDE_EDGE_CAP floats, so plane
# rows of 5001 words start off 16 B boundaries.
# tests/test_torch_join_inplace.py holds the plain versions to the JAX
# package on the same inputs.
WIDE_EDGE_CAP = 20_004
WIDE_EDGE_COUNTS = (0, 1, 3, 5, 2047, 2049, 4095, 4096, 4097, 8191, 8193,
                    WIDE_EDGE_CAP, WIDE_EDGE_CAP + 100)
# K1 edges (``split16_edge_inputs``): rows of SPLIT16_EDGE_W32 = 2 (mod 4)
# words, so odd rows start 8 B past a 16 B boundary and their outputs 4 B
# past an 8 B one; counts 0, 1, 3 (inside a word), 5 and 9 (inside a 16 B
# chunk, either chunk phase), around K1's tile (16384 floats), inside a
# later tile and at and below the row's capacity.
# tests/test_torch_split16_edges.py holds the plain versions to the JAX
# package on the same inputs.
SPLIT16_EDGE_W32 = 3 * 8192 + 2
SPLIT16_EDGE_COUNTS = (0, 1, 3, 5, 9, 16383, 16384, 16385, 2 * 16384 + 7,
                       2 * SPLIT16_EDGE_W32 - 1, 2 * SPLIT16_EDGE_W32)
# K13 edges (``join16_edge_inputs``): rows of JOIN16_EDGE_E plane words, an
# odd count, so odd members' output rows start 8 B past a 16 B boundary and
# end half way into a 16 B chunk; counts 0 (a failed member), 1, 2 and 3
# (inside an output word and a plane word), 5, around K13's tile (4096
# floats), inside a later tile, at the row's capacity and past it. The raw
# sections lie in one archive (``join16_edge_archive``) 1-3 words past a
# 16 B boundary, 8 (v1) or 128 (v2) words past their member's base.
# tests/test_torch_join16_inplace.py holds the plain versions to a NumPy
# gather joined by the JAX package on the same inputs.
JOIN16_EDGE_E = 3 * 1024 + 1
JOIN16_EDGE_COUNTS = (0, 1, 2, 3, 5, 4095, 4096, 4097, 8191, 8193,
                      4 * JOIN16_EDGE_E - 1, 4 * JOIN16_EDGE_E,
                      4 * JOIN16_EDGE_E + 100)
# K8 edges (``hist_edge_inputs``): rows of one byte value (0x00, 0x3F)
# counted to 65535, 65536 and 65537 bytes (what one 16-bit counter half
# holds, and K8's 64 KiB chunk) and over two of each; then N(0,1) bf16
# bytes in a ragged batch, rows of a width and sizes that are no multiple
# of 16, the last size past the row. tests/test_torch_histogram_checksum.py
# holds the plain version to the JAX package on the same inputs.
HIST_EDGE_CASES = ("0x00", "0x3f", "ragged")
HIST_EDGE_ONE_SIZES = (65535, 65536, 65537, 2 * 65535, 2 * 65536, 2 * 65536 + 48)
HIST_EDGE_RAGGED = (0, 1, 15, 17, 4097, 65551, 131071, 3 * 65536 + 5,
                    3 * 65536 + 99)
# K8's checksum-only form (``checksum_edge_inputs``): rows read in place as
# the decoded rows lie, (name, row bytes, row stride, bytes from a 16 B
# boundary to row 0): 16-bit words32 rows (4 ceil(n / 2) bytes: 13 and
# 200003 floats), fp32 (16E) and fp64 (32E) rows within and past a 64 KiB
# chunk, raw ANS rows at odd capacities in wider rows, and rows 4, 8 and
# 12 bytes past a 16 B boundary. Each row takes one size of
# CSUM_EDGE_SIZES ("full" is the row, "past" 9 bytes past it).
CSUM_EDGE_ROWS = (("16bit-13", 28, 28, 0), ("16bit-200003", 400008, 400008, 0),
                  ("fp32", 64, 64, 0), ("fp32-wide", 16 * 65539, 16 * 65539, 0),
                  ("fp64", 128, 128, 0), ("raw-45", 45, 48, 0),
                  ("raw-200003", 200003, 200006, 0), ("off4", 131075, 131079, 4),
                  ("off8", 65536, 65544, 8), ("off12", 3 * 65536 + 7, 3 * 65536 + 9, 12))
CSUM_EDGE_SIZES = (0, 1, 15, 16, 17, "full", "past")
# K16 edges (``parse_edge_rows``): a ragged batch in rows of PARSE_EDGE_NB
# blocks, member 0 of 6 blocks (its second row 2 live blocks), member 3
# empty, each archive at word PARSE_EDGE_BASES[b] of its row, made by the
# plain encoder in either layout at prob_bits 9-11; each rule breaks member
# 0 by one failure rule of the parse ("none", "expect_n_ok" and
# "caps_past_out" break nothing; "pdf_short" and "pdf_zero" leave a pdf
# that sums below 2^prob_bits, which the parse does not check), and
# "row_sum" exists in the row layout only.
# tests/test_torch_ans_parse.py holds the plain version to a scalar model
# of the contract on the same inputs.
PARSE_EDGE_NB = 8
PARSE_EDGE_SIZES = (5 * 4096 + 77, 9000, 1, 0)
PARSE_EDGE_BASES = (0, 1, 3, 2)
PARSE_EDGE_RULES = ("none", "magic", "prob_bits", "nb_vs_n", "nb_huge",
                    "n_negative", "total_negative", "past_row", "capacity",
                    "count_worst", "fill", "start_negative", "extent",
                    "row_sum", "expect_n", "expect_n_ok", "caps_past_out",
                    "pdf_short", "pdf_zero")
PARSE_EDGE_PASS = ("none", "expect_n_ok", "caps_past_out", "pdf_short", "pdf_zero")
PARSE_EDGE_CASES = tuple((r, native) for r in PARSE_EDGE_RULES
                         for native in (True, False) if native or r != "row_sum")
PARSE_EDGE_PROB_BITS = (9, 10, 11)
# K16 at the benchmark cells' shapes: (cell, float type, members, floats a
# member, sparse at 50% zeros, prob_bits, checksum)
PARSE_CELLS = (
    ("float_bf16.single123m", BF16, 1, 123_456_789, False, 10, False),
    ("float_fp32.single123m", FP32, 1, 123_456_789, False, 10, True),
    ("sparse_fp64.b5x15m", FP64, 5, 15_000_000, True, 9, True),
    ("float_bf16.batch128", BF16, 128, 1 << 19, False, 10, False),
    ("sparse_fp64.b3x1m", FP64, 3, 1_000_000, True, 9, True),
)
PARSE_MAX_MS = 0.03  # K16's device time a call at every cell's shape
# K17 edges (``table_edge_batch``): a batch of three, the case's member,
# an empty member (total 0) and the counts of TABLE_EDGE_BYTES exponential
# bytes, at prob_bits 9-11. The case's member: "big", counts above 2^24
# (float32 rounds them and their total); "total_high", a total whose int64
# value is not its low 32 bits; "diff_rounds", 20 counts against a total
# thrice their sum (diff > 256); "excess_rounds", three large counts and 20
# single ones (an excess loop of 6-7 rounds); "ties", exact quotients from
# a total of 1000 * 2^prob_bits and 3 single counts, so the last round takes
# the two least values and the lowest id of six equal ones; "single", one
# symbol; "totals_below", 30 counts against a total 0.9 of their sum;
# "zero_total", counts with a total of 0; "uniform", every symbol alike
# (diff 0); "few", five single counts (diff > 0 gives symbols of count 0
# probability). tests/test_torch_ans_table.py holds the plain version to a
# scalar model of the contract on the same inputs.
TABLE_EDGE_CASES = ("big", "total_high", "diff_rounds", "excess_rounds", "ties",
                    "single", "totals_below", "zero_total", "uniform", "few")
TABLE_EDGE_PROB_BITS = (9, 10, 11)
TABLE_EDGE_BYTES = 10_007
# K17 at the benchmark cells' shapes: (cell, members of the table build,
# prob_bits); fp64 encodes its two planes in one call
TABLE_CELLS = tuple((cell, count * (2 if ft == FP64 else 1), pb)
                    for cell, ft, count, _, _, pb, _ in PARSE_CELLS)
TABLE_MAX_MS = 0.03  # K17's device time a call at every cell's shape

# (wrapper in runtime.cuda_kernels, launch counter, plain version, source,
# file:line of each TPU kernel it replaces, within the JAX package, and the
# main paths that must launch it)
KERNELS = [
    ("split16_hist", "split16_hist", split16_hist_plain,
     "dietgpu_fork_torch/csrc/split16_hist.cu",
     ("ops/pallas/float_split_fused.py:265",), (P_BF16, P_A, P_CF, P_S16) + P_16),
    ("encode_rows", "rans_encode_rows", encode_rows_plain,
     "dietgpu_fork_torch/csrc/rans_encode_rows.cu",
     ("ops/pallas/rans_encode_fused.py:114",
      "ops/pallas/rans_encode_fused.py:420"),
     (P_BF16, P_FP32, P_FP64, P_A, P_B) + P_S),
    ("runs_merge", "runs_merge", runs_merge_plain,
     "dietgpu_fork_torch/csrc/runs_merge.cu",
     ("ops/pallas/merge.py:305", "ops/pallas/merge.py:74"),
     (P_BF16, P_FP32, P_FP64, P_A, P_B, P_CF, P_CR, P_C32) + P_S + P_ALL),
    ("decode_join16", "rans_decode_join16", _AT_ROWS,
     "dietgpu_fork_torch/csrc/rans_decode_rows.cu",
     ("ops/pallas/rans_decode_fused2.py:104",), (P_BF16, P_A, P_S16)),
    ("split_wide_hist", "split_wide_hist", split_wide_hist_plain,
     "dietgpu_fork_torch/csrc/split_wide_hist.cu",
     ("ops/pallas/float_split_fused.py:291",
      "ops/pallas/float_split_fused.py:305"),
     (P_FP32, P_FP64, P_C32, P_S32, P_S64) + P_WIDE_DEC),
    ("decode_rows", "rans_decode_rows", _AT_ROWS,
     "dietgpu_fork_torch/csrc/rans_decode_rows.cu",
     ("ops/pallas/rans_decode_fused2.py:104",),
     (P_FP64, P_B, P_S64, P_B16T, P_F32T)),
    ("join_wide_at", "join_wide_at", join_wide_at_plain,
     "dietgpu_fork_torch/csrc/join_wide.cu",
     ("ops/pallas/float_split_fused.py:395",
      "ops/pallas/float_split_fused.py:412"),
     (P_FP64, P_S64, P_F32T, P_F32TC, P_G64)),
    ("join_wide", "join_wide", join_wide_plain,
     "dietgpu_fork_torch/csrc/join_wide.cu",
     ("ops/pallas/float_split_fused.py:395",
      "ops/pallas/float_split_fused.py:412"), (P_O,)),
    ("byte_hist", "byte_hist", byte_hist_plain,
     "dietgpu_fork_torch/csrc/byte_hist.cu",
     ("ops/pallas/histogram_mxu.py:113", "ops/pallas/histogram_mxu.py:93"),
     # the histogram form on raw ANS encodes; the checksum-only form on
     # every decompress that verifies its bytes
     (P_A, P_B, P_CF, P_CR, P_C32, P_TAB) + P_S),
    ("encode_blocks", "rans_encode_blocks", encode_blocks_plain,
     "dietgpu_fork_torch/csrc/rans_encode_rows.cu",
     ("ops/pallas/rans_encode_fused.py:305",
      "ops/pallas/rans_encode_fused.py:114"), (P_CF, P_CR, P_C32) + P_ALL),
    ("decode_blocks", "rans_decode_blocks", _AT_BLOCKS,
     "dietgpu_fork_torch/csrc/rans_decode_rows.cu",
     ("ops/pallas/rans_decode_fused2.py:104",),
     (P_CR, P_B16TC, P_F32TC, P_G64, P_TAB)),
    ("decode_join16_blocks", "rans_decode_join16_blocks",
     _AT_BLOCKS, "dietgpu_fork_torch/csrc/rans_decode_rows.cu",
     ("ops/pallas/rans_decode_fused2.py:104",), (P_CF,) + P_16),
    ("pack_bitmap", "bitmap_pack", pack_bitmap_plain,
     "dietgpu_fork_torch/csrc/bitmap_pack.cu",
     ("ops/pallas/bitmap_pack.py:36", "ops/pallas/bitmap_pack.py:62",
      "ops/pallas/bitmap_pack.py:84"), P_S),
    ("compact_by_bitmap", "sparse_compact", compact_by_bitmap_plain,
     "dietgpu_fork_torch/csrc/sparse_compact.cu",
     ("ops/pallas/sparse_stream.py:175", "ops/pallas/sparse_stream.py:356"),
     P_S),
    ("expand_by_bitmap", "sparse_expand", expand_by_bitmap_plain,
     "dietgpu_fork_torch/csrc/sparse_expand.cu",
     ("ops/pallas/sparse_stream.py:60",), P_S),
    ("decode_join32", "rans_decode_join32", _AT_ROWS,
     "dietgpu_fork_torch/csrc/rans_decode_rows.cu",
     ("ops/pallas/rans_decode_fused2.py:104",
      "ops/pallas/rans_decode_fused2.py:267"), (P_FP32, P_S32)),
    ("decode_join32_blocks", "rans_decode_join32_blocks",
     _AT_BLOCKS, "dietgpu_fork_torch/csrc/rans_decode_rows.cu",
     ("ops/pallas/rans_decode_fused2.py:104",
      "ops/pallas/rans_decode_fused2.py:267"), (P_C32,) + P_DEC32),
    ("join16_at", "join16_at", join16_at_plain,
     "dietgpu_fork_torch/csrc/join_wide.cu",
     ("ops/pallas/float_split_fused.py:377",), (P_B16T, P_B16TC)),
    ("join16_rows", "join16", join16_rows_plain,
     "dietgpu_fork_torch/csrc/join_wide.cu",
     ("ops/pallas/float_split_fused.py:377",), (P_O,)),
    ("split16", "split16", split16_plain,
     "dietgpu_fork_torch/csrc/split16_hist.cu",
     ("ops/pallas/float_split_fused.py:234",), (P_O,)),
    ("split_wide", "split_wide", split_wide_plain,
     "dietgpu_fork_torch/csrc/split_wide_hist.cu",
     ("ops/pallas/float_split_fused.py:329",
      "ops/pallas/float_split_fused.py:349"), (P_O,)),
    ("chunked_lookup", "chunked_lookup", chunked_lookup_plain,
     "dietgpu_fork_torch/csrc/lookup.cu", ("ops/pallas/lookup.py:38",), (P_O,)),
    ("rowwise_lookup", "rowwise_lookup", rowwise_lookup_plain,
     "dietgpu_fork_torch/csrc/lookup.cu", ("ops/pallas/lookup.py:60",), (P_O,)),
    # K15: the rank scan the JAX package runs in XLA inside compact_by_bitmap
    # and expand_by_bitmap (popcounts and jnp.cumsum), not a Pallas kernel
    ("word_ranks", "word_ranks", word_ranks_plain,
     "dietgpu_fork_torch/csrc/word_ranks.cu",
     ("ops/pallas/sparse_stream.py:280", "ops/pallas/sparse_stream.py:430"),
     P_S),
    # K16: the header parse, its checks and the decode table, the torch glue
    # the JAX package leaves to XLA before its decode kernels, not a Pallas
    # kernel
    ("ans_parse", "ans_parse", ans_parse_plain,
     "dietgpu_fork_torch/csrc/ans_parse.cu",
     ("models/ans.py:331", "ops/table.py:218"), P_DECODE),
    # K17: the encode table build (normalisation, cdf, magic, packing), the
    # torch glue the JAX package leaves to XLA before its encode kernel,
    # not a Pallas kernel
    ("ans_table", "ans_table", ans_table_plain,
     "dietgpu_fork_torch/csrc/ans_table.cu",
     ("ops/table.py:26", "ops/table.py:110"), P_ENCODE),
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
WARP = 32  # rANS states a block


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _ws(ft) -> int:
    return FLOAT_WORD_SIZE[FloatType(ft)]


def _nnz(ranks) -> int:
    return int(ranks[:, -1].sum())


def _live_words(bm32, n) -> int:
    """Bitmap words holding a float below n, over the rows: the words the
    rank scan must read."""
    return int(((n.to(torch.int64).clamp(0, 32 * bm32.shape[1]) + 31) // 32).sum())


def _distinct(tables, idx) -> int:
    """Distinct clamped indices over the rows: the table words that one
    lookup per row must read."""
    s = idx.clamp(0, tables.shape[1] - 1).sort(dim=1).values
    return int(s.shape[0] + (s[:, 1:] != s[:, :-1]).sum()) if s.numel() else 0


def _decode_need(a) -> int:
    """The archive bytes an in-place decode (decode_at's arguments) needs
    of the whole archive tensor it is handed: the streams' words, the states
    of the blocks that decode something, and the raw section bytes below
    each block's count (1 a float for the 16-bit join, 3 for fp32's)."""
    seg_len, uncomp_w, raw_off, sec2_off = a[2], a[4], a[8], a[9]
    raw = 0 if raw_off is None else (1 if sec2_off is None else 3)
    return (4 * int(seg_len.clamp(min=0).sum())
            + 4 * WARP * int((uncomp_w > 0).sum()) + raw * int(uncomp_w.sum()))


def _join_at_need(a) -> int:
    """The bytes K7's archive mode (join_wide_at's arguments) needs of the
    archive and the planes: the section and plane bytes of the floats below
    each count (3 + 1 B a float for fp32, 6 + 2 for fp64), not the whole
    archive tensor."""
    planes, count, ft = a[1], a[4], a[5]
    return _ws(ft) * int(count.clamp(0, 4 * planes[0].shape[1]).sum())


def _join16_at_need(a) -> int:
    """The bytes K13's archive mode (join16_at's arguments) needs of the
    archive and the plane: 1 B of raw section and 1 B of plane a float
    below each count, not the whole archive tensor."""
    plane, count = a[1], a[3]
    return 2 * int(count.clamp(0, 4 * plane.shape[1]).sum())


def _parse_need(a) -> int:
    """The archive bytes K16 (ans_parse's arguments) needs of the whole
    archive tensor it is handed: each member's header and pdf (136 words)
    and 8 B of blockWords a live block."""
    live = int((ans_parse_plain(*a).uncomp_w > 0).sum())
    return 4 * 136 * a[0].shape[0] + 8 * live


# the bytes of the inputs whose use depends on the data, as (argument
# index or indices, the bytes that the call's data needs of them). The
# splits (K1, K5) are not here: their exponent planes are capacity-sized
# and unmasked, so they read every input word whatever the counts.
_DATA_INPUT = {
    "join_wide_at": ((0, 1), _join_at_need),
    "join16_at": ((0, 1), _join16_at_need),
    "encode_rows": (0, lambda a: int(a[1].sum())),
    "encode_blocks": (0, lambda a: int(a[1].sum())),
    "runs_merge": (0, lambda a: 4 * int(a[4].sum())),
    "decode_join16": (0, _decode_need),
    "decode_join16_blocks": (0, _decode_need),
    "decode_rows": (0, _decode_need),
    "decode_blocks": (0, _decode_need),
    "byte_hist": (0, lambda a: int(a[1].sum())),
    "pack_bitmap": (0, lambda a: _ws(a[2]) * int(a[1].sum())),
    "compact_by_bitmap": (0, lambda a: _ws(a[3]) * _nnz(a[2])),
    "expand_by_bitmap": (0, lambda a: _ws(a[5]) * _nnz(a[2])),
    "decode_join32": (0, _decode_need),
    "decode_join32_blocks": (0, _decode_need),
    "rowwise_lookup": (0, lambda a: 4 * _distinct(*a)),
    "word_ranks": (0, lambda a: 4 * _live_words(*a)),
    "ans_parse": (0, _parse_need),
}


def bound_ms(wname: str, args, out) -> float:
    """The least time of one call on an H100: each input read once and each
    output written once at device-memory rate, counting of the input whose
    use depends on the data only what this call's data needs (floats below
    n, nonzero floats, coded words, bytes of the runs copied)."""
    nbytes = _nbytes(args) + _nbytes(out)
    if wname in _DATA_INPUT:
        i, need = _DATA_INPUT[wname]
        nbytes += need(args) - sum(_nbytes(args[k]) for k in as_tuple(i))
    return nbytes / HBM_BYTES_PER_S * 1e3


def _typed_rows(rows32: torch.Tensor, ft) -> torch.Tensor:
    return rows32.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[_ws(ft)])


def library_call(wname: str, args):
    """One PyTorch call computing the kernel's function on the recorded
    inputs, set up outside the timing, or None where there is none."""
    if wname == "byte_hist":
        if len(args) > 2:  # the checksum-only form: no library call
            return None
        rows, sizes = args
        one = [rows[b, : int(s)] for b, s in enumerate(sizes.tolist())]
        return lambda: [torch.bincount(r, minlength=256) for r in one]
    if wname == "compact_by_bitmap":
        data32, bm32, _, ft = args
        s_cap = 4 * data32.shape[1] // _ws(ft)
        items = _typed_rows(data32, ft)[:, :s_cap]
        mask = _unpack_bits(bm32, s_cap)
        return lambda: torch.masked_select(items, mask)
    if wname == "expand_by_bitmap":
        nz32, bm32, ranks, n, out_floats, ft = args
        slots = 4 * (-(-out_floats * _ws(ft) // 4)) // _ws(ft)
        pos = torch.arange(slots, device=n.device)[None, :]
        mask = _unpack_bits(bm32, slots) & (pos < n[:, None])
        items = _typed_rows(nz32, ft)
        src = torch.cat([items[b, : int(c)] for b, c in
                         enumerate(mask.sum(dim=1).tolist())])
        return lambda: torch.zeros(mask.shape, dtype=items.dtype,
                                   device=n.device).masked_scatter_(mask, src)
    if wname in ("chunked_lookup", "rowwise_lookup"):
        tables, idx = args  # the clamp is set-up: gather takes no clamp
        safe = idx.to(torch.int64).clamp(0, tables.shape[1] - 1)
        return lambda: torch.gather(tables, 1, safe)
    return None


def float_words(seed: int, n: int, ft: FloatType = BF16) -> np.ndarray:
    """n N(0,1) values of type ft as unsigned words (bench.py's and
    bench/float_benchmark.py's input recipe)."""
    x = np.random.default_rng(seed).normal(0, 1, n)
    if ft == BF16:
        return (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    if ft == FP32:
        return x.astype(np.float32).view(np.uint32)
    if ft == FP64:
        return x.astype(np.float64).view(np.uint64)
    raise ValueError(ft)


def pack_rows(words, cap: int) -> np.ndarray:
    """Arrays of float words (uint16, uint32 or uint64, one type) ->
    uint32[B, ceil(cap * word size / 4)] rows, zero padded."""
    ws = words[0].itemsize
    buf = np.zeros((len(words), -(-cap * ws // 4) * 4), np.uint8)
    for i, w in enumerate(words):
        buf[i, : w.nbytes] = w.view(np.uint8)
    return buf.view(np.uint32)


def golden_input(ft: FloatType = BF16):
    """The phase-4 input of type ft: (float words, uint32[1, W32] rows)."""
    w = float_words(1, GOLDEN_N, ft)
    return w, pack_rows([w], GOLDEN_N)


def archive_sha256(row32: torch.Tensor, comp_bytes: int) -> str:
    """sha256 of the first comp_bytes bytes of one archive row."""
    return hashlib.sha256(
        rows_to_numpy(row32).view(np.uint8)[:comp_bytes].tobytes()
    ).hexdigest()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, warm: int, reps: int) -> float:
    """Median milliseconds of fn() by CUDA events on the current stream."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def max_abs_err(a, b) -> int:
    err = 0
    for x, y in zip(as_tuple(a), as_tuple(b)):
        if x is None and y is None:  # K8's checksum-only form: no histogram
            continue
        check(x.shape == y.shape and x.dtype == y.dtype, "kernel/plain shapes")
        if x.numel():
            d = (x.to(torch.int64) - y.to(torch.int64)).abs().max().item()
            err = max(err, int(d))
    return err


def record_calls(fn):
    """Run fn() with every kernel wrapper recording (args, output)."""
    calls = {w: [] for w, *_ in KERNELS}
    saved = {w: getattr(K, w) for w in calls}

    def recorder(name, orig):
        def rec(*args):
            out = orig(*args)
            calls[name].append((args, out))
            return out
        return rec

    for w, orig in saved.items():
        setattr(K, w, recorder(w, orig))
    try:
        fn()
    finally:
        for w, orig in saved.items():
            setattr(K, w, orig)
    return calls


class MainPath:
    """A main path of the float codec: 16Mi N(0,1) floats of one type,
    batch 1, native row-stream layout."""

    def __init__(self, ft: FloatType, dev: torch.device):
        self.name = ft.name
        self.ft = ft
        self.raw_bytes = FLOAT_WORD_SIZE[ft] * MAIN_N
        self.words = float_words(0, MAIN_N, ft)
        self.d = rows_from_numpy(pack_rows([self.words], MAIN_N), dev)
        self.n = torch.tensor([MAIN_N], dtype=torch.int32, device=dev)
        self.base = torch.zeros(1, dtype=torch.int64, device=dev)

    def compress(self, plain=False):
        return float_compress_core(self.d, self.n, self.ft, PROB_BITS,
                                   plain=plain)

    def decompress(self, out32, plain=False):
        return float_decompress_core(out32, self.base, MAIN_N, self.ft,
                                     PROB_BITS, plain=plain)

    def round_trip_ok(self, res) -> bool:
        words32, success, n_out = res[:3]
        nw = self.d.shape[1]
        return (bool(success.all()) and int(n_out[0]) == MAIN_N
                and torch.equal(words32[:, :nw], self.d)
                and not bool(words32[:, nw:].any()))


class ApiFloatPath:
    """A or C: one 16Mi N(0,1) float tensor through ``compress_data`` /
    ``decompress_data`` with the checksum on; native=None is the default
    layout. plain=True runs the model functions the API calls, all plain,
    on the same packed row."""

    def __init__(self, name, ft: FloatType, native, dev):
        self.name, self.ft, self.native = name, ft, native
        self.layout = True if native is None else native
        self.raw_bytes = FLOAT_WORD_SIZE[ft] * MAIN_N
        words = float_words(0, MAIN_N, ft)
        self.x = floats_from_words(words, _TORCH_DTYPE[ft], dev)
        self.d = rows_from_numpy(pack_rows([words], MAIN_N), dev)
        self.n = torch.tensor([MAIN_N], dtype=torch.int32, device=dev)

    def compress(self, plain=False):
        if plain:
            return float_compress_padded(self.d, self.n, self.ft, PROB_BITS,
                                         True, native=self.layout, plain=True)
        comp, comp_bytes, _ = C.compress_data(
            True, [self.x], checksum=True, prob_bits=PROB_BITS,
            native=self.native)
        return comp, comp_bytes

    def decompress(self, comp, plain=False):
        """-> (decoded tensor, success and checksum agreement)."""
        if plain:
            w, s, _, ca, cg = float_decompress_core(
                comp.view(torch.int32), torch.zeros_like(self.n), MAIN_N,
                self.ft, PROB_BITS, verify_checksum=True, native=self.layout,
                plain=True)
            out = w.view(torch.uint8)[0, : self.raw_bytes].view(self.x.dtype)
            return out, bool(s.all()) and torch.equal(ca, cg)
        outs, _, success, status, _ = C.decompress_data(
            True, comp, [MAIN_N], self.x.dtype, checksum=True,
            prob_bits=PROB_BITS)
        return outs[0], bool(success.all()) and status.ok

    def round_trip_ok(self, res) -> bool:
        out, ok = res
        return ok and out.dtype == self.x.dtype and torch.equal(
            out.view(torch.uint8), self.x.view(torch.uint8))


class ApiRawPath:
    """B or C: the same 32 MiB of bf16 bytes through raw ANS in the API,
    checksum on."""

    def __init__(self, name, native, dev):
        self.name, self.native = name, native
        self.layout = True if native is None else native
        self.raw_bytes = 2 * MAIN_N
        self.x = torch.from_numpy(float_words(0, MAIN_N, BF16).view(np.uint8)).to(dev)
        self.size = torch.tensor([self.raw_bytes], dtype=torch.int32, device=dev)

    def compress(self, plain=False):
        if plain:
            return ans_encode_padded(self.x[None], self.size, PROB_BITS, True,
                                     native=self.layout, plain=True)
        comp, comp_bytes, _ = C.compress_data(
            False, [self.x], checksum=True, prob_bits=PROB_BITS,
            native=self.native)
        return comp, comp_bytes

    def decompress(self, comp, plain=False):
        if plain:
            out, s, n, csum = ans_decode_padded(
                comp, self.raw_bytes, PROB_BITS, native=self.layout, plain=True)
            got = int(byte_hist_plain(out, n)[1][0])
            return out[0], bool(s.all()) and got == int(csum[0])
        outs, _, success, status, _ = C.decompress_data(
            False, comp, [self.raw_bytes], checksum=True, prob_bits=PROB_BITS)
        return outs[0], bool(success.all()) and status.ok

    def round_trip_ok(self, res) -> bool:
        out, ok = res
        return ok and torch.equal(out, self.x)


def golden_sparse_input(key: str):
    """The input of GOLDEN_SPARSE_SHA256[key]: (float type, native, float
    words with the key's share of exact zeros)."""
    ft, native, n, zeros = GOLDEN_SPARSE[key]
    w = float_words(3, n, ft)
    w[np.random.default_rng(4).random(n) < zeros] = 0
    return ft, native, w


class ApiSparsePath:
    """S: S_COUNT members of S_N N(0,1) floats of one type, a S_ZEROS share
    of them exact zeros, through ``compress_data`` / ``decompress_data``
    with sparse=True, prob_bits 9, the checksum on and the default layout
    (native on the card). The data is made on the card from a seed.
    plain=True runs the model functions the API calls, all plain, on the
    same rows."""

    def __init__(self, name, ft: FloatType, dev):
        self.name, self.ft = name, ft
        self.layout = dev.type == "cuda"  # the API's default layout
        self.raw_bytes = FLOAT_WORD_SIZE[ft] * S_N * S_COUNT
        g = torch.Generator(device=dev)
        g.manual_seed(int(ft))
        x = torch.randn((S_COUNT, S_N), generator=g, device=dev,
                        dtype=torch.float64)
        x[torch.rand((S_COUNT, S_N), generator=g, device=dev) < S_ZEROS] = 0
        x = x.to(_TORCH_DTYPE[ft])
        self.xs = list(x.unbind(0))
        self.d = x.view(torch.uint8).view(torch.int32)
        self.n = torch.full((S_COUNT,), S_N, dtype=torch.int32, device=dev)

    def compress(self, plain=False):
        if plain:
            return sparse_float_compress_padded(
                self.d, self.n, self.ft, S_PROB_BITS, True, native=self.layout,
                plain=True)
        comp, comp_bytes, _ = C.compress_data(
            True, self.xs, checksum=True, prob_bits=S_PROB_BITS, sparse=True)
        return comp, comp_bytes

    def decompress(self, comp, plain=False):
        """-> (decoded tensors, success and checksum agreement)."""
        dt = _TORCH_DTYPE[self.ft]
        if plain:
            w, s, _, ca, cg = sparse_float_decompress_core(
                comp.view(torch.int32), S_N, self.ft, S_PROB_BITS,
                verify_checksum=True, native=self.layout, plain=True)
            nb = FLOAT_WORD_SIZE[self.ft] * S_N
            outs = list(w.view(torch.uint8)[:, :nb].contiguous().view(dt))
            return outs, bool(s.all()) and torch.equal(ca, cg)
        outs, _, success, status, _ = C.decompress_data(
            True, comp, [S_N] * S_COUNT, dt, checksum=True,
            prob_bits=S_PROB_BITS, sparse=True)
        return outs, bool(success.all()) and status.ok

    def round_trip_ok(self, res) -> bool:
        outs, ok = res
        return ok and all(
            o.dtype == x.dtype and torch.equal(o.view(torch.uint8), x.view(torch.uint8))
            for o, x in zip(outs, self.xs))


class DecodePath(MainPath):
    """A decode formulation on a core path's archive: the 16Mi N(0,1) floats
    of type ft compressed once at set-up by the kernels, in the native or
    classic layout, then ``float_decompress_core(..., fused=fused)``.
    compress() hands back the set-up archive, so a run of the path is the
    decode alone; decompress_default() is the default formulation."""

    decode_only = True

    def __init__(self, name, ft: FloatType, native: bool, fused: bool, dev):
        super().__init__(ft, dev)
        self.name, self.native, self.fused = name, native, fused
        self.arc, self.comp_bytes = float_compress_core(
            self.d, self.n, ft, PROB_BITS, native=native)

    def compress(self, plain=False):
        return self.arc, self.comp_bytes

    def decompress(self, out32, plain=False):
        return float_decompress_core(out32, self.base, MAIN_N, self.ft,
                                     PROB_BITS, native=self.native,
                                     plain=plain, fused=self.fused)

    def decompress_default(self, out32):
        return float_decompress_core(out32, self.base, MAIN_N, self.ft,
                                     PROB_BITS, native=self.native)


class OpsPhase:
    """O: the ops with no TPU path, at the main paths' sizes: split_packed
    of the 16Mi input of each type and the join back (join16_rows,
    join_wide); chunked_lookup at the bf16 decode's shapes, a [1, 1024] LUT
    and one index per float; rowwise_lookup at one row-walk step, a
    [1024, 5120] table per row and 128 indices a row. Indices run past both
    ends of the tables. The data is made on the card from a seed."""

    name = P_O

    def __init__(self, dev):
        self.rows = {ft: rows_from_numpy(pack_rows([float_words(0, MAIN_N, ft)],
                                                   MAIN_N), dev)
                     for ft in (BF16, FP32, FP64)}
        g = torch.Generator(device=dev)
        g.manual_seed(5)

        def ints(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=g, device=dev,
                                 dtype=torch.int32)

        self.lut = ints(-(1 << 31), (1 << 31) - 1, (1, O_LUT))
        self.lut_idx = ints(-64, O_LUT + 64, (1, MAIN_N))
        self.tabs = ints(-(1 << 31), (1 << 31) - 1, (O_ROWS, O_ROW_WORDS))
        self.tab_idx = ints(-64, O_ROW_WORDS + 64, (O_ROWS, O_LANES))
        # for the profile, each lookup alone and its library call on the same
        # work (``library_call``: ``torch.gather``, the indices clamped at
        # set-up), each in its own loop
        self.lookups = (
            ("chunked lookup", lambda: chunked_lookup(self.lut, self.lut_idx)),
            ("rowwise lookup", lambda: rowwise_lookup(self.tabs, self.tab_idx)),
            ("chunked gather", library_call("chunked_lookup", (self.lut, self.lut_idx))),
            ("rowwise gather", library_call("rowwise_lookup", (self.tabs, self.tab_idx))))
        # for the profile, K1 alone with and without histogram on the bf16
        # rows and on one-bin bf16 data (every exponent byte in one bin)
        one_bin = (1 + 0.2 * torch.rand(MAIN_N, generator=g, device=dev)).to(
            torch.bfloat16).view(torch.int16).view(torch.int32).view(1, -1)
        n = torch.tensor([MAIN_N], dtype=torch.int32, device=dev)
        self.k1_alone = tuple(
            (f"K1 {what} {data}", fn)
            for data, d in (("N(0,1)", self.rows[BF16]), ("one-bin", one_bin))
            for what, fn in (("histogram", lambda d=d: split16_hist(d, n, True)),
                             ("split alone", lambda d=d: split16(d, True))))
        # for the profile, K8 alone on the bf16 rows' 32 MiB of bytes and on
        # as many bytes of one value
        raw = self.rows[BF16].view(torch.uint8)
        one = torch.full_like(raw, 0x3F)
        size = torch.tensor([raw.shape[1]], dtype=torch.int32, device=dev)
        self.k8_alone = (("K8 N(0,1) bf16 bytes", lambda: byte_hist(raw, size)),
                         ("K8 one byte value", lambda: byte_hist(one, size)))

    def run(self):
        """{type: split then join of its rows, "chunked", "rowwise"}."""
        out = {}
        for ft, d in self.rows.items():
            planes, secs = split_packed(d, ft)
            out[ft] = (join16_rows(planes[0], secs[0], True) if ft == BF16
                       else join_wide(planes, *secs, ft))
        out["chunked"] = chunked_lookup(self.lut, self.lut_idx)
        out["rowwise"] = rowwise_lookup(self.tabs, self.tab_idx)
        return out

    def ok(self, out) -> bool:
        return (all(torch.equal(out[ft], d) for ft, d in self.rows.items())
                and torch.equal(out["chunked"],
                                chunked_lookup_plain(self.lut, self.lut_idx))
                and torch.equal(out["rowwise"],
                                rowwise_lookup_plain(self.tabs, self.tab_idx)))


def exponential_bytes(seed: int, n: int, lam: float) -> np.ndarray:
    """n bytes by the reference ANSTest.cu's exponential law, as the CPU
    tests' ``make_exponential_bytes`` draws them, from a seed."""
    x = np.random.default_rng(seed).exponential(scale=256.0 / lam, size=n)
    return np.minimum(x, 255).astype(np.uint8)


def _bits(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def same(a, b) -> bool:
    """Tensors, or tuples of them, equal bit for bit (NaN bits too)."""
    a, b = as_tuple(a), as_tuple(b)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(a, b))


@contextlib.contextmanager
def nccl_world_of_one():
    """Phase P's process group: NCCL, rank 0 of a world of one, meeting
    through a file store in a temporary directory. No other backend is
    tried: without NCCL the run fails."""
    store = tempfile.mkdtemp(prefix="chip_smoke_store.")
    try:
        check(dist.is_nccl_available(), "P: NCCL is not available")
        dist.init_process_group("nccl", init_method=f"file://{store}/store",
                                rank=0, world_size=1)
        torch.cuda.set_device(0)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store, ignore_errors=True)


class ShardedFloatPath:
    """P: the sharded float codec on P_MEMBERS members of P_MEMBER_N N(0,1)
    floats (the rank's block: all of them in a world of one, placed on the
    card by ``shard_batch``): ``float_compress_sharded``,
    ``float_decompress_sharded`` and ``global_compressed_sizes``."""

    def __init__(self, name, ft: FloatType, group, seed: int):
        self.name, self.ft, self.g = name, ft, group
        w = float_words(seed, P_MEMBERS * P_MEMBER_N, ft).reshape(P_MEMBERS, -1)
        self.raw_bytes = w.nbytes
        self.d = SH.shard_batch(group, rows_from_numpy(w.view(np.uint32)))
        self.n = SH.shard_batch(group, torch.full((P_MEMBERS,), P_MEMBER_N,
                                                  dtype=torch.int32))

    def compress(self, plain=False):
        return SH.float_compress_sharded(self.g, self.d, self.n, self.ft,
                                         PROB_BITS, plain=plain)

    def decompress(self, comp, plain=False):
        return SH.float_decompress_sharded(self.g, comp, P_MEMBER_N, self.ft,
                                           PROB_BITS, plain=plain)

    def run(self, plain=False):
        """-> (archives, comp_bytes, words, success, n, global sizes)."""
        comp, cb = self.compress(plain)
        words, ok, n, _, _ = self.decompress(comp, plain)
        return comp, cb, words, ok, n, SH.global_compressed_sizes(cb, self.g)

    def check(self, res):
        comp, cb, words, ok, n, sizes = res
        nw = self.d.shape[1]
        check(bool(ok.all()) and bool((n == P_MEMBER_N).all())
              and torch.equal(words[:, :nw], self.d)
              and not bool(words[:, nw:].any()), f"{self.name}: round trip")
        check(torch.equal(sizes, cb), f"{self.name}: global sizes")
        check(same((comp, cb), float_compress_padded(
            self.d, self.n, self.ft, PROB_BITS, native=False)),
            f"{self.name}: archives equal float_compress_padded(native=False)")
        check(not C.detect_native_layout(True, comp), f"{self.name}: classic")

    def wire_bytes(self, res) -> int:
        return int(res[1].sum())

    def timings(self, res):
        comp, cb = res[:2]
        return (("float_compress_sharded", self.compress),
                ("float_decompress_sharded", lambda: self.decompress(comp)),
                ("global_compressed_sizes",
                 lambda: SH.global_compressed_sizes(cb, self.g)))


class SharedTablePath:
    """P: ``ans_encode_shared_table`` (one K8 histogram, summed by an NCCL
    all-reduce) and ``ans_decode_sharded`` on P_MEMBERS rows of
    P_TABLE_BYTES exponential bytes."""

    name = P_TAB

    def __init__(self, group, seed: int):
        self.g = group
        x = exponential_bytes(seed, P_MEMBERS * P_TABLE_BYTES, P_LAMBDA)
        self.raw_bytes = x.nbytes
        self.x = SH.shard_batch(group, torch.from_numpy(x.reshape(P_MEMBERS, -1)))
        self.sizes = SH.shard_batch(group, torch.full((P_MEMBERS,), P_TABLE_BYTES,
                                                      dtype=torch.int32))

    def compress(self, plain=False):
        return SH.ans_encode_shared_table(self.g, self.x, self.sizes, PROB_BITS,
                                          plain=plain)

    def decompress(self, comp, plain=False):
        return SH.ans_decode_sharded(self.g, comp, P_TABLE_BYTES, PROB_BITS,
                                     plain=plain)

    def run(self, plain=False):
        """-> (archives, comp_bytes, bytes, success, n)."""
        comp, cb = self.compress(plain)
        return (comp, cb) + tuple(self.decompress(comp, plain)[:3])

    def check(self, res):
        comp, cb, out, ok, n = res
        check(bool(ok.all()) and torch.equal(out, self.x)
              and bool((n == P_TABLE_BYTES).all()), f"{self.name}: round trip")
        check(bool((comp[:, 32:544] == comp[:1, 32:544]).all()),
              f"{self.name}: every archive embeds one table")
        hist = byte_hist(self.x, self.sizes)[0].sum(dim=0, dtype=torch.int32)
        tots = torch.full_like(self.sizes, int(self.sizes.sum()))
        check(same((comp, cb), ans_encode_padded(
            self.x, self.sizes, PROB_BITS, hist=hist[None].expand(P_MEMBERS, -1),
            hist_totals=tots, native=False)),
            f"{self.name}: archives equal ans_encode_padded(hist=, hist_totals=)")

    def wire_bytes(self, res) -> int:
        return int(res[1].sum())

    def timings(self, res):
        comp = res[0]
        return (("ans_encode_shared_table", self.compress),
                ("ans_decode_sharded", lambda: self.decompress(comp)))


class CollectivePath:
    """P: one compressed collective on one (1, MAIN_N) piece: in a world of
    one, its output is the piece itself, bit for bit. flag is what the
    piece's payload must ride as (an archive, or raw for random bits), and
    hops how many times the collective sends it (the all-reduce: its
    reduce-scatter's one hop, then its gather)."""

    def __init__(self, name, fn, x, group, flag=CO._FLAG_COMP, hops=1, **kw):
        self.name, self.fn, self.x, self.g = name, fn, x, group
        self.flag, self.hops, self.kw = flag, hops, kw
        self.raw_bytes = x.numel() * x.element_size()

    def run(self, plain=False):
        """-> (output, ok, wire words)."""
        return self.fn(self.x, group=self.g, return_stats=True, plain=plain,
                       **self.kw)

    def check(self, res):
        """The output is the input; the payload of a direct encode has the
        path's flag, and the run's wire is exactly that payload's chunks on
        each hop, so the run sent what the flag says."""
        out, ok, wire = res
        check(bool(ok.all()) and same(out, self.x),
              f"{self.name}: the output equals the input bit for bit")
        w, n, w32 = CO._to_u32(self.x)
        cw = CO._chunk_words(w32, None)
        _, meta = CO._encode_payload(w, n, CO._ft_of(self.x.dtype), PROB_BITS)
        check(int(meta[0]) == self.flag,
              f"{self.name}: the payload rides with flag {int(meta[0])}")
        want = self.hops * -(-int(meta[1]) // cw) * cw
        check(int(wire.sum()) == want,
              f"{self.name}: the run moved {int(wire.sum())} wire words, not "
              f"{want}, the chunks of a flag-{self.flag} payload of "
              f"{int(meta[1])} words on {self.hops} hop(s)")

    def wire_bytes(self, res) -> int:
        return 4 * int(res[2].sum())

    def timings(self, res):
        return ((self.fn.__name__, self.run),)


class ParallelPhase:
    """P: the distributed layer (``dietgpu_fork_torch.parallel``) through
    NCCL in a world of one, on data made from seeds with numpy: the sharded
    float codec (bf16, fp32), the shared-table raw ANS, ``compressed_all_gather``
    of 16Mi bf16, fp32, fp64 and of 16Mi fp32 of uniform random bits (raw,
    flag 2), ``compressed_reduce_scatter`` and ``compressed_all_reduce`` of a
    16Mi fp32 and a 16Mi bf16 addend, ``compressed_ppermute`` of 16Mi bf16
    along [(0, 0)]. Archives are classic, as the JAX package's."""

    def __init__(self):
        g = SH.data_mesh()
        check(dist.get_backend(g) == "nccl" and dist.get_world_size(g) == 1,
              "P: an NCCL world of one")

        def piece(words, dtype):
            return SH.shard_batch(g, floats_from_words(words, dtype)[None])

        x16 = piece(float_words(30, MAIN_N, BF16), torch.bfloat16)
        x32 = piece(float_words(31, MAIN_N, FP32), torch.float32)
        x64 = piece(float_words(32, MAIN_N, FP64), torch.float64)
        bits = piece(np.random.default_rng(33).integers(
            0, 1 << 32, MAIN_N, dtype=np.uint64).astype(np.uint32), torch.float32)
        gather = CO.compressed_all_gather
        rs, ar = CO.compressed_reduce_scatter, CO.compressed_all_reduce
        self.paths = [
            ShardedFloatPath(P_SH16, BF16, g, 20),
            ShardedFloatPath(P_SH32, FP32, g, 21),
            SharedTablePath(g, 22),
            CollectivePath(P_G16, gather, x16, g),
            CollectivePath(P_G32, gather, x32, g),
            CollectivePath(P_G64, gather, x64, g),
            CollectivePath(P_GRAW, gather, bits, g, flag=CO._FLAG_RAW),
            CollectivePath(P_RS32, rs, x32, g),
            CollectivePath(P_RS16, rs, x16, g),
            CollectivePath(P_AR32, ar, x32, g, hops=2),
            CollectivePath(P_AR16, ar, x16, g, hops=2),
            CollectivePath(P_PP16, CO.compressed_ppermute, x16, g, perm=[(0, 0)]),
        ]
        # --profile: the bf16 all-gather and the fp32 all-reduce
        self.profiled = [p for p in self.paths if p.name in (P_G16, P_AR32)]

    def check_profiling(self):
        """``utils.profiling`` on the card: a trace around one all-gather
        writes a file; ``timed`` gives a finite time."""
        g16 = next(p for p in self.paths if p.name == P_G16)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_trace.")
        try:
            with profiling.trace(tmp) as path:
                g16.run()
            size = os.path.getsize(path)
            check(size > 0, "P: profiling.trace wrote no trace")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        ms = profiling.timed(g16.run)
        check(math.isfinite(ms) and ms > 0, f"P: profiling.timed gave {ms}")
        print(f"P: profiling.trace around {g16.name} wrote {size} bytes; "
              f"profiling.timed {ms:.3f} ms (best of 5, fenced)")


def ragged_batch(ft, count, seed, dev):
    """A ragged batch of up to 128Ki floats per member, sizes 0, 1, 4097
    and 128Ki among them: compress on both paths, decode, check."""
    cap = 1 << 17
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, cap, count)
    sizes[:4] = [0, 1, 4097, cap]
    ws = [float_words(seed + 1 + i, int(s), ft) for i, s in enumerate(sizes)]
    d_b = rows_from_numpy(pack_rows(ws, cap), dev)
    n_b = torch.tensor(sizes, dtype=torch.int32, device=dev)
    base_b = torch.zeros(count, dtype=torch.int64, device=dev)
    b_out, b_cb = float_compress_core(d_b, n_b, ft, PROB_BITS)
    bp_out, bp_cb = float_compress_core(d_b, n_b, ft, PROB_BITS, plain=True)
    check(torch.equal(b_out, bp_out) and torch.equal(b_cb, bp_cb),
          f"{ft.name} batch archive equals the all-plain archive")
    bw, bs, bn, _, _ = float_decompress_core(b_out, base_b, cap, ft, PROB_BITS)
    check(bool(bs.all()) and torch.equal(bn.cpu(), torch.from_numpy(sizes)),
          f"{ft.name} batch success")
    check(torch.equal(bw[:, : d_b.shape[1]], d_b), f"{ft.name} batch round trip")
    raw = FLOAT_WORD_SIZE[ft] * int(sizes.sum())
    print(f"{ft.name} batch: {count} members, {int(sizes.sum())} floats, "
          f"ratio {int(b_cb.sum()) / raw:.6f}, exact")


def bytes_sha256(row_u8: torch.Tensor, nbytes: int) -> str:
    """sha256 of the first nbytes of one uint8 archive row."""
    return hashlib.sha256(row_u8[:nbytes].cpu().numpy().tobytes()).hexdigest()


def golden_classic(dev):
    """The classic archives of golden_input(BF16) through the API on dev:
    {GOLDEN_SHA256 key: (archive row, comp_bytes)}."""
    w, _ = golden_input(BF16)
    x = floats_from_words(w, torch.bfloat16, dev)
    f, fb, _ = C.compress_data(True, [x], prob_bits=PROB_BITS, native=False)
    r, rb, _ = C.compress_data(False, [x.view(torch.uint8)], checksum=True,
                               prob_bits=PROB_BITS, native=False)
    return {"bf16_classic": (f[0], int(fb[0])), "raw_classic": (r[0], int(rb[0]))}


def phase_d(dev, card):
    """D: the reference's large batch, 128 x 512Ki bf16 (128 MiB), default
    layout, through compress_data / decompress_data."""
    count, n = D_COUNT, D_N
    xs = [floats_from_words(float_words(1000 + i, n, BF16), torch.bfloat16, dev)
          for i in range(count)]
    comp, comp_bytes, _ = C.compress_data(True, xs, prob_bits=PROB_BITS)
    check(C.detect_native_layout(True, comp, float_type=BF16),
          "D: the default layout on the card is native")
    outs, sizes, success, _, _ = C.decompress_data(
        True, comp, [n] * count, torch.bfloat16, prob_bits=PROB_BITS)
    check(bool(success.all()) and all(int(s) == n for s in sizes),
          "D: success and sizes")
    check(all(torch.equal(o.view(torch.int16), x.view(torch.int16))
              for o, x in zip(outs, xs)), "D: exact round trip")
    c_ms = cuda_ms(lambda: C.compress_data(True, xs, prob_bits=PROB_BITS), 1, 3)
    d_ms = cuda_ms(lambda: C.decompress_data(
        True, comp, [n] * count, torch.bfloat16, prob_bits=PROB_BITS), 1, 3)
    gb = 2 * n * count / 1e9
    print(f"D batch {count} x {n} bf16: ratio "
          f"{int(comp_bytes.sum()) / (2 * n * count):.6f}, exact; compress "
          f"{c_ms:.3f} ms ({gb / (c_ms / 1e3):.3f} GB/s), decompress "
          f"{d_ms:.3f} ms ({gb / (d_ms / 1e3):.3f} GB/s) (median of 3; {card})")


def phase_e(dev):
    """E: the split-size API on one 16Mi bf16 tensor in ragged members
    (odd counts: seam words in the ragged concatenation)."""
    x = floats_from_words(float_words(7, MAIN_N, BF16), torch.bfloat16, dev)
    split = [MAIN_N // 3 + 1, 3, MAIN_N // 4, 1]
    split.append(MAIN_N - sum(split))
    comp, _, _ = C.compress_data_split_size(True, x, split, prob_bits=PROB_BITS)
    out, sizes, success, _, _ = C.decompress_data_split_size(
        True, comp, split, prob_bits=PROB_BITS)
    check(out.device == dev and out.is_contiguous() and out.dtype == torch.bfloat16
          and out.shape == x.shape, "E: one contiguous bf16 CUDA tensor")
    check(torch.equal(out.view(torch.int16), x.view(torch.int16)),
          "E: split-size round trip")
    print(f"E split size: {len(split)} members {split}, exact, one contiguous "
          "CUDA tensor")


def golden_sparse(dev):
    """The GOLDEN_SPARSE_SHA256 archives through sparse_float_compress_core
    on the card, each round-tripped."""
    for key, want in GOLDEN_SPARSE_SHA256.items():
        ft, native, w = golden_sparse_input(key)
        rows = rows_from_numpy(pack_rows([w], w.size), dev)
        n = torch.tensor([w.size], dtype=torch.int32, device=dev)
        out, cb = sparse_float_compress_core(rows, n, ft, PROB_BITS,
                                             native=native)
        digest = archive_sha256(out[0], int(cb[0]))
        check(digest == want, f"{key} golden sparse archive sha256 {digest}")
        dense0 = int(out[0, 4 + bitmap_words(w.size)]) & 0xFFFFFFFF
        ww, ws_, _, _, _ = sparse_float_decompress_core(
            out, w.size, ft, PROB_BITS, native=native)
        check(bool(ws_[0]) and torch.equal(ww[:, : rows.shape[1]], rows),
              f"{key} golden sparse round trip")
        print(f"{key} golden sparse archive: {int(cb[0])} bytes, dense "
              f"header {dense0:#010x}, sha256 matches")


def phase_sparse_classic(dev):
    """One fp32 member of 4Mi floats at 90% zeros in the classic layout:
    the kernel archive against the all-plain archive, the round trip and
    cross-decoding."""
    n = 1 << 22
    w = float_words(11, n, FP32)
    w[np.random.default_rng(12).random(n) < 0.9] = 0
    rows = rows_from_numpy(pack_rows([w], n), dev)
    nt = torch.tensor([n], dtype=torch.int32, device=dev)
    out, cb = sparse_float_compress_core(rows, nt, FP32, PROB_BITS, native=False)
    p_out, p_cb = sparse_float_compress_core(rows, nt, FP32, PROB_BITS,
                                             native=False, plain=True)
    check(torch.equal(out, p_out) and torch.equal(cb, p_cb),
          "classic sparse archive equals the all-plain archive")
    check(not C.detect_native_layout(True, out.view(torch.uint8), sparse=True,
                                     float_type=FP32),
          "classic sparse archive is classic")
    for arc, plain in ((out, True), (p_out, False)):
        ww, ok, _, _, _ = sparse_float_decompress_core(
            arc, n, FP32, PROB_BITS, native=False, plain=plain)
        check(bool(ok[0]) and torch.equal(ww, rows),
              f"classic sparse round trip with plain={plain}")
    print(f"classic sparse fp32 {n} floats at 90% zeros: ratio "
          f"{int(cb[0]) / (4 * n):.6f}, archive == plain, exact both ways")


def ragged_sparse_batch(dev):
    """64 bf16 members of up to 128Ki floats, sizes 0, 1, 4097 and 128Ki
    and shares of zeros 0, 0.5 and 1 among them: the archive against the
    all-plain archive, the round trip, and the API's per-member offsets
    (compress_data_simple / decompress_data_simple)."""
    cap, count = 1 << 17, 64
    rng = np.random.default_rng(21)
    sizes = rng.integers(0, cap, count)
    sizes[:4] = [0, 1, 4097, cap]
    zeros = rng.choice([0.0, 0.5, 0.9, 1.0], count)
    zeros[:6] = [0.5, 0.0, 1.0, 0.5, 0.0, 1.0]
    ws = []
    for i, (s, z) in enumerate(zip(sizes, zeros)):
        w = float_words(22 + i, int(s), BF16)
        w[rng.random(int(s)) < z] = 0
        ws.append(w)
    rows = rows_from_numpy(pack_rows(ws, cap), dev)
    n = torch.tensor(sizes, dtype=torch.int32, device=dev)
    out, cb = sparse_float_compress_core(rows, n, BF16, PROB_BITS)
    p_out, p_cb = sparse_float_compress_core(rows, n, BF16, PROB_BITS, plain=True)
    check(torch.equal(out, p_out) and torch.equal(cb, p_cb),
          "ragged sparse archive equals the all-plain archive")
    ww, ok, nn, _, _ = sparse_float_decompress_core(out, cap, BF16, PROB_BITS)
    check(bool(ok.all()) and torch.equal(nn.cpu(), torch.from_numpy(sizes))
          and torch.equal(ww, rows), "ragged sparse round trip")
    xs = [floats_from_words(w, torch.bfloat16, dev) for w in ws]
    outs = C.decompress_data_simple(
        True, C.compress_data_simple(True, xs, sparse=True), sparse=True)
    check(all(torch.equal(o.view(torch.int16), x.view(torch.int16))
              for o, x in zip(outs, xs)), "ragged sparse API round trip")
    raw = 2 * int(sizes.sum())
    print(f"ragged sparse bf16 batch: {count} members, {int(sizes.sum())} "
          f"floats, ratio {int(cb.sum()) / raw:.6f}, exact, archive == plain")


def phase_f(comp: torch.Tensor):
    """F: a flipped byte of the raw section of A's archive must make
    decompress_data(..., checksum=True) raise RuntimeError."""
    bad = comp.clone()
    bad[0, 4096] ^= 0x5A  # inside the v2 container's raw section (word 128 on)
    try:
        C.decompress_data(True, bad, [MAIN_N], torch.bfloat16, checksum=True,
                          prob_bits=PROB_BITS)
    except RuntimeError as e:
        print(f"F checksum mismatch raised: {str(e)[:100]}")
        return
    raise RuntimeError("check failed: F: a corrupted archive decoded without "
                       "a checksum error")


def print_ptxas(log: str) -> None:
    """ptxas's registers, shared memory and spills per kernel, each line
    under the kernel's name and template arguments (the kernels sit in
    anonymous namespaces, whose mangled names are cut away)."""
    fn = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line.split("'")[1] if "'" in line else line.split()[-1]
            m = re.match(r"_ZN(\d+)_GLOBAL__N_", fn)
            if m:  # _ZN <length><namespace> <length><name>, then template
                # arguments L<type><value>E
                rest = fn[m.start(1) + len(m.group(1)) + int(m.group(1)):]
                k = re.match(r"\d+", rest)
                name, rest = rest[k.end(): k.end() + int(k.group())], rest[k.end() + int(k.group()):]
                targs = re.findall(r"L[a-z](-?\d+)E", rest.split("EEv")[0])
                fn = f"{name}<{','.join(targs)}>" if targs else name
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {fn}: {line.strip().removeprefix('ptxas info    : ')}")


def phase_k3_ragged(dev):
    """K3 against its plain version on ragged runs that exercise its
    tiles: runs and zero-length runs at tile boundaries (8192 words), runs
    spanning many tiles, more runs in a tile than one batch of
    descriptors (256), sources and offsets not congruent mod 4 words, reads
    past a source's ends, bad refs, gaps and a zero tail; an output past
    2^31 words; and more than 8 sources refused."""
    g = np.random.default_rng(31)
    tile = 8192
    base = torch.from_numpy(g.integers(-(1 << 31), 1 << 31, 1 << 21,
                                       dtype=np.int64).astype(np.int32)).to(dev)
    # six sources, some starting 1-3 words past a 16 B boundary
    srcs = [base[k * 300_000 + k % 4: (k + 1) * 300_000 - 5] for k in range(6)]
    cases = {}
    # long runs straddling tiles, zero-length runs on tile boundaries
    dst = [0, tile - 3, tile, tile, 3 * tile + 1, 9 * tile, 9 * tile]
    lens = [tile - 3, 3, 0, 2 * tile + 1, 5 * tile + 7, 0, 40_000]
    ref = [0, 1, 2, 3, 4, 5, 0]
    off = [0, 17, 5, 2, 1 << 17, 9, 290_000]  # the last reads past its end
    cases["tiles"] = (dst, ref, off, lens, 9 * tile + 40_000 + 1000)
    # many short runs: tiles of more than 256 runs, every alignment
    R = 40_000
    ln = g.integers(0, 12, R)
    ln[g.random(R) < 0.2] = 0
    d = np.cumsum(g.integers(0, 3, R) + np.concatenate([[0], ln[:-1]]))
    rf = g.integers(-1, 7, R)  # -1 and 6 are bad refs
    of = g.integers(-3, 300_000, R)
    cases["short"] = (d, rf, of, ln, int(d[-1] + ln[-1]) + 5000)
    # mixed long and short runs, congruent and not
    R = 3000
    ln = np.where(g.random(R) < 0.1, g.integers(0, 60_000, R), g.integers(0, 9, R))
    d = np.cumsum(g.integers(0, 40, R) + np.concatenate([[0], ln[:-1]]))
    rf = g.integers(0, 6, R)
    # half the offsets congruent with the destination (source k starts k % 4
    # words past a 16 B boundary), half anywhere
    of = np.where(g.random(R) < 0.5, (d - rf % 4) % 4, g.integers(0, 240_000, R))
    cases["mixed"] = (d, rf, of, ln, int(d[-1] + ln[-1]) + 17)
    def t(x, dt=torch.int64):
        return torch.as_tensor(np.asarray(x), dtype=dt).to(dev)

    for name, (d, rf, of, ln, out_len) in cases.items():
        args = (srcs, t(d), t(rf, torch.int32), t(of), t(ln), out_len)
        got = K.runs_merge(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, runs_merge_plain(*args)),
              f"K3 ragged case {name} equals its plain version")
        print(f"K3 ragged {name}: {len(ln)} runs, {out_len} words, "
              f"{(out_len + tile - 1) // tile} tiles, equal to plain")
    # past 2^31 output words (8 GiB): a run straddling word 2^31 and one
    # from a misaligned source after it, zeros around them
    big = 1 << 31
    d, ln, of = [big - 500, big + 5000], [1000, 3000], [7, 11]
    out = K.runs_merge(srcs[:2], t(d), t([0, 1], torch.int32), t(of), t(ln),
                       big + 10_000)
    torch.cuda.synchronize()
    check(torch.equal(out[d[0]: d[0] + ln[0]], srcs[0][7: 7 + ln[0]])
          and torch.equal(out[d[1]: d[1] + ln[1]], srcs[1][11: 11 + ln[1]])
          and not bool(out[: d[0]].any()) and not bool(out[big + 500: d[1]].any())
          and not bool(out[d[1] + ln[1]:].any()),
          "K3 past 2^31 output words")
    del out
    print(f"K3 past 2^31 words: {big + 10_000} words out, runs across word "
          "2^31 placed, zeros elsewhere")
    try:
        runs_merge([srcs[0]] * 9, *args[1:])
    except ValueError as e:
        print(f"K3 with 9 sources raised: {e}")
    else:
        raise RuntimeError("check failed: K3 took 9 sources")


def encode_edge_bytes(case: str):
    """One of K2's EDGE_CASES: (uint8[B, EDGE_NB * 4096] rows, int32[B]
    sizes); the bytes past each size are not zero, and must not count.
    - ragged: skewed bytes, sizes 0, 1, 31, 4095, 4097, all but 5 and all;
    - uniform: uniform random bytes, the near-worst-case emissions;
    - single: one byte value a member, which emits nothing;
    - overflow: a member of 16 blocks of one value after a first block that
      holds every byte value 16 times, and one of 17 blocks with that block
      last (the row with dead warps): at prob_bits 11 the 255 rare values
      get pdf 1, so that block emits more than the classic cap of 2560 u16
      while its row stays under the row cap of 10240."""
    rng = np.random.default_rng(40 + EDGE_CASES.index(case))
    n = EDGE_NB * 4096
    if case == "ragged":
        sizes = [0, 1, 31, 4095, 4097, n - 5, n]
        x = np.minimum(rng.exponential(32.0, (len(sizes), n)), 255).astype(np.uint8)
    elif case == "uniform":
        sizes = [n, n - 4097]
        x = rng.integers(0, 256, (2, n)).astype(np.uint8)
    elif case == "single":
        sizes = [n, 3 * 4096 + 1]
        x = np.full((2, n), 0xA5, np.uint8)
        x[1, : sizes[1]] = 0
    elif case == "overflow":
        sizes = [16 * 4096, n]
        x = rng.integers(0, 256, (2, n)).astype(np.uint8)
        x[:, : 16 * 4096] = 0
        every = rng.permutation(np.repeat(np.arange(256), 16)).astype(np.uint8)
        x[0, :4096] = every
        x[1, 16 * 4096:] = every
    else:
        raise ValueError(case)
    return x, np.asarray(sizes, np.int32)


def encode_edge_inputs(case: str, prob_bits: int, dev):
    """K2's arguments for encode_edge_bytes(case) on dev: (x32, sizes,
    packed, magic), the tables normalised from each member's bytes."""
    x, sizes = encode_edge_bytes(case)
    hist = np.stack([np.bincount(r[:s], minlength=256) for r, s in zip(x, sizes)])
    packed, magic, _ = ans_table_plain(
        torch.from_numpy(hist), torch.from_numpy(sizes.astype(np.int64)), prob_bits)
    return (rows_from_numpy(x.view(np.uint32), dev),
            torch.from_numpy(sizes).to(dev), packed.to(dev), magic.to(dev))


def phase_encode_edges(dev):
    """K2 in both layouts and K14 rowwise against their plain versions on
    edge inputs, bit for bit: EDGE_CASES at prob_bits 9 and 11 (the ragged
    case also with rows only 4 B aligned), with the overflow case's block
    past the classic cap checked; then rowwise lookups of EDGE_LOOKUPS."""
    for pb in EDGE_PROB_BITS:
        for case in EDGE_CASES:
            x32, sizes, packed, magic = encode_edge_inputs(case, pb, dev)
            rows = [x32]
            if case == "ragged":
                flat = torch.zeros(x32.numel() + 1, dtype=torch.int32, device=dev)
                rows.append(flat[1:].view(x32.shape))
                rows[1].copy_(x32)
            for x in rows:
                for fn, plain in ((encode_rows, encode_rows_plain),
                                  (encode_blocks, encode_blocks_plain)):
                    got = fn(x, sizes, packed, magic, pb)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, plain(x, sizes, packed, magic, pb))
                    check(err == 0, f"{fn.__name__} on the {case} edge at prob_bits "
                                     f"{pb} (rows at {x.data_ptr() % 16} mod 16 B) "
                                     f"differs from its plain version by {err}")
            nw = got[2]
            if case == "overflow" and pb == 11:
                first, last = int(nw[0, 0]), int(nw[1, EDGE_NB - 1])
                check(min(first, last) > 2560 and int(nw[0, :4].sum()) < 10240,
                      f"overflow edge: blocks of {first} and {last} u16 pass "
                      "the classic cap under the row cap")
                print(f"K2 overflow edge: the all-values block emits {first} / "
                      f"{last} u16 (classic cap 2560), its row "
                      f"{int(nw[0, :4].sum())} (row cap 10240)")
            if case == "single":
                check(not bool(nw.any()), "a single-symbol member emits nothing")
        print(f"K2 edges at prob_bits {pb}: {', '.join(EDGE_CASES)}, row and "
              "classic layouts, equal to plain")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    for r, k, aligned in EDGE_LOOKUPS:
        tabs = torch.randint(-(1 << 31), (1 << 31) - 1, (r, EDGE_H), generator=g,
                             device=dev, dtype=torch.int32)
        idx = torch.randint(-50, EDGE_H + 50, (r, k), generator=g, device=dev,
                            dtype=torch.int32)
        if not aligned:
            flat = torch.zeros(r * k + 1, dtype=torch.int32, device=dev)
            flat[1:].view(r, k).copy_(idx)
            idx = flat[1:].view(r, k)
        got = rowwise_lookup(tabs, idx)
        torch.cuda.synchronize()
        check(torch.equal(got, rowwise_lookup_plain(tabs, idx)),
              f"rowwise_lookup [{r}, {k}] (idx at {idx.data_ptr() % 16} mod 16 B) "
              "equals its plain version")
    print(f"K14 rowwise edges {EDGE_LOOKUPS} (rows, k, aligned), tables of "
          f"{EDGE_H} words, indices past both ends: equal to plain")


def sparse_edge_inputs(case: str, ft, dev):
    """One of SPARSE_EDGE_CASES in float type ft on dev: (data32 int32[B,
    W32] rows, n int64[B], bm32 their bitmap (``pack_bitmap_plain``), nz32
    K11's nonzero rows, out_floats).
    - ragged: SPARSE_EDGE_MEMBERS in rows of the largest member's floats,
      so rows 1 on start off 16 B boundaries; member 3 keeps an odd count
      of its first 8192 floats, so in 16-bit floats the run of its second
      tile starts at an odd slot; nz32 is K10's plain output and out_floats
      the largest member;
    - overread: the same, but nz32 holds SPARSE_EDGE_NZ_WORDS words, so
      most members' ranks run past its floats, and out_floats is 3 below
      the largest member, which so passes it;
    - aligned: SPARSE_EDGE_ALIGNED in rows of 16384 floats, 16 B aligned."""
    aligned = case == "aligned"
    members = SPARSE_EDGE_ALIGNED if aligned else SPARSE_EDGE_MEMBERS
    rng = np.random.default_rng(60 + int(aligned))
    ws = []
    for i, (count, zeros) in enumerate(members):
        w = float_words(70 + i, count, ft)
        w[rng.random(count) < zeros] = 0
        ws.append(w)
    if not aligned and np.count_nonzero(ws[3][:8192]) % 2 == 0:
        ws[3][0] = 0 if ws[3][0] else 1
    cap = max(count for count, _ in members)
    data32 = rows_from_numpy(pack_rows(ws, cap), dev)
    n = torch.tensor([count for count, _ in members], dtype=torch.int64, device=dev)
    bm32 = pack_bitmap_plain(data32, n, ft)
    nz32 = compact_by_bitmap_plain(data32, bm32, word_ranks_plain(bm32, n), ft)[0]
    if case == "overread":
        return data32, n, bm32, nz32[:, :SPARSE_EDGE_NZ_WORDS].contiguous(), cap - 3
    return data32, n, bm32, nz32, cap


def phase_sparse_edges(dev):
    """K9, K15, K10 and K11 against their plain versions, bit for bit, on
    SPARSE_EDGE_CASES in bf16, fp32 and fp64, each kernel launched once a
    case; checks that the edges are there (an odd run start in bf16, ranks
    past the nonzero row)."""
    for case in SPARSE_EDGE_CASES:
        for ft in (BF16, FP32, FP64):
            data32, n, bm32, nz32, out_floats = sparse_edge_inputs(case, ft, dev)
            torch.cuda.synchronize()
            K.reset_launches()
            bm = pack_bitmap(data32, n, ft)
            ranks = word_ranks(bm32, n)
            packed = compact_by_bitmap(data32, bm32, ranks, ft)
            out = expand_by_bitmap(nz32, bm32, ranks, n, out_floats, ft)
            torch.cuda.synchronize()
            ran = {c: K.launches[c] for c in ("bitmap_pack", "word_ranks",
                                              "sparse_compact", "sparse_expand")}
            check(all(v == 1 for v in ran.values()),
                  f"sparse edge {case} {ft.name}: launches {ran}")
            p_ranks = word_ranks_plain(bm32, n)
            for name, got, want in (
                    ("pack_bitmap", bm, bm32),
                    ("word_ranks", ranks, p_ranks),
                    ("compact_by_bitmap", packed,
                     compact_by_bitmap_plain(data32, bm32, p_ranks, ft)),
                    ("expand_by_bitmap", out, expand_by_bitmap_plain(
                        nz32, bm32, p_ranks, n, out_floats, ft))):
                err = max_abs_err(got, want)
                check(err == 0, f"{name} on the {case} edge in {ft.name} "
                                f"differs from its plain version by {err}")
            nz_cap = 4 * nz32.shape[1] // _ws(ft)
            if case == "overread":
                check(int(ranks[:, -1].max()) > nz_cap,
                      "overread edge: ranks past the nonzero row")
            if case == "ragged" and ft == BF16:
                check(int(ranks[3, 256]) % 2 == 1,
                      "ragged edge: a bf16 run starts at an odd slot")
        print(f"sparse edges {case}: K9, K15, K10, K11 in bf16, fp32, fp64 equal "
              f"to plain (n {n.tolist()}, nnz {ranks[:, -1].tolist()}, "
              f"out_floats {out_floats}, K11 rows of {nz_cap} fp64 floats)")


def phase_misaligned(dev):
    """The in-place decode at archive offsets that are not 16 B aligned:
    the golden inputs' archives shifted by 1-3 words in wider rows, decoded
    in both layouts, bf16 fused and two-pass, fp32 fused and two-pass (K7's
    archive mode), fp64 two-pass, equal to the aligned decode and to the
    plain decode."""
    for ft, fused in ((BF16, True), (FP32, True), (BF16, False), (FP32, False),
                      (FP64, False)):
        rows = rows_from_numpy(golden_input(ft)[1], dev)
        n = torch.tensor([GOLDEN_N], dtype=torch.int32, device=dev)
        for native in (True, False):
            arc, _ = float_compress_core(rows, n, ft, PROB_BITS, native=native)
            want = float_decompress_core(
                arc, torch.zeros(1, dtype=torch.int64, device=dev), GOLDEN_N,
                ft, PROB_BITS, native=native, fused=fused)
            for shift in (1, 2, 3):
                wide = torch.zeros((1, arc.shape[1] + 4), dtype=torch.int32,
                                   device=dev)
                wide[:, shift: shift + arc.shape[1]] = arc
                base = torch.full((1,), shift, dtype=torch.int64, device=dev)
                for plain in (False, True):
                    got = float_decompress_core(wide, base, GOLDEN_N, ft,
                                                PROB_BITS, native=native,
                                                fused=fused, plain=plain)
                    check(all(torch.equal(x, y) for x, y in zip(got, want))
                          and bool(got[1][0]),
                          f"{ft.name} native={native} fused={fused} decode at "
                          f"word {shift} (plain={plain})")
    print("misaligned decode: bf16 and fp32 fused and two-pass, fp64 "
          "two-pass, both layouts, archives at words 1-3, equal to the "
          "aligned decode and to the plain decode")


def split16_edge_inputs(ft, one_bin: bool, dev):
    """K1's edge inputs in bf16 or fp16 on dev: (data32 int32[B,
    SPLIT16_EDGE_W32], N(0,1) or, with one_bin, in [1, 1.2) (every exponent
    byte in one bin, in either type), random floats past each count too;
    n int32[B], the SPLIT16_EDGE_COUNTS)."""
    rng = np.random.default_rng(100 + 2 * int(ft) + int(one_bin))
    B, cap = len(SPLIT16_EDGE_COUNTS), 2 * SPLIT16_EDGE_W32
    x = 1 + 0.2 * rng.random((B, cap)) if one_bin else rng.normal(0, 1, (B, cap))
    if ft == BF16:
        words = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    else:
        words = x.astype(np.float16).view(np.uint16)
    data32 = rows_from_numpy(pack_rows(list(words), cap), dev)
    return data32, torch.tensor(SPLIT16_EDGE_COUNTS, dtype=torch.int32, device=dev)


def phase_split16_edges(dev):
    """K1 with and without histogram against its plain versions, bit for
    bit, on ``split16_edge_inputs`` in bf16 and fp16, N(0,1) and one-bin
    data, each launched once a case: the rows where they lie (odd rows 8 B
    past a 16 B boundary) and copied to bases 4 and 8 B past one (a tile's
    pairs each alone)."""
    for ft in (BF16, FP16):
        bf16 = ft == BF16
        for one_bin in (False, True):
            data32, n = split16_edge_inputs(ft, one_bin, dev)
            what = f"{ft.name} {'one-bin' if one_bin else 'N(0,1)'}"
            for shift in (0, 1, 2):
                x = data32
                if shift:
                    flat = torch.zeros(data32.numel() + shift, dtype=torch.int32,
                                       device=dev)
                    x = flat[shift:].view(data32.shape)
                    x.copy_(data32)
                torch.cuda.synchronize()
                K.reset_launches()
                got_h = split16_hist(x, n, bf16)
                got_s = split16(x, bf16)
                torch.cuda.synchronize()
                ran = {c: K.launches[c] for c in ("split16_hist", "split16")}
                check(all(v == 1 for v in ran.values()),
                      f"split16 edge {what} at {x.data_ptr() % 16} mod 16 B: "
                      f"launches {ran}")
                for name, got, want in (
                        ("split16_hist", got_h, split16_hist_plain(x, n, bf16)),
                        ("split16", got_s, split16_plain(x, bf16))):
                    err = max_abs_err(got, want)
                    check(err == 0, f"{name} on the {what} edge at "
                                    f"{x.data_ptr() % 16} mod 16 B differs from "
                                    f"its plain version by {err}")
            if one_bin:
                hist = got_h[2]
                check(bool(((hist > 0).sum(dim=1) <= 1).all()) and int(hist.sum()) > 0,
                      f"one-bin edge: {ft.name} exponent bytes in one bin")
        print(f"split16 edges {ft.name}: K1 with and without histogram, N(0,1) "
              f"and one-bin, counts {list(SPLIT16_EDGE_COUNTS)} in rows of "
              f"{SPLIT16_EDGE_W32} words, bases at 0, 4 and 8 mod 16 B: equal "
              "to plain")


def wide_edge_inputs(ft, one_bin: bool, dev):
    """K5's and K7's edge inputs in fp32 or fp64 on dev: (data32 int32[B,
    W32], rows of WIDE_EDGE_CAP floats, N(0,1) or, with one_bin, in [1, 2)
    (fp64's plane-0 bytes in one bin), random bytes past each count; n
    int32[B], the WIDE_EDGE_COUNTS clamped to the row; count int64[B], the
    WIDE_EDGE_COUNTS themselves)."""
    rng = np.random.default_rng(80 + 2 * int(ft) + int(one_bin))
    B, cap = len(WIDE_EDGE_COUNTS), WIDE_EDGE_CAP
    x = 1 + rng.random((B, cap)) if one_bin else rng.normal(0, 1, (B, cap))
    words = x.astype(np.float32 if ft == FP32 else np.float64).view(
        np.uint32 if ft == FP32 else np.uint64)
    data32 = rows_from_numpy(pack_rows(list(words), cap), dev)
    count = torch.tensor(WIDE_EDGE_COUNTS, dtype=torch.int64, device=dev)
    return data32, count.clamp(max=cap).to(torch.int32), count


def wide_edge_archive(sec1, sec2, dev):
    """The sections of every member laid in one archive row: member b's
    sec1 row at a word phase of b % 4 within 16 B, its sec2 row 1-3 words
    after it, random words between; the archive ends inside the last
    member's sec2. -> (comp32 int32[1, W], s1_off, s2_off int64[B])."""
    B = sec1.shape[0]
    rng = np.random.default_rng(90)
    at, offs = 0, []
    for b in range(B):
        o1 = -(-at // 4) * 4 + b % 4
        o2 = o1 + sec1.shape[1] + 1 + b % 3
        offs.append((o1, o2))
        at = o2 + sec2.shape[1] + 5
    end = offs[-1][1] + sec2.shape[1] // 2
    flat = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, end, dtype=np.int64)
                            .astype(np.int32)).to(dev)
    for b, (o1, o2) in enumerate(offs):
        flat[o1: o1 + sec1.shape[1]] = sec1[b]
        w = min(sec2.shape[1], end - o2)
        flat[o2: o2 + w] = sec2[b, :w]
    o = torch.tensor(offs, dtype=torch.int64, device=dev)
    return flat.reshape(1, -1), o[:, 0].contiguous(), o[:, 1].contiguous()


def phase_wide_edges(dev):
    """K5 (with and without histograms) and K7 (archive and tensor modes)
    against their plain versions, bit for bit, on ``wide_edge_inputs`` in
    fp32 and fp64, N(0,1) and one-bin data, each launched once a case; the
    archive mode reads sections at every word phase, past the counts'
    tiles and, for the last member, past the archive's end."""
    for ft in (FP32, FP64):
        for one_bin in (False, True):
            data32, n, count = wide_edge_inputs(ft, one_bin, dev)
            torch.cuda.synchronize()
            K.reset_launches()
            got_h = split_wide_hist(data32, n, ft)
            got_s = split_wide(data32, ft)
            exp, sec1, sec2 = got_h[:3]
            B = data32.shape[0]
            planes = list(exp.reshape(-1, B, exp.shape[1]))
            comp32, s1_off, s2_off = wide_edge_archive(sec1, sec2, dev)
            got_at = join_wide_at(comp32, planes, s1_off, s2_off, count, ft)
            got_t = join_wide(planes, sec1, sec2, ft)
            torch.cuda.synchronize()
            ran = {c: K.launches[c] for c in ("split_wide_hist", "split_wide",
                                              "join_wide_at", "join_wide")}
            what = f"{ft.name} {'one-bin' if one_bin else 'N(0,1)'}"
            check(all(v == 1 for v in ran.values()),
                  f"wide edge {what}: launches {ran}")
            for name, got, want in (
                    ("split_wide_hist", got_h, split_wide_hist_plain(data32, n, ft)),
                    ("split_wide", got_s, split_wide_plain(data32, ft)),
                    ("join_wide_at", got_at, join_wide_at_plain(
                        comp32, planes, s1_off, s2_off, count, ft)),
                    ("join_wide", got_t, join_wide_plain(planes, sec1, sec2, ft))):
                err = max_abs_err(got, want)
                check(err == 0, f"{name} on the {what} edge differs from its "
                                f"plain version by {err}")
            # below each count the archive mode gives back the input (but the
            # last member, whose sections the archive's end cuts)
            keep = torch.arange(data32.shape[1], device=dev)[None] < (
                _ws(ft) // 4 * n.to(torch.int64))[:, None]
            check(torch.equal(torch.where(keep, data32, 0)[:-1],
                              got_at[:-1, : data32.shape[1]]),
                  f"wide edge {what}: archive-mode join returns the input")
            if one_bin and ft == FP64:
                h0 = got_h[3][:B]  # plane 0
                check(bool(((h0 > 0).sum(dim=1) <= 1).all()) and int(h0.sum()) > 0,
                      "one-bin edge: fp64 plane 0 in one bin")
        print(f"wide edges {ft.name}: K5 with and without histograms, K7 "
              f"archive and tensor modes, N(0,1) and one-bin, counts "
              f"{list(WIDE_EDGE_COUNTS)} in rows of {WIDE_EDGE_CAP}: equal to "
              "plain")


def join16_edge_inputs(ft, dev):
    """K13's edge inputs in bf16 or fp16 on dev: (data32 int32[B,
    2 JOIN16_EDGE_E], N(0,1) floats, random past each count too; count
    int64[B], the JOIN16_EDGE_COUNTS)."""
    rng = np.random.default_rng(110 + int(ft))
    B, cap = len(JOIN16_EDGE_COUNTS), 4 * JOIN16_EDGE_E
    x = rng.normal(0, 1, (B, cap))
    if ft == BF16:
        words = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    else:
        words = x.astype(np.float16).view(np.uint16)
    data32 = rows_from_numpy(pack_rows(list(words), cap), dev)
    return data32, torch.tensor(JOIN16_EDGE_COUNTS, dtype=torch.int64, device=dev)


def join16_edge_archive(raw, dev):
    """The raw sections of every member laid in one archive row, as the
    float container places them: member b's base 1 + b % 3 words past a
    16 B boundary, its section 8 (v1, b even) or 128 (v2, b odd) words
    past it, random words between; the archive ends half way into the last
    member's section. -> (comp32 int32[1, W], r_off int64[B])."""
    B, E = raw.shape
    rng = np.random.default_rng(120)
    at, offs = 0, []
    for b in range(B):
        base = -(-at // 4) * 4 + 1 + b % 3
        offs.append(base + (8 if b % 2 == 0 else 128))
        at = offs[-1] + E + 3
    end = offs[-1] + E // 2
    flat = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, end, dtype=np.int64)
                            .astype(np.int32)).to(dev)
    for b, o in enumerate(offs):
        w = min(E, end - o)
        flat[o: o + w] = raw[b, :w]
    return flat.reshape(1, -1), torch.tensor(offs, dtype=torch.int64, device=dev)


def _phased_rows(t, stride: int, shift: int):
    """t's rows copied into a flat buffer at row stride `stride` words,
    the first `shift` words in: rows at changing 4 B phases of 16 B."""
    B, W = t.shape
    flat = torch.zeros(shift + B * stride, dtype=t.dtype, device=t.device)
    v = flat[shift:].as_strided((B, W), (stride, 1))
    v.copy_(t)
    return v


def phase_join16_edges(dev):
    """K13 in both modes against its plain versions, bit for bit, on
    ``join16_edge_inputs`` in bf16 and fp16, each launched once a type: the
    archive mode on ``join16_edge_archive`` (sections at word phases 1-3,
    v1 and v2 offsets, the last cut by the archive's end), the tensor mode
    on plane and raw rows at changing word phases. Below each count the
    archive mode gives back the input, and zeros from it on."""
    E = JOIN16_EDGE_E
    for ft in (BF16, FP16):
        bf16 = ft == BF16
        data32, count = join16_edge_inputs(ft, dev)
        plane, raw = split16_plain(data32, bf16)
        comp32, r_off = join16_edge_archive(raw, dev)
        plane_v = _phased_rows(plane, E, 3)
        raw_v = _phased_rows(raw, E + 2, 1)
        torch.cuda.synchronize()
        K.reset_launches()
        got_at = join16_at(comp32, plane, r_off, count, ft)
        got_t = join16_rows(plane_v, raw_v, bf16)
        torch.cuda.synchronize()
        ran = {c: K.launches[c] for c in ("join16_at", "join16")}
        check(all(v == 1 for v in ran.values()),
              f"join16 edge {ft.name}: launches {ran}")
        for name, got, want in (
                ("join16_at", got_at, join16_at_plain(comp32, plane, r_off, count, ft)),
                ("join16_rows", got_t, join16_rows_plain(plane_v, raw_v, bf16))):
            err = max_abs_err(got, want)
            check(err == 0, f"{name} on the {ft.name} edge differs from its "
                            f"plain version by {err}")
        check(torch.equal(got_t, data32), f"join16 edge {ft.name}: tensor mode "
                                          "returns the input")
        keep = torch.arange(4 * E, device=dev)[None] < count[:, None]
        d16, g16 = data32.view(torch.int16), got_at.view(torch.int16)
        check(torch.equal(torch.where(keep, d16, 0)[:-1], g16[:-1])
              and not bool(torch.where(keep, 0, g16).any()),
              f"join16 edge {ft.name}: archive mode returns the input below "
              "each count, zeros from it on")
        print(f"join16 edges {ft.name}: K13 archive and tensor modes, counts "
              f"{list(JOIN16_EDGE_COUNTS)} in rows of {E} plane words, sections "
              "at word phases 1-3, v1 and v2 offsets: equal to plain")


def hist_edge_inputs(case: str, dev):
    """K8's edge inputs on dev: (rows uint8[B, S], sizes int32[B]). Cases
    "0x00" and "0x3f": rows of that byte, HIST_EDGE_ONE_SIZES, S the last
    size; "ragged": N(0,1) bf16 bytes, HIST_EDGE_RAGGED, S the second last
    (no multiple of 16), the last size past the row."""
    if case == "ragged":
        sizes, S = HIST_EDGE_RAGGED, HIST_EDGE_RAGGED[-2]
        B = len(sizes)
        rows = float_words(130, B * S // 2 + 1, BF16).view(np.uint8)[: B * S]
        rows = torch.from_numpy(rows.reshape(B, S).copy()).to(dev)
    else:
        sizes, S = HIST_EDGE_ONE_SIZES, HIST_EDGE_ONE_SIZES[-1]
        rows = torch.full((len(sizes), S), int(case, 16), dtype=torch.uint8,
                          device=dev)
    return rows, torch.tensor(sizes, dtype=torch.int32, device=dev)


def checksum_edge_inputs(case, dev):
    """(rows uint8[B, W], a view of rows ``stride`` bytes apart starting
    ``off`` bytes past a 16 B boundary; sizes int64[B], one of
    CSUM_EDGE_SIZES a row) for the CSUM_EDGE_ROWS entry ``case``, random
    bytes on dev."""
    _, W, stride, off = next(r for r in CSUM_EDGE_ROWS if r[0] == case)
    B = len(CSUM_EDGE_SIZES)
    g = torch.Generator(device=dev)
    g.manual_seed(W)
    buf = torch.randint(0, 256, (16 + B * stride,), generator=g,
                        dtype=torch.uint8, device=dev)
    rows = buf[off: off + B * stride].view(B, stride)[:, :W]
    sizes = [W if s == "full" else W + 9 if s == "past" else s
             for s in CSUM_EDGE_SIZES]
    return rows, torch.tensor(sizes, dtype=torch.int64, device=dev)


def phase_checksum_edges(dev):
    """K8's checksum-only form (``checksum_rows`` on the card) against the
    torch folds ``checksum_batched`` and, on rows of whole aligned words,
    ``checksum_packed``, bit for bit, on ``checksum_edge_inputs``: one
    launch a case, on the rows in place."""
    for case, W, _, off in CSUM_EDGE_ROWS:
        rows, sizes = checksum_edge_inputs(case, dev)
        torch.cuda.synchronize()
        K.reset_launches()
        got = checksum_rows(rows, sizes)
        torch.cuda.synchronize()
        check(K.launches["byte_hist"] == 1 and sum(K.launches.values()) == 1,
              f"checksum edge {case}: launches {K.launches}")
        check(torch.equal(got, checksum_batched(rows, sizes)),
              f"checksum edge {case}: K8 differs from checksum_batched")
        if W % 4 == 0 and off % 4 == 0 and rows.stride(0) % 4 == 0:
            words = to_u32(rows.contiguous().view(torch.int32))
            check(torch.equal(got, checksum_packed(words, sizes)),
                  f"checksum edge {case}: K8 differs from checksum_packed")
        print(f"checksum edges {case}: K8 checksum-only, rows of {W} bytes "
              f"{rows.stride(0)} apart, {off} past 16 B, sizes "
              f"{sizes.tolist()}: equal to the folds")


def time_checksum_form(dev, card: str) -> None:
    """K8's checksum-only form at sparse_fp64.b5x15m's verify: 5 decoded
    rows of 30M words (8E, E = 3.75M), about 7.5M live fp64 each; per call,
    the mean of 20 calls in a row by CUDA events, beside its bound (the
    live bytes read once) and the torch fold it replaces."""
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    E = -(-S_N // 4)
    words32 = torch.randint(-2**31, 2**31 - 1, (S_COUNT, 8 * E), generator=g,
                            dtype=torch.int32, device=dev)
    nnz = torch.tensor([7_500_000 + 997 * b for b in range(S_COUNT)],
                       dtype=torch.int64, device=dev)
    nbytes = 8 * nnz
    rows = words32.view(torch.uint8)
    want = checksum_packed(to_u32(words32), nbytes)
    check(torch.equal(checksum_rows(rows, nbytes), want),
          "b5x15m-shape checksum: K8 differs from checksum_packed")
    reps = 20
    k8 = cuda_ms(lambda: [K.byte_hist(rows, nbytes, False) for _ in range(reps)],
                 2, 5) / reps
    op = cuda_ms(lambda: [checksum_rows(rows, nbytes) for _ in range(reps)],
                 2, 5) / reps
    fold = cuda_ms(lambda: checksum_packed(to_u32(words32), nbytes), 1, 3)
    b_ms = (int(nbytes.sum()) + 16 * S_COUNT) / HBM_BYTES_PER_S * 1e3
    print(f"K8 checksum-only at b5x15m's verify ({S_COUNT} rows of {8 * E} "
          f"words, {int(nbytes.sum())} live bytes): kernel {k8:.4f} ms, "
          f"checksum_rows {op:.4f} ms, bound {b_ms:.4f} ms "
          f"({100 * b_ms / k8:.1f}% of it), the torch fold it replaces "
          f"{fold:.3f} ms ({card})")
    del words32, rows, want


@functools.lru_cache(maxsize=None)
def parse_edge_archives(native: bool, prob_bits: int) -> np.ndarray:
    """K16's edge batch unbroken: the archives of PARSE_EDGE_SIZES
    exponential bytes, made by the plain encoder on the CPU, each at word
    PARSE_EDGE_BASES[b] of its row (uint32[B, CW])."""
    cap = PARSE_EDGE_NB * 4096
    x = np.zeros((len(PARSE_EDGE_SIZES), cap), np.uint8)
    for b, n in enumerate(PARSE_EDGE_SIZES):
        x[b, :n] = exponential_bytes(1000 * prob_bits + 10 * native + b, n, 3.0)
    out, _ = ans_encode_core(rows_from_numpy(x.view(np.uint32)),
                             torch.tensor(PARSE_EDGE_SIZES, dtype=torch.int32),
                             prob_bits, s_bytes=cap, native=native, plain=True)
    arc = rows_to_numpy(out)
    rows = np.zeros((len(PARSE_EDGE_SIZES), arc.shape[1] + max(PARSE_EDGE_BASES) + 5),
                    np.uint32)
    for b, o in enumerate(PARSE_EDGE_BASES):
        rows[b, o: o + arc.shape[1]] = arc[b]
    rows.setflags(write=False)  # cached: each case breaks a copy
    return rows


def parse_edge_rows(rule: str, native: bool, prob_bits: int):
    """One of K16's edge cases: (rows uint32[B, CW], out_capacity,
    capacities int32[B] or None, expect_n int64[B] or None), the batch with
    rule applied to member 0 (PARSE_EDGE_RULES)."""
    rows = parse_edge_archives(native, prob_bits).copy()
    nb0, base = -(-PARSE_EDGE_SIZES[0] // 4096), PARSE_EDGE_BASES[0]
    hdr = rows[0, base: base + 8]  # views: writes go into rows
    pw = rows[0, base + 8: base + 136]
    bw = rows[0, base + 136 + 32 * nb0:][: 2 * nb0]  # (x, y) a block
    sizes = list(PARSE_EDGE_SIZES)
    out_capacity, caps, expect = PARSE_EDGE_NB * 4096, None, None
    total = int(hdr[3])
    if rule == "magic":
        hdr[0] ^= 0x10000
    elif rule == "prob_bits":
        hdr[4] = (int(hdr[4]) & ~0xF) | (11 if prob_bits == 9 else 9)
    elif rule == "nb_vs_n":
        hdr[1] += 1
    elif rule == "nb_huge":
        hdr[1] = 0x7FFFFFFF
    elif rule == "n_negative":
        hdr[2] = 0xFFFFF000
    elif rule == "total_negative":
        hdr[3] = 0x80000001
    elif rule == "past_row":
        hdr[3] = 2 * rows.shape[1]
    elif rule == "capacity":
        caps = torch.tensor([sizes[0] - 1] + sizes[1:], dtype=torch.int32)
    elif rule == "count_worst":  # block 0 past the worst case of 2560 u16
        bw[0] = (int(bw[0]) & 0xFFFF0000) | 2561
    elif rule == "fill":  # block 5 holds 77 bytes, not 78
        bw[10] = int(bw[10]) + (1 << 16)
    elif rule == "start_negative":  # block 2's start
        bw[5] = 0xFFFFFFF0
    elif rule == "extent":  # block 1's extent past total_w
        bw[3] = total
    elif rule == "row_sum":
        # the second row's blocks 4 and 5 pass one by one, not together
        c4, c5 = int(bw[8]) & 0xFFFF, int(bw[10]) & 0xFFFF
        check(c4 > 0 and c5 > 0, "K16 edges: row_sum needs two counts")
        bw[9] = bw[11] = total - max(c4, c5)
    elif rule == "expect_n":
        expect = torch.tensor([sizes[0] + 1] + sizes[1:])
    elif rule == "expect_n_ok":
        expect = torch.tensor(sizes)
    elif rule == "caps_past_out":  # member 0's blocks 4 and 5 are not read
        out_capacity, caps = 4 * 4096, torch.tensor([PARSE_EDGE_NB * 4096] * 4)
    elif rule == "pdf_short":
        pw[int(np.flatnonzero(pw & 0xFFFF)[0])] -= 1
    elif rule == "pdf_zero":
        pw[:] = 0
    elif rule != "none":
        raise ValueError(rule)
    return rows, out_capacity, caps, expect


def parse_edge_inputs(rule: str, native: bool, prob_bits: int, dev):
    """ans_parse's arguments for parse_edge_rows(rule, native, prob_bits)
    on dev."""
    rows, out_capacity, caps, expect = parse_edge_rows(rule, native, prob_bits)
    return (rows_from_numpy(rows, dev), torch.tensor(PARSE_EDGE_BASES, device=dev),
            out_capacity, None if caps is None else caps.to(dev), prob_bits,
            native, None if expect is None else expect.to(dev))


def phase_parse_edges(dev):
    """K16 against its plain version, every field and the table bit for
    bit, on parse_edge_inputs: each rule in both layouts at prob_bits 9-11,
    one launch a case; member 0 alone fails, by each failure rule."""
    for rule, native in PARSE_EDGE_CASES:
        for pb in PARSE_EDGE_PROB_BITS:
            args = parse_edge_inputs(rule, native, pb, dev)
            torch.cuda.synchronize()
            K.reset_launches()
            got = ans_parse(*args)
            torch.cuda.synchronize()
            what = f"K16 edge {rule} native={native} prob_bits {pb}"
            check(K.launches["ans_parse"] == 1 and sum(K.launches.values()) == 1,
                  f"{what}: launches {K.launches}")
            check(max_abs_err(tuple(got), tuple(ans_parse_plain(*args))) == 0,
                  f"{what}: K16 differs from the plain parse")
            check(got.success.tolist() == [rule in PARSE_EDGE_PASS] + [True] * 3,
                  f"{what}: success {got.success.tolist()}")
    print(f"K16 edges: {len(PARSE_EDGE_CASES)} cases x prob_bits "
          f"{PARSE_EDGE_PROB_BITS}, both layouts: equal to the plain parse, "
          "one launch each")


def _device_us(fn, name: str, reps: int) -> float:
    """Device microseconds a call of the kernels whose name holds name,
    from a torch.profiler trace of reps calls of fn after 3 warm-ups: the
    mean of the launches the trace holds (it may drop a few)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    trace = K.BUILD_DIR / f"parse.{os.getpid()}.json"
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    us = [e["dur"] for e in events
          if e.get("cat") == "kernel" and name in e.get("name", "")]
    check(2 * len(us) >= reps, f"{len(us)} {name} kernels traced of {reps}")
    return sum(us) / len(us)


def time_parse(dev, card: str) -> None:
    """K16 at each of PARSE_CELLS' shapes: the members' N(0,1) floats (half
    of them exact zeros where sparse) through compress_data, then one
    decompress_data with K16's calls recorded and counted; each call is held
    to the plain version bit for bit, then timed alone: its device time a
    call from a profiler trace of 20 calls (checked against PARSE_MAX_MS),
    by CUDA events, beside its bound and the plain version's time."""
    for cell, ft, count, n, sparse, pb, csum in PARSE_CELLS:
        g = torch.Generator(device=dev)
        g.manual_seed(18)
        wide = torch.float64 if ft == FP64 else torch.float32
        x = torch.randn((count, n), generator=g, device=dev, dtype=wide)
        if sparse:
            x[torch.rand((count, n), generator=g, device=dev) < 0.5] = 0
        x = x.to(_TORCH_DTYPE[ft])
        comp, _, _ = C.compress_data(True, list(x.unbind(0)), checksum=csum,
                                     prob_bits=pb, sparse=sparse)
        calls = []
        orig = K.ans_parse

        def rec(*a):
            out = orig(*a)
            calls.append((a, out))
            return out

        torch.cuda.synchronize()
        K.reset_launches()
        K.ans_parse = rec
        try:
            outs, _, ok, _, _ = C.decompress_data(
                True, comp, [n] * count, x.dtype, checksum=csum, prob_bits=pb,
                sparse=sparse)
            torch.cuda.synchronize()
        finally:
            K.ans_parse = orig
        launched = K.launches["ans_parse"]
        check(bool(ok.all()) and all(
            torch.equal(o.view(torch.uint8), r.view(torch.uint8))
            for o, r in zip(outs, x.unbind(0))), f"K16 at {cell}: round trip")
        check(launched == len(calls) == (2 if ft == FP64 else 1),
              f"K16 at {cell}: {launched} launches, {len(calls)} calls")
        del outs, x
        for i, (a, out) in enumerate(calls):
            check(max_abs_err(out, ans_parse_plain(*a)) == 0,
                  f"K16 at {cell} call {i}: differs from the plain parse")
            dev_ms = _device_us(lambda a=a: K.ans_parse(*a), "ans_parse_kernel",
                                20) / 1e3
            ev_ms = cuda_ms(lambda a=a: [K.ans_parse(*a) for _ in range(20)],
                            2, 5) / 20
            plain_ms = cuda_ms(lambda a=a: ans_parse_plain(*a), 1, 3)
            b_ms = bound_ms("ans_parse", a, out)
            B, NB = out[2].shape
            print(f"K16 at {cell} call {i}: B {B}, NB {NB}, {launched} "
                  f"launch(es) a decompress; device {dev_ms:.4f} ms a call "
                  f"(limit {PARSE_MAX_MS}), events {ev_ms:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({100 * b_ms / dev_ms:.1f}% of it), plain "
                  f"{plain_ms:.3f} ms ({card})")
            check(dev_ms <= PARSE_MAX_MS,
                  f"K16 at {cell}: {dev_ms:.4f} ms a call, over {PARSE_MAX_MS}")
        del calls, comp


def table_edge_batch(case: str, prob_bits: int):
    """One of K17's edge cases (TABLE_EDGE_CASES) at prob_bits: (hist
    int64[3, 256], totals int64[3]), the case's member, an empty member and
    the counts of TABLE_EDGE_BYTES exponential bytes."""
    T = 1 << prob_bits
    rng = np.random.default_rng(100 * prob_bits + TABLE_EDGE_CASES.index(case))
    h = np.zeros(256, np.int64)
    total = None  # None: the counts' sum
    if case == "big":
        h[:200] = rng.integers((1 << 24) + 1, (1 << 24) + (1 << 20), 200) | 1
    elif case == "total_high":
        h[:] = rng.integers(0, 5000, 256)
        total = int(h.sum()) + (1 << 32)
    elif case == "diff_rounds":
        h[rng.choice(256, 20, replace=False)] = rng.integers(1000, 5000, 20)
        total = 3 * int(h.sum())
    elif case == "excess_rounds":
        h[rng.choice(256, 23, replace=False)] = [10**6] * 3 + [1] * 20
    elif case == "ties":
        # quotients 60u (six), 40u (two), 72u and three bumped to 1, of 512u
        u = T // 512
        vals = [60 * u] * 6 + [40 * u] * 2 + [72 * u]
        ids = rng.choice(256, len(vals) + 3, replace=False)
        h[ids] = [1000 * v for v in vals] + [1] * 3
        total = 1000 * T
    elif case == "single":
        h[rng.integers(256)] = 12345
    elif case == "totals_below":
        h[rng.choice(256, 30, replace=False)] = rng.integers(1000, 5000, 30)
        total = int(0.9 * h.sum())
    elif case == "zero_total":
        h[:] = rng.integers(0, 5000, 256)
        total = 0
    elif case == "uniform":
        h[:] = 7
    elif case == "few":
        h[rng.choice(np.arange(10, 256), 5, replace=False)] = 1
    else:
        raise ValueError(case)
    natural = np.bincount(exponential_bytes(prob_bits, TABLE_EDGE_BYTES, 3.0),
                          minlength=256)
    hist = np.stack([h, np.zeros(256, np.int64), natural]).astype(np.int64)
    totals = np.array([int(h.sum()) if total is None else total, 0,
                       TABLE_EDGE_BYTES], np.int64)
    return hist, totals


def phase_table_edges(dev):
    """K17 against its plain version, pdf, packed table and magic bit for
    bit, on table_edge_batch: each case at prob_bits 9-11, through the
    dispatch (int64 counts, as the API hands them in: one launch a case),
    against the plain version on the card and on the CPU; then from one
    row expanded over the batch, read in place (the shared table's form)."""
    for case in TABLE_EDGE_CASES:
        for pb in TABLE_EDGE_PROB_BITS:
            hist, totals = table_edge_batch(case, pb)
            h, t = torch.from_numpy(hist), torch.from_numpy(totals)
            what = f"K17 edge {case} prob_bits {pb}"
            torch.cuda.synchronize()
            K.reset_launches()
            got = ans_table(h.to(dev), t.to(dev), pb)
            torch.cuda.synchronize()
            check(K.launches["ans_table"] == 1 and sum(K.launches.values()) == 1,
                  f"{what}: launches {K.launches}")
            check(max_abs_err(got, ans_table_plain(h.to(dev), t.to(dev), pb)) == 0,
                  f"{what}: K17 differs from the plain version on the card")
            check(max_abs_err(tuple(x.cpu() for x in got),
                              ans_table_plain(h, t, pb)) == 0,
                  f"{what}: K17 differs from the plain version on the CPU")
            row = h[2:].to(torch.int32).to(dev).expand(3, 256)
            tot = t[2:].to(dev).expand(3).contiguous()
            check(max_abs_err(K.ans_table(row, tot, pb),
                              ans_table_plain(row.contiguous(), tot, pb)) == 0,
                  f"{what}: K17 on an expanded row differs")
    print(f"K17 edges: {len(TABLE_EDGE_CASES)} cases x prob_bits "
          f"{TABLE_EDGE_PROB_BITS}: equal to the plain version on the card and "
          "on the CPU, one launch each; an expanded row read in place")


def table_cell_inputs(B: int, prob_bits: int, seed: int, dev):
    """K17's arguments at a cell's shape: B skewed random histograms (every
    other row with about 80% of its symbols absent, so bumps to 1 start the
    excess loop) and their sums as totals, made on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    h = (torch.rand((B, 256), generator=g, device=dev) ** 6 * 1e6).to(torch.int32)
    sparse_rows = (torch.arange(B, device=dev) % 2 == 1)[:, None]
    absent = torch.rand((B, 256), generator=g, device=dev) < 0.8
    h = torch.where(sparse_rows & absent, 0, h)
    return h, h.sum(dim=1, dtype=torch.int64), prob_bits


def time_table(dev, card: str) -> None:
    """K17 at each of TABLE_CELLS' shapes on table_cell_inputs, held to the
    plain version bit for bit, then timed alone: its device time a call
    from a profiler trace of 20 calls (checked against TABLE_MAX_MS), by
    CUDA events, beside its bound and the plain version's time."""
    for cell, B, pb in TABLE_CELLS:
        a = table_cell_inputs(B, pb, 20, dev)
        out = K.ans_table(*a)
        torch.cuda.synchronize()
        check(max_abs_err(out, ans_table_plain(*a)) == 0,
              f"K17 at {cell}: differs from the plain version")
        dev_ms = _device_us(lambda: K.ans_table(*a), "ans_table_kernel", 20) / 1e3
        ev_ms = cuda_ms(lambda: [K.ans_table(*a) for _ in range(20)], 2, 5) / 20
        plain_ms = cuda_ms(lambda: ans_table_plain(*a), 1, 3)
        b_ms = bound_ms("ans_table", a, out)
        print(f"K17 at {cell}: B {B}, prob_bits {pb}; device {dev_ms:.4f} ms a "
              f"call (limit {TABLE_MAX_MS}), events {ev_ms:.4f} ms, bound "
              f"{b_ms:.6f} ms ({100 * b_ms / dev_ms:.2f}% of it), plain "
              f"{plain_ms:.3f} ms ({card})")
        check(dev_ms <= TABLE_MAX_MS,
              f"K17 at {cell}: {dev_ms:.4f} ms a call, over {TABLE_MAX_MS}")


def phase_hist_edges(dev):
    """K8 against its plain version, bit for bit, on ``hist_edge_inputs``,
    launched once a case; a one-valued row's histogram holds its size in
    one bin."""
    for case in HIST_EDGE_CASES:
        rows, sizes = hist_edge_inputs(case, dev)
        torch.cuda.synchronize()
        K.reset_launches()
        got = byte_hist(rows, sizes)
        torch.cuda.synchronize()
        check(K.launches["byte_hist"] == 1,
              f"hist edge {case}: {K.launches['byte_hist']} K8 launches")
        err = max_abs_err(got, byte_hist_plain(rows, sizes))
        check(err == 0, f"byte_hist on the {case} edge differs from its plain "
                        f"version by {err}")
        if case != "ragged":
            want = torch.zeros_like(got[0])
            want[:, int(case, 16)] = sizes
            check(torch.equal(got[0], want), f"hist edge {case}: one bin")
        print(f"hist edges {case}: K8, sizes {sizes.tolist()} in rows of "
              f"{rows.shape[1]} bytes: equal to plain")


def _kernel_name(name: str) -> str:
    """A kernel of ``csrc/`` (they sit in an anonymous namespace) by its
    function and template arguments; other device ops as the profiler
    names them."""
    head = name.removeprefix("void ")
    if not head.startswith("(anonymous namespace)::"):
        return name
    return head.removeprefix("(anonymous namespace)::").split("(")[0]


def profile_paths(paths, ops, card: str) -> None:
    """``--profile``: for each main path's compress and decompress (a
    decode formulation's decompress alone; a phase P collective's call
    alone; an S path's rank scan alone too,
    K15 and the plain version; phase O's run, each of its lookups alone and
    their library calls, K1 alone with and without histogram on N(0,1) and
    one-bin 16Mi bf16, K8 alone on 32 MiB of N(0,1) bf16 bytes and of one
    byte value), the host-clock median of 10
    calls ending in a synchronise, and from a torch.profiler trace of 5
    calls after 3 warm-ups the device busy time (kernels, copies and
    fills), the idle share (1 - busy / host), the host's kernel launches,
    the device's operations, the eight device operations that take the
    most time and the device time of every kernel of ``csrc/``, each per
    call; then ``wrapper_breakdown``."""
    from torch.profiler import ProfilerActivity, profile

    trace = K.BUILD_DIR / f"profile.{os.getpid()}.json"
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    print(f"profile ({card}): path, call, host ms, device busy ms, idle "
          "share, host launches, device ops")
    for mp in paths + [ops]:
        if mp is ops:
            # each lookup alone and its library call too, device time
            # against device time
            runs = (("run", ops.run),) + ops.lookups + ops.k1_alone + ops.k8_alone
        elif isinstance(mp, CollectivePath):
            runs = ((mp.fn.__name__, mp.run),)
        else:
            arc = mp.compress()[0]
            runs = (("compress", mp.compress),
                    ("decompress", lambda: mp.decompress(arc)))
            if getattr(mp, "decode_only", False):
                runs = runs[1:]  # its compress is the set-up archive
            if isinstance(mp, ApiSparsePath):
                # the rank scan alone on the path's bitmap: K15, and the
                # plain version, which is how the scan ran before K15
                n64 = mp.n.to(torch.int64)
                bm = pack_bitmap_plain(mp.d, n64, mp.ft)
                runs += (("rank scan K15", lambda: word_ranks(bm, n64)),
                         ("rank scan plain", lambda: word_ranks_plain(bm, n64)))
        for what, fn in runs:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            host = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
            trace.unlink()
            dev = [e for e in events if e.get("ph") == "X" and e.get("cat")
                   in ("kernel", "gpu_memcpy", "gpu_memset")]
            launches = [e for e in events if e.get("cat") == "cuda_runtime"
                        and "LaunchKernel" in e.get("name", "")]
            h_ms = statistics.median(host)
            busy = sum(e["dur"] for e in dev) / 5 / 1e3
            print(f"profile {mp.name} {what}: host {h_ms:.3f} ms, device busy "
                  f"{busy:.3f} ms, idle share {1 - busy / h_ms:.3f}, host "
                  f"launches {len(launches) / 5:.0f}, device ops "
                  f"{len(dev) / 5:.0f}")
            by_name, ours = {}, set()
            for e in dev:
                name = _kernel_name(e["name"])
                by_name[name] = by_name.get(name, 0.0) + e["dur"]
                if name != e["name"]:
                    ours.add(name)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            print("  top: " + "; ".join(f"{name[:70]} {us / 5 / 1e3:.3f} ms"
                                        for name, us in top))
            print("  csrc: " + "; ".join(
                f"{name} {by_name[name] / 5 / 1e3:.4f} ms" for name in sorted(ours)))
    wrapper_breakdown(ops, card)


def wrapper_breakdown(ops, card: str, reps: int = 500) -> None:
    """``--profile``: the host time of K14 rowwise's wrapper at phase O's
    shapes, piece by piece (host clock, mean of reps calls after a
    synchronise; the launches queue on the device, which runs each in a
    few microseconds): the op's argument checks, the dispatch test, the
    wrapper's device test, the output's allocation, ``library()``, entering
    and leaving ``torch.cuda.device``, ``_stream``, the ctypes call that
    launches, and the whole ``rowwise_lookup`` call."""
    from dietgpu_fork_torch.core.config import use_kernels

    tabs, idx = ops.tabs, ops.tab_idx
    (r, h), k = tabs.shape, idx.shape[1]
    dev = idx.device
    lib = K.library()
    out = torch.empty((r, k), dtype=torch.int32, device=dev)
    stream = K._stream(idx)

    def enter_device():
        with torch.cuda.device(dev):
            pass

    pieces = (
        ("op checks", lambda: _check_lookup_args(tabs, idx, ROWWISE_MAX_K)),
        ("use_kernels", lambda: use_kernels(idx)),
        ("_cuda_only", lambda: K._cuda_only(tabs, idx)),
        ("torch.empty", lambda: torch.empty((r, k), dtype=torch.int32, device=dev)),
        ("library()", K.library),
        ("torch.cuda.device", enter_device),
        ("_stream", lambda: K._stream(idx)),
        ("ctypes call", lambda: lib.dgt_rowwise_lookup(
            tabs.data_ptr(), r, h, idx.data_ptr(), k, out.data_ptr(), stream)),
        ("rowwise_lookup", lambda: rowwise_lookup(tabs, idx)),
    )
    us = {}
    for name, fn in pieces:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    parts = sum(v for name, v in us.items() if name != "rowwise_lookup")
    print(f"wrapper rowwise_lookup host us ({card}): " + "; ".join(
        f"{name} {v:.2f}" for name, v in us.items())
        + f"; sum of the pieces {parts:.2f}")


def hold_kernels(name: str, calls, report) -> None:
    """Phase 2 for one path: each kernel of the path against its plain
    version on the calls the path recorded, bit for bit, timed beside its
    bound and its library call; no kernel off the path recorded."""
    torch.cuda.synchronize()
    for wname, _, plain_fn, _, _, needs in KERNELS:
        if name not in needs:
            check(not calls[wname], f"{wname} ran on the {name} path")
            continue
        check(len(calls[wname]) > 0, f"{wname} recorded no {name} call")
        err = 0
        for args, out in calls[wname]:
            err = max(err, max_abs_err(out, plain_fn(*args)))
        check(err == 0, f"{wname} differs from its plain version by {err} "
                        f"on the {name} path")
        kernel = getattr(K, wname)
        ms = sum(cuda_ms(lambda a=a: kernel(*a), 3, 10)
                 for a, _ in calls[wname])
        plain_ms = sum(cuda_ms(lambda a=a: plain_fn(*a), 1, 3)
                       for a, _ in calls[wname])
        b_ms = sum(bound_ms(wname, a, out) for a, out in calls[wname])
        libs = [f for f in (library_call(wname, a) for a, _ in calls[wname])
                if f is not None]
        lib_ms = (None if not libs
                  else sum(cuda_ms(f, 3, 10) for f in libs))
        del libs
        print(f"{wname} [{name}]: {len(calls[wname])} call(s), kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms, "
              f"library {'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, "
              f"max_abs_err {err}")
        r = report[wname]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b_ms
        r["ms_by_path"][name] = ms
        r["plain_ms_by_path"][name] = plain_ms
        r["bound_ms_by_path"][name] = b_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
            r["library_ms_by_path"][name] = lib_ms


def counted(name: str, fn, launches, report):
    """Phase 3 for one path: every launch counter set to 0 just before
    fn() and read just after; each kernel of the path must have launched
    and no other. Adds the counts to launches and the report; returns
    (fn's result, the counts)."""
    torch.cuda.synchronize()
    K.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    counts = dict(K.launches)
    for wname, counter, _, _, _, needs in KERNELS:
        if name in needs:
            check(counts[counter] > 0,
                  f"{wname} was not launched on the {name} main path")
        else:
            check(counts[counter] == 0,
                  f"{wname} was launched on the {name} main path")
        launches[wname] += counts[counter]
        report[wname]["launches_by_path"][name] = counts[counter]
    return res, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    with nccl_world_of_one():
        return run()


def run() -> int:
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    K.library()
    print(f"kernel build: {K.build_info['seconds']:.1f} s in nvcc, "
          f"{time.perf_counter() - t0:.1f} s to load ({K.build_info['path']})")
    print_ptxas(str(K.build_info["log"]))

    paths = [MainPath(ft, dev) for ft in (BF16, FP32, FP64)] + [
        ApiFloatPath(P_A, BF16, None, dev),
        ApiRawPath(P_B, None, dev),
        ApiFloatPath(P_CF, BF16, False, dev),
        ApiRawPath(P_CR, False, dev),
        ApiFloatPath(P_C32, FP32, False, dev),
    ] + [ApiSparsePath(name, ft, dev) for name, ft in zip(P_S, (BF16, FP32, FP64))]
    paths += [DecodePath(name, ft, native, fused, dev)
              for name, ft, native, fused in (
                  (P_F32T, FP32, True, False), (P_B16T, BF16, True, False),
                  (P_F32TC, FP32, False, False), (P_B16TC, BF16, False, False))]
    ops = OpsPhase(dev)
    par = ParallelPhase()
    if "--profile" in sys.argv[1:]:
        profile_paths(paths + par.profiled, ops, card)
        return 0
    print(f"K2 CTAs an SM: row layout {K.encode_ctas_per_sm(False)}, classic "
          f"{K.encode_ctas_per_sm(True)}")

    # 2. every kernel and mode against its plain version at each main
    # path's shapes
    report = {w: {"name": w, "route": "cuda", "source": source,
                  "replaces": replaces[0], "launches": 0, "max_abs_err": 0,
                  "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bound_by": "bytes", "library_ms": None, "ms_by_path": {},
                  "plain_ms_by_path": {}, "bound_ms_by_path": {},
                  "library_ms_by_path": {}, "launches_by_path": {}}
              for w, _, _, source, replaces, _ in KERNELS}
    for w, _, _, _, replaces, _ in KERNELS:
        if len(replaces) > 1:
            report[w]["also_replaces"] = list(replaces[1:])
    for mp in paths:
        hold_kernels(mp.name, record_calls(
            lambda: mp.decompress(mp.compress()[0])), report)
    hold_kernels(ops.name, record_calls(ops.run), report)
    for pp in par.paths:
        hold_kernels(pp.name, record_calls(pp.run), report)

    # 3. the main paths, each counted on its own
    archives = {}
    launches = {w: 0 for w, *_ in KERNELS}
    for mp in paths:

        def run(mp=mp):
            a, c = mp.compress()
            return a, c, mp.decompress(a)

        (arc, comp_bytes, res), counts = counted(mp.name, run, launches, report)
        check(mp.round_trip_ok(res), f"{mp.name} main path round trip")
        if not getattr(mp, "decode_only", False):
            check(counts["ans_table"] == 1,
                  f"{mp.name}: {counts['ans_table']} K17 launches a compress")
        if mp.name in K3_MAX_LAUNCHES:
            k3 = counts["runs_merge"]
            if getattr(mp, "decode_only", False):
                # its counted run is the decode alone: add its compress
                torch.cuda.synchronize()
                K.reset_launches()
                float_compress_core(mp.d, mp.n, mp.ft, PROB_BITS, native=mp.native)
                torch.cuda.synchronize()
                k3 += K.launches["runs_merge"]
            check(k3 <= K3_MAX_LAUNCHES[mp.name],
                  f"{mp.name}: {k3} K3 launches a round trip, more than "
                  f"{K3_MAX_LAUNCHES[mp.name]}")
        cb = int(comp_bytes.sum())
        print(f"{mp.name} main path: comp_bytes {cb}, ratio "
              f"{cb / mp.raw_bytes:.6f}, launches {counts}")
        if getattr(mp, "decode_only", False):
            # the other formulation of the same archive gives the same words
            other = mp.decompress_default(arc)
            check(all(torch.equal(x, y) for x, y in zip(res, other)),
                  f"{mp.name} equals the default decode")
            check(mp.round_trip_ok(mp.decompress(arc, plain=True)),
                  f"{mp.name} plain decode round trip")
            del other, res
            archives[mp.name] = arc
            print(f"{mp.name} path: round trip exact, equal to the default "
                  "decode and to the plain decode")
            continue
        p_arc, p_comp_bytes = mp.compress(plain=True)
        check(torch.equal(p_arc, arc) and torch.equal(p_comp_bytes, comp_bytes),
              f"{mp.name} kernel archive equals the all-plain archive")
        for a, plain in ((arc, True), (p_arc, False)):
            check(mp.round_trip_ok(mp.decompress(a, plain=plain)),
                  f"{mp.name} cross-decode with plain={plain}")
        del p_arc, res
        archives[mp.name] = arc
        print(f"{mp.name} main path: round trip exact, archive == plain "
              "archive, cross-decoding both ways")
    o_out, counts = counted(ops.name, ops.run, launches, report)
    check(ops.ok(o_out), "O: split then join returns the input, lookups "
                         "equal their plain versions")
    print(f"{ops.name}: split_packed + join exact for bf16, fp32, fp64; "
          f"lookups == plain; launches {counts}")
    del o_out
    # P: each path counted, checked exactly, and equal to its all-plain run
    p_results = {}
    for pp in par.paths:
        res, counts = counted(pp.name, pp.run, launches, report)
        pp.check(res)
        check(same(res, pp.run(plain=True)),
              f"{pp.name}: bytes, flags and wire words equal the all-plain run's")
        p_results[pp.name] = res
        print(f"{pp.name}: exact, equal to the direct calls and to the "
              f"all-plain run; launches {counts}")
    par.check_profiling()
    for w in launches:
        report[w]["launches"] = launches[w]
    # A: the API's archive is float_compress_core's, in the native layout
    a_path = next(p for p in paths if p.name == P_A)
    core32, core_cb = float_compress_core(a_path.d, a_path.n, BF16, PROB_BITS,
                                          use_checksum=True)
    a_arc = archives[P_A]
    nc = 4 * core32.shape[1]
    check(torch.equal(a_arc[:, :nc], core32.view(torch.uint8))
          and not bool(a_arc[:, nc:].any()),
          "A: the API archive equals float_compress_core's")
    check(C.detect_native_layout(True, a_arc, float_type=BF16),
          "A: the default layout on the card is native")
    for name in (P_CF, P_CR, P_C32):
        comp = archives[name]
        check(not C.detect_native_layout(name != P_CR, comp),
              f"{name}: the archive is classic")
    del core32

    # 4. link to the reference without JAX
    base0 = torch.zeros(1, dtype=torch.int64, device=dev)
    for ft in (BF16, FP32, FP64):
        g_rows = rows_from_numpy(golden_input(ft)[1], dev)
        g_out, g_cb = float_compress_core(
            g_rows, torch.tensor([GOLDEN_N], dtype=torch.int32, device=dev),
            ft, PROB_BITS)
        digest = archive_sha256(g_out[0], int(g_cb[0]))
        check(digest == GOLDEN_V2_SHA256[ft],
              f"{ft.name} golden archive sha256 {digest}")
        gw, gs, _, _, _ = float_decompress_core(
            g_out, base0, GOLDEN_N, ft, PROB_BITS)
        check(bool(gs[0]) and torch.equal(gw[:, : g_rows.shape[1]], g_rows)
              and not bool(gw[:, g_rows.shape[1]:].any()),
              f"{ft.name} golden round trip")
        print(f"{ft.name} golden v2 archive: {int(g_cb[0])} bytes, "
              "sha256 matches")
    for key, (row, nbytes) in golden_classic(dev).items():
        digest = bytes_sha256(row, nbytes)
        check(digest == GOLDEN_SHA256[key], f"{key} golden archive sha256 {digest}")
        print(f"{key} golden archive: {nbytes} bytes, sha256 matches")
    golden_sparse(dev)

    # 5. ragged batches: per-member tables inside K2, K4 and K6, partial
    # groups of floats in K5 and K7; then D, E and F
    phase_k3_ragged(dev)
    phase_encode_edges(dev)
    phase_sparse_edges(dev)
    phase_misaligned(dev)
    phase_wide_edges(dev)
    phase_split16_edges(dev)
    phase_join16_edges(dev)
    phase_hist_edges(dev)
    phase_checksum_edges(dev)
    phase_parse_edges(dev)
    phase_table_edges(dev)
    ragged_batch(BF16, 128, 2, dev)
    ragged_batch(FP32, 64, 200, dev)
    ragged_batch(FP64, 64, 300, dev)
    phase_d(dev, card)
    phase_e(dev)
    phase_f(a_arc)
    phase_sparse_classic(dev)
    ragged_sparse_batch(dev)

    # 6. times at the main paths; a decode formulation in turns with the
    # default one on the same archive (this, default, default, this)
    for mp in paths:
        gb = mp.raw_bytes / 1e9
        arc = archives[mp.name]
        if getattr(mp, "decode_only", False):
            this = "fused" if mp.fused else "two-pass"
            dflt = "two-pass" if mp.fused else "fused"
            t = {}
            for k, fn in ((f"decompress {this} 1", mp.decompress),
                          (f"decompress {dflt} (default) 1", mp.decompress_default),
                          (f"decompress {dflt} (default) 2", mp.decompress_default),
                          (f"decompress {this} 2", mp.decompress)):
                t[k] = cuda_ms(lambda fn=fn: fn(arc), 3, 10)
            t["decompress_plain"] = cuda_ms(lambda: mp.decompress(arc, True), 1, 3)
        else:
            t = {
                "compress": cuda_ms(mp.compress, 3, 10),
                "decompress": cuda_ms(lambda: mp.decompress(arc), 3, 10),
                "compress_plain": cuda_ms(lambda: mp.compress(True), 1, 3),
                "decompress_plain": cuda_ms(lambda: mp.decompress(arc, True), 1, 3),
            }
        for k, ms in t.items():
            print(f"{mp.name} {k}: {ms:.3f} ms, {gb / (ms / 1e3):.3f} GB/s "
                  f"({mp.raw_bytes / 2**20:.1f} MiB, median; {card})")

    time_checksum_form(dev, card)
    time_parse(dev, card)
    time_table(dev, card)

    # P: each function timed on its own; the wire is a collective's words
    # moved by this rank, the archives' bytes for the sharded codecs
    for pp in par.paths:
        res = p_results[pp.name]
        mib, wire = pp.raw_bytes / 2**20, pp.wire_bytes(res)
        for what, fn in pp.timings(res):
            ms = cuda_ms(fn, 3, 10)
            print(f"{pp.name} {what}: {ms:.3f} ms, "
                  f"{pp.raw_bytes / 1e9 / (ms / 1e3):.3f} GB/s of raw input; raw "
                  f"{mib:.1f} MiB, wire {wire / 2**20:.3f} MiB, share "
                  f"{wire / pp.raw_bytes:.6f} (median; {card})")

    print(card_line())
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
