#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dietgpu_fork_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the seven CUDA kernels from
   ``dietgpu_fork_torch/csrc`` (nvcc, sm_90a, one process per source),
   printing the build time;
2. drives each main path once with every kernel wrapper recording its
   calls, then holds each kernel against its plain PyTorch version on the
   recorded inputs (the main path's own shapes), bit for bit, and times
   both with CUDA events;
3. drives the main paths -- ``float_compress_core`` then
   ``float_decompress_core`` on 16Mi N(0,1) floats of bf16, fp32 and fp64,
   prob_bits 10, native row-stream layout, batch 1 -- each with the launch
   counters reset just before and read just after, and checks the round
   trip, the archive against the all-plain path's archive, cross-decoding
   both ways, and that every kernel of the path ran;
4. links the port to the JAX reference without JAX: the archive of a fixed
   v2-container input of each type must hash to its ``GOLDEN_V2_SHA256``
   entry, which the CPU tests hold equal to the NumPy oracle's archive;
5. round-trips a ragged bf16 batch of 128 members and ragged fp32 and
   fp64 batches of 64 members, each of up to 128Ki floats;
6. times compress and decompress of each main path (3 warm-ups, median of
   10) on the kernel path, and the all-plain path (median of 3).

It exits non-zero, printing no result, when CUDA is not available or any
phase fails. The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dietgpu_fork_torch.core.constants import FLOAT_WORD_SIZE, FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models.float_codec import (
    float_compress_core,
    float_decompress_core,
)
from dietgpu_fork_torch.ops.float_split import (
    join_wide_plain,
    split16_hist_plain,
    split_wide_hist_plain,
)
from dietgpu_fork_torch.ops.merge import runs_merge_plain
from dietgpu_fork_torch.ops.rans_decode import decode_join16_plain, decode_rows_plain
from dietgpu_fork_torch.ops.rans_encode import encode_rows_plain
from dietgpu_fork_torch.runtime import cuda_kernels as K

BF16, FP32, FP64 = FloatType.BFLOAT16, FloatType.FLOAT32, FloatType.FLOAT64
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
GOLDEN_N = (1 << 20) + 4097
MAIN_N = 1 << 24
MAIN_TYPES = (BF16, FP32, FP64)
PROB_BITS = 10
_WORD_DTYPE = {BF16: np.uint16, FP32: np.uint32, FP64: np.uint64}

# (wrapper in runtime.cuda_kernels, launch counter, plain version, source,
# file:line of each TPU kernel it replaces, within the JAX package, and the
# main paths that must launch it)
KERNELS = [
    ("split16_hist", "split16_hist", split16_hist_plain,
     "dietgpu_fork_torch/csrc/split16_hist.cu",
     ("ops/pallas/float_split_fused.py:265",), (BF16,)),
    ("encode_rows", "rans_encode_rows", encode_rows_plain,
     "dietgpu_fork_torch/csrc/rans_encode_rows.cu",
     ("ops/pallas/rans_encode_fused.py:114",
      "ops/pallas/rans_encode_fused.py:420"), MAIN_TYPES),
    ("runs_merge", "runs_merge", runs_merge_plain,
     "dietgpu_fork_torch/csrc/runs_merge.cu",
     ("ops/pallas/merge.py:305",), MAIN_TYPES),
    ("decode_join16", "rans_decode_join16", decode_join16_plain,
     "dietgpu_fork_torch/csrc/rans_decode_rows.cu",
     ("ops/pallas/rans_decode_fused2.py:104",), (BF16,)),
    ("split_wide_hist", "split_wide_hist", split_wide_hist_plain,
     "dietgpu_fork_torch/csrc/split_wide_hist.cu",
     ("ops/pallas/float_split_fused.py:291",
      "ops/pallas/float_split_fused.py:305"), (FP32, FP64)),
    ("decode_rows", "rans_decode_rows", decode_rows_plain,
     "dietgpu_fork_torch/csrc/rans_decode_rows.cu",
     ("ops/pallas/rans_decode_fused2.py:104",), (FP32, FP64)),
    ("join_wide", "join_wide", join_wide_plain,
     "dietgpu_fork_torch/csrc/join_wide.cu",
     ("ops/pallas/float_split_fused.py:395",
      "ops/pallas/float_split_fused.py:412"), (FP32, FP64)),
]


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
    """One main path: 16Mi N(0,1) floats of one type, batch 1."""

    def __init__(self, ft: FloatType, dev: torch.device):
        self.ft = ft
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

    def round_trip_ok(self, words32) -> bool:
        nw = self.d.shape[1]
        return (torch.equal(words32[:, :nw], self.d)
                and not bool(words32[:, nw:].any()))


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    K.library()
    print(f"kernel build: {K.build_info['seconds']:.1f} s in nvcc, "
          f"{time.perf_counter() - t0:.1f} s to load ({K.build_info['path']})")
    for line in str(K.build_info["log"]).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    paths = {ft: MainPath(ft, dev) for ft in MAIN_TYPES}

    # 2. every kernel against its plain version at each main path's shapes
    report = {w: {"name": w, "route": "cuda", "source": source,
                  "replaces": replaces[0], "max_abs_err": 0, "ms": 0.0,
                  "plain_ms": 0.0, "ms_by_path": {}, "plain_ms_by_path": {},
                  "launches_by_path": {}}
              for w, _, _, source, replaces, _ in KERNELS}
    for w, _, _, _, replaces, _ in KERNELS:
        if len(replaces) > 1:
            report[w]["also_replaces"] = list(replaces[1:])
    for ft, mp in paths.items():
        calls = record_calls(lambda: mp.decompress(mp.compress()[0]))
        torch.cuda.synchronize()
        for wname, _, plain_fn, _, _, needs in KERNELS:
            if ft not in needs:
                check(not calls[wname], f"{wname} ran on the {ft.name} path")
                continue
            check(len(calls[wname]) > 0, f"{wname} recorded no {ft.name} call")
            err = 0
            for args, out in calls[wname]:
                err = max(err, max_abs_err(out, plain_fn(*args)))
            check(err == 0, f"{wname} differs from its plain version by {err} "
                            f"on the {ft.name} path")
            kernel = getattr(K, wname)
            ms = sum(cuda_ms(lambda a=a: kernel(*a), 3, 10)
                     for a, _ in calls[wname])
            plain_ms = sum(cuda_ms(lambda a=a: plain_fn(*a), 1, 3)
                           for a, _ in calls[wname])
            print(f"{wname} [{ft.name}]: {len(calls[wname])} call(s), kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, max_abs_err {err}")
            r = report[wname]
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["ms_by_path"][ft.name] = ms
            r["plain_ms_by_path"][ft.name] = plain_ms
        del calls

    # 3. the main paths, each counted on its own
    archives = {}
    launches = {w: 0 for w, *_ in KERNELS}
    for ft, mp in paths.items():
        torch.cuda.synchronize()
        K.reset_launches()
        out32, comp_bytes = mp.compress()
        words, success, n_out, _, _ = mp.decompress(out32)
        torch.cuda.synchronize()
        counts = dict(K.launches)
        for wname, counter, _, _, _, needs in KERNELS:
            if ft in needs:
                check(counts[counter] > 0,
                      f"{wname} was not launched on the {ft.name} main path")
            launches[wname] += counts[counter]
            report[wname]["launches_by_path"][ft.name] = counts[counter]
        check(bool(success.all()), f"{ft.name} main path success")
        check(int(n_out[0]) == MAIN_N, f"{ft.name} main path decoded size")
        check(mp.round_trip_ok(words), f"{ft.name} main path round trip")
        cb = int(comp_bytes[0])
        print(f"{ft.name} main path: comp_bytes {cb}, ratio "
              f"{cb / (FLOAT_WORD_SIZE[ft] * MAIN_N):.6f}, launches {counts}")
        p_out32, p_comp_bytes = mp.compress(plain=True)
        check(torch.equal(p_out32, out32)
              and torch.equal(p_comp_bytes, comp_bytes),
              f"{ft.name} kernel archive equals the all-plain archive")
        for arc, plain in ((out32, True), (p_out32, False)):
            w2, s2, _, _, _ = mp.decompress(arc, plain=plain)
            check(bool(s2.all()) and mp.round_trip_ok(w2),
                  f"{ft.name} cross-decode with plain={plain}")
        del p_out32, w2
        archives[ft] = out32
        print(f"{ft.name} main path: round trip exact, archive == plain "
              "archive, cross-decoding both ways")
    for w in launches:
        report[w]["launches"] = launches[w]

    # 4. link to the reference without JAX
    base0 = torch.zeros(1, dtype=torch.int64, device=dev)
    for ft in MAIN_TYPES:
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

    # 5. ragged batches: per-member tables inside K2, K4 and K6, partial
    # groups of floats in K5 and K7
    ragged_batch(BF16, 128, 2, dev)
    ragged_batch(FP32, 64, 200, dev)
    ragged_batch(FP64, 64, 300, dev)

    # 6. times at the main paths
    for ft, mp in paths.items():
        gb = FLOAT_WORD_SIZE[ft] * MAIN_N / 1e9
        out32 = archives[ft]
        t = {
            "compress": cuda_ms(mp.compress, 3, 10),
            "decompress": cuda_ms(lambda: mp.decompress(out32), 3, 10),
            "compress_plain": cuda_ms(lambda: mp.compress(True), 1, 3),
            "decompress_plain": cuda_ms(lambda: mp.decompress(out32, True), 1, 3),
        }
        for k, ms in t.items():
            print(f"{ft.name} {k}: {ms:.3f} ms, {gb / (ms / 1e3):.3f} GB/s "
                  f"({MAIN_N >> 20}Mi {ft.name}, median; {card})")

    print(card_line())
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
