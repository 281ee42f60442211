#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dietgpu_fork_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the four CUDA kernels from
   ``dietgpu_fork_torch/csrc`` (nvcc, sm_90a), printing the build time;
2. drives the main path once with every kernel wrapper recording its
   calls, then holds each kernel against its plain PyTorch version on the
   recorded inputs (the main path's own shapes), bit for bit, and times
   both with CUDA events;
3. drives the main path -- ``float_compress_core`` then
   ``float_decompress_core``, 16Mi bf16 N(0,1) floats, prob_bits 10, native
   row-stream layout, batch 1 -- with the launch counters reset just
   before, and checks the round trip, the archive against the all-plain
   path's archive, cross-decoding both ways, and that every kernel ran;
4. links the port to the JAX reference without JAX: the archive of a fixed
   v2-container input must hash to ``GOLDEN_V2_SHA256``, which the CPU
   tests hold equal to the NumPy oracle's archive;
5. round-trips a ragged batch of 128 members of up to 128Ki floats;
6. times compress and decompress of the main path (3 warm-ups, median of
   10) on the kernel path, and the all-plain path.

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

from dietgpu_fork_torch.core.constants import FloatType
from dietgpu_fork_torch.core.interop import rows_from_numpy, rows_to_numpy
from dietgpu_fork_torch.models.float_codec import (
    float_compress_core,
    float_decompress_core,
)
from dietgpu_fork_torch.ops.float_split import split16_hist_plain
from dietgpu_fork_torch.ops.merge import runs_merge_plain
from dietgpu_fork_torch.ops.rans_decode import decode_join16_plain
from dietgpu_fork_torch.ops.rans_encode import encode_rows_plain
from dietgpu_fork_torch.runtime import cuda_kernels as K

# sha256 of the archive (its first comp_bytes bytes) of golden_input():
# bf16, prob_bits 10, native, n = 2^20 + 4097 (a v2 container with a
# partial row and a partial block). tests/test_torch_float_codec.py holds
# it equal to the NumPy oracle's archive and to the port's plain path.
GOLDEN_V2_SHA256 = (
    "2c86d4f6df30a86ff682c2a72844d01e1e331bf950bb78618e60bef1474355cf"
)
GOLDEN_N = (1 << 20) + 4097
MAIN_N = 1 << 24
BF16 = FloatType.BFLOAT16
PROB_BITS = 10

# (wrapper in runtime.cuda_kernels, launch counter, plain version, source,
# file:line of each TPU kernel it replaces, within the JAX package)
KERNELS = [
    ("split16_hist", "split16_hist", split16_hist_plain,
     "dietgpu_fork_torch/csrc/split16_hist.cu",
     ("ops/pallas/float_split_fused.py:265",)),
    ("encode_rows", "rans_encode_rows", encode_rows_plain,
     "dietgpu_fork_torch/csrc/rans_encode_rows.cu",
     ("ops/pallas/rans_encode_fused.py:114",
      "ops/pallas/rans_encode_fused.py:420")),
    ("runs_merge", "runs_merge", runs_merge_plain,
     "dietgpu_fork_torch/csrc/runs_merge.cu",
     ("ops/pallas/merge.py:305",)),
    ("decode_join16", "rans_decode_join16", decode_join16_plain,
     "dietgpu_fork_torch/csrc/rans_decode_join16.cu",
     ("ops/pallas/rans_decode_fused2.py:104",)),
]


def bf16_words(seed: int, n: int) -> np.ndarray:
    """n bf16 N(0,1) values as uint16 words (bench.py's input recipe)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n).astype(np.float32)
    return (x.view(np.uint32) >> 16).astype(np.uint16)


def pack_rows(words, cap: int) -> np.ndarray:
    """uint16 arrays -> uint32[B, ceil(cap / 2)] rows, zero padded."""
    buf = np.zeros((len(words), -(-cap // 2) * 4), np.uint8)
    for i, w in enumerate(words):
        buf[i, : w.nbytes] = w.view(np.uint8)
    return buf.view(np.uint32)


def golden_input():
    """The phase-4 input: (uint16 words, uint32[1, W32] rows)."""
    w = bf16_words(1, GOLDEN_N)
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

    # main-path input
    w_main = bf16_words(0, MAIN_N)
    d_main = rows_from_numpy(pack_rows([w_main], MAIN_N), dev)
    n_main = torch.tensor([MAIN_N], dtype=torch.int32, device=dev)
    base0 = torch.zeros(1, dtype=torch.int64, device=dev)

    def compress(plain=False):
        return float_compress_core(d_main, n_main, BF16, PROB_BITS, plain=plain)

    def decompress(out32, plain=False):
        return float_decompress_core(out32, base0, MAIN_N, BF16, PROB_BITS,
                                     plain=plain)

    # 2. every kernel against its plain version at the main path's shapes
    calls = record_calls(lambda: decompress(compress()[0]))
    torch.cuda.synchronize()
    report = []
    for wname, counter, plain_fn, source, replaces in KERNELS:
        check(len(calls[wname]) > 0, f"{wname} recorded no call")
        err = 0
        for args, out in calls[wname]:
            err = max(err, max_abs_err(out, plain_fn(*args)))
        check(err == 0, f"{wname} differs from its plain version by {err}")
        kernel = getattr(K, wname)
        ms = sum(cuda_ms(lambda a=a: kernel(*a), 3, 10) for a, _ in calls[wname])
        plain_ms = sum(cuda_ms(lambda a=a: plain_fn(*a), 1, 3)
                       for a, _ in calls[wname])
        print(f"{wname}: {len(calls[wname])} call(s), kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, max_abs_err {err}")
        entry = {"name": wname, "route": "cuda", "source": source,
                 "replaces": replaces[0], "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "counter": counter}
        if len(replaces) > 1:
            entry["also_replaces"] = list(replaces[1:])
        report.append(entry)
    del calls

    # 3. the main path, counted
    torch.cuda.synchronize()
    K.reset_launches()
    out32, comp_bytes = compress()
    words, success, n_out, _, _ = decompress(out32)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    for r in report:
        r["launches"] = counts[r.pop("counter")]
        check(r["launches"] > 0, f"{r['name']} was not launched on the main path")
    check(bool(success.all()), "main path success")
    check(int(n_out[0]) == MAIN_N, "main path decoded size")
    check(torch.equal(words, d_main), "main path round trip")
    cb = int(comp_bytes[0])
    print(f"main path: comp_bytes {cb}, ratio {cb / (2 * MAIN_N):.6f}, "
          f"launches {counts}")
    p_out32, p_comp_bytes = compress(plain=True)
    check(torch.equal(p_out32, out32) and torch.equal(p_comp_bytes, comp_bytes),
          "kernel archive equals the all-plain archive")
    for arc, plain in ((out32, True), (p_out32, False)):
        w2, s2, _, _, _ = decompress(arc, plain=plain)
        check(bool(s2.all()) and torch.equal(w2, d_main),
              f"cross-decode with plain={plain}")
    print("main path: round trip exact, archive == plain archive, "
          "cross-decoding both ways")

    # 4. link to the reference without JAX
    g_rows = rows_from_numpy(golden_input()[1], dev)
    g_out, g_cb = float_compress_core(
        g_rows, torch.tensor([GOLDEN_N], dtype=torch.int32, device=dev), BF16,
        PROB_BITS)
    digest = archive_sha256(g_out[0], int(g_cb[0]))
    check(digest == GOLDEN_V2_SHA256, f"golden archive sha256 {digest}")
    gw, gs, _, _, _ = float_decompress_core(
        g_out, base0, GOLDEN_N, BF16, PROB_BITS)
    check(bool(gs[0]) and torch.equal(gw, g_rows), "golden round trip")
    print(f"golden v2 archive: {int(g_cb[0])} bytes, sha256 matches")

    # 5. ragged batch: per-member tables inside K2 and K4
    rng = np.random.default_rng(2)
    sizes = rng.integers(0, 1 << 17, 128)
    sizes[:4] = [0, 1, 4097, 1 << 17]
    ws = [bf16_words(3 + i, int(s)) for i, s in enumerate(sizes)]
    d_b = rows_from_numpy(pack_rows(ws, 1 << 17), dev)
    n_b = torch.tensor(sizes, dtype=torch.int32, device=dev)
    base_b = torch.zeros(len(ws), dtype=torch.int64, device=dev)
    b_out, b_cb = float_compress_core(d_b, n_b, BF16, PROB_BITS)
    bp_out, bp_cb = float_compress_core(d_b, n_b, BF16, PROB_BITS, plain=True)
    check(torch.equal(b_out, bp_out) and torch.equal(b_cb, bp_cb),
          "batch archive equals the all-plain archive")
    bw, bs, bn, _, _ = float_decompress_core(b_out, base_b, 1 << 17, BF16,
                                             PROB_BITS)
    check(bool(bs.all()) and torch.equal(bn.cpu(), torch.from_numpy(sizes)),
          "batch success")
    check(torch.equal(bw, d_b), "batch round trip")
    print(f"batch: 128 members, {int(sizes.sum())} floats, "
          f"ratio {int(b_cb.sum()) / (2 * int(sizes.sum())):.6f}, exact")

    # 6. times at the main path
    gb = 2 * MAIN_N / 1e9
    t = {
        "compress": cuda_ms(compress, 3, 10),
        "decompress": cuda_ms(lambda: decompress(out32), 3, 10),
        "compress_plain": cuda_ms(lambda: compress(True), 1, 3),
        "decompress_plain": cuda_ms(lambda: decompress(out32, True), 1, 3),
    }
    for k, ms in t.items():
        print(f"{k}: {ms:.3f} ms, {gb / (ms / 1e3):.3f} GB/s "
              f"(16Mi bf16, median; {card})")

    print(card_line())
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
