// K11: expansion of a member's nonzero floats by its bitmap, with the tail
// past its float count zeroed:
//
//   out[f] = (f < n[b] and bit f) ? nz[rank(f)] : 0
//
// Replaces the JAX package's ops/pallas/sparse_stream.py::_expand_kernel
// (expand_by_bitmap) and the ops/checksum.py::mask_packed_bytes that
// models/sparse.py runs after it. Contract:
// dietgpu_fork_torch/ops/sparse_stream.py::expand_by_bitmap_plain.
//
// One warp per 32 output floats, word w of the bitmap. Lane l reads the
// bit of float f = 32w + l straight from the archive's MSB-first word, so
// no bit-reversal pass runs first; floats at or past n[b] take no bit.
// rank(f) = ranks[w] + popc(ballot & lanes below l), clamped into the
// member's nonzero row: a corrupt archive may set more bits than its dense
// part decoded, and no read leaves the row. Every output float is written
// (a u16 or u32 store, or two u32 stores for fp64), so the output needs no
// fill beforehand; a failed member, which the caller gives n = 0, comes
// out all zero. The TPU's scalar-prefetched windows of the nonzero stream
// and DMA chunks have no counterpart: each lane gathers its one float.
//
// Bound on the card: device memory, a read of the nonzero floats and the
// bitmap and a write of the whole output row, at 3.35 TB/s. Stores of one
// warp are contiguous; the gathers of one warp fall in one contiguous run
// of the nonzero row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int WS>
__global__ void __launch_bounds__(kThreads)
sparse_expand_kernel(const uint32_t* __restrict__ nz, int64_t nzw,
                     int64_t nz_cap, const uint32_t* __restrict__ bm,
                     const int32_t* __restrict__ ranks, int64_t bw,
                     const int32_t* __restrict__ n, int64_t slots,
                     uint32_t* __restrict__ out, int64_t ow) {
  const int64_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (slots + 31) / 32) return;  // uniform across the warp
  int64_t lim = n[b];
  lim = lim < 0 ? 0 : (lim > slots ? slots : lim);
  const int64_t f = 32 * w + lane;
  bool bit = false;
  if (32 * w < lim && w < bw) {
    const uint32_t word = bm[b * bw + w];
    bit = f < lim && ((word >> (8 * (lane >> 3) + 7 - (lane & 7))) & 1u);
  }
  const uint32_t bal = __ballot_sync(0xFFFFFFFFu, bit);
  const uint32_t* row = nz + b * nzw;
  uint32_t* orow = out + b * ow;
  uint32_t lo = 0, hi = 0;
  if (bit) {
    int64_t r = (int64_t)ranks[b * (bw + 1) + w] + __popc(bal & ((1u << lane) - 1u));
    r = r < 0 ? 0 : (r >= nz_cap ? nz_cap - 1 : r);
    if constexpr (WS == 2) {
      lo = reinterpret_cast<const uint16_t*>(row)[r];
    } else if constexpr (WS == 4) {
      lo = row[r];
    } else {
      lo = row[2 * r];
      hi = row[2 * r + 1];
    }
  }
  if (f >= slots) return;
  if constexpr (WS == 2) {
    reinterpret_cast<uint16_t*>(orow)[f] = (uint16_t)lo;
  } else if constexpr (WS == 4) {
    orow[f] = lo;
  } else {
    orow[2 * f] = lo;
    orow[2 * f + 1] = hi;
  }
}

template <int WS>
int launch(const void* nz, long long batch, long long nzw, long long nz_cap,
           const void* bm, const void* ranks, long long bw, const void* n,
           long long slots, void* out, long long ow, void* stream) {
  const long long words = (slots + 31) / 32;
  const long long gx = words > 0 ? (words + kWarps - 1) / kWarps : 1;
  dim3 grid((unsigned)gx, (unsigned)batch);
  sparse_expand_kernel<WS><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)nz, nzw, nz_cap, (const uint32_t*)bm,
      (const int32_t*)ranks, bw, (const int32_t*)n, slots, (uint32_t*)out, ow);
  return (int)cudaGetLastError();
}

}  // namespace

// nz: u32[B, nzw] rows of nonzero floats of ws bytes (2, 4 or 8), nz_cap
// >= 1 of them; bm: u32[B, bw] MSB-first bitmap words; ranks: i32[B, bw +
// 1]; n: i32[B] float counts; out: u32[B, ow] holding slots = 4 ow / ws
// floats, every one written. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for another ws.
extern "C" int dgt_sparse_expand(const void* nz, long long batch,
                                 long long nzw, long long nz_cap,
                                 const void* bm, const void* ranks,
                                 long long bw, const void* n, int ws,
                                 void* out, long long ow, void* stream) {
  if (ws != 2 && ws != 4 && ws != 8) return (int)cudaErrorInvalidValue;
  const long long slots = 4 * ow / ws;
  switch (ws) {
    case 2: return launch<2>(nz, batch, nzw, nz_cap, bm, ranks, bw, n, slots, out, ow, stream);
    case 4: return launch<4>(nz, batch, nzw, nz_cap, bm, ranks, bw, n, slots, out, ow, stream);
    case 8: return launch<8>(nz, batch, nzw, nz_cap, bm, ranks, bw, n, slots, out, ow, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
