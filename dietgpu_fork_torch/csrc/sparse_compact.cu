// K10: compaction of float rows by their nonzero bitmap: the kept floats
// move to the front of each member's row, in order, and the rest of the row
// is zero.
//
// Replaces two Pallas kernels of the JAX package's
// ops/pallas/sparse_stream.py and the glue between them: _compact_kernel
// (a rank-select per 8192-float cell into staging), the runs_merge that
// glues the cells (compact_by_bitmap) and, for 16-bit floats,
// _pack_pairs_kernel (pack_u16_pairs). Contract:
// dietgpu_fork_torch/ops/sparse_stream.py::compact_by_bitmap_plain.
//
// One warp per bitmap word w of member b. Lane l takes float f = 32w + l
// and reads its bit straight from the archive's MSB-first word (bit
// 8(l/8) + 7 - l%8), so no bit-reversal pass runs first. A set bit writes
// the float to slot ranks[w] + popc(ballot & lanes below l) of the output
// row as one u16 or u32 store, or two u32 stores for fp64: a 16-bit stream
// comes out in its packed-pairs form (item 2j the low half of word j) with
// no staging. Lane l also zeroes slot f when f >= nnz = ranks[bw], so with
// the ranks of the bitmap every slot below s_cap is written exactly once
// and the output needs no fill beforehand. Slots outside the row are never
// written, whatever the ranks. The TPU's per-cell binary search over word
// ranks, VMEM windows and staging merge have no counterpart: the ranks give
// each word its destination directly.
//
// Bound on the card: device memory, a read of the kept floats and the
// bitmap and a write of the whole output row (kept floats, then zeros), at
// 3.35 TB/s. Stores of one warp are contiguous; reads skip the zero floats
// but fetch whole 32 B sectors.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int WS>
__device__ __forceinline__ void copy_float(const uint32_t* src, int64_t f,
                                           uint32_t* dst, int64_t slot) {
  if constexpr (WS == 2) {
    reinterpret_cast<uint16_t*>(dst)[slot] =
        reinterpret_cast<const uint16_t*>(src)[f];
  } else if constexpr (WS == 4) {
    dst[slot] = src[f];
  } else {
    dst[2 * slot] = src[2 * f];
    dst[2 * slot + 1] = src[2 * f + 1];
  }
}

template <int WS>
__device__ __forceinline__ void zero_float(uint32_t* dst, int64_t slot) {
  if constexpr (WS == 2) {
    reinterpret_cast<uint16_t*>(dst)[slot] = 0;
  } else if constexpr (WS == 4) {
    dst[slot] = 0;
  } else {
    dst[2 * slot] = 0;
    dst[2 * slot + 1] = 0;
  }
}

template <int WS>
__global__ void __launch_bounds__(kThreads)
sparse_compact_kernel(const uint32_t* __restrict__ in, int64_t w32,
                      int64_t s_cap, const uint32_t* __restrict__ bm,
                      const int32_t* __restrict__ ranks, int64_t bw,
                      uint32_t* __restrict__ out, int64_t ow) {
  const int64_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (s_cap + 31) / 32) return;  // uniform across the warp
  const int32_t* rrow = ranks + b * (bw + 1);
  const uint32_t word = bm[b * bw + w];
  const int64_t f = 32 * w + lane;
  const bool bit =
      f < s_cap && ((word >> (8 * (lane >> 3) + 7 - (lane & 7))) & 1u);
  const uint32_t bal = __ballot_sync(0xFFFFFFFFu, bit);
  const uint32_t* row = in + b * w32;
  uint32_t* orow = out + b * ow;
  if (bit) {
    const int64_t slot = (int64_t)rrow[w] + __popc(bal & ((1u << lane) - 1u));
    if (slot >= 0 && slot < s_cap) copy_float<WS>(row, f, orow, slot);
  }
  if (f < s_cap && f >= (int64_t)rrow[bw]) zero_float<WS>(orow, f);
}

template <int WS>
int launch(const void* in, long long batch, long long w32, long long s_cap,
           const void* bm, const void* ranks, long long bw, void* out,
           long long ow, void* stream) {
  const long long words = (s_cap + 31) / 32;
  const long long gx = words > 0 ? (words + kWarps - 1) / kWarps : 1;
  dim3 grid((unsigned)gx, (unsigned)batch);
  sparse_compact_kernel<WS><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, w32, s_cap, (const uint32_t*)bm,
      (const int32_t*)ranks, bw, (uint32_t*)out, ow);
  return (int)cudaGetLastError();
}

}  // namespace

// in: u32[B, w32] rows of floats of ws bytes (2, 4 or 8), s_cap <= 4 w32 /
// ws of them; bm: u32[B, bw] MSB-first bitmap words, 32 bw >= s_cap;
// ranks: i32[B, bw + 1], the exclusive scan of the words' popcounts and
// the total; out: u32[B, ow], ow = ceil(s_cap ws / 4). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another ws.
extern "C" int dgt_sparse_compact(const void* in, long long batch,
                                  long long w32, long long s_cap,
                                  const void* bm, const void* ranks,
                                  long long bw, int ws, void* out,
                                  long long ow, void* stream) {
  switch (ws) {
    case 2: return launch<2>(in, batch, w32, s_cap, bm, ranks, bw, out, ow, stream);
    case 4: return launch<4>(in, batch, w32, s_cap, bm, ranks, bw, out, ow, stream);
    case 8: return launch<8>(in, batch, w32, s_cap, bm, ranks, bw, out, ow, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
