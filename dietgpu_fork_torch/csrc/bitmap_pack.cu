// K9: the sparse codec's nonzero bitmap, packed MSB first per byte and
// masked at each member's float count, in one read of the floats.
//
// Replaces three Pallas kernels of the JAX package's
// ops/pallas/bitmap_pack.py: _pack16_kernel, _pack32_kernel and
// _pack64_kernel (pack_bitmap16/32/64_tpu), with the tail mask that
// models/sparse.py:224-232 applies after them. Contract:
// dietgpu_fork_torch/ops/bitmap_pack.py::pack_bitmap_plain.
//
// Float f of member b is nonzero when its bits are not all zero (an integer
// compare, so -0.0 is nonzero; an fp64 float is nonzero when either u32
// half is), and counts only below n[b]. Bitmap word w holds floats
// 32w .. 32w + 31, float 32w + i on bit i ^ 7 (MSB first per byte, the
// archive's order). Words past the member's floats come out 0, up to the
// row width bw the caller sizes for the bitmap section.
//
// Bound on the card: device memory, one read of the floats below n (2, 4
// or 8 B each) and a write of 1/16 to 1/64 of that, at 3.35 TB/s. Design:
// a 16 B chunk of a row (4 words) holds 8 bf16, 4 fp32 or 2 fp64 floats,
// a byte, a nibble or 2 bits of the bitmap. A CTA of 512 threads takes a
// tile of 1024 chunks (16 KiB of floats), a warp 64 consecutive ones: lane
// l loads chunks l and l + 32 as uint4, both before the first test, so a
// warp moves 512 B a load (a one-off sweep on an H100 chose 512 threads and
// 2 chunks a thread over 256 x 4, 256 x 8 and 512 x 4). Each lane turns its
// chunk into bits (LSB first), the 4, 8 or 16 lanes of a word OR theirs
// together with shuffles, and the first of them writes the word.
// The mask is taken once, in the chunk that holds n; chunks past n are not
// read, so the zero words past the member's floats cost only their store.
// A row that does not start on a 16 B boundary (a member of a ragged
// batch) reads its chunks word by word, as does the warp whose span runs
// past the row's end. The TPU's lane rolls and slab gathers have no
// counterpart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnits = 2;  // chunks a thread a tile
constexpr int kWarpChunks = 32 * kUnits;
constexpr int kTileChunks = kThreads * kUnits;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Bit k: float k of the 16 B chunk a is nonzero.
template <int WS>
__device__ __forceinline__ uint32_t nonzero_bits(uint4 a) {
  if constexpr (WS == 2) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m |= (uint32_t)((w[i] & 0xFFFFu) != 0) << (2 * i);
      m |= (uint32_t)((w[i] >> 16) != 0) << (2 * i + 1);
    }
    return m;
  } else if constexpr (WS == 4) {
    return (uint32_t)(a.x != 0) | ((uint32_t)(a.y != 0) << 1) |
           ((uint32_t)(a.z != 0) << 2) | ((uint32_t)(a.w != 0) << 3);
  } else {
    return (uint32_t)((a.x | a.y) != 0) | ((uint32_t)((a.z | a.w) != 0) << 1);
  }
}

// Chunk c of a row (words 4c .. 4c + 3) word by word, 0 past the row.
__device__ __forceinline__ uint4 load_words(const uint32_t* row, int64_t c,
                                            int64_t w32) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 4 * c + i < w32 ? __ldg(row + 4 * c + i) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// CTA (x, y) takes tile x of row y's bw words.
template <int WS>
__global__ void __launch_bounds__(kThreads)
bitmap_pack_kernel(const uint32_t* __restrict__ in, int64_t w32, int64_t s_cap,
                   const int32_t* __restrict__ n, int64_t bw,
                   uint32_t* __restrict__ out) {
  constexpr int kF = 16 / WS;  // floats a chunk
  constexpr int kL = 32 / kF;  // chunks a bitmap word
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.y;
  const uint32_t* row = in + b * w32;
  // the warp's first chunk, and its floats below n
  const int64_t c0 = (int64_t)blockIdx.x * kTileChunks + (threadIdx.x >> 5) * kWarpChunks;
  int64_t lim = n[b];
  lim = lim < 0 ? 0 : (lim > s_cap ? s_cap : lim);
  const int64_t nl = lim - c0 * kF;
  const int live = nl <= 0 ? 0 : (nl >= kWarpChunks * kF ? kWarpChunks * kF : (int)nl);
  // uint4 loads where the row is 16 B aligned and the warp's span lies in it
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0 &&
                   4 * (c0 + kWarpChunks) <= w32;

  uint4 v[kUnits];
  const uint4* src = reinterpret_cast<const uint4*>(row) + c0;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int c = 32 * k + lane;  // the chunk in the warp's span
    v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (c * kF < live) v[k] = vec ? __ldg(src + c) : load_words(row, c0 + c, w32);
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int c = 32 * k + lane;
    uint32_t m = nonzero_bits<WS>(v[k]);
    const int left = live - c * kF;  // floats of the chunk below n
    if (left < kF) m &= left <= 0 ? 0u : (1u << left) - 1u;
    // this chunk's bits at their place in the word, LSB first, joined with
    // the word's other chunks
    m <<= kF * (lane % kL);
#pragma unroll
    for (int o = 1; o < kL; o <<= 1) m |= __shfl_xor_sync(kFull, m, o);
    const int64_t w = (c0 + c) / kL;
    if (lane % kL == 0 && w < bw) out[b * bw + w] = __byte_perm(__brev(m), 0, 0x0123);
  }
}

template <int WS>
int launch(const void* in, long long batch, long long w32, long long s_cap,
           const void* n, long long bw, void* out, void* stream) {
  constexpr long long kL = 32 / (16 / WS);
  const long long tpr = (bw * kL + kTileChunks - 1) / kTileChunks;  // tiles a row
  if (tpr == 0) return (int)cudaSuccess;
  bitmap_pack_kernel<WS><<<dim3((unsigned)tpr, (unsigned)batch), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)in, w32, s_cap, (const int32_t*)n, bw, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// in: u32[B, w32] rows of floats of ws bytes (2, 4 or 8), at any 4 B phase,
// s_cap <= 4 w32 / ws of them; n: i32[B]; out: u32[B, bw], every word
// written. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another ws.
extern "C" int dgt_bitmap_pack(const void* in, long long batch, long long w32,
                               long long s_cap, const void* n, long long bw,
                               int ws, void* out, void* stream) {
  switch (ws) {
    case 2: return launch<2>(in, batch, w32, s_cap, n, bw, out, stream);
    case 4: return launch<4>(in, batch, w32, s_cap, n, bw, out, stream);
    case 8: return launch<8>(in, batch, w32, s_cap, n, bw, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
