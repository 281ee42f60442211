// K15: the rank scan of the sparse codec's bitmaps, which compaction (K10)
// and expansion (K11) read:
//
//   ranks[b, w] = set bits of floats < n[b] in bitmap words 0 .. w - 1,
//   ranks[b, bw] = the member's nonzero count
//
// Replaces the scan the JAX package's ops/pallas/sparse_stream.py computes
// in XLA before its kernels (compact_by_bitmap, expand_by_bitmap: the
// popcounts and jnp.cumsum of the bitmap words). Contract:
// dietgpu_fork_torch/ops/sparse_stream.py::word_ranks_plain. Bits of floats
// at or past n[b] are dropped as ops/bitmap_pack.py::bits_below drops them,
// MSB first per byte, so n may end mid-byte or mid-word.
//
// Bound on the card: device memory, a read of the bitmap words below n and
// a write of the ranks, at 3.35 TB/s.
//
// Design: reduce, then scan, two launches behind one C entry. A CTA owns a
// tile of kTileWords words; warp k of it words 512 k .. 512 k + 511, lane l
// of the warp words 32 j + l of those, so every load and store of a warp
// is one coalesced 128 B line. Pass 1 writes each tile's masked popcount
// sum. Pass 2 sums the sums of the tiles before its own (a few hundred at
// most at the sizes the codec sees), scans its words with warp shuffles,
// and writes their ranks; the row's last tile writes the total. The bitmap
// is read twice, which costs less than a single pass's look-back across
// CTAs, whose status words would need zeroing before every call.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;  // words a thread
constexpr int kTileWords = kThreads * kPer;

// Word j of this thread in tile t.
__device__ __forceinline__ int64_t word_of(int64_t t, int j) {
  return t * kTileWords + (threadIdx.x >> 5) * (32 * kPer) + 32 * j +
         (threadIdx.x & 31);
}

// The set bits of floats < n in word w of a row of bw words; 0 past it.
__device__ __forceinline__ int masked_popc(const uint32_t* row, int64_t bw,
                                           int64_t n, int64_t w) {
  const int64_t r = n - 32 * w;
  if (w >= bw || r <= 0) return 0;
  uint32_t x = __ldg(row + w);
  if (r < 32) {  // the whole bytes below n, then the partial byte's top bits
    const int fb = 8 * (int)(r >> 3);
    x &= ((1u << fb) - 1u) | (((0xFF00u >> (r & 7)) & 0xFFu) << fb);
  }
  return __popc(x);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(const uint32_t* __restrict__ bm, int64_t bw,
                 const int64_t* __restrict__ n, int64_t ntiles,
                 int32_t* __restrict__ tsum) {
  __shared__ int sh[kWarps];
  const int64_t b = blockIdx.y;
  const int64_t t = blockIdx.x;
  const uint32_t* row = bm + b * bw;
  const int64_t nb = n[b];
  int s = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) s += masked_popc(row, bw, nb, word_of(t, j));
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) tot += sh[k];
    tsum[b * ntiles + t] = tot;
  }
}

__global__ void __launch_bounds__(kThreads)
ranks_kernel(const uint32_t* __restrict__ bm, int64_t bw,
             const int64_t* __restrict__ n, int64_t ntiles,
             const int32_t* __restrict__ tsum, int32_t* __restrict__ out) {
  __shared__ int sh_warp[kWarps];
  __shared__ int sh_before[kWarps];
  const int64_t b = blockIdx.y;
  const int64_t t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* row = bm + b * bw;
  const int64_t nb = n[b];
  int pc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) pc[j] = masked_popc(row, bw, nb, word_of(t, j));
  int before = 0;  // the bits of the tiles before this one
  for (int64_t k = threadIdx.x; k < t; k += kThreads) before += __ldg(tsum + b * ntiles + k);
  // the warp's words in order: step j, then lane
  int ex[kPer];
  int carry = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int x = pc[j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane >= d) x += y;
    }
    ex[j] = carry + x - pc[j];
    carry += __shfl_sync(0xFFFFFFFFu, x, 31);
  }
  before = warp_sum(before);
  if (lane == 0) {
    sh_warp[warp] = carry;
    sh_before[warp] = before;
  }
  __syncthreads();
  int pre = 0, tile = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    pre += sh_before[k] + (k < warp ? sh_warp[k] : 0);
    tile += sh_warp[k];
  }
  int32_t* orow = out + b * (bw + 1);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t w = word_of(t, j);
    if (w < bw) orow[w] = pre + ex[j];
  }
  if (t == ntiles - 1 && threadIdx.x == 0) {
    int tot = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) tot += sh_before[k];
    orow[bw] = tot + tile;
  }
}

}  // namespace

// bm: u32[B, bw] MSB-first bitmap words (bw >= 0, 32 bw < 2^31); n: i64[B]
// float counts; tsum: i32 scratch of tsum_len >= B * max(1, ceil(bw /
// 4096)) words; out: i32[B, bw + 1]. Returns cudaGetLastError() after
// each launch, or cudaErrorInvalidValue for a short tsum.
extern "C" int dgt_word_ranks(const void* bm, long long batch, long long bw,
                              const void* n, void* tsum, long long tsum_len,
                              void* out, void* stream) {
  const long long ntiles = bw > 0 ? (bw + kTileWords - 1) / kTileWords : 1;
  if (batch < 1 || tsum_len < batch * ntiles) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)ntiles, (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  tile_sums_kernel<<<grid, kThreads, 0, s>>>(
      (const uint32_t*)bm, bw, (const int64_t*)n, ntiles, (int32_t*)tsum);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ranks_kernel<<<grid, kThreads, 0, s>>>(
      (const uint32_t*)bm, bw, (const int64_t*)n, ntiles,
      (const int32_t*)tsum, (int32_t*)out);
  return (int)cudaGetLastError();
}
