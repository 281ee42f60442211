// K1: 16-bit float split with the exponent-plane histogram and the input
// checksum, in one pass over the input; and the split alone.
//
// dgt_split16_hist replaces the JAX package's
// ops/pallas/float_split_fused.py::_split16_hist_kernel (entry
// split_hist_packed_tpu). Contract: dietgpu_fork_torch/ops/float_split.py
// ::split16_hist_plain, the JAX package's split_packed + histogram_packed +
// checksum_packed + mask_packed_bytes.
//
// dgt_split16 (kHist = false) replaces ::_split16_kernel (entry
// split_packed_tpu): the same split with no histogram, no checksum and no
// tail mask. Contract: ops/float_split.py::split16_plain, the JAX package's
// split_packed.
//
// Per row b of u32 words (two 16-bit floats each), for each pair of input
// words (4 floats) one exponent-plane word and one raw-section word:
//   bf16 first rotates each 16-bit half left by 1 (sign into the raw byte);
//   exp = the 4 high bytes, raw = the 4 low bytes, raw bytes >= n zeroed;
//   hist[b] counts the exponent bytes of floats < n;
//   csum[b] = XOR of the first 2n input bytes.
//
// Bound on the card: device memory, per float 2 B read and 2 B written
// (the exponent plane is capacity-sized and unmasked, so the whole row is
// read whatever n is). Design, K5's carried to 16 bits: a CTA of 512
// threads takes one tile of a row (4096 pairs, 32 KiB of input), 4 chunks
// of 16 B (4 input words, 2 pairs) a thread, and starts all of its tile's
// loads before its first store; a chunk gives 8 B of plane and 8 B of raw,
// stored as uint2. Indices inside a tile are 32-bit from one int64 base,
// and a chunk's tail mask is taken once (a branch only the chunk that holds
// the count takes). The histogram is lane-private, two bins a word
// (csrc/split_hist.cuh, shared with K5), so a warp's increments go in one
// pass on one-bin data too, and a CTA flushes it once. Its 16 Mi shared
// atomics a 16Mi-float call are what the histogram costs over the split
// alone. A one-off sweep on an H100 chose 512 threads and 4 chunks a
// thread over 256 x 8 (the first design), 256 x 4, 512 x 2 and 1024 x 1-2,
// and counting after all of a thread's stores.
//
// Row phase: a row of W32 = 2 (mod 4) words may start 8 B past a 16 B
// boundary, and its output rows (W32/2 words) 4 B past an 8 B one. A tile
// then takes its first pair alone, so its chunks are 16 B aligned on the
// input and 8 B aligned on both outputs; a pair left at the tile's end
// goes alone too (one pair a thread, 4 B accesses). A row whose input or
// outputs cannot be aligned so (a base 4 B past an 8 B boundary) takes every
// pair alone: slower, right at any 4 B phase, and off the main paths.

#include <cstdint>
#include <cuda_runtime.h>

#include "split_hist.cuh"

namespace {

using split_hist::byte_mask;
using split_hist::count_byte;

constexpr int kThreads = 512;
constexpr int kUnits = 4;                         // 16 B chunks a thread a tile
constexpr int kTilePairs = 2 * kThreads * kUnits;  // input word pairs a tile
static_assert(4 * kTilePairs <= split_hist::kMaxTileFloats,
              "a tile's counts fit a bin's 16 bits");

__device__ __forceinline__ uint32_t rotl16x2(uint32_t x) {
  return ((x << 1) & 0xFFFEFFFEu) | ((x >> 15) & 0x00010001u);
}

// One pair of input words (4 floats) -> its exponent-plane word (the high
// bytes) and raw-section word (the low bytes).
template <bool kBf16>
__device__ __forceinline__ void split_pair(uint32_t a0, uint32_t a1,
                                           uint32_t& e, uint32_t& r) {
  if constexpr (kBf16) {
    a0 = rotl16x2(a0);
    a1 = rotl16x2(a1);
  }
  e = __byte_perm(a0, a1, 0x7531);
  r = __byte_perm(a0, a1, 0x6420);
}

// kHist: the histogram, the checksum and the tail mask at n; else the split
// alone (n, hist and csum unused). CTA (x, y) takes tile x of row y.
template <bool kHist, bool kBf16>
__global__ void __launch_bounds__(kThreads)
split16_hist_kernel(const uint32_t* __restrict__ in, int64_t w32,
                    int64_t batch, const int32_t* __restrict__ n,
                    uint32_t* __restrict__ exp_out,
                    uint32_t* __restrict__ raw_out,
                    unsigned int* __restrict__ hist,
                    unsigned int* __restrict__ csum) {
  __shared__ __align__(16) uint32_t sh_hist[kHist ? split_hist::words<1>() : 4];
  __shared__ uint32_t sh_xor[kThreads / 32];
  if constexpr (kHist) {
    split_hist::zero<kThreads, 1>(sh_hist);
    __syncthreads();
  }

  const int64_t half = w32 / 2;  // pairs a row
  const int64_t b = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kTilePairs;  // the tile's first pair
  const int tp = (int)(half - p0 < kTilePairs ? half - p0 : kTilePairs);
  // the tile's input, its plane words and its raw words, pair q at word q
  const uint32_t* t_in = in + b * w32 + 2 * p0;
  uint32_t* t_e = exp_out + b * half + p0;
  uint32_t* t_r = raw_out + b * half + p0;
  // chunks from pair c0 on, nc of them; the pairs before and after go alone
  const uintptr_t ia = reinterpret_cast<uintptr_t>(t_in);
  const int h = (int)((ia >> 3) & 1);
  const bool vec = (ia & 7) == 0 &&
                   ((reinterpret_cast<uintptr_t>(t_e + h) |
                     reinterpret_cast<uintptr_t>(t_r + h)) & 7) == 0;
  const int c0 = vec ? h : 0;
  const int nc = vec ? (tp - h) / 2 : 0;
  // the tile's floats below n
  int lim = 4 * tp;
  if constexpr (kHist) {
    const int64_t nl = n[b] - 4 * p0;
    lim = nl <= 0 ? 0 : (nl < lim ? (int)nl : lim);
  }
  uint32_t x = 0;

  const uint4* src = reinterpret_cast<const uint4*>(t_in + 2 * c0);
  uint2* e_dst = reinterpret_cast<uint2*>(t_e + c0);
  uint2* r_dst = reinterpret_cast<uint2*>(t_r + c0);
  uint4 v[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int c = k * kThreads + threadIdx.x;
    if (c < nc) v[k] = __ldg(src + c);
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int c = k * kThreads + threadIdx.x;  // the chunk in the tile
    if (c >= nc) continue;
    const uint4 a = v[k];
    uint32_t e0, r0, e1, r1;
    split_pair<kBf16>(a.x, a.y, e0, r0);
    split_pair<kBf16>(a.z, a.w, e1, r1);
    if constexpr (kHist) {
      // floats of the chunk below n
      const int left = min(max(lim - 4 * (c0 + 2 * c), 0), 8);
      if (left == 8) {
        x ^= a.x ^ a.y ^ a.z ^ a.w;
      } else {  // the chunk that holds the count, or one past it
        x ^= (a.x & byte_mask(2 * left)) ^ (a.y & byte_mask(2 * left - 4)) ^
             (a.z & byte_mask(2 * left - 8)) ^ (a.w & byte_mask(2 * left - 12));
        r0 &= byte_mask(left);
        r1 &= byte_mask(left - 4);
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        count_byte(sh_hist, 0, (e0 >> (8 * f)) & 0xFFu, f < left);
        count_byte(sh_hist, 0, (e1 >> (8 * f)) & 0xFFu, 4 + f < left);
      }
    }
    e_dst[c] = make_uint2(e0, e1);
    r_dst[c] = make_uint2(r0, r1);
  }

  // the pairs before the chunks and after them, one a thread
  const int tail0 = c0 + 2 * nc;
  for (int k = threadIdx.x; k < tp - 2 * nc; k += kThreads) {
    const int q = k < c0 ? k : tail0 + (k - c0);  // the pair in the tile
    const uint32_t a0 = __ldg(t_in + 2 * q), a1 = __ldg(t_in + 2 * q + 1);
    uint32_t e, r;
    split_pair<kBf16>(a0, a1, e, r);
    if constexpr (kHist) {
      const int left = min(max(lim - 4 * q, 0), 4);
      x ^= (a0 & byte_mask(2 * left)) ^ (a1 & byte_mask(2 * left - 4));
      r &= byte_mask(left);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        count_byte(sh_hist, 0, (e >> (8 * f)) & 0xFFu, f < left);
      }
    }
    t_e[q] = e;
    t_r[q] = r;
  }
  if constexpr (kHist) {
    split_hist::flush<kThreads, 1>(sh_hist, sh_xor, x, b, batch, hist, csum);
  }
}

// One CTA a tile of kTilePairs pairs.
template <bool kHist>
int launch(const uint32_t* in, long long batch, long long w32, const int32_t* n,
           int bf16, uint32_t* exp_out, uint32_t* raw_out, unsigned int* hist,
           unsigned int* csum, cudaStream_t s) {
  const long long tpr = (w32 / 2 + kTilePairs - 1) / kTilePairs;  // tiles a row
  if (tpr == 0) return (int)cudaSuccess;
  auto kernel = bf16 ? split16_hist_kernel<kHist, true>
                     : split16_hist_kernel<kHist, false>;
  kernel<<<dim3((unsigned)tpr, (unsigned)batch), kThreads, 0, s>>>(
      in, w32, batch, n, exp_out, raw_out, hist, csum);
  return (int)cudaGetLastError();
}

}  // namespace

// in: u32[B, w32] (w32 even, rows at any 4 B phase); n: i32[B] float
// counts; exp_out, raw_out: u32[B, w32/2]; hist: u32[B, 256] and csum:
// u32[B], both zeroed by the caller. Returns cudaGetLastError() after the
// launch.
extern "C" int dgt_split16_hist(const void* in, long long batch, long long w32,
                                const void* n, int bf16, void* exp_out,
                                void* raw_out, void* hist, void* csum,
                                void* stream) {
  return launch<true>((const uint32_t*)in, batch, w32, (const int32_t*)n, bf16,
                      (uint32_t*)exp_out, (uint32_t*)raw_out,
                      (unsigned int*)hist, (unsigned int*)csum,
                      (cudaStream_t)stream);
}

// As dgt_split16_hist without n, hist and csum: raw bytes past any count
// are kept.
extern "C" int dgt_split16(const void* in, long long batch, long long w32,
                           int bf16, void* exp_out, void* raw_out,
                           void* stream) {
  return launch<false>((const uint32_t*)in, batch, w32, nullptr, bf16,
                       (uint32_t*)exp_out, (uint32_t*)raw_out, nullptr, nullptr,
                       (cudaStream_t)stream);
}

extern "C" const char* dgt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
