// K5: fp32 and fp64 float split with the exponent-plane histograms and the
// input checksum, in one pass over the input; one template for both types;
// and the split alone.
//
// dgt_split_wide_hist replaces the JAX package's
// ops/pallas/float_split_fused.py::_split32_hist_kernel and
// ::_split64_hist_kernel (entry split_hist_packed_tpu). Contract:
// dietgpu_fork_torch/ops/float_split.py::split_wide_hist_plain, the JAX
// package's portable split_packed + histogram_packed + checksum_packed +
// mask_packed_bytes.
//
// dgt_split_wide (kHist = false) replaces ::_split32_kernel and
// ::_split64_kernel (entry split_packed_tpu): the same split with no
// histograms, no checksum and no tail mask. Contract:
// ops/float_split.py::split_wide_plain, the JAX package's split_packed.
//
// A thread takes 16 B chunks of input (fp32: 4 floats; fp64: 2 floats, a
// (lo, hi) word pair each), consecutive lanes consecutive chunks:
//   fp32: r = rotl(x, 1); exponent plane word = the 4 top bytes; sec1 = the
//         4 low halves (2 words); sec2 = the 4 third bytes (1 word);
//   fp64: each float is a (lo, hi) word pair rotated left by 1 across the
//         pair; exp0 = the top bytes of v_hi, exp1 = the next bytes, each 4
//         floats a word, so a lane pair joins its halves of the two plane
//         words with one shuffle and the even lane stores them; sec1 = the
//         v_lo words (8 B a lane); sec2 = the low halves of v_hi (1 word).
// With kHist, raw-section bytes at or past the member's count are zeroed.
// hist[p * B + b] counts plane p's bytes of floats < n; csum[b] = XOR of the
// first n * ws input bytes (XOR of masked words, then a fold of the 4 byte
// positions, which is linear, so each CTA folds its own part and XORs one
// byte into csum[b]).
//
// Bound on the card: device memory (fp32: 4 B read and 4 B written per
// float; fp64: 8 and 8). Design: a CTA takes one tile of a row, kSplitUnits
// 16 B chunks a thread; each thread issues all of its tile's loads before
// its first store, indices inside a tile are 32-bit from one int64 base,
// and a chunk's tail mask is taken once (a branch only the chunk that holds
// the count takes). The histograms are lane-private sub-histograms, two
// bins a word (csrc/split_hist.cuh, shared with K1): 16 KiB of shared
// memory a plane, so a warp's increments go in one pass whatever the bytes
// are; at its end a CTA adds its counts to global memory. A one-off sweep
// on an H100 chose 256 threads and 8 chunks a thread; warp-aggregated
// counting (__match_any_sync, one atomic a distinct bin a warp) was slower
// than the lane columns on fp64.

#include <cstdint>
#include <cuda_runtime.h>

#include "split_hist.cuh"

namespace {

using split_hist::byte_mask;
using split_hist::count_byte;
using split_hist::kFull;

constexpr int kSplitThreads = 256;
constexpr int kSplitUnits = 8;  // 16 B chunks a thread a tile
constexpr int kTileChunks = kSplitThreads * kSplitUnits;
static_assert(4 * kTileChunks <= split_hist::kMaxTileFloats,
              "a tile's counts fit a bin's 16 bits");

__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

// kWide64: fp64 (two planes); else fp32 (one plane). kHist: the histograms,
// the checksum and the tail mask at n; else the split alone (n, hist and
// csum unused). CTA (x, y) takes tile x of row y.
template <bool kWide64, bool kHist>
__global__ void __launch_bounds__(kSplitThreads)
split_wide_hist_kernel(const uint32_t* __restrict__ in, int64_t w32,
                       int64_t batch, const int32_t* __restrict__ n,
                       uint32_t* __restrict__ exp_out,
                       uint32_t* __restrict__ sec1_out,
                       uint32_t* __restrict__ sec2_out,
                       unsigned int* __restrict__ hist,
                       unsigned int* __restrict__ csum) {
  constexpr int kPlanes = kWide64 ? 2 : 1;
  constexpr int kPer = kWide64 ? 2 : 4;  // floats a chunk
  __shared__ __align__(16) uint32_t sh_hist[kHist ? split_hist::words<kPlanes>() : 4];
  __shared__ uint32_t sh_xor[kSplitThreads / 32];
  const int lane = threadIdx.x & 31;
  if constexpr (kHist) {
    split_hist::zero<kSplitThreads, kPlanes>(sh_hist);
    __syncthreads();
  }

  const int64_t chunks = w32 / 4;  // 16 B chunks a row
  const int64_t groups = w32 / (4 * kPlanes);  // exponent-plane words a row
  const int64_t b = blockIdx.y;
  const int64_t t0 = (int64_t)blockIdx.x * kTileChunks;  // the tile's first chunk
  const int64_t nf = kHist ? n[b] : 0;
  uint32_t x = 0;
  // the tile's chunks in the row, and its floats below n (kHist)
  const int tc = (int)(chunks - t0 < kTileChunks ? chunks - t0 : kTileChunks);
  const int64_t nl = nf - t0 * kPer;
  const int lim = nl <= 0 ? 0 : (nl >= kTileChunks * kPer ? kTileChunks * kPer : (int)nl);
  const uint4* src = reinterpret_cast<const uint4*>(in + b * w32) + t0;
  // the tile's first plane word, sec1 word and sec2 word
  uint32_t* e_t = exp_out + b * groups + t0 / (kWide64 ? 2 : 1);
  uint32_t* s1_t = sec1_out + b * (w32 / 2) + 2 * t0;
  uint32_t* s2_t = sec2_out + b * (w32 / 4) + t0;
  uint4 v[kSplitUnits];
#pragma unroll
  for (int k = 0; k < kSplitUnits; ++k) {
    const int c = k * kSplitThreads + threadIdx.x;
    if (c < tc) v[k] = __ldg(src + c);
  }
#pragma unroll
  for (int k = 0; k < kSplitUnits; ++k) {
    const int c = k * kSplitThreads + threadIdx.x;  // the chunk in the tile
    const bool live = c < tc;
    // floats of the chunk below n
    const int left = !live ? 0 : (kHist ? min(max(lim - c * kPer, 0), kPer) : kPer);
    const uint4 a = live ? v[k] : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (!kWide64) {
      const uint32_t r[4] = {(a.x << 1) | (a.x >> 31), (a.y << 1) | (a.y >> 31),
                             (a.z << 1) | (a.z >> 31), (a.w << 1) | (a.w >> 31)};
      const uint32_t e = pack4(r[0] >> 24, r[1] >> 24, r[2] >> 24, r[3] >> 24);
      uint32_t t = pack4((r[0] >> 16) & 0xFFu, (r[1] >> 16) & 0xFFu,
                         (r[2] >> 16) & 0xFFu, (r[3] >> 16) & 0xFFu);
      uint2 s1 = make_uint2((r[0] & 0xFFFFu) | (r[1] << 16),
                            (r[2] & 0xFFFFu) | (r[3] << 16));
      if constexpr (kHist) {
        if (left == 4) {
          x ^= a.x ^ a.y ^ a.z ^ a.w;
        } else {  // the chunk that holds the count, or one past it
          x ^= (a.x & -(uint32_t)(left > 0)) ^ (a.y & -(uint32_t)(left > 1)) ^
               (a.z & -(uint32_t)(left > 2));
          s1.x &= byte_mask(2 * left);
          s1.y &= byte_mask(2 * left - 4);
          t &= byte_mask(left);
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) count_byte(sh_hist, 0, r[f] >> 24, f < left);
      }
      if (live) {
        e_t[c] = e;
        *reinterpret_cast<uint2*>(s1_t + 2 * c) = s1;
        s2_t[c] = t;
      }
    } else {
      const uint32_t vh0 = (a.y << 1) | (a.x >> 31), vh1 = (a.w << 1) | (a.z >> 31);
      uint32_t vl0 = (a.x << 1) | (a.y >> 31), vl1 = (a.z << 1) | (a.w >> 31);
      uint32_t s2 = (vh0 & 0xFFFFu) | (vh1 << 16);
      if constexpr (kHist) {
        if (left == 2) {
          x ^= a.x ^ a.y ^ a.z ^ a.w;
        } else {
          const uint32_t one = -(uint32_t)(left > 0);
          x ^= (a.x ^ a.y) & one;
          vl0 &= one;
          vl1 = 0;
          s2 &= one & 0xFFFFu;
        }
        count_byte(sh_hist, 0, vh0 >> 24, left > 0);
        count_byte(sh_hist, 0, vh1 >> 24, left > 1);
        count_byte(sh_hist, 1, (vh0 >> 16) & 0xFFu, left > 0);
        count_byte(sh_hist, 1, (vh1 >> 16) & 0xFFu, left > 1);
      }
      // this lane's half of the two plane words (floats 2 (c & 1) and the
      // next of the group), joined with the partner lane's
      const uint32_t mine = (vh0 >> 24) | ((vh1 >> 24) << 8) |
                            (((vh0 >> 16) & 0xFFu) << 16) |
                            (((vh1 >> 16) & 0xFFu) << 24);
      const uint32_t other = __shfl_xor_sync(kFull, mine, 1);
      if (live) {
        if ((lane & 1) == 0) {
          e_t[c / 2] = (mine & 0xFFFFu) | (other << 16);
          e_t[batch * groups + c / 2] = (mine >> 16) | (other & 0xFFFF0000u);
        }
        *reinterpret_cast<uint2*>(s1_t + 2 * c) = make_uint2(vl0, vl1);
        s2_t[c] = s2;
      }
    }
  }
  if constexpr (kHist) {
    split_hist::flush<kSplitThreads, kPlanes>(sh_hist, sh_xor, x, b, batch, hist, csum);
  }
}

// One CTA a tile.
template <bool kWide64, bool kHist>
int launch(const uint32_t* x, long long batch, long long w32, const int32_t* n,
           uint32_t* exp_out, uint32_t* sec1_out, uint32_t* sec2_out,
           unsigned int* hist, unsigned int* csum, cudaStream_t s) {
  const long long tpr = (w32 / 4 + kTileChunks - 1) / kTileChunks;  // tiles a row
  if (tpr == 0) return (int)cudaSuccess;
  split_wide_hist_kernel<kWide64, kHist><<<dim3((unsigned)tpr, (unsigned)batch),
                                           kSplitThreads, 0, s>>>(
      x, w32, batch, n, exp_out, sec1_out, sec2_out, hist, csum);
  return (int)cudaGetLastError();
}

}  // namespace

// in: u32[B, w32], 16 B aligned (w32 % 4 == 0 for fp32, % 8 for fp64);
// n: i32[B] float counts. Writes exp_out u32[P, B, E] (P = 1, E = w32/4 for
// fp32; P = 2, E = w32/8 for fp64), sec1_out u32[B, w32/2], sec2_out
// u32[B, w32/4]; hist u32[P, B, 256] and csum u32[B], both zeroed by the
// caller. Returns cudaGetLastError() after the launch.
extern "C" int dgt_split_wide_hist(const void* in, long long batch,
                                   long long w32, const void* n, int fp64,
                                   void* exp_out, void* sec1_out,
                                   void* sec2_out, void* hist, void* csum,
                                   void* stream) {
  auto f = fp64 ? launch<true, true> : launch<false, true>;
  return f((const uint32_t*)in, batch, w32, (const int32_t*)n,
           (uint32_t*)exp_out, (uint32_t*)sec1_out, (uint32_t*)sec2_out,
           (unsigned int*)hist, (unsigned int*)csum, (cudaStream_t)stream);
}

// As dgt_split_wide_hist without n, hist and csum: raw-section bytes past
// any count are kept.
extern "C" int dgt_split_wide(const void* in, long long batch, long long w32,
                              int fp64, void* exp_out, void* sec1_out,
                              void* sec2_out, void* stream) {
  auto f = fp64 ? launch<true, false> : launch<false, false>;
  return f((const uint32_t*)in, batch, w32, nullptr, (uint32_t*)exp_out,
           (uint32_t*)sec1_out, (uint32_t*)sec2_out, nullptr, nullptr,
           (cudaStream_t)stream);
}
