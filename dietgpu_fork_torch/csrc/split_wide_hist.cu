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
// One thread per group of 4 floats (fp32: 4 input words, one 16 B load;
// fp64: 8 words, two 16 B loads), grid-stride over each row:
//   fp32: r = rotl(x, 1); exponent plane word = the 4 top bytes; sec1 = the
//         4 low halves (2 words); sec2 = the 4 third bytes (1 word);
//   fp64: each float is a (lo, hi) word pair rotated left by 1 across the
//         pair; exp0 = the 4 top bytes of v_hi, exp1 = the next bytes;
//         sec1 = the 4 v_lo words (one 16 B store); sec2 = the 4 low halves
//         of v_hi (2 words).
// With kHist, raw-section bytes at or past the member's count are zeroed.
// hist[p * B + b] counts plane p's bytes of floats < n; csum[b] = XOR of the
// first n * ws input bytes (XOR of masked words, then a fold of the 4 byte
// positions, which is linear, so each CTA folds its own part and XORs one
// byte into csum[b]).
//
// Bound on the card: device memory (fp32: 4 B read and 4 B written per
// float; fp64: 8 and 8). The histograms go to shared u32[256] per plane and
// CTA with shared-memory atomics, then once per bin to global memory; the
// checksum is a warp XOR shuffle and one global atomic per CTA. Exponent
// bytes of real data sit in a few bins, so the shared atomics contend; per-
// warp sub-histograms are the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridX = 1024;

__device__ __forceinline__ uint32_t byte_mask(int64_t nbytes) {
  if (nbytes >= 4) return 0xFFFFFFFFu;
  if (nbytes <= 0) return 0u;
  return (1u << (8 * nbytes)) - 1u;
}

__device__ __forceinline__ uint32_t word_if(uint32_t w, int64_t i, int64_t n) {
  return i < n ? w : 0u;
}

__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

// kWide64: fp64 (two planes, 8 words per group); else fp32 (one plane).
// kHist: the histograms, the checksum and the tail mask at n; else the
// split alone (n, hist and csum unused).
template <bool kWide64, bool kHist>
__global__ void __launch_bounds__(kThreads)
split_wide_hist_kernel(const uint32_t* __restrict__ in, int64_t w32,
                       int64_t batch, const int32_t* __restrict__ n,
                       uint32_t* __restrict__ exp_out,
                       uint32_t* __restrict__ sec1_out,
                       uint32_t* __restrict__ sec2_out,
                       unsigned int* __restrict__ hist,
                       unsigned int* __restrict__ csum) {
  constexpr int kPlanes = kWide64 ? 2 : 1;
  constexpr int kGroupWords = kWide64 ? 8 : 4;
  __shared__ unsigned int sh_hist[kPlanes][kHist ? 256 : 1];
  __shared__ uint32_t sh_xor[kThreads / 32];
  const int64_t b = blockIdx.y;
  if constexpr (kHist) {
    for (int i = threadIdx.x; i < kPlanes * 256; i += blockDim.x) {
      sh_hist[i / 256][i % 256] = 0;
    }
    __syncthreads();
  }

  // without kHist every float counts as below n: no mask
  const int64_t nf = kHist ? n[b] : (int64_t)1 << 40;
  const int64_t groups = w32 / kGroupWords;  // exponent-plane words
  const uint32_t* row = in + b * w32;
  uint32_t x = 0;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < groups;
       j += (int64_t)gridDim.x * blockDim.x) {
    const int64_t left = nf - 4 * j;  // floats of this group below n
    uint32_t e0, e1 = 0;
    if constexpr (!kWide64) {
      const uint4 a = *reinterpret_cast<const uint4*>(row + 4 * j);
      if constexpr (kHist) {
        x ^= word_if(a.x, 0, left) ^ word_if(a.y, 1, left) ^
             word_if(a.z, 2, left) ^ word_if(a.w, 3, left);
      }
      const uint32_t r0 = (a.x << 1) | (a.x >> 31);
      const uint32_t r1 = (a.y << 1) | (a.y >> 31);
      const uint32_t r2 = (a.z << 1) | (a.z >> 31);
      const uint32_t r3 = (a.w << 1) | (a.w >> 31);
      e0 = pack4(r0 >> 24, r1 >> 24, r2 >> 24, r3 >> 24);
      const uint32_t t = pack4((r0 >> 16) & 0xFFu, (r1 >> 16) & 0xFFu,
                               (r2 >> 16) & 0xFFu, (r3 >> 16) & 0xFFu);
      uint2 s1;
      s1.x = ((r0 & 0xFFFFu) | (r1 << 16)) & byte_mask(2 * left);
      s1.y = ((r2 & 0xFFFFu) | (r3 << 16)) & byte_mask(2 * left - 4);
      exp_out[b * groups + j] = e0;
      *reinterpret_cast<uint2*>(sec1_out + b * (w32 / 2) + 2 * j) = s1;
      sec2_out[b * groups + j] = t & byte_mask(left);
    } else {
      const uint4 a = *reinterpret_cast<const uint4*>(row + 8 * j);
      const uint4 c = *reinterpret_cast<const uint4*>(row + 8 * j + 4);
      const int64_t lw = 2 * left;  // input words of this group below 2n
      if constexpr (kHist) {
        x ^= word_if(a.x, 0, lw) ^ word_if(a.y, 1, lw) ^ word_if(a.z, 2, lw) ^
             word_if(a.w, 3, lw) ^ word_if(c.x, 4, lw) ^ word_if(c.y, 5, lw) ^
             word_if(c.z, 6, lw) ^ word_if(c.w, 7, lw);
      }
      const uint32_t lo[4] = {a.x, a.z, c.x, c.z};
      const uint32_t hi[4] = {a.y, a.w, c.y, c.w};
      uint32_t vh[4], vl[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        vh[f] = (hi[f] << 1) | (lo[f] >> 31);
        vl[f] = ((lo[f] << 1) | (hi[f] >> 31)) & byte_mask(4 * (left - f));
      }
      e0 = pack4(vh[0] >> 24, vh[1] >> 24, vh[2] >> 24, vh[3] >> 24);
      e1 = pack4((vh[0] >> 16) & 0xFFu, (vh[1] >> 16) & 0xFFu,
                 (vh[2] >> 16) & 0xFFu, (vh[3] >> 16) & 0xFFu);
      uint2 s2;
      s2.x = ((vh[0] & 0xFFFFu) | (vh[1] << 16)) & byte_mask(2 * left);
      s2.y = ((vh[2] & 0xFFFFu) | (vh[3] << 16)) & byte_mask(2 * left - 4);
      exp_out[b * groups + j] = e0;
      exp_out[(batch + b) * groups + j] = e1;
      *reinterpret_cast<uint4*>(sec1_out + b * (w32 / 2) + 4 * j) =
          make_uint4(vl[0], vl[1], vl[2], vl[3]);
      *reinterpret_cast<uint2*>(sec2_out + b * (w32 / 4) + 2 * j) = s2;
    }
    if constexpr (kHist) {
      for (int k = 0; k < 4; ++k) {
        if (k < left) {
          atomicAdd(&sh_hist[0][(e0 >> (8 * k)) & 0xFFu], 1u);
          if constexpr (kWide64) {
            atomicAdd(&sh_hist[kPlanes - 1][(e1 >> (8 * k)) & 0xFFu], 1u);
          }
        }
      }
    }
  }

  if constexpr (kHist) {
    for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xFFFFFFFFu, x, o);
    if ((threadIdx.x & 31) == 0) sh_xor[threadIdx.x >> 5] = x;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t t = 0;
      for (int w = 0; w < kThreads / 32; ++w) t ^= sh_xor[w];
      t ^= t >> 16;
      t ^= t >> 8;
      t &= 0xFFu;
      if (t) atomicXor(&csum[b], t);
    }
    for (int i = threadIdx.x; i < kPlanes * 256; i += blockDim.x) {
      const unsigned int v = sh_hist[i / 256][i % 256];
      if (v) atomicAdd(&hist[((i / 256) * batch + b) * 256 + i % 256], v);
    }
  }
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
  const long long groups = w32 / (fp64 ? 8 : 4);
  long long gx = (groups + kThreads - 1) / kThreads;
  if (gx < 1) gx = 1;
  if (gx > kMaxGridX) gx = kMaxGridX;
  dim3 grid((unsigned)gx, (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* x = (const uint32_t*)in;
  if (fp64) {
    split_wide_hist_kernel<true, true><<<grid, kThreads, 0, s>>>(
        x, w32, batch, (const int32_t*)n, (uint32_t*)exp_out,
        (uint32_t*)sec1_out, (uint32_t*)sec2_out, (unsigned int*)hist,
        (unsigned int*)csum);
  } else {
    split_wide_hist_kernel<false, true><<<grid, kThreads, 0, s>>>(
        x, w32, batch, (const int32_t*)n, (uint32_t*)exp_out,
        (uint32_t*)sec1_out, (uint32_t*)sec2_out, (unsigned int*)hist,
        (unsigned int*)csum);
  }
  return (int)cudaGetLastError();
}

// As dgt_split_wide_hist without n, hist and csum: raw-section bytes past
// any count are kept.
extern "C" int dgt_split_wide(const void* in, long long batch, long long w32,
                              int fp64, void* exp_out, void* sec1_out,
                              void* sec2_out, void* stream) {
  const long long groups = w32 / (fp64 ? 8 : 4);
  long long gx = (groups + kThreads - 1) / kThreads;
  if (gx < 1) gx = 1;
  if (gx > kMaxGridX) gx = kMaxGridX;
  dim3 grid((unsigned)gx, (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* x = (const uint32_t*)in;
  if (fp64) {
    split_wide_hist_kernel<true, false><<<grid, kThreads, 0, s>>>(
        x, w32, batch, nullptr, (uint32_t*)exp_out, (uint32_t*)sec1_out,
        (uint32_t*)sec2_out, nullptr, nullptr);
  } else {
    split_wide_hist_kernel<false, false><<<grid, kThreads, 0, s>>>(
        x, w32, batch, nullptr, (uint32_t*)exp_out, (uint32_t*)sec1_out,
        (uint32_t*)sec2_out, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
