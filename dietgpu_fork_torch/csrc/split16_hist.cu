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
//   csum[b] = XOR of the first 2n input bytes (XOR of masked words, then a
//   fold of the 4 byte positions, which is linear, so each CTA folds its
//   own part and XORs one byte into csum[b]).
//
// Bound on the card: device memory (per float 2 B read, 2 B written). The
// histogram goes to a shared u32[256] per CTA with shared-memory atomics and
// then once per bin to global memory; the checksum is a warp XOR shuffle and
// one global atomic per CTA. Exponent bytes of real data sit in a few bins,
// so the shared atomics contend; per-warp sub-histograms are the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridX = 1024;

__device__ __forceinline__ uint32_t rotl16x2(uint32_t x) {
  return ((x << 1) & 0xFFFEFFFEu) | ((x >> 15) & 0x00010001u);
}

// Keeps the first clamp(nbytes, 0, 4) little-endian bytes of a word.
__device__ __forceinline__ uint32_t byte_mask(int64_t nbytes) {
  if (nbytes >= 4) return 0xFFFFFFFFu;
  if (nbytes <= 0) return 0u;
  return (1u << (8 * nbytes)) - 1u;
}

// kHist: the histogram, the checksum and the tail mask at n; else the split
// alone (n, hist and csum unused).
template <bool kHist>
__global__ void __launch_bounds__(kThreads)
split16_hist_kernel(const uint32_t* __restrict__ in, int64_t w32,
                    const int32_t* __restrict__ n, int bf16,
                    uint32_t* __restrict__ exp_out,
                    uint32_t* __restrict__ raw_out,
                    unsigned int* __restrict__ hist,
                    unsigned int* __restrict__ csum) {
  __shared__ unsigned int sh_hist[kHist ? 256 : 1];
  __shared__ uint32_t sh_xor[kThreads / 32];
  const int64_t b = blockIdx.y;
  if constexpr (kHist) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sh_hist[i] = 0;
    __syncthreads();
  }

  const int64_t nf = kHist ? n[b] : 0;
  const int64_t half = w32 / 2;
  const uint32_t* row = in + b * w32;
  uint32_t x = 0;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < half;
       j += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t a0 = row[2 * j];
    const uint32_t a1 = row[2 * j + 1];
    if constexpr (kHist) {
      x ^= (a0 & byte_mask(2 * nf - 8 * j)) ^
           (a1 & byte_mask(2 * nf - 8 * j - 4));
    }
    const uint32_t we = bf16 ? rotl16x2(a0) : a0;
    const uint32_t wo = bf16 ? rotl16x2(a1) : a1;
    const uint32_t e = ((we >> 8) & 0xFFu) | ((we >> 24) << 8) |
                       (((wo >> 8) & 0xFFu) << 16) | ((wo >> 24) << 24);
    const uint32_t r = (we & 0xFFu) | (((we >> 16) & 0xFFu) << 8) |
                       ((wo & 0xFFu) << 16) | (((wo >> 16) & 0xFFu) << 24);
    exp_out[b * half + j] = e;
    if constexpr (kHist) {
      const int64_t left = nf - 4 * j;  // floats of this word below n
      raw_out[b * half + j] = r & byte_mask(left);
      for (int k = 0; k < 4; ++k) {
        if (k < left) atomicAdd(&sh_hist[(e >> (8 * k)) & 0xFFu], 1u);
      }
    } else {
      raw_out[b * half + j] = r;
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
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      if (sh_hist[i]) atomicAdd(&hist[b * 256 + i], sh_hist[i]);
    }
  }
}

}  // namespace

// in: u32[B, w32] (w32 even); n: i32[B] float counts; exp_out, raw_out:
// u32[B, w32/2]; hist: u32[B, 256] and csum: u32[B], both zeroed by the
// caller. Returns cudaGetLastError() after the launch.
extern "C" int dgt_split16_hist(const void* in, long long batch, long long w32,
                                const void* n, int bf16, void* exp_out,
                                void* raw_out, void* hist, void* csum,
                                void* stream) {
  const long long half = w32 / 2;
  long long gx = (half + kThreads - 1) / kThreads;
  if (gx < 1) gx = 1;
  if (gx > kMaxGridX) gx = kMaxGridX;
  dim3 grid((unsigned)gx, (unsigned)batch);
  split16_hist_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, w32, (const int32_t*)n, bf16, (uint32_t*)exp_out,
      (uint32_t*)raw_out, (unsigned int*)hist, (unsigned int*)csum);
  return (int)cudaGetLastError();
}

// As dgt_split16_hist without n, hist and csum: raw bytes past any count
// are kept.
extern "C" int dgt_split16(const void* in, long long batch, long long w32,
                           int bf16, void* exp_out, void* raw_out,
                           void* stream) {
  const long long half = w32 / 2;
  long long gx = (half + kThreads - 1) / kThreads;
  if (gx < 1) gx = 1;
  if (gx > kMaxGridX) gx = kMaxGridX;
  dim3 grid((unsigned)gx, (unsigned)batch);
  split16_hist_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, w32, nullptr, bf16, (uint32_t*)exp_out,
      (uint32_t*)raw_out, nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" const char* dgt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
