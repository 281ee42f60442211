// What the float splits share: the exponent-plane histograms and the input
// checksum of K1 (split16_hist.cu) and K5 (split_wide_hist.cu), counted by
// one CTA over one tile of a row and added to global memory once.
//
// Exponent bytes of real data fall in a few bins (bf16's and fp64's plane 0
// in 1-2), so one shared counter a bin would take every lane's atomic on
// one address. Each plane instead has lane-private sub-histograms laid out
// [bin pair][lane]: lane l only touches bank l, so a warp's 32 increments
// go in one pass whatever the bytes are. A word holds two bins' counts in
// its 16-bit halves (bin 2i low, 2i + 1 high), so a plane takes 16 KiB of
// shared memory; a tile holds fewer than 2^16 floats, so no half carries
// into the other, not even in the sum of a bin pair's 32 lanes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace split_hist {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxTileFloats = 65535;  // counts a tile may add to one bin

// The shared histogram words of a CTA: kPlanes * 128 bin pairs of 32 lanes.
template <int kPlanes>
__host__ __device__ constexpr int words() {
  return kPlanes * 128 * 32;
}

// Keeps the first clamp(nbytes, 0, 4) little-endian bytes of a word.
__device__ __forceinline__ uint32_t byte_mask(int nbytes) {
  return nbytes >= 4 ? 0xFFFFFFFFu
                     : (nbytes <= 0 ? 0u : (1u << (8 * nbytes)) - 1u);
}

// sh[i] = 0 for the CTA's histogram words, by the whole CTA; the caller
// syncs before the first count.
template <int kThreads, int kPlanes>
__device__ __forceinline__ void zero(uint32_t* sh) {
  for (int i = threadIdx.x; i < words<kPlanes>() / 4; i += kThreads) {
    reinterpret_cast<uint4*>(sh)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// One count of plane p's byte value bin, where live, in this lane's column.
__device__ __forceinline__ void count_byte(uint32_t* sh, int p, uint32_t bin,
                                           bool live) {
  if (live) {
    atomicAdd(&sh[(p * 128 + (bin >> 1)) * 32 + (threadIdx.x & 31)],
              1u << ((bin & 1) << 4));
  }
}

// The CTA's counts held in shared memory, added to global memory: the
// checksum byte (x, this thread's XOR of masked input words, folded over
// the CTA and its 4 byte positions, which is linear) into csum[row], and
// plane p's bin counts (each bin pair's 32 lanes) into
// hist[(p * batch + row) * 256 + bin]. Every thread of the CTA calls it.
template <int kThreads, int kPlanes>
__device__ __forceinline__ void flush(const uint32_t* sh, uint32_t* sh_xor,
                                      uint32_t x, int64_t row, int64_t batch,
                                      unsigned int* hist, unsigned int* csum) {
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(kFull, x, o);
  if ((threadIdx.x & 31) == 0) sh_xor[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t ^= sh_xor[w];
    t ^= t >> 16;
    t ^= t >> 8;
    t &= 0xFFu;
    if (t) atomicXor(&csum[row], t);
  }
  for (int i = threadIdx.x; i < kPlanes * 256; i += kThreads) {
    // bin i's pair word, its 32 lanes each thread starting at another bank
    // (the two threads of a pair read the same words)
    const int w = i >> 1;
    uint32_t v = 0;
    for (int l = 0; l < 32; ++l) v += sh[w * 32 + ((l + w) & 31)];
    v = (i & 1) ? v >> 16 : v & 0xFFFFu;
    if (v) atomicAdd(&hist[((i / 256) * batch + row) * 256 + i % 256], v);
  }
}

}  // namespace split_hist
