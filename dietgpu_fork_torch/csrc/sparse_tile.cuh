// What the sparse codec's tile kernels share: K10 (sparse_compact.cu) and
// K11 (sparse_expand.cu).
//
// A CTA of kThreads owns a tile of kTileBytes of floats: 4096 16-bit, 2048
// fp32 or 1024 fp64 floats, 128, 64 or 32 bitmap words, one a thread at
// most. A CTA works in phases behind barriers (load, place, store), so the
// bytes in flight come from many small CTAs: every width fits its buffers
// in static shared memory with 13 CTAs an SM for K10 and 16 for K11. Of
// CTAs of 128, 256 or 512 threads with tiles of 4 to 32 KiB, this one took
// the least time over the three widths on the card. Floats move as units
// of U: a u16 for a 16-bit float, a u32 otherwise
// (an fp64 float is two). A span of units goes between device and shared
// memory with 16 B accesses wherever both ends allow it: the shared buffer
// is entered at the same address mod 16 as the span in device memory, so
// the span's whole 16 B chunks are aligned on both sides (cp.async on the
// way in, uint4 on the way out) and only the partial chunks at its two ends
// go one unit a thread. A row may so start on any unit boundary, and a run
// of 16-bit floats that starts or ends at an odd slot shares no u32 with a
// read-modify-write: its end halves go out as u16 stores.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace sparse_tile {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 8192;

template <int WS>
struct Tile {
  using U = std::conditional_t<WS == 2, uint16_t, uint32_t>;
  static constexpr int kUnits = WS / (int)sizeof(U);    // units a float
  static constexpr int kFloats = kTileBytes / WS;       // floats a tile
  static constexpr int kWords = kFloats / 32;           // bitmap words a tile
  static constexpr int kChunk = 16 / (int)sizeof(U);    // units a 16 B chunk
  static constexpr int kBuf = kTileBytes / (int)sizeof(U) + kChunk;  // a tile and its phase
  static_assert(kWords <= kThreads, "a bitmap word a thread");
};

// Bit j of the result is float 32w + j of archive bitmap word w, which
// holds float 8k + i in bit 8k + 7 - i (MSB first per byte).
__device__ __forceinline__ uint32_t lsb_first(uint32_t w) {
  return __byte_perm(__brev(w), 0, 0x0123);
}

// Units of U from the 16 B boundary at or below address a up to a.
template <typename U>
__device__ __forceinline__ int phase(uintptr_t a) {
  return (int)((a & 15) / sizeof(U));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The units that precede the span's first 16 B boundary (at most n), and
// its whole chunks after them.
template <typename U>
__device__ __forceinline__ void split_span(const void* p, int64_t n,
                                           int64_t& head, int64_t& nq) {
  constexpr int V = 16 / (int)sizeof(U);
  const int64_t h = (V - phase<U>(reinterpret_cast<uintptr_t>(p))) % V;
  head = h < n ? h : n;
  nq = (n - head) / V;
}

// Unit k of the span's head and tail, which go one unit a thread: the
// head's units first, then the tail's from index tail0.
__device__ __forceinline__ int64_t edge_unit(int64_t k, int64_t head,
                                             int64_t tail0) {
  return k < head ? k : tail0 + (k - head);
}

// dst[i] = src[i] for i < n, by the whole CTA; dst (shared) and src lie at
// the same address mod 16. The whole chunks go by cp.async: the caller
// waits (cp_async_wait_all) and syncs before reading dst.
template <typename U>
__device__ __forceinline__ void copy_in(U* dst, const U* __restrict__ src,
                                        int64_t n) {
  constexpr int V = 16 / (int)sizeof(U);
  int64_t head, nq;
  split_span<U>(src, n, head, nq);
  for (int64_t q = threadIdx.x; q < nq; q += kThreads) {
    cp_async16(dst + head + q * V, src + head + q * V);
  }
  const int64_t tail0 = head + nq * V;
  for (int64_t k = threadIdx.x; k < head + n - tail0; k += kThreads) {
    const int64_t i = edge_unit(k, head, tail0);
    dst[i] = __ldg(src + i);
  }
}

// dst[i] = src[i] for i < n, by the whole CTA; dst (device) and src
// (shared) lie at the same address mod 16.
template <typename U>
__device__ __forceinline__ void copy_out(U* __restrict__ dst, const U* src,
                                         int64_t n) {
  constexpr int V = 16 / (int)sizeof(U);
  int64_t head, nq;
  split_span<U>(dst, n, head, nq);
  for (int64_t q = threadIdx.x; q < nq; q += kThreads) {
    *reinterpret_cast<uint4*>(dst + head + q * V) =
        *reinterpret_cast<const uint4*>(src + head + q * V);
  }
  const int64_t tail0 = head + nq * V;
  for (int64_t k = threadIdx.x; k < head + n - tail0; k += kThreads) {
    const int64_t i = edge_unit(k, head, tail0);
    dst[i] = src[i];
  }
}

// dst[i] = 0 for i < n, by the whole CTA.
template <typename U>
__device__ __forceinline__ void fill_zero(U* __restrict__ dst, int64_t n) {
  constexpr int V = 16 / (int)sizeof(U);
  int64_t head, nq;
  split_span<U>(dst, n, head, nq);
  for (int64_t q = threadIdx.x; q < nq; q += kThreads) {
    *reinterpret_cast<uint4*>(dst + head + q * V) = make_uint4(0u, 0u, 0u, 0u);
  }
  const int64_t tail0 = head + nq * V;
  for (int64_t k = threadIdx.x; k < head + n - tail0; k += kThreads) {
    dst[edge_unit(k, head, tail0)] = 0;
  }
}

// The exclusive scan of v over the CTA's threads, in thread order, with
// warp shuffles; *total gets the sum. sh: kWarps ints of shared memory,
// free again only after the caller's next barrier.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  int pre = 0, tot = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int s = sh[k];
    pre += k < warp ? s : 0;
    tot += s;
  }
  *total = tot;
  return pre + x - v;
}

}  // namespace sparse_tile
