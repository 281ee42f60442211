// K8: 256-bin byte histogram and XOR checksum of each member's first
// sizes[b] bytes, in one read; or, in its checksum-only form, the checksum
// alone.
//
// Replaces two Pallas kernels of the JAX package's
// ops/pallas/histogram_mxu.py: _hist_kernel (u8 rows, histogram_mxu) and
// _hist_kernel_packed (u32 rows, histogram_mxu_packed). The TPU counts with
// a one-hot nibble product on its matrix unit and subtracts the zero padding
// from bin 0 afterwards; here the contract is ported, not the product: bytes
// at or past sizes[b] are never counted. The same pass folds the checksum of
// the bytes it counts (the reference's checksumBatch + ansHistogramBatch).
// Contract: dietgpu_fork_torch/ops/histogram.py::byte_hist_plain.
//
// Grid (chunk, member); a CTA of 256 threads counts one 64 KiB chunk of one
// row with 16 B loads (neighbouring threads on neighbouring addresses).
// Each warp counts into its own shared-memory sub-histogram with shared
// atomics, so lanes contend within a warp only; at the end the CTA sums its
// 8 sub-histograms and adds each nonzero bin to the member's histogram
// with one global atomicAdd. The checksum: each thread XORs the words it read,
// folds them to a byte (XOR is linear, so folding first is exact), the warp
// XOR-reduces by shuffles and one lane atomicXors the member's word.
//
// The checksum-only form (kHist = false, dgt_byte_checksum; contract
// ops/checksum.py::checksum_batched) has no histogram and no counters, and
// reads the rows in place at any base and row stride, as the decoded rows
// lie: 16-bit words32 rows and raw ANS rows need not start on 16 B. Its
// chunks tile each row from the 16 B boundary at or below the row's start;
// a load that holds bytes before the start or at or past sizes[b] masks
// them out (XOR does not care where a byte sits), and a chunk wholly live
// issues its 16 loads a thread before it folds any. An aligned 16 B load
// that holds one live byte never leaves that byte's page.
//
// Bound on the card: device memory, one read of the rows. Bytes that all
// fall in one bin cost the counters no more than bytes spread over many:
// on an H100 80GB HBM3 at 700 W, 32 MiB of N(0,1) bf16 bytes took 0.0151 ms
// of device time and 32 MiB of one byte value 0.0107 (chip_smoke.py
// --profile). The checksum-only form read 300 MB of live bytes in 5 rows
// of 120 MB in 0.113 ms, 80% of its bound (chip_smoke.py's
// time_checksum_form).

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecPerThread = 16;
constexpr int64_t kChunk = (int64_t)kThreads * 16 * kVecPerThread;  // 64 KiB

__device__ __forceinline__ void count_word(int* h, uint32_t w) {
  atomicAdd(&h[w & 0xFFu], 1);
  atomicAdd(&h[(w >> 8) & 0xFFu], 1);
  atomicAdd(&h[(w >> 16) & 0xFFu], 1);
  atomicAdd(&h[w >> 24], 1);
}

// w with its bytes j outside [a, c) zeroed
__device__ __forceinline__ uint32_t keep_bytes(uint32_t w, int64_t a,
                                               int64_t c) {
  const int lo = a < 0 ? 0 : (a > 4 ? 4 : (int)a);
  const int hi = c < 0 ? 0 : (c > 4 ? 4 : (int)c);
  if (hi <= lo) return 0;
  const uint32_t m = (uint32_t)((1ull << (8 * hi)) - 1) &
                     ~(uint32_t)((1ull << (8 * lo)) - 1);
  return w & m;
}

// the warp's XOR of each lane's x, folded to a byte, into *csum
template <typename Sum>
__device__ __forceinline__ void fold_checksum(uint32_t x, int tid, Sum* csum) {
  x ^= x >> 16;
  x ^= x >> 8;
  x &= 0xFFu;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xFFFFFFFFu, x, o);
  if ((tid & 31) == 0 && x) atomicXor(csum, (Sum)x);
}

// kHist: the histogram and the checksum of 16 B aligned rows of row_bytes
// each, i32 sizes and u32 checksums; else the checksum alone of rows
// row_stride bytes apart, at any base, i64 sizes and u64 checksums (the
// caller's own types, so it converts neither).
template <bool kHist>
__global__ void __launch_bounds__(kThreads)
byte_hist_kernel(const uint8_t* __restrict__ data, int64_t row_stride,
                 int64_t row_bytes,
                 const std::conditional_t<kHist, int32_t, int64_t>* __restrict__ sizes,
                 int32_t* __restrict__ hist,
                 std::conditional_t<kHist, uint32_t, unsigned long long>* __restrict__ csum) {
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  int64_t size = sizes[b];
  size = size < 0 ? 0 : (size > row_bytes ? row_bytes : size);
  const int64_t start = (int64_t)blockIdx.x * kChunk;

  if constexpr (!kHist) {
    // the live bytes are [lo, hi) from the 16 B boundary at or below the
    // row's start
    const uint8_t* row = data + b * row_stride;
    const int64_t lo = (int64_t)(reinterpret_cast<uintptr_t>(row) & 15u);
    const uint8_t* base = row - lo;
    const int64_t hi = lo + size;
    if (size == 0 || start >= hi) return;
    uint32_t x = 0;
    if (start >= lo && start + kChunk <= hi) {
      uint4 v[kVecPerThread];
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k)
        v[k] = *reinterpret_cast<const uint4*>(
            base + start + ((int64_t)k * kThreads + tid) * 16);
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k)
        x ^= v[k].x ^ v[k].y ^ v[k].z ^ v[k].w;
    } else {
      const int64_t end = start + kChunk < hi ? start + kChunk : hi;
      for (int64_t off = start + (int64_t)tid * 16; off < end;
           off += (int64_t)kThreads * 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(base + off);
        x ^= keep_bytes(v.x, lo - off, hi - off) ^
             keep_bytes(v.y, lo - off - 4, hi - off - 4) ^
             keep_bytes(v.z, lo - off - 8, hi - off - 8) ^
             keep_bytes(v.w, lo - off - 12, hi - off - 12);
      }
    }
    fold_checksum(x, tid, &csum[b]);
  } else {
    __shared__ int sh[kWarps][256];
    const int warp = tid / 32;
    for (int i = tid; i < kWarps * 256; i += kThreads) (&sh[0][0])[i] = 0;
    __syncthreads();

    const int64_t end = start + kChunk < size ? start + kChunk : size;
    const uint8_t* row = data + b * row_stride;
    int* h = sh[warp];
    uint32_t x = 0;
    for (int64_t off = start + (int64_t)tid * 16; off < end;
         off += (int64_t)kThreads * 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + off);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      const int64_t rem = end - off;
      if (rem >= 16) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          x ^= w[k];
          count_word(h, w[k]);
        }
      } else {
        for (int j = 0; j < rem; ++j) {
          const uint32_t byte = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
          x ^= byte;
          atomicAdd(&h[byte], 1);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < 256; i += kThreads) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += sh[w][i];
      if (c) atomicAdd(&hist[b * 256 + i], c);
    }
    fold_checksum(x, tid, &csum[b]);
  }
}

}  // namespace

// data: u8[B, row_bytes], 16 B aligned rows, row_bytes % 16 == 0; sizes:
// i32[B]. Adds into hist i32[B, 256] and XORs into csum u32[B], which the
// caller zeroes. Returns cudaGetLastError() after the launch.
extern "C" int dgt_byte_hist(const void* data, long long batch,
                             long long row_bytes, const void* sizes,
                             void* hist, void* csum, void* stream) {
  const long long chunks = row_bytes > 0 ? (row_bytes + kChunk - 1) / kChunk : 1;
  dim3 grid((unsigned)chunks, (unsigned)batch);
  byte_hist_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, row_bytes, row_bytes, (const int32_t*)sizes,
      (int32_t*)hist, (uint32_t*)csum);
  return (int)cudaGetLastError();
}

// The checksum-only form. data: B rows of row_bytes bytes, row b at data +
// b * row_stride, at any base and stride; sizes: i64[B]. XORs the XOR of
// each row's first sizes[b] bytes into csum u64[B], which the caller
// zeroes. Returns cudaGetLastError() after the launch.
extern "C" int dgt_byte_checksum(const void* data, long long batch,
                                 long long row_stride, long long row_bytes,
                                 const void* sizes, void* csum, void* stream) {
  // a row's bytes span at most row_bytes + 15 from its 16 B boundary
  const long long chunks = (row_bytes + 15 + kChunk - 1) / kChunk;
  dim3 grid((unsigned)chunks, (unsigned)batch);
  byte_hist_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, row_stride, row_bytes, (const int64_t*)sizes,
      nullptr, (unsigned long long*)csum);
  return (int)cudaGetLastError();
}
