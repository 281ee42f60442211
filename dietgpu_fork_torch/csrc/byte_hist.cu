// K8: 256-bin byte histogram and XOR checksum of each member's first
// sizes[b] bytes, in one read.
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
// Bound on the card: device memory, one read of the rows. Bytes that all
// fall in one bin cost the counters no more than bytes spread over many:
// on an H100 80GB HBM3 at 700 W, 32 MiB of N(0,1) bf16 bytes took 0.0151 ms
// of device time and 32 MiB of one byte value 0.0107 (chip_smoke.py
// --profile).

#include <cstdint>
#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(kThreads)
byte_hist_kernel(const uint8_t* __restrict__ data, int64_t row_bytes,
                 const int32_t* __restrict__ sizes, int32_t* __restrict__ hist,
                 uint32_t* __restrict__ csum) {
  __shared__ int sh[kWarps][256];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  for (int i = tid; i < kWarps * 256; i += kThreads) (&sh[0][0])[i] = 0;
  __syncthreads();

  const int64_t b = blockIdx.y;
  int64_t size = sizes[b];
  size = size < 0 ? 0 : (size > row_bytes ? row_bytes : size);
  const int64_t start = (int64_t)blockIdx.x * kChunk;
  const int64_t end = start + kChunk < size ? start + kChunk : size;
  const uint8_t* row = data + b * row_bytes;
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
  x ^= x >> 16;
  x ^= x >> 8;
  x &= 0xFFu;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xFFFFFFFFu, x, o);
  if ((tid & 31) == 0 && x) atomicXor(&csum[b], x);
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
  byte_hist_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, row_bytes, (const int32_t*)sizes, (int32_t*)hist,
      (uint32_t*)csum);
  return (int)cudaGetLastError();
}
