// K14: table lookups, out = tables[row, clamp(idx, 0, H - 1)].
//
// dgt_chunked_lookup replaces the JAX package's ops/pallas/lookup.py
// ::_lookup_kernel (entry chunked_lookup): one table per member, any number
// of indices. Contract: dietgpu_fork_torch/ops/lookup.py
// ::chunked_lookup_plain, the JAX package's chunked_lookup off the TPU. A
// CTA stages its member's table in shared memory when it fits (H <=
// kSharedWords, 48 KiB: the decoder's LUT is at most 4096 words) and
// gathers from there; a larger table is read through global memory by the
// same kernel. Indices go 4 a thread with 16 B loads and stores where the
// rows are 16 B aligned, else one a thread. Bound on the card: device
// memory, the indices read and the values written once.
//
// dgt_rowwise_lookup replaces ::_rowwise_kernel (entry rowwise_lookup): a
// private table per row and at most 128 indices a row. Contract:
// ops/lookup.py::rowwise_lookup_plain. Bound on the card: latency, not
// bytes: each value is an index load followed by a table load that depends
// on it (one 32 B sector per distinct index), and a call at the walk's
// shapes (1024 rows of 128) moves under 2 MB. So every thread issues its
// index load, then its table loads, which are independent of each other,
// then one store: 4 indices a thread with a 16 B index load and a 16 B
// store where the rows allow it (k % 4 == 0, 16 B aligned), else one; and
// the grid spreads the indices flat over CTAs of 128 threads, 256 CTAs for
// 1024 x 128, so every SM takes part.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridX = 1024;
constexpr int kSharedWords = 12288;
constexpr int kRowThreads = 128;

__device__ __forceinline__ uint32_t at(const uint32_t* t, int64_t h, int i) {
  const int64_t c = i < 0 ? 0 : (i >= h ? h - 1 : i);
  return t[c];
}

// kVec: 4 indices a thread (rows 16 B aligned, n % 4 == 0).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
chunked_lookup_kernel(const uint32_t* __restrict__ tables, int64_t h,
                      const int32_t* __restrict__ idx, int64_t n,
                      uint32_t* __restrict__ out) {
  extern __shared__ uint32_t sh_tab[];
  const int64_t b = blockIdx.y;
  const uint32_t* tab = tables + b * h;
  const bool staged = h <= kSharedWords;
  if (staged) {
    for (int64_t i = threadIdx.x; i < h; i += blockDim.x) sh_tab[i] = tab[i];
    __syncthreads();
    tab = sh_tab;
  }
  const int32_t* row = idx + b * n;
  uint32_t* orow = out + b * n;
  const int64_t per = kVec ? 4 : 1;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n / per;
       j += (int64_t)gridDim.x * blockDim.x) {
    if constexpr (kVec) {
      const int4 i4 = reinterpret_cast<const int4*>(row)[j];
      reinterpret_cast<uint4*>(orow)[j] = make_uint4(
          at(tab, h, i4.x), at(tab, h, i4.y), at(tab, h, i4.z), at(tab, h, i4.w));
    } else {
      orow[j] = at(tab, h, row[j]);
    }
  }
}

// n = r * k indices, flat; kVec: 4 a thread (k % 4 == 0, idx and out 16 B
// aligned), so a thread's 4 indices lie in one row.
template <bool kVec>
__global__ void __launch_bounds__(kRowThreads)
rowwise_lookup_kernel(const uint32_t* __restrict__ tables, int64_t h,
                      const int32_t* __restrict__ idx, int64_t k, int64_t n,
                      uint32_t* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * kRowThreads + threadIdx.x;
  if constexpr (kVec) {
    if (4 * j >= n) return;
    const int4 i4 = __ldg(reinterpret_cast<const int4*>(idx) + j);
    const uint32_t* tab = tables + (4 * j / k) * h;
    // four independent loads, then one store
    reinterpret_cast<uint4*>(out)[j] = make_uint4(
        at(tab, h, i4.x), at(tab, h, i4.y), at(tab, h, i4.z), at(tab, h, i4.w));
  } else {
    if (j >= n) return;
    out[j] = at(tables + (j / k) * h, h, __ldg(idx + j));
  }
}

}  // namespace

// tables: u32[B, h] (h >= 1); idx: i32[B, n]. Writes out u32[B, n].
// Returns cudaGetLastError() after the launch.
extern "C" int dgt_chunked_lookup(const void* tables, long long batch,
                                  long long h, const void* idx, long long n,
                                  void* out, void* stream) {
  const bool vec = n % 4 == 0 && (uintptr_t)idx % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const long long work = vec ? n / 4 : n;
  long long gx = (work + kThreads - 1) / kThreads;
  if (gx < 1) gx = 1;
  if (gx > kMaxGridX) gx = kMaxGridX;
  dim3 grid((unsigned)gx, (unsigned)batch);
  const size_t shmem = h <= kSharedWords ? (size_t)h * 4 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    chunked_lookup_kernel<true><<<grid, kThreads, shmem, s>>>(
        (const uint32_t*)tables, h, (const int32_t*)idx, n, (uint32_t*)out);
  } else {
    chunked_lookup_kernel<false><<<grid, kThreads, shmem, s>>>(
        (const uint32_t*)tables, h, (const int32_t*)idx, n, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

// tables: u32[r, h] (h >= 1); idx: i32[r, k] (k <= 128). Writes out
// u32[r, k]. Returns cudaGetLastError() after the launch.
extern "C" int dgt_rowwise_lookup(const void* tables, long long r, long long h,
                                  const void* idx, long long k, void* out,
                                  void* stream) {
  const long long n = r * k;
  const bool vec = k % 4 == 0 && (uintptr_t)idx % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const long long work = vec ? n / 4 : n;
  const unsigned gx = (unsigned)((work + kRowThreads - 1) / kRowThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    rowwise_lookup_kernel<true><<<gx, kRowThreads, 0, s>>>(
        (const uint32_t*)tables, h, (const int32_t*)idx, k, n, (uint32_t*)out);
  } else {
    rowwise_lookup_kernel<false><<<gx, kRowThreads, 0, s>>>(
        (const uint32_t*)tables, h, (const int32_t*)idx, k, n, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
