// K3: ragged multi-source runs merge.
//
//   out[dst[r] + i] = srcs[ref[r]][off[r] + i]   for i < lens[r]
//   out[j] = 0                                   where no run covers j
//
// Replaces the JAX package's ops/pallas/merge.py::_merge2_kernel (dispatch
// _runs_merge_tpu2). Contract: dietgpu_fork_torch/ops/merge.py
// ::runs_merge_plain, the gather formulation of the JAX package's
// _runs_merge_ref, with int64 offsets and an explicit source index per run
// (the TPU packed the index into the offset's top bits).
//
// One thread per output word, grid-stride: it binary-searches the first run
// whose end (dst + len) lies past it, then copies one word or writes 0, so a
// single pass also does the zero fill. Reads past a source's end (a corrupt
// archive) take that source's last word, as the plain version clips them.
//
// Bound on the card: device memory (4 B read and 4 B written per word) plus
// about log2(runs) cached loads per word for the search. A CTA per run with
// 16 B copies after a zero fill is the faster form for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGrid = 8192;

__global__ void __launch_bounds__(kThreads)
runs_merge_kernel(const uint32_t* const* __restrict__ srcs,
                  const int64_t* __restrict__ src_len, int nsrc,
                  const int64_t* __restrict__ dst,
                  const int32_t* __restrict__ ref,
                  const int64_t* __restrict__ off,
                  const int64_t* __restrict__ lens, int64_t nruns,
                  uint32_t* __restrict__ out, int64_t out_len) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < out_len;
       j += (int64_t)gridDim.x * blockDim.x) {
    int64_t lo = 0, hi = nruns;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (dst[mid] + lens[mid] > j) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    uint32_t v = 0;
    if (nruns > 0) {
      const int64_t r = lo < nruns ? lo : nruns - 1;
      const int64_t d = dst[r];
      const int s = ref[r];
      if (j >= d && j < d + lens[r] && s >= 0 && s < nsrc) {
        int64_t o = off[r] + (j - d);
        const int64_t last = src_len[s] - 1;
        o = o < 0 ? 0 : (o > last ? last : o);
        v = srcs[s][o];
      }
    }
    out[j] = v;
  }
}

}  // namespace

// srcs: device array of nsrc u32 pointers; src_len: i64[nsrc] (each >= 1);
// dst, off, lens: i64[nruns]; ref: i32[nruns]; out: u32[out_len]. Runs are
// sorted by dst with nondecreasing ends. Returns cudaGetLastError().
extern "C" int dgt_runs_merge(const void* srcs, const void* src_len, int nsrc,
                              const void* dst, const void* ref,
                              const void* off, const void* lens,
                              long long nruns, void* out, long long out_len,
                              void* stream) {
  long long g = (out_len + kThreads - 1) / kThreads;
  if (g < 1) g = 1;
  if (g > kMaxGrid) g = kMaxGrid;
  runs_merge_kernel<<<(unsigned)g, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t* const*)srcs, (const int64_t*)src_len, nsrc,
      (const int64_t*)dst, (const int32_t*)ref, (const int64_t*)off,
      (const int64_t*)lens, nruns, (uint32_t*)out, out_len);
  return (int)cudaGetLastError();
}
