// K3: ragged multi-source runs merge.
//
//   out[dst[r] + i] = srcs[ref[r]][off[r] + i]   for i < lens[r]
//   out[j] = 0                                   where no run covers j
//
// Replaces the JAX package's ops/pallas/merge.py::_merge2_kernel (dispatch
// _runs_merge_tpu2) and, with one source, ::_merge_kernel. Contract:
// dietgpu_fork_torch/ops/merge.py::runs_merge_plain, the gather formulation
// of the JAX package's _runs_merge_ref, with int64 offsets and an explicit
// source index per run (the TPU packed the index into the offset's top
// bits): word j takes the first run r whose end dst[r] + lens[r] lies past
// j, copies from it if dst[r] <= j and is 0 otherwise. Reads past a
// source's end (a corrupt archive) take that source's last word, reads
// before its start its first word; a ref outside the sources gives 0.
//
// Bound on the card: device memory, each covered word read once and every
// output word written once. The design:
// - Tiles, not words. A CTA owns 8192 output words at a time (grid-stride
//   over the tiles, int64 throughout, so outputs past 2^31 words work). One
//   kThreads-ary search per tile (one dependent load per thread and round,
//   two rounds up to 65536 runs) finds the first run ending past the
//   tile's start; the CTA then walks the runs that reach into the tile, 256
//   descriptors at a time through shared memory. Run k owns the words from
//   the previous run's end to its own end: zeros up to its start, its copy
//   after. Every output word is written once, in one pass, gaps and the
//   tail past the last run included, and there is no per-word search.
// - 16 B accesses. Output words go in aligned quads: a uint4 store, with a
//   uint4 load where the run's source quad is 16 B aligned too (source and
//   destination congruent mod 4 words), else four 4 B loads. Only the
//   partial quads at a run's head and tail use 4 B stores. The quads of all
//   the segments in a tile are dealt round-robin over the CTA's threads,
//   so runs of a few words keep every thread busy too.
// - Sources by value: up to 8 pointers and lengths in the kernel's
//   parameters, no device copy of them per launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWords = 8192;
constexpr int kBatch = kThreads;  // run descriptors held in shared memory
constexpr int kMaxSources = 8;
constexpr long long kMaxGrid = 132 * 8;

struct Sources {
  const uint32_t* ptr[kMaxSources];
  int64_t len[kMaxSources];
};

// The first run r in [0, nruns) with dst[r] + lens[r] > x, else nruns:
// ends are nondecreasing. Each round samples kThreads evenly spaced runs
// and keeps the span between the last sample ending at or before x and the
// next one. Every thread of the CTA calls it and gets the same answer.
__device__ int64_t first_run_past(const int64_t* __restrict__ dst,
                                  const int64_t* __restrict__ lens,
                                  int64_t nruns, int64_t x) {
  int64_t lo = 0, hi = nruns;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t n = hi - lo;
    const int64_t step = (n + kThreads - 1) / kThreads;
    const int64_t k = (int64_t)threadIdx.x * step;
    bool at_or_before = false;
    if (k < n) {
      const int64_t s = lo + (k + step < n ? k + step : n) - 1;
      at_or_before = dst[s] + lens[s] <= x;
    }
    const int64_t c = __syncthreads_count(at_or_before);
    if (c * step < n) {
      const int64_t e = (c + 1) * step;
      hi = lo + (e < n ? e : n) - 1;
    }
    lo += c * step < n ? c * step : n;
  }
  return lo;
}

__device__ __forceinline__ uint32_t load1(const uint32_t* s, int64_t len,
                                          int64_t i) {
  i = i < 0 ? 0 : (i >= len ? len - 1 : i);
  return __ldg(s + i);
}

// Words [a, b) of out: zeros, or source words a + shift .. b - 1 + shift.
// The segment's quads are units (unit0 + u) of the tile's round-robin; the
// thread takes those that fall to it. Returns the segment's unit count.
__device__ __forceinline__ int64_t segment(uint32_t* __restrict__ out,
                                           int64_t a, int64_t b,
                                           const uint32_t* s, int64_t len,
                                           int64_t shift, bool zero,
                                           int64_t unit0) {
  const int64_t qa = a >> 2;
  const int64_t nq = ((b - 1) >> 2) - qa + 1;
  for (int64_t u = ((int64_t)threadIdx.x - unit0 % kThreads + kThreads) % kThreads;
       u < nq; u += kThreads) {
    const int64_t w0 = (qa + u) * 4;
    if (w0 >= a && w0 + 4 <= b) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (!zero) {
        const int64_t i = w0 + shift;
        if (i >= 0 && i + 4 <= len &&
            ((reinterpret_cast<uintptr_t>(s) + 4 * (uintptr_t)i) & 15) == 0) {
          v = __ldg(reinterpret_cast<const uint4*>(s + i));
        } else {
          v = make_uint4(load1(s, len, i), load1(s, len, i + 1),
                         load1(s, len, i + 2), load1(s, len, i + 3));
        }
      }
      reinterpret_cast<uint4*>(out)[qa + u] = v;
    } else {
      for (int t = 0; t < 4; ++t) {
        const int64_t j = w0 + t;
        if (j >= a && j < b) out[j] = zero ? 0u : load1(s, len, j + shift);
      }
    }
  }
  return nq;
}

__global__ void __launch_bounds__(kThreads)
runs_merge_kernel(const Sources src, int nsrc,
                  const int64_t* __restrict__ dst,
                  const int32_t* __restrict__ ref,
                  const int64_t* __restrict__ off,
                  const int64_t* __restrict__ lens, int64_t nruns,
                  uint32_t* __restrict__ out, int64_t out_len) {
  __shared__ const uint32_t* sh_src[kMaxSources];
  __shared__ int64_t sh_slen[kMaxSources];
  __shared__ int64_t sh_dst[kBatch];
  __shared__ int64_t sh_end[kBatch];
  __shared__ int64_t sh_off[kBatch];
  __shared__ int sh_ref[kBatch];
  const int tid = threadIdx.x;
  if (tid == 0) {  // constant indices: the parameters stay out of local memory
#pragma unroll
    for (int k = 0; k < kMaxSources; ++k) {
      sh_src[k] = src.ptr[k];
      sh_slen[k] = src.len[k];
    }
  }
  const int64_t ntiles = (out_len + kTileWords - 1) / kTileWords;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t ts = tile * kTileWords;
    const int64_t te = ts + kTileWords < out_len ? ts + kTileWords : out_len;
    int64_t r = first_run_past(dst, lens, nruns, ts);
    int64_t cover = ts;  // words [ts, cover) are dealt out
    int64_t unit0 = 0;   // quads dealt out so far in this tile
    for (;;) {
      // the next batch of runs; run r + t reaches into the tile while the
      // run before it ends before the tile's end
      const int64_t i = r + tid;
      if (i < nruns) {
        const int64_t d = dst[i];
        sh_dst[tid] = d;
        sh_end[tid] = d + lens[i];
        sh_off[tid] = off[i];
        sh_ref[tid] = ref[i];
      }
      __syncthreads();
      const bool in = i < nruns && (tid == 0 ? cover : sh_end[tid - 1]) < te;
      const int cnt = __syncthreads_count(in);
      for (int k = 0; k < cnt; ++k) {
        const int64_t d = sh_dst[k];
        const int64_t e = sh_end[k] < te ? sh_end[k] : te;
        const int64_t z = d < e ? d : e;  // zeros [cover, z), copy [z, e)
        if (z > cover) {
          unit0 += segment(out, cover, z, nullptr, 0, 0, true, unit0);
        }
        const int64_t c0 = z > cover ? z : cover;
        if (e > c0) {
          const int s = sh_ref[k];
          const bool bad = s < 0 || s >= nsrc;
          unit0 += segment(out, c0, e, bad ? nullptr : sh_src[s],
                           bad ? 0 : sh_slen[s], sh_off[k] - d, bad, unit0);
        }
        cover = e > cover ? e : cover;
      }
      __syncthreads();  // the batch is read before the next one lands
      if (cnt < kBatch) break;
      r += kBatch;
    }
    if (te > cover) segment(out, cover, te, nullptr, 0, 0, true, unit0);
  }
}

}  // namespace

// srcs, src_len: host arrays of nsrc (1..8) device u32 pointers and their
// word counts (each >= 1), passed to the kernel by value; dst, off, lens:
// device i64[nruns]; ref: device i32[nruns]; out: device u32[out_len], 16 B
// aligned. Runs have nondecreasing ends (dst + lens). Returns
// cudaGetLastError().
extern "C" int dgt_runs_merge(const void* const* srcs,
                              const long long* src_len, int nsrc,
                              const void* dst, const void* ref,
                              const void* off, const void* lens,
                              long long nruns, void* out, long long out_len,
                              void* stream) {
  if (nsrc < 1 || nsrc > kMaxSources) return (int)cudaErrorInvalidValue;
  Sources s{};
  for (int i = 0; i < nsrc; ++i) {
    s.ptr[i] = static_cast<const uint32_t*>(srcs[i]);
    s.len[i] = src_len[i];
  }
  long long g = (out_len + kTileWords - 1) / kTileWords;
  if (g < 1) g = 1;
  if (g > kMaxGrid) g = kMaxGrid;
  runs_merge_kernel<<<(unsigned)g, kThreads, 0, (cudaStream_t)stream>>>(
      s, nsrc, (const int64_t*)dst, (const int32_t*)ref, (const int64_t*)off,
      (const int64_t*)lens, nruns, (uint32_t*)out, out_len);
  return (int)cudaGetLastError();
}
