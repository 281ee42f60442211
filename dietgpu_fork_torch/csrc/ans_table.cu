// K17: the encode-side ANS table build (the normalisation of each member's
// byte histogram to 2^prob_bits, its cdf, the magic-multiply constants and
// the packed encode table), for every member of a batch in one launch.
//
// Replaces no Pallas kernel: it takes the place of torch glue that the JAX
// package leaves to XLA before its encode kernel (ops/table.py:26
// normalize_probs_batched and ops/table.py:110 pack_encode_table).
// Contract: dietgpu_fork_torch/ops/table.py::ans_table_plain, which is
// normalize_probs_batched, then pack_encode_table, bit for bit, itself a
// port of GpuANSStatistics.cuh:178-367.
//
// For member b, with count c = hist[b][s] and total t = totals[b], both
// reduced to their low 32 bits, it writes for each symbol s:
//   - pdf: the first pass is (float)2^prob_bits * ((float)c / (float)t) in
//     correctly rounded float32, truncated; a count above 0 that truncates
//     to 0 becomes 1. Then, with diff = 2^prob_bits less the row's sum:
//     diff > 0 adds diff / 256 to every symbol and 1 more to each symbol
//     whose id (not rank) is below diff % 256; diff < 0 runs the excess
//     loop, each round taking 1 off the it = min(d, #{pdf > 1}) entries
//     above 1 of least key (pdf << 16 | s), until d = -diff is spent. An
//     empty member (t = 0) gives an all-zero row.
//   - cdf, the exclusive sum of pdf; shift = 32 - clz(pdf - 1) and magic =
//     ((2^shift - pdf) << 32) / pdf + 1 mod 2^32, both 0 where pdf is 0;
//     packed = pdf | cdf << 12 | shift << 23.
//
// The loop: a round with d >= #{pdf > 1} takes 1 off every entry above 1,
// so r = min(least such pdf - 1, d / #) such rounds are taken at once (no
// entry reaches 1 before the last of them, and # holds through them); a
// round with d < # is the last, and ranks the keys. So the loop ends after
// at most 257 steps, whatever the counts, and ranks once.
//
// Bound on the card: 1 KiB of counts and 8 B of total read and 4 KiB
// written (packed and magic 1 KiB each, pdf 2 KiB) a member, at 3.35 TB/s:
// 1.5 ns a member, so the launch and a few dependent block reductions bound
// it.
//
// Design: one CTA of 256 threads a member, a thread a symbol; sums and
// minima by warp shuffles and 8 words of shared memory, the scan the same
// way; the rank of a key by comparing it with the other 255 in shared
// memory. Every branch that depends on the member is uniform in its CTA.
// IEEE float32 as the plain version: __uint2float_rn, __fdiv_rn,
// __fmul_rn and __float2ll_rz, under -O3 without --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSyms = 256;
constexpr int kWarps = kSyms / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kNone = 0x7FFFFFFFFFFFFFFFLL;  // no entry above 1

struct TableArgs {
  const uint32_t* hist;
  int64_t hist_stride;  // words between members' rows (0: one shared row)
  const int64_t* totals;
  int prob_bits;
  uint32_t* packed;
  uint32_t* magic;
  int64_t* pdf;
};

// The sum over the CTA, in every thread; sh holds kWarps words.
__device__ __forceinline__ long long block_sum(long long v, long long* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();  // sh's last readers are done
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  long long s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sh[w];
  return s;
}

// The least value over the CTA, in every thread.
__device__ __forceinline__ long long block_min(long long v, long long* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  long long m = sh[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = min(m, sh[w]);
  return m;
}

__global__ void __launch_bounds__(kSyms) ans_table_kernel(const TableArgs a) {
  __shared__ long long sh_red[kWarps];
  __shared__ long long sh_q[kSyms];
  __shared__ uint32_t sh_scan[kWarps];
  const int s = threadIdx.x;
  const int lane = s & 31;
  const int64_t b = blockIdx.x;
  const long long target = 1LL << a.prob_bits;
  const uint32_t count = __ldg(a.hist + b * a.hist_stride + s);
  const uint32_t total = (uint32_t)a.totals[b];

  // the float32 first pass, truncating cast (GpuANSStatistics.cuh:215-218)
  long long q = 0;
  if (total > 0) {
    const float f = __fmul_rn(
        (float)target, __fdiv_rn(__uint2float_rn(count), __uint2float_rn(total)));
    q = __float2ll_rz(f);
    if (count > 0 && q == 0) q = 1;
  }
  const long long diff = target - block_sum(q, sh_red);

  if (total == 0) {
    q = 0;
  } else if (diff > 0) {
    // +1 to symbols whose id < the remaining diff, in rounds of 256
    q += diff / kSyms + (s < diff % kSyms ? 1 : 0);
  } else if (diff < 0) {
    // take 1 from the `it` entries above 1 of least key (q << 16 | s)
    long long d = -diff;
    while (d > 0) {
      const bool gt1 = q > 1;
      const long long num = __syncthreads_count(gt1);
      if (num == 0) break;  // not reached: the row sums to target + d
      if (d >= num) {
        const long long k = block_min(gt1 ? q - 1 : kNone, sh_red);
        const long long r = min(k, d / num);
        if (gt1) q -= r;
        d -= r * num;
      } else {
        sh_q[s] = q;
        __syncthreads();
        if (gt1) {
          int rank = 0;
          for (int j = 0; j < kSyms; ++j) {
            const long long qj = sh_q[j];
            rank += qj > 1 && (qj < q || (qj == q && j < s));
          }
          if (rank < d) q -= 1;
        }
        d = 0;
      }
    }
  }

  // cdf: the exclusive sum of the row (at most 2^prob_bits)
  const uint32_t p = (uint32_t)q;
  uint32_t x = p;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh_scan[s >> 5] = x;
  __syncthreads();
  uint32_t cdf = x - p;
  for (int w = 0; w < (s >> 5); ++w) cdf += sh_scan[w];

  // magic-multiply division constants (GpuANSStatistics.cuh:345-358)
  uint32_t shift = 0, magic = 0;
  if (p > 0) {
    shift = 32 - __clz(p - 1);
    const uint64_t a_hi = (uint64_t)((1u << shift) - p);
    magic = (uint32_t)((a_hi << 32) / p + 1);
  }
  const int64_t at = b * kSyms + s;
  a.pdf[at] = q;
  a.magic[at] = magic;
  a.packed[at] = p | (cdf << 12) | (shift << 23);
}

}  // namespace

// hist: u32[batch, 256] counts, member b's row at word b * hist_stride
// (hist_stride >= 0; 0 shares one row); totals: i64[batch]; prob_bits 9-11.
// Outputs: packed, magic u32[batch, 256]; pdf i64[batch, 256]. Returns
// cudaErrorInvalidValue for arguments out of range, else cudaGetLastError()
// after the launch.
extern "C" int dgt_ans_table(const void* hist, long long batch,
                             long long hist_stride, const void* totals,
                             int prob_bits, void* packed, void* magic, void* pdf,
                             void* stream) {
  if (batch < 1 || batch > 0x7FFFFFFFLL || hist_stride < 0 || prob_bits < 9 ||
      prob_bits > 11) {
    return (int)cudaErrorInvalidValue;
  }
  TableArgs a;
  a.hist = (const uint32_t*)hist;
  a.hist_stride = hist_stride;
  a.totals = (const int64_t*)totals;
  a.prob_bits = prob_bits;
  a.packed = (uint32_t*)packed;
  a.magic = (uint32_t*)magic;
  a.pdf = (int64_t*)pdf;
  ans_table_kernel<<<(unsigned)batch, kSyms, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
