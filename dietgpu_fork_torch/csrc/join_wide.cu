// K7: fp32 and fp64 float join, the inverse of K5; one template for both.
// K13: the 16-bit float join, the inverse of K1's split.
//
// K7 replaces the JAX package's ops/pallas/float_split_fused.py
// ::_join32_kernel and ::_join64_kernel (entry join_packed_tpu). Contract:
// dietgpu_fork_torch/ops/float_split.py::join_wide_plain, the JAX package's
// portable join_packed.
//
// K13 (dgt_join16) replaces ::_join16_kernel (entry join_packed_tpu, the
// 16-bit arm, call float_split_fused.py:793), the second pass of the
// two-pass 16-bit decode. Contract: ops/float_split.py::join16_rows_plain,
// the 16-bit join_packed. Exponent word e and raw word r of a group of 4
// floats give out words (r0 | e0 << 8 | r1 << 16 | e1 << 24) and the same of
// bytes 2 and 3, each 16-bit half rotated right by 1 for bf16. Where rows
// are 16 B aligned a thread takes 4 groups: two 16 B loads, two 16 B
// stores; else one group, 4 B loads and one 8 B store. Bound: device
// memory, 2 B read and 2 B written per float.
//
// One thread per group of 4 floats, grid-stride over each row:
//   fp32: exponent-plane word e, sec1 words (2, one 8 B load), sec2 word t;
//         r = low half | third byte << 16 | top byte << 24, out = rotr(r, 1),
//         4 words in one 16 B store;
//   fp64: exp0 and exp1 words, sec1 = 4 v_lo words (one 16 B load), sec2 =
//         the 4 low halves of v_hi (one 8 B load); v_hi = low half |
//         exp1 byte << 16 | exp0 byte << 24, and the (lo, hi) pair is
//         rotated right by 1 across it, 8 words in two 16 B stores.
// Zeros past a member's count need no mask: its planes and sections are
// zero there, and the join of zero bytes is zero.
//
// Bound on the card: device memory (fp32: 4 B read and 4 B written per
// float; fp64: 8 and 8), a pure streaming interleave with no reuse.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridX = 1024;

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int k) {
  return (w >> (8 * k)) & 0xFFu;
}

// kWide64: fp64 (two planes, 8 output words per group); else fp32.
template <bool kWide64>
__global__ void __launch_bounds__(kThreads)
join_wide_kernel(const uint32_t* __restrict__ exp0, int64_t e0_stride,
                 const uint32_t* __restrict__ exp1, int64_t e1_stride,
                 const uint32_t* __restrict__ sec1, int64_t s1_stride,
                 const uint32_t* __restrict__ sec2, int64_t s2_stride,
                 int64_t groups, uint32_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < groups;
       j += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t e = exp0[b * e0_stride + j];
    if constexpr (!kWide64) {
      const uint2 s1 =
          *reinterpret_cast<const uint2*>(sec1 + b * s1_stride + 2 * j);
      const uint32_t t = sec2[b * s2_stride + j];
      const uint32_t low[4] = {s1.x & 0xFFFFu, s1.x >> 16, s1.y & 0xFFFFu,
                               s1.y >> 16};
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t r = low[k] | (byte_of(t, k) << 16) | (byte_of(e, k) << 24);
        w[k] = (r >> 1) | (r << 31);
      }
      *reinterpret_cast<uint4*>(out + b * 4 * groups + 4 * j) =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      const uint32_t e1 = exp1[b * e1_stride + j];
      const uint4 vl =
          *reinterpret_cast<const uint4*>(sec1 + b * s1_stride + 4 * j);
      const uint2 s2 =
          *reinterpret_cast<const uint2*>(sec2 + b * s2_stride + 2 * j);
      const uint32_t v_lo[4] = {vl.x, vl.y, vl.z, vl.w};
      const uint32_t mid[4] = {s2.x & 0xFFFFu, s2.x >> 16, s2.y & 0xFFFFu,
                               s2.y >> 16};
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t v_hi =
            mid[k] | (byte_of(e1, k) << 16) | (byte_of(e, k) << 24);
        w[2 * k] = (v_lo[k] >> 1) | (v_hi << 31);
        w[2 * k + 1] = (v_hi >> 1) | (v_lo[k] << 31);
      }
      uint4* o = reinterpret_cast<uint4*>(out + b * 8 * groups + 8 * j);
      o[0] = make_uint4(w[0], w[1], w[2], w[3]);
      o[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

__device__ __forceinline__ uint2 join16_group(uint32_t e, uint32_t r,
                                              int bf16) {
  uint32_t we = byte_of(r, 0) | (byte_of(e, 0) << 8) | (byte_of(r, 1) << 16) |
                (byte_of(e, 1) << 24);
  uint32_t wo = byte_of(r, 2) | (byte_of(e, 2) << 8) | (byte_of(r, 3) << 16) |
                (byte_of(e, 3) << 24);
  if (bf16) {
    we = ((we >> 1) & 0x7FFF7FFFu) | ((we << 15) & 0x80008000u);
    wo = ((wo >> 1) & 0x7FFF7FFFu) | ((wo << 15) & 0x80008000u);
  }
  return make_uint2(we, wo);
}

// kVec: 4 groups a thread with 16 B accesses (rows and strides 16 B
// aligned, groups % 4 == 0); else one group a thread.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
join16_kernel(const uint32_t* __restrict__ exp, int64_t e_stride,
              const uint32_t* __restrict__ raw, int64_t r_stride,
              int64_t groups, int bf16, uint32_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const int64_t per = kVec ? 4 : 1;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       j < groups / per; j += (int64_t)gridDim.x * blockDim.x) {
    if constexpr (kVec) {
      const uint4 e = *reinterpret_cast<const uint4*>(exp + b * e_stride + 4 * j);
      const uint4 r = *reinterpret_cast<const uint4*>(raw + b * r_stride + 4 * j);
      const uint2 w0 = join16_group(e.x, r.x, bf16);
      const uint2 w1 = join16_group(e.y, r.y, bf16);
      const uint2 w2 = join16_group(e.z, r.z, bf16);
      const uint2 w3 = join16_group(e.w, r.w, bf16);
      uint4* o = reinterpret_cast<uint4*>(out + b * 2 * groups + 8 * j);
      o[0] = make_uint4(w0.x, w0.y, w1.x, w1.y);
      o[1] = make_uint4(w2.x, w2.y, w3.x, w3.y);
    } else {
      *reinterpret_cast<uint2*>(out + b * 2 * groups + 2 * j) =
          join16_group(exp[b * e_stride + j], raw[b * r_stride + j], bf16);
    }
  }
}

}  // namespace

// exp0, exp1 (fp64 only; may be null for fp32): u32 rows of e0_stride and
// e1_stride words, groups used; sec1: u32 rows of s1_stride words (2 or 4
// per group used, 8 or 16 B aligned); sec2: rows of s2_stride words (1 or 2
// per group, 4 or 8 B aligned). Writes out u32[B, 4 * groups] (fp32) or
// [B, 8 * groups] (fp64), 16 B aligned. Returns cudaGetLastError().
extern "C" int dgt_join_wide(const void* exp0, long long e0_stride,
                             const void* exp1, long long e1_stride,
                             const void* sec1, long long s1_stride,
                             const void* sec2, long long s2_stride,
                             long long batch,
                             long long groups, int fp64, void* out,
                             void* stream) {
  long long gx = (groups + kThreads - 1) / kThreads;
  if (gx < 1) gx = 1;
  if (gx > kMaxGridX) gx = kMaxGridX;
  dim3 grid((unsigned)gx, (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (fp64) {
    join_wide_kernel<true><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)exp0, e0_stride, (const uint32_t*)exp1, e1_stride,
        (const uint32_t*)sec1, s1_stride, (const uint32_t*)sec2, s2_stride,
        groups, (uint32_t*)out);
  } else {
    join_wide_kernel<false><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)exp0, e0_stride, (const uint32_t*)exp1, e1_stride,
        (const uint32_t*)sec1, s1_stride, (const uint32_t*)sec2, s2_stride,
        groups, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

// exp: u32 rows of e_stride words, groups used; raw: u32 rows of r_stride
// words, groups used. Writes out u32[B, 2 * groups], 8 B aligned. Returns
// cudaGetLastError().
extern "C" int dgt_join16(const void* exp, long long e_stride, const void* raw,
                          long long r_stride, long long batch,
                          long long groups, int bf16, void* out,
                          void* stream) {
  const bool vec = groups % 4 == 0 && e_stride % 4 == 0 && r_stride % 4 == 0 &&
                   (uintptr_t)exp % 16 == 0 && (uintptr_t)raw % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const long long work = vec ? groups / 4 : groups;
  long long gx = (work + kThreads - 1) / kThreads;
  if (gx < 1) gx = 1;
  if (gx > kMaxGridX) gx = kMaxGridX;
  dim3 grid((unsigned)gx, (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    join16_kernel<true><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)exp, e_stride, (const uint32_t*)raw, r_stride, groups,
        bf16, (uint32_t*)out);
  } else {
    join16_kernel<false><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)exp, e_stride, (const uint32_t*)raw, r_stride, groups,
        bf16, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
