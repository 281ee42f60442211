// K7: fp32 and fp64 float join, the inverse of K5; one template for both.
// K13: the 16-bit float join, the inverse of K1's split.
//
// K7 replaces the JAX package's ops/pallas/float_split_fused.py
// ::_join32_kernel and ::_join64_kernel (entry join_packed_tpu). Contract:
// dietgpu_fork_torch/ops/float_split.py::join_wide_plain (tensor mode) and
// ::join_wide_at_plain (archive mode), the JAX package's portable
// join_packed.
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
// K7 joins, per float (4 floats a plane word):
//   fp32: the exponent-plane byte e, the low half of a sec1 word (2 floats
//         a word) and a sec2 byte t (4 a word): r = low | t << 16 | e << 24,
//         out = rotr(r, 1);
//   fp64: exp0 byte e0, exp1 byte e1, sec1 word v_lo (one a float), the
//         low half of a sec2 word (2 a word): v_hi = half | e1 << 16 |
//         e0 << 24, and the (v_lo, v_hi) pair rotated right by 1 across it.
// It takes the sections in one of two modes: as [B, >= kE] tensors with
// row strides (tensor mode: ops.float_split.join_wide, every float
// joined), or from the archive in place (archive mode, the two-pass
// decode: join_wide_at), where member b's sections start at words
// s1_off[b] and s2_off[b] of the archive at any 4 B phase, words outside
// the archive read as its end words (clamped), and only the floats below
// count[b] are read and joined: the rest are written as zeros. The count
// is required there, since the bytes past a member's sections are the next
// section or the ANS archive; it also zeroes a failed member (count 0).
//
// Bound on the card: device memory, a pure streaming interleave: fp32 4 B
// read (below the count) and 4 B written per float, fp64 8 and 8. Design: a
// CTA of kJoinThreads owns a tile of kJoinTileBytes of output. It first
// issues every load of the tile, each input span (planes, sec1, sec2 below
// the count) entering shared memory at its own 16 B phase with cp.async,
// the partial chunks at the span's ends word by word and clamped; then
// each thread writes 16 B chunks of output, consecutive lanes consecutive
// chunks (512 B a warp store: an fp64 chunk is 2 floats, so each lane
// reads its float pair's plane word and no store leaves a hole). Many
// small CTAs keep the bytes in flight; indices inside a tile are 32-bit,
// from one int64 base a tile. Of CTAs of 128 or 256 threads and tiles of
// 8, 16 or 32 KiB (a one-off sweep on an H100), 128 threads and 8 KiB took
// the least time in fp32 and fp64, with every float joined and with half
// of them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // K13
constexpr int kMaxGridX = 1024;
constexpr int kJoinThreads = 128;
constexpr int kJoinTileBytes = 8192;  // output bytes a tile
constexpr int64_t kNoClamp = INT64_MAX;

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int k) {
  return (w >> (8 * k)) & 0xFFu;
}

__device__ __forceinline__ int64_t clamp_word(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// buf[ph + k] = w[clamp(g0 + k)] for k < n, by the whole CTA, where ph (the
// return value) is the word phase of &w[g0] within 16 B: whole chunks
// inside [0, nwords) go by cp.async (the caller waits and syncs), the rest
// word by word. buf: 16 B aligned, n + 4 words.
__device__ __forceinline__ int stage_span(uint32_t* buf,
                                          const uint32_t* __restrict__ w,
                                          int64_t nwords, int64_t g0, int n) {
  const int ph = (int)((reinterpret_cast<uintptr_t>(w) / 4 + g0) & 3);
  for (int q = threadIdx.x; 4 * q < ph + n; q += kJoinThreads) {
    const int k0 = 4 * q - ph;  // the span index of the chunk's first word
    const int64_t g = g0 + k0;
    if (k0 >= 0 && k0 + 4 <= n && g >= 0 && g + 4 <= nwords) {
      cp_async16(buf + 4 * q, w + g);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + j >= 0 && k0 + j < n) {
          buf[4 * q + j] = __ldg(w + clamp_word(g + j, nwords));
        }
      }
    }
  }
  return ph;
}

struct JoinArgs {
  const uint32_t* exp0;
  int64_t e0_stride;
  const uint32_t* exp1;  // fp64
  int64_t e1_stride;
  const uint32_t* sec1;  // the archive in archive mode
  const uint32_t* sec2;
  int64_t nwords;  // sec1 and sec2 words that may be read (the clamp)
  const int64_t* s1_off;  // [B] archive mode, else null (row strides)
  const int64_t* s2_off;
  int64_t s1_stride;
  int64_t s2_stride;
  const int64_t* count;  // [B] floats to join; null: every float
  int64_t groups;  // E, exponent-plane words a row
  uint32_t* out;
};

// kWide64: fp64 (two planes); else fp32. One CTA a tile of a row.
template <bool kWide64>
__global__ void __launch_bounds__(kJoinThreads) join_wide_kernel(JoinArgs a) {
  constexpr int kWs = kWide64 ? 8 : 4;
  constexpr int kFloats = kJoinTileBytes / kWs;  // floats a tile
  constexpr int kPer = 16 / kWs;  // floats a 16 B output chunk
  constexpr int kS1 = kWide64 ? kFloats : kFloats / 2;  // sec1 words a tile
  constexpr int kS2 = kWide64 ? kFloats / 2 : kFloats / 4;
  __shared__ __align__(16) uint32_t e0[kFloats / 4 + 4];
  __shared__ __align__(16) uint32_t e1[kWide64 ? kFloats / 4 + 4 : 4];
  __shared__ __align__(16) uint32_t s1[kS1 + 4];
  __shared__ __align__(16) uint32_t s2[kS2 + 4];

  const int64_t b = blockIdx.y;
  const int64_t rowf = 4 * a.groups;  // floats a row
  const int64_t f0 = (int64_t)blockIdx.x * kFloats;
  // the member's values first, their loads in flight together
  const int64_t nf = a.count ? __ldg(a.count + b) : rowf;
  const int64_t o1 = a.s1_off ? __ldg(a.s1_off + b) : b * a.s1_stride;
  const int64_t o2 = a.s2_off ? __ldg(a.s2_off + b) : b * a.s2_stride;
  // floats of the tile below the count, and in the row
  const int lim = (int)clamp_word(min64(nf, rowf) - f0, (int64_t)kFloats + 1);
  const int tf = (int)min64(rowf - f0, kFloats);
  int p0 = 0, p1 = 0, q1 = 0, q2 = 0;
  if (lim > 0) {  // uniform over the CTA
    const int pw = (lim + 3) / 4;
    p0 = stage_span(e0, a.exp0, kNoClamp, b * a.e0_stride + f0 / 4, pw);
    if constexpr (kWide64) {
      p1 = stage_span(e1, a.exp1, kNoClamp, b * a.e1_stride + f0 / 4, pw);
    }
    if constexpr (kWide64) {
      q1 = stage_span(s1, a.sec1, a.nwords, o1 + f0, lim);
      q2 = stage_span(s2, a.sec2, a.nwords, o2 + f0 / 2, (lim + 1) / 2);
    } else {
      q1 = stage_span(s1, a.sec1, a.nwords, o1 + f0 / 2, (lim + 1) / 2);
      q2 = stage_span(s2, a.sec2, a.nwords, o2 + f0 / 4, pw);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  uint32_t* out = a.out + b * (rowf * kWs / 4) + f0 * kWs / 4;
  for (int c = threadIdx.x; c * kPer < tf; c += kJoinThreads) {
    const int f = c * kPer;  // the chunk's first float in the tile
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (f < lim) {
      if constexpr (!kWide64) {
        const uint32_t e = e0[p0 + c];
        const uint32_t lo = s1[q1 + 2 * c], hi = s1[q1 + 2 * c + 1];
        const uint32_t t = s2[q2 + c];
        const uint32_t low[4] = {lo & 0xFFFFu, lo >> 16, hi & 0xFFFFu, hi >> 16};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t r = low[k] | (byte_of(t, k) << 16) | (byte_of(e, k) << 24);
          w[k] = f + k < lim ? (r >> 1) | (r << 31) : 0u;
        }
      } else {
        // floats f and f + 1: bytes 2 (c & 1) and the next of the plane word
        const uint32_t x0 = e0[p0 + c / 2], x1 = e1[p1 + c / 2];
        const uint32_t m = s2[q2 + c];
        const int j = 2 * (c & 1);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const uint32_t v_lo = s1[q1 + 2 * c + k];
          const uint32_t v_hi = ((m >> (16 * k)) & 0xFFFFu) |
                                (byte_of(x1, j + k) << 16) |
                                (byte_of(x0, j + k) << 24);
          if (f + k < lim) {
            w[2 * k] = (v_lo >> 1) | (v_hi << 31);
            w[2 * k + 1] = (v_hi >> 1) | (v_lo << 31);
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(out + 4 * c) = make_uint4(w[0], w[1], w[2], w[3]);
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

// K7. exp0, exp1 (fp64 only; may equal exp0 for fp32): u32 rows of
// e0_stride and e1_stride words, groups (E) used. Tensor mode (s1_off and
// s2_off null): sec1 and sec2 are u32 rows of s1_stride and s2_stride
// words, 2E and E (fp32) or 4E and 2E (fp64) used, and count is null;
// archive mode: sec1 == sec2 is the archive of nwords words, member b's
// sections start at words s1_off[b] and s2_off[b] (int64), and count[b]
// (int64) floats are joined, the rest written as zeros. Writes out
// u32[B, 4E] (fp32) or [B, 8E] (fp64), 16 B aligned. Returns
// cudaGetLastError().
extern "C" int dgt_join_wide(const void* exp0, long long e0_stride,
                             const void* exp1, long long e1_stride,
                             const void* sec1, const void* sec2,
                             long long nwords, const void* s1_off,
                             const void* s2_off, long long s1_stride,
                             long long s2_stride, const void* count,
                             long long batch, long long groups, int fp64,
                             void* out, void* stream) {
  JoinArgs a{(const uint32_t*)exp0, e0_stride, (const uint32_t*)exp1,
             e1_stride, (const uint32_t*)sec1, (const uint32_t*)sec2,
             nwords, (const int64_t*)s1_off, (const int64_t*)s2_off,
             s1_stride, s2_stride, (const int64_t*)count, groups,
             (uint32_t*)out};
  const long long tile_floats = kJoinTileBytes / (fp64 ? 8 : 4);
  dim3 grid((unsigned)((4 * groups + tile_floats - 1) / tile_floats),
            (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (fp64) {
    join_wide_kernel<true><<<grid, kJoinThreads, 0, s>>>(a);
  } else {
    join_wide_kernel<false><<<grid, kJoinThreads, 0, s>>>(a);
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
