// K7: fp32 and fp64 float join, the inverse of K5. K13: the 16-bit float
// join, the inverse of K1's split. One template serves the three widths,
// each in two modes.
//
// K7 replaces the JAX package's ops/pallas/float_split_fused.py
// ::_join32_kernel and ::_join64_kernel (entry join_packed_tpu). Contract:
// dietgpu_fork_torch/ops/float_split.py::join_wide_plain (tensor mode) and
// ::join_wide_at_plain (archive mode), the JAX package's portable
// join_packed.
//
// K13 replaces ::_join16_kernel (entry join_packed_tpu, the 16-bit arm,
// call float_split_fused.py:793), the second pass of the two-pass 16-bit
// decode. Contract: ops/float_split.py::join16_rows_plain (tensor mode) and
// ::join16_at_plain (archive mode), the 16-bit join_packed.
//
// The join, per float (4 floats a plane word):
//   16-bit: the exponent-plane byte e and the raw byte r: out = r | e << 8,
//         two floats a word, each 16-bit half rotated right by 1 for bf16
//         (fp16 is not rotated);
//   fp32: the exponent-plane byte e, the low half of a sec1 word (2 floats
//         a word) and a sec2 byte t (4 a word): r = low | t << 16 | e << 24,
//         out = rotr(r, 1);
//   fp64: exp0 byte e0, exp1 byte e1, sec1 word v_lo (one a float), the
//         low half of a sec2 word (2 a word): v_hi = half | e1 << 16 |
//         e0 << 24, and the (v_lo, v_hi) pair rotated right by 1 across it.
// It takes the raw sections (16-bit: the one raw section, as sec1) in one
// of two modes: as [B, >= kE] tensors with row strides (tensor mode:
// ops.float_split.join_wide and join16_rows, every float joined), or from
// the archive in place (archive mode, the two-pass decode: join_wide_at
// and join16_at), where member b's sections start at words s1_off[b] and
// s2_off[b] of the archive at any 4 B phase, words outside the archive
// read as its end words (clamped), and only the floats below count[b] are
// read and joined: the rest are written as zeros. The count is required
// there, since the bytes past a member's sections are the next section or
// the ANS archive; it also zeroes a failed member (count 0), so the decode
// selects nothing after the join.
//
// Bound on the card: device memory, a pure streaming interleave: per float
// 2 B read (below the count) and 2 B written for 16-bit types, 4 and 4 for
// fp32, 8 and 8 for fp64. Design: a CTA of kJoinThreads owns a tile of
// kJoinTileBytes of output (4096 16-bit floats, 2048 fp32, 1024 fp64). It
// first issues every load of the tile, each input span (planes, sections
// below the count) entering shared memory at its own 16 B phase with
// cp.async, the partial chunks at the span's ends word by word and
// clamped; then each thread writes 16 B chunks of output, consecutive
// lanes consecutive chunks (512 B a warp store: a 16-bit chunk is 8 floats,
// two plane and two raw words; an fp64 chunk 2 floats, so each lane reads
// its float pair's plane word and no store leaves a hole). Many small CTAs
// keep the bytes in flight; indices inside a tile are 32-bit, from one
// int64 base a tile. Of CTAs of 128 or 256 threads and tiles of 8, 16 or
// 32 KiB (a one-off sweep on an H100), 128 threads and 8 KiB took the
// least time in fp32 and fp64, with every float joined and with half of
// them; K13 takes the same shape.
//
// K13's traps, and what the design does about them:
// - A raw section starts at any 4 B phase: classic v1 sections sit at
//   base + 8 words, v2 ones at base + 128, and the base is any word. A
//   16 B cp.async needs a 16 B aligned source, so each span is staged at
//   its own phase (stage_span) and read back from that phase.
// - A count that ends inside an output word: the word's high half (the
//   float at the count) is written as zero, and so is every later float.
// - A failed member (count 0) stages nothing and writes zeros; a header
//   whose n runs past the row is cut to the row's floats, and every
//   archive word read is clamped to the archive.
// - An output row of 2E words with E odd starts 8 B past a 16 B boundary
//   for every odd member and ends half way into a 16 B chunk: such a row
//   is written with 8 B stores, its last chunk only in its first half.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// The two output words of a group of 4 16-bit floats: exponent-plane word
// e and raw word r, bytes 0-1 and 2-3.
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

struct JoinArgs {
  const uint32_t* exp0;
  int64_t e0_stride;
  const uint32_t* exp1;  // fp64
  int64_t e1_stride;
  const uint32_t* sec1;  // the archive in archive mode
  const uint32_t* sec2;  // fp32, fp64
  int64_t nwords;  // sec1 and sec2 words that may be read (the clamp)
  const int64_t* s1_off;  // [B] archive mode, else null (row strides)
  const int64_t* s2_off;
  int64_t s1_stride;
  int64_t s2_stride;
  const int64_t* count;  // [B] floats to join; null: every float
  int64_t groups;  // E, exponent-plane words a row
  int bf16;  // 16-bit: rotate each half
  uint32_t* out;
};

// kWs: the float's bytes, 2 (K13), 4 or 8 (K7). One CTA a tile of a row.
template <int kWs>
__global__ void __launch_bounds__(kJoinThreads) join_kernel(JoinArgs a) {
  constexpr bool k16 = kWs == 2, k64 = kWs == 8;
  constexpr int kFloats = kJoinTileBytes / kWs;  // floats a tile
  constexpr int kPer = 16 / kWs;  // floats a 16 B output chunk
  // sec1 (16-bit: raw) and sec2 words a tile
  constexpr int kS1 = k16 ? kFloats / 4 : (k64 ? kFloats : kFloats / 2);
  constexpr int kS2 = k16 ? 0 : (k64 ? kFloats / 2 : kFloats / 4);
  __shared__ __align__(16) uint32_t e0[kFloats / 4 + 4];
  __shared__ __align__(16) uint32_t e1[k64 ? kFloats / 4 + 4 : 4];
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
    if constexpr (k16) {
      q1 = stage_span(s1, a.sec1, a.nwords, o1 + f0 / 4, pw);
    } else if constexpr (k64) {
      p1 = stage_span(e1, a.exp1, kNoClamp, b * a.e1_stride + f0 / 4, pw);
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
  // 16-bit rows of 2E words, E odd: 8 B aligned only (uniform over the CTA)
  const bool whole16 = !k16 || (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int c = threadIdx.x; c * kPer < tf; c += kJoinThreads) {
    const int f = c * kPer;  // the chunk's first float in the tile
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (f < lim) {
      if constexpr (k16) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 v = join16_group(e0[p0 + 2 * c + h], s1[q1 + 2 * c + h],
                                       a.bf16);
          w[2 * h] = v.x;
          w[2 * h + 1] = v.y;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // word k holds floats f + 2k, + 1
          w[k] &= (f + 2 * k < lim ? 0x0000FFFFu : 0u) |
                  (f + 2 * k + 1 < lim ? 0xFFFF0000u : 0u);
        }
      } else if constexpr (!k64) {
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
    uint32_t* o = out + 4 * c;
    if (whole16 && f + kPer <= tf) {
      *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {  // 16-bit only: 8 B stores, the second half where in the row
      *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
      if (f + kPer <= tf) *reinterpret_cast<uint2*>(o + 2) = make_uint2(w[2], w[3]);
    }
  }
}

}  // namespace

// K7 and K13. ws: the float's bytes, 2 (K13; bf16 rotates each half), 4 or
// 8 (K7). exp0, exp1 (fp64 only; may equal exp0 otherwise): u32 rows of
// e0_stride and e1_stride words, groups (E) used. Tensor mode (s1_off and
// s2_off null, count null): sec1 and sec2 (fp32, fp64; may equal sec1
// otherwise) are u32 rows of s1_stride and s2_stride words, E (16-bit), 2E
// and E (fp32) or 4E and 2E (fp64) used; archive mode: sec1 == sec2 is the
// archive of nwords words, member b's sections start at words s1_off[b]
// and s2_off[b] (int64; s2_off may equal s1_off for 16-bit types), and
// count[b] (int64) floats are joined, the rest written as zeros. Writes out
// u32[B, ws * E], 8 B aligned (16 B for fp32 and fp64). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another ws.
extern "C" int dgt_join(const void* exp0, long long e0_stride,
                        const void* exp1, long long e1_stride,
                        const void* sec1, const void* sec2, long long nwords,
                        const void* s1_off, const void* s2_off,
                        long long s1_stride, long long s2_stride,
                        const void* count, long long batch, long long groups,
                        int ws, int bf16, void* out, void* stream) {
  if (ws != 2 && ws != 4 && ws != 8) return (int)cudaErrorInvalidValue;
  JoinArgs a{(const uint32_t*)exp0, e0_stride, (const uint32_t*)exp1,
             e1_stride, (const uint32_t*)sec1, (const uint32_t*)sec2,
             nwords, (const int64_t*)s1_off, (const int64_t*)s2_off,
             s1_stride, s2_stride, (const int64_t*)count, groups, bf16,
             (uint32_t*)out};
  const long long tile_floats = kJoinTileBytes / ws;
  dim3 grid((unsigned)((4 * groups + tile_floats - 1) / tile_floats),
            (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (ws == 2) {
    join_kernel<2><<<grid, kJoinThreads, 0, s>>>(a);
  } else if (ws == 4) {
    join_kernel<4><<<grid, kJoinThreads, 0, s>>>(a);
  } else {
    join_kernel<8><<<grid, kJoinThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
