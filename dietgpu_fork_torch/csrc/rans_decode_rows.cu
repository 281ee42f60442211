// K4, K6 and K12: rANS decode, one walk with three epilogues, over the
// row-stream (0xDB0D) layout or the classic (0xD00D) one, reading the
// archive in place.
//
// K6 (epilogue kBytes) writes the decoded bytes. It replaces the JAX
// package's ops/pallas/rans_decode_fused2.py::_decode_kernel2 in mode
// JOIN_NONE with row=True (entry decode_blocks_fused2(row_stream=True)), the
// fp32/fp64 planes' decode. Contract: dietgpu_fork_torch/ops/rans_decode.py
// ::decode_at_plain, which stages the streams and runs the walk of the JAX
// package's decode_blocks_rows.
//
// K4 (kJoin16) joins each decoded exponent byte with its raw byte into a
// 16-bit float. It replaces _decode_kernel2 in modes JOIN_F16 / JOIN_BF16
// with row=True (entry decode_join16_fused): decode_blocks_rows followed by
// the 16-bit join_packed.
//
// K12 (kJoin32) joins each decoded exponent byte with the float's low 16
// bits (sec1) and third byte (sec2) into an fp32 word,
// ror1(low16 | sec2 byte << 16 | sym << 24). It replaces _decode_kernel2 in
// mode JOIN_F32 (entry decode_join32_fused, call rans_decode_fused2.py:731):
// decode_blocks_rows followed by the fp32 join_packed.
//
// Classic layout (kClassic): replaces _decode_kernel2 with
// row_stream=False, in mode JOIN_NONE (call at rans_decode_fused2.py:517),
// JOIN_F16/BF16 (call at :620) and JOIN_F32 (call at :731), the JAX
// package's decode_blocks. Each warp walks its own block's stream with its
// own cursor: the reverse order is a suffix of the warp's ballot alone, with
// no shared counts and no barrier a step.
//
// One CTA per row of 4 blocks = 128 threads. Row layout: ONE reverse cursor
// over the row's stream. The walk is bottom-aligned: at step i, block
// iteration k = i - (128 - nsteps), so every active block of the row undoes
// the same encode step 127 - i and the stream's reverse order is one suffix
// count over the row's 128 lanes (block-major, lane-minor): a reading lane
// takes the u16 word at ptr - (reads of lanes >= it), the in-warp part from
// a ballot, the higher warps' part from shared memory. Iteration k = 0
// covers the block's tail group of ((U - 1) mod 32) + 1 lanes. Step i
// decodes position p = 32 * (127 - i) + lane of each block.
//
// In place: every input is read from the archive words where it lies. A
// stream starts at seg_off (u32 words) and holds seg_len words, at most
// kRowCap (row) or kBlockCap (classic); a block's 32 states lie at
// state_off + 32 * block (read only for blocks that decode something); K4's
// raw bytes at raw_off + 1024 * block words, K12's sec1 and sec2 words at
// raw_off + 2048 * block and sec2_off + 1024 * block. A stream read below
// word 0 takes word 0, one at or past seg_len gives 0; every other read
// outside the archive tensor is clamped into it. So the walk sees exactly
// what the former staging copies held.
//
// Bound on the card: not bytes but the walk, 128 dependent steps a row (a
// shared LUT read, the state update, a ballot, one barrier and a shared
// stream read), and with 5 CTAs an SM the rate its instructions dispatch at. So:
// - nothing on the chain touches device memory. Before the walk the CTA
//   copies its stream(s) into shared memory with 16 B cp.async chunks (the
//   16 B-aligned quads of the span; a stream's start is only 4 B aligned,
//   so the buffer is indexed from the shifted base and the partial quads
//   at its ends go word by word), overlapped with the LUT fill and the
//   states' loads. One zero word behind each stream takes every read at or
//   past its length;
// - the step has no branch: a lane that does not decode keeps its state by
//   a select, the stream index is clamped into [0, length], and each step
//   stores its symbol byte to shared memory (16 KiB a row) unmasked;
// - after the last step the CTA writes the row's blocks with 16 B stores,
//   zero at and past each block's count: K6 the bytes; K4 16 floats a
//   thread from one raw uint4 and one symbol uint4; K12 8 floats a thread
//   from sec1 (uint4), sec2 (uint2) and the symbols. Every archive load of
//   a pass is started before its stores, vectorised where the archive's
//   alignment allows and word by word where it does not.
// Shared memory: streams 20.2 KiB, LUT 8 KiB, symbols 16 KiB: 44.2 KiB, 5
// CTAs an SM (the launch bounds hold the registers to that).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowBlocks = 4;
constexpr int kThreads = kWarp * kRowBlocks;
constexpr int kSteps = 128;
constexpr int kBlockBytes = 4096;
constexpr int kMaxLut = 1 << 11;
// stream caps in u32 words (the worst-case row or block plus slack), and
// the shared buffers: a cap plus up to 3 words of alignment shift, in 16 B
constexpr int kRowCap = 5128;
constexpr int kBlockCap = 1288;
constexpr int kBlockBuf = (kBlockCap + 3 + 1 + 3) / 4 * 4;
constexpr int kStreamBuf = kRowBlocks * kBlockBuf;
static_assert(kStreamBuf >= kRowCap + 3 + 1, "row stream buffer");
// resident CTAs an SM that the shared memory allows (about 44 KiB each)
constexpr int kCtasPerSm = 5;

enum Epilogue { kBytes = 0, kJoin16 = 1, kJoin32 = 2 };

struct DecodeArgs {
  const uint32_t* words;  // the archive words
  int64_t nwords;
  const int64_t* seg_off;  // [B, nseg] first word of each stream
  const int64_t* seg_len;  // [B, nseg] its length in words
  const int32_t* comp_w;   // [B, nb] u16 words of each block's stream
  const int32_t* uncomp_w;  // [B, nb] decoded bytes of each block
  const int64_t* state_off;  // [B] block 0's states
  const uint32_t* lut;  // [B, 2^prob_bits]
  const int64_t* raw_off;  // [B] K4: raw words; K12: sec1 words
  const int64_t* sec2_off;  // [B] K12: sec2 words
  int prob_bits;
  int bf16;
  int64_t nb;
  void* out;
};

__device__ __forceinline__ int64_t clamp_word(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// N consecutive archive words from word i: one N * 4 B load where the
// address is aligned and the words lie inside the archive, else word by
// word, each clamped into it.
template <int N>
__device__ __forceinline__ void load_words(const uint32_t* w, int64_t n,
                                           int64_t i, uint32_t (&v)[N]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(w) + 4 * (uintptr_t)i;
  if (i >= 0 && i + N <= n && addr % (4 * N) == 0) {
    if constexpr (N == 4) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(w + i));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(w + i));
      v[0] = t.x; v[1] = t.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = __ldg(w + clamp_word(i + k, n));
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Copy stream words g0 + k, k in [lo, hi), into buf[k]; g0's address is
// 16 B aligned. Whole quads inside the stream and the archive go by
// cp.async, the rest word by word (clamped). Thread t of nt.
__device__ __forceinline__ void stage_stream(uint32_t* buf, const uint32_t* w,
                                             int64_t n, int64_t g0, int lo,
                                             int hi, int t, int nt) {
  for (int q = t; 4 * q < hi; q += nt) {
    const int k0 = 4 * q;
    const int64_t g = g0 + k0;
    if (k0 >= lo && k0 + 4 <= hi && g >= 0 && g + 4 <= n) {
      cp_async16(buf + k0, w + g);
    } else {
      for (int k = k0; k < k0 + 4; ++k) {
        if (k >= lo && k < hi) buf[k] = __ldg(w + clamp_word(g0 + k, n));
      }
    }
  }
}

__device__ __forceinline__ uint32_t ror1_halves(uint32_t v) {
  return ((v >> 1) & 0x7FFF7FFFu) | ((v << 15) & 0x80008000u);
}

// The first n bytes of v (all of them for n >= 16, none for n <= 0).
__device__ __forceinline__ uint4 keep_bytes(uint4 v, int n) {
  if (n >= 16) return v;
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = n - 4 * k;
    w[k] &= m >= 4 ? 0xFFFFFFFFu : (m <= 0 ? 0u : (1u << (8 * m)) - 1u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int kEpi, bool kClassic>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
rans_decode_kernel(const DecodeArgs a) {
  __shared__ __align__(16) uint32_t sh_stream[kStreamBuf];
  __shared__ uint32_t sh_lut[kMaxLut];
  // the row's symbols: byte p of block w at [w * 4096 + p]
  __shared__ __align__(16) uint32_t sh_sym[kRowBlocks * kBlockBytes / 4];
  __shared__ int sh_cw[kRowBlocks];
  __shared__ int sh_uw[kRowBlocks];
  __shared__ __align__(16) int sh_cnt[2][kRowBlocks];
  const int64_t row = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t nr = gridDim.x;
  const int tid = threadIdx.x;
  const int blk = tid / kWarp;
  const int lane = tid % kWarp;
  const int64_t gb = row * kRowBlocks + blk;
  const bool live = gb < a.nb;
  const int64_t blk_idx = b * a.nb + (live ? gb : 0);
  const int uw = live ? a.uncomp_w[blk_idx] : 0;
  const int cw = live ? a.comp_w[blk_idx] : 0;
  if (lane == 0) {
    sh_cw[blk] = cw;
    sh_uw[blk] = uw;
  }

  // 1. the stream(s) into shared memory: the row's one stream with every
  // thread, or each block's own with its warp
  const int64_t seg = kClassic ? (live ? blk_idx : -1) : b * nr + row;
  int64_t s = 0, len = 0;
  if (seg >= 0) {
    s = a.seg_off[seg];
    len = a.seg_len[seg];
    const int64_t cap = kClassic ? kBlockCap : kRowCap;
    len = len < 0 ? 0 : (len > cap ? cap : len);
  }
  const int shift =
      (int)(((int64_t)(reinterpret_cast<uintptr_t>(a.words) >> 2) + s) & 3);
  uint32_t* sbuf = sh_stream + (kClassic ? blk * kBlockBuf : 0);
  if (kClassic ? lane == 0 : tid == 0) sbuf[shift + len] = 0u;
  if (kClassic) {
    stage_stream(sbuf, a.words, a.nwords, s - shift, shift, shift + (int)len,
                 lane, kWarp);
  } else {
    stage_stream(sbuf, a.words, a.nwords, s - shift, shift, shift + (int)len,
                 tid, kThreads);
  }

  // 2. the LUT and this lane's state while the copies fly
  const int nslots = 1 << a.prob_bits;
  for (int i = tid; i < nslots; i += kThreads) {
    sh_lut[i] = __ldg(a.lut + b * nslots + i);
  }
  uint32_t state = 0;
  if (uw > 0) {
    state = __ldg(a.words + clamp_word(a.state_off[b] + 32 * gb + lane,
                                       a.nwords));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  int ptr = 0;  // one past the stream's last unread u16 word
  if constexpr (kClassic) {
    ptr = sh_cw[blk];
  } else {
    for (int w = 0; w < kRowBlocks; ++w) ptr += sh_cw[w];
  }
  // the first step at which this lane decodes (past the last if never)
  const int nsteps = (uw + kWarp - 1) / kWarp;
  const int first =
      uw > 0 ? kSteps - nsteps + (lane < (uw - 1) % kWarp + 1 ? 0 : 1) : kSteps;
  const uint32_t smask = (uint32_t)nslots - 1u;
  const int pb = a.prob_bits;
  const unsigned at_or_above = ~((1u << lane) - 1u);
  // the higher warps' read counts of a step, as masks over the 4 counts
  const int m1 = blk < 1 ? -1 : 0, m2 = blk < 2 ? -1 : 0, m3 = blk < 3 ? -1 : 0;
  const uint32_t* sstream = sbuf + shift;
  const int slen = (int)len;
  uint8_t* sp = reinterpret_cast<uint8_t*>(sh_sym) + blk * kBlockBytes +
                kWarp * (kSteps - 1) + lane;

  // 3. the walk: shared memory only, no branch. A lane that does not decode
  // keeps its state; its symbol byte is masked by the epilogue. A stream
  // read below word 0 takes word 0, one at or past the length the zero
  // word behind the stream.
#pragma unroll 4
  for (int i = 0; i < kSteps; ++i) {
    const uint32_t ent = sh_lut[state & smask];
    const bool valid = i >= first;
    const uint32_t next = ((ent >> 8) & 0xFFFu) * (state >> pb) + (ent >> 20);
    state = valid ? next : state;
    *sp = (uint8_t)ent;
    sp -= kWarp;

    const bool read = valid && state < (1u << 15);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, read);
    int higher = 0, total;
    if constexpr (kClassic) {
      total = __popc(ballot);
    } else {
      if (lane == 0) sh_cnt[i & 1][blk] = __popc(ballot);
      __syncthreads();
      const int4 c = reinterpret_cast<const int4*>(sh_cnt)[i & 1];
      total = c.x + c.y + c.z + c.w;
      higher = (c.y & m1) + (c.z & m2) + (c.w & m3);
    }
    const int idx16 = ptr - higher - __popc(ballot & at_or_above);
    const uint32_t word = sstream[min(max(idx16 >> 1, 0), slen)];
    const uint32_t half = (idx16 & 1) ? word >> 16 : word & 0xFFFFu;
    state = read ? (state << 16) + half : state;
    ptr -= total;
  }
  __syncthreads();

  // 4. the epilogue: the row's live blocks with 16 B stores, zero at and
  // past each block's count; the archive loads of a pass all start before
  // its stores
  if constexpr (kEpi == kBytes) {
    for (int w = 0; w < kRowBlocks; ++w) {
      const int64_t g = row * kRowBlocks + w;
      if (g >= a.nb) break;
      const int u = sh_uw[w];
      const uint4* ssym = reinterpret_cast<const uint4*>(sh_sym) + w * 256;
      uint4* o = reinterpret_cast<uint4*>(a.out) + (b * a.nb + g) * 256;
      for (int j = tid; j < 256; j += kThreads) {
        o[j] = keep_bytes(ssym[j], u - 16 * j);
      }
    }
  } else if constexpr (kEpi == kJoin16) {
    // 16 floats a unit: raw words 4j..4j+3 and symbol bytes 16j..16j+15 of
    // block w, for the thread's 2 units in each of the 4 blocks
    constexpr int kUnits = 256 / kThreads;
    uint32_t r[kRowBlocks][kUnits][4];
#pragma unroll
    for (int w = 0; w < kRowBlocks; ++w) {
      const int64_t g = row * kRowBlocks + w;
      const int u = g < a.nb ? sh_uw[w] : 0;
      const int64_t rw = g < a.nb ? a.raw_off[b] + 1024 * g : 0;
#pragma unroll
      for (int t = 0; t < kUnits; ++t) {
        const int j = tid + kThreads * t;
        if (16 * j < u) {
          load_words<4>(a.words, a.nwords, rw + 4 * j, r[w][t]);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < kRowBlocks; ++w) {
      const int64_t g = row * kRowBlocks + w;
      if (g >= a.nb) break;
      const int u = sh_uw[w];
      const uint4* ssym = reinterpret_cast<const uint4*>(sh_sym) + w * 256;
      uint4* o = reinterpret_cast<uint4*>(a.out) + (b * a.nb + g) * 512;
#pragma unroll
      for (int t = 0; t < kUnits; ++t) {
        const int j = tid + kThreads * t;
        uint32_t f[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
        if (16 * j < u) {
          const uint4 e4 = ssym[j];
          const uint32_t e[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            // floats 2q, 2q + 1: raw | sym << 8 each
            uint32_t x = __byte_perm(r[w][t][q / 2], e[q / 2],
                                     (q & 1) ? 0x7362 : 0x5140);
            if (a.bf16) x = ror1_halves(x);
            const int p = 16 * j + 2 * q;
            if (p + 1 >= u) x &= p < u ? 0xFFFFu : 0u;
            f[q] = x;
          }
        }
        o[2 * j] = make_uint4(f[0], f[1], f[2], f[3]);
        o[2 * j + 1] = make_uint4(f[4], f[5], f[6], f[7]);
      }
    }
  } else {
    // 8 floats a unit: sec1 words 4j..4j+3, sec2 words 2j, 2j + 1 and
    // symbol bytes 8j..8j+7, for the thread's 4 units in each block; two
    // blocks a pass
    constexpr int kUnits = 512 / kThreads;
#pragma unroll
    for (int w0 = 0; w0 < kRowBlocks; w0 += 2) {
      uint32_t s1[2][kUnits][4], s2[2][kUnits][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t g = row * kRowBlocks + w0 + h;
        const int u = g < a.nb ? sh_uw[w0 + h] : 0;
        const int64_t w1 = g < a.nb ? a.raw_off[b] + 2048 * g : 0;
        const int64_t w2 = g < a.nb ? a.sec2_off[b] + 1024 * g : 0;
#pragma unroll
        for (int t = 0; t < kUnits; ++t) {
          const int j = tid + kThreads * t;
          if (8 * j < u) {
            load_words<4>(a.words, a.nwords, w1 + 4 * j, s1[h][t]);
            load_words<2>(a.words, a.nwords, w2 + 2 * j, s2[h][t]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t g = row * kRowBlocks + w0 + h;
        if (g >= a.nb) break;
        const int u = sh_uw[w0 + h];
        const uint2* ssym =
            reinterpret_cast<const uint2*>(sh_sym) + (w0 + h) * 512;
        uint4* o = reinterpret_cast<uint4*>(a.out) + (b * a.nb + g) * 1024;
#pragma unroll
        for (int t = 0; t < kUnits; ++t) {
          const int j = tid + kThreads * t;
          uint32_t f[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
          if (8 * j < u) {
            const uint2 e2 = ssym[j];
            const uint32_t e[2] = {e2.x, e2.y};
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const uint32_t low = (s1[h][t][q / 2] >> (16 * (q & 1))) & 0xFFFFu;
              const uint32_t third = (s2[h][t][q / 4] >> (8 * (q & 3))) & 0xFFu;
              const uint32_t ex = (e[q / 4] >> (8 * (q & 3))) & 0xFFu;
              const uint32_t x = low | (third << 16) | (ex << 24);
              f[q] = 8 * j + q < u ? (x >> 1) | (x << 31) : 0u;
            }
          }
          o[2 * j] = make_uint4(f[0], f[1], f[2], f[3]);
          o[2 * j + 1] = make_uint4(f[4], f[5], f[6], f[7]);
        }
      }
    }
  }
}

template <int kEpi, bool kClassic>
int launch(const DecodeArgs& a, long long batch, void* stream) {
  const long long nr = (a.nb + kRowBlocks - 1) / kRowBlocks;
  dim3 grid((unsigned)nr, (unsigned)batch);
  rans_decode_kernel<kEpi, kClassic>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// epi: 0 bytes (K6, out u8[B, nb, 4096]), 1 16-bit join (K4, out
// u16[B, nb, 4096]), 2 fp32 join (K12, out u32[B, nb, 4096]); classic: the
// 0xD00D layout (one stream per block) else row streams (one per row of 4
// blocks). words: u32[nwords] archive words; seg_off, seg_len:
// i64[B, nseg] (nseg = nb classic, ceil(nb / 4) rows); comp_w, uncomp_w:
// i32[B, nb]; state_off: i64[B]; lut: u32[B, 2^prob_bits]; raw_off: i64[B]
// (K4 raw words, K12 sec1 words; else null); sec2_off: i64[B] (K12, else
// null); out 16 B aligned. Returns cudaGetLastError() after the launch.
extern "C" int dgt_rans_decode(int epi, int classic, const void* words,
                               long long nwords, const void* seg_off,
                               const void* seg_len, const void* comp_w,
                               const void* uncomp_w, const void* state_off,
                               const void* lut, int prob_bits,
                               const void* raw_off, const void* sec2_off,
                               long long batch, long long nb, int bf16,
                               void* out, void* stream) {
  DecodeArgs a;
  a.words = (const uint32_t*)words;
  a.nwords = nwords;
  a.seg_off = (const int64_t*)seg_off;
  a.seg_len = (const int64_t*)seg_len;
  a.comp_w = (const int32_t*)comp_w;
  a.uncomp_w = (const int32_t*)uncomp_w;
  a.state_off = (const int64_t*)state_off;
  a.lut = (const uint32_t*)lut;
  a.raw_off = (const int64_t*)raw_off;
  a.sec2_off = (const int64_t*)sec2_off;
  a.prob_bits = prob_bits;
  a.bf16 = bf16;
  a.nb = nb;
  a.out = out;
  switch (epi * 2 + (classic ? 1 : 0)) {
    case 0: return launch<kBytes, false>(a, batch, stream);
    case 1: return launch<kBytes, true>(a, batch, stream);
    case 2: return launch<kJoin16, false>(a, batch, stream);
    case 3: return launch<kJoin16, true>(a, batch, stream);
    case 4: return launch<kJoin32, false>(a, batch, stream);
    case 5: return launch<kJoin32, true>(a, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
