// K2: interleaved 32-state rANS encode, with the emitted words compacted
// into the archive's stream order: the row-stream (0xDB0D) layout
// (dgt_rans_encode_rows) or the classic (0xD00D) one
// (dgt_rans_encode_blocks). One walk, two epilogues (a template parameter
// of one kernel).
//
// Replaces three Pallas kernels of the JAX package's
// ops/pallas/rans_encode_fused.py: _encode_kernel (:114, the walk, emitting
// a word and a mask bit per step and lane), _compact_kernel_rows (:420,
// ordering the emissions into one stream per row of 4 blocks) and, for the
// classic layout, _compact_kernel (:305, one stream per 4 KiB block). The
// TPU split walk and compaction because it has no warp ballot or scatter.
// Contract: dietgpu_fork_torch/ops/rans_encode.py::encode_rows_plain and
// ::encode_blocks_plain, the JAX package's encode_blocks_rows and
// encode_blocks.
//
// One CTA per row = 4 blocks x 32 states = 128 threads (warp w encodes block
// 4*row + w, lane l codes bytes 32*s + l of it at step s). A block's stream
// (classic) is step-major, lanes ascending, so a writing lane's slot is
// (words the block emitted before this step) + popc(ballot & lanes below
// me). The row stream is step-major and, within a step, blocks then lanes
// ascending: the slot adds the words of the row before this step and of the
// lower blocks at this step. The division state / pdf is the reference's
// magic multiply with __umulhi.
//
// Bound on the card: the walk, 128 dependent steps a block, and the rate
// its instructions issue at (about 30 a step), not the bytes (16 KiB of
// symbols in and 20 KiB of stream out a row). So:
// - nothing on the chain touches device memory: the CTA copies its blocks'
//   symbols (the bytes below the member's size) into shared memory with 16 B
//   cp.async before the walk, beside a per-symbol table of the step's
//   constants (pdf << (31 - prob_bits), magic, 2^prob_bits - pdf, cdf and
//   shift: one 16 B shared load a step), and each step loads the table
//   entry of the next step and the symbol of the one after, ahead of the
//   state's chain;
// - the step has no branch: validity is one compare against the block's byte
//   count, none at all for a full block (a full row in the row layout), and
//   a lane that does not write or is not valid keeps its state by a select;
// - the words go to shared memory: the classic layout appends each block's
//   words to its own buffer of 2560 u16 (its cap) and needs no barrier; the
//   row layout writes them straight into the row's buffer of 10240 u16 (the
//   row's cap: a block alone may pass 2560, as the contract allows), the
//   lower blocks' counts of the step coming from shared memory after one
//   barrier a step (double-buffered). A barrier a step costs less than
//   placing per-block buffers into the row after the walk (measured);
// - after the walk each stream is written with 16 B stores, zero past its
//   words.
// Shared memory: symbols 16 KiB, table 4 KiB, streams 20 KiB: 40 KiB, 5
// CTAs an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowBlocks = 4;
constexpr int kThreads = kWarp * kRowBlocks;
constexpr int kSteps = 128;
constexpr int kBlockBytes = 4096;
constexpr int kBlockWords16 = 2560;  // a classic stream's cap, u16
constexpr int kRowWords16 = 4 * kBlockWords16;  // a row stream's cap
constexpr int kCtasPerSm = 5;

struct __align__(16) Smem {
  uint8_t sym[kRowBlocks * kBlockBytes];  // block w's bytes at w * 4096
  uint4 tab[256];  // thr, magic, 2^prob_bits - pdf, cdf | shift << 16
  union {
    uint16_t emit[kRowBlocks][kBlockWords16];  // classic: each block's stream
    uint16_t row[kRowWords16];  // rows: the row's stream
  } out;
  int cnt[2][kRowBlocks];  // rows: words of each block at a step
};
static_assert(sizeof(Smem) <= 48 * 1024, "static shared memory");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The first n u16 of v (all of them for n >= 8).
__device__ __forceinline__ uint4 keep_halves(uint4 v, int n) {
  if (n >= 8) return v;
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = n - 2 * k;
    w[k] &= m >= 2 ? 0xFFFFFFFFu : (m == 1 ? 0xFFFFu : 0u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 128 steps of one block. kFull: every byte of the block is below the
// member's size; else step s is valid for this lane iff 32 s < lane_lim.
// Classic: the block's words go to its own buffer (dropped past 2560); rows:
// one barrier a step gives every block's count, and the words go to the
// row's buffer (dropped past 10240). words counts the block's emissions;
// returns the row's words (rows; 0 classic).
template <bool kClassic, bool kFull>
__device__ __forceinline__ int walk(Smem& sm, int blk, int lane, int lane_lim,
                                    uint32_t& state, int& words) {
  const uint8_t* ssym = sm.sym + blk * kBlockBytes + lane;
  const uint4* tab = sm.tab;
  uint16_t* out = kClassic ? sm.out.emit[blk] : sm.out.row;
  constexpr int cap = kClassic ? kBlockWords16 : kRowWords16;
  const unsigned below = (1u << lane) - 1u;
  // the lower blocks' counts of a step, as masks over the 4 counts
  const int m1 = blk > 0 ? -1 : 0, m2 = blk > 1 ? -1 : 0, m3 = blk > 2 ? -1 : 0;
  int row_words = 0;  // words the row emitted before this step
  uint32_t c1 = ssym[kWarp];
  uint4 e = tab[ssym[0]];
#pragma unroll 8
  for (int s = 0; s < kSteps; ++s) {
    const bool valid = kFull || kWarp * s < lane_lim;
    const uint4 en = tab[c1];
    c1 = ssym[kWarp * (s + 2)];
    const bool write = valid && state >= e.x;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, write);
    const int n = __popc(ballot);
    const int rank = __popc(ballot & below);
    int slot = words + rank;
    if constexpr (!kClassic) {
      if (lane == 0) sm.cnt[s & 1][blk] = n;
      __syncthreads();
      const int4 c = reinterpret_cast<const int4*>(sm.cnt)[s & 1];
      slot = row_words + (c.x & m1) + (c.y & m2) + (c.z & m3) + rank;
      row_words += c.x + c.y + c.z + c.w;
    }
    if (write && slot < cap) out[slot] = (uint16_t)state;
    words += n;
    const uint32_t x = write ? state >> 16 : state;
    // (q << prob_bits) + (x - q * pdf) + cdf, q = x / pdf
    const uint32_t q = (__umulhi(x, e.y) + x) >> (e.w >> 16);
    const uint32_t next = q * e.z + x + (e.w & 0xFFFFu);
    state = valid ? next : x;
    e = en;
  }
  return row_words;
}

// kClassic: one stream per block, streams u16[B, nb, 2560]; else one per
// row of 4 blocks, streams u16[B, nr, 10240].
template <bool kClassic>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
rans_encode_kernel(const uint8_t* __restrict__ sym,
                   const int32_t* __restrict__ sizes,
                   const uint32_t* __restrict__ packed,
                   const uint32_t* __restrict__ magic, int64_t nb, int64_t nr,
                   int prob_bits, uint32_t* __restrict__ states_out,
                   uint16_t* __restrict__ streams,
                   int32_t* __restrict__ num_words) {
  __shared__ Smem sm;
  const int64_t row = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const int blk = tid / kWarp;
  const int lane = tid % kWarp;
  const int64_t gb = row * kRowBlocks + blk;
  const bool live = gb < nb;
  // this block's bytes below the member's size, 0 to 4096
  const int64_t rem = live ? (int64_t)sizes[b] - gb * kBlockBytes : 0;
  const int lim = rem <= 0 ? 0 : (rem >= kBlockBytes ? kBlockBytes : (int)rem);

  // 1. the block's bytes below lim into shared memory, in 16 B chunks (the
  // rows are whole blocks, so every block has the base's alignment)
  uint8_t* ssym = sm.sym + blk * kBlockBytes;
  const uint8_t* src = sym + (b * nb + (live ? gb : 0)) * kBlockBytes;
  if ((reinterpret_cast<uintptr_t>(sym) & 15) == 0) {
    for (int c = lane; 16 * c < lim; c += kWarp) {
      cp_async16(ssym + 16 * c, src + 16 * c);
    }
  } else {
    for (int c = lane; 4 * c < lim; c += kWarp) {
      reinterpret_cast<uint32_t*>(ssym)[c] =
          __ldg(reinterpret_cast<const uint32_t*>(src) + c);
    }
  }
  // 2. the step's constants per symbol while the copies fly
  const uint32_t check_shift = 31 - prob_bits;
  for (int i = tid; i < 256; i += kThreads) {
    const uint32_t t = __ldg(packed + b * 256 + i);
    const uint32_t pdf = t & 0xFFFu;
    const uint32_t cdf = (t >> 12) & 0x7FFu;
    const uint32_t shift = min(t >> 23, 31u);
    sm.tab[i] = make_uint4(pdf << check_shift, __ldg(magic + b * 256 + i),
                           (1u << prob_bits) - pdf, cdf | (shift << 16));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // rows: the walk has a barrier a step, so its form is the CTA's (full when
  // the row's 4 blocks are)
  const bool row_full = __syncthreads_and(lim == kBlockBytes);

  // 3. the walk: shared memory and registers only
  uint32_t state = 1u << 15;
  int words = 0, row_words = 0;
  if constexpr (kClassic) {
    if (lim == kBlockBytes) {
      walk<true, true>(sm, blk, lane, 0, state, words);
    } else if (lim > 0) {
      walk<true, false>(sm, blk, lane, lim - lane, state, words);
    }
  } else if (row_full) {
    row_words = walk<false, true>(sm, blk, lane, 0, state, words);
  } else {
    row_words = walk<false, false>(sm, blk, lane, lim - lane, state, words);
  }
  if (live) {
    states_out[(b * nb + gb) * kWarp + lane] = state;
    if (lane == 0) num_words[b * nb + gb] = words;
  }

  // 4. the epilogue: 16 B stores, zero past the stream's words (the merge
  // copies (words + 1) >> 1 u32 words, so the odd trailing half is zero too)
  if constexpr (kClassic) {
    __syncwarp();
    if (!live) return;
    const int n = words < kBlockWords16 ? words : kBlockWords16;
    const uint4* e4 = reinterpret_cast<const uint4*>(sm.out.emit[blk]);
    uint4* o = reinterpret_cast<uint4*>(streams + (b * nb + gb) * kBlockWords16);
    for (int j = lane; j < kBlockWords16 / 8; j += kWarp) {
      o[j] = 8 * j < n ? keep_halves(e4[j], n - 8 * j) : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    __syncthreads();  // the last step's words
    const int n = row_words < kRowWords16 ? row_words : kRowWords16;
    const uint4* r4 = reinterpret_cast<const uint4*>(sm.out.row);
    uint4* o = reinterpret_cast<uint4*>(streams + (b * nr + row) * kRowWords16);
    for (int j = tid; j < kRowWords16 / 8; j += kThreads) {
      o[j] = 8 * j < n ? keep_halves(r4[j], n - 8 * j) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <bool kClassic>
int launch(const void* sym, const void* sizes, const void* packed,
           const void* magic, long long batch, long long nb, int prob_bits,
           void* states_out, void* streams, void* num_words, void* stream) {
  const long long nr = (nb + kRowBlocks - 1) / kRowBlocks;
  dim3 grid((unsigned)nr, (unsigned)batch);
  rans_encode_kernel<kClassic><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sym, (const int32_t*)sizes, (const uint32_t*)packed,
      (const uint32_t*)magic, nb, nr, prob_bits, (uint32_t*)states_out,
      (uint16_t*)streams, (int32_t*)num_words);
  return (int)cudaGetLastError();
}

}  // namespace

// sym: u8[B, nb * 4096], 4 B aligned; sizes: i32[B] byte counts; packed,
// magic: u32[B, 256] (pdf | cdf << 12 | shift << 23, and the magic
// multipliers). Writes states u32[B, nb, 32], streams u16[B, nr, 10240] (16
// B aligned) and num_words i32[B, nb]. Returns cudaGetLastError() after the
// launch.
extern "C" int dgt_rans_encode_rows(const void* sym, const void* sizes,
                                    const void* packed, const void* magic,
                                    long long batch, long long nb,
                                    int prob_bits, void* states_out,
                                    void* streams, void* num_words,
                                    void* stream) {
  return launch<false>(sym, sizes, packed, magic, batch, nb, prob_bits,
                       states_out, streams, num_words, stream);
}

// As dgt_rans_encode_rows, in the classic layout: streams u16[B, nb, 2560].
extern "C" int dgt_rans_encode_blocks(const void* sym, const void* sizes,
                                      const void* packed, const void* magic,
                                      long long batch, long long nb,
                                      int prob_bits, void* states_out,
                                      void* streams, void* num_words,
                                      void* stream) {
  return launch<true>(sym, sizes, packed, magic, batch, nb, prob_bits,
                      states_out, streams, num_words, stream);
}

// CTAs of the encode kernel (classic or row layout) resident on one SM, or
// the negated CUDA error.
extern "C" int dgt_rans_encode_ctas_per_sm(int classic) {
  int n = 0;
  const cudaError_t e =
      classic ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, rans_encode_kernel<true>, kThreads, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, rans_encode_kernel<false>, kThreads, 0);
  return e == cudaSuccess ? n : -(int)e;
}
