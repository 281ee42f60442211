// K4, K6 and K12: rANS decode, one walk with three epilogues, over the
// row-stream (0xDB0D) layout or the classic (0xD00D) one.
//
// K6 (dgt_rans_decode_rows) writes the decoded bytes. It replaces the JAX
// package's ops/pallas/rans_decode_fused2.py::_decode_kernel2 in mode
// JOIN_NONE with row=True (entry decode_blocks_fused2(row_stream=True)), the
// fp32/fp64 planes' decode. Contract: dietgpu_fork_torch/ops/rans_decode.py
// ::decode_rows_plain, the JAX package's decode_blocks_rows.
//
// K4 (dgt_rans_decode_join16) joins each decoded exponent byte with its raw
// byte into a 16-bit float. It replaces _decode_kernel2 in modes JOIN_F16 /
// JOIN_BF16 with row=True (entry decode_join16_fused). Contract:
// ops/rans_decode.py::decode_join16_plain, decode_blocks_rows followed by
// the 16-bit join_packed.
//
// K12 (dgt_rans_decode_join32) joins each decoded exponent byte with the
// float's low 16 bits (sec1) and third byte (sec2) into an fp32 word,
// ror1(low16 | sec2 byte << 16 | sym << 24). It replaces _decode_kernel2 in
// mode JOIN_F32 (entry decode_join32_fused, call rans_decode_fused2.py:731).
// Contract: ops/rans_decode.py::decode_join32_plain, decode_blocks_rows
// followed by the fp32 join_packed over block-major sections. The walk
// keeps each step's symbol bytes in shared memory (16 KiB a row) and joins
// after the last step, 4 floats a thread with 8 B and 4 B loads and one
// 16 B store: the 4 B/float output never enters the serial walk, whose
// register set stays K6's (the TPU's fused fp32 spilled there).
//
// One CTA per row of 4 blocks = 128 threads with ONE reverse cursor over the
// row's stream. The walk is bottom-aligned: at step i, block iteration
// k = i - (128 - nsteps), so every active block of the row undoes the same
// encode step 127 - i and the stream's reverse order is one suffix count over
// the row's 128 lanes (block-major, lane-minor): a reading lane takes the u16
// word at ptr - (reads of lanes >= it), the in-warp part from a ballot, the
// higher warps' part from shared memory. Iteration k = 0 covers the block's
// tail group of ((U - 1) mod 32) + 1 lanes.
//
// Step i decodes position p = 32 * (127 - i) + lane of each block. K6 writes
// the symbol byte there; K4 writes raw | sym << 8, rotated right by 1 within
// 16 bits for bf16; K12 keeps the byte for its join. All write 0 at
// positions >= the block's decoded count.
//
// Classic layout (dgt_rans_decode_blocks, dgt_rans_decode_join16_blocks,
// dgt_rans_decode_join32_blocks): replaces _decode_kernel2 with
// row_stream=False, in mode JOIN_NONE (call at rans_decode_fused2.py:517),
// JOIN_F16/BF16 (call at :620) and JOIN_F32 (call at :731). Contracts:
// ops/rans_decode.py::decode_blocks_plain, decode_join16_blocks_plain and
// decode_join32_blocks_plain, the JAX package's decode_blocks. Each warp
// reads its own block's stream, staged at [B, nb, sw], with its own cursor:
// the reverse order is a suffix of the warp's ballot alone, with no shared
// counts and no barrier a step. The walk and the epilogues are the row
// layout's.
//
// Bound on the card: the serial chain of 128 dependent steps (a shared LUT
// read, the state update, one barrier) per row; occupancy comes from the
// number of rows. The decode LUT ((slot - cdf) << 20 | pdf << 8 | sym,
// 2^prob_bits u32) sits in shared memory. The row stream is read from the
// start-aligned staging buffer; reading it from the archive in place is a
// later change. K6's byte stores are 32 B per warp and step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowBlocks = 4;
constexpr int kThreads = kWarp * kRowBlocks;
constexpr int kSteps = 128;
constexpr int kBlockBytes = 4096;
constexpr int kMaxLut = 1 << 11;

// The epilogue: K6 writes u8 symbols, K4 u16 floats joined with the raw
// bytes, K12 u32 floats joined with the two raw sections after the walk.
enum Epilogue { kBytes = 0, kJoin16 = 1, kJoin32 = 2 };

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int k) {
  return (w >> (8 * k)) & 0xFFu;
}

// kClassic: streams u32[B, nb, sw], one per block; else u32[B, nr, sw].
// raw: K4's u8[B, nb, 4096] raw bytes, K12's u32[B, nb, 2048] sec1 words;
// sec2: K12's u32[B, nb, 1024] third-byte words.
template <int kEpi, bool kClassic>
__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const uint32_t* __restrict__ streams, int64_t sw,
                   const int32_t* __restrict__ comp_w,
                   const int32_t* __restrict__ uncomp_w,
                   const uint32_t* __restrict__ states,
                   const uint32_t* __restrict__ lut, int prob_bits,
                   const void* __restrict__ raw,
                   const uint32_t* __restrict__ sec2, int64_t nb, int64_t nr,
                   int bf16, void* __restrict__ out) {
  __shared__ uint32_t sh_lut[kMaxLut];
  // K12's symbols: byte p of block w of the row at [w * 4096 + p]
  __shared__ uint32_t sh_sym[kEpi == kJoin32 ? kRowBlocks * kBlockBytes / 4 : 1];
  __shared__ int sh_cw[kRowBlocks];
  __shared__ int sh_uw[kRowBlocks];
  __shared__ int sh_cnt[2][kRowBlocks];
  const int64_t row = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const int blk = tid / kWarp;
  const int lane = tid % kWarp;
  const int nslots = 1 << prob_bits;
  for (int i = tid; i < nslots; i += kThreads) {
    sh_lut[i] = lut[b * nslots + i];
  }
  const int64_t gb = row * kRowBlocks + blk;
  const bool live = gb < nb;
  const int64_t blk_idx = b * nb + (live ? gb : 0);
  const int uw = live ? uncomp_w[blk_idx] : 0;
  if (lane == 0) {
    sh_cw[blk] = live ? comp_w[blk_idx] : 0;
    sh_uw[blk] = uw;
  }
  __syncthreads();

  int ptr = 0;  // one past the stream's last unread u16 word
  if constexpr (kClassic) {
    ptr = sh_cw[blk];
  } else {
    for (int w = 0; w < kRowBlocks; ++w) ptr += sh_cw[w];
  }
  const int nsteps = (uw + kWarp - 1) / kWarp;
  const int tail = uw > 0 ? ((uw - 1) % kWarp) + 1 : kWarp;
  const uint32_t smask = (uint32_t)nslots - 1u;
  uint32_t state = live ? states[blk_idx * kWarp + lane] : 0u;
  const uint8_t* rawb =
      kEpi == kJoin16 ? (const uint8_t*)raw + blk_idx * kBlockBytes : nullptr;
  const uint32_t* srow = streams + (kClassic ? blk_idx : b * nr + row) * sw;
  const unsigned at_or_above = ~((1u << lane) - 1u);

  for (int i = 0; i < kSteps; ++i) {
    const int k = i - (kSteps - nsteps);
    const bool valid = uw > 0 && k >= 0 && (k > 0 || lane < tail);
    const int p = kWarp * (kSteps - 1 - i) + lane;
    uint32_t v = 0;
    if (valid) {
      const uint32_t ent = sh_lut[state & smask];
      const uint32_t pdf = (ent >> 8) & 0xFFFu;
      state = pdf * (state >> prob_bits) + (ent >> 20);
      v = ent & 0xFFu;
      if constexpr (kEpi == kJoin16) {
        v = (uint32_t)rawb[p] | (v << 8);
        if (bf16) v = ((v >> 1) | (v << 15)) & 0xFFFFu;
      }
    }
    if constexpr (kEpi == kJoin32) {
      ((uint8_t*)sh_sym)[blk * kBlockBytes + p] = (uint8_t)v;
    } else if (live) {
      if constexpr (kEpi == kJoin16) {
        ((uint16_t*)out)[blk_idx * kBlockBytes + p] = (uint16_t)v;
      } else {
        ((uint8_t*)out)[blk_idx * kBlockBytes + p] = (uint8_t)v;
      }
    }

    const bool read = valid && state < (1u << 15);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, read);
    int higher = 0, total = 0;
    if constexpr (kClassic) {
      total = __popc(ballot);
    } else {
      if (lane == 0) sh_cnt[i & 1][blk] = __popc(ballot);
      __syncthreads();
      for (int w = 0; w < kRowBlocks; ++w) {
        const int c = sh_cnt[i & 1][w];
        total += c;
        if (w > blk) higher += c;
      }
    }
    if (read) {
      const int idx16 = ptr - (higher + __popc(ballot & at_or_above));
      int64_t idx32 = idx16 >> 1;
      idx32 = idx32 < 0 ? 0 : (idx32 > sw - 1 ? sw - 1 : idx32);
      const uint32_t word = srow[idx32];
      state = (state << 16) + ((idx16 & 1) ? (word >> 16) : (word & 0xFFFFu));
    }
    ptr -= total;
  }

  if constexpr (kEpi == kJoin32) {
    // the row's 4 blocks, each as 1024 groups of 4 floats: symbol word j of
    // the block, sec1 words 2j and 2j + 1, sec2 word j -> out words 4j..4j+3
    __syncthreads();
    const uint32_t* sec1 = (const uint32_t*)raw;
    for (int w = 0; w < kRowBlocks; ++w) {
      const int64_t g = row * kRowBlocks + w;
      if (g >= nb) break;
      const int64_t bi = b * nb + g;
      const int u = sh_uw[w];
      uint4* o = (uint4*)out + bi * (kBlockBytes / 4);
      for (int j = tid; j < kBlockBytes / 4; j += kThreads) {
        uint4 res = make_uint4(0u, 0u, 0u, 0u);
        if (4 * j < u) {
          const uint2 s1 = ((const uint2*)sec1)[bi * (kBlockBytes / 4) + j];
          const uint32_t t = sec2[bi * (kBlockBytes / 4) + j];
          const uint32_t e = sh_sym[w * (kBlockBytes / 4) + j];
          const uint32_t low[4] = {s1.x & 0xFFFFu, s1.x >> 16, s1.y & 0xFFFFu,
                                   s1.y >> 16};
          uint32_t f[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t r =
                low[q] | (byte_of(t, q) << 16) | (byte_of(e, q) << 24);
            f[q] = 4 * j + q < u ? (r >> 1) | (r << 31) : 0u;
          }
          res = make_uint4(f[0], f[1], f[2], f[3]);
        }
        o[j] = res;
      }
    }
  }
}

template <int kEpi, bool kClassic>
int launch(const void* streams, long long sw, const void* comp_w,
           const void* uncomp_w, const void* states, const void* lut,
           int prob_bits, const void* raw, const void* sec2, long long batch,
           long long nb, int bf16, void* out, void* stream) {
  const long long nr = (nb + kRowBlocks - 1) / kRowBlocks;
  dim3 grid((unsigned)nr, (unsigned)batch);
  rans_decode_kernel<kEpi, kClassic>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)streams, sw, (const int32_t*)comp_w,
      (const int32_t*)uncomp_w, (const uint32_t*)states,
      (const uint32_t*)lut, prob_bits, raw, (const uint32_t*)sec2, nb, nr,
      bf16, out);
  return (int)cudaGetLastError();
}

}  // namespace

// streams: u32[B, nr, sw] start-aligned staged row streams (u16 pairs);
// comp_w, uncomp_w: i32[B, nb]; states: u32[B, nb, 32]; lut:
// u32[B, 2^prob_bits]. Writes out u8[B, nb, 4096]. Returns
// cudaGetLastError() after the launch.
extern "C" int dgt_rans_decode_rows(const void* streams, long long sw,
                                    const void* comp_w, const void* uncomp_w,
                                    const void* states, const void* lut,
                                    int prob_bits, long long batch,
                                    long long nb, void* out, void* stream) {
  return launch<kBytes, false>(streams, sw, comp_w, uncomp_w, states, lut,
                               prob_bits, nullptr, nullptr, batch, nb, 0, out,
                               stream);
}

// As dgt_rans_decode_rows, plus raw: u8[B, nb, 4096] block-major raw bytes.
// Writes out u16[B, nb, 4096].
extern "C" int dgt_rans_decode_join16(const void* streams, long long sw,
                                      const void* comp_w, const void* uncomp_w,
                                      const void* states, const void* lut,
                                      int prob_bits, const void* raw,
                                      long long batch, long long nb, int bf16,
                                      void* out, void* stream) {
  return launch<kJoin16, false>(streams, sw, comp_w, uncomp_w, states, lut,
                                prob_bits, raw, nullptr, batch, nb, bf16, out,
                                stream);
}

// As dgt_rans_decode_rows, plus sec1: u32[B, nb, 2048] block-major low-u16
// pairs (8 B aligned) and sec2: u32[B, nb, 1024] block-major third bytes.
// Writes out u32[B, nb, 4096] (16 B aligned): fp32 words.
extern "C" int dgt_rans_decode_join32(const void* streams, long long sw,
                                      const void* comp_w, const void* uncomp_w,
                                      const void* states, const void* lut,
                                      int prob_bits, const void* sec1,
                                      const void* sec2, long long batch,
                                      long long nb, void* out, void* stream) {
  return launch<kJoin32, false>(streams, sw, comp_w, uncomp_w, states, lut,
                                prob_bits, sec1, sec2, batch, nb, 0, out,
                                stream);
}

// As dgt_rans_decode_rows, in the classic layout: streams u32[B, nb, sw].
extern "C" int dgt_rans_decode_blocks(const void* streams, long long sw,
                                      const void* comp_w, const void* uncomp_w,
                                      const void* states, const void* lut,
                                      int prob_bits, long long batch,
                                      long long nb, void* out, void* stream) {
  return launch<kBytes, true>(streams, sw, comp_w, uncomp_w, states, lut,
                              prob_bits, nullptr, nullptr, batch, nb, 0, out,
                              stream);
}

// As dgt_rans_decode_join16, in the classic layout: streams u32[B, nb, sw].
extern "C" int dgt_rans_decode_join16_blocks(
    const void* streams, long long sw, const void* comp_w,
    const void* uncomp_w, const void* states, const void* lut, int prob_bits,
    const void* raw, long long batch, long long nb, int bf16, void* out,
    void* stream) {
  return launch<kJoin16, true>(streams, sw, comp_w, uncomp_w, states, lut,
                               prob_bits, raw, nullptr, batch, nb, bf16, out,
                               stream);
}

// As dgt_rans_decode_join32, in the classic layout: streams u32[B, nb, sw].
extern "C" int dgt_rans_decode_join32_blocks(
    const void* streams, long long sw, const void* comp_w,
    const void* uncomp_w, const void* states, const void* lut, int prob_bits,
    const void* sec1, const void* sec2, long long batch, long long nb,
    void* out, void* stream) {
  return launch<kJoin32, true>(streams, sw, comp_w, uncomp_w, states, lut,
                               prob_bits, sec1, sec2, batch, nb, 0, out,
                               stream);
}
