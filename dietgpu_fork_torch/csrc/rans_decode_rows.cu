// K4 and K6: rANS decode, one walk with two epilogues, over the row-stream
// (0xDB0D) layout or the classic (0xD00D) one.
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
// 16 bits for bf16. Both write 0 at positions >= the block's decoded count.
//
// Classic layout (dgt_rans_decode_blocks, dgt_rans_decode_join16_blocks):
// replaces _decode_kernel2 with row_stream=False, in mode JOIN_NONE (call at
// rans_decode_fused2.py:517) and JOIN_F16/BF16 (call at :620). Contracts:
// ops/rans_decode.py::decode_blocks_plain and decode_join16_blocks_plain,
// the JAX package's decode_blocks. Each warp reads its own block's stream,
// staged at [B, nb, sw], with its own cursor: the reverse order is a suffix
// of the warp's ballot alone, with no shared counts and no barrier a step.
// The walk and both epilogues are the row layout's.
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

// kJoin16: K4's epilogue (raw bytes in, u16 floats out); else K6's (u8 out).
// kClassic: streams u32[B, nb, sw], one per block; else u32[B, nr, sw].
template <bool kJoin16, bool kClassic>
__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const uint32_t* __restrict__ streams, int64_t sw,
                   const int32_t* __restrict__ comp_w,
                   const int32_t* __restrict__ uncomp_w,
                   const uint32_t* __restrict__ states,
                   const uint32_t* __restrict__ lut, int prob_bits,
                   const uint8_t* __restrict__ raw, int64_t nb, int64_t nr,
                   int bf16, void* __restrict__ out) {
  __shared__ uint32_t sh_lut[kMaxLut];
  __shared__ int sh_cw[kRowBlocks];
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
  if (lane == 0) sh_cw[blk] = live ? comp_w[blk_idx] : 0;
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
  const uint8_t* rawb = kJoin16 ? raw + blk_idx * kBlockBytes : nullptr;
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
      if constexpr (kJoin16) {
        v = (uint32_t)rawb[p] | (v << 8);
        if (bf16) v = ((v >> 1) | (v << 15)) & 0xFFFFu;
      }
    }
    if (live) {
      if constexpr (kJoin16) {
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
}

template <bool kJoin16, bool kClassic>
int launch(const void* streams, long long sw, const void* comp_w,
           const void* uncomp_w, const void* states, const void* lut,
           int prob_bits, const void* raw, long long batch, long long nb,
           int bf16, void* out, void* stream) {
  const long long nr = (nb + kRowBlocks - 1) / kRowBlocks;
  dim3 grid((unsigned)nr, (unsigned)batch);
  rans_decode_kernel<kJoin16, kClassic>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)streams, sw, (const int32_t*)comp_w,
      (const int32_t*)uncomp_w, (const uint32_t*)states,
      (const uint32_t*)lut, prob_bits, (const uint8_t*)raw, nb, nr, bf16, out);
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
  return launch<false, false>(streams, sw, comp_w, uncomp_w, states, lut,
                              prob_bits, nullptr, batch, nb, 0, out, stream);
}

// As dgt_rans_decode_rows, plus raw: u8[B, nb, 4096] block-major raw bytes.
// Writes out u16[B, nb, 4096].
extern "C" int dgt_rans_decode_join16(const void* streams, long long sw,
                                      const void* comp_w, const void* uncomp_w,
                                      const void* states, const void* lut,
                                      int prob_bits, const void* raw,
                                      long long batch, long long nb, int bf16,
                                      void* out, void* stream) {
  return launch<true, false>(streams, sw, comp_w, uncomp_w, states, lut,
                             prob_bits, raw, batch, nb, bf16, out, stream);
}

// As dgt_rans_decode_rows, in the classic layout: streams u32[B, nb, sw].
extern "C" int dgt_rans_decode_blocks(const void* streams, long long sw,
                                      const void* comp_w, const void* uncomp_w,
                                      const void* states, const void* lut,
                                      int prob_bits, long long batch,
                                      long long nb, void* out, void* stream) {
  return launch<false, true>(streams, sw, comp_w, uncomp_w, states, lut,
                             prob_bits, nullptr, batch, nb, 0, out, stream);
}

// As dgt_rans_decode_join16, in the classic layout: streams u32[B, nb, sw].
extern "C" int dgt_rans_decode_join16_blocks(
    const void* streams, long long sw, const void* comp_w,
    const void* uncomp_w, const void* states, const void* lut, int prob_bits,
    const void* raw, long long batch, long long nb, int bf16, void* out,
    void* stream) {
  return launch<true, true>(streams, sw, comp_w, uncomp_w, states, lut,
                            prob_bits, raw, batch, nb, bf16, out, stream);
}
