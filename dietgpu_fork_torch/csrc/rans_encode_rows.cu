// K2: interleaved 32-state rANS encode, with the emitted words compacted
// into the archive's stream order inside the walk: the row-stream (0xDB0D)
// layout (dgt_rans_encode_rows) or the classic (0xD00D) one
// (dgt_rans_encode_blocks), a template parameter of one kernel.
//
// Replaces two Pallas kernels of the JAX package's ops/pallas/rans_encode_fused.py:
// _encode_kernel (phase A: the walk, emitting a word and a mask bit per step
// and lane) and _compact_kernel_rows (phase B: ordering the emissions into one
// stream per row of 4 blocks). The TPU split the two because it has no warp
// ballot or scatter. Contract: dietgpu_fork_torch/ops/rans_encode.py
// ::encode_rows_plain, the JAX package's encode_blocks_rows.
//
// One CTA per row = 4 blocks x 32 states = 128 threads (warp w encodes block
// 4*row + w, lane l codes bytes 32*s + l of it at step s). The row stream is
// step-major and, within a step, blocks then lanes ascending, so at each step
// a writing lane's u16 slot is
//   (words the row emitted before this step)
//   + (words of lower blocks of the row at this step: shared memory)
//   + popc(ballot & lanes below me).
// Lanes past the member's size neither emit nor update their state. The
// division state / pdf is the reference's magic multiply with __umulhi.
//
// Classic layout: replaces the classic (native=False) mode of _encode_kernel
// and the Pallas _compact_kernel (rans_encode_fused.py:305), which orders the
// emissions into one stream per 4 KiB block. Contract:
// ops/rans_encode.py::encode_blocks_plain, the JAX package's encode_blocks.
// Each block's stream is step-major, lanes ascending, so a writing lane's
// slot is (words this block emitted before this step)
// + popc(ballot & lanes below me): no cross-warp count and no barrier a step.
//
// Bound on the card: the serial chain of 128 dependent steps, each with a
// CTA barrier in the row layout (the per-step counts double-buffer, so one
// barrier a step suffices) and none in the classic one. Occupancy comes
// from the number of rows (1024 at 16Mi floats). The coding tables
// (2 x 256 u32) sit in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowBlocks = 4;
constexpr int kThreads = kWarp * kRowBlocks;
constexpr int kSteps = 128;
constexpr int kBlockBytes = 4096;
constexpr int kBlockWords16 = 2560;  // one block's u16 worst case
constexpr int kRowWords16 = 4 * kBlockWords16;

// kClassic: one stream per block, streams u16[B, nb, 2560]; else one per
// row of 4 blocks, streams u16[B, nr, 10240].
template <bool kClassic>
__global__ void __launch_bounds__(kThreads)
rans_encode_kernel(const uint8_t* __restrict__ sym,
                   const int32_t* __restrict__ sizes,
                   const uint32_t* __restrict__ packed,
                   const uint32_t* __restrict__ magic, int64_t nb, int64_t nr,
                   int prob_bits, uint32_t* __restrict__ states_out,
                   uint16_t* __restrict__ streams,
                   int32_t* __restrict__ num_words) {
  __shared__ uint32_t sh_packed[256];
  __shared__ uint32_t sh_magic[256];
  __shared__ int sh_cnt[2][kRowBlocks];
  const int64_t row = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const int blk = tid / kWarp;
  const int lane = tid % kWarp;
  for (int i = tid; i < 256; i += kThreads) {
    sh_packed[i] = packed[b * 256 + i];
    sh_magic[i] = magic[b * 256 + i];
  }
  __syncthreads();

  const int64_t gb = row * kRowBlocks + blk;
  const bool live = gb < nb;
  const int64_t size = sizes[b];
  const int64_t blk_base = gb * kBlockBytes;
  const uint8_t* src = sym + (b * nb + (live ? gb : 0)) * kBlockBytes;
  uint16_t* out = kClassic
      ? streams + (b * nb + (live ? gb : 0)) * kBlockWords16
      : streams + (b * nr + row) * kRowWords16;
  const uint32_t check_shift = 31 - prob_bits;
  const unsigned below = (1u << lane) - 1u;

  uint32_t state = 1u << 15;
  int row_count = 0;  // u16 words the row emitted before this step
  int blk_words = 0;  // u16 words this block emitted so far
  for (int s = 0; s < kSteps; ++s) {
    const bool valid = live && blk_base + s * kWarp + lane < size;
    uint32_t t = 0, m = 0;
    if (valid) {
      const uint8_t x = src[s * kWarp + lane];
      t = sh_packed[x];
      m = sh_magic[x];
    }
    const uint32_t pdf = t & 0xFFFu;
    const uint32_t cdf = (t >> 12) & 0x7FFu;
    const uint32_t shift = min(t >> 23, 31u);
    const bool write = valid && state >= (pdf << check_shift);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, write);
    const int cnt = __popc(ballot);
    int slot = 0, total = 0;
    if constexpr (kClassic) {
      slot = blk_words;
    } else {
      if (lane == 0) sh_cnt[s & 1][blk] = cnt;
      __syncthreads();
      for (int w = 0; w < kRowBlocks; ++w) {
        const int c = sh_cnt[s & 1][w];
        total += c;
        if (w < blk) slot += c;
      }
      slot += row_count;
    }
    if (write) {
      slot += __popc(ballot & below);
      if (slot < (kClassic ? kBlockWords16 : kRowWords16)) {
        out[slot] = (uint16_t)(state & 0xFFFFu);
      }
      state >>= 16;
    }
    if (valid) {
      const uint32_t q = (__umulhi(state, m) + state) >> shift;
      const uint32_t mod = state - q * pdf;
      state = (q << prob_bits) + mod + cdf;
    }
    row_count += total;
    blk_words += cnt;
  }

  if (live) {
    states_out[(b * nb + gb) * kWarp + lane] = state;
    if (lane == 0) num_words[b * nb + gb] = blk_words;
  }
  // the merge copies (words + 1) >> 1 u32 words: zero the odd trailing
  // half and the rest of the stream
  if constexpr (kClassic) {
    if (live) {
      for (int i = blk_words + lane; i < kBlockWords16; i += kWarp) out[i] = 0;
    }
  } else {
    for (int i = row_count + tid; i < kRowWords16; i += kThreads) out[i] = 0;
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

// sym: u8[B, nb * 4096]; sizes: i32[B] byte counts; packed, magic: u32[B, 256]
// (pdf | cdf << 12 | shift << 23, and the magic multipliers). Writes
// states u32[B, nb, 32], streams u16[B, nr, 10240] and num_words i32[B, nb].
// Returns cudaGetLastError() after the launch.
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
