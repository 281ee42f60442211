// K16: the ANS header parse, its format checks, the expected-size check and
// the decode table, for every member of a batch in one launch.
//
// Replaces no Pallas kernel: it takes the place of torch glue that the JAX
// package left to XLA around its decode (models/ans.py:331
// _ans_parse_and_stage's header gathers, format checks and blockWords read,
// and ops/table.py:218 build_decode_table_batched). Contract:
// dietgpu_fork_torch/models/ans.py::ans_parse_plain, which is _ans_parse,
// then _expect_sizes where expect_n is given, then
// build_decode_table_batched.
//
// For member b, whose archive starts at word base[b] of row b of comp
// (u32[B, cw]), it writes every field of ParsedANS and the decode table:
// n, csum, state_off and pdf (i64), success (u8); comp_w and uncomp_w
// (i32[B, nb]) from the blockWords; seg_off and seg_len (i64[B, nseg]), the
// first word and the length of each stream: one a row of 4 blocks (row
// layout) or one a block (classic); lut (u32[B, 2^prob_bits]), each slot
// ((slot - cdf) << 20 | pdf << 8 | sym) for the first symbol whose
// inclusive pdf sum passes the slot, 255 past the sum.
//
// A member fails on a wrong magic or prob_bits; n < 0, total_w < 0 or a
// block count other than ceil(n / 4096); streams reaching past its row; n
// above its capacity; a live block whose count passes the worst case, whose
// uncomp_w is not the header's fill, whose start is negative or whose
// extent passes total_w; in the row layout a row whose 4 blocks together
// pass total_w; with expect_n, a decoded size other than expect_n[b]. Its
// streams, blocks and success are then zero, as the plain version leaves
// them: a parse failure zeroes its streams' starts too, an expect_n failure
// keeps them. The checks are made in 64-bit signed arithmetic on the
// header's int32 readings, as the plain version's are.
//
// Bound on the card: device memory, the header, pdf and blockWords read
// once and the outputs and table written once, at 3.35 TB/s: 8 B read and
// 8 B + 16 B a stream written a block, 2.5 KiB and 4 << prob_bits B a
// member. That is 0.2 us for a 123,456,789-byte plane (30,141 blocks), so
// in practice a few dependent reads and the launch bound it.
//
// Design: one CTA of 1024 threads a member, one launch. Threads 0-135 read
// the header and pdf words into shared memory; every thread then holds the
// header's verdict. The table: an inclusive scan of the 256 pdf values in
// shared memory, then a binary search of each slot over the sums,
// 2^prob_bits / 1024 slots a thread, stored coalesced. The blocks: a step
// takes blocks 4096 j + 1024 u + t (u < 4) for thread t and starts all
// eight of their blockWords loads (a warp reads 256 contiguous bytes a
// block index u) before it checks and writes any of them. A row's 4 blocks
// lie in 4 neighbouring lanes, which sum their counts by shuffles. Outputs
// are written as if the member passes; __syncthreads_and reduces its
// verdict, and a failed member's outputs are written again in a second
// pass by the threads that wrote them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kStep = kThreads * kUnroll;  // blocks a step
constexpr int kHdrWords = 8;
constexpr int kMetaWords = 136;  // header (8) + packed pdf (128)
constexpr int kSyms = 256;
constexpr int64_t kBlockSize = 4096;
// a block's worst case in u16 words: 2 * MAX_BLOCK_WORDS32 (core/constants.py)
constexpr int64_t kMaxBlockWords = 2 * 1280;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct ParseArgs {
  const uint32_t* comp;
  int64_t cw;      // words a row
  int64_t nwords;  // words of comp
  const int64_t* base;
  const int64_t* caps;  // null: out_capacity for every member
  int64_t out_capacity;
  const int64_t* expect_n;  // null: no size check
  uint32_t magic;
  int prob_bits;
  int native;
  int64_t nb;    // blocks of a member's outputs
  int64_t nseg;  // streams of a member's outputs
  int64_t* seg_off;
  int64_t* seg_len;
  int32_t* comp_w;
  int32_t* uncomp_w;
  int64_t* state_off;
  int64_t* pdf;
  uint8_t* success;
  int64_t* n;
  int64_t* csum;
  uint32_t* lut;
};

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The int32 reading of a u32 word, in 64 bits.
__device__ __forceinline__ int64_t as_i32(uint32_t w) {
  return (int64_t)(int32_t)w;
}

// The word after a member's blockWords: 4 B aligned pairs, padded to an
// even block count (models/ans.py::_layout).
__device__ __forceinline__ int64_t data_words(int64_t nb) {
  return kMetaWords + 32 * nb + 4 * ((nb + 1) / 2);
}

__global__ void __launch_bounds__(kThreads) ans_parse_kernel(const ParseArgs a) {
  __shared__ uint32_t sh_hdr[kHdrWords];
  __shared__ uint32_t sh_pdf[kSyms];
  __shared__ uint32_t sh_cum[kSyms];  // inclusive sums of sh_pdf
  __shared__ uint32_t sh_warp[kSyms / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t b = blockIdx.x;
  const int64_t base = a.base[b];
  const uint32_t* row = a.comp + b * a.cw;

  // header and pdf, read clamped into the member's row
  if (tid < kMetaWords) {
    const uint32_t w = __ldg(row + clamp64(base + tid, 0, a.cw - 1));
    if (tid < kHdrWords) {
      sh_hdr[tid] = w;
    } else {
      const int k = 2 * (tid - kHdrWords);
      sh_pdf[k] = w & 0xFFFFu;
      sh_pdf[k + 1] = w >> 16;
      a.pdf[b * kSyms + k] = w & 0xFFFFu;
      a.pdf[b * kSyms + k + 1] = w >> 16;
    }
  }
  __syncthreads();
  if (tid < kSyms) {  // warps 0-7 whole
    uint32_t x = sh_pdf[tid];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) sh_warp[tid >> 5] = x;
    sh_cum[tid] = x;
  }
  __syncthreads();
  if (tid < kSyms) {
    uint32_t pre = 0;
    for (int w = 0; w < (tid >> 5); ++w) pre += sh_warp[w];
    sh_cum[tid] += pre;
  }
  __syncthreads();

  // the decode table: the first symbol whose inclusive sum passes the slot
  const int slots = 1 << a.prob_bits;
  uint32_t* lrow = a.lut + b * (int64_t)slots;
  for (int s = tid; s < slots; s += kThreads) {
    int lo = 0, hi = kSyms;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sh_cum[mid] > (uint32_t)s) hi = mid; else lo = mid + 1;
    }
    const int sym = lo < kSyms ? lo : kSyms - 1;
    const uint32_t p = sh_pdf[sym];
    const uint32_t within = (uint32_t)s - (sh_cum[sym] - p);
    lrow[s] = (within << 20) | (p << 8) | (uint32_t)sym;
  }

  // the header's verdict
  int64_t nb_arch = as_i32(sh_hdr[1]);
  int64_t n = as_i32(sh_hdr[2]);
  const int64_t total_w = as_i32(sh_hdr[3]);
  const bool struct_ok = n >= 0 && total_w >= 0 &&
                         nb_arch == (n + kBlockSize - 1) / kBlockSize;
  const bool fits = base + data_words(clamp64(nb_arch, 0, 1 << 24)) +
                        ((total_w + 1) >> 1) <= a.cw;
  const bool valid = sh_hdr[0] == a.magic &&
                     (int)(sh_hdr[4] & 0xFu) == a.prob_bits && struct_ok && fits;
  if (!valid) {
    n = 0;
    nb_arch = 0;
  }
  const bool head_ok = valid && n <= (a.caps ? a.caps[b] : a.out_capacity);
  const int64_t nb_live = head_ok ? (nb_arch < a.nb ? nb_arch : a.nb) : 0;
  const int64_t abs_base = b * a.cw + base;
  const int64_t bw_at = abs_base + kMetaWords + 32 * nb_arch;
  const int64_t data_at = abs_base + data_words(nb_arch);
  int32_t* cw_row = a.comp_w + b * a.nb;
  int32_t* uw_row = a.uncomp_w + b * a.nb;
  int64_t* so_row = a.seg_off + b * a.nseg;
  int64_t* sl_row = a.seg_len + b * a.nseg;

  // the blocks, written as if the member passes
  int ok = 1;
  for (int64_t k0 = 0; k0 < a.nb; k0 += kStep) {
    uint32_t bx[kUnroll], by[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t k = k0 + u * kThreads + tid;
      bx[u] = by[u] = 0;
      if (k < nb_live) {
        bx[u] = __ldg(a.comp + clamp64(bw_at + 2 * k, 0, a.nwords - 1));
        by[u] = __ldg(a.comp + clamp64(bw_at + 2 * k + 1, 0, a.nwords - 1));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t k = k0 + u * kThreads + tid;
      const bool live = k < nb_live;
      const int cnt = (int)(bx[u] & 0xFFFFu);
      const int fill = (int)(bx[u] >> 16);
      const int64_t start = live ? as_i32(by[u]) : 0;
      if (live) {
        ok &= cnt <= kMaxBlockWords &&
              fill == clamp64(n - k * kBlockSize, 0, kBlockSize) &&
              start >= 0 && start + cnt <= total_w;
      }
      if (k < a.nb) {
        cw_row[k] = cnt;
        uw_row[k] = fill;
      }
      if (a.native) {
        // a row's stream: its first block's start, its 4 blocks' counts
        int row_cnt = cnt;
        row_cnt += __shfl_xor_sync(kFull, row_cnt, 1);
        row_cnt += __shfl_xor_sync(kFull, row_cnt, 2);
        if ((tid & 3) == 0 && k < a.nb) {
          if (live) ok &= start + row_cnt <= total_w;
          so_row[k >> 2] = data_at + (start >> 1);
          sl_row[k >> 2] = (row_cnt + 1) >> 1;
        }
      } else if (k < a.nb) {
        so_row[k] = data_at + (start >> 1);
        sl_row[k] = (cnt + 1) >> 1;
      }
    }
  }
  const bool parse_ok = __syncthreads_and(ok) && head_ok;
  const bool size_ok = a.expect_n == nullptr || n == a.expect_n[b];

  if (!(parse_ok && size_ok)) {
    // the second pass: no blocks, no streams; a parse failure also moves
    // each stream's first word to the data's start
    for (int64_t k = tid; k < a.nb; k += kThreads) {
      cw_row[k] = 0;
      uw_row[k] = 0;
      if (!a.native || (tid & 3) == 0) {
        const int64_t s = a.native ? k >> 2 : k;
        if (!parse_ok) so_row[s] = data_at;
        sl_row[s] = 0;
      }
    }
  }
  if (tid == 0) {
    a.success[b] = parse_ok && size_ok;
    a.n[b] = n;
    a.csum[b] = sh_hdr[5];
    a.state_off[b] = abs_base + kMetaWords;
  }
}

}  // namespace

// comp: u32[batch, cw] archive rows (cw >= 1); base: i64[batch], each
// member's first word in its row; caps: i64[batch] capacities in decoded
// bytes, or null for out_capacity each; expect_n: i64[batch] or null;
// prob_bits 9-11; native: the row layout (0xDB0D) else classic (0xD00D); nb
// >= 1: blocks of a member's outputs. Outputs: seg_off, seg_len
// i64[batch, nseg] (nseg = ceil(nb / 4) native, else nb); comp_w, uncomp_w
// i32[batch, nb]; state_off, n, csum i64[batch]; pdf i64[batch, 256];
// success u8[batch]; lut u32[batch, 2^prob_bits]. Returns
// cudaErrorInvalidValue for arguments out of range, else cudaGetLastError()
// after the launch.
extern "C" int dgt_ans_parse(const void* comp, long long batch, long long cw,
                             const void* base, const void* caps,
                             long long out_capacity, const void* expect_n,
                             int prob_bits, int native, long long nb,
                             void* seg_off, void* seg_len, void* comp_w,
                             void* uncomp_w, void* state_off, void* pdf,
                             void* success, void* n, void* csum, void* lut,
                             void* stream) {
  if (batch < 1 || batch > 0x7FFFFFFFLL || cw < 1 || nb < 1 ||
      prob_bits < 9 || prob_bits > 11) {
    return (int)cudaErrorInvalidValue;
  }
  ParseArgs a;
  a.comp = (const uint32_t*)comp;
  a.cw = cw;
  a.nwords = batch * cw;
  a.base = (const int64_t*)base;
  a.caps = (const int64_t*)caps;
  a.out_capacity = out_capacity;
  a.expect_n = (const int64_t*)expect_n;
  a.magic = native ? 0xDB0D0001u : 0xD00D0001u;
  a.prob_bits = prob_bits;
  a.native = native;
  a.nb = nb;
  a.nseg = native ? (nb + 3) / 4 : nb;
  a.seg_off = (int64_t*)seg_off;
  a.seg_len = (int64_t*)seg_len;
  a.comp_w = (int32_t*)comp_w;
  a.uncomp_w = (int32_t*)uncomp_w;
  a.state_off = (int64_t*)state_off;
  a.pdf = (int64_t*)pdf;
  a.success = (uint8_t*)success;
  a.n = (int64_t*)n;
  a.csum = (int64_t*)csum;
  a.lut = (uint32_t*)lut;
  ans_parse_kernel<<<(unsigned)batch, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
