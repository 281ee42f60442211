// K11: expansion of a member's nonzero floats by its bitmap, with the tail
// past its float count zeroed:
//
//   out[f] = (f < n[b] and bit f) ? nz[rank(f)] : 0
//
// Replaces the JAX package's ops/pallas/sparse_stream.py::_expand_kernel
// (expand_by_bitmap) and the ops/checksum.py::mask_packed_bytes that
// models/sparse.py runs after it. Contract:
// dietgpu_fork_torch/ops/sparse_stream.py::expand_by_bitmap_plain, for
// ranks that are the bitmap's word_ranks (K15, word_ranks.cu). A rank is
// clamped into the member's nonzero row: a corrupt archive may set more
// bits than its dense part decoded, and such a float reads the row's last
// float; no read leaves the row.
//
// Bound on the card: device memory, a read of the nonzero floats and the
// bitmap and a write of the whole output row, at 3.35 TB/s.
//
// Design: tiles of output floats (sparse_tile.cuh), one a CTA.
// 1. The tile's nonzeros are one contiguous run of the nonzero row, ranks
//    [ranks[w_lo], ranks[w_hi]) of its first word and of the word after
//    its last, each clamped into the row. Those two loads are all the copy
//    waits for: the run goes into shared memory by cp.async, 16 B a thread
//    and request, entered at its own address mod 16, while each thread
//    loads one bitmap word (bits at or past lim = clamp(n[b], 0, slots)
//    dropped) and the CTA scans their popcounts with warp shuffles.
// 2. Each thread then builds 16 B of contiguous output floats at a time
//    (the tile's first and last partial chunks one float a thread): a
//    float whose bit is set reads its value from the staged run at its
//    local rank, every other float is 0. Every output float is written, so
//    the output needs no fill beforehand; a failed member, which the caller
//    gives n = 0, comes out all zero.

#include "sparse_tile.cuh"

namespace {

using namespace sparse_tile;

// Floats fl .. fl + N - 1 of a tile into v, KU words each: 0 where the
// bit is clear, else the staged nonzero at the float's local rank r (the
// tile's set bits before it), staged index clamp(r - d, 0, last). The rank
// is counted on from the first float, with the next word's bits loaded
// where the floats cross into it.
template <int KU, int N, typename U>
__device__ __forceinline__ void gather(int fl, const uint32_t* bits,
                                       const int* pre, const U* run, int d,
                                       int last, uint32_t (&v)[N * KU]) {
  uint32_t wb = bits[fl >> 5];
  int l = fl & 31;
  int r = pre[fl >> 5] + __popc(wb & ((1u << l) - 1u));
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j > 0 && l == 0) wb = bits[(fl + j) >> 5];
    const uint32_t bit = (wb >> l) & 1u;
    int i = r - d;
    i = i < 0 ? 0 : (i > last ? last : i);
#pragma unroll
    for (int k = 0; k < KU; ++k) v[j * KU + k] = bit ? (uint32_t)run[i * KU + k] : 0u;
    r += (int)bit;
    l = (l + 1) & 31;
  }
}

template <int WS>
__global__ void __launch_bounds__(kThreads)
sparse_expand_kernel(const uint32_t* __restrict__ nz, int64_t nzw,
                     int64_t nz_cap, const uint32_t* __restrict__ bm,
                     const int32_t* __restrict__ ranks, int64_t bw,
                     const int32_t* __restrict__ n, int64_t slots,
                     uint32_t* __restrict__ out, int64_t ow) {
  using T = Tile<WS>;
  using U = typename T::U;
  constexpr int KU = T::kUnits;
  __shared__ __align__(16) U sh_nz[T::kBuf];
  __shared__ uint32_t sh_bits[T::kWords];
  __shared__ int sh_pre[T::kWords];
  __shared__ int sh_scan[kWarps];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t f_lo = (int64_t)blockIdx.x * T::kFloats;
  const int64_t f_hi = f_lo + T::kFloats < slots ? f_lo + T::kFloats : slots;
  if (f_lo >= f_hi) return;  // uniform across the CTA
  const int nf = (int)(f_hi - f_lo);
  const int64_t w_lo = f_lo / 32;
  const int nw = (nf + 31) / 32;

  // 1. the run of nonzeros [c_lo, c_lo + len) in flight (at least one
  // float, so a lookup always lands in it), then the bitmap words
  const int32_t* rrow = ranks + b * (bw + 1);
  const int64_t base = __ldg(rrow + w_lo);
  const int64_t end = __ldg(rrow + w_lo + nw);
  const int64_t c_lo = base < 0 ? 0 : (base >= nz_cap ? nz_cap - 1 : base);
  int64_t c_hi = end - 1 < 0 ? 0 : (end - 1 >= nz_cap ? nz_cap - 1 : end - 1);
  if (c_hi < c_lo) c_hi = c_lo;
  if (c_hi - c_lo >= T::kFloats) c_hi = c_lo + T::kFloats - 1;
  const int64_t len = c_hi - c_lo + 1;
  const U* src = reinterpret_cast<const U*>(nz + b * nzw) + c_lo * KU;
  U* run = sh_nz + phase<U>(reinterpret_cast<uintptr_t>(src));
  copy_in(run, src, len * KU);
  int64_t lim = n[b];
  lim = lim < 0 ? 0 : (lim > slots ? slots : lim);
  uint32_t bits = 0;
  if (tid < nw) {
    const int64_t w = w_lo + tid;
    const int64_t rest = lim - 32 * w;
    if (rest > 0) {
      bits = lsb_first(__ldg(bm + b * bw + w));
      if (rest < 32) bits &= (1u << rest) - 1u;
    }
  }
  int total;  // not needed: the staged run was sized from the ranks
  const int pre = block_exclusive_scan(__popc(bits), sh_scan, &total);
  if (tid < nw) {
    sh_bits[tid] = bits;
    sh_pre[tid] = pre;
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. the output floats, 16 B a thread at a time. Local rank r is slot
  // base + r of the row, clamped into [0, nz_cap) and then into the staged
  // run: staged index clamp(r - d, 0, len - 1) with d = c_lo - base, which
  // a tile's ranks (0 .. kFloats) reach only within 2 kFloats of 0.
  constexpr int V = 16 / WS;  // floats a 16 B chunk
  constexpr int64_t kFar = 2 * T::kFloats;
  const int64_t d64 = c_lo - base;
  const int d = (int)(d64 < -kFar ? -kFar : (d64 > kFar ? kFar : d64));
  const int last = (int)len - 1;
  U* dst = reinterpret_cast<U*>(out + b * ow) + f_lo * KU;
  int64_t head, nq;
  split_span<U>(dst, nf * KU, head, nq);  // in units; rows are WS aligned
  head /= KU;
  for (int64_t q = tid; q < nq; q += kThreads) {
    const int fl = (int)(head + q * V);
    uint32_t v[V * KU];
    gather<KU, V>(fl, sh_bits, sh_pre, run, d, last, v);
    uint4 w;
    if constexpr (WS == 2) {  // two 16-bit floats a word, the first low
      w = make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                     v[4] | (v[5] << 16), v[6] | (v[7] << 16));
    } else {
      w = make_uint4(v[0], v[1], v[2], v[3]);
    }
    *reinterpret_cast<uint4*>(dst + (int64_t)fl * KU) = w;
  }
  const int64_t tail0 = head + nq * V;
  for (int64_t k = tid; k < head + nf - tail0; k += kThreads) {
    const int fl = (int)edge_unit(k, head, tail0);
    uint32_t v[KU];
    gather<KU, 1>(fl, sh_bits, sh_pre, run, d, last, v);
#pragma unroll
    for (int j = 0; j < KU; ++j) dst[(int64_t)fl * KU + j] = (U)v[j];
  }
}

template <int WS>
int launch(const void* nz, long long batch, long long nzw, long long nz_cap,
           const void* bm, const void* ranks, long long bw, const void* n,
           long long slots, void* out, long long ow, void* stream) {
  constexpr long long tf = Tile<WS>::kFloats;
  const long long gx = slots > 0 ? (slots + tf - 1) / tf : 1;
  dim3 grid((unsigned)gx, (unsigned)batch);
  sparse_expand_kernel<WS><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)nz, nzw, nz_cap, (const uint32_t*)bm,
      (const int32_t*)ranks, bw, (const int32_t*)n, slots, (uint32_t*)out, ow);
  return (int)cudaGetLastError();
}

}  // namespace

// nz: u32[B, nzw] rows of nonzero floats of ws bytes (2, 4 or 8), nz_cap
// >= 1 of them; bm: u32[B, bw] MSB-first bitmap words; ranks: i32[B, bw +
// 1]; n: i32[B] float counts; out: u32[B, ow] holding slots = 4 ow / ws <=
// 32 bw floats, every one written, its rows on ws byte boundaries. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another ws or a misaligned out.
extern "C" int dgt_sparse_expand(const void* nz, long long batch,
                                 long long nzw, long long nz_cap,
                                 const void* bm, const void* ranks,
                                 long long bw, const void* n, int ws,
                                 void* out, long long ow, void* stream) {
  if (ws != 2 && ws != 4 && ws != 8) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out % ws || (4 * ow) % ws) return (int)cudaErrorInvalidValue;
  const long long slots = 4 * ow / ws;
  switch (ws) {
    case 2: return launch<2>(nz, batch, nzw, nz_cap, bm, ranks, bw, n, slots, out, ow, stream);
    case 4: return launch<4>(nz, batch, nzw, nz_cap, bm, ranks, bw, n, slots, out, ow, stream);
    case 8: return launch<8>(nz, batch, nzw, nz_cap, bm, ranks, bw, n, slots, out, ow, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
