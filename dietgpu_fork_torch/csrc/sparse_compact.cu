// K10: compaction of float rows by their nonzero bitmap: the kept floats
// move to the front of each member's row, in order, and the rest of the row
// is zero.
//
// Replaces two Pallas kernels of the JAX package's
// ops/pallas/sparse_stream.py and the glue between them: _compact_kernel
// (a rank-select per 8192-float cell into staging), the runs_merge that
// glues the cells (compact_by_bitmap) and, for 16-bit floats,
// _pack_pairs_kernel (pack_u16_pairs). Contract:
// dietgpu_fork_torch/ops/sparse_stream.py::compact_by_bitmap_plain, for
// ranks that are the bitmap's word_ranks (K15, word_ranks.cu).
//
// Bound on the card: device memory, a read of the kept floats and the
// bitmap and a write of the whole output row (kept floats, then zeros), at
// 3.35 TB/s. At half zeros nearly every 32 B sector of the input holds a
// kept float, so the floor is nearer a read of the whole input.
//
// Design: tiles (sparse_tile.cuh), one a CTA, each a read of the tile's
// floats, one pass over shared memory and a write of one contiguous run.
// 1. The tile's floats go into shared memory by cp.async, 16 B a thread and
//    request, all issued before any other work; meanwhile each thread loads
//    one bitmap word (bits of floats at or past s_cap dropped), the CTA
//    scans their popcounts with warp shuffles, and the ranks of the tile's
//    first word (base) and of the row's end (nnz) arrive.
// 2. Each thread takes floats f, f + 128, ...: a kept one goes to its
//    local rank in a shared output buffer, entered at the address that
//    slot base of the output row has mod 16. The tile's kept floats are
//    the output run [base, base + count): with the bitmap's ranks the
//    tiles' runs abut.
// 3. The run goes out with 16 B stores, units at its two ends (u16 for a
//    16-bit float at an odd slot, never a read-modify-write of a u32 that a
//    neighbouring tile's run shares). The CTA then zeroes the slots of its
//    own float range at or past nnz. With the bitmap's ranks every slot
//    below s_cap is so written exactly once, and the output needs no fill
//    beforehand. A slot outside [0, s_cap) is never written, whatever the
//    ranks say.

#include "sparse_tile.cuh"

namespace {

using namespace sparse_tile;

template <int WS>
__global__ void __launch_bounds__(kThreads)
sparse_compact_kernel(const uint32_t* __restrict__ in, int64_t w32,
                      int64_t s_cap, const uint32_t* __restrict__ bm,
                      const int32_t* __restrict__ ranks, int64_t bw,
                      uint32_t* __restrict__ out, int64_t ow) {
  using T = Tile<WS>;
  using U = typename T::U;
  constexpr int KU = T::kUnits;
  __shared__ __align__(16) U sh_in[T::kBuf];
  __shared__ __align__(16) U sh_out[T::kBuf];
  __shared__ uint32_t sh_bits[T::kWords];
  __shared__ int sh_pre[T::kWords];
  __shared__ int sh_scan[kWarps];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t f_lo = (int64_t)blockIdx.x * T::kFloats;
  const int64_t f_hi = f_lo + T::kFloats < s_cap ? f_lo + T::kFloats : s_cap;
  if (f_lo >= f_hi) return;  // uniform across the CTA
  const int nf = (int)(f_hi - f_lo);

  // 1. the tile's floats in flight, then its bitmap words and ranks
  const U* src = reinterpret_cast<const U*>(in + b * w32) + f_lo * KU;
  U* fin = sh_in + phase<U>(reinterpret_cast<uintptr_t>(src));
  copy_in(fin, src, (int64_t)nf * KU);
  const int64_t w_lo = f_lo / 32;
  const int nw = (nf + 31) / 32;
  uint32_t bits = 0;
  if (tid < nw) {
    bits = lsb_first(__ldg(bm + b * bw + w_lo + tid));
    const int64_t rest = f_hi - 32 * (w_lo + tid);  // >= 1
    if (rest < 32) bits &= (1u << rest) - 1u;
  }
  const int32_t* rrow = ranks + b * (bw + 1);
  const int64_t base = __ldg(rrow + w_lo);
  const int64_t nnz = __ldg(rrow + bw);
  int cnt;
  const int pre = block_exclusive_scan(__popc(bits), sh_scan, &cnt);
  if (tid < nw) {
    sh_bits[tid] = bits;
    sh_pre[tid] = pre;
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. each kept float to its local rank; local rank r is slot base + r
  U* orow = reinterpret_cast<U*>(out + b * ow);
  U* fout = sh_out + phase<U>(reinterpret_cast<uintptr_t>(orow) +
                              (uintptr_t)(base * WS));
  for (int f = tid; f < nf; f += kThreads) {
    const uint32_t wb = sh_bits[f >> 5];
    const int l = f & 31;
    if ((wb >> l) & 1u) {
      const int r = sh_pre[f >> 5] + __popc(wb & ((1u << l) - 1u));
#pragma unroll
      for (int k = 0; k < KU; ++k) fout[r * KU + k] = fin[f * KU + k];
    }
  }
  __syncthreads();

  // 3. the run's slots within [0, s_cap), then zeros at or past nnz
  const int64_t s0 = base > 0 ? base : 0;
  const int64_t s1 = base + cnt < s_cap ? base + cnt : s_cap;
  if (s1 > s0) copy_out(orow + s0 * KU, fout + (s0 - base) * KU, (s1 - s0) * KU);
  const int64_t z0 = nnz > f_lo ? nnz : f_lo;
  if (f_hi > z0) fill_zero(orow + z0 * KU, (f_hi - z0) * KU);
}

template <int WS>
int launch(const void* in, long long batch, long long w32, long long s_cap,
           const void* bm, const void* ranks, long long bw, void* out,
           long long ow, void* stream) {
  constexpr long long tf = Tile<WS>::kFloats;
  const long long gx = s_cap > 0 ? (s_cap + tf - 1) / tf : 1;
  dim3 grid((unsigned)gx, (unsigned)batch);
  sparse_compact_kernel<WS><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, w32, s_cap, (const uint32_t*)bm,
      (const int32_t*)ranks, bw, (uint32_t*)out, ow);
  return (int)cudaGetLastError();
}

}  // namespace

// in: u32[B, w32] rows of floats of ws bytes (2, 4 or 8), s_cap <= 4 w32 /
// ws of them; bm: u32[B, bw] MSB-first bitmap words, 32 bw >= s_cap;
// ranks: i32[B, bw + 1], the exclusive scan of the words' popcounts and
// the total; out: u32[B, ow], ow = ceil(s_cap ws / 4). Rows start on 4 B
// boundaries. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another ws.
extern "C" int dgt_sparse_compact(const void* in, long long batch,
                                  long long w32, long long s_cap,
                                  const void* bm, const void* ranks,
                                  long long bw, int ws, void* out,
                                  long long ow, void* stream) {
  switch (ws) {
    case 2: return launch<2>(in, batch, w32, s_cap, bm, ranks, bw, out, ow, stream);
    case 4: return launch<4>(in, batch, w32, s_cap, bm, ranks, bw, out, ow, stream);
    case 8: return launch<8>(in, batch, w32, s_cap, bm, ranks, bw, out, ow, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
