// K9: the sparse codec's nonzero bitmap, packed MSB first per byte and
// masked at each member's float count, in one read of the floats.
//
// Replaces three Pallas kernels of the JAX package's
// ops/pallas/bitmap_pack.py: _pack16_kernel, _pack32_kernel and
// _pack64_kernel (pack_bitmap16/32/64_tpu), with the tail mask that
// models/sparse.py:224-232 applies after them. Contract:
// dietgpu_fork_torch/ops/bitmap_pack.py::pack_bitmap_plain.
//
// One warp per bitmap word w of member b: lane l tests float 32w + l
// (an integer compare, so -0.0 is nonzero; an fp64 float is nonzero when
// either u32 half is), false at or past n[b]. __ballot_sync gives the word
// LSB first; __brev reverses it whole, and __byte_perm(.., 0x0123) puts the
// bytes back in order, so float 8k + j lands on bit 8k + 7 - j, the
// archive's order. Words past the member's floats come out 0, up to the
// row width bw the caller sizes for the bitmap section. The TPU's lane
// rolls and slab gathers have no counterpart: the ballot is the fold.
//
// Bound on the card: device memory, one read of the floats below n (2, 4
// or 8 B each) and a write of 1/16 to 1/64 of that, at 3.35 TB/s. A warp
// reads 64-256 contiguous bytes per word; lane 0 writes the word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int WS>
__global__ void __launch_bounds__(kThreads)
bitmap_pack_kernel(const uint32_t* __restrict__ in, int64_t w32, int64_t s_cap,
                   const int32_t* __restrict__ n, int64_t bw,
                   uint32_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= bw) return;  // uniform across the warp
  int64_t lim = n[b];
  lim = lim < 0 ? 0 : (lim > s_cap ? s_cap : lim);
  const int64_t f = 32 * w + lane;
  const uint32_t* row = in + b * w32;
  bool nz = false;
  if (f < lim) {
    if constexpr (WS == 2) {
      nz = reinterpret_cast<const uint16_t*>(row)[f] != 0;
    } else if constexpr (WS == 4) {
      nz = row[f] != 0;
    } else {
      nz = (row[2 * f] | row[2 * f + 1]) != 0;
    }
  }
  const uint32_t m = __ballot_sync(0xFFFFFFFFu, nz);
  if (lane == 0) out[b * bw + w] = __byte_perm(__brev(m), 0, 0x0123);
}

template <int WS>
int launch(const void* in, long long batch, long long w32, long long s_cap,
           const void* n, long long bw, void* out, void* stream) {
  const long long gx = bw > 0 ? (bw + kWarps - 1) / kWarps : 1;
  dim3 grid((unsigned)gx, (unsigned)batch);
  bitmap_pack_kernel<WS><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, w32, s_cap, (const int32_t*)n, bw, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// in: u32[B, w32] rows of floats of ws bytes (2, 4 or 8), s_cap <= 4 w32 /
// ws of them; n: i32[B]; out: u32[B, bw], every word written.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another ws.
extern "C" int dgt_bitmap_pack(const void* in, long long batch, long long w32,
                               long long s_cap, const void* n, long long bw,
                               int ws, void* out, void* stream) {
  switch (ws) {
    case 2: return launch<2>(in, batch, w32, s_cap, n, bw, out, stream);
    case 4: return launch<4>(in, batch, w32, s_cap, n, bw, out, stream);
    case 8: return launch<8>(in, batch, w32, s_cap, n, bw, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
