// Dense batched 96x96 matvec: z_b = inv_b r_b.
//
// Replaces: precond_tpu/ops/pallas/symv.py, batched_symv (_symv_kernel), the
// apply's dense per-block symv below the packed threshold.
//
// What bounds it on the H100: bytes. 2*96^2 flop per 37,632 bytes of device
// traffic per block (~0.5 flop/byte); the goal is streaming inv at full
// memory rate.
//
// Design: one warp per block. Row i of a block is 96 contiguous floats, so
// the warp reads it as three coalesced 128-byte loads (lane l takes columns
// l, l+32, l+64 against r values it holds in registers), then a butterfly
// of xor-shuffles sums the 32 partial products; every lane ends with the
// same bits, and lane i%32 keeps row i so the 96 results leave as three
// coalesced stores. Eight warps per thread block.
//
// Numbers: f32 loads, fma and shuffle-add in a fixed order, so the result is
// bitwise reproducible; it differs from an einsum only by summation order.
//
// The bf16 entry symv96_bf16 lives in symv_bf16.cu.

#include <cuda_runtime.h>

namespace {

constexpr int D = 96;
constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
symv96_kernel(const float* __restrict__ inv, const float* __restrict__ r,
              float* __restrict__ z, int nb) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= nb) return;  // warp-uniform: the whole warp leaves together
  const float* m = inv + static_cast<size_t>(b) * D * D;
  const float* rb = r + static_cast<size_t>(b) * D;
  const float r0 = rb[lane], r1 = rb[32 + lane], r2 = rb[64 + lane];
  float out[3] = {0.0f, 0.0f, 0.0f};

#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll 8
    for (int ii = 0; ii < 32; ++ii) {
      const float* row = m + (g * 32 + ii) * D;
      float p = row[lane] * r0;
      p = fmaf(row[32 + lane], r1, p);
      p = fmaf(row[64 + lane], r2, p);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == ii) out[g] = p;
    }
  }

  float* zb = z + static_cast<size_t>(b) * D;
  zb[lane] = out[0];
  zb[32 + lane] = out[1];
  zb[64 + lane] = out[2];
}

}  // namespace

extern "C" int symv96(const float* inv, const float* r, float* z, int nb, void* stream) {
  if (nb > 0) {
    symv96_kernel<<<(nb + WARPS - 1) / WARPS, WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(inv, r, z, nb);
  }
  return static_cast<int>(cudaGetLastError());
}
