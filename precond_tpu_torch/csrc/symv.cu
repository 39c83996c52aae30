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
// symv96_bf16: the same product on a bf16 table (SchwarzConfig.inverse_dtype
// "bfloat16"), z_b = inv_b bf16(r_b) with f32 output.
//
// Replaces: the JAX package's dense bf16 apply, an XLA einsum with the rhs
// rounded to the table's dtype and f32 accumulation
// (precond_tpu/ops/batched_inverse.py, apply_block_inverse;
// ops/pallas/packed_symv.py, dense_symv_cm).
//
// What bounds it: bytes, 18,432 of table plus 768 of vectors per block
// against 37,632 in f32.
//
// Design: the f32 kernel's shape, one warp per block and a butterfly per
// row, on spans of two rows: rows 2j and 2j+1 are 96 contiguous bf16 pairs,
// read by the warp as three coalesced 128-byte loads of __nv_bfloat162
// (lane l takes pairs l, 32+l and 64+l). Pair l belongs to row 2j, pair
// 64+l to row 2j+1 and pair 32+l to row 2j for l < 16, else to row 2j+1, so
// each lane sums into two partials and the warp reduces both at once.
//
// Numbers: r is rounded to bf16 (round to nearest even, as JAX's astype) and
// widened again; a product of two bf16 values is exact in f32, so the kernel
// differs from the f32 einsum of the widened operands only in the order of
// its f32 sums, which is fixed (bitwise reproducible).

#include <cuda_bf16.h>
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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(WARPS * 32)
symv96_bf16_kernel(const __nv_bfloat162* __restrict__ inv, const float* __restrict__ r,
                   float* __restrict__ z, int nb) {
  constexpr int PAIRS = D * D / 2;  // bf16 pairs per block
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= nb) return;  // warp-uniform
  const __nv_bfloat162* m = inv + static_cast<size_t>(b) * PAIRS;
  const float* rb = r + static_cast<size_t>(b) * D;
  // the columns of the lane's three pairs in every two-row span
  const bool lo = lane < 16;
  const int c0 = 2 * lane, c1 = lo ? 64 + 2 * lane : 2 * lane - 32, c2 = 32 + 2 * lane;
  const float x0 = bf16_round(rb[c0]), x0b = bf16_round(rb[c0 + 1]);
  const float x1 = bf16_round(rb[c1]), x1b = bf16_round(rb[c1 + 1]);
  const float x2 = bf16_round(rb[c2]), x2b = bf16_round(rb[c2 + 1]);
  float out[3] = {0.0f, 0.0f, 0.0f};

#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll 4
    for (int jj = 0; jj < 16; ++jj) {
      const __nv_bfloat162* span = m + (g * 16 + jj) * D;  // rows 2j, 2j+1: 96 pairs
      const float2 a0 = __bfloat1622float2(span[lane]);
      const float2 a1 = __bfloat1622float2(span[32 + lane]);
      const float2 a2 = __bfloat1622float2(span[64 + lane]);
      float s0 = fmaf(a0.y, x0b, a0.x * x0);
      float s1 = fmaf(a2.y, x2b, a2.x * x2);
      const float p1 = fmaf(a1.y, x1b, a1.x * x1);
      s0 = lo ? s0 + p1 : s0;
      s1 = lo ? s1 : s1 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (lane == 2 * jj) out[g] = s0;
      if (lane == 2 * jj + 1) out[g] = s1;
    }
  }

  float* zb = z + static_cast<size_t>(b) * D;
  zb[lane] = out[0];
  zb[32 + lane] = out[1];
  zb[64 + lane] = out[2];
}

}  // namespace

extern "C" int symv96_bf16(const void* inv, const float* r, float* z, int nb, void* stream) {
  if (nb > 0) {
    symv96_bf16_kernel<<<(nb + WARPS - 1) / WARPS, WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat162*>(inv), r, z, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int symv96(const float* inv, const float* r, float* z, int nb, void* stream) {
  if (nb > 0) {
    symv96_kernel<<<(nb + WARPS - 1) / WARPS, WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(inv, r, z, nb);
  }
  return static_cast<int>(cudaGetLastError());
}
