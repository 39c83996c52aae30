// Batched 96x96 SPD inverse: panel-32 blocked LDL^T, the blockwise inverse
// W = L^-1, and the Gram product A^-1 = Wh^T Wh with Wh = D^-1/2 W, with the
// non-finite repair fused into the epilogue.
//
// Replaces: precond_tpu/ops/pallas/chol_inverse.py, both
//   invert_spd_blocks_chol_panel (_panel_kernel, panel-32 blocked LDL^T) and
//   invert_spd_blocks_chol (_make_kernel, unblocked 96-pivot LDL^T), and the
//   repair pass the JAX solver runs after them (invert_spd_blocks_panel,
//   repair=True). Same algorithm as the plain version
//   ops/batched_inverse.invert_spd_blocks_panel followed by _repair_nonfinite.
//
// What bounds it on the H100. An SPD inverse needs ~96^3 flop per block
// against 2 x 36,864 bytes of device traffic: 12 flop/byte, below the f32
// ridge (67 TFLOP/s over 3.35 TB/s = 20), so the floor is the bytes bound.
// The earlier kernel of this file sat ~15x above it, held by shared memory:
// 96 dependent pivot steps of a rank-1 update, each FMA paying a shared load,
// a broadcast load and a shared store, and a Gram that read two operands per
// FMA; per matrix 1.32 M FMAs at ~70k shared-memory wavefronts (13,680 warp
// FMAs x 3 for the elimination, 28.8k for the Gram) and two block barriers
// per pivot. This design, per matrix:
//   - 24 products of 32x32 tiles over a depth of 32 (two for Y and three for
//     the trailing update of panel 0, one and one for panel 1, seven for the
//     blockwise inverse, ten for the half Gram): 786k FMAs. Each thread holds
//     a 4x4 register tile; per step of the depth a warp issues 16 FMAs per
//     thread against two 16-byte shared loads (one row of X broadcast to 8
//     lanes, one 128-byte row of Z): ~3.1k wavefronts;
//   - three 32-step panel factors inside one warp, columns in registers, the
//     multipliers by shuffle: 1,488 warp FMAs, 1,584 shuffles, ~0.3k
//     wavefronts of row traffic;
//   - loads, stores, row scaling and the Gram's parked tiles: ~1.4k
//     wavefronts;
//   - 20 block barriers in all, none inside a pivot loop.
// ~0.84 M FMAs and ~5k wavefronts per matrix. What bounds it now is latency:
// each panel factor is a chain of 32 dependent steps in one warp while the
// block's other three warps wait, the one-tile phases leave one slot idle,
// and the other blocks on the SM (five fit) cover only part of it. Measured
// on an H100 80GB HBM3 at 700 W (PERF.md, chip_smoke.py): ~2.75 ms at
// B = 34,952 against the 0.77 ms bytes bound.
//
// Why no tensor cores: TF32 keeps ~3 decimal digits and the blocks reach
// cond ~1e7; the factor and Gram products must stay full f32 (ROADMAP Queue C
// item 2), and the card has no f32 tensor-core product.
//
// Design: one thread block (128 threads = two 64-thread slots) owns one
// matrix, staged by cp.async in 16-byte pieces into shared memory with a
// padded row stride of 100 floats (the panel factor's lanes write rows of
// W^T side by side, and hit distinct banks). Each slot computes one 32x32
// output tile C[m][n] = sum_k X[k][m] Z[k][n] at a time, X and Z row-major
// tiles in shared memory, so transposes are kept in storage, not in the
// loops: the factor writes W1 = L11^-1 both row-major and transposed, Y and
// L21 = Y D^-1 are kept as Y^T and L21^T. The trailing block's upper tiles
// are updated, so the next panel's R^T is read off them; every scratch
// operand lives in a tile of the matrix that is no longer read (the kernel
// lists the roles). The output tiles of a phase are disjoint from its
// operands, or are written after a barrier. Shared memory: the matrix
// (38,400 B), 1/d and 1/sqrt(d) (768 B) = 39,168 B; five blocks per SM at
// <= 96 registers.
//
// Gram: only the six tiles (p,q), p <= q, are computed, tile(p,q) = sum over
// r >= q of Wh[r,p]^T Wh[r,q] (Wh is block-lower), and written at (p,q) and
// transposed at (q,p) (128-byte rows, and 64-byte pieces of rows for the
// transposed copy); 10 tile products instead of 27. In a diagonal tile the
// entries (a,b) and (b,a) are accumulated by fmaf over the same depth in the
// same order, and fmaf is commutative in its factors, so the whole output
// is bitwise symmetric by construction.
//
// Repair: every thread tests the values it holds; __syncthreads_or combines
// the tests; if any is non-finite and `repair` is set the block writes the
// identity instead. Nothing runs after the kernel.
//
// Numbers: f32 storage, f32 fmaf accumulation, no atomics, a fixed order of
// every sum: the output is deterministic bit for bit. No pivoting: the blocks
// are SPD (assembly identity-fills empty diagonals).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 96;
constexpr int NN = N * N;
constexpr int P = 32;          // panel width, and the side of every tile
constexpr int LDA = 100;       // padded row stride of the staged matrix
constexpr int THREADS = 128;   // two slots of 64 threads, one output tile each
constexpr int SMEM_FLOATS = N * LDA + 2 * N;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);   // 39,168

// a row-major 32x32 tile in shared memory
struct Op {
  float* p;
  int ld;
};

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// acc[i][j] += sum_{k<32} X[k][4tm+i] * Z[k][4tn+j], k ascending
__device__ __forceinline__ void mma32(float (&acc)[4][4], Op x, Op z, int tm, int tn) {
  const float* xp = x.p + 4 * tm;
  const float* zp = z.p + 4 * tn;
#pragma unroll 2
  for (int k = 0; k < P; ++k) {
    const float4 xv = *reinterpret_cast<const float4*>(xp + k * x.ld);
    const float4 zv = *reinterpret_cast<const float4*>(zp + k * z.ld);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const float zs[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], zs[j], acc[i][j]);
  }
}

// d[4tm+i][4tn+j] = (ACCUM ? d[..] : 0) + alpha * acc[i][j] * (rs ? rs[4tm+i] : 1)
template <bool ACCUM>
__device__ __forceinline__ void put(Op d, const float (&acc)[4][4], int tm, int tn, float alpha,
                                    const float* rs = nullptr) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4* dp = reinterpret_cast<float4*>(d.p + (4 * tm + i) * d.ld + 4 * tn);
    const float s = rs ? alpha * rs[4 * tm + i] : alpha;
    float4 v = make_float4(s * acc[i][0], s * acc[i][1], s * acc[i][2], s * acc[i][3]);
    if (ACCUM) {
      const float4 o = *dp;
      v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
    }
    *dp = v;
  }
}

// One warp: in-place LDL^T of the 32x32 diagonal tile t (row stride LDA),
// lane k holding column k in registers. At pivot j every row i > j loses
// c_i = M[j][i] * (1 / d_j) times row j: the multiplier is read off the
// pivot row and scaled by the pivot's reciprocal, as the Pallas kernel does
// (chol_inverse.py:128); an IEEE division would take its slow path on the
// exact zeros the assembled blocks are full of. M[j][i] is register j of
// lane i, so each c_i is one shuffle, and lane k applies all of them to its
// own column: M[i][k] -= c_i M[j][k] for i > j (the rows below the pivot
// only, 496 updates a panel). The same row operation on an augmented
// identity builds W = L^-1 in the columns the elimination has cleared:
// column k holds W for k < j and the trailing matrix for k > j, and lane j
// turns its column into W[i][j] = 0 - c_i * W[j][j]. The kernel inlines this
// function once, in a rolled loop over the panels, so its unrolled pivot
// loop exists once. Writes W (unit lower) row-major over t, W^T to wt, 1/d
// to dinv[k] and 1/sqrt(d) to dsc[k].
__device__ __forceinline__ void factor32(float* t, Op wt, float* dinv, float* dsc, int lane) {
  float r[P];
#pragma unroll
  for (int i = 0; i < P; ++i) r[i] = t[i * LDA + lane];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float rinv = 1.0f / __shfl_sync(0xffffffffu, r[j], j);
    const float mjk = lane == j ? 1.0f : r[j];
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      const float c = __shfl_sync(0xffffffffu, r[j], i) * rinv;
      r[i] = fmaf(-c, mjk, lane == j ? 0.0f : r[i]);
    }
  }
  float dk = 0.0f;
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    float w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * q + u;
      if (i == lane) dk = r[i];
      w[u] = i > lane ? r[i] : (i == lane ? 1.0f : 0.0f);
      t[i * LDA + lane] = w[u];
    }
    *reinterpret_cast<float4*>(wt.p + lane * wt.ld + 4 * q) = make_float4(w[0], w[1], w[2], w[3]);
  }
  dinv[lane] = 1.0f / dk;
  dsc[lane] = 1.0f / sqrtf(dk);
}

// Gram tile (p,q) of one thread to the output: at (p,q), and transposed at
// (q,p) off the diagonal; the identity's values instead when `ident`
__device__ __forceinline__ void emit(float* dst, const float (&g)[4][4], int p, int q, int tm,
                                     int tn, bool ident) {
  const int m0 = P * p + 4 * tm, n0 = P * q + 4 * tn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = ident ? (m0 + i == n0 + j ? 1.0f : 0.0f) : g[i][j];
    *reinterpret_cast<float4*>(dst + (m0 + i) * N + n0) = make_float4(v[0], v[1], v[2], v[3]);
  }
  if (p == q) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = ident ? 0.0f : g[i][j];
    *reinterpret_cast<float4*>(dst + (n0 + j) * N + m0) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ bool any_nonfinite(const float (&g)[4][4]) {
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) bad |= !isfinite(g[i][j]);
  return bad;
}

// five blocks fit an SM's shared memory (5 x 39,168 B of 227 KB) and its
// registers (5 x 128 threads x 96)
__global__ void __launch_bounds__(THREADS, 5)
spd_inverse96_kernel(const float* __restrict__ a, float* __restrict__ out, int repair) {
  extern __shared__ __align__(16) float sm[];
  float* A = sm;                      // [96][LDA] the matrix, then W, then Wh
  float* dinv = sm + N * LDA;         // [96] 1/d
  float* dsc = dinv + N;              // [96] 1/sqrt(d)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = tid >> 6;
  const int tm = (tid & 63) >> 3;
  const int tn = tid & 7;
  auto T = [&](int r, int c) { return Op{A + P * r * LDA + P * c, LDA}; };

  // ---- stage the matrix: 2,304 pieces of 16 bytes
  const float* src = a + static_cast<size_t>(blockIdx.x) * NN;
  for (int e = tid; e < NN / 4; e += THREADS) {
    const int rw = e / (N / 4), c4 = e - rw * (N / 4);
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(A + rw * LDA + 4 * c4));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src + 4 * e));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Tile roles (S the matrix, R^T the upper strip right of a panel):
  //   panel 0: W0 -> (0,0), W0^T -> (2,1) (the lower copy of (1,2), never
  //            read), Y^T over R^T in (0,1) (0,2), L^T = D^-1 Y^T over R in
  //            (1,0) (2,0); trailing (1,1) (1,2) (2,2) -= L Y^T
  //   panel 1: W1 -> (1,1), W1^T -> (0,2), Y^T over (1,2), L21^T -> (0,1);
  //            trailing (2,2) -= L21 Y^T
  //   panel 2: W2 -> (2,2), W2^T -> (1,2)
  float acc[4][4], acc2[4][4];
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    if (warp == 0)
      factor32(T(p, p).p, p == 0 ? T(2, 1) : (p == 1 ? T(0, 2) : T(1, 2)), dinv + P * p,
               dsc + P * p, lane);
    __syncthreads();
    if (p == 0) {
      // Y^T = W0 R^T, one tile per slot, in place; L^T beside it
      zero(acc);
      mma32(acc, T(2, 1), T(0, 1 + slot), tm, tn);
      __syncthreads();
      put<false>(T(0, 1 + slot), acc, tm, tn, 1.0f);
      put<false>(T(1 + slot, 0), acc, tm, tn, 1.0f, dinv);
      __syncthreads();
      // S(r,s) -= L(r) Y(s)^T: (1,1) and (2,2) on slot 0, (1,2) on slot 1
      for (int j = slot; j < 3; j += 2) {
        const int r = 1 + (j >> 1), s = 1 + ((j + 1) >> 1);
        zero(acc);
        mma32(acc, T(r, 0), T(0, s), tm, tn);
        put<true>(T(r, s), acc, tm, tn, -1.0f);
      }
    } else if (p == 1) {
      if (slot == 0) {
        zero(acc);
        mma32(acc, T(0, 2), T(1, 2), tm, tn);
      }
      __syncthreads();
      if (slot == 0) {
        put<false>(T(1, 2), acc, tm, tn, 1.0f);               // Y^T
        put<false>(T(0, 1), acc, tm, tn, 1.0f, dinv + P);     // L21^T
      }
      __syncthreads();
      if (slot == 0) {
        zero(acc);
        mma32(acc, T(0, 1), T(1, 2), tm, tn);
        put<true>(T(2, 2), acc, tm, tn, -1.0f);
      }
    }
    __syncthreads();
  }

  // ---- W = L^-1 blockwise (lower_inverse_blocks), into the lower tiles
  // T1 = L10 W0 and T3 = L20 W0 in place over L^T (slot 0); T2 = L21 W1 -> (2,1)
  zero(acc);
  zero(acc2);
  if (slot == 0) {
    mma32(acc, T(1, 0), T(0, 0), tm, tn);
    mma32(acc2, T(2, 0), T(0, 0), tm, tn);
  } else {
    mma32(acc, T(0, 1), T(1, 1), tm, tn);
  }
  __syncthreads();
  if (slot == 0) {
    put<false>(T(1, 0), acc, tm, tn, 1.0f);
    put<false>(T(2, 0), acc2, tm, tn, 1.0f);
  } else {
    put<false>(T(2, 1), acc, tm, tn, 1.0f);
  }
  __syncthreads();
  // W10 = -W1 T1 (slot 0), W21 = -W2 T2 (slot 1), in place
  zero(acc);
  if (slot == 0) mma32(acc, T(0, 2), T(1, 0), tm, tn);
  else mma32(acc, T(1, 2), T(2, 1), tm, tn);
  __syncthreads();
  put<false>(slot == 0 ? T(1, 0) : T(2, 1), acc, tm, tn, -1.0f);
  __syncthreads();
  // T3 += L21 W10, then W20 = -W2 T3 in place
  if (slot == 0) {
    zero(acc);
    mma32(acc, T(0, 1), T(1, 0), tm, tn);
    put<true>(T(2, 0), acc, tm, tn, 1.0f);
  }
  __syncthreads();
  if (slot == 0) {
    zero(acc);
    mma32(acc, T(1, 2), T(2, 0), tm, tn);
  }
  __syncthreads();
  if (slot == 0) put<false>(T(2, 0), acc, tm, tn, -1.0f);
  __syncthreads();

  // ---- Wh = D^-1/2 W: scale the rows of the six lower tiles
  for (int e = tid; e < 6 * P * (P / 4); e += THREADS) {
    const int t = e / (P * (P / 4));
    const int rem = e - t * P * (P / 4);
    const int rr = rem >> 3, c4 = rem & 7;
    const int tr = t < 1 ? 0 : (t < 3 ? 1 : 2);   // tiles (0,0) (1,0) (1,1) (2,0) (2,1) (2,2)
    const int tc = t - tr * (tr + 1) / 2;
    float4* p = reinterpret_cast<float4*>(A + (P * tr + rr) * LDA + P * tc + 4 * c4);
    const float s = dsc[P * tr + rr];
    const float4 v = *p;
    *p = make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
  }
  __syncthreads();

  // ---- Gram, the six tiles p <= q: 5 tile products per slot. Each slot
  // parks its first tile in a free upper tile ((0,1) or (0,2): nothing reads
  // them any more), each thread only its own entries, so no barrier is
  // needed; the other two stay in registers.
  float g[2][4][4];
  const Op park = T(0, 1 + slot);
  zero(acc);
  zero(g[0]);
  zero(g[1]);
  if (slot == 0) {
    // (0,0) over r = 0,1,2; (1,2) and (2,2) over r = 2
#pragma unroll 1
    for (int r = 0; r < 3; ++r) mma32(acc, T(r, 0), T(r, 0), tm, tn);
    put<false>(park, acc, tm, tn, 1.0f);
    mma32(g[0], T(2, 1), T(2, 2), tm, tn);
    mma32(g[1], T(2, 2), T(2, 2), tm, tn);
  } else {
    // (0,1) over r = 1,2, parked; (1,1) over r = 1,2; (0,2) over r = 2
#pragma unroll 1
    for (int r = 1; r < 3; ++r) mma32(acc, T(r, 0), T(r, 1), tm, tn);
    put<false>(park, acc, tm, tn, 1.0f);
#pragma unroll 1
    for (int r = 1; r < 3; ++r) mma32(g[0], T(r, 1), T(r, 1), tm, tn);
    mma32(g[1], T(2, 0), T(2, 2), tm, tn);
  }
  const bool bad = any_nonfinite(acc) || any_nonfinite(g[0]) || any_nonfinite(g[1]);
  const bool ident = __syncthreads_or(bad) && repair;
  float* dst = out + static_cast<size_t>(blockIdx.x) * NN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(park.p + (4 * tm + i) * LDA + 4 * tn);
    acc[i][0] = v.x;
    acc[i][1] = v.y;
    acc[i][2] = v.z;
    acc[i][3] = v.w;
  }
  if (slot == 0) {
    emit(dst, acc, 0, 0, tm, tn, ident);
    emit(dst, g[0], 1, 2, tm, tn, ident);
    emit(dst, g[1], 2, 2, tm, tn, ident);
  } else {
    emit(dst, acc, 0, 1, tm, tn, ident);
    emit(dst, g[0], 1, 1, tm, tn, ident);
    emit(dst, g[1], 0, 2, tm, tn, ident);
  }
}

cudaError_t prepare_function() {
  // ask for the largest shared-memory split of the SM, so five blocks fit
  // (per device, so set on every call; it is cheap)
  return cudaFuncSetAttribute(spd_inverse96_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int spd_inverse96(const float* a, float* out, int nb, int repair, void* stream) {
  cudaError_t e = prepare_function();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nb > 0) {
    spd_inverse96_kernel<<<nb, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        a, out, repair);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's dynamic shared memory per block and how many blocks the
// runtime fits on one SM with it (no launch).
extern "C" int spd_inverse96_occupancy(int* smem_bytes, int* blocks_per_sm) {
  cudaError_t e = prepare_function();
  if (e != cudaSuccess) return static_cast<int>(e);
  *smem_bytes = static_cast<int>(SMEM_BYTES);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, spd_inverse96_kernel, THREADS, SMEM_BYTES));
}
