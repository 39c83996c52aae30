// Packed-symmetric batched 96x96 symv: z_b = A_b x_b from 4704 floats per block.
//
// Replaces: precond_tpu/ops/pallas/packed_symv.py, packed_symv_t (kernel
// _kernel), the apply's per-block symv at >= 4096 blocks.
//
// Layout (the JAX PackedInverse, batch-minor, Bp = padded block count):
//   F  f32[48][96][Bp]: F[i][c][b] =
//        c < 48, i > c : A11[i][c]            (strict lower of A11)
//        c < 48, i < c : A22[c][i]            (strict lower of A22, transposed up)
//        c >= 48       : A21[i][c-48]         (= A[48+i][c-48], full off-diagonal block)
//        c < 48, i == c: unused (stored zero, never read)
//   dg f32[96][Bp] diagonal of A;  x, z f32[96][Bp].
// Every stored element is read from device memory once and used for both
// A[i][j] and A[j][i].
//
// What bounds it on the H100: bytes. A block moves 19,584 bytes (F, dg, x
// read once, z written once) for 18,432 flop (~0.9 flop/byte), far below the
// f32 ridge, so the goal is streaming F at the memory rate. No tensor cores:
// the kernel is bound by bytes, and TF32 would lose digits the
// preconditioner needs (blocks reach cond ~1e7).
//
// Design (Hopper): F is viewed as a 2-D tensor [4608 rows (i, c), Bp] with
// a pitch of Bp*4 bytes, and a tile is 32 consecutive blocks b. Persistent
// thread blocks (as many as fit on the card, two per SM) walk over the tiles
// with a stride of the grid, so there is no wave tail beyond one tile per
// thread block. Each thread block has one producer thread and four consumer
// warps:
//   * the producer keeps 2-D TMA loads (cp.async.bulk.tensor, mbarrier
//     complete_tx) in flight into a ring of STAGES = 5 shared-memory stages,
//     one box {32 blocks b, 96 rows c} = F[i][0:96][tile] = 12 KB per stage,
//     48 boxes per tile; x and dg of the tile come as two more boxes into a
//     double-buffered pair of their own. The bytes in flight are TMA's, not
//     registers', and can reach ~120 KB per SM (Little's law at 3.35 TB/s
//     needs ~18 KB);
//   * consumer lane l serves block b = tile*32 + l, and warp w owns the
//     outputs z[j] and z[48+j] for j = w, w+4, ..., w+44 (24 accumulators).
//     For each row i it reads from the staged box the 24 elements that touch
//     its outputs as a column (F[i][j] and F[i][48+j], times x[i] or
//     x[48+i]); the warp with i % 4 == w also takes row i's dot products for
//     z[i] and z[48+i] (all 96 elements of the row, with the tile's x held in
//     96 registers). Every warp read of a staged row is 32 consecutive floats,
//     free of bank conflicts, and A21 is read from device memory once by
//     construction;
//   * z is written per tile with coalesced 128-byte stores, masked past Bp;
//     ragged tiles read TMA's zero fill.
// Two thread blocks per SM rather than one with a deeper ring: one block's
// four consumer warps, not the bytes in flight, set its pace, so one block
// per SM with 8 or 14 stages runs ~1.6x slower (PERF.md).
// TMA needs a 16-byte-aligned base and a pitch that is a multiple of 16
// bytes: Bp must be a multiple of 4 (the wrapper raises otherwise).
//
// Registers: the first version (one thread, all 96 accumulators) used 255
// with 8,028 bytes of spill stores per thread, the second (two warps of 48
// accumulators, plain loads) 233 with no spills (ptxas -v, sm_90a, CUDA
// 12.9); the build log (-Xptxas -v) reports this version's count.
//
// Numbers: f32 loads and fma accumulation in a fixed order per output (the
// row order i, then the row's own dot products), so the result is bitwise
// reproducible from launch to launch whatever the grid; it differs from a
// dense matvec only by summation order.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int D = 96;
constexpr int H = 48;
constexpr int WB = 32;                       // blocks b per tile, one per lane
constexpr int CONSUMERS = 4;                 // consumer warps
constexpr int SLOTS = H / CONSUMERS;         // j = w + 4k, k < SLOTS
constexpr int THREADS = (CONSUMERS + 1) * 32;
constexpr int STAGES = 5;
constexpr int BOX_FLOATS = D * WB;           // one box {32 b, 96 rows}
constexpr unsigned BOX_BYTES = BOX_FLOATS * 4;
// F ring, x and dg double-buffered, the mbarriers
constexpr size_t SMEM_BYTES = (STAGES + 4) * static_cast<size_t>(BOX_BYTES) + (2 * STAGES + 4) * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// box {32 columns from `col`, 96 rows from `row`} of `map` into `dst`
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(THREADS, 2)
packed_symv96_kernel(__grid_constant__ const CUtensorMap fmap,
                     __grid_constant__ const CUtensorMap xmap,
                     __grid_constant__ const CUtensorMap dmap, float* __restrict__ z, int bp) {
  // indexing the shared array itself (no integer round trip) keeps the
  // compiler's loads shared-memory loads (LDS), not generic ones
  extern __shared__ __align__(128) float smem[];
  float* fs = smem;                      // [STAGES][96][32]
  float* xs = fs + STAGES * BOX_FLOATS;  // [2][96][32]
  float* ds = xs + 2 * BOX_FLOATS;       // [2][96][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(ds + 2 * BOX_FLOATS);
  uint64_t* empty = full + STAGES;
  uint64_t* xfull = empty + STAGES;
  uint64_t* xempty = xfull + 2;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ntiles = (bp + WB - 1) / WB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the last barrier of the kernel: the roles never meet again

  if (warp == CONSUMERS) {
    // producer: one thread keeps the ring full, tile after tile
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x, t = 0; tile < ntiles; tile += gridDim.x, ++t) {
      const int xb = t & 1;
      const int col = tile * WB;
      mbar_wait(&xempty[xb], ((t >> 1) & 1) ^ 1);
      mbar_expect_tx(&xfull[xb], 2 * BOX_BYTES);
      tma_load(xs + xb * BOX_FLOATS, &xmap, col, 0, &xfull[xb]);
      tma_load(ds + xb * BOX_FLOATS, &dmap, col, 0, &xfull[xb]);
      for (int i = 0; i < H; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], BOX_BYTES);
        tma_load(fs + stage * BOX_FLOATS, &fmap, col, i * D, &full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warp w owns z[j], z[48+j] for j = w + 4k
  const int w = warp;
  const size_t s = static_cast<size_t>(bp);
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x, t = 0; tile < ntiles; tile += gridDim.x, ++t) {
    const int xb = t & 1;
    mbar_wait(&xfull[xb], (t >> 1) & 1);
    const float* xt = xs + xb * BOX_FLOATS + lane;  // xt[r * WB] = x[r][b]
    const float* dt = ds + xb * BOX_FLOATS + lane;
    float xr[D];
#pragma unroll
    for (int r = 0; r < D; ++r) xr[r] = xt[r * WB];
    float top[SLOTS], bot[SLOTS];  // z[j], z[48 + j]
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int j = w + CONSUMERS * k;
      top[k] = dt[j * WB] * xt[j * WB];
      bot[k] = dt[(H + j) * WB] * xt[(H + j) * WB];
    }

    for (int i = 0; i < H; ++i) {
      mbar_wait(&full[stage], phase);
      const float* fr = fs + stage * BOX_FLOATS + lane;  // fr[c * WB] = F[i][c][b]
      const float xi = xt[i * WB];
      const float xhi = xt[(H + i) * WB];
      // The row index i is a run-time value, so which of A11 / A22 an element
      // belongs to is a select, not a branch: a branch per element would cut
      // the unrolled loop into blocks the compiler cannot schedule loads
      // across. A term the select drops adds an exact zero (x is finite).
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const int j = w + CONSUMERS * k;
        const float v = fr[j * WB];
        top[k] = fmaf(j < i ? v : 0.0f, xi, top[k]);   // A11[i][j]: z[j] += . x[i]
        bot[k] = fmaf(j > i ? v : 0.0f, xhi, bot[k]);  // A22[j][i]: z[48+j] += . x[48+i]
        top[k] = fmaf(fr[(H + j) * WB], xhi, top[k]);  // A[48+i][j]: z[j] += . x[48+i]
      }
      if ((i % CONSUMERS) == w) {
        // row i's own outputs: z[i] += A11[i][:i] x[:i];
        // z[48+i] += A22[i][i+1:] x[48+i+1:] + A21[i][:] x[:48]
        float st = 0.0f, sb = 0.0f;
#pragma unroll
        for (int c = 0; c < H; ++c) {
          const float v = fr[c * WB];
          st = fmaf(c < i ? v : 0.0f, xr[c], st);
          sb = fmaf(c > i ? v : 0.0f, xr[H + c], sb);
        }
#pragma unroll
        for (int c = 0; c < H; ++c) sb = fmaf(fr[(H + c) * WB], xr[c], sb);
        const int own = i / CONSUMERS;
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          if (k == own) {
            top[k] += st;
            bot[k] += sb;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&xempty[xb]);

    const int b = tile * WB + lane;
    if (b < bp) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const int j = w + CONSUMERS * k;
        z[j * s + b] = top[k];
        z[(H + j) * s + b] = bot[k];
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup (libcuda is
// already loaded), so the library links without -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// a [rows, bp] f32 row-major tensor, boxes of {32 columns, 96 rows}; columns
// past bp read as zero
bool encode(EncodeTiled fn, CUtensorMap* map, const float* ptr, int rows, int bp) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(bp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(bp) * sizeof(float)};
  const cuuint32_t box[2] = {WB, D};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, pitch, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;
int persistent_blocks[MAX_DEVICES];  // per device, 0 until first asked

}  // namespace

extern "C" int packed_symv96(const float* f, const float* dg, const float* x, float* z,
                             int bp, void* stream) {
  if (bp <= 0) return static_cast<int>(cudaGetLastError());
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (bp % 4 != 0 || misaligned(f) || misaligned(dg) || misaligned(x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap fmap, xmap, dmap;
  if (!encode(fn, &fmap, f, H * D, bp) || !encode(fn, &xmap, x, D, bp) ||
      !encode(fn, &dmap, dg, D, bp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB of dynamic shared memory a launch is refused unless the
  // function opts in (per device, so set on every call; it is cheap)
  cudaError_t e = cudaFuncSetAttribute(packed_symv96_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  int grid = dev < MAX_DEVICES ? persistent_blocks[dev] : 0;
  if (grid == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
      return static_cast<int>(e);
    }
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, packed_symv96_kernel, THREADS,
                                                           SMEM_BYTES)) != cudaSuccess) {
      return static_cast<int>(e);
    }
    grid = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < MAX_DEVICES) persistent_blocks[dev] = grid;
  }
  const int ntiles = (bp + WB - 1) / WB;
  packed_symv96_kernel<<<ntiles < grid ? ntiles : grid, THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(fmap, xmap, dmap, z, bp);
  return static_cast<int>(cudaGetLastError());
}
