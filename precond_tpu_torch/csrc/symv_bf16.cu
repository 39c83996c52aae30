// Dense batched 96x96 symv on a bf16 table: z_b = A_b bf16(r_b), f32 out.
//
// Replaces: the JAX package's dense bf16 apply (SchwarzConfig.inverse_dtype
// "bfloat16"), an XLA einsum with the rhs rounded to the table's dtype and
// f32 accumulation (precond_tpu/ops/batched_inverse.py, apply_block_inverse;
// precond_tpu/ops/pallas/packed_symv.py, dense_symv_cm). No Pallas kernel.
//
// Precondition: every table A_b is bitwise symmetric. K1 writes its inverse
// so, the "xla" inverse symmetrizes, _factorize rounds to bf16 entry by
// entry and cm_permute96 permutes rows and columns alike. The kernel reads
// only the lower triangle and the diagonal; whatever lies above the diagonal
// is never used, NaN included.
//
// What bounds it on the H100: bytes. The work needs 4,656 of the 9,216
// entries. Row i needs columns 0..i, fetched as ceil((i+1)/8) 16-byte
// chunks from its 192-byte-aligned start: 624 chunks, 9,984 bytes a block
// (336 DRAM sectors of 32 bytes, 10,752 bytes), against 18,432 dense; plus
// 384 bytes of f32 rhs read and 384 of f32 z written. At ~1 flop a byte it
// is far below any ridge, so no tensor cores: the sums stay f32 in a fixed
// order.
//
// Design (Hopper):
//   * The table is cut into 8x8 tiles, 12 per side: 66 strictly below the
//     diagonal and 12 on it, 78 tiles of 8 row chunks each (= the 624
//     chunks). A thread owns a tile. An off-diagonal tile T = A[8I.., 8J..]
//     serves both sides, as K2 does: u = T x_J (for z_I) and v = T^T x_I
//     (for z_J), 128 fma from 8 loads of 16 bytes; a diagonal tile uses its
//     lower triangle for both and never touches its upper entries (the
//     indices are compile-time constants).
//   * Each tile leaves u and v in a scratch [12 groups][12 sources][8], one
//     slot per tile and side (no atomics); thread i then sums z_i over the
//     12 sources in the order 0..11 and stores it: 96 consecutive floats,
//     coalesced. The sum order is fixed, so the result is bitwise
//     reproducible whatever the grid.
//   * Loads: persistent thread blocks of 128 threads (as many as fit, from
//     the occupancy API, cached per device) walk the blocks b with a stride
//     of the grid, each with a ring of STAGES = 2 shared-memory stages:
//     cp.async.cg copies of 16 bytes for block b+grid land while block b is
//     multiplied. Thread t copies chunks t, t+128, ... of the row-major
//     triangle (5 a thread at most) to the same place in the stage, so each
//     warp reads row prefixes and writes 512 contiguous bytes; the rhs comes
//     by one 4-byte cp.async.ca a thread (no alignment needed), and thread i
//     rounds element i once, when its own copy has landed.
//   * Why this layout: landing the chunks in swizzled per-tile lines
//     instead (the first design) makes the copies alone 36% slower: they
//     write 16 bytes to each of many shared-memory lines; that design did
//     not beat torch.bmm (scripts/torch_k3bf16_variants.py, tile_dst;
//     PERF.md). In the compact triangle, chunk J of row 8I + r sits at
//     chunk (I+1)(4I+r) + J, in bank group ((I+1)r + J) mod 8: a
//     quarter-warp that holds tiles of one row group I with distinct J mod 8
//     reads without bank conflicts. The tile table TI / TJ places the tiles
//     so (16 quarter-warps, 4 warps); the diagonal tiles, one chunk a row,
//     fill the last two quarters.
//   * What bounds it: the DRAM reads of the row prefixes. The copies alone
//     take as long as the whole kernel; the same copies from a contiguous
//     span take 79% of that (the variants script). If the DRAM reads
//     64-byte pieces, the triangle costs 12,288 bytes a block, not 9,984.
//   * Shared memory per thread block: 2 x (9,984 + 384) + 12 x 104 x 4 =
//     25,728 bytes (static); ptxas (CUDA 12.9, sm_90a): 78 registers, no
//     spills; 6 blocks per SM.
//
// Numbers: r is rounded to bf16 (round to nearest even, as JAX's astype)
// and widened again; a product of two bf16 values is exact in f32, so the
// kernel differs from the f32 einsum of the widened operands only in the
// order of its f32 sums, which is fixed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int D = 96;
constexpr int NT = D / 8;                     // 8x8 tiles per side
constexpr int TILES = NT * (NT + 1) / 2;      // on and below the diagonal
constexpr int CHUNKS = TILES * 8;             // 16-byte row chunks of the triangle
constexpr int THREADS = 128;                  // 16 quarter-warps of tiles; 96 sum z
constexpr int COPIES = (CHUNKS + THREADS - 1) / THREADS;
constexpr int STAGES = 2;
constexpr int TRI_BYTES = CHUNKS * 16;
constexpr int STAGE_BYTES = TRI_BYTES + D * 4;  // triangle + f32 rhs
constexpr int SCR = NT * 8 + 8;                 // floats per output group (padded)
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + NT * SCR * 4;
constexpr int MAX_DEVICES = 64;
static_assert(CHUNKS == 624 && COPIES == 5, "the 96x96 triangle is 624 chunks");
static_assert(STAGE_BYTES % 128 == 0, "stages stay 128-byte aligned");
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory");

// Thread t's tile (TI[t], TJ[t]): I > J below the diagonal, I == J on it,
// -1 for none. Each quarter-warp (8 threads) holds tiles of one row group I
// with distinct J mod 8, so their 16-byte reads of a row r fall in distinct
// bank groups of the compact triangle (chunk J of row 8I + r sits at chunk
// (I+1)(4I+r) + J, bank group ((I+1)r + J) mod 8). The diagonal tiles fill
// the last two quarters; they read one chunk a row and run their own path.
__constant__ int8_t TI[THREADS] = {
    11, 11, 11, 11, 11, 11, 11, 11, 10, 10, 10, 10, 10, 10, 10, 10,
    9,  9,  9,  9,  9,  9,  9,  9,  8,  8,  8,  8,  8,  8,  8,  8,
    7,  7,  7,  7,  7,  7,  7,  -1, 6,  6,  6,  6,  6,  6,  -1, -1,
    5,  5,  5,  5,  5,  -1, -1, -1, 4,  4,  4,  4,  -1, -1, -1, -1,
    3,  3,  3,  -1, -1, -1, -1, -1, 2,  2,  -1, -1, -1, -1, -1, -1,
    1,  -1, -1, -1, -1, -1, -1, -1, 11, 11, 11, -1, -1, -1, -1, -1,
    10, 10, -1, -1, -1, -1, -1, -1, 9,  -1, -1, -1, -1, -1, -1, -1,
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, -1, -1, -1, -1};
__constant__ int8_t TJ[THREADS] = {
    0,  1,  2,  3,  4,  5,  6,  7,  0,  1,  2,  3,  4,  5,  6,  7,
    0,  1,  2,  3,  4,  5,  6,  7,  0,  1,  2,  3,  4,  5,  6,  7,
    0,  1,  2,  3,  4,  5,  6,  -1, 0,  1,  2,  3,  4,  5,  -1, -1,
    0,  1,  2,  3,  4,  -1, -1, -1, 0,  1,  2,  3,  -1, -1, -1, -1,
    0,  1,  2,  -1, -1, -1, -1, -1, 0,  1,  -1, -1, -1, -1, -1, -1,
    0,  -1, -1, -1, -1, -1, -1, -1, 8,  9,  10, -1, -1, -1, -1, -1,
    8,  9,  -1, -1, -1, -1, -1, -1, 8,  -1, -1, -1, -1, -1, -1, -1,
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, -1, -1, -1, -1};

int persistent_blocks[MAX_DEVICES] = {};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Chunk q of the row-major lower triangle, its byte offset in the block's
// table (the stage keeps the same order, at 16 * q). Row group g (rows
// 8g..8g+7) holds g+1 chunks a row and starts at chunk 4g(g+1).
__device__ __forceinline__ int chunk_src(int q) {
  int g = 0;
  while (4 * (g + 1) * (g + 2) <= q) ++g;
  const int off = q - 4 * g * (g + 1);
  const int r = off / (g + 1);
  return (8 * g + r) * D * 2 + 16 * (off - r * (g + 1));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// eight f32 of the staged rhs (already rounded to bf16 values)
__device__ __forceinline__ void load_x(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// a 16-byte chunk of eight bf16 (little-endian pairs) widened to f32
__device__ __forceinline__ void unpack8(const uint4 w, float* a) {
  const uint32_t p[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[2 * k] = __uint_as_float(p[k] << 16);
    a[2 * k + 1] = __uint_as_float(p[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__global__ void __launch_bounds__(THREADS, 5)
symv96_bf16_kernel(const unsigned char* __restrict__ inv, const float* __restrict__ r,
                   float* __restrict__ z, int nb) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  float* scr = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  const int tid = threadIdx.x;
  const uint32_t sbase = smem_u32(smem);

  // this thread's chunk copies, the same for every block b
  int src[COPIES];
#pragma unroll
  for (int s = 0; s < COPIES; ++s) {
    const int q = tid + s * THREADS;
    src[s] = q < CHUNKS ? chunk_src(q) : 0;
  }
  const bool last_copy = tid + (COPIES - 1) * THREADS < CHUNKS;

  // this thread's tile: row r of it is chunk tbase + r * (ti + 1) of a stage
  const int ti = TI[tid], tj = TJ[tid];
  const int tbase = 16 * (4 * ti * (ti + 1) + tj), tstep = 16 * (ti + 1);

  // blocks b = blockIdx.x + n * gridDim.x, n < count (the grid is <= nb)
  const int count = (nb - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  const auto fetch = [&](int n) {
    if (n < count) {
      const size_t b = blockIdx.x + static_cast<size_t>(n) * gridDim.x;
      const unsigned char* tab = inv + b * (D * D * 2);
      const uint32_t st = sbase + (n % STAGES) * STAGE_BYTES;
#pragma unroll
      for (int s = 0; s < COPIES; ++s) {
        if (s < COPIES - 1 || last_copy) cp_async16(st + 16 * (tid + s * THREADS), tab + src[s]);
      }
      if (tid < D) cp_async4(st + TRI_BYTES + 4 * tid, r + b * D + tid);
    }
    cp_async_commit();  // one group per n, empty past the end
  };
  // Thread i rounds element i of a table's rhs in place once its own
  // 4-byte copy has landed; the next barrier shows it to every thread.
  const auto round_x = [&](int n) {
    if (n < count && tid < D) {
      float* x = reinterpret_cast<float*>(smem + (n % STAGES) * STAGE_BYTES + TRI_BYTES);
      x[tid] = bf16_round(x[tid]);
    }
  };

#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) fetch(n);
  cp_async_wait<STAGES - 2>();
  round_x(0);
  for (int n = 0; n < count; ++n) {
    __syncthreads();  // block n's copies (each thread waited for its own) are
                      // in, its rhs is rounded, and stage n-1 is free
    fetch(n + STAGES - 1);
    const unsigned char* stage = smem + (n % STAGES) * STAGE_BYTES;
    const float* xs = reinterpret_cast<const float*>(stage + TRI_BYTES);
    if (ti > tj) {
      // below the diagonal: u = T x_J for z_I, v = T^T x_I for z_J
      const unsigned char* tile = stage + tbase;
      float xi[8], xj[8], u[8], v[8];
      load_x(xs + 8 * ti, xi);
      load_x(xs + 8 * tj, xj);
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        float a[8];
        unpack8(*reinterpret_cast<const uint4*>(tile + rr * tstep), a);
        float s = a[0] * xj[0];
#pragma unroll
        for (int c = 1; c < 8; ++c) s = fmaf(a[c], xj[c], s);
        u[rr] = s;
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = rr == 0 ? a[c] * xi[0] : fmaf(a[c], xi[rr], v[c]);
      }
      store8(scr + ti * SCR + 8 * tj, u);
      store8(scr + tj * SCR + 8 * ti, v);
    } else if (ti >= 0) {
      // on the diagonal: row rr's dot product over c <= rr, then its strict
      // lower entries into the earlier rows' sums; nothing above is read
      const unsigned char* tile = stage + tbase;
      float xi[8], u[8];
      load_x(xs + 8 * ti, xi);
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        float a[8];
        unpack8(*reinterpret_cast<const uint4*>(tile + rr * tstep), a);
        float s = a[0] * xi[0];
#pragma unroll
        for (int c = 1; c <= rr; ++c) s = fmaf(a[c], xi[c], s);
#pragma unroll
        for (int c = 0; c < rr; ++c) u[c] = fmaf(a[c], xi[rr], u[c]);
        u[rr] = s;
      }
      store8(scr + ti * SCR + 8 * ti, u);
    }
    __syncthreads();
    if (tid < D) {
      const float* sc = scr + (tid >> 3) * SCR + (tid & 7);
      float acc = sc[0];
#pragma unroll
      for (int k = 1; k < NT; ++k) acc += sc[8 * k];
      z[(blockIdx.x + static_cast<size_t>(n) * gridDim.x) * D + tid] = acc;
    }
    cp_async_wait<STAGES - 2>();  // this thread's copies of the next block have landed
    round_x(n + 1);
  }
}

// The persistent grid on the current device: SMs x resident blocks per SM.
cudaError_t persistent_grid(int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  *grid = dev < MAX_DEVICES ? persistent_blocks[dev] : 0;
  if (*grid > 0) return cudaSuccess;
  // prefer the largest shared-memory carveout, so six blocks fit on an SM
  e = cudaFuncSetAttribute(symv96_bf16_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, symv96_bf16_kernel, THREADS, 0);
  if (e != cudaSuccess) return e;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) persistent_blocks[dev] = *grid;
  return cudaSuccess;
}

}  // namespace

extern "C" int symv96_bf16(const void* inv, const float* r, float* z, int nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  if (reinterpret_cast<uintptr_t>(inv) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);  // the 16-byte copies need it
  }
  int grid = 0;
  const cudaError_t e = persistent_grid(&grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  symv96_bf16_kernel<<<nb < grid ? nb : grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(inv), r, z, nb);
  return static_cast<int>(cudaGetLastError());
}

// No launch: the persistent grid (thread blocks, each taking one table at a
// time) and the resident blocks per SM on the current device.
extern "C" int symv96_bf16_grid(int* grid, int* per_sm) {
  const cudaError_t e = persistent_grid(grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *per_sm = sms > 0 ? *grid / sms : 0;
  return static_cast<int>(cudaGetLastError());
}
