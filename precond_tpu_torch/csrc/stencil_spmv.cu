// Fused stencil-form block SpMV of a structured (nx, ny) grid, one pass:
//   y[:, v] = diag[v] x[:, v] + sum_d dirs_d[v] x[:, v + (di_d, dj_d)]
// over vertex-minor planes: diag f32[9, N] (entry 3r+c of the 3x3 block),
// dirs f32[D*9, N], x and y component-major f32[3, N], N = nx*ny, vertex
// v = i*ny + j.
//
// Replaces: precond_tpu/ops/pallas/stencil_spmv.py, spmv_pallas (_kernel),
// the structured grid path's SpMV in every PCG iteration.
//
// What bounds it on the H100: bytes. Each vertex reads 9 + 9D plane floats
// once and writes 3; at D = 12 that is 492 B against 234 flop, far below the
// f32 ridge. The design only has to stream the planes at the memory rate.
//
// Design: one thread per vertex, so consecutive threads read consecutive
// floats of every plane (coalesced) and of every shifted window of x (the
// neighbour reads of a warp are one or two contiguous runs; the D windows
// overlap, so L1/L2 serve most of them). Three f32 accumulators, filled in
// the plain version's order: the diagonal block first, then the directions
// in offset order. Offsets arrive by value in the kernel's parameters.
//
// Off-grid neighbours are skipped by testing 0 <= i+di < nx and
// 0 <= j+dj < ny, as the plain version's 2-D zero padding does. (The Pallas
// kernel reads a flat shift di*ny + dj into a zero-padded x and relies on the
// direction block being zero wherever the shift wraps a row edge; here a
// wrapped read never happens, so a zero block can never meet a non-finite x.)
// Plane offsets are 64-bit, since D*9*N outgrows 32 bits first.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_OFFSETS = 32;
constexpr int THREADS = 256;

struct Stencil {
  int nd, nx, ny;
  int di[MAX_OFFSETS];
  int dj[MAX_OFFSETS];
};

__device__ __forceinline__ void block_mv(const float* __restrict__ p, long long n,
                                         float u0, float u1, float u2,
                                         float& a0, float& a1, float& a2) {
  a0 += __ldg(p) * u0 + __ldg(p + n) * u1 + __ldg(p + 2 * n) * u2;
  a1 += __ldg(p + 3 * n) * u0 + __ldg(p + 4 * n) * u1 + __ldg(p + 5 * n) * u2;
  a2 += __ldg(p + 6 * n) * u0 + __ldg(p + 7 * n) * u1 + __ldg(p + 8 * n) * u2;
}

__global__ void __launch_bounds__(THREADS)
stencil_spmv_kernel(const float* __restrict__ diag, const float* __restrict__ dirs,
                    const float* __restrict__ x, float* __restrict__ y, const Stencil s) {
  const long long n = static_cast<long long>(s.nx) * s.ny;
  const long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (v >= n) return;
  const int i = static_cast<int>(v / s.ny);
  const int j = static_cast<int>(v - static_cast<long long>(i) * s.ny);

  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  block_mv(diag + v, n, __ldg(x + v), __ldg(x + n + v), __ldg(x + 2 * n + v), a0, a1, a2);

  // fully unrolled, so every di/dj read is a static parameter offset
#pragma unroll
  for (int d = 0; d < MAX_OFFSETS; ++d) {
    if (d >= s.nd) break;
    const int ii = i + s.di[d];
    const int jj = j + s.dj[d];
    if (ii < 0 || ii >= s.nx || jj < 0 || jj >= s.ny) continue;
    const long long u = static_cast<long long>(ii) * s.ny + jj;
    block_mv(dirs + static_cast<long long>(d) * 9 * n + v, n,
             __ldg(x + u), __ldg(x + n + u), __ldg(x + 2 * n + u), a0, a1, a2);
  }
  y[v] = a0;
  y[n + v] = a1;
  y[2 * n + v] = a2;
}

}  // namespace

// offsets: host array of nd (di, dj) pairs, copied into the kernel's
// parameters; nd <= 32.
extern "C" int stencil_spmv(const float* diag, const float* dirs, const float* x, float* y,
                            int nx, int ny, int nd, const int* offsets, void* stream) {
  if (nd < 0 || nd > MAX_OFFSETS || nx < 0 || ny < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Stencil s;
  s.nd = nd;
  s.nx = nx;
  s.ny = ny;
  for (int d = 0; d < MAX_OFFSETS; ++d) {
    s.di[d] = d < nd ? offsets[2 * d] : 0;
    s.dj[d] = d < nd ? offsets[2 * d + 1] : 0;
  }
  const long long n = static_cast<long long>(nx) * ny;
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
    stencil_spmv_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        diag, dirs, x, y, s);
  }
  return static_cast<int>(cudaGetLastError());
}
