// Block-ELL SpMV of the general path, one pass over the stored blocks:
//   y[v] = diag[v] x[v] + sum over the valid slots s of row v of blocks[v,s] x[idx[v,s]]
// with diag f32[N,3,3], idx i32[N,K], blocks f32[N,K,3,3], mask u8/bool[N,K]
// (nonzero = valid), x and y f32[N,3], all contiguous.
//
// Replaces no TPU kernel: the JAX package's spmv (precond_tpu/ops/blockcsr.py)
// is a gather plus einsum that XLA fuses. On the card the plain PyTorch version
// (ops/blockcsr.py, spmv_plain) writes a gathered [N,K,3] copy of x, a permuted
// copy of the blocks and a separate diagonal product, and reads every padded
// slot; this kernel reads each stored block once and writes y once.
//
// What bounds it on the H100: bytes. A row reads its stored 36-byte blocks
// and their 4-byte column ids, its diagonal block, its K mask bytes and its
// own x, and writes 12 bytes; x (12 B a vertex) is gathered through the 50 MB
// L2. At 2 flop a block entry the kernel lies far below the f32 ridge.
//
// Design: one warp a row; lanes 0..26 work, 27..31 only vote. Lane l owns
// entry e = l % 9 of a 3x3 block (row e / 3, column e % 3) and phase
// p = l / 9, and walks the valid slots p, p + 3, p + 6, ... of its row in
// order. So one step of the warp reads three consecutive valid blocks: where
// the valid slots are contiguous (every producer of the port packs them
// first), 108 contiguous bytes with 4-byte loads; rows are 36 K bytes apart,
// only 4-byte aligned, so wider loads do not apply. Masked slots are never
// read, so a padded slot's block may hold anything, NaN included.
// The valid slots are found 54 at a time: each worker lane reads two mask
// bytes, two ballots give the window's valid set, and each valid lane writes
// its slot into the warp's list in shared memory at its rank (no prefix is
// assumed). Each lane keeps one f32 sum; the diagonal block goes into phase
// 0's lanes first. The sums are then reduced by shuffles in a fixed order,
// first over the three phases, then over the three columns, so two calls give
// the same bits; there are no atomics. Blocks and the diagonal are streamed
// (read once, evict first), idx, mask and x go through the read-only path.
// UNROLL steps are issued before their x gathers so that a row's loads are in
// flight together. Four warps a block and four steps in flight were the
// fastest of the sizes tried on the 1M Delaunay sheet, where 72% of the rows
// hold at most 12 valid slots (a persistent grid that prefetched the next
// row's mask was slower). Offsets into blocks are 64-bit (9 N K outgrows 32 bits).

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;          // rows per thread block
constexpr int PHASES = 3;         // blocks a warp step reads
constexpr int LANES = 9 * PHASES; // working lanes of a warp: 27
constexpr int WINDOW = 2 * LANES; // slots whose mask one pass reads: 54
constexpr int UNROLL = 4;         // steps in flight: 12 valid slots

__global__ void __launch_bounds__(32 * WARPS)
ell_spmv_kernel(const float* __restrict__ diag, const int* __restrict__ idx,
                const float* __restrict__ blocks, const unsigned char* __restrict__ mask,
                const float* __restrict__ x, float* __restrict__ y, int n, int k) {
  __shared__ unsigned char list[WARPS][WINDOW];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (row >= n) return;  // the whole warp
  const bool worker = lane < LANES;
  const int phase = lane / 9;
  const int e = lane - 9 * phase;
  const int c = e % 3;
  const long long rk = row * k;
  const unsigned below = (1u << lane) - 1u;

  float acc = 0.0f;
  if (lane < 9) acc = __ldcs(diag + row * 9 + lane) * __ldg(x + row * 3 + c);

  for (int w0 = 0; w0 < k; w0 += WINDOW) {
    const int s0 = w0 + lane;
    const int s1 = s0 + LANES;
    const bool v0 = worker && s0 < k && __ldg(mask + rk + s0) != 0;
    const bool v1 = worker && s1 < k && __ldg(mask + rk + s1) != 0;
    const unsigned b0 = __ballot_sync(FULL, v0);
    const unsigned b1 = __ballot_sync(FULL, v1);
    const int n0 = __popc(b0);
    if (v0) list[warp][__popc(b0 & below)] = static_cast<unsigned char>(lane);
    if (v1) list[warp][n0 + __popc(b1 & below)] = static_cast<unsigned char>(LANES + lane);
    __syncwarp();
    const int count = n0 + __popc(b1);
    for (int j = phase; j < count; j += PHASES * UNROLL) {
      bool ok[UNROLL];
      float b[UNROLL];
      int col[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = j + PHASES * u;
        ok[u] = worker && r < count;
        b[u] = 0.0f;
        col[u] = 0;
        if (ok[u]) {
          const long long o = rk + w0 + list[warp][r];
          b[u] = __ldcs(blocks + o * 9 + e);
          col[u] = __ldg(idx + o);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (ok[u]) acc = fmaf(b[u], __ldg(x + static_cast<long long>(col[u]) * 3 + c), acc);
      }
    }
    __syncwarp();  // the next window rewrites the list
  }

  // y[r] = sum over phases p and columns c of acc[9 p + 3 r + c], in that order
  float s = acc + __shfl_down_sync(FULL, acc, 9);
  s += __shfl_down_sync(FULL, acc, 18);
  float t = s + __shfl_down_sync(FULL, s, 1);
  t += __shfl_down_sync(FULL, s, 2);
  if (lane < 9 && c == 0) y[row * 3 + lane / 3] = t;
}

}  // namespace

extern "C" int ell_spmv(const float* diag, const int* idx, const float* blocks,
                        const unsigned char* mask, const float* x, float* y, int n, int k,
                        void* stream) {
  if (n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned grid = static_cast<unsigned>((static_cast<long long>(n) + WARPS - 1) / WARPS);
    ell_spmv_kernel<<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        diag, idx, blocks, mask, x, y, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
