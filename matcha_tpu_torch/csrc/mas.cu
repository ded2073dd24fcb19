// Monotonic Alignment Search for Hopper (sm_90a), one block per batch row.
//
// Replaces the Pallas TPU kernel matcha_tpu/ops/mas_pallas.py
// (maximum_path_pallas, body _mas_kernel). It computes the same function,
// bit for bit: the banded Viterbi forward over mel frames y,
//
//   acc[y][x] = max(acc[y-1][x], acc[y-1][x-1]) + lp[x][y]   inside the band
//               x <= y, x >= t_x + y - t_y, x < t_x (y < t_y), else -1e9,
//
// with acc[-1][-1] = 0 for the first cell, then the backtrack from
// index = t_x - 1 that moves up one token when
//   index != 0 && (index == y || acc[y-1][index] < acc[y-1][index-1]) && y > 0.
//
// What bounds it. The work is a chain of t_y dependent row steps plus a
// backtrack of t_y dependent steps, with about three operations per cell:
// the kernel is bound by latency, far from both the bytes bound (lp read
// once, the path written once) and the operations bound. Its design:
//  * Forward: one thread per x (up to MAX_CHUNKS cells per thread when
//    T_x > 1024). A cell's previous value stays in a register; its left
//    neighbour comes from __shfl_up_sync within the warp and, at warp and
//    chunk edges, from a few words of shared memory written the row
//    before (double-buffered by row parity), so a row costs one
//    __syncthreads(). lp[x][y] is read x-major as the caller holds it;
//    each warp's 32 cache lines serve the next 31 rows from L1, and a
//    register ring prefetches PREFETCH rows ahead.
//  * The backtrack needs only the decision bit of each cell,
//    acc[y-1][x-1] > acc[y-1][x], which the forward computes from the
//    very floats the max compared (so a tie does not move). A warp packs
//    its 32 bits with __ballot_sync into one word of a (B, T_y, ceil(T_x/32))
//    scratch the wrapper allocates; no f32 row is kept.
//  * Backtrack: warp 0 walks y down. Per 32 rows, each lane loads the two
//    bit words (index >> 5 and the one before) of one row, so one round
//    of loads serves 32 serial decisions made with __shfl_sync.
// The path is written as 1.0f into an f32 (B, T_x, T_y) output that the
// wrapper zeroed; rows y >= t_y stay 0. The kernel only adds, maxes and
// compares: there is no multiply for the compiler to contract.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_CHUNKS = 4;
constexpr int PREFETCH = 4;
constexpr int MAX_WARPS = 32;
constexpr float MAX_NEG_VAL = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(1024)
mas_kernel(const float* __restrict__ lp, const int* __restrict__ t_xs,
           const int* __restrict__ t_ys, uint32_t* __restrict__ bits,
           float* __restrict__ path, int T_x, int T_y, int chunks) {
  __shared__ float edge[2][MAX_CHUNKS][MAX_WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int W = (T_x + 31) >> 5;
  const int t_x = min(t_xs[b], T_x), t_y = min(t_ys[b], T_y);
  if (t_x <= 0 || t_y <= 0) return;  // the same for the whole block

  const float* lpb = lp + (size_t)b * T_x * T_y;
  uint32_t* bitsb = bits + (size_t)b * T_y * W;

  // row -1 is all MAX_NEG_VAL; its edges are read at y = 0 from parity 1
  for (int i = tid; i < MAX_CHUNKS * MAX_WARPS; i += blockDim.x)
    edge[1][i / MAX_WARPS][i % MAX_WARPS] = MAX_NEG_VAL;

  float prev[MAX_CHUNKS];
  float ring[PREFETCH][MAX_CHUNKS];
#pragma unroll
  for (int k = 0; k < MAX_CHUNKS; ++k) {
    prev[k] = MAX_NEG_VAL;
    const int x = k * blockDim.x + tid;
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j)
      ring[j][k] = (k < chunks && x < t_x && j < t_y) ? __ldg(lpb + (size_t)x * T_y + j) : 0.f;
  }
  __syncthreads();

  for (int y0 = 0; y0 < t_y; y0 += PREFETCH) {
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const int y = y0 + j;
      if (y >= t_y) break;  // uniform: every thread leaves at the same row
      const int rd = (y + 1) & 1, wr = y & 1;
#pragma unroll
      for (int k = 0; k < MAX_CHUNKS; ++k) {
        if (k >= chunks) break;
        const int x = k * blockDim.x + tid;
        float left = __shfl_up_sync(FULL, prev[k], 1);
        if (lane == 0) {
          if (warp > 0) left = edge[rd][k][warp - 1];
          else if (k > 0) left = edge[rd][k - 1][n_warps - 1];
          else left = (y == 0) ? 0.f : MAX_NEG_VAL;
        }
        const float cand = fmaxf(prev[k], left);
        const float nv = __fadd_rn(cand, ring[j][k]);
        const bool in_band = x <= y && x >= t_x + y - t_y && x < t_x;
        const float out = in_band ? nv : MAX_NEG_VAL;
        // decision bit of cell (y, x): acc[y-1][x-1] > acc[y-1][x]
        const unsigned word = __ballot_sync(FULL, x < t_x && left > prev[k]);
        if (lane == 0 && x < t_x) bitsb[(size_t)y * W + (x >> 5)] = word;
        if (lane == 31) edge[wr][k][warp] = out;
        prev[k] = out;
        const int yn = y + PREFETCH;
        ring[j][k] = (yn < t_y && x < t_x) ? __ldg(lpb + (size_t)x * T_y + yn) : 0.f;
      }
      __syncthreads();
    }
  }

  if (warp != 0) return;
  float* pathb = path + (size_t)b * T_x * T_y;
  int index = t_x - 1;
  for (int y0 = t_y - 1; y0 >= 0; y0 -= 32) {
    const int w = index >> 5;
    const int yl = y0 - lane;
    uint32_t hi = 0, lo = 0;
    if (yl > 0) {  // row 0 never moves
      hi = bitsb[(size_t)yl * W + w];
      lo = w > 0 ? bitsb[(size_t)yl * W + w - 1] : 0u;
    }
    const int rows = min(32, y0 + 1);
    for (int j = 0; j < rows; ++j) {
      const int y = y0 - j;
      const uint32_t h = __shfl_sync(FULL, hi, j), l = __shfl_sync(FULL, lo, j);
      if (lane == 0) pathb[(size_t)index * T_y + y] = 1.f;
      // index has fallen at most j <= 31 below the chunk's start: its word
      // is w or w - 1
      const uint32_t wd = (index >> 5) == w ? h : l;
      const bool bit = (wd >> (index & 31)) & 1u;
      const bool move = index != 0 && (index == y || bit) && y > 0;
      index -= move ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// lp, path: (B, T_x, T_y) f32 contiguous, path zeroed; t_xs, t_ys: (B,)
// int32; bits: (B, T_y, ceil(T_x / 32)) 32-bit words of scratch. threads:
// a multiple of 32, at most 1024, with threads * MAX_CHUNKS >= T_x.
// Returns cudaGetLastError() after the launch.
int mas_launch(const float* lp, const int* t_xs, const int* t_ys, uint32_t* bits,
               float* path, int B, int T_x, int T_y, int threads, void* stream) {
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  const int chunks = (T_x + threads - 1) / threads;
  if (chunks > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  mas_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(lp, t_xs, t_ys, bits, path, T_x, T_y,
                                                       chunks);
  return (int)cudaGetLastError();
}

const char* mas_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
