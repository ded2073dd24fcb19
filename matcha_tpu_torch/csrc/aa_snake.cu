// One whole anti-aliased SnakeBeta activation (BigVGAN's Activation1d) on
// Hopper (sm_90a), f32, in one pass.
//
// Replaces no TPU kernel: the JAX package has no BigVGAN. It exists because
// BigVGAN-v2 runs 18 of these activations per upsampling stage and one
// after the last, and PyTorch runs each as some ten launches (two replicate
// pads, a depthwise transposed conv, a slice copy, the snake's elementwise
// ops, a depthwise conv), each reading and writing the 2x-rate signal.
// ops/aa_snake.py::aa_snake_reference is the plain version.
//
// Per channel c of x (B, C, L), channels first, with p the input sample:
//   u[2p]     = 2 sum_j h_up[11 - 2j] x[clamp(p - 3 + j)],  j = 0..5
//   u[2p + 1] = 2 sum_j h_up[10 - 2j] x[clamp(p - 2 + j)]
//          (replicate pad 5, transposed conv at stride 2, 15 cut each end;
//          clamp to [0, L - 1])
//   v[m] = u[m] + inv_mag[c] sin(u[m] freq[c])^2,  m in [0, 2L)
//   y[q] = sum_k h_down[k] v[clamp(2q + k - 5, 0, 2L - 1)],  k = 0..11
//          (replicate pad 5 left, 6 right, conv at stride 2)
// The edges are the published ones exactly: Up replicates x's edge, Down
// replicates the activated signal's edge. A position m < 0 of Down's pad
// reads v[0], the even sample of pair p = 0; m > 2L - 1 reads v[2L - 1],
// the odd sample of pair p = L - 1.
//
// What bounds it on this card: bytes. Per output sample it reads 4 bytes
// and writes 4, against two Up dots of 6 taps, two sines and a 12-tap Down
// dot (~58 FLOPs), below the card's 20 f32 FLOPs a byte; but only if the
// instructions per sample stay few (at 8 bytes a sample the memory allows
// ~80 instructions a sample). The design:
//   * A tile is (row b*C + c, TQ = 1024 outputs). A persistent grid of
//     BLOCKS_PER_SM blocks of 256 threads per SM walks the tiles in strides.
//     For each it reads x[q0 - 6 .. q0 + TQ + 9] once, clamped at the row's
//     ends, into shared memory (coalesced), and while it computes one tile
//     the next tile's inputs are already in flight into registers (one tile
//     per block at a time left the loads unoverlapped). A block advances its
//     tile's (row, channel, tile in the row) by carries: two 64-bit
//     divisions a tile cost as much as the arithmetic.
//   * Phase 1, by pairs: pair i (p = q0 - 3 + i, i in [0, TQ + 8)) gives
//     E[i] = v at position 2p and O[i] = v at 2p + 1 (clamped as above). A
//     thread takes 4 consecutive pairs from one window of 10 inputs (three
//     float4 shared loads), so every tap index is a constant and the 24
//     taps live in registers.
//   * Phase 2: output t = q - q0 is sum_j h_down[2j] O[t + j] + h_down[2j+1]
//     E[t + j + 1]; a thread takes 4 consecutive outputs from 12 of E and
//     12 of O (six float4 shared loads) and stores them as one float4 when
//     the row length is a multiple of 4.
//   * The sine: |freq u| is not bounded, so it is reduced to [-pi, pi]
//     first (two FMAs against 2 pi split in two floats), then __sinf (the
//     SFU, absolute error 2^-21.4 there). sinf's general path costs ~40
//     instructions and a stack frame; it held K4 to 25 % of its bound.
//   * The filters come in as device pointers (12 floats each), so no call
//     copies anything from the host and a CUDA graph captures the launch.
//     Up's taps are doubled (2 h x is exact as 2 (h x)).
//   * The halo costs 8 pairs of 1032 and 16 loads of 1040.

#include <cuda_runtime.h>

namespace {

constexpr int TAPS = 12;     // the Kaiser-sinc filter's length (Up and Down)
constexpr int PAD = 5;       // Up's replicate pad of x; Down's left pad of v
constexpr int TQ = 1024;     // output samples per block (ops/aa_snake.py TILE)
constexpr int THREADS = 256;
constexpr int R = 4;                         // pairs, then outputs, per thread and step
constexpr int XOFF = PAD + 1;                // xs[i] = x[clamp(q0 - XOFF + i)]
constexpr int NPAIR = TQ + 8;                // pairs i in [0, NPAIR), a multiple of R
constexpr int NX = NPAIR + 8;                // inputs a block reads (three float4 past 4g)
constexpr int NGROUP = NPAIR / R;
constexpr int PER_THREAD = (NX + THREADS - 1) / THREADS;  // prefetched inputs per thread
constexpr int BLOCKS_PER_SM = 4;  // resident at <= 64 registers a thread
constexpr float TWO_PI_HI = 6.28318548202514648f;   // 2 pi rounded to float
constexpr float TWO_PI_LO = -1.74845553e-7f;        // 2 pi - TWO_PI_HI
constexpr float INV_TWO_PI = 0.159154943091895336f;

__device__ __forceinline__ float snake(float u, float a, float ib)
{
    const float z = u * a;
    const float k = rintf(z * INV_TWO_PI);
    const float r = fmaf(-k, TWO_PI_LO, fmaf(-k, TWO_PI_HI, z));
    const float s = __sinf(r);
    return fmaf(ib, s * s, u);
}

}  // namespace

// A tile's place: its row b*C + c, the row's channel c, and its first
// output q0. A block walks tiles blockIdx.x, + gridDim.x, ...; the place
// advances by (rows, tiles) = divmod(gridDim.x, n_tiles) and carries, so no
// thread divides per tile.
struct Place {
    int row, c, tq;
};

struct Stride {
    int rows, c, tq;
};

__device__ __forceinline__ Place advance(Place t, Stride s, int n_tiles, int C)
{
    t.tq += s.tq;
    int carry = t.tq >= n_tiles;
    t.tq -= carry * n_tiles;
    t.row += s.rows + carry;
    t.c += s.c + carry;
    t.c -= (t.c >= C) * C;
    return t;
}

__device__ __forceinline__ void prefetch(float (&pre)[PER_THREAD], const float* __restrict__ x,
                                         Place t, int L)
{
    const float* xr = x + (long long)t.row * L;
    const int q0 = t.tq * TQ;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        const int i = threadIdx.x + k * THREADS;
        if (i < NX) pre[k] = __ldg(xr + min(max(q0 - XOFF + i, 0), L - 1));
    }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
aa_snake_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ freq, const float* __restrict__ inv_mag,
                const float* __restrict__ h_up, const float* __restrict__ h_down,
                int C, int L, int n_tiles, int n_total)
{
    __shared__ __align__(16) float xs[NX];
    __shared__ __align__(16) float E[NPAIR];
    __shared__ __align__(16) float O[NPAIR];

    float hu[TAPS], hd[TAPS];
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
        hu[k] = 2.0f * __ldg(h_up + k);
        hd[k] = __ldg(h_down + k);
    }
    const int b = (int)blockIdx.x, grid = (int)gridDim.x;
    const Stride step = {grid / n_tiles, (grid / n_tiles) % C, grid % n_tiles};
    Place place = {b / n_tiles, (b / n_tiles) % C, b % n_tiles};
    float pre[PER_THREAD];
    prefetch(pre, x, place, L);

    for (int tile = b; tile < n_total; tile += grid) {
        const int row = place.row, c = place.c, q0 = place.tq * TQ;
        // the previous tile's phase 1 read xs before the barrier its phase 2
        // began with, so xs is free; E and O are free after this barrier
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
            const int i = threadIdx.x + k * THREADS;
            if (i < NX) xs[i] = pre[k];
        }
        const float a = __ldg(freq + c), ib = __ldg(inv_mag + c);
        __syncthreads();
        place = advance(place, step, n_tiles, C);
        if (tile + grid < n_total) prefetch(pre, x, place, L);

        // phase 1: E[i], O[i] for the pairs i = 4g .. 4g + 3, p = q0 - 3 + i
        for (int g = threadIdx.x; g < NGROUP; g += THREADS) {
            const int i0 = R * g, p0 = q0 - 3 + i0;
            float ev[R], ov[R];
            if (p0 >= 0 && p0 + R - 1 <= L - 1) {  // every pair inside the row
                float w[12];
                const float4* w4 = reinterpret_cast<const float4*>(xs + i0);
#pragma unroll
                for (int v = 0; v < 3; ++v) {
                    const float4 t = w4[v];
                    w[4 * v] = t.x; w[4 * v + 1] = t.y; w[4 * v + 2] = t.z; w[4 * v + 3] = t.w;
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {  // pair i0 + r reads x[p - 3 .. p + 3] = w[r .. r + 6]
                    float ue = 0.0f, uo = 0.0f;
#pragma unroll
                    for (int j = 0; j < 6; ++j) {
                        ue = fmaf(hu[11 - 2 * j], w[r + j], ue);
                        uo = fmaf(hu[10 - 2 * j], w[r + 1 + j], uo);
                    }
                    ev[r] = snake(ue, a, ib);
                    ov[r] = snake(uo, a, ib);
                }
            } else {  // a row end: pairs outside [0, L) stand for v[0] or v[2L - 1]
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int p = p0 + r, pc = min(max(p, 0), L - 1);
                    const float* w = xs + (pc - q0 + XOFF - 3);
                    float ue = 0.0f, uo = 0.0f;
#pragma unroll
                    for (int j = 0; j < 6; ++j) {
                        ue = fmaf(hu[11 - 2 * j], w[j], ue);
                        uo = fmaf(hu[10 - 2 * j], w[j + 1], uo);
                    }
                    const float ve = snake(ue, a, ib), vo = snake(uo, a, ib);
                    ev[r] = p > L - 1 ? vo : ve;
                    ov[r] = p < 0 ? ve : vo;
                }
            }
            reinterpret_cast<float4*>(E)[g] = make_float4(ev[0], ev[1], ev[2], ev[3]);
            reinterpret_cast<float4*>(O)[g] = make_float4(ov[0], ov[1], ov[2], ov[3]);
        }
        __syncthreads();

        // phase 2: outputs t = 4 tau .. 4 tau + 3 of the tile
        const int t0 = R * threadIdx.x;
        if (q0 + t0 < L) {
            float e[12], o[12];
            const float4* e4 = reinterpret_cast<const float4*>(E + t0);
            const float4* o4 = reinterpret_cast<const float4*>(O + t0);
#pragma unroll
            for (int v = 0; v < 3; ++v) {
                const float4 te = e4[v], to = o4[v];
                e[4 * v] = te.x; e[4 * v + 1] = te.y; e[4 * v + 2] = te.z; e[4 * v + 3] = te.w;
                o[4 * v] = to.x; o[4 * v + 1] = to.y; o[4 * v + 2] = to.z; o[4 * v + 3] = to.w;
            }
            float out[R];
#pragma unroll
            for (int s = 0; s < R; ++s) {
                float acc = 0.0f;
#pragma unroll
                for (int j = 0; j < 6; ++j) {
                    acc = fmaf(hd[2 * j], o[s + j], acc);
                    acc = fmaf(hd[2 * j + 1], e[s + j + 1], acc);
                }
                out[s] = acc;
            }
            float* yr = y + (long long)row * L + q0 + t0;
            if ((L & 3) == 0) {  // L % 4 == 0: the row and the tile start on 16 bytes
                *reinterpret_cast<float4*>(yr) = make_float4(out[0], out[1], out[2], out[3]);
            } else {
#pragma unroll
                for (int s = 0; s < R; ++s)
                    if (q0 + t0 + s < L) yr[s] = out[s];
            }
        }
    }
}

extern "C" int aa_snake_launch(const float* x, float* y, const float* freq, const float* inv_mag,
                               const float* h_up, const float* h_down, long long rows, int C,
                               int L, void* stream)
{
    if (rows < 1 || C < 1 || L < 1 || rows % C != 0) return (int)cudaErrorInvalidValue;
    const int n_tiles = (L + TQ - 1) / TQ;
    if (rows * n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int n_total = (int)(rows * n_tiles);
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int blocks = n_total < sms * BLOCKS_PER_SM ? n_total : sms * BLOCKS_PER_SM;
    aa_snake_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        x, y, freq, inv_mag, h_up, h_down, C, L, n_tiles, n_total);
    return (int)cudaGetLastError();
}

extern "C" const char* aa_snake_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
