// One whole HiFi-GAN multi-receptive-field (MRF) stage, fused, for sm_90a.
//
// Replaces matcha_tpu/ops/mrf_pallas.py::fused_mrf_stage (the Pallas TPU
// kernel). For each ResBlock1 chain (kernel size k, dilations d_j), per
// dilation: leaky(0.1) -> dilated 'same' conv -> re-zero outside [0, T)
// -> leaky(0.1) -> d=1 conv -> re-zero -> residual add. The stage output
// is the mean of the chains. Re-zeroing after EVERY conv reproduces the
// per-conv zero padding at the true sequence edges.
//
// What bounds it: f32 FMA throughput. At C = 64 the stage is about
// 1 MFLOP per output sample against 8 bytes of input and output, so the
// activation traffic is negligible and the design spends its shared
// memory on keeping the whole chain of 18 convs on chip:
//
//   * One thread block per (time tile, batch row). The tile plus a halo of
//     HALO = 64 samples per side (the stage's receptive field is 60) lives
//     in two shared-memory buffers of C x E floats, E = t_tile + 128: the
//     chain state xb and the conv-1 output hb. Conv 1 reads leaky(xb) and
//     writes hb; conv 2 reads hb and adds into xb in place. Only the
//     central t_tile samples are exact and only they are written out.
//   * Each buffer row carries MARGIN zero columns per side, so a tap that
//     reaches past the window reads 0 (the Pallas kernel's zero-filled
//     shift) without a bounds check in the inner loop.
//   * The tile size follows from the shared-memory budget: two buffers of
//     C x (E + 2 * MARGIN) f32 within the 227 KB a block may use gives
//     E = 384 (t_tile = 256) at C = 64 and E = 768 (t_tile = 640) at
//     C = 32. The halo is recomputed by neighbouring tiles: 1/3 of the
//     arithmetic at C = 64, 1/6 at C = 32.
//   * A warp computes a 16 (out channels) x 128 (time) tile of one conv,
//     each lane 16 x 4 outputs in registers. Per (input channel, tap) a
//     lane reads 4 activations from shared memory (consecutive lanes,
//     consecutive addresses: no bank conflicts) and 16 weights as four
//     warp-uniform float4 loads, then issues 64 FMAs.
//   * Weights (126 C^2 floats, 2 MB at C = 64) do not fit on chip; they
//     are read through L1/L2 in the layout [tap][c_in][c_out].
//   * The chain sum is accumulated in the output tensor: each block owns
//     its central tile, and the same thread writes the same outputs for
//     every chain, so no synchronisation is needed for it.
//   * Above C = 80 two buffers no longer fit with a 128-sample tile. Then
//     (HB_GLOBAL) only xb stays in shared memory and hb lives in a global
//     scratch region of the block's own, C x (E + 2 * MARGIN) f32 (229 KB
//     at C = 128, t_tile 256): conv 1 writes it once and conv 2 reads it
//     k times per output, mostly from L2. C = 32 and C = 64 keep both
//     buffers in shared memory.

#include <cuda_runtime.h>

#define HALO 64
#define MARGIN 32
#define TCO 16
#define TT 4
#define MAX_BLOCKS 4
#define MAX_DIL 4
#define MAX_THREADS 384

struct MrfConfig {
    int n_blocks;
    int n_dil;
    int k[MAX_BLOCKS];
    int d[MAX_BLOCKS][MAX_DIL];
    long long w_off[MAX_BLOCKS][4];  // W1, B1, W2, B2 offsets in the weight buffer
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.1f * v; }

// One 'same' conv over the whole window. CONV1: reads leaky(src), stores
// leaky(masked conv) into dst. !CONV1: adds the masked conv into dst (the
// chain state) and, when out_mode > 0, folds the new chain state of the
// central tile into the output: 1 = first chain, 2 = middle chain, 3 = last
// chain (then divided by n_blocks).
//
// K is the kernel size, fixed at compile time so that the tap loop
// unrolls and the loads of several taps are in flight together.
template <bool CONV1, int K>
__device__ __forceinline__ void conv_pass(
    const float* src, float* dst, const float* __restrict__ wt, const float* __restrict__ bias,
    int C, int E, int W, int d, int g0, int T, int t_tile,
    float* __restrict__ yg, int out_mode, int n_blocks)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int n_tc = E / (32 * TT);
    const int n_items = (C / TCO) * n_tc;
    const int c0 = (K - 1) / 2;

    for (int item = warp; item < n_items; item += nwarps) {
        const int co0 = (item / n_tc) * TCO;
        const int e0 = (item % n_tc) * (32 * TT) + lane;

        float acc[TCO][TT];
#pragma unroll
        for (int i = 0; i < TCO; ++i)
#pragma unroll
            for (int j = 0; j < TT; ++j) acc[i][j] = 0.f;

        for (int ci = 0; ci < C; ++ci) {
            const float* srow = src + ci * W + MARGIN + e0;
            const float* wrow = wt + (size_t)ci * C + co0;
#pragma unroll
            for (int tap = 0; tap < K; ++tap) {
                const int off = (tap - c0) * d;
                float a[TT];
#pragma unroll
                for (int j = 0; j < TT; ++j) {
                    const float v = srow[off + 32 * j];
                    a[j] = CONV1 ? leaky(v) : v;
                }
                const float4* wp = reinterpret_cast<const float4*>(wrow + (size_t)tap * C * C);
                float wv[TCO];
#pragma unroll
                for (int q = 0; q < TCO / 4; ++q) {
                    const float4 w4 = __ldg(wp + q);
                    wv[4 * q] = w4.x;
                    wv[4 * q + 1] = w4.y;
                    wv[4 * q + 2] = w4.z;
                    wv[4 * q + 3] = w4.w;
                }
#pragma unroll
                for (int i = 0; i < TCO; ++i)
#pragma unroll
                    for (int j = 0; j < TT; ++j) acc[i][j] = fmaf(wv[i], a[j], acc[i][j]);
            }
        }

#pragma unroll
        for (int i = 0; i < TCO; ++i) {
            const int co = co0 + i;
            const float bv = bias[co];
#pragma unroll
            for (int j = 0; j < TT; ++j) {
                const int e = e0 + 32 * j;
                const int g = g0 + e;
                const bool valid = g >= 0 && g < T;
                const float v = valid ? acc[i][j] + bv : 0.f;
                float* p = dst + co * W + MARGIN + e;
                if (CONV1) {
                    *p = leaky(v);
                } else {
                    const float nx = *p + v;
                    *p = nx;
                    if (out_mode > 0 && valid && e >= HALO && e < HALO + t_tile) {
                        float* o = yg + (size_t)co * T + g;
                        if (out_mode == 1) {
                            *o = n_blocks == 1 ? nx / (float)n_blocks : nx;
                        } else if (out_mode == 2) {
                            *o = *o + nx;
                        } else {
                            *o = (*o + nx) / (float)n_blocks;
                        }
                    }
                }
            }
        }
    }
}

// HiFi-GAN's kernel sizes (v1 and v2); the launch refuses any other.
template <bool CONV1>
__device__ __forceinline__ void conv_dispatch(
    const float* src, float* dst, const float* __restrict__ wt, const float* __restrict__ bias,
    int C, int E, int W, int k, int d, int g0, int T, int t_tile,
    float* __restrict__ yg, int out_mode, int n_blocks)
{
    switch (k) {
        case 3:
            conv_pass<CONV1, 3>(src, dst, wt, bias, C, E, W, d, g0, T, t_tile, yg, out_mode, n_blocks);
            break;
        case 7:
            conv_pass<CONV1, 7>(src, dst, wt, bias, C, E, W, d, g0, T, t_tile, yg, out_mode, n_blocks);
            break;
        case 11:
            conv_pass<CONV1, 11>(src, dst, wt, bias, C, E, W, d, g0, T, t_tile, yg, out_mode, n_blocks);
            break;
    }
}

// HB_GLOBAL: hb is the block's own region of `hscratch` (C x W f32 per
// block) instead of the second half of shared memory.
template <bool HB_GLOBAL>
__global__ void __launch_bounds__(MAX_THREADS)
mrf_stage_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                 float* hscratch, int C, int T, int t_tile, MrfConfig cfg)
{
    extern __shared__ float smem[];
    const int E = t_tile + 2 * HALO;
    const int W = E + 2 * MARGIN;
    float* xb = smem;
    float* hb = HB_GLOBAL
        ? hscratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * C * W
        : smem + C * W;
    const int b = blockIdx.y;
    const int g0 = blockIdx.x * t_tile - HALO;  // global position of window column 0
    const float* xg = x + (size_t)b * C * T;
    float* yg = y + (size_t)b * C * T;

    // zero the margin columns of both buffers once; nothing writes them later
    for (int i = threadIdx.x; i < C * 2 * MARGIN; i += blockDim.x) {
        const int row = i / (2 * MARGIN);
        const int m = i % (2 * MARGIN);
        const int col = m < MARGIN ? m : E + m;
        xb[row * W + col] = 0.f;
        hb[row * W + col] = 0.f;
    }

    for (int blk = 0; blk < cfg.n_blocks; ++blk) {
        const int k = cfg.k[blk];
        const float* W1 = w + cfg.w_off[blk][0];
        const float* B1 = w + cfg.w_off[blk][1];
        const float* W2 = w + cfg.w_off[blk][2];
        const float* B2 = w + cfg.w_off[blk][3];
        const int out_mode = blk == 0 ? 1 : (blk == cfg.n_blocks - 1 ? 3 : 2);

        __syncthreads();  // the previous chain is done with xb and hb
        for (int i = threadIdx.x; i < C * E; i += blockDim.x) {
            const int row = i / E;
            const int e = i % E;
            const int g = g0 + e;
            xb[row * W + MARGIN + e] = (g >= 0 && g < T) ? xg[(size_t)row * T + g] : 0.f;
        }
        __syncthreads();

        for (int j = 0; j < cfg.n_dil; ++j) {
            conv_dispatch<true>(xb, hb, W1 + (size_t)j * k * C * C, B1 + j * C, C, E, W, k,
                                cfg.d[blk][j], g0, T, t_tile, yg, 0, cfg.n_blocks);
            __syncthreads();
            conv_dispatch<false>(hb, xb, W2 + (size_t)j * k * C * C, B2 + j * C, C, E, W, k, 1,
                                 g0, T, t_tile, yg, j == cfg.n_dil - 1 ? out_mode : 0,
                                 cfg.n_blocks);
            __syncthreads();
        }
    }
}

// Launches the stage on `stream`. x, y: (B, C, T) f32 contiguous; w: the
// stage's weights packed per block as W1 (n_dil, k, C, C), B1 (n_dil, C),
// W2 (n_dil, k, C, C), B2 (n_dil, C). ks, dils: host arrays (n_blocks,)
// and (n_blocks, n_dil). hscratch: null to keep both buffers in shared
// memory, else B * ceil(T / t_tile) * C * (t_tile + 2 * HALO + 2 * MARGIN)
// f32 of device memory for hb. Returns the CUDA error code of the launch.
extern "C" int mrf_stage_launch(const float* x, const float* w, float* y, float* hscratch,
                                int B, int C, int T, int t_tile, int n_blocks, int n_dil,
                                const int* ks, const int* dils, int threads, void* stream)
{
    if (n_blocks < 1 || n_blocks > MAX_BLOCKS || n_dil < 1 || n_dil > MAX_DIL ||
        C % TCO != 0 || t_tile % (32 * TT) != 0 || threads > MAX_THREADS || threads % 32 != 0)
        return (int)cudaErrorInvalidValue;
    MrfConfig cfg;
    cfg.n_blocks = n_blocks;
    cfg.n_dil = n_dil;
    long long off = 0;
    for (int b = 0; b < n_blocks; ++b) {
        if (ks[b] != 3 && ks[b] != 7 && ks[b] != 11) return (int)cudaErrorInvalidValue;
        cfg.k[b] = ks[b];
        for (int j = 0; j < n_dil; ++j) cfg.d[b][j] = dils[b * n_dil + j];
        const long long wsize = (long long)n_dil * ks[b] * C * C;
        cfg.w_off[b][0] = off;
        off += wsize;
        cfg.w_off[b][1] = off;
        off += (long long)n_dil * C;
        cfg.w_off[b][2] = off;
        off += wsize;
        cfg.w_off[b][3] = off;
        off += (long long)n_dil * C;
    }
    const int E = t_tile + 2 * HALO;
    const size_t smem = (hscratch ? 1ull : 2ull) * C * (E + 2 * MARGIN) * sizeof(float);
    void (*kernel)(const float*, const float*, float*, float*, int, int, int, MrfConfig) =
        hscratch ? mrf_stage_kernel<true> : mrf_stage_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T + t_tile - 1) / t_tile, B);
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(x, w, y, hscratch, C, T, t_tile, cfg);
    return (int)cudaGetLastError();
}

extern "C" const char* mrf_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
