// One whole HiFi-GAN multi-receptive-field (MRF) stage on channels-last
// activations, fused, for sm_90a.
//
// Replaces matcha_tpu/ops/mrf_pallas.py::fused_mrf_stage_phase (the
// phase-packed Pallas TPU kernel) for C <= 64: the same function as
// csrc/mrf_stage.cu (per ResBlock1 chain and dilation: leaky(0.1) ->
// dilated 'same' conv -> re-zero outside [0, T) -> leaky -> d=1 conv ->
// re-zero -> residual add; the mean of the chains), on x and y of shape
// (B, T, C).
//
// The TPU kernel packs P = 128 // C time phases onto the channel axis so
// that each conv's product has 128 rows for the 128-row matrix unit, and
// pays for it by building a |O| * C-row operand per conv. This card needs
// no packing: time is the M side of every product, so a 128-sample strip
// fills a warp (and later a 64-row wgmma tile) whatever C is, and a tap is
// a whole-row offset into a shared buffer. No operand is concatenated.
//
// What bounds it: f32 FMA throughput, as for K1 (about 1 MFLOP per output
// sample at C = 64 against 8 bytes of input and output). The design:
//
//   * One thread block per (time tile, batch row). The tile plus a halo of
//     HALO = 64 rows per side (the stage's receptive field is 60) lives in
//     two shared buffers of E = t_tile + 128 rows: the chain state xb and
//     the conv-1 output hb. Conv 1 reads leaky(xb) and writes hb; conv 2
//     reads hb and adds into xb in place. Only the central t_tile rows are
//     exact and only they are written out.
//   * A row holds the C channels of one time step, padded to a stride of
//     S = C + 1 floats. Lanes walk time, so the 32 lanes of a load read 32
//     rows: with an even stride (S = C) they would all hit one bank; with
//     an odd one they hit 32 different banks.
//   * The buffers are laid out [MARGIN][xb][MARGIN][hb][MARGIN] rows, the
//     margin rows zero: a tap that reaches past the window reads 0 (the
//     Pallas kernel's zero-filled shift) without a bounds check, and the
//     middle band serves both buffers.
//   * A warp computes a 128 (time) x 16 (out channels) tile of one conv,
//     each lane 4 x 16 outputs in registers. Per (input channel, tap) a
//     lane reads 4 activations from shared memory and 16 weights as four
//     warp-uniform float4 loads of K1's [tap][c_in][c_out] buffer, then
//     issues 64 FMAs.
//   * The tile size follows from the shared-memory budget: t_tile = 256 at
//     C = 64, 640 at C = 32, 1408 at C = 16.
//   * After a chain, the block adds its central rows into the output tensor
//     in one pass of consecutive addresses (channels-last rows are
//     contiguous), dividing by the number of chains after the last.

#include <cuda_runtime.h>

#define HALO 64
#define MARGIN 32
#define TCO 16
#define TT 4
#define MAX_BLOCKS 4
#define MAX_DIL 4
#define MAX_THREADS 384
#define MAX_CHANNELS 64

struct MrfConfig {
    int n_blocks;
    int n_dil;
    int k[MAX_BLOCKS];
    int d[MAX_BLOCKS][MAX_DIL];
    long long w_off[MAX_BLOCKS][4];  // W1, B1, W2, B2 offsets in the weight buffer
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.1f * v; }

// One 'same' conv over the whole window. src and dst point at row 0 of
// their buffer (the first row after the margin). CONV1: reads leaky(src),
// stores leaky(masked conv) into dst. !CONV1: adds the masked conv into dst
// (the chain state).
template <bool CONV1, int K>
__device__ __forceinline__ void conv_pass(
    const float* src, float* dst, const float* __restrict__ wt, const float* __restrict__ bias,
    int C, int S, int E, int d, int g0, int T)
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
            const float* scol = src + e0 * S + ci;
            const float* wrow = wt + (size_t)ci * C + co0;
#pragma unroll
            for (int tap = 0; tap < K; ++tap) {
                const int off = (tap - c0) * d;
                float a[TT];
#pragma unroll
                for (int j = 0; j < TT; ++j) {
                    const float v = scol[(off + 32 * j) * S];
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
                const float v = (g >= 0 && g < T) ? acc[i][j] + bv : 0.f;
                float* p = dst + e * S + co;
                if (CONV1) {
                    *p = leaky(v);
                } else {
                    *p += v;
                }
            }
        }
    }
}

// HiFi-GAN's kernel sizes (v1 and v2); the launch refuses any other.
template <bool CONV1>
__device__ __forceinline__ void conv_dispatch(
    const float* src, float* dst, const float* __restrict__ wt, const float* __restrict__ bias,
    int C, int S, int E, int k, int d, int g0, int T)
{
    switch (k) {
        case 3:
            conv_pass<CONV1, 3>(src, dst, wt, bias, C, S, E, d, g0, T);
            break;
        case 7:
            conv_pass<CONV1, 7>(src, dst, wt, bias, C, S, E, d, g0, T);
            break;
        case 11:
            conv_pass<CONV1, 11>(src, dst, wt, bias, C, S, E, d, g0, T);
            break;
    }
}

extern "C" __global__ void __launch_bounds__(MAX_THREADS)
mrf_phase_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                 int C, int T, int t_tile, MrfConfig cfg)
{
    extern __shared__ float smem[];
    const int E = t_tile + 2 * HALO;
    const int S = C + 1;
    float* xb = smem + MARGIN * S;               // rows [MARGIN, MARGIN + E)
    float* hb = smem + (E + 2 * MARGIN) * S;     // rows [E + 2 MARGIN, 2 E + 2 MARGIN)
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * t_tile;          // global position of the first central row
    const int g0 = t0 - HALO;                    // global position of window row 0
    const float* xg = x + (size_t)b * T * C;
    float* yg = y + (size_t)b * T * C;

    // zero the three margin bands once; nothing writes them later
    for (int i = threadIdx.x; i < 3 * MARGIN * S; i += blockDim.x) {
        const int band = i / (MARGIN * S);
        smem[band * (E + MARGIN) * S + i % (MARGIN * S)] = 0.f;
    }

    for (int blk = 0; blk < cfg.n_blocks; ++blk) {
        const int k = cfg.k[blk];
        const float* W1 = w + cfg.w_off[blk][0];
        const float* B1 = w + cfg.w_off[blk][1];
        const float* W2 = w + cfg.w_off[blk][2];
        const float* B2 = w + cfg.w_off[blk][3];

        __syncthreads();  // the previous chain is done with xb and hb
        for (int i = threadIdx.x; i < E * C; i += blockDim.x) {
            const int r = i / C;
            const int c = i - r * C;
            const int g = g0 + r;
            xb[r * S + c] = (g >= 0 && g < T) ? xg[(size_t)g * C + c] : 0.f;
        }
        __syncthreads();

        for (int j = 0; j < cfg.n_dil; ++j) {
            conv_dispatch<true>(xb, hb, W1 + (size_t)j * k * C * C, B1 + j * C, C, S, E, k,
                                cfg.d[blk][j], g0, T);
            __syncthreads();
            conv_dispatch<false>(hb, xb, W2 + (size_t)j * k * C * C, B2 + j * C, C, S, E, k, 1,
                                 g0, T);
            __syncthreads();
        }

        // fold this chain's central rows into the output
        const int rows = min(t_tile, T - t0);
        for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
            const int r = i / C;
            const int c = i - r * C;
            float* o = yg + (size_t)t0 * C + i;
            float v = xb[(HALO + r) * S + c];
            if (blk > 0) v = *o + v;
            if (blk == cfg.n_blocks - 1) v = v / (float)cfg.n_blocks;
            *o = v;
        }
    }
}

// Launches the stage on `stream`. x, y: (B, T, C) f32 contiguous; w: the
// stage's weights packed per block as W1 (n_dil, k, C, C), B1 (n_dil, C),
// W2 (n_dil, k, C, C), B2 (n_dil, C), as for mrf_stage_launch. ks, dils:
// host arrays (n_blocks,) and (n_blocks, n_dil). Returns the CUDA error
// code of the launch.
extern "C" int mrf_phase_launch(const float* x, const float* w, float* y, int B, int C, int T,
                                int t_tile, int n_blocks, int n_dil, const int* ks,
                                const int* dils, int threads, void* stream)
{
    if (n_blocks < 1 || n_blocks > MAX_BLOCKS || n_dil < 1 || n_dil > MAX_DIL ||
        C % TCO != 0 || C > MAX_CHANNELS || t_tile % (32 * TT) != 0 ||
        threads > MAX_THREADS || threads % 32 != 0)
        return (int)cudaErrorInvalidValue;
    MrfConfig cfg;
    cfg.n_blocks = n_blocks;
    cfg.n_dil = n_dil;
    long long off = 0;
    for (int b = 0; b < n_blocks; ++b) {
        if (ks[b] != 3 && ks[b] != 7 && ks[b] != 11) return (int)cudaErrorInvalidValue;
        cfg.k[b] = ks[b];
        for (int j = 0; j < n_dil; ++j) {
            cfg.d[b][j] = dils[b * n_dil + j];
            if ((ks[b] - 1) / 2 * cfg.d[b][j] > MARGIN) return (int)cudaErrorInvalidValue;
        }
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
    const size_t smem = (size_t)(2 * E + 3 * MARGIN) * (C + 1) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(mrf_phase_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T + t_tile - 1) / t_tile, B);
    mrf_phase_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(x, w, y, C, T, t_tile, cfg);
    return (int)cudaGetLastError();
}

extern "C" const char* mrf_phase_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
