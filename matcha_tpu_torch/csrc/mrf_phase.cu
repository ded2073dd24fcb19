// One whole HiFi-GAN multi-receptive-field (MRF) stage on channels-last
// activations, fused, on Hopper's tensor cores (sm_90a).
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
// no packing: time is the M side of every product, so a 32-sample band
// fills a warp's two m16 tiles whatever C is, and a tap is a whole-row
// offset into a shared buffer. No operand is concatenated.
//
// What bounds it: the products, as for K1 (about 1 MFLOP per output
// sample at C = 64 against 8 bytes of input and output). The conv pass is
// K1's (csrc/mrf_stage.cu, whose header gives the reasons), copied here
// for C <= 64:
//
//   * Each conv is one product with time on M, C_out on N and (tap, C_in)
//     on K, in 3xTF32: every operand v is split into hi (v rounded to
//     TF32) and lo = v - hi, and a_lo b_hi + a_hi b_lo + a_hi b_hi is
//     accumulated in f32 by mma.sync.m16n8k8, so the stage keeps f32
//     accuracy.
//   * One thread block per (time tile, batch row). The tile plus a halo of
//     HALO = 64 rows per side lives in two shared buffers of E = t_tile +
//     128 rows, the chain state xb and the conv-1 output hb, laid out
//     [MARGIN][xb][MARGIN][hb][MARGIN][TAIL]; the margin rows are zero, so
//     a tap that reaches past the window reads 0. Rows are channels-last
//     at a stride of C + 4 floats, so the A-fragment loads fall on 32
//     distinct banks. Every conv re-zeroes its output outside [0, T).
//   * A warp owns a band of BAND = 32 time rows and all C_out (NT = C / 8
//     n8 tiles); B fragments are float4 (float2 at C = 16, 48) runs of the
//     packed [tap][c_in][c_out] buffer through the column permutation.
//   * The tile is K1's (ops/mrf.py::pick_t_tile): the same rows, so the
//     same shared-memory budget, and the fewest waves over the SMs.
//
// Where K3 differs from K1, because its activations are channels-last:
//
//   * The window load copies whole rows: a row of C floats in global
//     memory and a row of C + 4 in shared memory both start on 16 bytes,
//     so each thread moves one float4 per step, neighbouring threads on
//     neighbouring addresses. K1 gathers (C, T) columns into rows.
//   * The chain sum goes into the output in one pass over the central
//     rows of xb after each chain's last conv, again one float4 per
//     thread and step: an epilogue per accumulator, as K1 writes its
//     channels-first output, would store 4 scattered bytes per value in
//     this layout. The sum order is K1's (y = x_1, y + x_2, ..., then
//     (y + x_n) / n), and so is the conv pass, so the two kernels agree
//     bit for bit on the same input.

#include <cuda_runtime.h>
#include <stdint.h>

#define HALO 64
#define MARGIN 32     // zero rows per buffer side; >= the widest tap reach c0 * d
#define TILE_STEP 16  // t_tile granularity: one m16 tile
#define MAX_BLOCKS 4
#define MAX_DIL 4
#define MAX_THREADS 384
#define BAND 32       // time rows of one warp's work item: two m16 tiles
// rows after the last margin: the last band may reach BAND - 16 rows past
// the window; those rows are read but never stored
#define TAIL (BAND - TILE_STEP)

struct MrfConfig {
    int n_blocks;
    int n_dil;
    int k[MAX_BLOCKS];
    int d[MAX_BLOCKS][MAX_DIL];
    long long w_off[MAX_BLOCKS][4];  // W1, B1, W2, B2 offsets in the weight buffer
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.1f * v; }

// v = hi + lo. hi is v rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero: cvt.rna.tf32.f32's rounding, in two integer
// operations); lo is the exact remainder, of which the tensor core reads
// the TF32 bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo)
{
    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
}

// N consecutive floats from p, in the widest loads its alignment allows
template <int N>
__device__ __forceinline__ void load_run(const float* __restrict__ p, float (&v)[N])
{
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
            v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
        }
    } else if constexpr (N % 2 == 0) {
#pragma unroll
        for (int q = 0; q < N / 2; ++q) {
            const float2 f = __ldg(reinterpret_cast<const float2*>(p) + q);
            v[2 * q] = f.x; v[2 * q + 1] = f.y;
        }
    } else {
#pragma unroll
        for (int q = 0; q < N; ++q) v[q] = __ldg(p + q);
    }
}

// d += a (16 x 8, row major) * b (8 x 8, column major), TF32 in, f32 sum
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 'same' conv over the whole window. src and dst point at row 0 of
// their buffer. CONV1: reads leaky(src), stores leaky(masked conv) into
// dst. !CONV1: adds the masked conv into dst (the chain state). K is the
// kernel size, fixed at compile time so that the tap loop unrolls.
template <int C, bool CONV1, int K>
__device__ __forceinline__ void conv_pass(
    const float* src, float* dst, const float* __restrict__ wt, const float* __restrict__ bias,
    int E, int d, int g0, int T)
{
    constexpr int S = C + 4, NT = C / 8;
    constexpr int MT = BAND / 16;  // m16 tiles per warp item
    constexpr int c0 = (K - 1) / 2;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int gr = lane >> 2, tg = lane & 3;  // the fragments' group and thread-in-group
    const int n_items = (E + BAND - 1) / BAND;

    for (int item = warp; item < n_items; item += nwarps) {
        const int e0 = item * BAND;

        float acc[MT][NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

#pragma unroll 1
        for (int ci0 = 0; ci0 < C; ci0 += 8) {
            const float* arow = src + (e0 + gr) * S + ci0 + tg;
            const float* wrow = wt + (ci0 + tg) * C + gr * NT;
#pragma unroll
            for (int tap = 0; tap < K; ++tap) {
                const int off = (tap - c0) * d * S;
                uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    const float* p = arow + off + m * 16 * S;
                    const float v[4] = {p[0], p[8 * S], p[4], p[8 * S + 4]};
#pragma unroll
                    for (int q = 0; q < 4; ++q) split(CONV1 ? leaky(v[q]) : v[q], ahi[m][q], alo[m][q]);
                }
                const float* wp = wrow + tap * C * C;
                float wv0[NT], wv1[NT];
                load_run<NT>(wp, wv0);
                load_run<NT>(wp + 4 * C, wv1);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    uint32_t bhi0, blo0, bhi1, blo1;
                    split(wv0[n], bhi0, blo0);
                    split(wv1[n], bhi1, blo1);
#pragma unroll
                    for (int m = 0; m < MT; ++m) {
                        mma_tf32(acc[m][n], alo[m], bhi0, bhi1);
                        mma_tf32(acc[m][n], ahi[m], blo0, blo1);
                        mma_tf32(acc[m][n], ahi[m], bhi0, bhi1);
                    }
                }
            }
        }

        // accumulator q of tile (m, n): row e0 + 16 m + gr + 8 (q / 2),
        // column 2 tg + q % 2 of n8 tile n, which is output channel
        // (2 tg + q % 2) NT + n
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int co = (2 * tg + j) * NT + n;
                const float bv = __ldg(bias + co);
#pragma unroll
                for (int m = 0; m < MT; ++m) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int e = e0 + m * 16 + gr + 8 * h;
                        if (e >= E) continue;
                        const int g = g0 + e;
                        const float v = (g >= 0 && g < T) ? acc[m][n][2 * h + j] + bv : 0.f;
                        float* p = dst + e * S + co;
                        if (CONV1) {
                            *p = leaky(v);
                        } else {
                            *p = *p + v;
                        }
                    }
                }
            }
        }
    }
}

// HiFi-GAN's kernel sizes (v1 and v2); the launch refuses any other.
template <int C, bool CONV1>
__device__ __forceinline__ void conv_dispatch(
    const float* src, float* dst, const float* __restrict__ wt, const float* __restrict__ bias,
    int E, int k, int d, int g0, int T)
{
    switch (k) {
        case 3:
            conv_pass<C, CONV1, 3>(src, dst, wt, bias, E, d, g0, T);
            break;
        case 7:
            conv_pass<C, CONV1, 7>(src, dst, wt, bias, E, d, g0, T);
            break;
        case 11:
            conv_pass<C, CONV1, 11>(src, dst, wt, bias, E, d, g0, T);
            break;
    }
}

template <int C>
__global__ void __launch_bounds__(MAX_THREADS, 1)
mrf_phase_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                 int T, int t_tile, MrfConfig cfg)
{
    constexpr int S = C + 4, Q = C / 4;  // row stride in floats; float4s per row
    extern __shared__ __align__(16) float smem[];
    const int E = t_tile + 2 * HALO;
    float* xb = smem + MARGIN * S;               // rows [MARGIN, MARGIN + E) of shared memory
    float* hb = smem + (E + 2 * MARGIN) * S;     // rows [E + 2 MARGIN, 2 E + 2 MARGIN)
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * t_tile;          // global position of the first central row
    const int g0 = t0 - HALO;                    // global position of window row 0
    const float* xg = x + (size_t)b * T * C;
    float* yg = y + (size_t)b * T * C;

    // zero the margin rows around both buffers once; nothing writes them later
    for (int i = threadIdx.x; i < 2 * MARGIN * S; i += blockDim.x) {
        const int r = i % (MARGIN * S);
        const int base = i < MARGIN * S ? -MARGIN * S : E * S;
        xb[base + r] = 0.f;
        hb[base + r] = 0.f;
    }

    for (int blk = 0; blk < cfg.n_blocks; ++blk) {
        const int k = cfg.k[blk];
        const float* W1 = w + cfg.w_off[blk][0];
        const float* B1 = w + cfg.w_off[blk][1];
        const float* W2 = w + cfg.w_off[blk][2];
        const float* B2 = w + cfg.w_off[blk][3];

        __syncthreads();  // the previous chain is done with xb and hb
        // the window's rows, zero outside [0, T)
        for (int i = threadIdx.x; i < E * Q; i += blockDim.x) {
            const int r = i / Q;
            const int q = i - r * Q;
            const int g = g0 + r;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (g >= 0 && g < T) v = __ldg(reinterpret_cast<const float4*>(xg + (size_t)g * C) + q);
            *reinterpret_cast<float4*>(xb + r * S + 4 * q) = v;
        }
        __syncthreads();

        for (int j = 0; j < cfg.n_dil; ++j) {
            conv_dispatch<C, true>(xb, hb, W1 + (size_t)j * k * C * C, B1 + j * C, E, k,
                                   cfg.d[blk][j], g0, T);
            __syncthreads();
            conv_dispatch<C, false>(hb, xb, W2 + (size_t)j * k * C * C, B2 + j * C, E, k, 1, g0,
                                    T);
            __syncthreads();
        }

        // fold this chain's central rows into the output
        const int rows = min(t_tile, T - t0);
        const float n = (float)cfg.n_blocks;
        for (int i = threadIdx.x; i < rows * Q; i += blockDim.x) {
            const int r = i / Q;
            const int q = i - r * Q;
            float4 v = *reinterpret_cast<const float4*>(xb + (HALO + r) * S + 4 * q);
            float4* o = reinterpret_cast<float4*>(yg + (size_t)(t0 + r) * C) + q;
            if (blk > 0) {
                const float4 p = *o;
                v = make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
            }
            if (blk == cfg.n_blocks - 1) v = make_float4(v.x / n, v.y / n, v.z / n, v.w / n);
            *o = v;
        }
    }
}

template <int C>
static int launch(const float* x, const float* w, float* y, int B, int T, int t_tile,
                  const MrfConfig& cfg, int threads, cudaStream_t stream)
{
    const int E = t_tile + 2 * HALO;
    const size_t smem = (size_t)(2 * E + 3 * MARGIN + TAIL) * (C + 4) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(mrf_phase_kernel<C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T + t_tile - 1) / t_tile, B);
    mrf_phase_kernel<C><<<grid, threads, smem, stream>>>(x, w, y, T, t_tile, cfg);
    return (int)cudaGetLastError();
}

// Launches the stage on `stream`. x, y: (B, T, C) f32 contiguous, 16-byte
// aligned; w: the stage's weights packed per block as W1 (n_dil, k, C, C),
// B1 (n_dil, C), W2 (n_dil, k, C, C), B2 (n_dil, C), as for
// mrf_stage_launch. ks, dils: host arrays (n_blocks,) and (n_blocks,
// n_dil). C: 16, 32, 48 or 64. t_tile: a multiple of TILE_STEP whose two
// buffers fit the block's shared memory. Returns the CUDA error code of
// the launch.
extern "C" int mrf_phase_launch(const float* x, const float* w, float* y, int B, int C, int T,
                                int t_tile, int n_blocks, int n_dil, const int* ks,
                                const int* dils, int threads, void* stream)
{
    if (n_blocks < 1 || n_blocks > MAX_BLOCKS || n_dil < 1 || n_dil > MAX_DIL ||
        t_tile < TILE_STEP || t_tile % TILE_STEP != 0 || threads < 32 ||
        threads > MAX_THREADS || threads % 32 != 0 ||
        ((uintptr_t)x | (uintptr_t)y) % 16 != 0)
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
            if (cfg.d[b][j] < 1 || (ks[b] - 1) / 2 * cfg.d[b][j] > MARGIN)
                return (int)cudaErrorInvalidValue;
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
    const cudaStream_t s = (cudaStream_t)stream;
    switch (C) {
        case 16: return launch<16>(x, w, y, B, T, t_tile, cfg, threads, s);
        case 32: return launch<32>(x, w, y, B, T, t_tile, cfg, threads, s);
        case 48: return launch<48>(x, w, y, B, T, t_tile, cfg, threads, s);
        case 64: return launch<64>(x, w, y, B, T, t_tile, cfg, threads, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* mrf_phase_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
