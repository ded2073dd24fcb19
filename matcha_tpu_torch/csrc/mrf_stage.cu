// One whole HiFi-GAN multi-receptive-field (MRF) stage, fused, on Hopper's
// tensor cores (sm_90a).
//
// Replaces matcha_tpu/ops/mrf_pallas.py::fused_mrf_stage (the Pallas TPU
// kernel). For each ResBlock1 chain (kernel size k, dilations d_j), per
// dilation: leaky(0.1) -> dilated 'same' conv -> re-zero outside [0, T)
// -> leaky(0.1) -> d=1 conv -> re-zero -> residual add. The stage output
// is the mean of the chains. Re-zeroing after EVERY conv reproduces the
// per-conv zero padding at the true sequence edges.
//
// What bounds it on this card: the products. A stage is 126 C^2 multiply-
// adds per output sample (C = 64: ~1 MFLOP) against 8 bytes of input and
// output, so activation traffic is negligible. In 3xTF32 each product
// costs three TF32 tensor-core products (bound: 3 x FLOPs / 495 TFLOP/s),
// issued as warp-level mma.sync, and every operand needs a split; the
// weights (2 MB at C = 64) come from L2/L1 for every block. The design:
//
//   * Each conv is one product with time on M, C_out on N and (tap, C_in)
//     on K: out[e, co] = sum_tap sum_ci in[e + (tap - c0) d, ci] W[tap, ci, co].
//     A tap is a row offset into a channels-last buffer, so nothing is
//     copied (no im2col); mma.sync takes its operands from registers, so a
//     lane loads its A fragment at any row offset.
//   * f32 accuracy from TF32 tensor cores (3xTF32): every operand v is
//     split into hi (v rounded to TF32) and lo = v - hi, and each product
//     is a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first, accumulated
//     in f32 by mma.sync.m16n8k8 (lo * lo is dropped). One TF32 product
//     alone keeps ~3 decimal digits, too few for a chain of 18 convs.
//   * One thread block per (time tile, batch row). The tile plus a halo of
//     HALO = 64 rows per side (the stage's receptive field is 60) lives in
//     two shared buffers of E = t_tile + 128 rows: the chain state xb and
//     the conv-1 output hb, laid out [MARGIN][xb][MARGIN][hb][MARGIN][TAIL].
//     The margin rows are zero, so a tap that reaches past the window reads
//     0 (the Pallas kernel's zero-filled shift). Conv 1 reads leaky(xb) and
//     writes hb; conv 2 reads hb and adds into xb in place. The (C, T)
//     input is transposed into xb when a chain starts; only the central
//     t_tile rows are exact, and only they are written out, channels-first,
//     from the accumulators.
//   * A row holds the C channels of one time step at a stride of C + 4
//     floats (4 or 20 mod 32 for every multiple of 16), so the A-fragment
//     loads (rows g = lane / 4, columns t = lane % 4 and t + 4) fall on 32
//     distinct banks.
//   * A warp owns a band of BAND = 32 time rows (two m16 tiles) and all
//     C_out (half of them above C = 64): one split A fragment feeds C / 8
//     (or C / 16) n8 tiles, one split B fragment two m16 tiles. The last
//     band may reach 16 rows past E; those rows read the next margin (or
//     the TAIL rows) and are never stored.
//   * B comes from the packed [tap][c_in][c_out] buffer with __ldg. Column
//     j of n8 tile n stands for output channel j * NT + n, so a lane's B
//     values for all its tiles are NT consecutive floats of one row (two
//     float4 loads at C = 64 instead of 16 scalar ones); the epilogue maps
//     the accumulators back the same way.
//   * The tile follows from the shared-memory budget (t_tile 240 at
//     C = 64, 608 at C = 32) and from filling the card: the wrapper picks
//     a smaller tile where that gives fewer waves of blocks over the SMs
//     (ops/mrf.py::pick_t_tile); halo recompute is cheaper than idle SMs.
//   * Above C = 80 two buffers leave no room for a 128-row tile. Then
//     (HB_GLOBAL) only xb stays in shared memory and hb lives channels-last
//     in a global scratch region of the block's own, [MARGIN][E][MARGIN]
//     [TAIL] rows: conv 1 writes it once, conv 2 reads it k times, mostly
//     from L2.
//   * The chain sum is accumulated in the output tensor: each block owns
//     its central tile, and the same lane writes the same outputs for
//     every chain, so no synchronisation is needed for it.
//
// A second instance (BF16, the Pallas kernel's compute_dtype=bfloat16)
// rounds both operands of every product to bf16 (to nearest even) and
// sums in f32: one mma.sync.m16n8k16 bf16 product per 16 channels of a
// tap in place of three TF32 products per 8, so its bound is FLOPs /
// 989 TFLOP/s. Bias, leaky, re-zero, residual and chain mean stay f32,
// and so do activations in and out and in shared memory. The k order of
// a product is free as long as A and B agree: k = 2t, 2t + 1, 2t + 8,
// 2t + 9 of lane (g, t) stand for channels t, t + 4, t + 8, t + 12, so
// the A loads are the TF32 pass's (conflict-free) and B reads four rows.

#include <cuda_runtime.h>
#include <stdint.h>

#define HALO 64
#define MARGIN 32     // zero rows per buffer side; >= the widest tap reach c0 * d
#define TILE_STEP 16  // t_tile granularity: one m16 tile
#define MAX_BLOCKS 4
#define MAX_DIL 4
#define MAX_THREADS 384
#define BAND 32       // time rows of one warp's work item: two m16 tiles
// rows after a buffer's last margin: the last band may reach BAND - 16 rows
// past the window; those rows are read but never stored
#define TAIL (BAND - TILE_STEP)

struct MrfConfig {
    int n_blocks;
    int n_dil;
    int k[MAX_BLOCKS];
    int d[MAX_BLOCKS][MAX_DIL];
    long long w_off[MAX_BLOCKS][4];  // W1, B1, W2, B2 offsets in the weight buffer
};

template <int C>
struct Geometry {
    static constexpr int S = C + 4;               // row stride in floats
    static constexpr bool HB_GLOBAL = C > 80;     // = ops/mrf.py::hb_in_global
    static constexpr int NG = C > 64 ? 2 : 1;     // column groups of C_out
    static constexpr int NT = C / (8 * NG);       // n8 tiles per warp item
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.1f * v; }

// v = hi + lo. hi is v rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero: cvt.rna.tf32.f32's rounding, in two integer
// operations, which ran faster than the cvt); lo is the exact remainder,
// of which the tensor core reads the TF32 bits.
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

// lo and hi rounded to bf16 (to nearest even), packed lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

// d += a (16 x 16, row major) * b (16 x 8, column major), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 'same' conv over the whole window. src and dst point at row 0 of
// their buffer. CONV1: reads leaky(src), stores leaky(masked conv) into
// dst. !CONV1: adds the masked conv into dst (the chain state) and, when
// out_mode > 0, folds the new chain state of the central tile into the
// output: 1 = first chain, 2 = middle chain, 3 = last chain (then divided
// by n_blocks). K is the kernel size, fixed at compile time so that the
// tap loop unrolls. BF16: the products' operands rounded to bf16, one
// m16n8k16 product per 16 channels of a tap; else 3xTF32 per 8.
template <int C, bool CONV1, int K, bool BF16>
__device__ __forceinline__ void conv_pass(
    const float* src, float* dst, const float* __restrict__ wt, const float* __restrict__ bias,
    int E, int d, int g0, int T, int t_tile, float* __restrict__ yg, int out_mode, int n_blocks)
{
    using G = Geometry<C>;
    constexpr int S = G::S, NT = G::NT, NG = G::NG;
    constexpr int MT = BAND / 16;  // m16 tiles per warp item
    constexpr int c0 = (K - 1) / 2;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int gr = lane >> 2, tg = lane & 3;  // the fragments' group and thread-in-group
    const int n_items = (E + BAND - 1) / BAND * NG;

    for (int item = warp; item < n_items; item += nwarps) {
        const int e0 = item / NG * BAND;
        const int co0 = item % NG * (NT * 8);

        float acc[MT][NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

#pragma unroll 1
        for (int ci0 = 0; ci0 < C; ci0 += BF16 ? 16 : 8) {
            const float* arow = src + (e0 + gr) * S + ci0 + tg;
            const float* wrow = wt + (ci0 + tg) * C + co0 + gr * NT;
            if constexpr (BF16) {
#pragma unroll
                for (int tap = 0; tap < K; ++tap) {
                    const int off = (tap - c0) * d * S;
                    // a[m]: rows g, g + 8 of m16 tile m; channels t, t + 4
                    // (regs 0, 1) and t + 8, t + 12 (regs 2, 3)
                    uint32_t a[MT][4];
#pragma unroll
                    for (int m = 0; m < MT; ++m) {
                        const float* p = arow + off + m * 16 * S;
                        float v[8] = {p[0], p[4], p[8 * S], p[8 * S + 4],
                                      p[8], p[12], p[8 * S + 8], p[8 * S + 12]};
#pragma unroll
                        for (int q = 0; q < 8; ++q) v[q] = CONV1 ? leaky(v[q]) : v[q];
#pragma unroll
                        for (int q = 0; q < 4; ++q) a[m][q] = pack_bf16(v[2 * q], v[2 * q + 1]);
                    }
                    const float* wp = wrow + tap * C * C;
                    float wv[4][NT];
#pragma unroll
                    for (int r = 0; r < 4; ++r) load_run<NT>(wp + 4 * r * C, wv[r]);
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        const uint32_t b0 = pack_bf16(wv[0][n], wv[1][n]);
                        const uint32_t b1 = pack_bf16(wv[2][n], wv[3][n]);
#pragma unroll
                        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][n], a[m], b0, b1);
                    }
                }
            } else {
#pragma unroll
                for (int tap = 0; tap < K; ++tap) {
                    const int off = (tap - c0) * d * S;
                    uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
                    for (int m = 0; m < MT; ++m) {
                        const float* p = arow + off + m * 16 * S;
                        const float v[4] = {p[0], p[8 * S], p[4], p[8 * S + 4]};
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            split(CONV1 ? leaky(v[q]) : v[q], ahi[m][q], alo[m][q]);
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
        }

        // accumulator q of tile (m, n): row e0 + 16 m + gr + 8 (q / 2),
        // column 2 tg + q % 2 of n8 tile n, which is output channel
        // co0 + (2 tg + q % 2) NT + n
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int co = co0 + (2 * tg + j) * NT + n;
                const float bv = __ldg(bias + co);
#pragma unroll
                for (int m = 0; m < MT; ++m) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int e = e0 + m * 16 + gr + 8 * h;
                        if (e >= E) continue;
                        const int g = g0 + e;
                        const bool valid = g >= 0 && g < T;
                        const float v = valid ? acc[m][n][2 * h + j] + bv : 0.f;
                        float* p = dst + e * S + co;
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
    }
}

// HiFi-GAN's kernel sizes (v1 and v2); the launch refuses any other.
template <int C, bool CONV1, bool BF16>
__device__ __forceinline__ void conv_dispatch(
    const float* src, float* dst, const float* __restrict__ wt, const float* __restrict__ bias,
    int E, int k, int d, int g0, int T, int t_tile, float* __restrict__ yg, int out_mode,
    int n_blocks)
{
    switch (k) {
        case 3:
            conv_pass<C, CONV1, 3, BF16>(src, dst, wt, bias, E, d, g0, T, t_tile, yg, out_mode,
                                         n_blocks);
            break;
        case 7:
            conv_pass<C, CONV1, 7, BF16>(src, dst, wt, bias, E, d, g0, T, t_tile, yg, out_mode,
                                         n_blocks);
            break;
        case 11:
            conv_pass<C, CONV1, 11, BF16>(src, dst, wt, bias, E, d, g0, T, t_tile, yg, out_mode,
                                          n_blocks);
            break;
    }
}

template <int C, bool BF16>
__global__ void __launch_bounds__(MAX_THREADS, 1)
mrf_stage_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                 float* hscratch, int T, int t_tile, MrfConfig cfg)
{
    using G = Geometry<C>;
    constexpr int S = G::S;
    extern __shared__ __align__(16) float smem[];
    const int E = t_tile + 2 * HALO;
    float* xb = smem + MARGIN * S;  // rows [MARGIN, MARGIN + E) of shared memory
    float* hb = G::HB_GLOBAL
        ? hscratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (E + 2 * MARGIN + TAIL) * S +
              MARGIN * S
        : smem + (E + 2 * MARGIN) * S;  // rows [E + 2 MARGIN, 2 E + 2 MARGIN)
    const int b = blockIdx.y;
    const int g0 = blockIdx.x * t_tile - HALO;  // global position of window row 0
    const float* xg = x + (size_t)b * C * T;
    float* yg = y + (size_t)b * C * T;

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
        const int out_mode = blk == 0 ? 1 : (blk == cfg.n_blocks - 1 ? 3 : 2);

        __syncthreads();  // the previous chain is done with xb and hb
        // transpose the (C, T) window into channels-last rows
        for (int i = threadIdx.x; i < C * E; i += blockDim.x) {
            const int c = i / E;
            const int e = i - c * E;
            const int g = g0 + e;
            xb[e * S + c] = (g >= 0 && g < T) ? xg[(size_t)c * T + g] : 0.f;
        }
        __syncthreads();

        for (int j = 0; j < cfg.n_dil; ++j) {
            conv_dispatch<C, true, BF16>(xb, hb, W1 + (size_t)j * k * C * C, B1 + j * C, E, k,
                                         cfg.d[blk][j], g0, T, t_tile, yg, 0, cfg.n_blocks);
            __syncthreads();
            conv_dispatch<C, false, BF16>(hb, xb, W2 + (size_t)j * k * C * C, B2 + j * C, E, k,
                                          1, g0, T, t_tile, yg,
                                          j == cfg.n_dil - 1 ? out_mode : 0, cfg.n_blocks);
            __syncthreads();
        }
    }
}

template <int C, bool BF16>
static int launch(const float* x, const float* w, float* y, float* hscratch, int B, int T,
                  int t_tile, const MrfConfig& cfg, int threads, cudaStream_t stream)
{
    using G = Geometry<C>;
    if ((hscratch != nullptr) != G::HB_GLOBAL) return (int)cudaErrorInvalidValue;
    const int E = t_tile + 2 * HALO;
    const int rows = (G::HB_GLOBAL ? E + 2 * MARGIN : 2 * E + 3 * MARGIN) + TAIL;
    const size_t smem = (size_t)rows * G::S * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(mrf_stage_kernel<C, BF16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T + t_tile - 1) / t_tile, B);
    mrf_stage_kernel<C, BF16><<<grid, threads, smem, stream>>>(x, w, y, hscratch, T, t_tile, cfg);
    return (int)cudaGetLastError();
}

template <bool BF16>
static int launch_width(const float* x, const float* w, float* y, float* hscratch, int B, int C,
                        int T, int t_tile, const MrfConfig& cfg, int threads, void* stream)
{
    const cudaStream_t s = (cudaStream_t)stream;
    switch (C) {
        case 16: return launch<16, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, threads, s);
        case 32: return launch<32, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, threads, s);
        case 48: return launch<48, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, threads, s);
        case 64: return launch<64, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, threads, s);
        case 80: return launch<80, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, threads, s);
        case 96: return launch<96, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, threads, s);
        case 112: return launch<112, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, threads, s);
        case 128: return launch<128, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, threads, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Launches the stage on `stream`. x, y: (B, C, T) f32 contiguous; w: the
// stage's weights packed per block as W1 (n_dil, k, C, C), B1 (n_dil, C),
// W2 (n_dil, k, C, C), B2 (n_dil, C). ks, dils: host arrays (n_blocks,)
// and (n_blocks, n_dil). C: a multiple of 16 up to 128. t_tile: a multiple
// of TILE_STEP whose buffers fit the block's shared memory. hscratch: null
// up to C = 80, else B * ceil(T / t_tile) * (t_tile + 2 * HALO + 2 *
// MARGIN + TAIL) * (C + 4) f32 of device memory for hb. bf16: 0 = the
// 3xTF32 instance (f32 accuracy), 1 = the bf16-product instance. Returns
// the CUDA error code of the launch.
extern "C" int mrf_stage_launch(const float* x, const float* w, float* y, float* hscratch,
                                int B, int C, int T, int t_tile, int n_blocks, int n_dil,
                                const int* ks, const int* dils, int threads, int bf16,
                                void* stream)
{
    if (n_blocks < 1 || n_blocks > MAX_BLOCKS || n_dil < 1 || n_dil > MAX_DIL ||
        t_tile < TILE_STEP || t_tile % TILE_STEP != 0 || threads < 32 ||
        threads > MAX_THREADS || threads % 32 != 0 || (bf16 != 0 && bf16 != 1))
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
    return bf16 ? launch_width<true>(x, w, y, hscratch, B, C, T, t_tile, cfg, threads, stream)
                : launch_width<false>(x, w, y, hscratch, B, C, T, t_tile, cfg, threads, stream);
}

extern "C" const char* mrf_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
