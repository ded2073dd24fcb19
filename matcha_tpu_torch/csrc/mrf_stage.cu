// One whole HiFi-GAN multi-receptive-field (MRF) stage, fused, on Hopper's
// warpgroup tensor cores (sm_90a): kernel K1, on (B, C, T) activations.
//
// Replaces matcha_tpu/ops/mrf_pallas.py::fused_mrf_stage (the Pallas TPU
// kernel). The stage, what bounds it and the conv pass's design are in
// csrc/mrf_conv.cuh, which K3 (csrc/mrf_phase.cu) includes too: f32-
// accurate 3xTF32 wgmma products, their weights fed from a shared-memory
// ring, each conv computing only the rows its tile still needs. What is
// K1's own is the layout at its edges:
//
//   * A chain's window (its own receptive field around the tile) is
//     gathered from the (C, T) input into channels-last rows: a lane per
//     channel and four time steps, one float4 of the channel's row where
//     T allows, so that neighbouring lanes store to distinct banks.
//   * After each chain's last conv its central rows are folded into the
//     channels-first output in one pass (y = x_1, y + x_2, ..., then (y +
//     x_n) / n), mapped alike: the sum order K3 takes, so the two agree
//     bit for bit on the same input.
//   * Two instances: 3xTF32 (f32 accuracy) and bf16 products (the Pallas
//     kernel's compute_dtype=bfloat16), at every multiple of 16 channels up
//     to 128; above C = 80 the conv-1 buffer lives in a global scratch.

#include "mrf_conv.cuh"

template <int C>
struct ChannelsFirst {
    static constexpr int S = C + 8;  // row stride of the window buffer
    const float* x;  // this batch row's (C, T) input and output
    float* y;
    int T, t0, t_tile;  // t0: the tile's first position
    bool vec;           // every channel's row starts on 16 bytes: float4 runs of time

    // A lane per channel, four time steps each (a float4 of the channel's
    // row when vec): the window's shared stores fall on distinct banks.
    // Rows [lo, hi) widen to multiples of 4, still inside the buffer.
    __device__ void load(float* xb, int lo, int hi, int g0) const
    {
        const int q0 = lo / 4, nq = (hi + 3) / 4 - q0;
        for (int i = threadIdx.x; i < C * nq; i += N_WG * 128) {
            const int c = i % C, e = 4 * (q0 + i / C), g = g0 + e;
            const float* src = x + (size_t)c * T + g;
            float v[4];
            if (vec && g >= 0 && g + 3 < T) {
                const float4 f = __ldg(reinterpret_cast<const float4*>(src));
                v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) v[q] = (g + q >= 0 && g + q < T) ? src[q] : 0.f;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) xb[(e + q) * S + c] = v[q];
        }
    }

    // xc: the tile's first central row. A lane per channel, four time
    // steps each, read from distinct banks and written as one float4 where
    // the row allows.
    __device__ void fold(const float* xc, int blk, int n_blocks) const
    {
        const int rows = min(t_tile, T - t0);
        const float n = (float)n_blocks;
        for (int i = threadIdx.x; i < C * ((rows + 3) / 4); i += N_WG * 128) {
            const int c = i % C, r = 4 * (i / C);
            float* o = y + (size_t)c * T + t0 + r;
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) v[q] = xc[(r + q) * S + c];
            if (vec && r + 3 < rows) {
                float4 f = make_float4(v[0], v[1], v[2], v[3]);
                if (blk > 0) {
                    const float4 p = *reinterpret_cast<const float4*>(o);
                    f = make_float4(p.x + f.x, p.y + f.y, p.z + f.z, p.w + f.w);
                }
                if (blk == n_blocks - 1) f = make_float4(f.x / n, f.y / n, f.z / n, f.w / n);
                *reinterpret_cast<float4*>(o) = f;
            } else {
                for (int q = 0; q < 4 && r + q < rows; ++q) {
                    float u = v[q];
                    if (blk > 0) u = o[q] + u;
                    if (blk == n_blocks - 1) u = u / n;
                    o[q] = u;
                }
            }
        }
    }
};

template <int C, bool BF16>
__global__ void __launch_bounds__(MRF_THREADS, 1)
mrf_stage_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                 float* hscratch, int T, int t_tile, MrfConfig cfg)
{
    const size_t row = (size_t)blockIdx.y * C * T;
    const bool vec = T % 4 == 0 && ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
    const ChannelsFirst<C> io{x + row, y + row, T, (int)blockIdx.x * t_tile, t_tile, vec};
    mrf_block<C, BF16>(w, hscratch, T, t_tile, cfg, io);
}

template <int C, bool BF16>
static int launch(const float* x, const float* w, float* y, float* hscratch, int B, int T,
                  int t_tile, const MrfConfig& cfg, cudaStream_t stream)
{
    if ((hscratch != nullptr) != Geometry<C, BF16>::HB_GLOBAL) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<C, BF16>(t_tile);
    cudaError_t err = cudaFuncSetAttribute(mrf_stage_kernel<C, BF16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T + t_tile - 1) / t_tile, B);
    mrf_stage_kernel<C, BF16><<<grid, MRF_THREADS, smem, stream>>>(x, w, y, hscratch, T, t_tile,
                                                                   cfg);
    return (int)cudaGetLastError();
}

template <bool BF16>
static int launch_width(const float* x, const float* w, float* y, float* hscratch, int B, int C,
                        int T, int t_tile, const MrfConfig& cfg, void* stream)
{
    const cudaStream_t s = (cudaStream_t)stream;
    switch (C) {
        case 16: return launch<16, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, s);
        case 32: return launch<32, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, s);
        case 48: return launch<48, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, s);
        case 64: return launch<64, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, s);
        case 80: return launch<80, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, s);
        case 96: return launch<96, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, s);
        case 112: return launch<112, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, s);
        case 128: return launch<128, BF16>(x, w, y, hscratch, B, T, t_tile, cfg, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Launches the stage on `stream`. x, y: (B, C, T) f32 contiguous; w: the
// stage's weights as ops/mrf.py::pack_mrf_weights packs them (16-byte
// aligned). ks, dils: host arrays (n_blocks,) and (n_blocks, n_dil). C: a
// multiple of 16 up to 128. t_tile: a multiple of TILE_STEP whose buffers
// fit the block's shared memory. hscratch: null up to C = 80, else B *
// ceil(T / t_tile) * (t_tile + 2 * HALO + WG_ROWS) * (C + 8) f32 of device
// memory for hb. bf16: 0 = the 3xTF32 instance (f32 accuracy), 1 = the
// bf16-product instance. Returns the CUDA error code of the launch.
extern "C" int mrf_stage_launch(const float* x, const float* w, float* y, float* hscratch,
                                int B, int C, int T, int t_tile, int n_blocks, int n_dil,
                                const int* ks, const int* dils, int bf16, void* stream)
{
    if (t_tile < TILE_STEP || t_tile % TILE_STEP != 0 || (bf16 != 0 && bf16 != 1) ||
        (uintptr_t)w % 16 != 0)
        return (int)cudaErrorInvalidValue;
    MrfConfig cfg;
    const int err = mrf_config(cfg, C, n_blocks, n_dil, ks, dils, bf16 != 0);
    if (err != 0) return err;
    return bf16 ? launch_width<true>(x, w, y, hscratch, B, C, T, t_tile, cfg, stream)
                : launch_width<false>(x, w, y, hscratch, B, C, T, t_tile, cfg, stream);
}

extern "C" const char* mrf_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
