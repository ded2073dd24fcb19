// One whole HiFi-GAN multi-receptive-field (MRF) stage on channels-last
// activations, fused, on Hopper's warpgroup tensor cores (sm_90a): kernel
// K3, on x and y of shape (B, T, C).
//
// Replaces matcha_tpu/ops/mrf_pallas.py::fused_mrf_stage_phase (the
// phase-packed Pallas TPU kernel) for C <= 64: the same function as K1
// (csrc/mrf_stage.cu). The TPU kernel packs P = 128 // C time phases onto
// the channel axis so that each conv's product has 128 rows for the
// 128-row matrix unit, and pays for it by building a |O| * C-row operand
// per conv. This card needs no packing: time is the M side of every
// product and a tap is a whole-row offset into a shared buffer, so no
// operand is concatenated.
//
// The conv pass is K1's, in csrc/mrf_conv.cuh (3xTF32 wgmma products fed
// from a shared-memory ring of weight stages, each conv computing only the
// rows its tile still needs; the header gives the reasons), with K1's tile
// and rows (ops/mrf.py::pick_t_tile). What is K3's own, because its
// activations are channels-last:
//
//   * The window load copies whole rows: a row of C floats in global
//     memory and a row of C + 8 in shared memory both start on 16 bytes,
//     so each thread moves one float4 per step, neighbouring threads on
//     neighbouring addresses.
//   * After each chain's last conv its central rows go into the output in
//     one pass of float4s, in K1's sum order (y = x_1, y + x_2, ..., then
//     (y + x_n) / n), so the two kernels agree bit for bit on the same
//     input.

#include "mrf_conv.cuh"

template <int C>
struct RowsLast {
    static constexpr int Q = C / 4;  // float4s per row
    const float* x;  // this batch row's (T, C) input and output
    float* y;
    int T, t0, t_tile;  // t0: the tile's first position

    __device__ void load(float* xb, int lo, int hi, int g0) const
    {
        for (int i = threadIdx.x; i < (hi - lo) * Q; i += N_WG * 128) {
            const int r = lo + i / Q;
            const int q = i % Q;
            const int g = g0 + r;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (g >= 0 && g < T) v = __ldg(reinterpret_cast<const float4*>(x + (size_t)g * C) + q);
            *reinterpret_cast<float4*>(xb + r * (C + 8) + 4 * q) = v;
        }
    }

    // xc: the tile's first central row
    __device__ void fold(const float* xc, int blk, int n_blocks) const
    {
        const int rows = min(t_tile, T - t0);
        const float n = (float)n_blocks;
        for (int i = threadIdx.x; i < rows * Q; i += N_WG * 128) {
            const int r = i / Q;
            const int q = i - r * Q;
            float4 v = *reinterpret_cast<const float4*>(xc + r * (C + 8) + 4 * q);
            float4* o = reinterpret_cast<float4*>(y + (size_t)(t0 + r) * C) + q;
            if (blk > 0) {
                const float4 p = *o;
                v = make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
            }
            if (blk == n_blocks - 1) v = make_float4(v.x / n, v.y / n, v.z / n, v.w / n);
            *o = v;
        }
    }
};

template <int C>
__global__ void __launch_bounds__(MRF_THREADS, 1)
mrf_phase_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                 int T, int t_tile, MrfConfig cfg)
{
    const size_t row = (size_t)blockIdx.y * T * C;
    const RowsLast<C> io{x + row, y + row, T, (int)blockIdx.x * t_tile, t_tile};
    mrf_block<C, false>(w, nullptr, T, t_tile, cfg, io);
}

template <int C>
static int launch(const float* x, const float* w, float* y, int B, int T, int t_tile,
                  const MrfConfig& cfg, cudaStream_t stream)
{
    const size_t smem = smem_bytes<C, false>(t_tile);
    cudaError_t err = cudaFuncSetAttribute(mrf_phase_kernel<C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T + t_tile - 1) / t_tile, B);
    mrf_phase_kernel<C><<<grid, MRF_THREADS, smem, stream>>>(x, w, y, T, t_tile, cfg);
    return (int)cudaGetLastError();
}

// Launches the stage on `stream`. x, y: (B, T, C) f32 contiguous, 16-byte
// aligned; w: the stage's weights as ops/mrf.py::pack_mrf_weights packs
// them, as for mrf_stage_launch. ks, dils: host arrays (n_blocks,) and
// (n_blocks, n_dil). C: 16, 32, 48 or 64. t_tile: a multiple of TILE_STEP
// whose two buffers fit the block's shared memory. Returns the CUDA error
// code of the launch.
extern "C" int mrf_phase_launch(const float* x, const float* w, float* y, int B, int C, int T,
                                int t_tile, int n_blocks, int n_dil, const int* ks,
                                const int* dils, void* stream)
{
    if (t_tile < TILE_STEP || t_tile % TILE_STEP != 0 ||
        ((uintptr_t)x | (uintptr_t)y | (uintptr_t)w) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    MrfConfig cfg;
    const int err = mrf_config(cfg, C, n_blocks, n_dil, ks, dils, false);
    if (err != 0) return err;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (C) {
        case 16: return launch<16>(x, w, y, B, T, t_tile, cfg, s);
        case 32: return launch<32>(x, w, y, B, T, t_tile, cfg, s);
        case 48: return launch<48>(x, w, y, B, T, t_tile, cfg, s);
        case 64: return launch<64>(x, w, y, B, T, t_tile, cfg, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* mrf_phase_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
