// Monotonic Alignment Search for Hopper (sm_90a): one block per batch row,
// one warp of it carries the row's whole DP chain.
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
// What bounds it. A latency chain: t_y dependent row steps forward and
// t_y dependent steps back, about 2 * t_y in all (1,664 at t_y = 832), with
// a few operations per cell. The bytes bound (lp read once, the path written
// once: 61 MB at (32, 288, 832), 0.018 ms at 3.35 TB/s) is far below it, and
// one row per SM (B = 32 of 132 SMs) leaves no parallelism across rows.
// Measured on an H100 (scripts/profile_mas.py, T_y = 832, CPL 1 to 16), a
// row costs about 157 clocks plus about 15 per cell of a lane, forward and
// backtrack together: one warp's issue of the chain sets the time, not
// memory. So the design shortens each step:
//  * The chain warp. Warp 0 owns the row: lane l holds CPL consecutive cells
//    x = l * CPL + i in registers (CPL a compile-time instance, the smallest
//    of CPL_INSTANCES with 32 * CPL >= T_x; one warp up to T_x = 4096 at
//    CPL = 128, so no second chain warp and no barrier between chain warps
//    exists). Within a row the cells depend only on the row before, so a
//    row costs one __shfl_up_sync (the lane's left edge) and CPL independent
//    max-add-select steps; there is no block barrier per row.
//  * Staged log-prior tiles. Warps 1..LOADER_WARPS copy the next tile of R
//    mel frames, lp[x][y0 : y0 + R] for x < t_x, into shared memory with
//    cp.async while the chain warp works on the current one (two buffers,
//    one __syncthreads() per tile). Cell x sits in slot (x % CPL) * 32 +
//    x / CPL, rows of S = R + PAD floats, so lane l's read of its i-th cell
//    is slot i * 32 + l: for CPL <= 16 a float4 (4 rows at once, S = 4 mod 8,
//    no bank conflict in a quarter warp), above that a float (S odd). The
//    copies are 16 bytes where T_y % 4 == 0 and lp starts on 16 bytes (and
//    the float4 layout is in use), else 4 bytes.
//  * Decision bits. The backtrack needs only acc[y-1][x-1] > acc[y-1][x]
//    for each cell, computed from the very floats the max compared (so a tie
//    does not move). A lane packs its CPL bits into WPL = ceil(CPL / 32)
//    words per row; the warp stores a row's words as one coalesced line into
//    a (B, T_y, 32 * WPL) scratch the wrapper allocates. No f32 row is kept.
//  * Backtrack, on the same warp. For each run of 32 rows the warp copies
//    those rows' words into shared memory (cp.async, coalesced, the next run
//    in flight while this one is walked) and syncs; lane 0 walks the 32
//    serial steps, reading bit index % CPL of owner index / CPL.
// The path is written as 1.0f into an f32 (B, T_x, T_y) output that the
// wrapper zeroed; rows y >= t_y stay 0. A cell's value is
// __fadd_rn(fmaxf(prev, left), lp), as in the plain version; the band
// select's products and fmas are exact on 0 and 1 (row_step).
//
// ops/mas.py::mas_layout mirrors the geometry below (CPL_INSTANCES,
// MAX_TILE_ROWS, MAX_SMEM, BT_ROWS, the row padding and step, smem_bytes);
// the two must agree, and chip_smoke.py checks smem_bytes against it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float MAX_NEG_VAL = -1e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int LOADER_WARPS = 3;
constexpr int THREADS = 32 * (1 + LOADER_WARPS);
constexpr int MAX_TILE_ROWS = 64;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most one block may take
constexpr int BT_ROWS = 32;       // rows per backtrack run
// cells per lane: the instances mas_launch is compiled for
constexpr int CPL_INSTANCES[] = {1, 2, 3, 4, 6, 8, 10, 12, 16, 24, 32, 48, 64, 96, 128};

template <int CPL>
struct Geometry {
    static constexpr bool VEC4 = CPL <= 16;     // float4 reads of 4 rows, else floats
    static constexpr int PAD = VEC4 ? 4 : 1;    // S = R + PAD
    static constexpr int ROW_STEP = VEC4 ? 8 : 2;  // R is a multiple of it
    static constexpr int WPL = (CPL + 31) / 32;     // bit words per lane and row
    static constexpr int SLOTS = 32 * CPL;
};

int smem_bytes(int cpl, int rows) {
    const int pad = cpl <= 16 ? 4 : 1, wpl = (cpl + 31) / 32;
    const long long tiles = 2LL * 32 * cpl * (rows + pad) * 4;
    const long long backtrack = 2LL * BT_ROWS * 32 * wpl * 4;
    const long long bytes = tiles > backtrack ? tiles : backtrack;
    return bytes > MAX_SMEM ? -1 : (int)bytes;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Loader threads (ltid in [0, 32 * LOADER_WARPS)) copy rows y0 .. y0 + n - 1
// of lp[x] for x < t_x into slot (x % CPL) * 32 + x / CPL of dst: a thread
// takes one piece (16 or 4 bytes) of every rows_per_pass-th x.
template <int CPL>
__device__ void load_tile(float* dst, const float* lpb, int T_y, int t_x, int y0, int n, int S,
                          bool vec16, int ltid) {
    const int step = vec16 ? 4 : 1;
    const int pieces = (n + step - 1) / step;  // per x, <= MAX_TILE_ROWS; a 16-byte piece past
                                               // t_y stays in T_y
    const int rows_per_pass = 32 * LOADER_WARPS / pieces;
    if (ltid < rows_per_pass * pieces) {
        const int k = (ltid % pieces) * step;
        for (int x = ltid / pieces; x < t_x; x += rows_per_pass) {
            float* d = dst + ((x % CPL) * 32 + x / CPL) * S + k;
            const float* s = lpb + (size_t)x * T_y + y0 + k;
            if (vec16) cp_async16(d, s);
            else cp_async4(d, s);
        }
    }
    cp_async_commit();
}

// 0xffffffff where a > b, else 0 (one compare, no select)
__device__ __forceinline__ uint32_t gt_mask(float a, float b) {
    uint32_t m;
    asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(m) : "f"(a), "f"(b));
    return m;
}

// One row y of the forward on the chain warp: lane-local cells i of
// x = base + i, lp values lpv, decision bits into the row's words.
//
// Compares, maxes, selects and logic run at half the rate of float adds and
// multiplies on sm_90 (64 against 128 a clock per SM); a cell takes three of
// them (the max, the bit's compare and its OR) and does the band select on
// the float pipe: with lo = t_x + y - t_y - base and
// hi = min(y, t_x - 1) - base, in_band = sat(1 - lo + i) * sat(hi + 1 - i)
// is exactly 1 or 0 (small integers), and fma(nv, in_band, fma(in_band, 1e9,
// -1e9)) is exactly nv or -1e9 for a finite nv (a -0 may turn +0, which no
// compare tells apart). nv is finite for x < t_x; cells x >= t_x read
// unloaded shared memory, feed only cells further right and are never read
// back.
template <int CPL>
__device__ __forceinline__ void row_step(float (&prev)[CPL], const float (&lpv)[CPL], int y,
                                         int lane, int base, int t_x, int t_y,
                                         uint32_t* __restrict__ bitsb) {
    constexpr int WPL = Geometry<CPL>::WPL;
    const float edge = __shfl_up_sync(FULL, prev[CPL - 1], 1);
    const float left0 = lane > 0 ? edge : (y == 0 ? 0.f : MAX_NEG_VAL);
    const float from_lo = __int2float_rn(1 - (t_x + y - t_y - base));
    const float to_hi = __int2float_rn(min(y, t_x - 1) - base + 1);
    uint32_t word[WPL];
#pragma unroll
    for (int w = 0; w < WPL; ++w) word[w] = 0u;
#pragma unroll
    for (int i = CPL - 1; i >= 0; --i) {  // downwards: prev[i - 1] is still row y - 1
        const float left = i > 0 ? prev[i - 1] : left0;
        word[i / 32] |= gt_mask(left, prev[i]) & (1u << (i % 32));
        const float nv = __fadd_rn(fmaxf(prev[i], left), lpv[i]);
        const float in_band = __saturatef(from_lo + i) * __saturatef(to_hi - i);
        prev[i] = fmaf(nv, in_band, fmaf(in_band, -MAX_NEG_VAL, MAX_NEG_VAL));
    }
#pragma unroll
    for (int w = 0; w < WPL; ++w) bitsb[((size_t)y * WPL + w) * 32 + lane] = word[w];
}

__device__ __forceinline__ float component(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int CPL>
__global__ void __launch_bounds__(THREADS, 1)
mas_kernel(const float* __restrict__ lp, const int* __restrict__ t_xs,
           const int* __restrict__ t_ys, uint32_t* __restrict__ bits,
           float* __restrict__ path, int T_x, int T_y, int R, int vec16) {
    using G = Geometry<CPL>;
    extern __shared__ __align__(16) float smem[];

    const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t_x = min(t_xs[b], T_x), t_y = min(t_ys[b], T_y);
    if (t_x <= 0 || t_y <= 0) return;  // the same for the whole block

    const int S = R + G::PAD;
    const float* lpb = lp + (size_t)b * T_x * T_y;
    uint32_t* bitsb = bits + (size_t)b * T_y * 32 * G::WPL;
    const int tile_floats = G::SLOTS * S;  // two tiles: smem and smem + tile_floats
    const int n_tiles = (t_y + R - 1) / R;

    if (warp > 0) {
        load_tile<CPL>(smem, lpb, T_y, t_x, 0, min(R, t_y), S, vec16, threadIdx.x - 32);
        cp_async_wait<0>();
    }
    __syncthreads();

    float prev[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) prev[i] = MAX_NEG_VAL;
    const int base = lane * CPL;

    for (int t = 0; t < n_tiles; ++t) {
        const int y0 = t * R;
        if (warp > 0) {
            if (t + 1 < n_tiles)
                load_tile<CPL>(smem + ((t + 1) & 1) * tile_floats, lpb, T_y, t_x, y0 + R,
                               min(R, t_y - y0 - R), S, vec16, threadIdx.x - 32);
        } else {
            const float* cur = smem + (t & 1) * tile_floats + lane * S;
            const int n = min(R, t_y - y0);
            if constexpr (G::VEC4) {
                float4 v[CPL];
#pragma unroll
                for (int i = 0; i < CPL; ++i)
                    v[i] = *reinterpret_cast<const float4*>(cur + i * 32 * S);
                for (int r0 = 0; r0 < n; r0 += 4) {
                    // the next 4 rows, in flight while these run (r0 + 4 <= R: at most
                    // the row's padding)
                    float4 next[CPL];
#pragma unroll
                    for (int i = 0; i < CPL; ++i)
                        next[i] = *reinterpret_cast<const float4*>(cur + i * 32 * S + r0 + 4);
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        if (r0 + k >= n) break;  // uniform: the tile's last rows
                        float lpv[CPL];
#pragma unroll
                        for (int i = 0; i < CPL; ++i) lpv[i] = component(v[i], k);
                        row_step<CPL>(prev, lpv, y0 + r0 + k, lane, base, t_x, t_y, bitsb);
                    }
#pragma unroll
                    for (int i = 0; i < CPL; ++i) v[i] = next[i];
                }
            } else {
                for (int r0 = 0; r0 < n; ++r0) {
                    float lpv[CPL];
#pragma unroll
                    for (int i = 0; i < CPL; ++i) lpv[i] = cur[i * 32 * S + r0];
                    row_step<CPL>(prev, lpv, y0 + r0, lane, base, t_x, t_y, bitsb);
                }
            }
        }
        if (warp > 0) cp_async_wait<0>();
        __syncthreads();  // the next tile is in; the current one may be overwritten
    }

    if (warp != 0) return;
    // The tiles are spent: their shared memory holds two runs of bit rows.
    // The lanes' bit stores must be seen by the copies below.
    __threadfence();
    __syncwarp();
    constexpr int RW = 32 * G::WPL;  // words per bit row
    uint32_t* runs = reinterpret_cast<uint32_t*>(smem);
    const int n_runs = (t_y + BT_ROWS - 1) / BT_ROWS;
    auto fetch = [&](int c) {  // run c: rows t_y - 1 - 32 c - r, r < 32, each >= 0
        uint32_t* dst = runs + (c & 1) * BT_ROWS * RW;
        const int top = t_y - 1 - c * BT_ROWS;
        for (int e = lane; e < BT_ROWS * RW / 4; e += 32) {
            const int r = e / (RW / 4), k = 4 * (e % (RW / 4));
            if (top - r >= 0) cp_async16(dst + r * RW + k, bitsb + (size_t)(top - r) * RW + k);
        }
        cp_async_commit();
    };

    float* pathb = path + (size_t)b * T_x * T_y;
    int index = t_x - 1;
    fetch(0);
    for (int c = 0; c < n_runs; ++c) {
        if (c + 1 < n_runs) {
            fetch(c + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncwarp();
        if (lane == 0) {
            // index = owner * CPL + i; the word of row r + 1 is read for both the
            // index and the one below it while row r decides, so a step waits on
            // its bit alone, not on a shared-memory load
            const uint32_t* run = runs + (c & 1) * BT_ROWS * RW;
            const int top = t_y - 1 - c * BT_ROWS;
            const int rows = min(BT_ROWS, top + 1);
            int owner = index / CPL, i = index - owner * CPL;
            uint32_t word = run[(i >> 5) * 32 + owner];
            for (int r = 0; r < rows; ++r) {
                const int y = top - r;
                const int rn = min(r + 1, BT_ROWS - 1) * RW;  // past the run: read, not used
                const int owner_dn = i > 0 || index == 0 ? owner : owner - 1;
                const int i_dn = i > 0 ? i - 1 : index == 0 ? 0 : CPL - 1;
                const uint32_t stay = run[rn + (i >> 5) * 32 + owner];
                const uint32_t down = run[rn + (i_dn >> 5) * 32 + owner_dn];
                pathb[(size_t)index * T_y + y] = 1.f;
                const bool bit = (word >> (i & 31)) & 1u;
                if (index != 0 && (index == y || bit) && y > 0) {
                    --index;
                    owner = owner_dn;
                    i = i_dn;
                    word = down;
                } else {
                    word = stay;
                }
            }
        }
        index = __shfl_sync(FULL, index, 0);
        __syncwarp();  // lane 0 is done with this run before it is refilled
    }
}

template <int CPL>
int launch(const float* lp, const int* t_xs, const int* t_ys, uint32_t* bits, float* path, int B,
           int T_x, int T_y, int R, cudaStream_t stream) {
    using G = Geometry<CPL>;
    if (32 * CPL < T_x || R < 1 || R > MAX_TILE_ROWS || R % G::ROW_STEP != 0)
        return (int)cudaErrorInvalidValue;
    const int smem = smem_bytes(CPL, R);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    const int vec16 = G::VEC4 && T_y % 4 == 0 && reinterpret_cast<uintptr_t>(lp) % 16 == 0;
    cudaError_t err = cudaFuncSetAttribute(mas_kernel<CPL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    mas_kernel<CPL><<<B, THREADS, smem, stream>>>(lp, t_xs, t_ys, bits, path, T_x, T_y, R, vec16);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of the (cpl, tile_rows) instance in bytes, or -1 where cpl
// is not an instance or the tiles do not fit.
int mas_smem_bytes(int cpl, int tile_rows) {
    for (const int c : CPL_INSTANCES)
        if (c == cpl) return smem_bytes(cpl, tile_rows);
    return -1;
}

// lp, path: (B, T_x, T_y) f32 contiguous, path zeroed; t_xs, t_ys: (B,)
// int32; bits: (B, T_y, 32 * ceil(cpl / 32)) 32-bit words of scratch,
// 16-byte aligned. cpl: an instance with 32 * cpl >= T_x; tile_rows: R, a
// multiple of 8 (cpl <= 16) or 2, at most MAX_TILE_ROWS, whose two tiles fit
// (ops/mas.py::mas_layout picks both). Returns cudaGetLastError() after the
// launch.
int mas_launch(const float* lp, const int* t_xs, const int* t_ys, uint32_t* bits, float* path,
               int B, int T_x, int T_y, int cpl, int tile_rows, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
#define MAS_CASE(C) \
    case C: return launch<C>(lp, t_xs, t_ys, bits, path, B, T_x, T_y, tile_rows, s);
    switch (cpl) {
        MAS_CASE(1) MAS_CASE(2) MAS_CASE(3) MAS_CASE(4) MAS_CASE(6) MAS_CASE(8) MAS_CASE(10)
        MAS_CASE(12) MAS_CASE(16) MAS_CASE(24) MAS_CASE(32) MAS_CASE(48) MAS_CASE(64)
        MAS_CASE(96) MAS_CASE(128)
        default: return (int)cudaErrorInvalidValue;
    }
#undef MAS_CASE
}

const char* mas_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
