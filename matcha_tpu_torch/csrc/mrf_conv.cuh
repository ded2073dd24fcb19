// The conv pass of the fused HiFi-GAN MRF kernels, and the whole run of one
// thread block around it, on Hopper's warpgroup tensor cores (sm_90a).
// K1 (csrc/mrf_stage.cu, (B, C, T) activations) and K3 (csrc/mrf_phase.cu,
// (B, T, C)) include it; they differ only in how a chain's window comes in
// and how its central rows go out (the `io` object of mrf_block).
//
// The stage: for each ResBlock1 chain (kernel size k, dilations d_j), per
// dilation: leaky(0.1) -> dilated 'same' conv -> re-zero outside [0, T) ->
// leaky(0.1) -> d=1 conv -> re-zero -> residual add; the output is the mean
// of the chains. Re-zeroing after every conv reproduces the per-conv zero
// padding at the true sequence edges.
//
// What bounds it on this card: the products. A stage is 126 C^2 multiply-
// adds per output sample (C = 64: ~1 MFLOP) against 8 bytes of input and
// output. In 3xTF32 each product costs three TF32 tensor-core products
// (bound: 3 x FLOPs / 495 TFLOP/s), and wgmma, the warpgroup product, is
// the only way to the tensor cores' full rate. The design:
//
//   * Each conv is one product per 64-row time tile: time on M, C_out on
//     N (the whole of C, m64nCk8), (tap, C_in) on K. A tap is a row offset
//     (tap - c0) * d into a channels-last buffer, which breaks the 8-row
//     core matrices of a shared-memory operand, so A, the activations, comes
//     from registers: each lane loads its fragment at any row offset (two
//     float2 per tile and k step; rows at a stride of C + 8 floats, 8 or 24
//     mod 32, so each half-warp's loads fall on distinct banks), applies
//     leaky and the split there. B, the weights, is read from shared memory
//     through a descriptor, K-major ([c_out][c_in] core matrices, no
//     swizzle).
//   * f32 accuracy from TF32 tensor cores (3xTF32): every operand v is hi
//     (v rounded to TF32) plus lo = v - hi, and each product is a_lo b_hi +
//     a_hi b_lo + a_hi b_hi in f32 (lo * lo is dropped). The weights are
//     split once, when they are packed (ops/mrf.py::pack_mrf_weights); the
//     activations per load.
//   * The weights are staged, not reloaded: 16 input channels of one tap
//     (hi and lo, 8 KB at C = 64) at a time, by one producer thread through
//     cp.async.bulk into a ring of RING slots with a full and an empty
//     mbarrier each, the whole stage's sequence in order, while the two
//     consumer warpgroups run wgmma on the slots that have arrived (the
//     producer's warpgroup gives its registers to them: setmaxnreg). A
//     consumer frees a slot once its last product has completed.
//   * What keeps the products asynchronous: ptxas serializes every wgmma
//     (a wait after each) when one sits on a path it takes for divergent,
//     or when it judges the registers of the products in flight too many.
//     So the warpgroup index is made warp-uniform (__shfl_sync), a
//     warpgroup's tile count is a compile-time constant per pass (one
//     uniform dispatch, no branch between loads or products), a warpgroup
//     holds MTW = 2 tiles (3 at C = 16), and keeps IN_FLIGHT k steps of
//     products in flight: two (wgmma.wait_group 1 before it overwrites a
//     set of A registers), one at C = 16 and above C = 96. Measured on an
//     H100: more tiles or steps than that, and ptxas serializes them and
//     the kernel runs up to 1.4x slower.
//   * Each conv computes only the rows its tile still needs: conv i of a
//     chain the central t_tile rows plus, on each side, rem_i = the reach of
//     the chain's later convs (c0 d for a dilated conv, c0 for a d=1 one),
//     rounded up to whole 64-row tiles; the last conv exactly the tile.
//     A chain's window load reads its own receptive field. Rows past what
//     a conv needs are computed but never stored, so they cannot reach a
//     stored row (ops/mrf.py::conv_rows mirrors the schedule).
//   * One thread block per (time tile, batch row); the window of t_tile +
//     2 HALO rows lives in two shared buffers, the chain state xb and the
//     conv-1 output hb (above C = 80, HB_GLOBAL, hb in a global scratch
//     region of the block's own), laid out [mbarriers][xb][hb][ring]: a
//     garbage row's taps may read up to 63 rows past the last buffer, into
//     the ring. Conv 1 reads leaky(xb) and writes hb; conv 2 reads hb and
//     adds into xb in place. The tiles of a conv go round the warpgroups,
//     MTW at a time each; a conv with more tiles takes more passes over its
//     weights (cheap: a stage's weights come from L2).
//   * After each chain's last conv, the io object folds the central rows
//     of xb into the output: y = x_1, y + x_2, ..., (y + x_n) / n.
//
// A second instance (BF16, the Pallas kernel's compute_dtype=bfloat16)
// rounds both operands of every product to bf16 (to nearest even) and sums
// in f32: one m64nCk16 product per 16 channels of a tap, its weights staged
// as bf16 copies; bias, leaky, re-zero, residual and chain mean stay f32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HALO 64       // window rows per side of the tile; >= the receptive field
#define TILE_STEP 16  // t_tile granularity
#define MAX_BLOCKS 4
#define MAX_DIL 4
#define WG_ROWS 64    // time rows of one warpgroup product
#define N_WG 2        // consumer warpgroups
#define MRF_THREADS (N_WG * 128 + 128)  // and the producer's warpgroup
#define RING 4        // weight slots in shared memory
#define TF32_KC 16    // input channels of one 3xTF32 weight stage

struct MrfConfig {
    int n_blocks;
    int n_dil;
    int k[MAX_BLOCKS];
    int d[MAX_BLOCKS][MAX_DIL];
    long long bias[MAX_BLOCKS][2];    // B1, B2: floats from the buffer's start
    long long staged[MAX_BLOCKS][2];  // W1, W2 staged for the instance: bytes from the start
};

template <int C, bool BF16>
struct Geometry {
    static constexpr int S = C + 8;             // row stride in floats
    static constexpr bool HB_GLOBAL = C > 80;   // = ops/mrf.py::hb_in_global
    static constexpr int KC = BF16 && C % 32 == 0 ? 32 : (BF16 ? 16 : TF32_KC);  // channels a stage
    static constexpr int KSTEP = BF16 ? 16 : 8; // k of one product
    static constexpr int KS = KC / KSTEP;       // k steps a stage: 1 or 2
    static constexpr int STAGE_BYTES = BF16 ? C * KC * 2 : 2 * C * KC * 4;
    static constexpr int SBO = KC / (BF16 ? 8 : 4) * 128;  // bytes between 8-row core groups
    // both instances keep the 3xTF32 ring, so that they take the same tile
    static constexpr int RING_BYTES = RING * 2 * C * TF32_KC * 4;
    // 64-row tiles a warpgroup holds at once,
    // and the k steps it keeps in flight: as many as ptxas keeps asynchronous
    // (see the design notes)
    static constexpr int MTW = C <= 16 ? 3 : 2;
    static constexpr int IN_FLIGHT = C <= 16 || C > 96 || KS == 1 ? 1 : 2;
};

// [mbarriers][xb][hb][ring]: where the ring starts, and the block's bytes
template <int C, bool BF16>
__host__ __device__ inline size_t ring_offset(int E)
{
    using G = Geometry<C, BF16>;
    const size_t rows = G::HB_GLOBAL ? E : 2 * (size_t)E;
    return (128 + rows * G::S * 4 + 127) / 128 * 128;
}

template <int C, bool BF16>
inline size_t smem_bytes(int t_tile)
{
    return ring_offset<C, BF16>(t_tile + 2 * HALO) + Geometry<C, BF16>::RING_BYTES;
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.1f * v; }

// v = hi + lo. hi is v rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: cvt.rna.tf32.f32's rounding, in two integer operations);
// lo is the exact remainder, of which the tensor core reads the TF32 bits.
// ops/mrf.py::split_tf32 splits the weights alike.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo)
{
    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
}

// lo and hi rounded to bf16 (to nearest even), packed lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

// waits until the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done)
                     : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// copies `bytes` from global memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

// the consumer warpgroups only (the producer's has left)
__device__ __forceinline__ void consumer_sync()
{
    asm volatile("bar.sync 1, %0;\n" ::"n"(N_WG * 128) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to these registers across the
// wgmma fences and waits around them
template <int N>
__device__ __forceinline__ void hold(float (&r)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// a K-major, unswizzled shared-memory operand: core matrices of 8 rows x
// 16 bytes, 128 bytes apart along K (LBO) and `sbo` bytes apart along N
__device__ __forceinline__ uint64_t smem_desc(const void* p, int sbo)
{
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x N, f32) += a (64 x 8 TF32, registers) * b (8 x N TF32, shared
// memory), and the same with 64 x 16 bf16 operands: one specialisation per
// N, since the accumulators are listed one by one
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t b);

template <> __device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7}, "
                 "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_tf32<48>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23}, "
                 "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_tf32<80>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39}, "
                 "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_tf32<96>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
                 "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_tf32<112>(float* d, const uint32_t* a,
                                                       uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55}, "
                 "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t* a,
                                                       uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
                 "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                   "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_bf16<16>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7}, "
                 "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_bf16<32>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_bf16<48>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23}, "
                 "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_bf16<64>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_bf16<80>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39}, "
                 "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_bf16<96>(float* d, const uint32_t* a,
                                                      uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
                 "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_bf16<112>(float* d, const uint32_t* a,
                                                       uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55}, "
                 "{%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_bf16<128>(float* d, const uint32_t* a,
                                                       uint64_t b)
{
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
                 "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                   "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// NT of this warpgroup's tiles of a conv (rows row0, row0 + N_WG * WG_ROWS,
// ... for this lane), over one pass of the conv's weight stages. NT is
// fixed at compile time, so that the loads of all NT tiles go out together
// and the products run without a branch between them (a wgmma on a
// conditional path costs a warpgroup arrive of its own). NT = 0 only takes
// and frees the stages.
template <int C, bool CONV1, bool BF16, int NT>
__device__ __forceinline__ void conv_tiles(const float* src, float* dst, const char* ring,
                                           uint64_t* full, uint64_t* empty, uint32_t& sc,
                                           int row0, int k, int d, int e_hi, int g0, int T,
                                           const float* __restrict__ bias)
{
    using G = Geometry<C, BF16>;
    constexpr int S = G::S, NA = C / 2, STRIDE = N_WG * WG_ROWS * S;
    constexpr int NR = BF16 ? 4 : 8;  // A registers of a tile and k step: bf16 pairs, or hi, lo
    constexpr int NV = BF16 ? 4 : 2;  // float2 loads of a tile and k step
    const int lane = threadIdx.x & 31, tq = lane & 3;
    const int c0 = (k - 1) >> 1;
    const int n_stages = k * (C / G::KC);

    float acc[NT > 0 ? NT : 1][NA];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[j][i] = 0.f;
        hold(acc[j]);
    }
#pragma unroll 1
    for (int s = 0; s < n_stages; ++s, ++sc) {
        const int slot = sc % RING;
        mbar_wait(full + slot, (sc / RING) & 1);
        const int tap = s / (C / G::KC);
        const int ci0 = (s - tap * (C / G::KC)) * G::KC;
        const float* a0 = src + (row0 + (tap - c0) * d) * S + ci0 + 2 * tq;
        const uint64_t desc = smem_desc(ring + slot * G::STAGE_BYTES, G::SBO);
#pragma unroll
        for (int ks = 0; ks < G::KS; ++ks) {
            // the group that last read this step's A registers is done (with
            // one step in flight, every group), and at the last step so is the
            // previous stage's last group
            wgmma_wait<G::IN_FLIGHT - 1>();
            if (ks == G::KS - 1 && s > 0 && lane == 0) mbar_arrive(empty + (sc - 1) % RING);
            if constexpr (NT > 0) {
                // rows g and g + 8; TF32: k = t and t + 4 stand for channels 2t
                // and 2t + 1 (the packed weights' order); bf16: k = 2t, 2t + 1
                // and 2t + 8, 2t + 9, the channels themselves
                uint32_t a[NT][NR];
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const float* p = a0 + j * STRIDE + ks * G::KSTEP;
                    float2 v[NV];
                    v[0] = *reinterpret_cast<const float2*>(p);
                    v[1] = *reinterpret_cast<const float2*>(p + 8 * S);
                    if constexpr (BF16) {
                        v[2] = *reinterpret_cast<const float2*>(p + 8);
                        v[3] = *reinterpret_cast<const float2*>(p + 8 * S + 8);
                    }
#pragma unroll
                    for (int q = 0; q < NV; ++q)
                        if (CONV1) v[q] = make_float2(leaky(v[q].x), leaky(v[q].y));
                    if constexpr (BF16) {
#pragma unroll
                        for (int q = 0; q < 4; ++q) a[j][q] = pack_bf16(v[q].x, v[q].y);
                    } else {
                        split(v[0].x, a[j][0], a[j][4]);
                        split(v[1].x, a[j][1], a[j][5]);
                        split(v[0].y, a[j][2], a[j][6]);
                        split(v[1].y, a[j][3], a[j][7]);
                    }
                    hold(a[j]);
                }
                wgmma_fence();
                const uint64_t b = desc + ks * (2 * 128 >> 4);  // two core matrices along K
                // lo * hi, hi * lo, hi * hi (the lo tile follows the hi one), each
                // over the tiles in turn
#pragma unroll
                for (int q = 0; q < (BF16 ? 1 : 3); ++q) {
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        if constexpr (BF16) {
                            wgmma_bf16<C>(acc[j], a[j], b);
                        } else {
                            constexpr uint64_t lo_tile = C * G::KC * 4 >> 4;
                            wgmma_tf32<C>(acc[j], a[j] + (q == 0 ? 4 : 0),
                                          b + (q == 1 ? lo_tile : 0));
                        }
                    }
                }
                wgmma_commit();
            }
        }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) hold(acc[j]);
    if (lane == 0) mbar_arrive(empty + (sc - 1) % RING);

    // accumulator 4i + 2h + q of tile j: row row0 + N_WG * WG_ROWS * j + 8h,
    // output channel 8i + 2 tq + q
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int e = row0 + j * N_WG * WG_ROWS + 8 * h;
            if (e >= e_hi) continue;  // a row no later conv reads
            const int g = g0 + e;
            const bool valid = g >= 0 && g < T;
            float* p = dst + e * S + 2 * tq;
#pragma unroll
            for (int i = 0; i < C / 8; ++i) {
                const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + 8 * i + 2 * tq));
                const float v0 = valid ? acc[j][4 * i + 2 * h] + bv.x : 0.f;
                const float v1 = valid ? acc[j][4 * i + 2 * h + 1] + bv.y : 0.f;
                float2* o = reinterpret_cast<float2*>(p + 8 * i);
                if (CONV1) {
                    *o = make_float2(leaky(v0), leaky(v1));
                } else {
                    const float2 x = *o;
                    *o = make_float2(x.x + v0, x.y + v1);
                }
            }
        }
    }
}

// conv_tiles with NT = n, for n from 0 to NT
template <int C, bool CONV1, bool BF16, int NT>
__device__ __forceinline__ void conv_tiles_n(int n, const float* src, float* dst, const char* ring,
                                             uint64_t* full, uint64_t* empty, uint32_t& sc,
                                             int row0, int k, int d, int e_hi, int g0, int T,
                                             const float* __restrict__ bias)
{
    if constexpr (NT == 0) {
        conv_tiles<C, CONV1, BF16, 0>(src, dst, ring, full, empty, sc, row0, k, d, e_hi, g0, T,
                                      bias);
    } else if (n == NT) {
        conv_tiles<C, CONV1, BF16, NT>(src, dst, ring, full, empty, sc, row0, k, d, e_hi, g0, T,
                                       bias);
    } else {
        conv_tiles_n<C, CONV1, BF16, NT - 1>(n, src, dst, ring, full, empty, sc, row0, k, d, e_hi,
                                             g0, T, bias);
    }
}

// One 'same' conv over the rows [HALO - rem, HALO + t_tile + rem) of the
// window: src and dst point at window row 0, which is global position g0.
// CONV1: reads leaky(src), stores leaky(masked conv) into dst. !CONV1: adds
// the masked conv into dst (the chain state). The conv's 64-row tiles go
// round the warpgroups, up to MTW each a pass. `sc` counts the weight
// stages consumed so far, as the producer counts them; wg is warp-uniform.
template <int C, bool CONV1, bool BF16>
__device__ __forceinline__ void conv_pass(const float* src, float* dst, const char* ring,
                                          uint64_t* full, uint64_t* empty, uint32_t& sc, int wg,
                                          int k, int d, int rem, int t_tile, int g0, int T,
                                          const float* __restrict__ bias)
{
    constexpr int MTW = Geometry<C, BF16>::MTW;
    const int warp = (threadIdx.x >> 5) & 3, gr = (threadIdx.x & 31) >> 2;
    const int e_lo = HALO - rem, e_hi = HALO + t_tile + rem;
    const int n_tiles = (e_hi - e_lo + WG_ROWS - 1) / WG_ROWS;
    for (int base = 0; base < n_tiles; base += N_WG * MTW) {
        const int n = min(MTW, max(0, (n_tiles - base - wg + N_WG - 1) / N_WG));
        const int row0 = e_lo + (base + wg) * WG_ROWS + warp * 16 + gr;
        conv_tiles_n<C, CONV1, BF16, MTW>(n, src, dst, ring, full, empty, sc, row0, k, d, e_hi,
                                          g0, T, bias);
    }
}

// The producer: every weight stage of the block's run, in the order the
// consumers take them, each into the next ring slot once it is free.
template <int C, bool BF16>
__device__ __forceinline__ void produce(const char* __restrict__ w, char* ring, uint64_t* full,
                                        uint64_t* empty, int t_tile, const MrfConfig& cfg)
{
    using G = Geometry<C, BF16>;
    uint32_t sc = 0;
    for (int blk = 0; blk < cfg.n_blocks; ++blk) {
        const int k = cfg.k[blk], c0 = (k - 1) / 2, n_stages = k * (C / G::KC);
        int rem = 0;
        for (int j = 0; j < cfg.n_dil; ++j) rem += c0 * (cfg.d[blk][j] + 1);
        for (int j = 0; j < cfg.n_dil; ++j) {
            for (int conv = 0; conv < 2; ++conv) {
                rem -= conv == 0 ? c0 * cfg.d[blk][j] : c0;
                const int n_tiles = (t_tile + 2 * rem + WG_ROWS - 1) / WG_ROWS;
                const int passes = (n_tiles + N_WG * G::MTW - 1) / (N_WG * G::MTW);
                const char* src = w + cfg.staged[blk][conv] + (size_t)j * n_stages * G::STAGE_BYTES;
                for (int p = 0; p < passes; ++p) {
                    for (int s = 0; s < n_stages; ++s, ++sc) {
                        const int slot = sc % RING;
                        mbar_wait(empty + slot, ((sc / RING) & 1) ^ 1);
                        bulk_load(ring + slot * G::STAGE_BYTES, src + (size_t)s * G::STAGE_BYTES,
                                  G::STAGE_BYTES, full + slot);
                    }
                }
            }
        }
    }
}

// The block's whole run for one (time tile, batch row): per chain, io.load
// fills the window rows [lo, hi) of xb (zero outside [0, T)), the chain's
// convs run, and io.fold adds its central rows into the output.
template <int C, bool BF16, class IO>
__device__ __forceinline__ void mrf_block(const float* __restrict__ w, float* hscratch, int T,
                                          int t_tile, const MrfConfig& cfg, const IO& io)
{
    using G = Geometry<C, BF16>;
    extern __shared__ __align__(128) char smem[];
    const int E = t_tile + 2 * HALO;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + RING;
    float* xb = reinterpret_cast<float*>(smem + 128);
    float* hb = G::HB_GLOBAL
        ? hscratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (E + WG_ROWS) * G::S
        : xb + (size_t)E * G::S;
    char* ring = smem + ring_offset<C, BF16>(E);
    const int g0 = blockIdx.x * t_tile - HALO;  // global position of window row 0

    if (threadIdx.x == 0) {
        for (int i = 0; i < RING; ++i) {
            mbar_init(full + i, 1);
            mbar_init(empty + i, N_WG * 4);  // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // the warpgroup, warp-uniform as ptxas sees it, so that no wgmma sits on
    // a path it takes for divergent
    const int wg = __shfl_sync(0xffffffff, (int)threadIdx.x / 128, 0);
    if (wg == N_WG) {  // the producer's warpgroup: one thread issues every copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == N_WG * 128)
            produce<C, BF16>(reinterpret_cast<const char*>(w), ring, full, empty, t_tile, cfg);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        uint32_t sc = 0;
        for (int blk = 0; blk < cfg.n_blocks; ++blk) {
            const int k = cfg.k[blk], c0 = (k - 1) / 2;
            int rem = 0;  // the chain's receptive field, then what its later convs reach
            for (int j = 0; j < cfg.n_dil; ++j) rem += c0 * (cfg.d[blk][j] + 1);
            io.load(xb, HALO - rem, HALO + t_tile + rem, g0);
            consumer_sync();
            for (int j = 0; j < cfg.n_dil; ++j) {
                const int d = cfg.d[blk][j];
                rem -= c0 * d;
                conv_pass<C, true, BF16>(xb, hb, ring, full, empty, sc, wg, k, d, rem, t_tile, g0,
                                         T, w + cfg.bias[blk][0] + j * C);
                consumer_sync();
                rem -= c0;
                conv_pass<C, false, BF16>(hb, xb, ring, full, empty, sc, wg, k, 1, rem, t_tile,
                                          g0, T, w + cfg.bias[blk][1] + j * C);
                consumer_sync();
            }
            io.fold(xb + HALO * G::S, blk, cfg.n_blocks);
            consumer_sync();  // before the next chain's window overwrites xb
        }
    }
}

// Checks a launch's chain geometry and fills cfg for a stage of C channels
// whose weights pack_mrf_weights packed: the f32 tuple (per chain W1
// (n_dil, k, C, C), B1 (n_dil, C), W2, B2), then per 4-D tensor in that
// order its 3xTF32 stages, then its bf16 stages. Returns a CUDA error code.
inline int mrf_config(MrfConfig& cfg, int C, int n_blocks, int n_dil, const int* ks,
                      const int* dils, bool bf16)
{
    if (n_blocks < 1 || n_blocks > MAX_BLOCKS || n_dil < 1 || n_dil > MAX_DIL)
        return (int)cudaErrorInvalidValue;
    cfg.n_blocks = n_blocks;
    cfg.n_dil = n_dil;
    long long floats = 0, tf32 = 0;
    for (int b = 0; b < n_blocks; ++b) {
        if (ks[b] != 3 && ks[b] != 7 && ks[b] != 11) return (int)cudaErrorInvalidValue;
        cfg.k[b] = ks[b];
        int reach = 0;
        for (int j = 0; j < n_dil; ++j) {
            cfg.d[b][j] = dils[b * n_dil + j];
            if (cfg.d[b][j] < 1) return (int)cudaErrorInvalidValue;
            reach += (ks[b] - 1) / 2 * (cfg.d[b][j] + 1);
        }
        if (reach > HALO) return (int)cudaErrorInvalidValue;
        const long long wsize = (long long)n_dil * ks[b] * C * C;
        cfg.bias[b][0] = floats + wsize;
        cfg.bias[b][1] = floats + 2 * wsize + n_dil * C;
        floats += 2 * (wsize + n_dil * C);
        tf32 += 2 * wsize;
    }
    // bytes: 3xTF32 stages hold each weight twice (hi, lo), bf16 ones half
    long long pos = 4 * floats + (bf16 ? 8 * tf32 : 0);
    for (int b = 0; b < n_blocks; ++b) {
        const long long wsize = (long long)n_dil * ks[b] * C * C;
        for (int c = 0; c < 2; ++c) {
            cfg.staged[b][c] = pos;
            pos += (bf16 ? 2 : 8) * wsize;
        }
    }
    return 0;
}
