// One whole anti-aliased SnakeBeta activation (BigVGAN's Activation1d) on
// Hopper (sm_90a), f32, in one pass, on channels-last rows.
//
// Replaces no TPU kernel: the JAX package has no BigVGAN. It exists because
// BigVGAN-v2 runs 18 of these activations per upsampling stage and one
// after the last, and PyTorch runs each as some ten launches (two replicate
// pads, a depthwise transposed conv, a slice copy, the snake's elementwise
// ops, a depthwise conv), each reading and writing the 2x-rate signal.
// ops/aa_snake.py::aa_snake_reference is the plain version.
//
// x and y are (B, C, L) seen through (B, L, C) storage: sample q of channel
// c of row b lies at (b L + q) C + c, so one time step of all channels is
// one contiguous run of C floats. That is the layout cuDNN's NHWC convs
// read and write, so the generator keeps every activation in it.
//
// Per channel c, with p the input sample:
//   u[2p]     = 2 sum_j h_up[11 - 2j] x[clamp(p - 3 + j)],  j = 0..5
//   u[2p + 1] = 2 sum_j h_up[10 - 2j] x[clamp(p - 2 + j)]
//          (replicate pad 5, transposed conv at stride 2, 15 cut each end;
//          clamp to [0, L - 1])
//   v[m] = u[m] + inv_mag[c] sin(u[m] freq[c])^2,  m in [0, 2L)
//   y[q] = sum_k h_down[k] v[clamp(2q + k - 5, 0, 2L - 1)],  k = 0..11
//          (replicate pad 5 left, 6 right, conv at stride 2)
// Pair p gives E = v[2p] and O = v[2p + 1]. Output q reads the pairs
// q - 3 .. q + 3 (O of the first six, E of the last six), and pair p reads
// the inputs p - 3 .. p + 3. The edges are the published ones exactly: Up
// replicates x's edge, Down replicates the activated signal's edge, so a
// pair p < 0 stands for v[0] (E and O both the E of pair 0) and a pair
// p > L - 1 for v[2L - 1] (both the O of pair L - 1).
//
// What bounds it on this card: bytes. Per output sample it reads 4 bytes
// and writes 4, against two Up dots of 6 taps, two sines and a 12-tap Down
// dot (~58 FLOPs), below the card's 20 f32 FLOPs a byte; but only if the
// instructions per sample stay few (at 8 bytes a sample the memory allows
// ~70 instructions a sample). The design:
//   * A thread owns V adjacent channels (V = 2 where C allows: 8-byte
//     loads and stores) and one run of output samples of one row.
//     Neighbouring threads take neighbouring channel vectors of the same
//     run, so every load of a time step is coalesced, whatever C is. Four
//     channels a thread (16-byte vectors) took 134 registers against 72
//     and ran 5-15 % slower at the published stages on an H100.
//   * The thread walks its run in steps of R = 4 outputs, sliding a window
//     in registers: each step loads the R inputs it has not seen, computes
//     the R new pairs, writes R outputs, and carries the last HALO = 6
//     inputs and pairs to the next step. Nothing goes through shared
//     memory. A run's first step recomputes the 6 pairs before it from 12
//     inputs (the halo), which the run before read too, so from L2.
//   * The run length is chosen by the wrapper from B, C and L (ops/
//     aa_snake.py::plan): the longest that still gives every SM enough
//     threads, so that the small stages fill the card as the large do.
//   * The sine: |freq u| is not bounded, so it is reduced to [-pi, pi]
//     first (two FMAs against 2 pi split in two floats), then __sinf (the
//     SFU, absolute error 2^-21.4 there). sinf's general path costs ~40
//     instructions and a stack frame.
//   * The filters come in as device pointers (12 floats each), so no call
//     copies anything from the host and a CUDA graph captures the launch.
//     Up's taps are doubled (2 h x is exact as 2 (h x)).

#include <cuda_runtime.h>

namespace {

constexpr int TAPS = 12;     // the Kaiser-sinc filter's length (Up and Down)
constexpr int R = 4;         // outputs a thread computes per step (ops/aa_snake.py STEP)
constexpr int HALO = 6;      // inputs and pairs a step carries to the next
constexpr int W = HALO + R;  // the window: inputs q .. q + 9, pairs q - 3 .. q + 6
constexpr int THREADS = 128;
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

// V floats from p (aligned to 4 V bytes) into d, and back
template <int V>
__device__ __forceinline__ void load(float (&d)[V], const float* p)
{
    if constexpr (V == 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(p));
        d[0] = t.x; d[1] = t.y;
    } else {
        d[0] = __ldg(p);
    }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&s)[V])
{
    if constexpr (V == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(s[0], s[1]);
    } else {
        p[0] = s[0];
    }
}

// the pair whose inputs are w[0 .. 6] (p - 3 .. p + 3): E and O, per channel
template <int V>
__device__ __forceinline__ void pair(float (&e)[V], float (&o)[V], float (*w)[V],
                                     const float (&hu)[TAPS], const float (&a)[V],
                                     const float (&ib)[V])
{
#pragma unroll
    for (int v = 0; v < V; ++v) {
        float ue = 0.0f, uo = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
            ue = fmaf(hu[11 - 2 * j], w[j][v], ue);
            uo = fmaf(hu[10 - 2 * j], w[j + 1][v], uo);
        }
        e[v] = snake(ue, a[v], ib[v]);
        o[v] = snake(uo, a[v], ib[v]);
    }
}

// pair i, past the row's end: both samples the O of pair i - 1
template <int V>
__device__ __forceinline__ void past_end(float (*E)[V], float (*O)[V], int i)
{
#pragma unroll
    for (int v = 0; v < V; ++v) {
        E[i][v] = O[i - 1][v];
        O[i][v] = O[i - 1][v];
    }
}

}  // namespace

// One thread: channels c0 .. c0 + V - 1 of row b, outputs q0 .. q0 + run - 1
// (fewer at the row's end). Task t of n_tasks: vector t % (C / V), run
// t / (C / V), the run (b, q0 / run) in row-major order.
template <int V>
__global__ void __launch_bounds__(THREADS)
aa_snake_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ freq, const float* __restrict__ inv_mag,
                const float* __restrict__ h_up, const float* __restrict__ h_down,
                int C, int L, int run, int runs_per_row, long long n_tasks)
{
    const long long task = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (task >= n_tasks) return;
    const int nv = C / V;
    const long long r = task / nv;
    const int c0 = (int)(task - r * nv) * V;
    const int b = (int)(r / runs_per_row);
    const int q0 = (int)(r - (long long)b * runs_per_row) * run;
    const float* __restrict__ xr = x + (long long)b * L * C + c0;
    float* __restrict__ yr = y + (long long)b * L * C + c0;

    float hu[TAPS], hd[TAPS], a[V], ib[V];
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
        hu[k] = 2.0f * __ldg(h_up + k);
        hd[k] = __ldg(h_down + k);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
        a[v] = __ldg(freq + c0 + v);
        ib[v] = __ldg(inv_mag + c0 + v);
    }

    // xw[k] = x[q + k]; E[i], O[i] = pair q - 3 + i (q the step's first output)
    float xw[W][V], E[W][V], O[W][V];
    {   // the halo: pairs q0 - 3 .. q0 + 2 from x[q0 - 6 .. q0 + 5]
        float t[2 * HALO][V];
#pragma unroll
        for (int k = 0; k < 2 * HALO; ++k)
            load<V>(t[k], xr + min(max(q0 - HALO + k, 0), L - 1) * C);
#pragma unroll
        for (int i = 0; i < HALO; ++i) pair<V>(E[i], O[i], t + i, hu, a, ib);
#pragma unroll
        for (int k = 0; k < HALO; ++k)
#pragma unroll
            for (int v = 0; v < V; ++v) xw[k][v] = t[HALO + k][v];
        if (q0 + 2 > L - 1) {
#pragma unroll
            for (int i = 1; i < HALO; ++i)
                if (q0 - 3 + i > L - 1) past_end<V>(E, O, i);
        }
        if (q0 == 0) {  // pairs -3 .. -1 stand for v[0]
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
                for (int v = 0; v < V; ++v) E[i][v] = O[i][v] = E[3][v];
        }
    }

    const int q_end = min(q0 + run, L);
    for (int q = q0; q < q_end; q += R) {
#pragma unroll
        for (int k = 0; k < R; ++k)
            load<V>(xw[HALO + k], xr + min(q + HALO + k, L - 1) * C);
#pragma unroll
        for (int i = HALO; i < W; ++i) pair<V>(E[i], O[i], xw + (i - HALO), hu, a, ib);
        if (q + R + 2 > L - 1) {
#pragma unroll
            for (int i = HALO; i < W; ++i)
                if (q - 3 + i > L - 1) past_end<V>(E, O, i);
        }
#pragma unroll
        for (int s = 0; s < R; ++s) {
            float out[V];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                float acc = 0.0f;
#pragma unroll
                for (int j = 0; j < 6; ++j) {
                    acc = fmaf(hd[2 * j], O[s + j][v], acc);
                    acc = fmaf(hd[2 * j + 1], E[s + j + 1][v], acc);
                }
                out[v] = acc;
            }
            if (q + s < L) store<V>(yr + (q + s) * C, out);
        }
#pragma unroll
        for (int k = 0; k < HALO; ++k)
#pragma unroll
            for (int v = 0; v < V; ++v) {
                xw[k][v] = xw[k + R][v];
                E[k][v] = E[k + R][v];
                O[k][v] = O[k + R][v];
            }
    }
}

extern "C" int aa_snake_launch(const float* x, float* y, const float* freq, const float* inv_mag,
                               const float* h_up, const float* h_down, int B, int C, int L,
                               int V, int run, void* stream)
{
    if (B < 1 || C < 1 || L < 1 || run < R || run % R != 0 || (V != 1 && V != 2)
        || C % V != 0 || (long long)L * C > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int runs_per_row = (L + run - 1) / run;
    const long long n_tasks = (long long)(C / V) * B * runs_per_row;
    const long long blocks = (n_tasks + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (V == 2)
        aa_snake_kernel<2><<<(unsigned)blocks, THREADS, 0, s>>>(
            x, y, freq, inv_mag, h_up, h_down, C, L, run, runs_per_row, n_tasks);
    else
        aa_snake_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(
            x, y, freq, inv_mag, h_up, h_down, C, L, run, runs_per_row, n_tasks);
    return (int)cudaGetLastError();
}

extern "C" const char* aa_snake_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
