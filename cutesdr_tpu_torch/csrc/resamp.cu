// Banded windowed-sinc fractional resampler over B independent streams.
//
// Replaces cutesdr_tpu/kernels/resamp1.py:resample_band (_kernel, reached
// through _resample_padded's pallas_call): for every output k at time
// t_k = t_int[k] + t_frac[k],
//     y[k] = sum_m w(m - t_k) z[m],  m = t_int[k]+1 .. t_int[k]+P+1,
// with the P-period Blackman-Harris windowed sinc w evaluated in the
// separable closed form of ops/resampler._sinc_band (the reference's
// CFractResampler table, dsp/fractresampler.cpp:101-114, without the
// table).  A channel bank runs its B streams in one launch (the stream in
// blockIdx.y, per-stream strides); one stream is B = 1.  Complex input is
// two planes under one set of weights.
//
// Bound on the H100: operations, and at the receiver's small blocks the
// latency of one output's chain.  The bytes are the input once plus the
// times and the output (~3.5 MB on the 262,144-sample rate-locked tail);
// the work is ~20 float32 operations and one division per tap, P + 1
// candidate taps per output.  One output per thread would leave the
// session's 1,024-sample block on 4 of the 132 SMs behind one thread's
// serial chain of taps.  Design:
//  * G lanes per output (kernels/resamp.launch_plan: 8 for a small call,
//    to spread it over the card and cut each thread's chain; 2 where two
//    lanes an output already fill the card's resident threads, since
//    every lane repeats its output's setup).  Lane l takes the taps
//    m = t_int + 1 + l + G i, i < TPL, fully unrolled and predicated (a
//    slot outside the window's support contributes nothing), and the G
//    partial sums meet in a fixed xor-shuffle tree.  A block of 256
//    threads evaluates 256 / G outputs at once and walks `opb`
//    consecutive outputs (32 to 256, so that large calls stage their
//    tables once per 256 outputs and still give each SM four blocks).
//  * The per-output terms (the window's sincos of 2 pi k T / P, k = 1..3,
//    and sin(pi r)) are spread over the group's lanes and broadcast with
//    shuffles: one sincos a lane at G = 8 (four outputs a warp share one
//    pass of sincos), two at G = 2.
//  * The window-factor table, as [3, M] pairs (a_k cos 2 pi k m / P,
//    a_k sin ...) so that a tap reads it in three 8-byte loads, and the
//    block's span of z (from its first chunk's 128-aligned base to its
//    last chunk's base + M) are staged in shared memory, padded by G TPL
//    so that the unrolled slots past the last tap stay inside them.  An
//    output whose taps leave the table or the span (a ratio far off the
//    one M was sized for) takes the guarded path: clamped table reads
//    and z from global memory.
//  * Odd P: P/2 is a half-integer, so the sine's argument pi (m - T - P/2)
//    is reduced about T + 1/2 (r = tf - 1/2, parity of t_int + 1) instead
//    of round(T); the window factors are the same for any P.
//  * Shared memory above 48 KB is granted once per size and kernel
//    (cudaFuncSetAttribute), never on a call that does not need it.
// What bounds it now (262,144-sample tail): shared-memory bandwidth and
// instruction throughput.  A tap slot reads 28 bytes of shared memory
// (~5.4 us for the call at 128 bytes a clock an SM) and executes ~22
// instructions (~6 us at four warp instructions a clock an SM), and the
// two compete for the same dispatch slots.
//
// Numbers: the window's three terms and the tap sum are FMAs, and the
// sinc quotient w * numerator / (pi v) takes the hardware reciprocal
// (__fdividef, 2 ulp), so a weight differs from the plain version's by a
// few float32 ulp (pinned arithmetic, no FMA and IEEE division, would
// keep it the same number at ~40% more instructions a tap).  The outputs agree with the plain version to ~2e-7 of the block's peak
// (tolerance 2e-5 x peak in chip_smoke.py, which also holds the refgold
// resampler fixture at >= 110 dB through this kernel).  The per-output
// position terms stay pinned (__fadd_rn etc.), and the 64-output chunks
// and their 128-aligned base b0 are the plain version's.  Odd P: the
// plain version takes the JAX package's direct form (sin(fi)/fi at each
// tap), which rounds its large arguments; the separable form agrees with
// it to 2e-6 of the weights' unit scale (tests/test_torch_sizes.py).  In
// the reference-exact mode (interp = 0) the truncating 10,000-point grid
// is decided at the chunk-local offset from the chunk's clamped first
// time, as there.
#include "common.cuh"

namespace cutesdr {

constexpr int RS_THREADS = 256;
constexpr int RS_CHUNK = 64;          // outputs per chunk (resampler._CHUNK)
constexpr float RS_PI = 3.14159265358979323846f;
constexpr float RS_PTS = 10000.f;     // SINC_PERIOD_PTS
constexpr float RS_A0 = 0.35875f;     // Blackman-Harris a0

__device__ __forceinline__ int floor_mod(int a, int b) {
    const int r = a % b;
    return r < 0 ? r + b : r;
}

__device__ __forceinline__ int chunk_base(const int* ti, int k) {
    const int first = max(ti[(k / RS_CHUNK) * RS_CHUNK], 0);
    return (first / 128) * 128;
}

// What the taps of one output share.
struct OutTerms {
    float ct[3], st[3];   // cos, sin of 2 pi k T / P
    float r;              // tf - (round(tf), or 1/2 for odd P)
    float numl;           // the sine numerator's sign at this lane's taps
    int j0;               // d - (P/2 + round) at this lane's first tap
};

// This lane's partial sum of one output over the taps m = m0 + LANES i.
// tab holds the pairs (a_k cos 2 pi k m / P, a_k sin ...), k = 1..3, as
// [3][Ms] float2.  GUARD: clamp table reads to [0, M) and read z from
// global memory outside the staged span.
template <int LANES, int TPL, bool CPLX, bool GUARD>
__device__ __forceinline__ void lane_taps(
        const OutTerms& o, int m0, int ntpl, const float2* tab, int Ms, int M,
        float hp, const float* sr, const float* si, int zoff, int span,
        const float* zr, const float* zi, int es, int nz, int b0,
        float& acc_r, float& acc_i) {
    const int nt = TPL ? TPL : ntpl;
#pragma unroll
    for (int i = 0; i < nt; ++i) {
        const int m = m0 + LANES * i;
        const float vc = (float)(o.j0 + LANES * i) - o.r;
        bool use = vc > -hp && vc <= hp;
        int mt = m;
        if (GUARD) {
            use = use && m >= 0 && m < M;
            mt = min(max(m, 0), M - 1);
        }
        float w = RS_A0;
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) {
            const float2 f = tab[kk * Ms + mt];
            w = fmaf(o.ct[kk], f.x, w);
            w = fmaf(o.st[kk], f.y, w);
        }
        const float fi = vc * RS_PI;
        const float s = fabsf(fi) < 1e-4f ? w : w * __fdividef(o.numl, fi);
        float vr, vi = 0.f;
        if (GUARD) {
            const int idx = zoff + m;
            const bool staged = idx >= 0 && idx < span;
            const long long g = (long long)min(max(b0 + m, 0), nz - 1) * es;
            vr = staged ? sr[idx] : zr[g];
            if (CPLX) vi = staged ? si[idx] : zi[g];
        } else {
            vr = sr[zoff + m];
            if (CPLX) vi = si[zoff + m];
        }
        if (use) {
            acc_r = fmaf(s, vr, acc_r);
            if (CPLX) acc_i = fmaf(s, vi, acc_i);
        }
    }
}

// tables: [3, M] float2 — the pairs (cm_k, sm_k), k = 1..3.
// A plane's sample g is zr[g * es] (es = 2 for interleaved complex).
template <int LANES, int TPL, bool CPLX>
__global__ void __launch_bounds__(RS_THREADS)
resamp_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
              long long z_cstride, int es, int nz,
              const int* __restrict__ t_int, const float* __restrict__ t_frac,
              long long t_cstride, int n_out,
              const float2* __restrict__ tables, int M, int periods,
              int interp, int opb, int ntpl, int span,
              float* __restrict__ yr, float* __restrict__ yi,
              long long y_cstride, int ys) {
    constexpr int SLOTS = RS_THREADS / LANES;   // outputs a pass
    constexpr int SPREAD = LANES < 4 ? LANES : 4;   // lanes taking terms
    extern __shared__ float2 smem2[];
    const int pad = LANES * ntpl;
    const int Ms = M + pad;                 // padded table row
    float2* tab = smem2;                    // [3, Ms]
    float* sr = (float*)(tab + 3 * Ms);     // [span + pad]
    float* si = sr + span + pad;            // [span + pad] (complex only)
    const int b = blockIdx.y;
    zr += b * z_cstride;
    if (CPLX) zi += b * z_cstride;
    t_int += b * t_cstride;
    t_frac += b * t_cstride;
    yr += b * y_cstride;
    if (CPLX) yi += b * y_cstride;

    const int k0 = blockIdx.x * opb;
    const int lo = chunk_base(t_int, k0);
    for (int row = 0; row < 3; ++row)
        for (int m = threadIdx.x; m < Ms; m += RS_THREADS)
            tab[row * Ms + m] = m < M ? tables[row * M + m]
                                      : make_float2(0.f, 0.f);
    for (int i = threadIdx.x; i < span + pad; i += RS_THREADS) {
        const long long g = (long long)min(lo + i, nz - 1) * es;  // edge-pad
        sr[i] = zr[g];
        if (CPLX) si[i] = zi[g];
    }
    __syncthreads();

    const int lane = threadIdx.x % LANES;
    const bool odd = periods & 1;
    const int half = periods / 2;
    const float hp = 0.5f * (float)periods;
    const float ang1 = (float)(2.0 * 3.14159265358979323846 / periods);
    const float ang2 = (float)(2.0 * 3.14159265358979323846 * 2 / periods);
    const float ang3 = (float)(2.0 * 3.14159265358979323846 * 3 / periods);
    const int kend = min(k0 + opb, n_out);
    // whole passes: every lane of a warp reaches the shuffles; a slot past
    // the end evaluates its group's last live output and writes nothing
    for (int kb = k0; kb < kend; kb += SLOTS) {
        const int kslot = kb + threadIdx.x / LANES;
        const int k = min(kslot, kend - 1);
        const int first = max(t_int[(k / RS_CHUNK) * RS_CHUNK], 0);
        const int b0 = (first / 128) * 128;
        const int Ti = t_int[k] - b0;
        float tf = t_frac[k];
        if (!interp) {
            const float offs = (float)(t_int[k] - first);
            const float q = ceilf(__fmul_rn(__fadd_rn(offs, tf), RS_PTS));
            tf = __fdiv_rn(__fsub_rn(q, __fmul_rn(offs, RS_PTS)), RS_PTS);
        }
        OutTerms o;
        const float rf = odd ? 0.5f : rintf(tf);
        o.r = __fsub_rn(tf, rf);
        const float TP = __fadd_rn((float)floor_mod(Ti, periods), tf);
        // the four per-output terms (sincos of 2 pi k T / P, k = 1..3, and
        // sin(pi r)) spread over the group's lanes, then broadcast
        float cv[4], sv[4];
#pragma unroll
        for (int t0 = 0; t0 < 4; t0 += SPREAD) {
            const int term = t0 + lane % SPREAD;
            const float arg = term == 3 ? o.r * RS_PI
                              : TP * (term == 0 ? ang1
                                                : term == 1 ? ang2 : ang3);
            float s, c;
            sincosf(arg, &s, &c);
#pragma unroll
            for (int j = 0; j < SPREAD; ++j) {
                cv[t0 + j] = __shfl_sync(FULL, c, j, LANES);
                sv[t0 + j] = __shfl_sync(FULL, s, j, LANES);
            }
        }
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) {
            o.ct[kk] = cv[kk];
            o.st[kk] = sv[kk];
        }
        const int nround = odd ? 1 : (int)rf;
        const float par = floor_mod(Ti + nround, 2) ? -1.f : 1.f;
        // the numerator's sign alternates with m; a lane's taps step by
        // LANES (even), so it is one sign a lane
        const int m0 = Ti + 1 + lane;
        o.numl = par * sv[3] * (((m0 + half) & 1) ? 1.f : -1.f);
        o.j0 = 1 + lane - half - nround;
        const int zoff = b0 - lo;
        // every tap of this output (m = Ti+1 .. Ti+P+1) inside the table
        // and the staged span: the same for the group's lanes
        const bool inside = Ti + 1 >= 0 && Ti + periods + 1 < M
                            && zoff + Ti + 1 >= 0
                            && zoff + Ti + periods + 1 < span;
        float acc_r = 0.f, acc_i = 0.f;
        if (inside)
            lane_taps<LANES, TPL, CPLX, false>(o, m0, ntpl, tab, Ms, M, hp,
                                               sr, si, zoff, span, zr, zi,
                                               es, nz, b0, acc_r, acc_i);
        else
            lane_taps<LANES, TPL, CPLX, true>(o, m0, ntpl, tab, Ms, M, hp,
                                              sr, si, zoff, span, zr, zi,
                                              es, nz, b0, acc_r, acc_i);
#pragma unroll
        for (int d = LANES / 2; d; d >>= 1) {
            acc_r += __shfl_xor_sync(FULL, acc_r, d, LANES);
            if (CPLX) acc_i += __shfl_xor_sync(FULL, acc_i, d, LANES);
        }
        if (lane == 0 && kslot < kend) {
            yr[(long long)k * ys] = acc_r;
            if (CPLX) yi[(long long)k * ys] = acc_i;
        }
    }
}

template <int LANES, int TPL, bool CPLX>
static int launch(dim3 grid, size_t smem, cudaStream_t st, const float* zr,
                  const float* zi, long long z_cstride, int es, int nz,
                  const int* t_int, const float* t_frac, long long t_cstride,
                  int n_out, const float2* tables, int M, int periods,
                  int interp, int opb, int ntpl, int span, float* yr,
                  float* yi, long long y_cstride, int ys) {
    // above the default 48 KB, grant this kernel the size once
    static size_t granted = 48 * 1024;
    if (smem > granted) {
        cudaError_t err = cudaFuncSetAttribute(
            resamp_kernel<LANES, TPL, CPLX>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        granted = smem;
    }
    resamp_kernel<LANES, TPL, CPLX><<<grid, RS_THREADS, smem, st>>>(
        zr, zi, z_cstride, es, nz, t_int, t_frac, t_cstride, n_out, tables,
        M, periods, interp, opb, ntpl, span, yr, yi, y_cstride, ys);
    return (int)cudaGetLastError();
}

template <bool CPLX>
static int dispatch(int lanes, int ntpl, dim3 grid, size_t smem,
                    cudaStream_t st, const float* zr, const float* zi,
                    long long z_cstride, int es, int nz, const int* t_int,
                    const float* t_frac, long long t_cstride, int n_out,
                    const float2* tables, int M, int periods, int interp,
                    int opb, int span, float* yr, float* yi,
                    long long y_cstride, int ys) {
#define RS_LAUNCH(L, T)                                                     \
    launch<L, T, CPLX>(grid, smem, st, zr, zi, z_cstride, es, nz, t_int,    \
                       t_frac, t_cstride, n_out, tables, M, periods, interp,\
                       opb, ntpl, span, yr, yi, y_cstride, ys)
    if (lanes == 8) {
        switch (ntpl) {
            case 4: return RS_LAUNCH(8, 4);
            case 8: return RS_LAUNCH(8, 8);
            default: return RS_LAUNCH(8, 0);    // a rolled loop of ntpl
        }
    }
    if (lanes == 2) {
        switch (ntpl) {
            case 16: return RS_LAUNCH(2, 16);
            case 32: return RS_LAUNCH(2, 32);
            default: return RS_LAUNCH(2, 0);
        }
    }
    return (int)cudaErrorInvalidValue;
#undef RS_LAUNCH
}

}  // namespace cutesdr

using namespace cutesdr;

// z planes [B, nz] (zi null for real input; es, ys = 2 for interleaved
// complex z and y), t_int / t_frac [B, n_out], outputs [B, n_out]; the
// channel strides are in floats; tables [3, M] float2.  lanes (per
// output, 2 or 8), opb (outputs per block), ntpl (taps per lane) and span
// (staged z samples) come from resamp.launch_plan.
CUTESDR_API int cutesdr_resamp(const void* zr, const void* zi,
                               long long z_cstride, int es, int nz,
                               const void* t_int, const void* t_frac,
                               long long t_cstride, int n_out,
                               const void* tables, int M, int periods,
                               int interp, int lanes, int opb, int ntpl,
                               int span, int n_streams, void* yr, void* yi,
                               long long y_cstride, int ys, void* stream) {
    if (n_out <= 0 || n_streams <= 0) return 0;
    if (opb <= 0 || ntpl <= 0) return (int)cudaErrorInvalidValue;
    const int pad = lanes * ntpl;
    const size_t smem = 3 * (size_t)(M + pad) * sizeof(float2)
                        + (zi ? 2 : 1) * (size_t)(span + pad) * sizeof(float);
    const dim3 grid((n_out + opb - 1) / opb, n_streams);
    const cudaStream_t st = (cudaStream_t)stream;
    return zi ? dispatch<true>(lanes, ntpl, grid, smem, st, (const float*)zr,
                               (const float*)zi, z_cstride, es, nz,
                               (const int*)t_int, (const float*)t_frac,
                               t_cstride, n_out, (const float2*)tables, M,
                               periods, interp, opb, span, (float*)yr,
                               (float*)yi, y_cstride, ys)
              : dispatch<false>(lanes, ntpl, grid, smem, st,
                                (const float*)zr, nullptr, z_cstride, es, nz,
                                (const int*)t_int, (const float*)t_frac,
                                t_cstride, n_out, (const float2*)tables, M,
                                periods, interp, opb, span, (float*)yr,
                                nullptr, y_cstride, ys);
}
