// Banded windowed-sinc fractional resampler over B independent streams.
//
// Replaces cutesdr_tpu/kernels/resamp1.py:resample_band (_kernel, reached
// through _resample_padded's pallas_call): for every output k at time
// t_k = t_int[k] + t_frac[k],
//     y[k] = sum_m w(m - t_k) z[m],  m = t_int[k]+1 .. t_int[k]+P,
// with the P-period Blackman-Harris windowed sinc w evaluated in the
// separable closed form of ops/resampler._sinc_band (the reference's
// CFractResampler table, dsp/fractresampler.cpp:101-114, without the
// table).  A channel bank runs its B streams in one launch (the stream in
// blockIdx.y, per-stream strides); one stream is B = 1.  Complex input is
// two planes under one set of weights.
//
// Bound on the H100: operations, and at the receiver's sizes the launch.
// Each output reads P taps of a span that its neighbours share, so the
// bytes are the input once plus the times and the output (~3.5 MB on the
// 262,144-sample flagship tail); the work is ~20 float32 operations and
// one IEEE division per tap.  Design: a block of 256 threads (four chunks
// of 64 outputs) stages its span of z, from its first chunk's base to its
// last chunk's base + M, in shared memory with coalesced loads; each
// thread then evaluates one output: the per-output terms once (sin(pi r),
// the parity, sincos of 2 pi k TP / P for k = 1..3), then only the P + 1
// taps that can be non-zero, where the plain version evaluates all M.
// The per-m factors a_k cos(2 pi k m / P), a_k sin(2 pi k m / P) come from
// a table made on the host in float64 and rounded to float32, as the
// plain version makes them.  The TPU kernel's 1024-aligned DMA, flat roll
// and [128, 128] transposes answered Mosaic's tiling and were dropped.
//
// Numbers: every operation is pinned with __fmul_rn/__fadd_rn/__fdiv_rn
// in the plain version's order (no FMA contraction, IEEE division, the
// |fi| < 1e-4 branch), and the 64-output chunks and their 128-aligned base
// b0 are the plain version's, so each weight is the same number in both;
// only the order of the tap sum differs.  In the reference-exact mode
// (interp = 0) the truncating 10,000-point grid is decided at the
// chunk-local offset from the chunk's clamped first time, as there.
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

// tables: [6, M] float32 — rows (cm_1, sm_1, cm_2, sm_2, cm_3, sm_3).
// A plane's sample g is zr[g * es] (es = 2 for interleaved complex).
__global__ void resamp_kernel(const float* __restrict__ zr,
                              const float* __restrict__ zi,
                              long long z_cstride, int es, int nz,
                              const int* __restrict__ t_int,
                              const float* __restrict__ t_frac,
                              long long t_cstride, int n_out,
                              const float* __restrict__ tables, int M,
                              int periods, int interp, int span_cap,
                              float* __restrict__ yr, float* __restrict__ yi,
                              long long y_cstride, int ys) {
    extern __shared__ float smem[];
    float* sr = smem;                       // [span_cap]
    float* si = smem + span_cap;            // [span_cap] (complex only)
    const int b = blockIdx.y;
    zr += b * z_cstride;
    if (zi) zi += b * z_cstride;
    t_int += b * t_cstride;
    t_frac += b * t_cstride;
    yr += b * y_cstride;
    if (yi) yi += b * y_cstride;

    const int k0 = blockIdx.x * RS_THREADS;
    const int lo = chunk_base(t_int, k0);
    for (int i = threadIdx.x; i < span_cap; i += RS_THREADS) {
        const int g = min(lo + i, nz - 1);   // edge-pad past the end
        sr[i] = zr[(long long)g * es];
        if (zi) si[i] = zi[(long long)g * es];
    }
    __syncthreads();

    const int k = k0 + threadIdx.x;
    if (k >= n_out) return;
    const int first = max(t_int[(k / RS_CHUNK) * RS_CHUNK], 0);
    const int b0 = (first / 128) * 128;
    const int Ti = t_int[k] - b0;
    float tf = t_frac[k];
    if (!interp) {
        const float offs = (float)(t_int[k] - first);
        const float q = ceilf(__fmul_rn(__fadd_rn(offs, tf), RS_PTS));
        tf = __fdiv_rn(__fsub_rn(q, __fmul_rn(offs, RS_PTS)), RS_PTS);
    }
    const int half = periods / 2;

    // per-output terms
    const float TP = __fadd_rn((float)floor_mod(Ti, periods), tf);
    float ct[3], st[3];
    for (int kk = 0; kk < 3; ++kk) {
        const float ang = __fmul_rn(
            TP, (float)(2.0 * 3.14159265358979323846 * (kk + 1) / periods));
        ct[kk] = cosf(ang);
        st[kk] = sinf(ang);
    }
    const float rf = rintf(tf);
    const float sin_r = sinf(__fmul_rn(__fsub_rn(tf, rf), RS_PI));
    const int n_round = Ti + (int)rf;
    const float par = floor_mod(n_round, 2) ? -1.f : 1.f;
    const float num0 = __fmul_rn(par, sin_r);

    float acc_r = 0.f, acc_i = 0.f;
    // m - P/2 - Ti = j; the weight can be non-zero for j in
    // (tf - P/2, P/2 + tf], tf in [0, 1]: j = 1 - P/2 .. P/2 + 1
    for (int j = 1 - half; j <= half + 1; ++j) {
        const int m = Ti + half + j;
        if (m < 0 || m >= M) continue;
        const float vc = __fsub_rn((float)j, tf);
        if (!(vc > -(float)half && vc <= (float)half)) continue;
        float w = RS_A0;
        for (int kk = 0; kk < 3; ++kk) {
            const float cm = tables[2 * kk * M + m];
            const float sm = tables[(2 * kk + 1) * M + m];
            w = __fadd_rn(w, __fadd_rn(__fmul_rn(ct[kk], cm),
                                       __fmul_rn(st[kk], sm)));
        }
        const float fi = __fmul_rn(vc, RS_PI);
        float s;
        if (fabsf(fi) < 1e-4f) {
            s = w;
        } else {
            const float sign_m = ((m + half) & 1) ? 1.f : -1.f;
            s = __fdiv_rn(__fmul_rn(w, __fmul_rn(num0, sign_m)), fi);
        }
        // z index b0 + m: staged, or (beyond the span a ratio far off its
        // nominal could reach) read from global memory
        const int idx = b0 + m - lo;
        const bool staged = idx >= 0 && idx < span_cap;
        const long long g = (long long)min(b0 + m, nz - 1) * es;
        acc_r = __fadd_rn(acc_r, __fmul_rn(s, staged ? sr[idx] : zr[g]));
        if (zi)
            acc_i = __fadd_rn(acc_i, __fmul_rn(s, staged ? si[idx] : zi[g]));
    }
    yr[(long long)k * ys] = acc_r;
    if (yi) yi[(long long)k * ys] = acc_i;
}

}  // namespace cutesdr

using namespace cutesdr;

// z planes [B, nz] (zi null for real input; es, ys = 2 for interleaved
// complex z and y), t_int / t_frac [B, n_out], outputs [B, n_out]; the
// channel strides are in floats.
CUTESDR_API int cutesdr_resamp(const void* zr, const void* zi,
                               long long z_cstride, int es, int nz,
                               const void* t_int,
                               const void* t_frac, long long t_cstride,
                               int n_out, const void* tables, int M,
                               int periods, int interp, int span_cap,
                               int n_streams, void* yr, void* yi,
                               long long y_cstride, int ys, void* stream) {
    if (n_out <= 0 || n_streams <= 0) return 0;
    const size_t smem = (zi ? 2 : 1) * (size_t)span_cap * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        resamp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_out + RS_THREADS - 1) / RS_THREADS, n_streams);
    resamp_kernel<<<grid, RS_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)zr, (const float*)zi, z_cstride, es, nz,
        (const int*)t_int, (const float*)t_frac, t_cstride, n_out,
        (const float*)tables, M, periods, interp, span_cap, (float*)yr,
        (float*)yi, y_cstride, ys);
    return (int)cudaGetLastError();
}
