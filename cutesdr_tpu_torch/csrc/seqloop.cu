// Exact sequential FM and SAM PLL loops over C independent streams.
//
// Replaces cutesdr_tpu/kernels/seqloop.py:fm_pll_scan (_fm_kernel) and
// seqloop.py:sam_pll_scan (_sam_kernel): the per-sample reference
// recurrences (dsp/fmdemod.cpp:62-89, dsp/samdemod.cpp:78-110) that the
// demodulators fall back to when neither parallel tier is exact
// (acquisition, clamp hits, carrier-less noise).  A channel bank runs
// its C streams in one launch, as the JAX bank vmaps its scan; one stream
// is C = 1.
//
//   FM:  err = -wrap(th + phase)            emits freq (post-update), err
//   SAM: err =  wrap(th - phase)            emits phase (pre-update)
//   both: freq  = clip(freq + beta*err, +-limit)
//         phase = wrap(phase + freq + alpha*err)
//   final state: (phase mod 2pi, freq)
//
// Bound on the H100: the loop-carried latency.  Every sample is a chain of
// about a dozen dependent float32 operations (~60 cycles), so 262,144
// samples take a few ms whatever the memory does; one SM works per
// stream, the others idle.  Design: one block of one warp per stream
// (the stream in blockIdx.x, state and series at its row).  The warp stages a
// 1024-sample tile of theta in shared memory with coalesced loads, lane 0
// runs the recurrence over the tile into shared memory, and the warp
// stores the outputs coalesced.  The next tile's loads are issued into
// registers before lane 0 starts, so they arrive while it computes.  The
// TPU kernel's (8, 128) output tiles, SMEM-resident theta and 1,024-sample
// grid steps answer Mosaic rules and were dropped: this kernel streams
// from global memory and takes any n.
//
// Rounding: every operation is pinned with __fmul_rn/__fadd_rn/__fsub_rn,
// so nvcc contracts nothing into an FMA, and the wrap is the plain
// version's (ops/pll.wrap_pi): e - 2pi*rint(e * (1/2pi)), round half to
// even.  The kernel and its plain version therefore agree to the bit.
// The TPU kernel uses a conditional subtract instead (seqloop._wrap):
// the two agree except within an ulp of odd multiples of pi, where the
// round form can keep a value just above pi that the conditional form
// moves down by 2pi.
#include "common.cuh"

namespace cutesdr {

constexpr int SEQ_LANES = 32;
constexpr int SEQ_PER_LANE = 32;
constexpr int SEQ_TILE = SEQ_LANES * SEQ_PER_LANE;   // samples per tile
constexpr float SEQ_TWO_PI = 6.283185307179586f;     // float32(2pi)

__device__ __forceinline__ float wrap_pi(float e, float inv_two_pi) {
    const float r = rintf(__fmul_rn(e, inv_two_pi));
    return __fsub_rn(e, __fmul_rn(SEQ_TWO_PI, r));
}

__device__ __forceinline__ float clampf(float x, float limit) {
    return fminf(fmaxf(x, -limit), limit);            // torch.clamp order
}

// x mod 2pi with the sign of 2pi, as torch.remainder: fmod (exact), then
// one rounded add where the signs differ
__device__ __forceinline__ float mod_two_pi(float x) {
    const float m = fmodf(x, SEQ_TWO_PI);
    return m < 0.f ? __fadd_rn(m, SEQ_TWO_PI) : m;
}

// This lane's coalesced share of the tile starting at ``base``.
__device__ __forceinline__ void fetch(float (&next)[SEQ_PER_LANE],
                                      const float* theta, int n, int base,
                                      int lane) {
#pragma unroll
    for (int k = 0; k < SEQ_PER_LANE; ++k) {
        const int i = base + k * SEQ_LANES + lane;
        next[k] = i < n ? theta[i] : 0.f;
    }
}

struct PllArgs {
    const float* theta;      // [C, n]
    int n;
    float alpha, beta, limit;
    const float* state0;     // [C, 2] phase, freq
    float* out0;             // [C, n] FM: freq series;  SAM: pre-update phase
    float* out1;             // [C, n] FM: err series;   SAM: unused
    float* state;            // [C, 2] phase mod 2pi, freq
};

template <bool FM>
__global__ void __launch_bounds__(SEQ_LANES)
pll_kernel(PllArgs a) {
    __shared__ float th_s[SEQ_TILE];
    __shared__ float o0_s[SEQ_TILE];
    __shared__ float o1_s[FM ? SEQ_TILE : 1];
    const long long row = (long long)blockIdx.x * a.n;
    a.theta += row;
    a.out0 += row;
    if (FM) a.out1 += row;
    a.state0 += 2 * blockIdx.x;
    a.state += 2 * blockIdx.x;
    const int lane = threadIdx.x;
    const float inv_two_pi = __fdiv_rn(1.f, SEQ_TWO_PI);
    float phase = a.state0[0], freq = a.state0[1];
    float next[SEQ_PER_LANE];
    fetch(next, a.theta, a.n, 0, lane);
    for (int base = 0; base < a.n; base += SEQ_TILE) {
        const int len = min(SEQ_TILE, a.n - base);
#pragma unroll
        for (int k = 0; k < SEQ_PER_LANE; ++k)
            th_s[k * SEQ_LANES + lane] = next[k];
        __syncwarp();
        if (base + SEQ_TILE < a.n)                     // in flight
            fetch(next, a.theta, a.n, base + SEQ_TILE, lane);
        if (lane == 0) {
#pragma unroll 4
            for (int j = 0; j < len; ++j) {
                const float th = th_s[j];
                float err;
                if (FM) {
                    err = -wrap_pi(__fadd_rn(th, phase), inv_two_pi);
                } else {
                    err = wrap_pi(__fsub_rn(th, phase), inv_two_pi);
                    o0_s[j] = phase;
                }
                freq = clampf(__fadd_rn(freq, __fmul_rn(a.beta, err)),
                              a.limit);
                phase = wrap_pi(__fadd_rn(__fadd_rn(phase, freq),
                                          __fmul_rn(a.alpha, err)),
                                inv_two_pi);
                if (FM) {
                    o0_s[j] = freq;
                    o1_s[j] = err;
                }
            }
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < SEQ_PER_LANE; ++k) {
            const int j = k * SEQ_LANES + lane;
            if (j < len) {
                a.out0[base + j] = o0_s[j];
                if (FM) a.out1[base + j] = o1_s[j];
            }
        }
        __syncwarp();
    }
    if (lane == 0) {
        a.state[0] = mod_two_pi(phase);
        a.state[1] = freq;
    }
}

}  // namespace cutesdr

using namespace cutesdr;

CUTESDR_API int cutesdr_fm_pll(const float* theta, int n, int n_ch,
                               float alpha, float beta, float limit,
                               const float* state0, float* freqs, float* err,
                               float* state, void* stream) {
    if (n_ch <= 0) return 0;
    PllArgs a{theta, n, alpha, beta, limit, state0, freqs, err, state};
    pll_kernel<true><<<n_ch, SEQ_LANES, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

CUTESDR_API int cutesdr_sam_pll(const float* theta, int n, int n_ch,
                                float alpha, float beta, float limit,
                                const float* state0, float* prev,
                                float* state, void* stream) {
    if (n_ch <= 0) return 0;
    PllArgs a{theta, n, alpha, beta, limit, state0, prev, nullptr, state};
    pll_kernel<false><<<n_ch, SEQ_LANES, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
