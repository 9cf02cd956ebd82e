// The AGC's exact sequential averagers over C independent streams.
//
// The fallback is decided on the card, as JAX's lax.cond decides it
// inside the compiled step: the call takes the guess-verify solve's
// convergence flag (``skip``) and returns at once where it holds; where
// it does not, the exact result is written over the parallel one in
// place (attack last, decay last, timer, the max(attack, decay) series),
// so no select follows, and the call adds one to a device counter (the
// fallback count the host reads only when asked).  No host read, so the
// receiver's step can be captured and replayed as one CUDA graph.
//
// Has no Pallas counterpart.  It replaces the per-sample torch loop
// ops/agc._averager_scan of the port (the recurrence that JAX runs on the
// device as a lax.scan under lax.cond, cutesdr_tpu/ops/agc.py:134-156,
// 329-342), which the AGC takes when guess-verify has not converged:
//
//   attack:  alpha = pk > a ? ar : af;  a = (1-alpha)*a + alpha*pk
//   decay, two-rate:  the same with (dr, df) on d
//   decay, hang mode: pk > d: d = (1-dr)*d + dr*pk, timer = 0;
//                     else timer < hang_time: d held, timer + 1;
//                     else d = (1-df)*d + df*pk
//   emits max(a, d) per sample and the final (a, d, timer) of each stream.
//
// Bound on the H100: the loop-carried latency.  Each averager computes
// both branches' updates from the previous value (their products by
// alpha*pk are off the chain) and selects one by the compare, so the
// chain is a multiply, an add and a select, ~10 cycles a sample, and the
// ~20-25 instructions a sample issue in about as many cycles: ~3 ms at
// 262,144 samples whatever the memory does.  Design: one warp per stream
// (the stream in blockIdx.x), every lane running the same recurrence (the
// same bits in every lane, so nothing diverges).  The peaks come in with
// coalesced loads a tile (8 groups of 32) ahead of the one computed, and
// are staged in shared memory; each group's 32 peaks are read into
// registers (broadcast reads) before its 32 steps, so no read waits on
// the chain or the chain on a read.  Lane j keeps max(a, d) of the group's
// sample j, so the group's outputs leave with one coalesced store.  The
// loop body is one group, small enough for the instruction cache.
// Why not simpler (measured on the H100, PERF.md §6): lane 0 alone
// reading each peak from shared memory on the chain took ~56 cycles a
// sample; every lane taking each peak by a warp shuffle issued inside the
// step, ~42 (a shuffle cannot move past the step's exit test).
//
// Rounding: every product and sum is pinned with __fmul_rn/__fadd_rn, so
// nvcc contracts nothing into an FMA, in the plain loop's order; 1 - alpha
// rounds once, as the plain loop's float32 subtraction does.  The branch
// not taken is computed and dropped, so the value kept is the plain loop's
// one update.  Kernel and plain loop therefore agree to the bit.
#include "common.cuh"

namespace cutesdr {

constexpr int AGC_LANES = 32;
constexpr int AGC_GROUPS = 8;                        // 32-sample groups
constexpr int AGC_TILE = AGC_LANES * AGC_GROUPS;     // samples per tile

struct AgcSeqArgs {
    const float* peak;       // [C, n]
    int n;
    float ar, af, dr, df;    // attack and decay rise/fall alphas
    int hang_time;
    const float* a0;         // [C] initial states
    const float* d0;
    const int* timer0;
    float* a_out;            // [C] final states
    float* d_out;
    int* timer_out;
    float* mag;              // [C, n] max(a, d)
    const unsigned char* skip;   // null, or: set -> return at once
    int* count;              // null, or: +1 for a call that runs
};

// Both averagers' state and constants (1 - alpha rounded once).
struct AgcState {
    float a, d;
    int timer;
    float car, caf, cdr, cdf;
};

// One averager update (1 - alpha)*x + alpha*pk as the plain loop rounds
// it, from c = 1 - alpha and alpha*pk.
__device__ __forceinline__ float ave_step(float x, float c, float apk) {
    return __fadd_rn(__fmul_rn(c, x), apk);
}

// The ``len`` steps of one group from its peaks pk[0 .. len); returns
// max(a, d) after step ``lane``.  PARTIAL: len may be below 32 (the
// row's last group; warp-uniform).
template <bool HANG, bool PARTIAL>
__device__ __forceinline__ float run_group(const AgcSeqArgs& s, AgcState& st,
                                           const float* pk_s, int len,
                                           int lane) {
    float pk[AGC_LANES];
#pragma unroll
    for (int j = 0; j < AGC_LANES; ++j) pk[j] = pk_s[j];
    float out = 0.f;
#pragma unroll
    for (int j = 0; j < AGC_LANES; ++j) {
        if (PARTIAL && j >= len) break;
        const float a_up = ave_step(st.a, st.car, __fmul_rn(s.ar, pk[j]));
        const float a_dn = ave_step(st.a, st.caf, __fmul_rn(s.af, pk[j]));
        const float d_up = ave_step(st.d, st.cdr, __fmul_rn(s.dr, pk[j]));
        const float d_dn = ave_step(st.d, st.cdf, __fmul_rn(s.df, pk[j]));
        st.a = pk[j] > st.a ? a_up : a_dn;
        if (!HANG) {
            st.d = pk[j] > st.d ? d_up : d_dn;
        } else {
            const bool rising = pk[j] > st.d;
            const bool hold = st.timer < s.hang_time;
            st.d = rising ? d_up : (hold ? st.d : d_dn);
            st.timer = rising ? 0 : (hold ? st.timer + 1 : st.timer);
        }
        if (lane == j) out = fmaxf(st.a, st.d);
    }
    return out;
}

// Lane l's peak of each group of the tile at ``base``.
__device__ __forceinline__ void load_groups(float (&v)[AGC_GROUPS],
                                            const float* peak, int base,
                                            int n, int lane) {
#pragma unroll
    for (int g = 0; g < AGC_GROUPS; ++g) {
        const int i = base + g * AGC_LANES + lane;
        v[g] = i < n ? peak[i] : 0.f;
    }
}

template <bool HANG>
__global__ void __launch_bounds__(AGC_LANES) agc_seq_kernel(AgcSeqArgs s) {
    __shared__ __align__(16) float tile[AGC_TILE];
    if (s.skip && *s.skip) return;             // the solve converged
    if (s.count && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(s.count, 1);
    const long long row = (long long)blockIdx.x * s.n;
    const float* peak = s.peak + row;
    float* mag = s.mag + row;
    const int lane = threadIdx.x;
    AgcState st{s.a0[blockIdx.x], s.d0[blockIdx.x],
                HANG ? s.timer0[blockIdx.x] : 0,
                __fsub_rn(1.f, s.ar), __fsub_rn(1.f, s.af),
                __fsub_rn(1.f, s.dr), __fsub_rn(1.f, s.df)};
    float next[AGC_GROUPS];
    load_groups(next, peak, 0, s.n, lane);
    for (int base = 0; base < s.n; base += AGC_TILE) {
        __syncwarp();                          // the last tile's reads done
#pragma unroll
        for (int g = 0; g < AGC_GROUPS; ++g)
            tile[g * AGC_LANES + lane] = next[g];
        __syncwarp();
        if (base + AGC_TILE < s.n)             // in flight
            load_groups(next, peak, base + AGC_TILE, s.n, lane);
        const int groups = min(AGC_GROUPS,
                               (s.n - base + AGC_LANES - 1) / AGC_LANES);
#pragma unroll 1
        for (int g = 0; g < groups; ++g) {
            const int first = base + g * AGC_LANES;
            const int len = min(AGC_LANES, s.n - first);
            const float* pk_s = tile + g * AGC_LANES;
            const float out =
                len == AGC_LANES
                    ? run_group<HANG, false>(s, st, pk_s, len, lane)
                    : run_group<HANG, true>(s, st, pk_s, len, lane);
            if (lane < len) mag[first + lane] = out;
        }
    }
    if (lane == 0) {
        s.a_out[blockIdx.x] = st.a;
        s.d_out[blockIdx.x] = st.d;
        if (HANG) s.timer_out[blockIdx.x] = st.timer;
    }
}

}  // namespace cutesdr

using namespace cutesdr;

// Both averagers over peak [n_ch, n] from (a0, d0, timer0) [n_ch]: mag
// [n_ch, n] = max(a, d), the final states into a_out, d_out and (hang
// mode: hang_time >= 0) timer_out.  hang_time < 0: the two-rate decay.
// skip: null, or a device flag on which the call writes nothing and
// returns; count: null, or a device counter the call adds one to when it
// runs.
CUTESDR_API int cutesdr_agc_seq(const float* peak, int n, int n_ch, float ar,
                                float af, float dr, float df, int hang_time,
                                const float* a0, const float* d0,
                                const int* timer0, float* a_out, float* d_out,
                                int* timer_out, float* mag,
                                const unsigned char* skip, int* count,
                                void* stream) {
    if (n <= 0 || n_ch <= 0) return (int)cudaErrorInvalidValue;
    AgcSeqArgs s{peak, n, ar, af, dr, df, hang_time, a0, d0, timer0,
                 a_out, d_out, timer_out, mag, skip, count};
    const cudaStream_t st = (cudaStream_t)stream;
    if (hang_time >= 0)
        agc_seq_kernel<true><<<n_ch, AGC_LANES, 0, st>>>(s);
    else
        agc_seq_kernel<false><<<n_ch, AGC_LANES, 0, st>>>(s);
    return (int)cudaGetLastError();
}
