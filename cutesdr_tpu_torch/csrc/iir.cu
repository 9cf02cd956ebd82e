// The biquad (direct form 2) over real rows, one launch (N2).
//
// Has no Pallas counterpart: it replaces the JAX package's
// lax.associative_scan of 2x2 affine maps (cutesdr_tpu/ops/iir.py:52-80),
// which the port ran as a Hillis-Steele prefix of ~486 torch kernels at
// 262,144 samples (ops/iir.py before this kernel; its form is the plain
// version, kernels/iir.biquad_plain):
//
//   w[n] = x[n] - a1*w[n-1] - a2*w[n-2]
//   y[n] = b0*w[n] + b1*w[n-1] + b2*w[n-2]
//
// With the state s[n] = (w[n], w[n-1]) each sample is the affine map
// s -> M s + (x[n], 0), M = [[-a1, -a2], [1, 0]]; maps compose "l then
// r" as (A_r A_l, A_r b_l + b_r).  The scan is the affine scan's (K3,
// scan.cu) with this 2x2 map in place of the scalar one: a row of n
// elements is cut into chunks of 2048, one block each; the block stages
// its chunk of x with coalesced loads, each thread composes its 8
// elements' maps, an ordered block scan gives every thread its prefix
// and the chunk its map, the look-back of scan_common.cuh (one pass,
// status words zeroed before the launch, chunk ids from a ticket) gives
// the chunk its start state, and the thread then steps its elements from
// its prefix state, forming y in the same pass; y goes back through the
// tile with coalesced stores.  The chunk holding a row's last element
// writes its final (w[n-1], w[n-2]).  A row of one chunk takes no
// look-back.
//
// Bound on the H100: x read and y written once (8 bytes a sample);
// ~20 float32 operations a sample (the thread's composition, the step
// and y).  At FM's 262,144 samples that is 2 MB, 0.6 us at 3.35 TB/s;
// the launch and the look-back's latency dominate.
//
// Numbers: float32 maps, composed in another order than the plain
// version's log-depth prefix.  chip_smoke.py holds the kernel to the
// float64 solve of the same float32 coefficients: no farther from it than
// 1.5x the plain version, at FM's rates, where the 3 kHz lowpass's poles
// sit closest to the unit circle.
#include "scan_common.cuh"

namespace cutesdr {

// s -> A s + b on s = (w[n], w[n-1]).
struct Aff2 {
    float a00, a01, a10, a11, b0, b1;
};
struct W2 {
    float w0, w1;                 // w[n], w[n-1]
};

__device__ __forceinline__ void identity(Aff2* m) {
    *m = {1.f, 0.f, 0.f, 1.f, 0.f, 0.f};
}
__device__ __forceinline__ Aff2 compose(Aff2 l, Aff2 r) {
    return {fmaf(r.a00, l.a00, r.a01 * l.a10),
            fmaf(r.a00, l.a01, r.a01 * l.a11),
            fmaf(r.a10, l.a00, r.a11 * l.a10),
            fmaf(r.a10, l.a01, r.a11 * l.a11),
            fmaf(r.a00, l.b0, fmaf(r.a01, l.b1, r.b0)),
            fmaf(r.a10, l.b0, fmaf(r.a11, l.b1, r.b1))};
}
__device__ __forceinline__ W2 apply(Aff2 f, W2 s) {
    return {fmaf(f.a00, s.w0, fmaf(f.a01, s.w1, f.b0)),
            fmaf(f.a10, s.w0, fmaf(f.a11, s.w1, f.b1))};
}
__device__ __forceinline__ Aff2 shfl_up(Aff2 x, int d) {
    return {__shfl_up_sync(FULL, x.a00, d), __shfl_up_sync(FULL, x.a01, d),
            __shfl_up_sync(FULL, x.a10, d), __shfl_up_sync(FULL, x.a11, d),
            __shfl_up_sync(FULL, x.b0, d), __shfl_up_sync(FULL, x.b1, d)};
}
__device__ __forceinline__ Aff2 shfl_down(Aff2 x, int d) {
    return {__shfl_down_sync(FULL, x.a00, d),
            __shfl_down_sync(FULL, x.a01, d),
            __shfl_down_sync(FULL, x.a10, d),
            __shfl_down_sync(FULL, x.a11, d),
            __shfl_down_sync(FULL, x.b0, d), __shfl_down_sync(FULL, x.b1, d)};
}
// A chunk map in its look-back slot (two 16-byte words), past L1.
__device__ __forceinline__ void publish(double2* slot, Aff2 m) {
    float4* f = reinterpret_cast<float4*>(slot);
    __stcg(f, make_float4(m.a00, m.a01, m.a10, m.a11));
    __stcg(f + 1, make_float4(m.b0, m.b1, 0.f, 0.f));
}
__device__ __forceinline__ void fetch(const double2* slot, Aff2* m) {
    const float4* f = reinterpret_cast<const float4*>(slot);
    const float4 a = __ldcg(f), b = __ldcg(f + 1);
    *m = {a.x, a.y, a.z, a.w, b.x, b.y};
}

struct BiquadArgs {
    const float* x;              // [rows, n]
    float a1, a2, b0, b1, b2;
    const float* w1;             // [rows] w[-1]
    const float* w2;             // [rows] w[-2]
    int n, nchunks, rows;
    bool vec;                    // x, y 16-byte aligned, n % 4 == 0
    float* y;                    // [rows, n]
    float* w_out;                // [2, rows]: w[n-1], then w[n-2] of each
                                 //   row
    Lookback lb;
    unsigned* ticket;
};

__global__ void __launch_bounds__(SCAN_THREADS) biquad_kernel(BiquadArgs s) {
    __shared__ __align__(16) float tile[SCAN_CHUNK];
    const bool chained = s.nchunks > 1;
    const int id = chunk_ticket(s.ticket, chained);
    const int row = id / s.nchunks, c = id - row * s.nchunks;
    const long long off = (long long)row * s.n + (long long)c * SCAN_CHUNK;
    const int len = min(SCAN_CHUNK, s.n - c * SCAN_CHUNK);
    load_tile(tile, s.x + off, len, s.vec);
    __syncthreads();
    float xv[SCAN_ITEMS];
    own_items(tile, xv);
    const int first = (int)threadIdx.x * SCAN_ITEMS;
    const float m00 = -s.a1, m01 = -s.a2;
    Aff2 t;
    identity(&t);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k)
        if (first + k < len)
            t = compose(t, Aff2{m00, m01, 1.f, 0.f, xv[k], 0.f});
    Aff2 total;
    const Aff2 ex = block_exclusive(t, &total);
    const W2 s0{s.w1[row], s.w2[row]};
    const W2 start = chained ? chunk_start(s.lb, row * s.nchunks, c,
                                           s.nchunks, total, s0)
                             : s0;
    W2 w = apply(ex, start);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        if (first + k >= len) break;
        const W2 prev = w;
        w = {fmaf(m00, prev.w0, fmaf(m01, prev.w1, xv[k])), prev.w0};
        // y as the plain version rounds it: three products, two sums
        xv[k] = __fadd_rn(__fadd_rn(__fmul_rn(s.b0, w.w0),
                                    __fmul_rn(s.b1, prev.w0)),
                          __fmul_rn(s.b2, prev.w1));
        if (c * SCAN_CHUNK + first + k == s.n - 1) {
            s.w_out[row] = w.w0;
            s.w_out[s.rows + row] = w.w1;
        }
    }
    __syncthreads();                      // every thread has read its items
    put_items(tile, xv);
    __syncthreads();
    store_tile(s.y + off, tile, len, s.vec);
}

}  // namespace cutesdr

using namespace cutesdr;

// y [rows, n] of the biquad over x [rows, n], from each row's (w[-1],
// w[-2]) = (w1[row], w2[row]); w_out [2, rows] takes each row's final
// w[n-1], then each row's final w[n-2].  vec: x, y 16-byte aligned and
// n % 4 == 0.  Rows of more than one chunk chain through the look-back
// memory (flags: rows * ceil(n / 2048) slots, agg: two 16-byte words a
// slot; ticket: one counter), all zeroed by the caller before the launch.
CUTESDR_API int cutesdr_biquad(const float* x, float a1, float a2, float b0,
                               float b1, float b2, const float* w1,
                               const float* w2, int n, int rows, int vec,
                               float* y, float* w_out, unsigned* flags,
                               double2* agg, unsigned* ticket, void* stream) {
    if (n <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
    const int nchunks = (n + SCAN_CHUNK - 1) / SCAN_CHUNK;
    BiquadArgs s{x, a1, a2, b0, b1, b2, w1, w2, n, nchunks, rows, vec != 0,
                 y, w_out, {flags, agg}, ticket};
    biquad_kernel<<<rows * nchunks, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        s);
    return (int)cudaGetLastError();
}
