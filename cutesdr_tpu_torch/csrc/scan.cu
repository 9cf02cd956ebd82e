// Affine scan x[n] = A[n]*x[n-1] + B[n], two modes.
//
// Replaces cutesdr_tpu/kernels/scan1.py:first_order_scan (_kernel, mode
// "plain": A and B are read) and scan1.py:guess_round (_round_kernel, mode
// "round": A and B are built from the AGC branch pattern and the window
// peak, and the epilogue emits x, the re-derived pattern and the count of
// unforgiven mismatches).
//
// Bound on the H100: latency and launches, not bytes.  At the flagship's
// 262,144 elements an operand is 1 MB, which the card reads in well under
// a microsecond; the AGC calls this up to ~50 times per step, so what
// counts is the number of dependent passes.  Design: three launches on one
// stream — (1) each block composes its 2048-element chunk (8 elements per
// thread sequentially, then an ordered block scan) into one affine total;
// (2) one block scans the chunk totals into chunk start values; (3) each
// block recomputes its chunk from its start value and writes the outputs.
// The sequential per-thread composition keeps the work O(n); decoupled
// look-back (one pass) is later work.  The mismatch count is a block
// reduction plus one integer atomicAdd per block, so it is deterministic.
#include "scan_common.cuh"

namespace cutesdr {

enum Mode { PLAIN = 0, ROUND = 1 };

struct ScanArgs {
    const float* a;              // PLAIN: A
    const float* b;              // PLAIN: B
    const float* peak;           // ROUND: window peak
    const unsigned char* pat;    // ROUND: branch pattern (0/1)
    float rise, fall;            // ROUND: rise / fall alphas
    int n;
};

template <int MODE>
__device__ __forceinline__ Aff load(const ScanArgs& s, int i) {
    if (MODE == PLAIN) return {s.a[i], s.b[i]};
    const bool p = s.pat[i] != 0;
    return {p ? 1.f - s.rise : 1.f - s.fall,
            (p ? s.rise : s.fall) * s.peak[i]};
}

// This thread's composition of its SCAN_ITEMS consecutive elements.
template <int MODE>
__device__ Aff thread_total(const ScanArgs& s, int first) {
    Aff t = aff_id();
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int i = first + k;
        if (i < s.n) t = compose(t, load<MODE>(s, i));
    }
    return t;
}

template <int MODE>
__global__ void chunk_totals_kernel(ScanArgs s, float* __restrict__ tot_a,
                                    float* __restrict__ tot_b) {
    const int first = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
    Aff total;
    block_exclusive(thread_total<MODE>(s, first), &total);
    if (threadIdx.x == 0) {
        tot_a[blockIdx.x] = total.a;
        tot_b[blockIdx.x] = total.b;
    }
}

template <int MODE>
__global__ void apply_kernel(ScanArgs s, const float* __restrict__ starts,
                             float* __restrict__ x_out,
                             unsigned char* __restrict__ newpat,
                             int* __restrict__ count) {
    __shared__ int warp_count[32];
    const int first = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
    Aff total;
    Aff ex = block_exclusive(thread_total<MODE>(s, first), &total);
    float x = apply(ex, starts[blockIdx.x]);
    int mism = 0;
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int i = first + k;
        if (i >= s.n) break;
        const float prev = x;
        x = apply(load<MODE>(s, i), prev);
        x_out[i] = x;
        if (MODE == ROUND) {
            const float pk = s.peak[i];
            const bool np = pk > prev;
            newpat[i] = np;
            // same predicates as scan1.py:_round_kernel; each branch's
            // update (1-a)*prev + a*pk rounds once, as an FMA, like the
            // plain version (scan.guess_round_plain) and XLA:CPU
            const float up = fmaf(1.f - s.rise, prev, __fmul_rn(s.rise, pk));
            const float dn = fmaf(1.f - s.fall, prev, __fmul_rn(s.fall, pk));
            mism += (np != (s.pat[i] != 0)) && (pk != prev) && !(up == dn);
        }
    }
    if (MODE == ROUND) {
        for (int d = 16; d; d >>= 1) mism += __shfl_down_sync(FULL, mism, d);
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        if (lane == 0) warp_count[warp] = mism;
        __syncthreads();
        if (threadIdx.x == 0) {
            int c = 0;
            for (int w = 0; w < (int)(blockDim.x >> 5); ++w) c += warp_count[w];
            if (c) atomicAdd(count, c);
        }
    }
}

template <int MODE>
static int run(const ScanArgs& s, const float* x0, float* x_out,
               unsigned char* newpat, int* count, float* tot_a, float* tot_b,
               float* starts, cudaStream_t stream) {
    const int nchunks = (s.n + SCAN_CHUNK - 1) / SCAN_CHUNK;
    chunk_totals_kernel<MODE><<<nchunks, SCAN_THREADS, 0, stream>>>(
        s, tot_a, tot_b);
    chunk_starts_kernel<<<1, SCAN_THREADS, 0, stream>>>(tot_a, tot_b,
                                                        nchunks, x0, starts);
    apply_kernel<MODE><<<nchunks, SCAN_THREADS, 0, stream>>>(
        s, starts, x_out, newpat, count);
    return (int)cudaGetLastError();
}

}  // namespace cutesdr

using namespace cutesdr;

CUTESDR_API int cutesdr_scan_plain(const float* a, const float* b,
                                   const float* x0, int n, float* x,
                                   float* tot_a, float* tot_b, float* starts,
                                   void* stream) {
    ScanArgs s{a, b, nullptr, nullptr, 0.f, 0.f, n};
    return run<PLAIN>(s, x0, x, nullptr, nullptr, tot_a, tot_b, starts,
                      (cudaStream_t)stream);
}

CUTESDR_API int cutesdr_scan_round(const float* peak,
                                   const unsigned char* pattern, float rise,
                                   float fall, const float* x0, int n,
                                   float* x, unsigned char* newpat,
                                   int* count, float* tot_a, float* tot_b,
                                   float* starts, void* stream) {
    ScanArgs s{nullptr, nullptr, peak, pattern, rise, fall, n};
    return run<ROUND>(s, x0, x, newpat, count, tot_a, tot_b, starts,
                      (cudaStream_t)stream);
}
