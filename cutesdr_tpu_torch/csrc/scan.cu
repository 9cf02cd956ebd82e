// Affine scan x[n] = A[n]*x[n-1] + B[n], and the AGC's guess-verify solve.
//
// Replaces cutesdr_tpu/kernels/scan1.py:first_order_scan (_kernel: A and
// B are read; cutesdr_scan_plain) and scan1.py:guess_round (_round_kernel:
// A and B are built from the AGC branch pattern and the window peak, and
// the epilogue emits x, the re-derived pattern and the count of
// unforgiven mismatches), together with the loop around it, JAX's
// ops/agc._two_rate_parallel: a lax.while_loop of rounds after a warm
// start, exiting when a round's count is 0 or after n_iters rounds
// (cutesdr_scan_solve).
//
// Bound on the H100: latency, launches and host reads, not bytes.  At the
// flagship's 262,144 elements an operand is 1 MB, which the card reads in
// well under a microsecond.
//  * The plain scan is three launches on one stream: (1) each block
//    composes its 2048-element chunk (8 elements per thread sequentially,
//    then an ordered block scan) into one affine total; (2) one block
//    scans the chunk totals into chunk start values; (3) each block
//    recomputes its chunk from its start value and writes the outputs.
//  * The guess-verify solve would be one such triple per round, driven
//    from Python with a host read of the count after every round (~0.1 ms
//    of host time a round on the card for ~9 us of device work).  It is
//    ONE cooperative launch (cudaLaunchCooperativeKernel, at
//    most the co-resident block count, each block persistent over the
//    chunks blockIdx.x, + gridDim.x, ...) that runs the warm start (round
//    0: the geometric-mean rate, which derives the first pattern) and
//    every round on the device.  A round is: each block composes its
//    chunks' totals from the pattern; a grid barrier; each block scans the
//    totals itself (the same block scan as (2), so every block gets the
//    same start values) and applies its chunks, writing x and the
//    re-derived pattern in place and counting mismatches into that
//    round's slot; a grid barrier; every block reads the round's count
//    and stops at 0 or after n_iters rounds.  The last round's count and
//    the round number are written for the host, which reads them once per
//    block of the receiver, if at all.  A barrier of its own over a plain
//    launch could deadlock while another stream (the session's ingest)
//    holds SMs; the cooperative launch guarantees co-residency.
//  * Data one block writes and another reads after a barrier (the chunk
//    totals, the counts) are read with ld.global.cg, past the L1 cache,
//    which is not coherent across SMs.
//
// Numbers: the solve composes, scans and applies in the same order as the
// three-launch form, so its x is bitwise the three-launch rounds' x.
// Against the float64 solve of the same pattern and float32 coefficients
// the chunked scan's reassociation error is ~2e-6 decades at the attack
// averager's rates and ~2e-5 at the decay averager's 12,500-sample memory,
// a quarter of the plain version's log-depth solve there (chip_smoke.py
// holds the kernel to the plain version within 1e-5 plus the plain
// version's own error).  The counts are integer block reductions plus one
// atomicAdd per block, so they are deterministic.
#include <cooperative_groups.h>

#include "scan_common.cuh"

namespace cutesdr {

namespace cg = cooperative_groups;

// ------------------------------------------------------------ plain scan --

__device__ __forceinline__ Aff thread_total(const float* a, const float* b,
                                            int n, int first) {
    Aff t = aff_id();
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int i = first + k;
        if (i < n) t = compose(t, Aff{a[i], b[i]});
    }
    return t;
}

__global__ void chunk_totals_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b, int n,
                                    float* __restrict__ tot_a,
                                    float* __restrict__ tot_b) {
    const int first = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
    Aff total;
    block_exclusive(thread_total(a, b, n, first), &total);
    if (threadIdx.x == 0) {
        tot_a[blockIdx.x] = total.a;
        tot_b[blockIdx.x] = total.b;
    }
}

__global__ void apply_kernel(const float* __restrict__ a,
                             const float* __restrict__ b, int n,
                             const float* __restrict__ starts,
                             float* __restrict__ x_out) {
    const int first = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
    Aff total;
    Aff ex = block_exclusive(thread_total(a, b, n, first), &total);
    float x = apply(ex, starts[blockIdx.x]);
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int i = first + k;
        if (i >= n) break;
        x = apply(Aff{a[i], b[i]}, x);
        x_out[i] = x;
    }
}

// ------------------------------------------------------ guess-verify solve --

struct SolveArgs {
    const float* peak;
    const unsigned char* pat_in;   // round 1's pattern; null: warm start
    unsigned char* pat;            // each round's re-derived pattern
    float* x;
    const float* x0;
    float rise, fall, ag;          // ag: the warm start's rate
    int n, nchunks, n_iters;
    float* tot_a;                  // [nchunks] chunk totals
    float* tot_b;
    int* counts;                   // [n_iters + 1] mismatches per round
    int* result;                   // [2]: last count == 0, rounds run
};

// A and B of element i: the warm start's constant rate, or the branch of
// the pattern (the same products as scan.guess_round_plain).
__device__ __forceinline__ Aff solve_load(const SolveArgs& s,
                                          const unsigned char* pat, bool warm,
                                          int i) {
    if (warm) return {1.f - s.ag, __fmul_rn(s.ag, s.peak[i])};
    const bool p = pat[i] != 0;
    return {p ? 1.f - s.rise : 1.f - s.fall,
            __fmul_rn(p ? s.rise : s.fall, s.peak[i])};
}

__device__ __forceinline__ Aff solve_thread_total(const SolveArgs& s,
                                                  const unsigned char* pat,
                                                  bool warm, int first) {
    Aff t = aff_id();
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int i = first + k;
        if (i < s.n) t = compose(t, solve_load(s, pat, warm, i));
    }
    return t;
}

// Chunk c from its start value: x (not in the warm start), the new
// pattern in place, and this thread's count of unforgiven mismatches.
__device__ int apply_chunk(const SolveArgs& s, const unsigned char* pat,
                           bool warm, int c, float start) {
    const int first = c * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
    Aff total;
    Aff ex = block_exclusive(solve_thread_total(s, pat, warm, first), &total);
    float x = apply(ex, start);
    int mism = 0;
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int i = first + k;
        if (i >= s.n) break;
        const float prev = x;
        x = apply(solve_load(s, pat, warm, i), prev);
        const float pk = s.peak[i];
        const bool np = pk > prev;
        if (!warm) {
            s.x[i] = x;
            // same predicates as scan1.py:_round_kernel; each branch's
            // update (1-a)*prev + a*pk rounds once, as an FMA, like the
            // plain version (scan.guess_round_plain) and XLA:CPU
            const float up = fmaf(1.f - s.rise, prev, __fmul_rn(s.rise, pk));
            const float dn = fmaf(1.f - s.fall, prev, __fmul_rn(s.fall, pk));
            mism += (np != (pat[i] != 0)) && (pk != prev) && !(up == dn);
        }
        s.pat[i] = np;                    // after this thread's last read
    }
    return mism;
}

__global__ void __launch_bounds__(SCAN_THREADS) solve_kernel(SolveArgs s) {
    cg::grid_group grid = cg::this_grid();
    __shared__ float starts[SCAN_THREADS];
    __shared__ int warp_count[32];
    if (blockIdx.x == 0)
        for (int r = threadIdx.x; r <= s.n_iters; r += blockDim.x)
            s.counts[r] = 0;
    const float x0 = *s.x0;
    for (int r = s.pat_in ? 1 : 0;; ++r) {
        const bool warm = r == 0;
        const unsigned char* pat = r == 1 && s.pat_in ? s.pat_in : s.pat;
        for (int c = blockIdx.x; c < s.nchunks; c += gridDim.x) {
            Aff total;
            block_exclusive(solve_thread_total(
                                s, pat, warm,
                                c * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS),
                            &total);
            if (threadIdx.x == 0) {
                s.tot_a[c] = total.a;
                s.tot_b[c] = total.b;
            }
        }
        grid.sync();
        // the chunk start values, as chunk_starts_kernel forms them, a
        // window of SCAN_THREADS chunks at a time; this block's chunks of
        // the window follow at once
        int mism = 0;
        float xs = x0;
        for (int base = 0; base < s.nchunks; base += SCAN_THREADS) {
            const int k = base + threadIdx.x;
            const Aff t = k < s.nchunks
                              ? Aff{__ldcg(s.tot_a + k), __ldcg(s.tot_b + k)}
                              : aff_id();
            Aff total;
            const Aff ex = block_exclusive(t, &total);
            starts[threadIdx.x] = apply(ex, xs);
            xs = apply(total, xs);
            __syncthreads();
            const int end = min(base + SCAN_THREADS, s.nchunks);
            const int c0 = base + (int)((blockIdx.x + gridDim.x
                                         - base % gridDim.x) % gridDim.x);
            for (int c = c0; c < end; c += gridDim.x)
                mism += apply_chunk(s, pat, warm, c, starts[c - base]);
        }
        if (!warm) {
            for (int d = 16; d; d >>= 1)
                mism += __shfl_down_sync(FULL, mism, d);
            const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
            if (lane == 0) warp_count[warp] = mism;
            __syncthreads();
            if (threadIdx.x == 0) {
                int c = 0;
                for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
                    c += warp_count[w];
                if (c) atomicAdd(s.counts + r, c);
            }
        }
        grid.sync();
        if (warm) continue;
        const int count = __ldcg(s.counts + r);
        if (count == 0 || r >= s.n_iters) {
            if (blockIdx.x == 0 && threadIdx.x == 0) {
                s.result[0] = count == 0;
                s.result[1] = r;
            }
            return;
        }
    }
}

// The co-resident block count of solve_kernel on the current device.
static int solve_max_blocks() {
    static int max_blocks = 0;
    if (!max_blocks) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solve_kernel,
                                                      SCAN_THREADS, 0);
        max_blocks = sms * per_sm;
    }
    return max_blocks;
}

}  // namespace cutesdr

using namespace cutesdr;

CUTESDR_API int cutesdr_scan_plain(const float* a, const float* b,
                                   const float* x0, int n, float* x,
                                   float* tot_a, float* tot_b, float* starts,
                                   void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int nchunks = (n + SCAN_CHUNK - 1) / SCAN_CHUNK;
    chunk_totals_kernel<<<nchunks, SCAN_THREADS, 0, st>>>(a, b, n, tot_a,
                                                          tot_b);
    chunk_starts_kernel<<<1, SCAN_THREADS, 0, st>>>(tot_a, tot_b, nchunks,
                                                    x0, starts);
    apply_kernel<<<nchunks, SCAN_THREADS, 0, st>>>(a, b, n, starts, x);
    return (int)cudaGetLastError();
}

// Guess-verify rounds of the two-rate averager in one cooperative launch:
// from pattern_in (one round's input; null: the warm start at rate ag
// derives it) up to n_iters rounds.  Writes x [n] and the last round's
// pattern [n], counts [n_iters + 1] (the mismatches of each round run),
// result [2] (1 if the last round's count is 0, the rounds run); tot_a,
// tot_b are [ceil(n / 2048)] scratch.
CUTESDR_API int cutesdr_scan_solve(const float* peak,
                                   const unsigned char* pattern_in,
                                   float rise, float fall, float ag,
                                   const float* x0, int n, int n_iters,
                                   float* x, unsigned char* pattern,
                                   int* counts, int* result, float* tot_a,
                                   float* tot_b, void* stream) {
    if (n <= 0 || n_iters <= 0) return (int)cudaErrorInvalidValue;
    const int nchunks = (n + SCAN_CHUNK - 1) / SCAN_CHUNK;
    const int max_blocks = solve_max_blocks();
    if (max_blocks <= 0) return (int)cudaGetLastError();
    SolveArgs s{peak, pattern_in, pattern, x, x0, rise, fall, ag, n,
                nchunks, n_iters, tot_a, tot_b, counts, result};
    void* args[] = {&s};
    cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)solve_kernel, dim3(min(nchunks, max_blocks)),
        dim3(SCAN_THREADS), args, 0, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
