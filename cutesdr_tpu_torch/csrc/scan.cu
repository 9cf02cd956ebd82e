// Affine scan x[n] = A[n]*x[n-1] + B[n], and the AGC's guess-verify solve.
//
// Replaces cutesdr_tpu/kernels/scan1.py:first_order_scan (_kernel: A and
// B are read; cutesdr_scan_affine) and scan1.py:guess_round (_round_kernel:
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
//  * The affine scan is ONE launch over [rows, n] (grid = rows x chunks of
//    2048): each block stages its chunk of B (and of A, unless A is one
//    scalar for the whole call, as for the EMAs) in shared memory with
//    coalesced 16-byte loads, each thread composes its 8 consecutive
//    elements, an ordered block scan gives every thread its prefix and
//    the chunk its map, the look-back of scan_common.cuh (one pass, status
//    words zeroed before the launch, chunk ids from a ticket, the same
//    bits on every call) gives the chunk its start value, and x goes back
//    through the tile with coalesced stores.  B may carry a scale (the
//    EMA's alpha: B = alpha*u, rounded once, as the plain version's
//    product); each row has its own initial state.  A row of one chunk
//    (the session's block, a bank's rows) takes no look-back at all.  Each
//    operand is read once and x written once; no scratch, no host read.
//  * The guess-verify solve would be one scan per round, driven
//    from Python with a host read of the count after every round (~0.1 ms
//    of host time a round on the card for ~9 us of device work).  It is
//    ONE cooperative launch (cudaLaunchCooperativeKernel, at
//    most the co-resident block count, each block persistent over the
//    chunks blockIdx.x, + gridDim.x, ...) that runs the warm start (round
//    0: the geometric-mean rate, which derives the first pattern) and
//    every round on the device.  A round is: each block composes its
//    chunks' totals from the pattern; a grid barrier; each block scans the
//    totals itself (so every block gets the same start values) and applies
//    its chunks, writing x and the
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
// Numbers: the solve composes, scans and applies chunk by chunk as the
// three-launch scan it replaced did, so its x is bitwise those rounds' x.
// Against the float64 solve of the same pattern and float32 coefficients
// the chunked scan's reassociation error is ~2e-6 decades at the attack
// averager's rates and ~2e-5 at the decay averager's 12,500-sample memory,
// a quarter of the plain version's log-depth solve there (chip_smoke.py
// holds the kernel to the plain version within 1e-5 plus the plain
// version's own error).  The counts are integer block reductions plus one
// atomicAdd per block, so they are deterministic.  The affine scan is
// held to the float64 solve of its float32 inputs (chip_smoke.py): no
// worse than 1.5x the plain version's error.
#include <cooperative_groups.h>

#include "scan_common.cuh"

namespace cutesdr {

namespace cg = cooperative_groups;

// ------------------------------------------------------------ affine scan --

struct AffineArgs {
    const float* a;          // [rows, n]; null: a_scalar for every element
    float a_scalar;
    const float* b;          // [rows, n]
    float b_scale;           // B = b_scale * b (1: B = b)
    const float* x0;         // row r's initial state x0[r * x0_stride];
    int x0_stride;           //   null: x0_value
    float x0_value;
    int n, nchunks;
    bool vec;                // a, b, x 16-byte aligned, n % 4 == 0
    float* x;                // [rows, n]
    Lookback lb;
    unsigned* ticket;
};

__global__ void __launch_bounds__(SCAN_THREADS)
affine_scan_kernel(AffineArgs s) {
    __shared__ __align__(16) float tile_b[SCAN_CHUNK];
    __shared__ __align__(16) float tile_a[SCAN_CHUNK];
    const bool chained = s.nchunks > 1;
    const int id = chunk_ticket(s.ticket, chained);
    const int row = id / s.nchunks, c = id - row * s.nchunks;
    const long long off = (long long)row * s.n + (long long)c * SCAN_CHUNK;
    const int len = min(SCAN_CHUNK, s.n - c * SCAN_CHUNK);
    load_tile(tile_b, s.b + off, len, s.vec);
    if (s.a) load_tile(tile_a, s.a + off, len, s.vec);
    __syncthreads();
    float av[SCAN_ITEMS], bv[SCAN_ITEMS];
    own_items(tile_b, bv);
    if (s.a) own_items(tile_a, av);
    const int first = (int)threadIdx.x * SCAN_ITEMS;
    Aff t = aff_id();
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        if (!s.a) av[k] = s.a_scalar;
        bv[k] = __fmul_rn(s.b_scale, bv[k]);
        if (first + k < len) t = compose(t, Aff{av[k], bv[k]});
    }
    Aff total;
    const Aff ex = block_exclusive(t, &total);
    const float x0 = s.x0 ? s.x0[(long long)row * s.x0_stride] : s.x0_value;
    const float start = chained ? chunk_start(s.lb, row * s.nchunks, c,
                                              s.nchunks, total, x0)
                                : x0;
    float x = apply(ex, start);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        x = apply(Aff{av[k], bv[k]}, x);
        bv[k] = x;
    }
    put_items(tile_b, bv);                 // each thread its own slots
    __syncthreads();
    store_tile(s.x + off, tile_b, len, s.vec);
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
        // the chunk start values, an ordered block scan of the totals, a
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

// x [rows, n] of x[i] = A[i]*x[i-1] + B[i] along each row, in one
// launch: A = a[i] (a non-null) or a_scalar, B = b_scale*b[i], x[-1] of
// row r = x0[r * x0_stride] (x0 non-null) or x0_value.  vec: a, b, x are
// 16-byte aligned and n % 4 == 0.  Rows of more than one chunk chain
// through the look-back memory (flags: rows * ceil(n / 2048) slots, agg:
// two 16-byte words a slot; ticket: one counter), all zeroed by the
// caller before the launch.
CUTESDR_API int cutesdr_scan_affine(const float* a, float a_scalar,
                                    const float* b, float b_scale,
                                    const float* x0, int x0_stride,
                                    float x0_value, int n, int rows, int vec,
                                    float* x, unsigned* flags, double2* agg,
                                    unsigned* ticket, void* stream) {
    if (n <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
    const int nchunks = (n + SCAN_CHUNK - 1) / SCAN_CHUNK;
    AffineArgs s{a, a_scalar, b, b_scale, x0, x0_stride, x0_value, n,
                 nchunks, vec != 0, x, {flags, agg}, ticket};
    affine_scan_kernel<<<rows * nchunks, SCAN_THREADS, 0,
                         (cudaStream_t)stream>>>(s);
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
