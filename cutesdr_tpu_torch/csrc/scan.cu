// Affine scan x[n] = A[n]*x[n-1] + B[n], and the AGC's guess-verify solve.
//
// Replaces cutesdr_tpu/kernels/scan1.py:first_order_scan (_kernel: A and
// B are read; cutesdr_scan_affine) and scan1.py:guess_round (_round_kernel:
// A and B are built from the AGC branch pattern and the window peak, and
// the epilogue emits x, the re-derived pattern and the count of
// unforgiven mismatches), together with the loop around it, JAX's
// ops/agc._two_rate_parallel: a lax.while_loop of rounds after a warm
// start, exiting when a round's count is 0 or after n_iters rounds
// (cutesdr_scan_solve), over one stream or a bank's rows (JAX's vmapped
// loop: a row that validated is frozen).  Also hang mode's decay solve,
// which has no Pallas kernel (N3h, cutesdr_hang_solve; JAX
// ops/agc.py:256-300), with the same two launch forms.
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
//    of host time a round on the card for ~9 us of device work).  Rows of
//    one chunk (a bank's 1,024-sample rows, short single-stream blocks)
//    take a block each, whose rounds need only block barriers
//    (solve_rows_kernel).  Longer rows take ONE cooperative launch
//    (cudaLaunchCooperativeKernel, at most the co-resident block count,
//    each block persistent over the
//    (row, chunk) items blockIdx.x, + gridDim.x, ...) that runs the warm
//    start (round 0: the geometric-mean rate, which derives the first
//    pattern) and every round on the device, each row's rounds counted
//    in its own slots (solve_kernel; a lone row, the single stream,
//    takes solve_one_kernel: the same rounds without the rows'
//    bookkeeping, about 2.5 us less a solve on an H100 at 262,144
//    samples).  A round is: each block composes its
//    chunks' totals from the pattern; a grid barrier; each block scans the
//    totals itself (so every block gets the same start values) and applies
//    its chunks, writing x and the
//    re-derived pattern in place and counting mismatches into that
//    round's slot; a grid barrier; every block reads the round's counts
//    and stops where no row has one left or after n_iters rounds.  Each
//    row's flag, the all-rows flag (which the sequential fallback N1
//    reads by pointer: a bank votes bank-wide) and the rounds run stay on
//    the device.  A barrier of its own over a plain
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
#include <limits.h>

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

// ------------------------------------------------ guess-verify bookkeeping --
//
// Both solves (the two-rate averager's, K4, and hang mode's, N3h) run
// rounds over [rows, n] until every row validates or n_iters rounds ran,
// a row frozen once it validates, and report the same way.

struct Rounds {
    int rows, n_iters;
    int* counts;                   // [rows, n_iters + 1] mismatches per round
    int* rounds;                   // [1] rounds run
    unsigned char* ok;             // [rows + 1]: each row converged, all rows
    unsigned* done;                // row form: blocks finished and the rounds'
                                   //   max (zeroed by the caller); null: one
                                   //   block
};

__device__ __forceinline__ int* count_slot(const Rounds& o, int row, int r) {
    return o.counts + row * (o.n_iters + 1) + r;
}

// Row r takes part in round ``r``: every row in the first round, then the
// rows whose last round left mismatches (a row that validated is frozen;
// its later counts stay 0).  A lone row takes part in every round that
// runs (the rounds stop once it validates), so it reads no count.
__device__ __forceinline__ bool row_active(const Rounds& o, int row, int r) {
    return r <= 1 || o.rows == 1 || __ldcg(count_slot(o, row, r - 1)) != 0;
}

// The block's sum of one count per thread, valid in every thread.  All
// threads call.
__device__ int block_sum(int v) {
    __shared__ int warp_count[32];
    __shared__ int sum;
    for (int d = 16; d; d >>= 1) v += __shfl_down_sync(FULL, v, d);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_count[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        int c = 0;
        for (int k = 0; k < (int)(blockDim.x >> 5); ++k) c += warp_count[k];
        sum = c;
    }
    __syncthreads();
    const int out = sum;
    __syncthreads();                      // sum is reused by the next call
    return out;
}

// A row's count of round r, added by each block that applied a chunk of
// it (one barrier: only thread 0 needs the sum; a barrier of the block's
// next scan comes before warp_count is written again).  All threads call.
__device__ __forceinline__ void add_count(const Rounds& o, int row, int r,
                                          int mism) {
    __shared__ int warp_count[32];
    for (int d = 16; d; d >>= 1) mism += __shfl_down_sync(FULL, mism, d);
    if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = mism;
    __syncthreads();
    if (threadIdx.x == 0) {
        int c = 0;
        for (int k = 0; k < (int)(blockDim.x >> 5); ++k) c += warp_count[k];
        if (c) atomicAdd(count_slot(o, row, r), c);
    }
}

// Cooperative form, after round r's barrier: whether any row has
// mismatches left and rounds remain.  Where not, block 0 writes the
// flags and the rounds run.  Every block calls and sees the same.
__device__ bool grid_rounds_left(const Rounds& o, int r) {
    bool left = false;
    for (int row = 0; row < o.rows; ++row)
        left |= __ldcg(count_slot(o, row, r)) != 0;
    if (left && r < o.n_iters) return true;
    if (blockIdx.x == 0) {
        bool all = true;
        for (int row = threadIdx.x; row < o.rows; row += blockDim.x) {
            const bool ok = __ldcg(count_slot(o, row, r)) == 0;
            o.ok[row] = ok;
            all &= ok;
        }
        all = __syncthreads_and(all);
        if (threadIdx.x == 0) {
            o.ok[o.rows] = all;
            o.rounds[0] = r;
        }
    }
    return false;
}

// Row form: this block's rows are done, the last of them after ``most``
// rounds; the last block to finish writes the all-rows flag and the
// rounds run.  All threads of every block call.
__device__ void rows_finish(const Rounds& o, int most) {
    __shared__ bool last;
    if (!o.done) {                        // one block, one row
        if (threadIdx.x == 0) {
            o.ok[o.rows] = o.ok[0];
            o.rounds[0] = most;
        }
        return;
    }
    if (threadIdx.x == 0) {
        atomicMax(o.done + 1, (unsigned)most);
        __threadfence();
        last = atomicAdd(o.done, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    bool all = true;
    for (int row = threadIdx.x; row < o.rows; row += blockDim.x)
        all &= __ldcg(o.ok + row) != 0;
    all = __syncthreads_and(all);
    if (threadIdx.x == 0) {
        o.ok[o.rows] = all;
        o.rounds[0] = (int)__ldcg(o.done + 1);
    }
}

// The first item (row-major over rows x chunks) at or after ``k`` that
// this block owns in a persistent launch: items blockIdx.x, + gridDim.x...
__device__ __forceinline__ int first_owned(int k) {
    return k + (int)((blockIdx.x + gridDim.x - k % gridDim.x) % gridDim.x);
}

// The co-resident block count of a cooperative kernel on the current
// device, found once per kernel.
template <class Kernel>
static int max_blocks_of(Kernel kernel, int* cache) {
    if (!*cache) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      SCAN_THREADS, 0);
        *cache = sms * per_sm;
    }
    return *cache;
}

// ------------------------------------------------------ guess-verify solve --

struct SolveArgs {
    const float* peak;             // [rows, n]
    const unsigned char* pat_in;   // round 1's pattern; null: warm start
    unsigned char* pat;            // each round's re-derived pattern
    float* x;
    const float* x0;               // [rows]
    float rise, fall, ag;          // ag: the warm start's rate
    int n, nchunks, rows, n_iters;
    float* tot_a;                  // [rows * nchunks] chunk totals
    float* tot_b;
    Rounds out;
};

// One row of the solve: its peaks, the pattern a round reads and the one
// it writes (the same array after round 1), and its x.
struct SolveRow {
    const float* peak;
    const unsigned char* pat_rd;
    unsigned char* pat;
    float* x;
};

__device__ __forceinline__ SolveRow solve_row(const SolveArgs& s, int row,
                                              int r) {
    const long long off = (long long)row * s.n;
    return {s.peak + off,
            (r == 1 && s.pat_in ? s.pat_in : s.pat) + off, s.pat + off,
            s.x + off};
}

// A and B of element i: the warm start's constant rate, or the branch of
// the pattern (the same products as scan.guess_round_plain).
__device__ __forceinline__ Aff solve_load(const SolveArgs& s,
                                          const SolveRow& w, bool warm,
                                          int i) {
    if (warm) return {1.f - s.ag, __fmul_rn(s.ag, w.peak[i])};
    const bool p = w.pat_rd[i] != 0;
    return {p ? 1.f - s.rise : 1.f - s.fall,
            __fmul_rn(p ? s.rise : s.fall, w.peak[i])};
}

__device__ __forceinline__ Aff solve_thread_total(const SolveArgs& s,
                                                  const SolveRow& w,
                                                  bool warm, int first) {
    Aff t = aff_id();
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int i = first + k;
        if (i < s.n) t = compose(t, solve_load(s, w, warm, i));
    }
    return t;
}

// Chunk c of a row from its start value: x (not in the warm start), the
// new pattern in place, and this thread's count of unforgiven mismatches.
__device__ int apply_chunk(const SolveArgs& s, const SolveRow& w, bool warm,
                           int c, float start) {
    const int first = c * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
    Aff total;
    Aff ex = block_exclusive(solve_thread_total(s, w, warm, first), &total);
    float x = apply(ex, start);
    int mism = 0;
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int i = first + k;
        if (i >= s.n) break;
        const float prev = x;
        x = apply(solve_load(s, w, warm, i), prev);
        const float pk = w.peak[i];
        const bool np = pk > prev;
        if (!warm) {
            w.x[i] = x;
            // same predicates as scan1.py:_round_kernel; each branch's
            // update (1-a)*prev + a*pk rounds once, as an FMA, like the
            // plain version (scan.guess_round_plain) and XLA:CPU
            const float up = fmaf(1.f - s.rise, prev, __fmul_rn(s.rise, pk));
            const float dn = fmaf(1.f - s.fall, prev, __fmul_rn(s.fall, pk));
            mism += (np != (w.pat_rd[i] != 0)) && (pk != prev) && !(up == dn);
        }
        w.pat[i] = np;                    // after this thread's last read
    }
    return mism;
}

// Rows of several chunks: one cooperative launch, persistent over the
// (row, chunk) items.  Round r: each block composes its items' totals
// from the pattern; a grid barrier; for each row it holds items of, each
// block scans the row's totals itself (so every block gets the same start
// values) and applies its chunks, writing x and the re-derived pattern
// in place and counting mismatches into the row's slot of that round; a
// grid barrier; every block reads the round's counts and stops when no
// row has one left or after n_iters rounds.  A lone row takes
// solve_one_kernel.
__global__ void __launch_bounds__(SCAN_THREADS) solve_kernel(SolveArgs s) {
    cg::grid_group grid = cg::this_grid();
    __shared__ float starts[SCAN_THREADS];
    const int items = s.rows * s.nchunks;
    if (blockIdx.x == 0)
        for (int k = threadIdx.x; k < s.rows * (s.n_iters + 1);
             k += blockDim.x)
            s.out.counts[k] = 0;
    for (int r = s.pat_in ? 1 : 0;; ++r) {
        const bool warm = r == 0;
        for (int k = blockIdx.x; k < items; k += gridDim.x) {
            const int row = k / s.nchunks, c = k - row * s.nchunks;
            if (!row_active(s.out, row, r)) continue;
            Aff total;
            block_exclusive(solve_thread_total(
                                s, solve_row(s, row, r), warm,
                                c * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS),
                            &total);
            if (threadIdx.x == 0) {
                s.tot_a[k] = total.a;
                s.tot_b[k] = total.b;
            }
        }
        grid.sync();
        for (int row = 0; row < s.rows; ++row) {
            const int k0 = row * s.nchunks;
            if (first_owned(k0) >= k0 + s.nchunks || !row_active(s.out, row, r))
                continue;
            const SolveRow w = solve_row(s, row, r);
            // the chunk start values, an ordered block scan of the row's
            // totals, a window of SCAN_THREADS chunks at a time; this
            // block's chunks of the window follow at once
            int mism = 0;
            float xs = s.x0[row];
            for (int base = 0; base < s.nchunks; base += SCAN_THREADS) {
                const int k = base + threadIdx.x;
                const Aff t = k < s.nchunks
                                  ? Aff{__ldcg(s.tot_a + k0 + k),
                                        __ldcg(s.tot_b + k0 + k)}
                                  : aff_id();
                Aff total;
                const Aff ex = block_exclusive(t, &total);
                starts[threadIdx.x] = apply(ex, xs);
                xs = apply(total, xs);
                __syncthreads();
                const int end = min(base + SCAN_THREADS, s.nchunks);
                // each read of starts precedes apply_chunk's barriers, so
                // the next window's scan barrier orders it before the
                // next write
                for (int c = first_owned(k0 + base) - k0; c < end;
                     c += gridDim.x)
                    mism += apply_chunk(s, w, warm, c, starts[c - base]);
            }
            if (!warm) add_count(s.out, row, r, mism);
        }
        grid.sync();
        if (!warm && !grid_rounds_left(s.out, r)) return;
    }
}

// One row of several chunks (the single stream): solve_kernel's rounds
// without the rows' bookkeeping (no per-row activity, one count a
// round), bitwise the same.
__global__ void __launch_bounds__(SCAN_THREADS) solve_one_kernel(SolveArgs s) {
    cg::grid_group grid = cg::this_grid();
    __shared__ float starts[SCAN_THREADS];
    if (blockIdx.x == 0)
        for (int k = threadIdx.x; k <= s.n_iters; k += blockDim.x)
            s.out.counts[k] = 0;
    const float x0 = *s.x0;
    for (int r = s.pat_in ? 1 : 0;; ++r) {
        const bool warm = r == 0;
        const SolveRow w = solve_row(s, 0, r);
        for (int c = blockIdx.x; c < s.nchunks; c += gridDim.x) {
            Aff total;
            block_exclusive(solve_thread_total(
                                s, w, warm,
                                c * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS),
                            &total);
            if (threadIdx.x == 0) {
                s.tot_a[c] = total.a;
                s.tot_b[c] = total.b;
            }
        }
        grid.sync();
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
            for (int c = first_owned(base); c < end; c += gridDim.x)
                mism += apply_chunk(s, w, warm, c, starts[c - base]);
        }
        if (!warm) add_count(s.out, 0, r, mism);
        grid.sync();
        if (warm) continue;
        const int count = __ldcg(count_slot(s.out, 0, r));
        if (count == 0 || r >= s.n_iters) {
            if (blockIdx.x == 0 && threadIdx.x == 0) {
                s.out.ok[0] = s.out.ok[1] = count == 0;
                s.out.rounds[0] = r;
            }
            return;
        }
    }
}

// Rows of one chunk (a bank's rows, the short single-stream blocks): a
// block a row, whose rounds need block barriers only, so an ordinary
// launch with no grid barrier.  The last block to finish (a ticket the
// caller zeroed; none with one block) writes the all-rows flag and the
// rounds run.
__global__ void __launch_bounds__(SCAN_THREADS) solve_rows_kernel(SolveArgs s) {
    int most = 0;
    for (int row = blockIdx.x; row < s.rows; row += gridDim.x) {
        int count = 0, r = s.pat_in ? 1 : 0;
        for (;; ++r) {
            const bool warm = r == 0;
            // one chunk: it starts from the row's initial state
            const int mism = apply_chunk(s, solve_row(s, row, r), warm, 0,
                                         s.x0[row]);
            __syncthreads();              // the pattern is read next round
            if (warm) continue;
            count = block_sum(mism);
            if (threadIdx.x == 0) *count_slot(s.out, row, r) = count;
            if (count == 0 || r >= s.n_iters) break;
        }
        if (threadIdx.x == 0) s.out.ok[row] = count == 0;
        most = max(most, r);
    }
    rows_finish(s.out, most);
}

// ------------------------------------------------- hang-mode decay solve --
//
// N3h: the hang-mode decay averager (JAX ops/agc.py:256-300, a
// lax.while_loop of _solve rounds).  The pattern is the rising flags
// p[i] = pk[i] > d[i-1]; a round derives from it the distance since the
// last rise, dist[i] = i - (the last i' <= i with p[i'], a virtual rise
// at -1 - timer0 before the block), the hold window hold[i] = !p[i] &&
// dist[i-1] < hang_time, the rates alpha = p ? rise : hold ? 0 : fall,
// the affine solve d[i] = (1-alpha)*d[i-1] + alpha*pk[i] and the
// re-derived pattern; a row validates on EXACT equality (a tie resets
// the timer: no forgiveness, cutesdr_tpu/ops/agc.py:263-275).  Round 1
// starts from p[i] = pk[i] > pk[i-1] (pk[-1] = d0).
//
// The solve's arithmetic is the affine scan's (affine_scan_kernel, K3)
// on the same A = 1 - alpha and B = alpha*pk: the same thread
// compositions, block scan and chunk-start composition (lookback<Aff>'s
// order), so d is bitwise what the plain version's rounds give through
// K3 on the card, and the patterns, timers and rounds are the same.
// The last-rise index carries across chunks as a max: each chunk keeps
// the last rise of its pattern (written when the pattern is), and a chunk
// takes the max over the chunks before it.

constexpr int NO_RISE = INT_MIN;

struct HangArgs {
    const float* peak;             // [rows, n]
    const float* d0;               // [rows]
    const int* timer0;             // [rows]
    float rise, fall;              // decay rise and release alphas
    int hang_time;
    int n, nchunks, rows, n_iters;
    unsigned char* pat;            // [rows, n] the pattern (scratch)
    float* d;                      // [rows, n]
    int* timer;                    // [rows] min(dist[n-1], hang_time)
    int* last;                     // [rows * nchunks] a chunk's last rise
    int* carry;                    // [rows * nchunks] the last rise before it
    Lookback lb;                   // chunk maps (flags unused)
    Rounds out;
};

// Exclusive max over the block's threads in thread order (NO_RISE for
// thread 0); *total receives the block's max.  All threads call.
__device__ int block_exclusive_max(int v, int* total) {
    __shared__ int warp_tot[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int inc = v;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc = max(inc, y);
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int w = lane < nwarps ? warp_tot[lane] : NO_RISE;
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, w, d);
            if (lane >= d) w = max(w, y);
        }
        warp_tot[lane] = w;
    }
    __syncthreads();
    int ex = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) ex = NO_RISE;
    if (warp > 0) ex = max(ex, warp_tot[warp - 1]);
    *total = warp_tot[nwarps - 1];
    __syncthreads();
    return ex;
}

// One thread's items of chunk c of a row: peaks and pattern flags.
struct HangItems {
    float pk[SCAN_ITEMS];
    bool p[SCAN_ITEMS];
    int first, cnt;                // row index of item 0, valid items
    int last;                      // the thread's last rise, or NO_RISE
};

__device__ __forceinline__ HangItems hang_items(const HangArgs& s, int row,
                                                int c) {
    HangItems t;
    const long long off = (long long)row * s.n;
    t.first = c * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
    t.cnt = max(0, min(SCAN_ITEMS, s.n - t.first));
    t.last = NO_RISE;
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        t.pk[k] = 0.f;
        t.p[k] = false;
        if (k < t.cnt) {
            t.pk[k] = s.peak[off + t.first + k];
            t.p[k] = s.pat[off + t.first + k] != 0;
            if (t.p[k]) t.last = t.first + k;
        }
    }
    return t;
}

// Element k's map from the last rise before it (``*last``, updated).
__device__ __forceinline__ Aff hang_map(const HangArgs& s, const HangItems& t,
                                        int k, int* last) {
    const int i = t.first + k;
    const bool hold = !t.p[k] && (i - 1) - *last < s.hang_time;
    const float alpha = t.p[k] ? s.rise : (hold ? 0.f : s.fall);
    if (t.p[k]) *last = i;
    return {1.f - alpha, __fmul_rn(alpha, t.pk[k])};
}

// The thread's maps composed, from the last rise before its first item.
__device__ __forceinline__ Aff hang_total(const HangArgs& s,
                                          const HangItems& t, int last) {
    Aff tot = aff_id();
    for (int k = 0; k < SCAN_ITEMS; ++k)
        if (k < t.cnt) tot = compose(tot, hang_map(s, t, k, &last));
    return tot;
}

// Chunk c of a row under the pattern, from ``carry`` (the last rise
// before the chunk): the thread's items, the last rise before its first
// item, its exclusive map and the chunk's map.  All threads call.
__device__ __forceinline__ Aff hang_scan(const HangArgs& s, int row, int c,
                                         int carry, HangItems* t, int* last,
                                         Aff* total) {
    *t = hang_items(s, row, c);
    int unused;
    *last = max(carry, block_exclusive_max(t->last, &unused));
    return block_exclusive(hang_total(s, *t, *last), total);
}

// Apply chunk c of a row from its start value: d, the new pattern in
// place, the row's timer where the chunk holds its last element; returns
// this thread's count of mismatches, and the new pattern's last rise of
// the chunk in ``*new_last`` (valid in every thread).  All threads call.
__device__ int hang_apply(const HangArgs& s, int row, int c, int carry,
                          const float* start_s, int* new_last) {
    HangItems t;
    int last;
    Aff total;
    const Aff ex = hang_scan(s, row, c, carry, &t, &last, &total);
    float x = apply(ex, *start_s);
    const long long off = (long long)row * s.n;
    int mism = 0, mine = NO_RISE;
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        if (k >= t.cnt) break;
        const float prev = x;
        x = apply(hang_map(s, t, k, &last), prev);
        const int i = t.first + k;
        const bool np = t.pk[k] > prev;
        s.d[off + i] = x;
        s.pat[off + i] = np;
        mism += np != t.p[k];
        if (np) mine = i;
        if (i == s.n - 1)
            s.timer[row] = min(i - last, s.hang_time);
    }
    int chunk_last;
    block_exclusive_max(mine, &chunk_last);
    *new_last = chunk_last;
    return mism;
}

// Round 1's pattern pk[i] > pk[i-1] (pk[-1] = d0) over chunk c of a row,
// and its last rise (valid in every thread).  All threads call.
__device__ int hang_first_pattern(const HangArgs& s, int row, int c) {
    const long long off = (long long)row * s.n;
    const int first = c * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
    int mine = NO_RISE;
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int i = first + k;
        if (i >= s.n) break;
        const float before = i ? s.peak[off + i - 1] : s.d0[row];
        const bool p = s.peak[off + i] > before;
        s.pat[off + i] = p;
        if (p) mine = i;
    }
    int chunk_last;
    block_exclusive_max(mine, &chunk_last);
    return chunk_last;
}

// The max of last[k0 .. k0 + c) (chunks a grid barrier ago), valid in
// every thread.  All threads call.
__device__ int rise_before(const HangArgs& s, int k0, int c) {
    int m = NO_RISE;
    for (int j = threadIdx.x; j < c; j += blockDim.x)
        m = max(m, __ldcg(s.last + k0 + j));
    int total;
    block_exclusive_max(m, &total);
    return total;
}

// Rows of several chunks: one cooperative launch, persistent over the
// (row, chunk) items.  First each item's round-1 pattern and its last
// rise; a grid barrier; then per round: each active item takes the last
// rise before it (a max over its row's earlier chunks), composes its map
// and publishes it; a grid barrier; each active item composes its row's
// earlier maps (lookback<Aff>'s order, nothing to wait for), applies, and
// adds its mismatches to the row's count; a grid barrier; stop as K4.
__global__ void __launch_bounds__(SCAN_THREADS) hang_kernel(HangArgs s) {
    cg::grid_group grid = cg::this_grid();
    __shared__ float start_s;
    const int items = s.rows * s.nchunks;
    if (blockIdx.x == 0)
        for (int k = threadIdx.x; k < s.rows * (s.n_iters + 1);
             k += blockDim.x)
            s.out.counts[k] = 0;
    for (int k = blockIdx.x; k < items; k += gridDim.x) {
        const int row = k / s.nchunks;
        const int last = hang_first_pattern(s, row, k - row * s.nchunks);
        if (threadIdx.x == 0) s.last[k] = last;
    }
    grid.sync();
    for (int r = 1;; ++r) {
        for (int k = blockIdx.x; k < items; k += gridDim.x) {
            const int row = k / s.nchunks, c = k - row * s.nchunks;
            if (!row_active(s.out, row, r)) continue;
            const int k0 = row * s.nchunks;
            const int carry = max(-1 - s.timer0[row], rise_before(s, k0, c));
            HangItems t;
            int last;
            Aff total;
            hang_scan(s, row, c, carry, &t, &last, &total);
            if (threadIdx.x == 0) {
                s.carry[k] = carry;
                publish(s.lb.agg + 2 * k, total);
            }
        }
        grid.sync();
        for (int k = blockIdx.x; k < items; k += gridDim.x) {
            const int row = k / s.nchunks, c = k - row * s.nchunks;
            if (!row_active(s.out, row, r)) continue;
            const Aff m = lookback<Aff, false>(s.lb, row * s.nchunks, c);
            if (threadIdx.x == 0) start_s = apply(m, s.d0[row]);
            __syncthreads();
            int new_last;
            const int mism = hang_apply(s, row, c, __ldcg(s.carry + k),
                                        &start_s, &new_last);
            if (threadIdx.x == 0) s.last[k] = new_last;
            add_count(s.out, row, r, mism);
        }
        grid.sync();
        if (!grid_rounds_left(s.out, r)) return;
    }
}

// Rows of one chunk: a block a row, rounds with block barriers only (as
// solve_rows_kernel).  The start value is d0 itself, as K3 takes it for
// a row of one chunk.
__global__ void __launch_bounds__(SCAN_THREADS) hang_rows_kernel(HangArgs s) {
    __shared__ float start_s;
    int most = 0;
    for (int row = blockIdx.x; row < s.rows; row += gridDim.x) {
        hang_first_pattern(s, row, 0);
        if (threadIdx.x == 0) start_s = s.d0[row];
        __syncthreads();
        const int carry = -1 - s.timer0[row];
        int count = 0, r = 1;
        for (;; ++r) {
            int unused;
            const int mism = hang_apply(s, row, 0, carry, &start_s, &unused);
            count = block_sum(mism);
            if (threadIdx.x == 0) *count_slot(s.out, row, r) = count;
            if (count == 0 || r >= s.n_iters) break;
        }
        if (threadIdx.x == 0) s.out.ok[row] = count == 0;
        most = max(most, r);
        __syncthreads();                  // start_s is the next row's
    }
    rows_finish(s.out, most);
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

// Guess-verify rounds of the two-rate averager over ``rows`` independent
// rows of peak [rows, n], each from its own x0[row], in one launch: from
// pattern_in (one round's input; null: the warm start at rate ag derives
// it) up to n_iters rounds, a row frozen once it validates.  Writes x and
// the last pattern [rows, n], counts [rows, n_iters + 1] (the mismatches
// of each round a row ran), rounds [1] (the rounds run), ok [rows + 1]
// (each row converged, then all rows).  Rows of several chunks take one
// cooperative launch (tot_a, tot_b: [rows * ceil(n / 2048)] scratch);
// rows of one chunk a block each, with done [2] zeroed by the caller
// (null for one row).
CUTESDR_API int cutesdr_scan_solve(const float* peak,
                                   const unsigned char* pattern_in,
                                   float rise, float fall, float ag,
                                   const float* x0, int n, int rows,
                                   int n_iters, float* x,
                                   unsigned char* pattern, int* counts,
                                   int* rounds, unsigned char* ok,
                                   float* tot_a, float* tot_b,
                                   unsigned* done, void* stream) {
    if (n <= 0 || rows <= 0 || n_iters <= 0)
        return (int)cudaErrorInvalidValue;
    const int nchunks = (n + SCAN_CHUNK - 1) / SCAN_CHUNK;
    SolveArgs s{peak, pattern_in, pattern, x, x0, rise, fall, ag, n,
                nchunks, rows, n_iters, tot_a, tot_b,
                {rows, n_iters, counts, rounds, ok, done}};
    if (nchunks == 1) {
        if (rows > 1 && !done) return (int)cudaErrorInvalidValue;
        solve_rows_kernel<<<rows, SCAN_THREADS, 0, (cudaStream_t)stream>>>(s);
        return (int)cudaGetLastError();
    }
    static int cache = 0, cache_one = 0;
    const bool one = rows == 1;
    const int max_blocks = one ? max_blocks_of(solve_one_kernel, &cache_one)
                               : max_blocks_of(solve_kernel, &cache);
    if (max_blocks <= 0) return (int)cudaGetLastError();
    void* args[] = {&s};
    cudaError_t err = cudaLaunchCooperativeKernel(
        one ? (const void*)solve_one_kernel : (const void*)solve_kernel,
        dim3(min(rows * nchunks, max_blocks)), dim3(SCAN_THREADS), args, 0,
        (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Hang-mode decay guess-verify solve (N3h) over ``rows`` rows of peak
// [rows, n] with their own d0[row] and timer0[row], in one launch: up to
// n_iters rounds, a row frozen once its pattern repeats exactly.  Writes
// d [rows, n], timer [rows] (min(distance since the last rise, hang_time)
// at the row's end), counts, rounds and ok as cutesdr_scan_solve;
// pattern [rows, n] is scratch.  Rows of several chunks take one
// cooperative launch (last, carry: [rows * ceil(n / 2048)] int scratch;
// agg: two 16-byte words an item); rows of one chunk a block each, with
// done [2] zeroed by the caller (null for one row).
CUTESDR_API int cutesdr_hang_solve(const float* peak, const float* d0,
                                   const int* timer0, float rise, float fall,
                                   int hang_time, int n, int rows,
                                   int n_iters, float* d, int* timer,
                                   unsigned char* pattern, int* counts,
                                   int* rounds, unsigned char* ok, int* last,
                                   int* carry, double2* agg, unsigned* done,
                                   void* stream) {
    if (n <= 0 || rows <= 0 || n_iters <= 0)
        return (int)cudaErrorInvalidValue;
    const int nchunks = (n + SCAN_CHUNK - 1) / SCAN_CHUNK;
    HangArgs s{peak, d0, timer0, rise, fall, hang_time, n, nchunks, rows,
               n_iters, pattern, d, timer, last, carry, {nullptr, agg},
               {rows, n_iters, counts, rounds, ok, done}};
    if (nchunks == 1) {
        if (rows > 1 && !done) return (int)cudaErrorInvalidValue;
        hang_rows_kernel<<<rows, SCAN_THREADS, 0, (cudaStream_t)stream>>>(s);
        return (int)cudaGetLastError();
    }
    static int cache = 0;
    const int max_blocks = max_blocks_of(hang_kernel, &cache);
    if (max_blocks <= 0) return (int)cudaGetLastError();
    void* args[] = {&s};
    cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)hang_kernel, dim3(min(rows * nchunks, max_blocks)),
        dim3(SCAN_THREADS), args, 0, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
