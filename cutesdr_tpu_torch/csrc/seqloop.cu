// Exact FM and SAM PLL loops over C independent streams.
//
// Replaces cutesdr_tpu/kernels/seqloop.py:fm_pll_scan (_fm_kernel, K7)
// and seqloop.py:sam_pll_scan (_sam_kernel, K8): the per-sample reference
// recurrences (dsp/fmdemod.cpp:62-89, dsp/samdemod.cpp:78-110) that the
// demodulators take when their linear tier is not exact (acquisition,
// clamp hits, carrier-less noise).  For FM, K7 also takes the place of
// the JAX package's chunked tier (cutesdr_tpu/ops/pll.py:chunked_scan,
// called by demod/fm.py:_pll_chunked), whose validity flag it returns.
// Both take the linear tier's validity flag by pointer (``skip``) and
// return at once where it holds, leaving the linear tier's outputs in
// place, so the demodulators choose their tier on the card as JAX's
// lax.cond does, with no host read (the receiver's step is replayed as
// one CUDA graph).
//
//   FM:  err = -wrap(th + phase)            emits freq (post-update), err
//   SAM: err =  wrap(th - phase)            emits phase (pre-update)
//   both: freq  = clip(freq + beta*err, +-limit)
//         phase = wrap(phase + freq + alpha*err)
//   final state: (phase mod 2pi, freq)
//
// Bound on the H100: counting bytes and operations, the bytes (theta in,
// the series out), well under a microsecond; a walk over a stream is held
// instead by the loop-carried latency of the step, ~15 dependent float32
// operations a sample on one lane, which K7 takes off on noise by
// walking chunks in parallel.
//
// The step (pll_step), shared by both loops, keeps the chain short
// without changing a bit:
//  * the wrap's round is the float32 magic-constant round,
//    (x + 1.5*2^23) - 1.5*2^23, which equals rintf(x) (half to even) for
//    |x| < 2^22: two adds instead of the conversion unit's FRND.
//  * e - 2pi*r is one FMA: where |r| <= 2, 2pi*r is exact in float32
//    (a power-of-two multiple of float32(2pi)), so fma(-2pi, r, e) rounds
//    e - 2pi*r once, as the plain wrap's subtraction does.
//  Both hold where |x| = |e/2pi| < 2.5.  Its bound: with |theta| <= 4 in
//  a 32-sample group and |phase| <= 8 at a walk's start (after one wrap
//  |phase| < 4), |th +- phase| <= 12; a wrapped error is below 4 in
//  magnitude, so with limit + 4*|alpha| <= 7 (checked on the host)
//  |phase + freq + alpha*err| <= 15 < 2.5*2pi.  A group whose theta (or
//  a walk whose start phase) breaks the bound takes the plain form
//  (rintf, a rounded product and a subtraction), chosen by a warp vote
//  off the chain.  The magic round gives +0 where rintf keeps a -0,
//  which changes the result only for e = -0 (the FMA then keeps -0, the
//  plain wrap gives +0); theta and the start phase are mapped from -0 to
//  +0 (an add of +0), after which no wrap argument is ever -0, so every
//  output keeps its bits (SAM's first pre-update phase is written back
//  as given).
//  * alpha*err is computed beside the frequency update, off the chain.
//    The clamp stays on it: taking it off as a select of phase + f and
//    the rail sums phase +- limit (known before f) measured slower, a
//    compare and a select costing more than fmax and fmin.
//  * the walk is split over two warps (warp specialization): the walker
//    warp runs the steps, the stager warp copies theta in (cp.async,
//    coalesced, into a double-buffered shared tile) and the outputs out
//    (coalesced stores from a double-buffered tile), one barrier a
//    32-sample group between them (a bar.red, which also carries the
//    repair walker's stop to the stager).  The walker reads the next group's
//    theta into registers and checks it against the fast wrap's bound
//    between its steps, so no read, store or check sits on the chain.
//  Measured on the H100 (the walk's clock64() probe, SAM, one lane,
//  chip_smoke.py): 81 cycles a sample, the steps alone 70 (100 with the
//  plain wrap).  With one warp doing both jobs, the copies, barriers and
//  tile stores ran between the groups' chains (~85 a sample); each lane
//  loading and storing its own samples between the steps was slower
//  still in nvcc's schedule.
// Every operation is pinned with __fmul_rn/__fadd_rn/__fsub_rn, so nvcc
// contracts nothing into an FMA (the wrap's one FMA is written out and
// exact, as above), in the plain loops' order (kernels/seqloop.py):
// kernel and plain loop agree to the bit.  The
// TPU kernel uses a conditional subtract instead (seqloop._wrap): the
// two agree except within an ulp of odd multiples of pi.
//
// The walk (walk): one lane of the walker warp walks each segment, up to
// 32 segments in lockstep, and the stager warp stages them all.  K8 is
// the walk over the streams, C streams packed one per lane (C = 1: one
// lane walks, a warp stages).
//
// K7 is one launch of a chunked guess-verify scan (the JAX chunked tier's
// schedule, chunk 128 and halo 128) with a walker that repairs in place:
//  1. pass 1: every chunk runs from the guess (the block's initial
//     state) through its halo and then its own samples, keeping its end
//     state; chunk 0 starts from the true state (its halo forgotten);
//  2. pass 2: every chunk re-runs its own samples from its left
//     neighbour's pass-1 end, writing its outputs and its end state;
//  3. the first verify: every boundary's pass-2 end equals the pass-1 end
//     its right neighbour consumed (float ==, JAX's comparison), the flag
//     JAX's chunked tier returns as ``valid``;
//  4. the repair: from the first boundary that failed (bitwise), a walker
//     re-runs the chunks to its right from the true state, rewriting
//     their outputs, in one walk that checks each chunk's end: where the
//     true end equals, bitwise, the pass-1 end the next chunk consumed,
//     that chunk's pass-2 outputs are already true, and the walker jumps
//     to the next failed boundary.  A tail of n % 128 samples is walked
//     from the true end of the last chunk.
// The outputs are the sequential loop's, bitwise, for any n and C; where
// the loop bit-syncs within the halo (noise) nothing is re-run.  Worst
// case (a loop that never bit-syncs, a locked tone): the walk of every
// sample after the first failed boundary, plus passes 1 and 2.  Fewer
// than 4 chunks (n < 512) take the walker alone.
//
// Geometry and ordering: two warps a block (walker and stager), 32
// chunks a block (a walker lane a chunk), grid = streams x chunk groups
// (2,048 chunks of a 262,144-sample stream on 64 blocks).  Pass 2 of a
// group needs one value of its left neighbour group (its last chunk's
// pass-1 end), and the repair needs every group's pass 2.  Both are
// status words (one per group and pass, zeroed with the ticket before
// the launch) in the look-back memory of kernels/scan.py, and group ids
// come from an atomic ticket in launch order, so every group a block waits on
// has started before it: the left neighbour for its pass-1 end, and, for
// a stream's last group, which runs the repair, all the stream's groups
// for their pass 2.  No block waits on a block that waits on it, no grid
// barrier, no co-residency requirement (a cooperative launch would bound
// C x groups by the resident blocks and hold every stream at one
// barrier), and no barrier between repaired chunks.
#include "scan_common.cuh"

namespace cutesdr {

constexpr int PLL_LANES = 32;
constexpr int PLL_STEPS = 32;                 // samples a group of a walk
constexpr int PLL_CHUNK = 128;                // K7's chunk (JAX's PLL_CHUNK)
constexpr int PLL_MIN_CHUNKS = 4;             // fewer: the walker alone
constexpr float SEQ_TWO_PI = 6.283185307179586f;     // float32(2pi)
constexpr float ROUND_MAGIC = 12582912.f;            // 1.5 * 2^23
constexpr float FAST_THETA = 4.f;                    // the bounds of the
constexpr float FAST_PHASE = 8.f;                    // fast wrap (header)

struct PllK {
    float alpha, beta, limit, inv;
    bool fast;               // the host allows the fast wrap (its bounds)
    unsigned stager_ns;      // the stager's sleep after each group's
                             // barrier (0: none; a test of the ordering)
};

template <bool FAST>
__device__ __forceinline__ float wrap_pi(float e, float inv) {
    const float x = __fmul_rn(e, inv);
    if (FAST) {
        const float r = __fsub_rn(__fadd_rn(x, ROUND_MAGIC), ROUND_MAGIC);
        return __fmaf_rn(-SEQ_TWO_PI, r, e);
    }
    return __fsub_rn(e, __fmul_rn(SEQ_TWO_PI, rintf(x)));
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

// One sample of either loop; returns err.
template <bool FM, bool FAST>
__device__ __forceinline__ float pll_step(float th, float& phase,
                                          float& freq, const PllK& k) {
    const float w = wrap_pi<FAST>(FM ? __fadd_rn(th, phase)
                                     : __fsub_rn(th, phase), k.inv);
    const float err = FM ? -w : w;
    const float a_err = __fmul_rn(k.alpha, err);
    freq = clampf(__fadd_rn(freq, __fmul_rn(k.beta, err)), k.limit);
    phase = wrap_pi<FAST>(__fadd_rn(__fadd_rn(phase, freq), a_err), k.inv);
    return err;
}

// The block's staging tiles: row r holds segment r's PLL_STEPS samples of
// a group (theta and the outputs double-buffered), and the walk's stop.
constexpr int PLL_ROW = PLL_STEPS + 1;        // row stride: no conflicts
constexpr int PLL_THREADS = 2 * PLL_LANES;    // the walker and the stager
struct PllTiles {
    float th[2][PLL_LANES * PLL_ROW];
    float o0[2][PLL_LANES * PLL_ROW];
    float o1[2][PLL_LANES * PLL_ROW];
    int stopped;             // chunks walked before a stop; -1: none
                             // (read once both warps have left the walk)
};

// Up to 32 segments of equal length, evenly spaced in one row; sample i
// of segment r is row[first + r*stride + i] (indices below 0 read as 0).
struct Span {
    const float* row;
    float* o0;               // outputs, indexed as row; null: none
    float* o1;               // FM's err series; null: none
    long long first, stride;
    int nseg, len;           // block-uniform
};

struct PllState { float phase, freq; };

struct WalkEnd {
    PllState st;             // the walker warp's lanes (the stager: none)
    int stopped;             // chunks walked before a stop; -1: none
};

__device__ __forceinline__ bool same_bits(float2 x, float2 y) {
    return __float_as_uint(x.x) == __float_as_uint(y.x) &&
           __float_as_uint(x.y) == __float_as_uint(y.y);
}

// Lane 0's state in every lane of the warp.
__device__ __forceinline__ PllState broadcast(PllState st) {
    return {__shfl_sync(FULL, st.phase, 0), __shfl_sync(FULL, st.freq, 0)};
}

// Each segment's group at ``off`` into ``tile``, the stager's lanes
// taking consecutive samples (coalesced), asynchronously (cp.async,
// zero-filled outside the segments).
__device__ __forceinline__ void stage_group(float* tile, const Span& s,
                                            int off, int lane) {
    for (int r = 0; r < s.nseg; ++r) {
#pragma unroll
        for (int q = 0; q < PLL_STEPS / PLL_LANES; ++q) {
            const int j = off + q * PLL_LANES + lane;
            const long long i = s.first + r * s.stride + j;
            const bool in = j < s.len && i >= 0;
            const unsigned dst = (unsigned)__cvta_generic_to_shared(
                tile + r * PLL_ROW + q * PLL_LANES + lane);
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                         :: "r"(dst), "l"(in ? s.row + i : s.row),
                            "r"(in ? 4 : 0));
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_copies() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Group g's outputs from the tiles to device memory (the stager).
template <bool FM>
__device__ __forceinline__ void store_group(const PllTiles& t,
                                            const Span& s, int g,
                                            int lane) {
    const int off = g * PLL_STEPS;
    const int glen = min(PLL_STEPS, s.len - off);
    for (int r = 0; r < s.nseg; ++r) {
#pragma unroll
        for (int q = 0; q < PLL_STEPS / PLL_LANES; ++q) {
            const int j = q * PLL_LANES + lane;
            if (j < glen) {
                const long long i = s.first + r * s.stride + off + j;
                s.o0[i] = t.o0[g & 1][r * PLL_ROW + j];
                if (FM && s.o1) s.o1[i] = t.o1[g & 1][r * PLL_ROW + j];
            }
        }
    }
}

// The ``glen`` steps of this lane's segment from theta in registers,
// outputs into this lane's tile rows.  Between the steps the next
// group's theta ``nx`` (read from shared memory before them) is mapped
// from -0 to +0 and checked against the fast wrap's bound into
// ``ok_next``, in instruction slots the chain leaves idle.  PARTIAL: glen may
// be below PLL_STEPS (warp-uniform; the last group, with no next).
template <bool FM, bool FAST, bool PARTIAL>
__device__ __forceinline__ void run_group(const float (&th)[PLL_STEPS],
                                          float (&nx)[PLL_STEPS],
                                          bool& ok_next, float* o0,
                                          float* o1, int glen, PllState& st,
                                          const PllK& k) {
#pragma unroll
    for (int j = 0; j < PLL_STEPS; ++j) {
        if (PARTIAL && j >= glen) break;
        const float before = st.phase;
        const float err = pll_step<FM, FAST>(th[j], st.phase, st.freq, k);
        if (FM) {
            o0[j] = st.freq;
            o1[j] = err;
        } else {
            o0[j] = before;
        }
        nx[j] = __fadd_rn(nx[j], 0.f);        // -0 -> +0 (see the header)
        ok_next &= fabsf(nx[j]) <= FAST_THETA;
    }
}

// A barrier of the block's two warps (named, so that the walker's and
// the stager's code paths meet at it), ordering their shared memory.
__device__ __forceinline__ void block_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(PLL_THREADS) : "memory");
}

// The same barrier as a reduction: true in both warps if any thread
// passed true.  The walk's per-group barriers are all of this kind (a
// barrier's instance is never met by bar.sync on one side and bar.red on
// the other); the walker's stop travels in it, so the stager never reads
// a word the walker may be writing.
__device__ __forceinline__ bool block_sync_or(bool p) {
    unsigned r;
    asm volatile("{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n"
                 " bar.red.or.pred q, 1, %2, p;\n selp.u32 %0, 1, 0, q;\n}\n"
                 : "=r"(r) : "r"((unsigned)p), "n"(PLL_THREADS) : "memory");
    return r != 0;
}

// The walker warp's side of a walk: lane l walks segment l of ``s`` from
// ``st`` (lanes past s.nseg walk garbage and are ignored).  At each
// group's barrier the next group's theta is staged; it is read into
// registers during the group's steps, checked against the fast wrap's
// bound there and used as the next group's, so no read and no check sits
// on the chain.  A walk takes the fast wrap where its start phase and
// each group's theta are within the bound.
template <bool FM>
__device__ __noinline__ PllState walker(const Span& s, PllState st,
                                        const PllK& k, PllTiles& t,
                                        long long* clocks,
                                        const float2* stop, int nstop) {
    constexpr int GPC = PLL_CHUNK / PLL_STEPS;      // groups a chunk
    const int lane = threadIdx.x;
    const int groups = (s.len + PLL_STEPS - 1) / PLL_STEPS;
    const bool active = lane < s.nseg;
    // a start phase within the bound; after one wrap |phase| < 4
    const bool fast = k.fast && __all_sync(
        FULL, !active || fabsf(st.phase) <= FAST_PHASE);
    float cur[PLL_STEPS], nx[PLL_STEPS];
    bool ok = true;
    if (lane == 0) t.stopped = -1;
    block_sync();                              // groups 0 and 1 staged
    {
        const float* row = t.th[0] + lane * PLL_ROW;
#pragma unroll
        for (int j = 0; j < PLL_STEPS; ++j) {
            cur[j] = __fadd_rn(row[j], 0.f);
            ok &= fabsf(cur[j]) <= FAST_THETA;
        }
    }
    for (int g = 0; g < groups; ++g) {
        block_sync_or(false);                  // group g + 1 staged
        if (g + 1 < groups) {
            const float* row = t.th[(g + 1) & 1] + lane * PLL_ROW;
#pragma unroll
            for (int j = 0; j < PLL_STEPS; ++j) nx[j] = row[j];
        } else {
#pragma unroll
            for (int j = 0; j < PLL_STEPS; ++j) nx[j] = 0.f;
        }
        const int glen = min(PLL_STEPS, s.len - g * PLL_STEPS);
        const bool f = fast && __all_sync(FULL, !active || ok);
        const bool check = stop && g / GPC < nstop && g % GPC == GPC - 1;
        const float2 stop_at = check ? __ldcg(stop + g / GPC)
                                     : make_float2(0.f, 0.f);
        const bool probe = clocks && blockIdx.x == 0 && lane == 0;
        if (probe && (g == 1 || g == groups - 1))
            clocks[g == 1 ? 0 : 2] = clock64();
        float* o0 = t.o0[g & 1] + lane * PLL_ROW;
        float* o1 = t.o1[g & 1] + lane * PLL_ROW;
        ok = true;
        if (glen == PLL_STEPS) {
            if (f) run_group<FM, true, false>(cur, nx, ok, o0, o1, glen, st,
                                              k);
            else run_group<FM, false, false>(cur, nx, ok, o0, o1, glen, st,
                                               k);
        } else {
            if (f) run_group<FM, true, true>(cur, nx, ok, o0, o1, glen, st,
                                             k);
            else run_group<FM, false, true>(cur, nx, ok, o0, o1, glen, st,
                                              k);
        }
        if (probe && g == 1) clocks[1] = clock64();
        if (check) {
            const PllState b = broadcast(st);
            if (same_bits(make_float2(b.phase, b.freq), stop_at)) {
                if (lane == 0) t.stopped = g / GPC + 1;
                block_sync_or(true);           // the group's outputs; stop
                return st;
            }
        }
#pragma unroll
        for (int j = 0; j < PLL_STEPS; ++j) cur[j] = nx[j];
    }
    block_sync_or(false);                      // the last group's outputs
    return st;
}

// The stager warp's side: before the walker's barrier for group g it has
// staged group g + 1 (cp.async, landed); after it, it stores group g - 1's
// outputs and starts group g + 2 into the buffer group g left.  A walker
// that stops after group g - 1 meets this barrier with its stop (true):
// the stager stores group g - 1 and leaves.
template <bool FM>
__device__ __noinline__ void stager(const Span& s, PllTiles& t,
                                    unsigned sleep_ns) {
    const int lane = threadIdx.x - PLL_LANES;
    const int groups = (s.len + PLL_STEPS - 1) / PLL_STEPS;
    stage_group(t.th[0], s, 0, lane);
    if (groups > 1) stage_group(t.th[1], s, PLL_STEPS, lane);
    wait_copies();
    block_sync();                              // groups 0 and 1 staged
    for (int g = 0; g < groups; ++g) {
        // the walker is on group g, or stopped after g - 1
        const bool stop = block_sync_or(false);
        if (sleep_ns) __nanosleep(sleep_ns);
        if (g > 0 && s.o0) store_group<FM>(t, s, g - 1, lane);
        if (stop) return;
        if (g + 2 < groups) {
            stage_group(t.th[g & 1], s, (g + 2) * PLL_STEPS, lane);
            wait_copies();
        }
    }
    block_sync_or(false);                      // the walker is done
    if (s.o0 && groups > 0) store_group<FM>(t, s, groups - 1, lane);
}

// One walk, both warps of the block calling it with the same arguments:
// the walker warp runs the steps (walker), the stager warp moves theta in
// and the outputs out (stager), one barrier a group between them.  With
// ``stop`` (one segment of whole 128-sample chunks: the repair walker)
// the walk stops after chunk c < nstop whose end state equals stop[c]
// bitwise.  ``clocks``, where not null, gets block 0's clock64() before
// and after the steps of group 1 and before those of the last group.
// Returns, in both warps, the stop; the state in the walker's lanes.
template <bool FM>
__device__ WalkEnd walk(const Span& s, PllState st, const PllK& k,
                        PllTiles& t, long long* clocks, const float2* stop,
                        int nstop) {
    if (threadIdx.x < PLL_LANES)
        st = walker<FM>(s, st, k, t, clocks, stop, nstop);
    else
        stager<FM>(s, t, k.stager_ns);
    block_sync();                              // stores done, stop read
    const int stopped = t.stopped;
    block_sync();                              // before the next walk
    return {st, stopped};
}

struct PllArgs {
    const float* theta;      // [C, n]
    int n, n_ch, halo;
    PllK k;
    const float* state0;     // [C, 2] phase, freq
    float* out0;             // [C, n] FM: freq series;  SAM: pre-update phase
    float* out1;             // [C, n] FM: err series;   SAM: unused
    float* state;            // [C, 2] phase mod 2pi, freq
    unsigned char* valid;    // [C] FM: the first verify held (0 unchunked)
    float2* e1;              // [C, n / 128] FM chunked: pass-1 end states
    float2* e2;              //                          pass-2 end states
    unsigned* flags;         // [2 * C * groups] status words (zeroed)
    unsigned* ticket;        // zeroed before the launch
    long long* clocks;       // [3] or null: the clock probe
    const unsigned char* skip;   // null, or a flag: when set, the call
                                 // leaves every output as it was (FM's
                                 // valid: 0) and returns at once
};

// The skip flag of a call (every thread reads it; all return together,
// before any barrier).
__device__ __forceinline__ bool skipped(const PllArgs& a) {
    return a.skip && *a.skip;
}

__device__ __forceinline__ PllState start_state(const PllArgs& a, int c) {
    return {__fadd_rn(a.state0[2 * c], 0.f), a.state0[2 * c + 1]};
}

__device__ __forceinline__ void put_state(const PllArgs& a, int c,
                                          PllState st) {
    a.state[2 * c] = mod_two_pi(st.phase);
    a.state[2 * c + 1] = st.freq;
}

// The walker over the streams: block b walks streams 32b .. 32b + 31.
template <bool FM>
__global__ void __launch_bounds__(PLL_THREADS) pll_walk_kernel(PllArgs a) {
    __shared__ PllTiles t;
    const int lane = threadIdx.x & (PLL_LANES - 1);
    const bool mine = threadIdx.x < PLL_LANES;      // the walker warp
    const int c0 = blockIdx.x * PLL_LANES;
    const int nseg = min(PLL_LANES, a.n_ch - c0);
    const int c = c0 + min(lane, nseg - 1);
    if (skipped(a)) {
        if (FM && mine && lane < nseg) a.valid[c] = 0;
        return;
    }
    const long long row = (long long)c0 * a.n;
    const Span s{a.theta + row, a.out0 + row, FM ? a.out1 + row : nullptr,
                 0, a.n, nseg, a.n};
    const PllState st =
        walk<FM>(s, start_state(a, c), a.k, t, a.clocks, nullptr, 0).st;
    if (mine && lane < nseg) {
        if (!FM && a.n > 0)                    // the start phase as given
            a.out0[row + (long long)lane * a.n] = a.state0[2 * c];
        put_state(a, c, st);
        if (FM) a.valid[c] = 0;
    }
}

// The first boundary in [from, end) whose pass-2 end differs bitwise from
// its pass-1 end, or ``end``.  All lanes call; every lane returns it.
__device__ int next_failed(const float2* e1, const float2* e2, int from,
                           int end, int lane) {
    for (int base = from; base < end; base += PLL_LANES) {
        const int q = base + lane;
        const bool bad = q < end && !same_bits(__ldcg(e1 + q), __ldcg(e2 + q));
        const unsigned m = __ballot_sync(FULL, bad);
        if (m) return base + __ffs(m) - 1;
    }
    return end;
}

// Every lane's stores before it, visible device-wide, then the word.
__device__ __forceinline__ void publish_word(unsigned* word) {
    __threadfence();
    __syncwarp();
    if (threadIdx.x == 0) st_release(word, READY);
}

// K7 on n >= 4 chunks: one block a group of 32 chunks of one stream.
// Both warps run the same control flow (every decision comes from device
// memory or the walk's shared stop); only the walker warp writes state.
__global__ void __launch_bounds__(PLL_THREADS) fm_chunked_kernel(PllArgs a) {
    __shared__ PllTiles t;
    __shared__ unsigned id_s;
    const int lane = threadIdx.x & (PLL_LANES - 1);
    const bool mine = threadIdx.x < PLL_LANES;      // the walker warp
    if (skipped(a)) {
        if (threadIdx.x == 0 && (int)blockIdx.x < a.n_ch)
            a.valid[blockIdx.x] = 0;
        return;
    }
    if (threadIdx.x == 0) id_s = atomicAdd(a.ticket, 1u);
    __syncthreads();
    const unsigned id = id_s;
    const int K = a.n / PLL_CHUNK;
    const int G = (K + PLL_LANES - 1) / PLL_LANES;
    const int c = (int)(id / G), g = (int)(id % G);
    const int k0 = g * PLL_LANES, nseg = min(PLL_LANES, K - k0);
    const int kk = k0 + lane;                  // this lane's chunk
    const bool writes = mine && lane < nseg;
    const long long row = (long long)c * a.n;
    const float* th = a.theta + row;
    float* out0 = a.out0 + row;
    float* out1 = a.out1 + row;
    float2* e1 = a.e1 + (long long)c * K;
    float2* e2 = a.e2 + (long long)c * K;
    const PllState init = start_state(a, c);
    const long long own = (long long)k0 * PLL_CHUNK;

    // pass 1: from the guess through the halo, then the chunk's own
    PllState st = init;
    if (a.halo > 0)
        st = walk<true>(Span{th, nullptr, nullptr, own - a.halo, PLL_CHUNK,
                             nseg, a.halo},
                        st, a.k, t, nullptr, nullptr, 0).st;
    if (kk == 0) st = init;                    // chunk 0's halo forgotten
    st = walk<true>(Span{th, nullptr, nullptr, own, PLL_CHUNK, nseg,
                         PLL_CHUNK}, st, a.k, t, nullptr, nullptr, 0).st;
    if (writes) e1[kk] = make_float2(st.phase, st.freq);
    publish_word(a.flags + 2 * id);

    // pass 2: from the left neighbour's pass-1 end
    PllState left{__shfl_up_sync(FULL, st.phase, 1),
                  __shfl_up_sync(FULL, st.freq, 1)};
    if (threadIdx.x == 0) {
        if (g == 0) {
            left = init;
        } else {
            while (ld_acquire(a.flags + 2 * (id - 1)) != READY) {
            }
            const float2 v = __ldcg(e1 + k0 - 1);
            left = {v.x, v.y};
        }
    }
    st = walk<true>(Span{th, out0, out1, own, PLL_CHUNK, nseg, PLL_CHUNK},
                    left, a.k, t, nullptr, nullptr, 0).st;
    if (writes) e2[kk] = make_float2(st.phase, st.freq);
    publish_word(a.flags + 2 * id + 1);
    if (g != G - 1) return;

    // the stream's last group: every group's pass 2, the first verify,
    // then the repair walk
    for (int q = lane; q < G - 1; q += PLL_LANES) {
        while (ld_acquire(a.flags + 2 * (id - (G - 1) + q) + 1) != READY) {
        }
    }
    __syncthreads();
    bool held = true;
    for (int q = lane; q < K - 1; q += PLL_LANES) {
        const float2 x = __ldcg(e1 + q), y = __ldcg(e2 + q);
        held &= x.x == y.x && x.y == y.y;
    }
    held = __all_sync(FULL, held);
    int k = next_failed(e1, e2, 0, K - 1, lane);
    float2 v = __ldcg(e2 + k);                 // the true end of chunk k
    st = {v.x, v.y};
    while (k < K - 1) {
        // chunks k + 1 .. K - 1 from the true state, in one walk that
        // stops after a chunk m < K - 1 whose true end is the pass-1 end
        // that chunk m + 1 consumed: chunk m + 1's outputs are true
        const WalkEnd w = walk<true>(
            Span{th, out0, out1, (long long)(k + 1) * PLL_CHUNK, 0, 1,
                 (K - 1 - k) * PLL_CHUNK},
            st, a.k, t, nullptr, e1 + k + 1, K - 2 - k);
        st = broadcast(w.st);
        if (w.stopped < 0) break;              // walked to the end
        k = next_failed(e1, e2, k + w.stopped + 1, K - 1, lane);
        v = __ldcg(e2 + k);
        st = {v.x, v.y};
    }
    const int tail = a.n - K * PLL_CHUNK;
    if (tail)
        st = broadcast(walk<true>(
            Span{th, out0, out1, (long long)K * PLL_CHUNK, 0, 1, tail}, st,
            a.k, t, nullptr, nullptr, 0).st);
    if (threadIdx.x == 0) {
        put_state(a, c, st);
        a.valid[c] = held;
    }
}

static bool fm_chunked(int n) {
    return n / PLL_CHUNK >= PLL_MIN_CHUNKS;
}

static PllK make_k(float alpha, float beta, float limit, int fast,
                   unsigned stager_ns) {
    return {alpha, beta, limit, 1.f / SEQ_TWO_PI, fast != 0, stager_ns};
}

}  // namespace cutesdr

using namespace cutesdr;

// K7: the FM loop over theta [n_ch, n] from state0 [n_ch, 2]: freqs, err
// [n_ch, n], state [n_ch, 2], valid [n_ch].  n >= 512 (4 chunks of 128)
// takes the chunked scan with ``halo`` (0 .. 128) samples of warm-up,
// e1, e2 [n_ch, n / 128] float2 scratch and 2 * n_ch * ceil(n / 4096)
// status words (flags and the ticket, zeroed by the caller before the
// launch, as cutesdr_scan_affine's); below, the walker (valid 0, no
// scratch).
// fast: the fast wrap may be used (limit + 4*|alpha| <= 7); limit >= 0.
// clocks [3] or null: the clock probe, which takes the walker at every n.
// stager_ns: the stager warp sleeps this long after each group's barrier
// (0 in use; a check that the walk's stop does not race its stores).
// skip: null, or a device flag (FM's linear tier held) on which the call
// writes valid 0, leaves freqs, err and state as they were, and returns.
CUTESDR_API int cutesdr_fm_pll(const float* theta, int n, int n_ch,
                               float alpha, float beta, float limit,
                               int fast, int halo, const float* state0,
                               float* freqs, float* err, float* state,
                               unsigned char* valid, float2* e1,
                               float2* e2,
                               unsigned* flags, unsigned* ticket,
                               long long* clocks, unsigned stager_ns,
                               const unsigned char* skip, void* stream) {
    if (n < 0 || n_ch <= 0 || halo < 0 || halo > PLL_CHUNK || !(limit >= 0.f))
        return (int)cudaErrorInvalidValue;
    const PllArgs a{theta, n, n_ch, halo,
                    make_k(alpha, beta, limit, fast, stager_ns),
                    state0, freqs, err, state, valid, e1, e2, flags, ticket,
                    clocks, skip};
    const cudaStream_t st = (cudaStream_t)stream;
    if (fm_chunked(n) && !clocks) {
        const int groups = (n / PLL_CHUNK + PLL_LANES - 1) / PLL_LANES;
        fm_chunked_kernel<<<n_ch * groups, PLL_THREADS, 0, st>>>(a);
    } else {
        pll_walk_kernel<true><<<(n_ch + PLL_LANES - 1) / PLL_LANES,
                                PLL_THREADS, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}

// K8: the SAM loop over theta [n_ch, n]: prev [n_ch, n] (the pre-update
// phases), state [n_ch, 2]; streams packed one a lane.  skip: null, or a
// device flag (SAM's linear tier held) on which the call leaves prev and
// state as they were and returns.
CUTESDR_API int cutesdr_sam_pll(const float* theta, int n, int n_ch,
                                float alpha, float beta, float limit,
                                int fast, const float* state0, float* prev,
                                float* state, long long* clocks,
                                const unsigned char* skip, void* stream) {
    if (n < 0 || n_ch <= 0 || !(limit >= 0.f))
        return (int)cudaErrorInvalidValue;
    const PllArgs a{theta, n, n_ch, 0, make_k(alpha, beta, limit, fast, 0),
                    state0, prev, nullptr, state, nullptr, nullptr, nullptr,
                    nullptr, nullptr, clocks, skip};
    pll_walk_kernel<false><<<(n_ch + PLL_LANES - 1) / PLL_LANES,
                             PLL_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
