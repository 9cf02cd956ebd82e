// Shared pieces of the affine scans (scan.cu, smeter.cu): the operator
// algebra, ordered warp/block scans and reductions, tile staging, and the
// single-pass decoupled look-back that chains a row's chunks inside one
// launch.
//
// Affine maps x -> a*x + b compose "l then r" as (l.a*r.a, r.a*l.b + r.b);
// max-affine maps x -> max(c*x + u, v) (c >= 0) compose as
// (l.c*r.c, r.c*l.u + r.u, max(r.c*l.v + r.u, r.v)) with identity
// (1, 0, -inf).  Both are associative but not commutative, so every scan
// and reduction below keeps the element order.  Max-affine maps are held
// in double: the S-meter's decay composes 1 - alpha ~ 0.99997 over whole
// rows, and in float32 the rounding of those products, the same for every
// chunk, left its final value up to 1.7x farther from the float64 solve
// than the plain log-depth solve (6.6e-4 dB at 262,143 on the H100); in
// double it is 1e-5 to 3e-5 dB, the float32 attack values it snaps to.
#pragma once

#include "common.cuh"

namespace cutesdr {

constexpr int SCAN_THREADS = 256;                 // threads per block
constexpr int SCAN_ITEMS = 8;                     // elements per thread
constexpr int SCAN_CHUNK = SCAN_THREADS * SCAN_ITEMS;   // 2048 per block

struct Aff { float a, b; };
struct MaxAff { double c, u, v; };

__device__ __forceinline__ Aff aff_id() { return {1.f, 0.f}; }
__device__ __forceinline__ Aff compose(Aff l, Aff r) {
    return {l.a * r.a, fmaf(r.a, l.b, r.b)};
}
__device__ __forceinline__ float apply(Aff f, float x) {
    return fmaf(f.a, x, f.b);
}

__device__ __forceinline__ MaxAff maxaff_id() { return {1.f, 0.f, -INFINITY}; }
__device__ __forceinline__ MaxAff compose(MaxAff l, MaxAff r) {
    return {l.c * r.c, fma(r.c, l.u, r.u), fmax(fma(r.c, l.v, r.u), r.v)};
}
__device__ __forceinline__ double apply(MaxAff f, double x) {
    return fmax(fma(f.c, x, f.u), f.v);
}

__device__ __forceinline__ void identity(Aff* m) { *m = aff_id(); }
__device__ __forceinline__ void identity(MaxAff* m) { *m = maxaff_id(); }

__device__ __forceinline__ Aff shfl_up(Aff x, int d) {
    return {__shfl_up_sync(FULL, x.a, d), __shfl_up_sync(FULL, x.b, d)};
}
__device__ __forceinline__ Aff shfl_down(Aff x, int d) {
    return {__shfl_down_sync(FULL, x.a, d), __shfl_down_sync(FULL, x.b, d)};
}
__device__ __forceinline__ MaxAff shfl_down(MaxAff x, int d) {
    return {__shfl_down_sync(FULL, x.c, d), __shfl_down_sync(FULL, x.u, d),
            __shfl_down_sync(FULL, x.v, d)};
}

// Inclusive scan over the 32 lanes of a warp (all lanes must call); Map
// is any map type with ``compose`` and ``shfl_up`` (Aff here, the
// biquad's 2x2 map in iir.cu).
template <class Map>
__device__ __forceinline__ Map warp_inclusive(Map x) {
    const int lane = threadIdx.x & 31;
    for (int d = 1; d < 32; d <<= 1) {
        Map y = shfl_up(x, d);
        if (lane >= d) x = compose(y, x);
    }
    return x;
}

// Exclusive scan of one value per thread over the whole block, in thread
// order; *total receives the block's composition.  All threads call.
template <class Map>
__device__ Map block_exclusive(Map x, Map* total) {
    __shared__ Map warp_tot[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    Map inc = warp_inclusive(x);
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        Map w;
        if (lane < nwarps) w = warp_tot[lane];
        else identity(&w);
        w = warp_inclusive(w);
        warp_tot[lane] = w;               // inclusive over warps
    }
    __syncthreads();
    Map ex = shfl_up(inc, 1);
    if (lane == 0) identity(&ex);
    Map res = warp == 0 ? ex : compose(warp_tot[warp - 1], ex);
    *total = warp_tot[nwarps - 1];
    __syncthreads();                      // warp_tot is reused by the caller
    return res;
}

// Ordered reduction of one max-affine map per thread; the result is valid
// in thread 0.  All threads call.
static __device__ MaxAff block_reduce(MaxAff x) {
    __shared__ MaxAff warp_tot[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int d = 1; d < 32; d <<= 1) {
        MaxAff y = shfl_down(x, d);
        if (lane + d < 32) x = compose(x, y);
    }
    if (lane == 0) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
        x = lane < nwarps ? warp_tot[lane] : maxaff_id();
        for (int d = 1; d < 32; d <<= 1) {
            MaxAff y = shfl_down(x, d);
            if (lane + d < 32) x = compose(x, y);
        }
    }
    __syncthreads();
    return x;
}

// ------------------------------------------------------------ staging --
//
// A chunk of ``len`` <= SCAN_CHUNK floats moves between device memory and
// a shared tile in coalesced accesses (16-byte vectors where ``vec``: the
// source is 16-byte aligned), so that each thread can then own
// SCAN_ITEMS consecutive elements of the tile.

__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int len, bool vec) {
    int done = 0;
    if (vec) {
        done = len & ~3;
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* t4 = reinterpret_cast<float4*>(tile);
        for (int k = threadIdx.x; k < done / 4; k += blockDim.x)
            t4[k] = s4[k];
    }
    for (int k = done + threadIdx.x; k < len; k += blockDim.x)
        tile[k] = src[k];
}

__device__ __forceinline__ void store_tile(float* dst, const float* tile,
                                           int len, bool vec) {
    int done = 0;
    if (vec) {
        done = len & ~3;
        float4* d4 = reinterpret_cast<float4*>(dst);
        const float4* t4 = reinterpret_cast<const float4*>(tile);
        for (int k = threadIdx.x; k < done / 4; k += blockDim.x)
            d4[k] = t4[k];
    }
    for (int k = done + threadIdx.x; k < len; k += blockDim.x)
        dst[k] = tile[k];
}

// This thread's SCAN_ITEMS consecutive tile elements (two 16-byte reads).
__device__ __forceinline__ void own_items(const float* tile,
                                          float (&v)[SCAN_ITEMS]) {
    const float4* t4 = reinterpret_cast<const float4*>(tile) + 2 * threadIdx.x;
    const float4 p = t4[0], q = t4[1];
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
    v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
}

__device__ __forceinline__ void put_items(float* tile,
                                          const float (&v)[SCAN_ITEMS]) {
    float4* t4 = reinterpret_cast<float4*>(tile) + 2 * threadIdx.x;
    t4[0] = make_float4(v[0], v[1], v[2], v[3]);
    t4[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// ------------------------------------------------------------ look-back --
//
// A row of n elements is cut into chunks of SCAN_CHUNK, one block each,
// all in one launch.  Every chunk publishes its map (the aggregate of its
// elements) as soon as it has composed them, then every warp of the block
// walks back over a window of 32 of its predecessors' aggregates, all
// windows at once, composes them (a warp reduction, farthest first; then
// the windows in order) and applies the result to the row's initial
// state: the state before the chunk.  One pass over the data (the
// single-pass scan of Merrill & Garland, "Single-pass parallel prefix scan
// with decoupled look-back", 2016, here always looking back to the row's
// start instead of stopping at a predecessor's inclusive value): a chunk
// waits only for aggregates, which no block computes from another's, and
// the order of the composition is fixed by the chunk's index alone, so the
// result does not depend on the blocks' timing: every call gives the same
// bits.  A round of windows covers 256 predecessors at the latency of one
// status word and one map read: at 262,144 elements the last chunk folds
// its 127 in one round.
//
// A status word reads READY once its chunk has published its aggregate.
// The wrapper zeroes the call's status words and its ticket on the stream
// before the launch (one fill, which a CUDA graph captures with the
// launch), so a word left by an earlier call, or by an earlier replay of
// a graph, reads as not ready, and every call's chunk ids start at 0:
// the kernels take no per-call number from the host.  A word is published
// with a release store after its aggregate, and read with an acquire load
// before the aggregate, which is read past L1 (ld.global.cg): L1 is not
// coherent across SMs.  Chunk ids come from an atomic ticket taken when a
// block starts, so every predecessor a block waits on has started, and
// holds its SM, before it: no wait on a block that is not scheduled, even
// while another stream holds SMs.

constexpr unsigned READY = 1u;            // a published status word

struct Lookback {
    unsigned* flags;          // [slots] status words (0, or READY)
    double2* agg;             // [2 * slots] chunk maps, two words a slot
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// A chunk map to and from its slot, past L1 (a float Aff's values are
// exact in double).
__device__ __forceinline__ void publish(double2* slot, Aff m) {
    __stcg(slot, make_double2(m.a, m.b));
}
__device__ __forceinline__ void publish(double2* slot, MaxAff m) {
    __stcg(slot, make_double2(m.c, m.u));
    __stcg(slot + 1, make_double2(m.v, 0.0));
}
__device__ __forceinline__ void fetch(const double2* slot, Aff* m) {
    const double2 w = __ldcg(slot);
    *m = {(float)w.x, (float)w.y};
}
__device__ __forceinline__ void fetch(const double2* slot, MaxAff* m) {
    const double2 w = __ldcg(slot), z = __ldcg(slot + 1);
    *m = {w.x, w.y, z.x};
}

// The block's chunk id: a ticket in launch order (the ticket zeroed
// before the launch), or blockIdx.x where the chunks do not wait on each
// other.  All threads call.
__device__ __forceinline__ int chunk_ticket(unsigned* ticket, bool ordered) {
    __shared__ int id;
    if (!ordered) return blockIdx.x;
    if (threadIdx.x == 0) id = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    return id;
}

// The composition of chunks 0 .. c-1 of a row whose status words start at
// ``row``, in order, valid in thread 0.  All threads call; thread t takes
// the chunk t before the nearest of the round, so warp w's window ends 32*w
// chunks back.  WAIT: spin on each predecessor's status word; without it
// the maps are known to be published (a grid barrier came between, as in
// the AGC solves' rounds) and lb.flags is not read.
template <class Map, bool WAIT = true>
__device__ Map lookback(const Lookback& lb, int row, int c) {
    __shared__ Map window[SCAN_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    Map acc;                                // the chunks after the round
    identity(&acc);
    for (int base = c - 1; base >= 0; base -= (int)blockDim.x) {
        const int j = base - (int)threadIdx.x;
        Map m;
        identity(&m);
        if (j >= 0) {
            while (WAIT && ld_acquire(lb.flags + row + j) != READY) {
            }
            fetch(lb.agg + 2 * (row + j), &m);
        }
        // farthest first: lane l takes in lane l + d before itself
        for (int d = 1; d < 32; d <<= 1) {
            const Map y = shfl_down(m, d);
            if (lane + d < 32) m = compose(y, m);
        }
        if (lane == 0) window[warp] = m;
        __syncthreads();
        if (threadIdx.x == 0)               // farther windows on the left
            for (int w = 0; w < nwarps; ++w) acc = compose(window[w], acc);
        __syncthreads();
    }
    return acc;
}

// The state before chunk c of its row: chunk c publishes its map
// ``total`` (valid in thread 0) unless it is the row's last, then
// applies its predecessors' composition to the row's initial state
// ``x0`` (float for an Aff, double for a MaxAff).  All threads call;
// every thread returns the start.
template <class Map, class T>
__device__ T chunk_start(const Lookback& lb, int row, int c, int nchunks,
                         Map total, T x0) {
    __shared__ T start_s;
    if (threadIdx.x == 0 && c + 1 < nchunks) {
        publish(lb.agg + 2 * (row + c), total);
        st_release(lb.flags + row + c, READY);
    }
    const Map m = lookback<Map>(lb, row, c);
    if (threadIdx.x == 0) start_s = apply(m, x0);
    __syncthreads();
    return start_s;
}

}  // namespace cutesdr
