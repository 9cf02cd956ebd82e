// Shared pieces of the affine scans (scan.cu, smeter.cu): the operator
// algebra, ordered warp/block scans and reductions, and the single-block
// pass that turns per-chunk totals into chunk start values.
//
// Affine maps x -> a*x + b compose "l then r" as (l.a*r.a, r.a*l.b + r.b);
// max-affine maps x -> max(c*x + u, v) (c >= 0) compose as
// (l.c*r.c, r.c*l.u + r.u, max(r.c*l.v + r.u, r.v)) with identity
// (1, 0, -inf).  Both are associative but not commutative, so every scan
// and reduction below keeps the element order.
#pragma once

#include "common.cuh"

namespace cutesdr {

constexpr int SCAN_THREADS = 256;                 // threads per block
constexpr int SCAN_ITEMS = 8;                     // elements per thread
constexpr int SCAN_CHUNK = SCAN_THREADS * SCAN_ITEMS;   // 2048 per block

struct Aff { float a, b; };
struct MaxAff { float c, u, v; };

__device__ __forceinline__ Aff aff_id() { return {1.f, 0.f}; }
__device__ __forceinline__ Aff compose(Aff l, Aff r) {
    return {l.a * r.a, fmaf(r.a, l.b, r.b)};
}
__device__ __forceinline__ float apply(Aff f, float x) {
    return fmaf(f.a, x, f.b);
}

__device__ __forceinline__ MaxAff maxaff_id() { return {1.f, 0.f, -INFINITY}; }
__device__ __forceinline__ MaxAff compose(MaxAff l, MaxAff r) {
    return {l.c * r.c, fmaf(r.c, l.u, r.u), fmaxf(fmaf(r.c, l.v, r.u), r.v)};
}

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

// Inclusive scan over the 32 lanes of a warp (all lanes must call).
__device__ __forceinline__ Aff warp_inclusive(Aff x) {
    const int lane = threadIdx.x & 31;
    for (int d = 1; d < 32; d <<= 1) {
        Aff y = shfl_up(x, d);
        if (lane >= d) x = compose(y, x);
    }
    return x;
}

// Exclusive scan of one value per thread over the whole block, in thread
// order; *total receives the block's composition.  All threads call.
static __device__ Aff block_exclusive(Aff x, Aff* total) {
    __shared__ Aff warp_tot[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    Aff inc = warp_inclusive(x);
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        Aff w = lane < nwarps ? warp_tot[lane] : aff_id();
        w = warp_inclusive(w);
        warp_tot[lane] = w;               // inclusive over warps
    }
    __syncthreads();
    Aff ex = shfl_up(inc, 1);
    if (lane == 0) ex = aff_id();
    Aff res = warp == 0 ? ex : compose(warp_tot[warp - 1], ex);
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

// Single block: starts[k] = the state before chunk k's first element,
// from the chunk totals and the initial state *x0.
static __global__ void chunk_starts_kernel(const float* __restrict__ tot_a,
                                           const float* __restrict__ tot_b,
                                           int nchunks,
                                           const float* __restrict__ x0,
                                           float* __restrict__ starts) {
    float x = *x0;
    for (int base = 0; base < nchunks; base += blockDim.x) {
        const int k = base + threadIdx.x;
        Aff t = k < nchunks ? Aff{tot_a[k], tot_b[k]} : aff_id();
        Aff total;
        Aff ex = block_exclusive(t, &total);
        if (k < nchunks) starts[k] = apply(ex, x);
        x = apply(total, x);
    }
}

}  // namespace cutesdr
