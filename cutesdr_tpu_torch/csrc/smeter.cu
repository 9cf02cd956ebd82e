// S-meter averager pair, final values only.
//
// Replaces cutesdr_tpu/kernels/scan1.py:smeter_last (_smeter_kernel):
//     a[n] = (1-aa)*a[n-1] + aa*m[n]                (attack EMA)
//     d[n] = max((1-ad)*d[n-1] + ad*m[n], a[n])     (snapped decay)
// and emits (a[N-1], d[N-1]); the series are never written.
//
// Bound on the H100: latency.  It is a reduction of a 1 MB operand to two
// scalars, so the cost is the number of dependent passes.  Design: four
// launches on one stream — (1) per-2048-chunk affine totals of the attack
// EMA; (2) one block turns them into the attack value at each chunk start
// (exclusive prefix, the same pass as scan.cu); (3) each chunk rebuilds its
// attack series locally and composes its max-affine map (c, u, v) =
// (1-ad, ad*m, a) in order, identity (1, 0, -inf) as scan1.py:276; (4) one
// block composes the chunk maps in order and applies them to d0.
#include "scan_common.cuh"

namespace cutesdr {

__device__ __forceinline__ Aff attack_elem(const float* mag, float aa,
                                           int i) {
    return {1.f - aa, aa * mag[i]};
}

__device__ Aff attack_thread_total(const float* mag, float aa, int first,
                                   int n) {
    Aff t = aff_id();
    for (int k = 0; k < SCAN_ITEMS; ++k)
        if (first + k < n) t = compose(t, attack_elem(mag, aa, first + k));
    return t;
}

__global__ void attack_totals_kernel(const float* __restrict__ mag, float aa,
                                     int n, float* __restrict__ tot_a,
                                     float* __restrict__ tot_b) {
    const int first = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
    Aff total;
    block_exclusive(attack_thread_total(mag, aa, first, n), &total);
    if (threadIdx.x == 0) {
        tot_a[blockIdx.x] = total.a;
        tot_b[blockIdx.x] = total.b;
    }
}

__global__ void decay_maps_kernel(const float* __restrict__ mag, float aa,
                                  float ad, int n,
                                  const float* __restrict__ starts,
                                  float* __restrict__ map_c,
                                  float* __restrict__ map_u,
                                  float* __restrict__ map_v) {
    const int first = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
    Aff total;
    Aff ex = block_exclusive(attack_thread_total(mag, aa, first, n), &total);
    float a = apply(ex, starts[blockIdx.x]);
    MaxAff m = maxaff_id();
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        const int i = first + k;
        if (i >= n) break;
        a = apply(attack_elem(mag, aa, i), a);
        m = compose(m, MaxAff{1.f - ad, ad * mag[i], a});
    }
    m = block_reduce(m);
    if (threadIdx.x == 0) {
        map_c[blockIdx.x] = m.c;
        map_u[blockIdx.x] = m.u;
        map_v[blockIdx.x] = m.v;
    }
}

__global__ void finish_kernel(const float* __restrict__ map_c,
                              const float* __restrict__ map_u,
                              const float* __restrict__ map_v, int nchunks,
                              const float* __restrict__ tot_a,
                              const float* __restrict__ tot_b,
                              const float* __restrict__ starts,
                              const float* __restrict__ d0,
                              float* __restrict__ out) {
    MaxAff acc = maxaff_id();
    for (int base = 0; base < nchunks; base += blockDim.x) {
        const int k = base + threadIdx.x;
        MaxAff m = k < nchunks ? MaxAff{map_c[k], map_u[k], map_v[k]}
                               : maxaff_id();
        m = block_reduce(m);
        if (threadIdx.x == 0) acc = compose(acc, m);
    }
    if (threadIdx.x == 0) {
        const int last = nchunks - 1;
        out[0] = apply(Aff{tot_a[last], tot_b[last]}, starts[last]);
        out[1] = fmaxf(fmaf(acc.c, *d0, acc.u), acc.v);
    }
}

}  // namespace cutesdr

using namespace cutesdr;

CUTESDR_API int cutesdr_smeter(const float* mag, float aa, float ad,
                               const float* a0, const float* d0, int n,
                               float* out, float* tot_a, float* tot_b,
                               float* starts, float* map_c, float* map_u,
                               float* map_v, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int nchunks = (n + SCAN_CHUNK - 1) / SCAN_CHUNK;
    attack_totals_kernel<<<nchunks, SCAN_THREADS, 0, st>>>(mag, aa, n, tot_a,
                                                           tot_b);
    chunk_starts_kernel<<<1, SCAN_THREADS, 0, st>>>(tot_a, tot_b, nchunks,
                                                    a0, starts);
    decay_maps_kernel<<<nchunks, SCAN_THREADS, 0, st>>>(
        mag, aa, ad, n, starts, map_c, map_u, map_v);
    finish_kernel<<<1, SCAN_THREADS, 0, st>>>(map_c, map_u, map_v, nchunks,
                                              tot_a, tot_b, starts, d0, out);
    return (int)cudaGetLastError();
}
