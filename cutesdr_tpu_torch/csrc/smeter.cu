// S-meter averager pair, final values only, over [rows, n].
//
// Replaces cutesdr_tpu/kernels/scan1.py:smeter_last (_smeter_kernel):
//     a[n] = (1-aa)*a[n-1] + aa*m[n]                (attack EMA)
//     d[n] = max((1-ad)*d[n-1] + ad*m[n], a[n])     (snapped decay)
// and emits (a[N-1], d[N-1]) of every row; the series are never written.
//
// Bound on the H100: latency.  It is a reduction of the magnitudes to two
// scalars a row, so the cost is the number of dependent passes.  Design:
// ONE launch, grid = rows x chunks of 2048, one read of ``mag``.  Each
// block stages its chunk with coalesced 16-byte loads and each thread
// keeps its 8 consecutive magnitudes in registers for both phases:
//  1. the attack EMA: an ordered block scan of the affine maps
//     (1-aa, aa*m) gives each thread its prefix and the chunk its map; the
//     look-back over the row's earlier chunks (scan_common.cuh) gives the
//     chunk its attack start value;
//  2. the decay: each thread rebuilds its attack values and composes the
//     max-affine maps (1-ad, ad*m, a) in order, identity (1, 0, -inf) as
//     scan1.py:276, in double (scan_common.cuh; the per-element terms are
//     the plain version's float32 values); an ordered block
//     reduction gives the chunk its map, and a second look-back, chained
//     in the same launch, its decay start value; d_last rounds to float32
//     once.
// The last chunk of a row writes the row's (a_last, d_last).  A row of one
// chunk (the session's block, a bank's rows, the FM monitor) takes no
// look-back.  No scratch, no host read; the caller zeroes the look-back's
// status words and ticket before the launch (scan_common.cuh).
#include "scan_common.cuh"

namespace cutesdr {

struct SmeterArgs {
    const float* mag;        // [rows, n]
    int n, nchunks, rows;
    bool vec;                // mag 16-byte aligned, n % 4 == 0
    float aa, ca, ad, cd;    // alphas and the plain version's 1 - alpha
    const float* a0;         // row r's initial states at [r * carry_stride]
    const float* d0;
    int carry_stride;
    float* out;              // [2, rows]: a_last, d_last
    Lookback attack, decay;
    unsigned* ticket;
};

__global__ void __launch_bounds__(SCAN_THREADS) smeter_kernel(SmeterArgs s) {
    __shared__ __align__(16) float tile[SCAN_CHUNK];
    const bool chained = s.nchunks > 1;
    const int id = chunk_ticket(s.ticket, chained);
    const int row = id / s.nchunks, c = id - row * s.nchunks;
    const int len = min(SCAN_CHUNK, s.n - c * SCAN_CHUNK);
    load_tile(tile, s.mag + (long long)row * s.n + (long long)c * SCAN_CHUNK,
              len, s.vec);
    __syncthreads();
    float m[SCAN_ITEMS];
    own_items(tile, m);
    const int first = (int)threadIdx.x * SCAN_ITEMS;
    Aff t = aff_id();
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k)
        if (first + k < len) t = compose(t, Aff{s.ca, __fmul_rn(s.aa, m[k])});
    Aff total;
    const Aff ex = block_exclusive(t, &total);
    const int slots = row * s.nchunks;
    const float a0 = s.a0[(long long)row * s.carry_stride];
    const float a_start =
        chained ? chunk_start(s.attack, slots, c, s.nchunks, total, a0) : a0;
    float a = apply(ex, a_start);
    MaxAff dm = maxaff_id();
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        if (first + k < len) {
            a = apply(Aff{s.ca, __fmul_rn(s.aa, m[k])}, a);
            dm = compose(dm, MaxAff{s.cd, __fmul_rn(s.ad, m[k]), a});
        }
    }
    dm = block_reduce(dm);                 // valid in thread 0
    const double d0 = s.d0[(long long)row * s.carry_stride];
    const double d_start =
        chained ? chunk_start(s.decay, slots, c, s.nchunks, dm, d0)
                : d0;
    if (c == s.nchunks - 1 && threadIdx.x == 0) {
        s.out[row] = apply(total, a_start);
        s.out[s.rows + row] = (float)apply(dm, d_start);
    }
}

}  // namespace cutesdr

using namespace cutesdr;

// (a_last, d_last) of every row of mag [rows, n] into out [2, rows], in
// one launch.  ca, cd: 1 - aa and 1 - ad as the plain version rounds
// them; a0, d0: the rows' initial states at r * carry_stride; vec: mag
// 16-byte aligned and n % 4 == 0.  Rows of more than one chunk chain
// through two phases of look-back memory (flags: 2 * rows * ceil(n / 2048)
// slots, agg: two 16-byte words a slot; the decay phase's after the
// attack's;
// ticket: one counter), all zeroed by the caller before the launch.
CUTESDR_API int cutesdr_smeter(const float* mag, float aa, float ca, float ad,
                               float cd, const float* a0, const float* d0,
                               int carry_stride, int n, int rows, int vec,
                               float* out, unsigned* flags, double2* agg,
                               unsigned* ticket, void* stream) {
    if (n <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
    const int nchunks = (n + SCAN_CHUNK - 1) / SCAN_CHUNK;
    const int slots = rows * nchunks;
    SmeterArgs s{mag, n, nchunks, rows, vec != 0, aa, ca, ad, cd, a0, d0,
                 carry_stride, out,
                 {flags, agg},
                 {flags + slots, agg + 2 * slots},
                 ticket};
    smeter_kernel<<<slots, SCAN_THREADS, 0, (cudaStream_t)stream>>>(s);
    return (int)cudaGetLastError();
}
