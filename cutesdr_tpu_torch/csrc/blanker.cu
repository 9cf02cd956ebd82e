// The impulse noise blanker over the radio's int16 planes, one launch
// (K10).
//
// Has no Pallas counterpart: the JAX package runs the blanker as whole-
// block array operations (cutesdr_tpu/ops/noiseblanker.py), which the
// port ran as ~25 torch kernels a block at the input rate: the planes'
// casts, abs, maximum, cat, a float32 cumsum difference, the dilation's
// two cummax passes with their flips, and the wheres.  CuteSDR's
// CNoiseProc (dsp/noiseproc.cpp:121-176), sample by sample:
//
//   mag[i]   = max(|I[i]|, |Q[i]|)
//   S[i]     = mag[i-M] + ... + mag[i]           (M + 1 magnitudes)
//   trig[i]  = mag[i] * ratio > S[i]
//   blank[i] = any trig among positions i-W+1 .. i
//   out[i]   = blank[i] ? 0 : x[i - D1]          (D1 = W/2 + 1)
//
// Positions below 0 are the carried tails: the last M magnitudes, the
// last W-1 triggers and the last D1 input samples (the float32/complex64
// BlankerCarry of ops/noiseblanker.py, which holds integers on this
// route; a magnitude before the tail counts 0, as at a cold start).
//
// The magnitudes of int16 planes are integers, so S is summed in integers
// (exact, as the float64 reference's is; a float32 cumulative sum reaches
// ~1.8e9 over a 524,288-sample block, where its step is 128) and the
// comparison is made in double: the same double product and sum as the
// float64 reference's.  The output is zero or a delayed input sample, an
// int16 again, so the blanked planes are written as int16 and K1 reads
// them on its int16 route.
//
// Work split: a block of BL_THREADS threads takes a tile of T outputs
// [t0, t1) of one row.  It stages d[q] = mag[q] - mag[q-M-1] for the
// positions [a, t1), a = max(t0 - (W-1), 0), in shared memory, sums the
// M + 1 magnitudes before a (S[a-1]) with a block reduction, and scans d
// in order: S[q] = S[a-1] + d[a] + ... + d[q], each sum exact.  Its
// triggers over [t0 - (W-1), t1) (the tail's below 0) then take a second
// block scan, a running count, so blank[i] = C[i] - C[i-W] > 0 for any
// width.  The tile holding the row's last sample writes the new tails.
//
// Bound on the H100: the int16 planes read once and written once (8 bytes
// a sample) and the tails; at 524,288 samples 4.2 MB, 1.25 us at 3.35
// TB/s.  The tile re-reads the M + 1 magnitudes before it and the lagged
// ones (from L2: a block's planes are 2 MB).
#include "common.cuh"

namespace cutesdr {

constexpr int BL_THREADS = 512;
constexpr int BL_WARPS = BL_THREADS / 32;

struct BlankerArgs {
    const short* re;
    const short* im;
    long long in_cstride;         // elements between rows of the planes
    const float* mag_tail;        // [rows, M]
    const float* trig_tail;       // [rows, W-1]
    const float2* sig_tail;       // [rows, D1]
    short* out_re;                // [rows, n]
    short* out_im;
    float* new_mag;               // [rows, M]
    float* new_trig;              // [rows, W-1]
    float2* new_sig;              // [rows, D1]
    int n, M, W, D1, tile;
    double ratio;
};

// The magnitude at position q of a row (q < 0: the carried tail, 0
// before it).
__device__ __forceinline__ int mag_at(const BlankerArgs& s, const short* re,
                                      const short* im, const float* tail,
                                      int q) {
    if (q >= 0) return max(abs((int)re[q]), abs((int)im[q]));
    if (q >= -s.M) return __float2int_rn(tail[s.M + q]);
    return 0;
}

// Inclusive scan of v over the block, in thread order; every thread must
// call.  ``warp_sums`` holds BL_WARPS ints.
__device__ __forceinline__ int block_scan(int v, int* warp_sums) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        int u = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += u;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int w = lane < BL_WARPS ? warp_sums[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            int u = __shfl_up_sync(FULL, w, d);
            if (lane >= d) w += u;
        }
        if (lane < BL_WARPS) warp_sums[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += warp_sums[warp - 1];
    __syncthreads();
    return v;
}

// In-order inclusive scan of buf[0, len) in place, each thread a
// contiguous run of it.
__device__ __forceinline__ void scan_runs(int* buf, int len, int* warp_sums) {
    const int run = (len + BL_THREADS - 1) / BL_THREADS;
    const int lo = min((int)threadIdx.x * run, len), hi = min(lo + run, len);
    int total = 0;
    for (int k = lo; k < hi; ++k) total += buf[k];
    int acc = block_scan(total, warp_sums) - total;
    for (int k = lo; k < hi; ++k) {
        acc += buf[k];
        buf[k] = acc;
    }
    __syncthreads();
}

__global__ void __launch_bounds__(BL_THREADS)
blanker_kernel(BlankerArgs s) {
    extern __shared__ int smem[];
    __shared__ int warp_sums[BL_WARPS];
    __shared__ long long warp_ll[BL_WARPS];
    const int row = blockIdx.y;
    const short* re = s.re + row * s.in_cstride;
    const short* im = s.im + row * s.in_cstride;
    const float* mtail = s.mag_tail + (long long)row * s.M;
    const int H = s.W - 1;
    const int t0 = blockIdx.x * s.tile;
    const int t1 = min(t0 + s.tile, s.n);
    const int a = max(t0 - H, 0);          // first position computed here
    const int L = t1 - a;
    const int lo = t0 - H;                 // first trigger position needed
    const int Lt = t1 - lo;
    int* A = smem;                         // d, then the trigger counts
    int* B = smem + s.tile + H;            // magnitudes, then triggers

    for (int k = threadIdx.x; k < L; k += BL_THREADS) {
        const int q = a + k;
        const int m = mag_at(s, re, im, mtail, q);
        A[k] = m - mag_at(s, re, im, mtail, q - s.M - 1);
        B[k] = m;
    }
    // S[a-1]: the M + 1 magnitudes before a
    long long base = 0;
    for (int q = a - s.M - 1 + (int)threadIdx.x; q < a; q += BL_THREADS)
        base += mag_at(s, re, im, mtail, q);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        base += __shfl_down_sync(FULL, base, d);
    if ((threadIdx.x & 31) == 0) warp_ll[threadIdx.x >> 5] = base;
    __syncthreads();
    base = 0;
    for (int w = 0; w < BL_WARPS; ++w) base += warp_ll[w];

    // S over [a, t1), in order (the running part fits an int: |d| <= 2^15
    // and L <= 8,191), and the triggers
    {
        const int run = (L + BL_THREADS - 1) / BL_THREADS;
        const int k0 = min((int)threadIdx.x * run, L), k1 = min(k0 + run, L);
        int total = 0;
        for (int k = k0; k < k1; ++k) total += A[k];
        int acc = block_scan(total, warp_sums) - total;
        for (int k = k0; k < k1; ++k) {
            acc += A[k];
            const double sum = (double)(base + acc);
            B[k] = (double)B[k] * s.ratio > sum ? 1 : 0;
        }
    }
    __syncthreads();

    // the triggers over [lo, t1) (the tail's below 0), counted in order
    const float* ttail = s.trig_tail + (long long)row * H;
    for (int u = threadIdx.x; u < Lt; u += BL_THREADS) {
        const int p = lo + u;
        A[u] = p < a ? (ttail[H + p] > 0.5f ? 1 : 0) : B[p - a];
    }
    __syncthreads();
    scan_runs(A, Lt, warp_sums);

    const float2* stail = s.sig_tail + (long long)row * s.D1;
    short* ore = s.out_re + (long long)row * s.n;
    short* oim = s.out_im + (long long)row * s.n;
    for (int i = t0 + threadIdx.x; i < t1; i += BL_THREADS) {
        const int u = i - lo;
        const int before = u - s.W >= 0 ? A[u - s.W] : 0;
        short vr = 0, vi = 0;
        if (A[u] == before) {
            const int src = i - s.D1;
            if (src >= 0) {
                vr = re[src];
                vi = im[src];
            } else {
                const float2 z = stail[s.D1 + src];
                vr = (short)__float2int_rn(z.x);
                vi = (short)__float2int_rn(z.y);
            }
        }
        ore[i] = vr;
        oim[i] = vi;
    }

    if (t1 != s.n) return;
    // the tile holding the row's last sample: the new tails
    float* nt = s.new_trig + (long long)row * H;
    for (int k = threadIdx.x; k < H; k += BL_THREADS) {
        const int u = s.n - H + k - lo;
        nt[k] = (float)(A[u] - (u > 0 ? A[u - 1] : 0));
    }
    float* nm = s.new_mag + (long long)row * s.M;
    for (int k = threadIdx.x; k < s.M; k += BL_THREADS)
        nm[k] = (float)mag_at(s, re, im, mtail, s.n - s.M + k);
    float2* ns = s.new_sig + (long long)row * s.D1;
    for (int k = threadIdx.x; k < s.D1; k += BL_THREADS) {
        const int p = s.n - s.D1 + k;
        ns[k] = p >= 0 ? make_float2((float)re[p], (float)im[p])
                       : stail[s.D1 + p];
    }
}

}  // namespace cutesdr

using namespace cutesdr;

CUTESDR_API int cutesdr_blanker(const short* re, const short* im,
                                long long in_cstride, const float* mag_tail,
                                const float* trig_tail,
                                const float2* sig_tail, int n, int rows,
                                int M, int W, int D1, double ratio, int tile,
                                short* out_re, short* out_im, float* new_mag,
                                float* new_trig, float2* new_sig,
                                void* stream) {
    if (n <= 0 || rows <= 0 || M < 0 || W < 1 || D1 < 1 || tile <= 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * sizeof(int) * (size_t)(tile + W - 1);
    // above the default 48 KB, grant the kernel the size once
    static size_t granted = 48 * 1024;
    if (smem > granted) {
        cudaError_t err = cudaFuncSetAttribute(
            blanker_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        granted = smem;
    }
    BlankerArgs s{re, im, in_cstride, mag_tail, trig_tail, sig_tail, out_re,
                  out_im, new_mag, new_trig, new_sig, n, M, W, D1, tile,
                  ratio};
    dim3 grid((n + tile - 1) / tile, rows);
    blanker_kernel<<<grid, BL_THREADS, smem, (cudaStream_t)stream>>>(s);
    return (int)cudaGetLastError();
}
