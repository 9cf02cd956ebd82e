// Fused DC cal + NCO mix + polyphase decimation by D, for C channels.
//
// Replaces cutesdr_tpu/kernels/mixdec.py:MixDecimate.process_planes
// (_kernel_bs / _kernel_planes, shared body _compute), which the JAX
// channel bank runs under vmap.
//
// y[c, n] = sum_j h[j] * m[c, D*n + j] over z_c = [raw tail_c (L-1-d;
// rows tail_cstride apart) | block_c], with m[c, i] = (z_c[i] - dc_c) * e^{j*phase_c(i)}, phase from
// the exact uint32 DDS accumulator acc = base_c + (i - tail_len)*inc_c
// (mod 2^32; the tail samples take back-dated phases through unsigned
// wraparound) and h the composed taps, flipped to correlation order.
// Each channel has its own tail, phase, increment and DC cal; the block is
// shared (channel stride 0, a ChannelBank) or one row per channel (a
// StackedReceiver).  One stream is C = 1.
//
// Bound on the H100: bytes (the flagship reads 67 MB of float32 planes per
// step, 20 us at 3.35 TB/s; 34 MB as int16 planes, 10 us), with the FIR's
// float32 FMAs close behind
// (~0.57 G at D=32, L=1,063: 17 us at 67 TFLOP/s) and one accurate sincosf
// per input sample beside them.  So the loads must overlap the arithmetic,
// and the sum must run near the FMA rate, which a per-tap shared-memory
// load cannot feed.  Design, as a polyphase sum y[n] = sum_p sum_k g_p[k]
// u_p[n+k] with g_p[k] = h[kD+p] and u_p[m] = m[mD+p]:
// * one block per tile of outputs of one channel (channel in blockIdx.y)
//   brings the tile's window through shared memory in chunks of P =
//   min(D, 32) phases: asynchronous copies (cp.async: all of a thread's
//   copies in flight at once, no registers held) of the raw samples and
//   of the chunk's taps (zero-padded to K = ceil(L/D) per phase), then
//   each thread mixes the samples it copied in place (sincosf, no fast
//   math: the DDS phase must match the plain version);
// * lane p of a group of P lanes owns phase p of the chunk; it reads u_p
//   and g_p at consecutive addresses across the lanes (no bank conflicts;
//   for D < 32 the window rows of R outputs are padded by P samples so
//   that the 32/P groups of a warp fall on other banks);
// * each thread keeps R = 8 consecutive outputs in registers and slides
//   over k: one window sample and one tap per k feed 2R FMAs;
// * the P lanes' partial sums meet in a reduce-scatter of warp shuffles
//   (2R values: log2(P) levels, each sending half of what is left), and
//   the lanes that end with the sums write them, coalesced; with several
//   chunks (D > 32) a warp owns one group of the tile and keeps its sums
//   in registers from chunk to chunk;
// * interleaved input (im = re + 1 float, both strides 2: the complex iq
//   views the receiver passes) is copied as one float2 per sample;
// * int16 planes (the radio's wire values, ``cutesdr_mixdec_i16``) are
//   staged as int16: a thread's two block samples as one 4-byte copy a
//   plane into the pair's slot, widened to float in the mix pass beside
//   the sincosf and the DC cal.  The cast is exact, so the mixed window,
//   and every output, is bitwise the float path's on the cast planes; the
//   block is read at half the bytes.  A pair that reaches into the tail or
//   past the window, or whose samples are not 4-byte aligned, takes one
//   sample at a time (the tail's float2 by cp.async, the int16 by plain
//   loads);
// * the tile and the block size come from the wrapper's per-call plan
//   (kernels/mixdec.py:launch_plan), which spreads small calls over many
//   SMs and keeps the window overlap of the large ones near 13%.  This
//   file sizes shared memory from the same tile, as launch_plan's
//   ``smem_bytes`` does.
// Any D that is a power of two and any output offset d work: the offset is
// folded into the tail length.
#include "common.cuh"

namespace cutesdr {

constexpr int MIX_R = 8;            // outputs per thread
constexpr int MIX_MAX_THREADS = 512;

// input layouts: float planes of any stride, interleaved float2 (the
// complex iq views), int16 planes
constexpr int IN_STRIDED = 0, IN_IL = 1, IN_I16 = 2;

// asynchronous global -> shared copies of 16, 8 and 4 bytes (cp.async)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Reduce-scatter of CNT values across the lanes xor OFF, OFF/2, .., 1: at
// each level a lane keeps one half of what it holds (the upper half where
// its OFF bit is set) and adds the partner's copy of that half.  Once one
// value is left the remaining levels sum it whole; the lanes with one of
// those bits set hold a copy and do not write.  ``base`` gathers the index
// of the first value the lane ends with.
template <int OFF, int CNT>
__device__ __forceinline__ void reduce_scatter(float* a, int lane, int& base,
                                               bool& writer) {
    if constexpr (CNT > 1) {
        constexpr int H = CNT / 2;
        const bool up = lane & OFF;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const float send = up ? a[i] : a[i + H];
            const float keep = up ? a[i + H] : a[i];
            a[i] = keep + __shfl_xor_sync(FULL, send, OFF);
        }
        if (up) base += H;
        if constexpr (OFF > 1) reduce_scatter<OFF / 2, H>(a, lane, base, writer);
    } else {
        a[0] += __shfl_xor_sync(FULL, a[0], OFF);
        if (lane & OFF) writer = false;
        if constexpr (OFF > 1) reduce_scatter<OFF / 2, 1>(a, lane, base, writer);
    }
}

// One step k of the sliding sum: tap g_p[k] times the R window samples
// u_p[n0+k .. n0+k+R-1], which sit in w at slots (i + kk) % R.
template <int KK>
__device__ __forceinline__ void mac(float (&acc)[2 * MIX_R],
                                   const float2 (&w)[MIX_R], float h) {
#pragma unroll
    for (int i = 0; i < MIX_R; ++i) {
        const float2 v = w[(i + KK) % MIX_R];
        acc[2 * i] = fmaf(h, v.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(h, v.y, acc[2 * i + 1]);
    }
}

// Steps k .. k+cnt-1 (k a multiple of R, cnt <= R), taps g_p[k + kk] at
// gk[kk * P]: after step k+kk the slot kk takes u_p[n0 + k + kk + R],
// which lies in the window row after the one of u_p[n0 + k], at
// un[kk * P].
__device__ __forceinline__ void mac_block(float (&acc)[2 * MIX_R],
                                          float2 (&w)[MIX_R],
                                          const float2* un, const float* gk,
                                          int P, int cnt) {
#define CUTESDR_MAC_STEP(KK)                                         \
    if (KK < cnt) {                                                  \
        mac<KK>(acc, w, gk[KK * P]);                                 \
        w[KK] = un[KK * P];                                          \
    }
    CUTESDR_MAC_STEP(0) CUTESDR_MAC_STEP(1) CUTESDR_MAC_STEP(2)
    CUTESDR_MAC_STEP(3) CUTESDR_MAC_STEP(4) CUTESDR_MAC_STEP(5)
    CUTESDR_MAC_STEP(6) CUTESDR_MAC_STEP(7)
#undef CUTESDR_MAC_STEP
}
static_assert(MIX_R == 8, "mac_block unrolls R = 8 steps");

// The sum of one group of R outputs (gi) over the window's P phases
// (lane pl owns phase pl): u_p[gi*R + m] sits at win + (m / R) * row +
// (m % R) * P + pl (a row of R outputs' samples is padded by PAD), the
// taps g_p[k] at gs[k*P + pl].
__device__ __forceinline__ void group_sum(float (&acc)[2 * MIX_R],
                                          const float2* win,
                                          const float* gs, int gi, int pl,
                                          int P, int row, int K) {
    const float2* u0 = win + (size_t)gi * row + pl;
    const float* gp = gs + pl;
    float2 w[MIX_R];
#pragma unroll
    for (int i = 0; i < MIX_R; ++i) w[i] = u0[i * P];
    int k = 0;
    for (; k + MIX_R <= K; k += MIX_R)
        mac_block(acc, w, u0 + (k / MIX_R + 1) * row, gp + k * P, P, MIX_R);
    mac_block(acc, w, u0 + (k / MIX_R + 1) * row, gp + k * P, P, K - k);
}

// P lanes' partial sums of group gi meet in the reduce-scatter; the lanes
// that end with a sum write it, where the output lies inside the tile.
template <int P>
__device__ __forceinline__ void group_write(float (&acc)[2 * MIX_R],
                                            float2* y, int gi, int pl,
                                            int outs) {
    int first = 0;
    bool writer = true;
    if constexpr (P > 1)
        reduce_scatter<P / 2, 2 * MIX_R>(acc, pl, first, writer);
    constexpr int CNT = 2 * MIX_R / P > 0 ? 2 * MIX_R / P : 1;
    if (writer) {
        float* yf = reinterpret_cast<float*>(y + gi * MIX_R);
#pragma unroll
        for (int t = 0; t < CNT; ++t) {
            const int j = first + t;             // float index in the group
            if (gi * MIX_R + (j >> 1) < outs) yf[j] = acc[t];
        }
    }
}

// P: lanes per output group (min(D, 32)); IN: the input layout (IN_*),
// T its element type (float, or short for IN_I16).  incs: one uint32
// increment per channel (held as int64), or null for one stream, whose
// increment is inc0.  With one chunk of phases a warp walks the tile's
// groups in turn; with several (D > 32) each warp owns one group
// (tile_out = R * warps) and keeps its sums in registers from chunk to
// chunk.
template <int P, int IN, typename T>
__global__ void __launch_bounds__(MIX_MAX_THREADS, 2)
mixdec_kernel(const T* __restrict__ re, const T* __restrict__ im,
              long long re_cstride, long long im_cstride,
              long long re_stride, long long im_stride,
              const float2* __restrict__ tail, int tail_len,
              long long tail_cstride,
              const float* __restrict__ taps, int ntaps,
              const float2* __restrict__ dc,
              const long long* __restrict__ phase,
              const long long* __restrict__ incs, unsigned int inc0,
              float scale, int dec, int n_out, int tile_out, int K,
              float2* __restrict__ y) {
    constexpr int S = 32 / P;                  // output groups per warp
    constexpr int PAD = P < 32 ? P : 0;        // window row padding
    constexpr int LG_P = P == 1 ? 0 : P == 2 ? 1 : P == 4 ? 2 : P == 8 ? 3
                         : P == 16 ? 4 : 5;
    constexpr int LG_R = 3;                    // log2(MIX_R)
    extern __shared__ float2 smem[];
    const int ch = blockIdx.y;
    re += ch * re_cstride;
    im += ch * im_cstride;
    tail += ch * tail_cstride;
    const int o0 = blockIdx.x * tile_out;
    y += (long long)ch * n_out + o0;
    const int outs = min(tile_out, n_out - o0);
    const long long z0 = (long long)o0 * dec;       // window start in z
    const int wlen = (outs - 1) * dec + ntaps;      // samples the sum reads
    const int nrow = tile_out + K;                  // window rows (outputs)
    const int nwin = nrow * P;                      // a chunk's samples
    const int row = MIX_R * P + PAD;                // R rows, padded
    float2* win = smem;
    float* gs = reinterpret_cast<float*>(smem + (nrow / MIX_R + 1) * row);
    const unsigned int base = (unsigned int)phase[ch];
    const unsigned int inc = incs ? (unsigned int)incs[ch] : inc0;
    const float2 d = dc[ch];
    // int16 planes: a pair's samples (i even, so k = zi - tail_len has the
    // parity of z0 - tail_len throughout) are one aligned 4-byte word a
    // plane where the planes are dense and so aligned
    const bool words =
        IN == IN_I16 && re_stride == 1 && im_stride == 1 &&
        (((reinterpret_cast<uintptr_t>(re) >> 1) + (z0 - tail_len)) & 1) ==
            0 &&
        (((reinterpret_cast<uintptr_t>(im) >> 1) + (z0 - tail_len)) & 1) == 0;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int sub = lane / P, pl = lane % P;
    const int groups = (outs + MIX_R - 1) / MIX_R;
    const int nchunk = dec / P;
    float acc[2 * MIX_R];
#pragma unroll
    for (int i = 0; i < 2 * MIX_R; ++i) acc[i] = 0.f;

    for (int c = 0; c < nchunk; ++c) {
        if (c) __syncthreads();          // the last chunk's sums are done
        // element e: row e / P, phase c*P + e % P of the window, at
        // win[e + (e / (R*P)) * PAD]
        const int p0 = c * P;
        for (int i = threadIdx.x; i < K * P; i += blockDim.x) {
            const int j = (i >> LG_P) * dec + p0 + (i & (P - 1));
            if (j < ntaps)
                cp_async4(gs + i, taps + j);
            else
                gs[i] = 0.f;
        }
        // two adjacent samples a thread at a time: elements e, e+1 (e
        // even) are window samples i, i+1 and adjacent in shared memory
        for (int e = 2 * threadIdx.x; e < nwin; e += 2 * blockDim.x) {
            const int i = (e >> LG_P) * dec + p0 + (e & (P - 1));
            float2* dst = win + e + (e >> (LG_P + LG_R)) * PAD;
            const long long zi = z0 + i;
            const bool two = e + 1 < nwin;
            if constexpr (IN == IN_I16) {
                if (words && zi >= tail_len && two && i + 1 < wlen) {
                    // re[k..k+1] and im[k..k+1] into the pair's slot
                    const long long k = zi - tail_len;
                    cp_async4(&dst->x, re + k);
                    cp_async4(&dst->y, im + k);
                    continue;
                }
            }
            const float2* src = zi < tail_len
                ? tail + zi
                : IN == IN_IL
                    ? reinterpret_cast<const float2*>(re) + (zi - tail_len)
                    : nullptr;
            if (i + 1 < wlen && two && src &&
                (zi + 1 < tail_len) == (zi < tail_len) &&
                ((reinterpret_cast<uintptr_t>(src) |
                  reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
                cp_async16(dst, src);
                continue;
            }
            for (int h = 0; h < 2 && (h == 0 || two); ++h) {
                if (i + h >= wlen) {
                    dst[h] = make_float2(0.f, 0.f);
                } else if (zi + h < tail_len) {
                    cp_async8(dst + h, tail + zi + h);
                } else if (IN == IN_IL) {
                    cp_async8(dst + h, reinterpret_cast<const float2*>(re)
                                           + (zi + h - tail_len));
                } else if (IN == IN_I16) {
                    const long long k = zi + h - tail_len;
                    dst[h] = make_float2((float)re[k * re_stride],
                                         (float)im[k * im_stride]);
                } else {
                    const long long k = zi + h - tail_len;
                    cp_async4(&dst[h].x, reinterpret_cast<const float*>(re)
                                             + k * re_stride);
                    cp_async4(&dst[h].y, reinterpret_cast<const float*>(im)
                                             + k * im_stride);
                }
            }
        }
        cp_async_wait_all();
        // the phase of window sample i: ph0 + i * inc (mod 2^32)
        const unsigned int ph0 = base + (unsigned int)(z0 - tail_len) * inc;
        for (int e = 2 * threadIdx.x; e < nwin; e += 2 * blockDim.x) {
            const int i = (e >> LG_P) * dec + p0 + (e & (P - 1));
            float2* dst = win + e + (e >> (LG_P + LG_R)) * PAD;
            float2 wire[2];
            bool staged16 = false;
            if constexpr (IN == IN_I16) {
                staged16 = words && z0 + i >= tail_len && e + 1 < nwin &&
                           i + 1 < wlen;
                if (staged16) {
                    // the low halves are sample i, the high ones i + 1
                    const int2 w = *reinterpret_cast<const int2*>(dst);
                    wire[0] = make_float2((float)(short)w.x, (float)(short)w.y);
                    wire[1] = make_float2((float)(short)(w.x >> 16),
                                          (float)(short)(w.y >> 16));
                }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (i + h >= wlen || e + h >= nwin) break;
                float sn, cs;
                sincosf((float)(ph0 + (unsigned int)(i + h) * inc) * scale,
                        &sn, &cs);
                const float2 x = staged16 ? wire[h] : dst[h];
                const float xr = x.x - d.x, xi = x.y - d.y;
                // the roundings written out, so that the compiler fuses
                // them alike in every layout's kernel (each component's
                // first product fused, as the float path always compiled)
                dst[h] = make_float2(__fmaf_rn(xr, cs, -__fmul_rn(xi, sn)),
                                     __fmaf_rn(xr, sn, __fmul_rn(xi, cs)));
            }
        }
        __syncthreads();

        if (nchunk == 1) {
            for (int g0 = warp * S; g0 < groups;
                 g0 += (blockDim.x >> 5) * S) {
                const int gi = g0 + sub;   // < tile_out / R: in the window
#pragma unroll
                for (int i = 0; i < 2 * MIX_R; ++i) acc[i] = 0.f;
                group_sum(acc, win, gs, gi, pl, P, row, K);
                group_write<P>(acc, y, gi, pl, outs);
            }
        } else {
            group_sum(acc, win, gs, warp, pl, P, row, K);
        }
    }
    if (nchunk > 1) group_write<P>(acc, y, warp, pl, outs);
}

template <int P, int IN, typename T>
int launch(dim3 grid, int threads, size_t smem, cudaStream_t st, const T* re,
           const T* im, long long re_cstride, long long im_cstride,
           long long re_stride, long long im_stride, const float2* tail,
           int tail_len, long long tail_cstride, const float* taps,
           int ntaps, const float2* dc, const long long* phase,
           const long long* incs, unsigned int inc0, float scale, int dec,
           int n_out, int tile_out, int K, float2* y) {
    auto kern = mixdec_kernel<P, IN, T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, threads, smem, st>>>(
        re, im, re_cstride, im_cstride, re_stride, im_stride, tail, tail_len,
        tail_cstride, taps, ntaps, dc, phase, incs, inc0, scale, dec, n_out,
        tile_out, K, y);
    return (int)cudaGetLastError();
}

// One call of either entry: checks the plan (tile_out and threads come
// from the wrapper's: tile_out a multiple of R * threads/32 * 32/P, and
// for D > 32 exactly R * threads/32, a group per warp; dec a power of
// two), sizes shared memory and launches the layout's kernel.
template <int IN, typename T>
int mixdec_call(const T* re, const T* im, long long re_cstride,
                long long im_cstride, long long re_stride,
                long long im_stride, const void* tail, int tail_len,
                long long tail_cstride, const float* taps, int ntaps,
                const void* dc, const long long* phase,
                const long long* incs, unsigned int inc0, float scale,
                int dec, int n_out, int n_ch, int tile_out, int threads,
                void* y, void* stream) {
    if (n_out <= 0 || n_ch <= 0) return 0;
    const int P = dec < 32 ? dec : 32;
    const int unit = MIX_R * (threads / 32) * (32 / P);
    if (dec <= 0 || (dec & (dec - 1)) || threads % 32 ||
        threads > MIX_MAX_THREADS || tile_out <= 0 || tile_out % unit ||
        (dec > 32 && tile_out != unit))
        return (int)cudaErrorInvalidValue;
    const int K = (ntaps + dec - 1) / dec;
    const int row = MIX_R * P + (P < 32 ? P : 0);
    const size_t smem = ((size_t)((tile_out + K) / MIX_R + 1) * row
                         + (K * P + 1) / 2) * sizeof(float2);
    const dim3 grid((n_out + tile_out - 1) / tile_out, n_ch);
    cudaStream_t st = (cudaStream_t)stream;
#define CUTESDR_MIX_ARGS                                                    \
    grid, threads, smem, st, re, im, re_cstride, im_cstride, re_stride,     \
        im_stride, (const float2*)tail, tail_len, tail_cstride, taps, ntaps,\
        (const float2*)dc, phase, incs, inc0, scale, dec, n_out, tile_out,  \
        K, (float2*)y
    switch (P) {
        case 1: return launch<1, IN>(CUTESDR_MIX_ARGS);
        case 2: return launch<2, IN>(CUTESDR_MIX_ARGS);
        case 4: return launch<4, IN>(CUTESDR_MIX_ARGS);
        case 8: return launch<8, IN>(CUTESDR_MIX_ARGS);
        case 16: return launch<16, IN>(CUTESDR_MIX_ARGS);
        default: return launch<32, IN>(CUTESDR_MIX_ARGS);
    }
#undef CUTESDR_MIX_ARGS
}

}  // namespace cutesdr

using namespace cutesdr;

// float32 planes (the complex iq views, or any strides)
CUTESDR_API int cutesdr_mixdec(const float* re, const float* im,
                               long long re_cstride, long long im_cstride,
                               long long re_stride, long long im_stride,
                               const void* tail, int tail_len,
                               long long tail_cstride, const float* taps,
                               int ntaps, const void* dc,
                               const long long* phase, const long long* incs,
                               unsigned int inc0, float scale, int dec,
                               int n_out, int n_ch, int tile_out, int threads,
                               void* y, void* stream) {
    // one float2 copy per sample where im is re + 1 float, both stride 2
    const bool il = im == re + 1 && re_stride == 2 && im_stride == 2 &&
                    re_cstride == im_cstride && re_cstride % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(re) % 8 == 0;
    return (il ? mixdec_call<IN_IL, float> : mixdec_call<IN_STRIDED, float>)(
        re, im, re_cstride, im_cstride, re_stride, im_stride, tail, tail_len,
        tail_cstride, taps, ntaps, dc, phase, incs, inc0, scale, dec, n_out,
        n_ch, tile_out, threads, y, stream);
}

// int16 planes (the radio's wire values), the same arguments
CUTESDR_API int cutesdr_mixdec_i16(const short* re, const short* im,
                                   long long re_cstride, long long im_cstride,
                                   long long re_stride, long long im_stride,
                                   const void* tail, int tail_len,
                                   long long tail_cstride, const float* taps,
                                   int ntaps, const void* dc,
                                   const long long* phase,
                                   const long long* incs, unsigned int inc0,
                                   float scale, int dec, int n_out, int n_ch,
                                   int tile_out, int threads, void* y,
                                   void* stream) {
    return mixdec_call<IN_I16, short>(
        re, im, re_cstride, im_cstride, re_stride, im_stride, tail, tail_len,
        tail_cstride, taps, ntaps, dc, phase, incs, inc0, scale, dec, n_out,
        n_ch, tile_out, threads, y, stream);
}
