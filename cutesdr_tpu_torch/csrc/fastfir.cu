// Overlap-save complex bandpass: per frame FFT -> *H -> unscaled IFFT, for
// one stream or a bank of C channels with one H each.
//
// Replaces cutesdr_tpu/kernels/fastfir4.py:FastFirFourStep.filter_frames
// (K2: _kernel, per-frame math _frame) and, with the channel grid,
// FastFirFourStep.filter_frames_batch / batch_call (K6: _kernel_batch).
//
// Frame f of z_c = [tail_c (ntaps-1) | block_c] is z_c[f*V : f*V + nfft]
// with V = nfft - ntaps + 1; it contributes its last V samples of
// IFFT_unscaled(FFT(frame) * H_c).  H is in natural order and already
// holds 1/nfft (design/fastfir_design.py), so the inverse is not scaled
// again.  The kernel reads the frame from the tail and the block through
// two pointers, so the caller never concatenates them.  The grid is
// (frame groups, channels); one stream is one channel.
//
// Bound on the H100: bytes, far below anything a frame's dependent chain
// allows (2 MB in and out at the flagship's 256 frames: 1.3 us); the FFT
// work (~0.06 GFLOP) is small too.  A frame's time is latency: the chain
// of passes and the barriers between them.  Design: a register-resident
// mixed-radix Stockham FFT.  Each thread of a frame holds E = 16 complex
// points (nfft/16 threads: 128 at 2048) and does a radix-16 butterfly in
// registers per pass (the last pass radix nfft/16^m with several
// butterflies a thread), so 2048 = 16*16*8 takes three passes and the
// whole FFT -> *H -> IFFT five barriers (radix-2 took 22).  The exchange
// between passes goes through shared memory padded by one point in 16
// (no bank conflicts on the stride-16 stores of the first pass), in two
// ping-pong buffers.  The first pass reads the frame from global memory,
// *H is applied in registers at the forward transform's last pass, and
// the inverse's last pass writes the V valid outputs straight to global
// memory.  Twiddles between passes come from a quarter table of
// exp(-2 pi i k / nfft), k < nfft/4, computed in float64 and rounded once
// to float32 (kernels/fastfir.py:_twiddles), staged in shared memory per
// block; the other quadrants are the exact rotations by -i, so every
// twiddle is still rounded once.  The radix-16/8/4/2 butterflies use the
// 16th roots of unity as float constants.  FP32 CUDA-core arithmetic
// throughout: TF32 would cost the filter its floor.  A block holds F
// frames of one channel (F from the wrapper: several when frames are
// many and small, one when they are few).
#include "common.cuh"

namespace cutesdr {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// The FFT plan of nfft = N points: E points a thread, passes of radix 16
// and a last one of radix N / 16^(passes-1) (kernels/fastfir.py:fft_plan)
__host__ __device__ constexpr int ff_ept(int n) { return n < 16 ? n : 16; }
__host__ __device__ constexpr int ff_lg(int n) { return n > 1 ? 1 + ff_lg(n / 2) : 0; }
__host__ __device__ constexpr int ff_passes(int n) { return (ff_lg(n) + 3) / 4; }
__host__ __device__ constexpr int ff_radix(int n, int pass) {
    return pass < ff_passes(n) - 1 ? 16 : n >> (4 * (ff_passes(n) - 1));
}
__host__ __device__ constexpr int ff_ns(int pass) { return 1 << (4 * pass); }
// i's low ``bits`` (<= 4) reversed, in closed form so that an unrolled
// index folds to a constant (a register, not local memory)
__host__ __device__ constexpr int ff_brev(int i, int bits) {
    return (((i & 1) << 3) | ((i & 2) << 1) | ((i & 4) >> 1) |
            ((i & 8) >> 3)) >> (4 - bits);
}
__host__ __device__ constexpr int ff_pad(int i) { return i + (i >> 4); }

// d * W16^m, W16 = exp(-2 pi i / 16) (its conjugate for the inverse)
template <bool INV>
__device__ __forceinline__ float2 rot16(float2 d, int m) {
    if (m == 0) return d;
    if (m == 4) return INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
    constexpr float C1 = 0.92387953251128674f, S1 = 0.38268343236508978f;
    constexpr float R2 = 0.70710678118654752f;
    float c, s;
    switch (m) {
        case 1: c = C1; s = S1; break;
        case 2: c = R2; s = R2; break;
        case 3: c = S1; s = C1; break;
        case 5: c = -S1; s = C1; break;
        case 6: c = -R2; s = R2; break;
        default: c = -C1; s = S1; break;   // 7
    }
    return cmul(d, make_float2(c, INV ? s : -s));
}

// The radix-2 decimation-in-frequency stages of span LEN, LEN/2, .., 2 of
// an R-point DFT in registers (a template per stage: every index is a
// constant, so v stays in registers).
template <int R, int LEN, bool INV>
__device__ __forceinline__ void dif_stages(float2* v) {
    constexpr int H = LEN / 2;
#pragma unroll
    for (int s = 0; s < R; s += LEN) {
#pragma unroll
        for (int k = 0; k < H; ++k) {
            const float2 a = v[s + k], b = v[s + k + H];
            v[s + k] = cadd(a, b);
            v[s + k + H] = rot16<INV>(csub(a, b), k * (16 / LEN));
        }
    }
    if constexpr (H >= 2) dif_stages<R, H, INV>(v);
}

// In-register DFT of R points (natural order in and out): radix-2
// decimation in frequency, then the bit-reversal as register renaming.
template <int R, bool INV>
__device__ __forceinline__ void dft(float2* v) {
    if constexpr (R >= 2) dif_stages<R, R, INV>(v);
    constexpr int BITS = ff_lg(R);
    float2 t[R];
#pragma unroll
    for (int i = 0; i < R; ++i) t[i] = v[ff_brev(i, BITS)];
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = t[i];
}

// exp(-+2 pi i m / N) from the quarter table tw[r] = exp(-2 pi i r / N),
// r < N/4: quadrant q of m rotates by (-i)^q, exactly
template <int N, bool INV>
__device__ __forceinline__ float2 twiddle(const float2* tw, int m) {
    constexpr int Q = N / 4;
    const float2 w = tw[m % Q];
    float2 r;
    switch (m / Q) {
        case 0: r = w; break;
        case 1: r = make_float2(w.y, -w.x); break;
        case 2: r = make_float2(-w.x, -w.y); break;
        default: r = make_float2(-w.y, w.x); break;
    }
    if (INV) r.y = -r.y;
    return r;
}

// One Stockham pass of radix R over N points (NS = the product of the
// earlier radices): butterfly j reads points j + k*N/R, twiddles them by
// W_N^((j mod NS) * k * N/(NS*R)), transforms them and writes them to
// (j / NS) * NS*R + j mod NS + k*NS.  A thread does E/R butterflies:
// j = t, t + N/E, ...
template <int N, int R, int NS, bool INV, class Load, class Store>
__device__ __forceinline__ void pass(int t, const float2* tw, Load load,
                                     Store store) {
    constexpr int E = ff_ept(N), TPF = N / E, B = E / R;
    float2 v[E];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
        for (int k = 0; k < R; ++k)
            v[b * R + k] = load(t + b * TPF + k * (N / R));
#pragma unroll
    for (int b = 0; b < B; ++b) {
        const int j = t + b * TPF;
        const int jm = j % NS;
        if constexpr (NS > 1) {
#pragma unroll
            for (int k = 1; k < R; ++k)
                v[b * R + k] = cmul(v[b * R + k],
                                    twiddle<N, INV>(tw, jm * k * (N / (NS * R))));
        }
        dft<R, INV>(v + b * R);
        const int base = (j / NS) * NS * R + jm;
#pragma unroll
        for (int k = 0; k < R; ++k) store(base + k * NS, v[b * R + k]);
    }
}

struct SmemIO {
    float2* buf;
    __device__ float2 operator()(int i) const { return buf[ff_pad(i)]; }
    __device__ void operator()(int i, float2 x) const { buf[ff_pad(i)] = x; }
};

struct SmemTimesH {    // the forward transform's output, times H
    float2* buf;
    const float2* __restrict__ h;
    __device__ void operator()(int i, float2 x) const {
        buf[ff_pad(i)] = cmul(x, __ldg(h + i));
    }
};

struct FrameIn {       // point i of the frame: z[pos0 + i] of [tail | block]
    const float2* __restrict__ tail;
    const float2* __restrict__ block;
    long long pos0;
    int tlen;
    bool valid;
    __device__ float2 operator()(int i) const {
        if (!valid) return make_float2(0.f, 0.f);
        const long long pos = pos0 + i;
        return pos < tlen ? tail[pos] : block[pos - tlen];
    }
};

struct FrameOut {      // the frame's last V points to y[pos0 + i - tlen]
    float2* __restrict__ y;
    long long pos0;
    int tlen;
    bool valid;
    __device__ void operator()(int i, float2 x) const {
        if (valid && i >= tlen) y[pos0 + i - tlen] = x;
    }
};

// All passes of one transform: the first reads ``first``, the last writes
// ``last``; pass p in between writes bufs[p % 2] and the next reads it.
template <int N, bool INV, class Load, class Store>
__device__ __forceinline__ void transform(int t, const float2* tw, Load first,
                                          Store last, float2* b0,
                                          float2* b1) {
    constexpr int NP = ff_passes(N);
    if constexpr (NP == 1) {
        pass<N, ff_radix(N, 0), 1, INV>(t, tw, first, last);
    } else {
        pass<N, ff_radix(N, 0), 1, INV>(t, tw, first, SmemIO{b0});
        __syncthreads();
        if constexpr (NP == 2) {
            pass<N, ff_radix(N, 1), ff_ns(1), INV>(t, tw, SmemIO{b0}, last);
        } else {
            pass<N, ff_radix(N, 1), ff_ns(1), INV>(t, tw, SmemIO{b0},
                                                   SmemIO{b1});
            __syncthreads();
            if constexpr (NP == 3) {
                pass<N, ff_radix(N, 2), ff_ns(2), INV>(t, tw, SmemIO{b1},
                                                       last);
            } else {
                static_assert(NP == 4, "nfft up to 16^4");
                pass<N, ff_radix(N, 2), ff_ns(2), INV>(t, tw, SmemIO{b1},
                                                       SmemIO{b0});
                __syncthreads();
                pass<N, ff_radix(N, 3), ff_ns(3), INV>(t, tw, SmemIO{b0},
                                                       last);
            }
        }
    }
}

template <int N>
__host__ __device__ constexpr int ff_buf() {   // padded points of a buffer
    return ff_pad(N - 1) + 1;
}

constexpr int FF_MAX_THREADS = 512;

template <int N>
__global__ void __launch_bounds__(FF_MAX_THREADS)
fastfir_kernel(const float2* __restrict__ tail,
               const float2* __restrict__ block,
               const float2* __restrict__ h, const float2* __restrict__ tw_g,
               float2* __restrict__ out, int ntaps, int n_frames, int fpb,
               long long tail_cstride, long long block_cstride,
               long long h_cstride, long long y_cstride) {
    constexpr int TPF = N / ff_ept(N), BUF = ff_buf<N>();
    extern __shared__ float2 smem[];
    float2* tw = smem;                                     // N/4 twiddles
    const int slot = threadIdx.x / TPF, t = threadIdx.x % TPF;
    float2* b0 = smem + N / 4 + 2 * slot * BUF;
    float2* b1 = b0 + BUF;
    const int c = blockIdx.y;
    const int f = blockIdx.x * fpb + slot;
    const bool valid = f < n_frames;
    const int tlen = ntaps - 1, V = N - tlen;
    const long long pos0 = (long long)f * V;
    for (int i = threadIdx.x; i < N / 4; i += blockDim.x) tw[i] = tw_g[i];

    // the forward transform's last pass leaves FFT*H in the buffer it
    // would have written next; the inverse reads it there and ping-pongs
    // through the other one
    constexpr bool FWD_IN_B0 = (ff_passes(N) - 1) % 2 == 0;
    float2* spec = FWD_IN_B0 ? b0 : b1;
    float2* other = FWD_IN_B0 ? b1 : b0;
    transform<N, false>(
        t, tw,
        FrameIn{tail + c * tail_cstride, block + c * block_cstride, pos0,
                tlen, valid},
        SmemTimesH{spec, h + c * h_cstride}, b0, b1);
    __syncthreads();
    transform<N, true>(t, tw, SmemIO{spec},
                       FrameOut{out + c * y_cstride, pos0, tlen, valid},
                       other, spec);
}

template <int N>
int launch(const void* tail, const void* block,
           const void* h, const void* tw, void* y, int ntaps, int n_frames,
           int n_ch, int fpb, long long tail_cstride, long long block_cstride,
           long long h_cstride, long long y_cstride, cudaStream_t st) {
    static_assert(N / ff_ept(N) <= FF_MAX_THREADS, "a frame fits a block");
    const size_t smem = (N / 4 + 2 * (size_t)fpb * ff_buf<N>()) * sizeof(float2);
    cudaError_t err = cudaFuncSetAttribute(
        fastfir_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_frames + fpb - 1) / fpb, n_ch);
    fastfir_kernel<N><<<grid, fpb * (N / ff_ept(N)), smem, st>>>(
        (const float2*)tail, (const float2*)block, (const float2*)h,
        (const float2*)tw, (float2*)y, ntaps, n_frames, fpb, tail_cstride,
        block_cstride, h_cstride, y_cstride);
    return (int)cudaGetLastError();
}

}  // namespace cutesdr

using namespace cutesdr;

// tail [n_ch, ntaps-1] and block [n_ch, n_frames*V] (channel strides in
// complex elements, 0 for one stream), h [n_ch, nfft], the quarter twiddle
// table [nfft/4], y [n_ch, n_frames*V]; fpb frames a block.
CUTESDR_API int cutesdr_fastfir(const void* tail, const void* block,
                                const void* h, const void* tw, void* y,
                                int nfft, int ntaps, int n_frames, int n_ch,
                                int fpb, long long tail_cstride,
                                long long block_cstride, long long h_cstride,
                                long long y_cstride, void* stream) {
    if (n_frames <= 0 || n_ch <= 0) return 0;
    if (fpb <= 0 || fpb * (nfft / ff_ept(nfft)) > FF_MAX_THREADS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define CUTESDR_FF_ARGS                                                      \
    tail, block, h, tw, y, ntaps, n_frames, n_ch, fpb, tail_cstride,      \
        block_cstride, h_cstride, y_cstride, st
    switch (nfft) {
        case 4: return launch<4>(CUTESDR_FF_ARGS);
        case 8: return launch<8>(CUTESDR_FF_ARGS);
        case 16: return launch<16>(CUTESDR_FF_ARGS);
        case 32: return launch<32>(CUTESDR_FF_ARGS);
        case 64: return launch<64>(CUTESDR_FF_ARGS);
        case 128: return launch<128>(CUTESDR_FF_ARGS);
        case 256: return launch<256>(CUTESDR_FF_ARGS);
        case 512: return launch<512>(CUTESDR_FF_ARGS);
        case 1024: return launch<1024>(CUTESDR_FF_ARGS);
        case 2048: return launch<2048>(CUTESDR_FF_ARGS);
        case 4096: return launch<4096>(CUTESDR_FF_ARGS);
        case 8192: return launch<8192>(CUTESDR_FF_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef CUTESDR_FF_ARGS
}
