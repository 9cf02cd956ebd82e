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
// again.  The grid is (frames, channels); one stream is one channel.
//
// Bound on the H100: bytes.  A 2048-point frame is 16 KB and the flagship
// block is 256 frames (2 MB in, 2 MB out); the FFT work (~11 radix-2
// stages x 1024 butterflies per transform) is small next to the card's
// FP32 rate.  Design: one block per frame; the frame, both transforms and
// the multiply by H stay in shared memory (two ping-pong buffers of nfft
// complex values, 32 KB at 2048).  The transforms are radix-2 Stockham
// (self-sorting, so no bit reversal) in FP32 CUDA-core arithmetic with
// twiddles computed in float64 on the host and rounded once to float32.
// The TPU's four-step matmul split answered its matrix unit and is not
// carried over.  A bank of 64 channels of one frame (the 10 MSPS
// config-4 step) gives 64 blocks, half the card's SMs: the step is small
// and its time is the launch's.
#include "common.cuh"

namespace cutesdr {

constexpr int FF_THREADS = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Radix-2 Stockham over x (nfft = 2^log2n points) using y as scratch;
// returns the buffer holding the result.  tw[k] = exp(-2 pi i k / nfft)
// for k < nfft/2; ``inverse`` conjugates the twiddles (unscaled).
__device__ float2* stockham(float2* x, float2* y, const float2* tw, int nfft,
                            int log2n, bool inverse) {
    const int half = nfft >> 1;
    for (int st = 0; st < log2n; ++st) {
        const int s = 1 << st;            // stride
        const int m = half >> st;         // half the current sub-length
        for (int t = threadIdx.x; t < half; t += blockDim.x) {
            const int p = t >> st;
            const int q = t & (s - 1);
            float2 w = __ldg(tw + (p << st));
            if (inverse) w.y = -w.y;
            const float2 a = x[q + s * p];
            const float2 b = x[q + s * (p + m)];
            y[q + s * (2 * p)] = make_float2(a.x + b.x, a.y + b.y);
            y[q + s * (2 * p + 1)] = cmul(make_float2(a.x - b.x, a.y - b.y), w);
        }
        __syncthreads();
        float2* t = x;
        x = y;
        y = t;
    }
    return x;
}

__global__ void fastfir_kernel(const float2* __restrict__ z,
                               const float2* __restrict__ h,
                               const float2* __restrict__ tw,
                               float2* __restrict__ out, int nfft, int log2n,
                               int ntaps, long long z_cstride,
                               long long h_cstride, long long y_cstride) {
    extern __shared__ float2 buf[];
    const int c = blockIdx.y;
    z += c * z_cstride;
    h += c * h_cstride;
    out += c * y_cstride;
    const int valid = nfft - ntaps + 1;
    const float2* frame = z + (long long)blockIdx.x * valid;
    for (int i = threadIdx.x; i < nfft; i += blockDim.x) buf[i] = frame[i];
    __syncthreads();

    float2* x = stockham(buf, buf + nfft, tw, nfft, log2n, false);
    for (int i = threadIdx.x; i < nfft; i += blockDim.x)
        x[i] = cmul(x[i], h[i]);
    __syncthreads();
    float2* other = x == buf ? buf + nfft : buf;
    x = stockham(x, other, tw, nfft, log2n, true);

    float2* dst = out + (long long)blockIdx.x * valid;
    for (int i = threadIdx.x; i < valid; i += blockDim.x)
        dst[i] = x[ntaps - 1 + i];
}

}  // namespace cutesdr

using namespace cutesdr;

// The channel strides are in complex elements (0 for one stream).
CUTESDR_API int cutesdr_fastfir(const void* z, const void* h, const void* tw,
                                void* y, int nfft, int ntaps, int n_frames,
                                int n_ch, long long z_cstride,
                                long long h_cstride, long long y_cstride,
                                void* stream) {
    if (n_frames <= 0 || n_ch <= 0) return 0;
    int log2n = 0;
    while ((1 << log2n) < nfft) ++log2n;
    const size_t smem = 2 * (size_t)nfft * sizeof(float2);
    cudaError_t err = cudaFuncSetAttribute(
        fastfir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_frames, n_ch);
    fastfir_kernel<<<grid, FF_THREADS, smem, (cudaStream_t)stream>>>(
        (const float2*)z, (const float2*)h, (const float2*)tw, (float2*)y,
        nfft, log2n, ntaps, z_cstride, h_cstride, y_cstride);
    return (int)cudaGetLastError();
}
