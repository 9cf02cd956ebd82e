// Fused DC cal + NCO mix + polyphase decimation by D, for C channels.
//
// Replaces cutesdr_tpu/kernels/mixdec.py:MixDecimate.process_planes
// (_kernel_bs / _kernel_planes, shared body _compute), which the JAX
// channel bank runs under vmap.
//
// y[c, n] = sum_j h[j] * m[c, D*n + j] over z_c = [raw tail_c (L-1-d) |
// block_c], with m[c, i] = (z_c[i] - dc_c) * e^{j*phase_c(i)}, phase from
// the exact uint32 DDS accumulator acc = base_c + (i - tail_len)*inc_c
// (mod 2^32; the tail samples take back-dated phases through unsigned
// wraparound) and h the composed taps, flipped to correlation order.
// Each channel has its own tail, phase, increment and DC cal; the block is
// shared (channel stride 0, a ChannelBank) or one row per channel (a
// StackedReceiver).  One stream is C = 1.
//
// Bound on the H100: bytes.  The flagship reads 67 MB of float32 planes
// per step (20 us at 3.35 TB/s); the FIR is ~0.6 G FP32 FMAs, far below the
// card's FP32 rate.  Design: one block per tile of outputs of one channel
// (the channel in blockIdx.y).  It stages its input window (tile*D samples
// plus the L-1 history) in shared memory, mixing each sample once on the
// way in (sincosf, no fast math: the DDS phase must match the plain
// version), then each warp reduces whole outputs over the taps.  Any D and
// any output offset d work: the offset is folded into the tail length.
// The window overlap costs (L-1)/(tile*D) extra reads and oscillator
// evaluations (13% at D=32).  A shared block is read once per channel; the
// channels of a bank run concurrently, so those reads mostly hit L2.
#include "common.cuh"

namespace cutesdr {

constexpr int MIX_THREADS = 256;
constexpr int MIX_TILE_IN = 8192;   // input samples per block (before halo)

// incs: one uint32 increment per channel (held as int64), or null for
// one stream, whose increment is inc0
__global__ void mixdec_kernel(const float* __restrict__ re,
                              const float* __restrict__ im,
                              long long re_cstride, long long im_cstride,
                              long long re_stride, long long im_stride,
                              const float2* __restrict__ tail, int tail_len,
                              const float* __restrict__ taps, int ntaps,
                              const float2* __restrict__ dc,
                              const long long* __restrict__ phase,
                              const long long* __restrict__ incs,
                              unsigned int inc0, float scale, int dec,
                              int n_out, int tile_out,
                              float2* __restrict__ y) {
    extern __shared__ float2 win[];
    const int ch = blockIdx.y;
    re += ch * re_cstride;
    im += ch * im_cstride;
    tail += (long long)ch * tail_len;
    y += (long long)ch * n_out;
    const int o0 = blockIdx.x * tile_out;
    const int outs = min(tile_out, n_out - o0);
    const long long z0 = (long long)o0 * dec;      // window start in z
    const int wlen = (outs - 1) * dec + ntaps;
    const unsigned int base = (unsigned int)phase[ch];
    const unsigned int inc = incs ? (unsigned int)incs[ch] : inc0;
    const float2 d = dc[ch];

    for (int i = threadIdx.x; i < wlen; i += blockDim.x) {
        const long long zi = z0 + i;
        float xr, xi;
        if (zi < tail_len) {
            const float2 t = tail[zi];
            xr = t.x;
            xi = t.y;
        } else {
            const long long k = zi - tail_len;
            xr = re[k * re_stride];
            xi = im[k * im_stride];
        }
        const unsigned int acc =
            base + (unsigned int)(zi - tail_len) * inc;   // mod 2^32
        float s, c;
        sincosf((float)acc * scale, &s, &c);
        xr -= d.x;
        xi -= d.y;
        win[i] = make_float2(xr * c - xi * s, xr * s + xi * c);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int o = warp; o < outs; o += nwarps) {
        const float2* w = win + (long long)o * dec;
        float ar = 0.f, ai = 0.f;
        for (int j = lane; j < ntaps; j += 32) {
            const float h = __ldg(taps + j);
            const float2 v = w[j];
            ar = fmaf(h, v.x, ar);
            ai = fmaf(h, v.y, ai);
        }
        for (int sh = 16; sh; sh >>= 1) {
            ar += __shfl_xor_sync(FULL, ar, sh);
            ai += __shfl_xor_sync(FULL, ai, sh);
        }
        if (lane == 0) y[o0 + o] = make_float2(ar, ai);
    }
}

}  // namespace cutesdr

using namespace cutesdr;

CUTESDR_API int cutesdr_mixdec(const float* re, const float* im,
                               long long re_cstride, long long im_cstride,
                               long long re_stride, long long im_stride,
                               const void* tail, int tail_len,
                               const float* taps, int ntaps, const void* dc,
                               const long long* phase, const long long* incs,
                               unsigned int inc0, float scale, int dec,
                               int n_out, int n_ch, void* y, void* stream) {
    if (n_out <= 0 || n_ch <= 0) return 0;
    const int tile_out = dec >= MIX_TILE_IN ? 1 : MIX_TILE_IN / dec;
    const size_t smem = ((size_t)(tile_out - 1) * dec + ntaps) * sizeof(float2);
    cudaError_t err = cudaFuncSetAttribute(
        mixdec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_out + tile_out - 1) / tile_out, n_ch);
    mixdec_kernel<<<grid, MIX_THREADS, smem, (cudaStream_t)stream>>>(
        re, im, re_cstride, im_cstride, re_stride, im_stride,
        (const float2*)tail, tail_len, taps, ntaps, (const float2*)dc, phase,
        incs, inc0, scale, dec, n_out, tile_out, (float2*)y);
    return (int)cudaGetLastError();
}
