// SPH pair-pass kernels of the cell engine, for Hopper (sm_90a).
//
// sph_fwd_kernel replaces the Pallas TPU kernel
//   sph_nca_tpu/ops/pallas/pair_kernel.py:79 _fwd_kernel
// (the SPH gradient of the state plus the pre-update life-mask blur), and
// sph_mask_kernel replaces
//   sph_nca_tpu/ops/pallas/pair_kernel.py:625 _mask_kernel
// (the post-update life-mask blur).
//
// Both run over one window-size bucket of the cell engine
// (sph_nca_tpu_torch/ops/cells.py): block b holds P = 64 rows (8 subcells x 8
// slots) and a union window of W slots. For every pair (p, w) of a block:
//   r_d  = xw_d[w] - xb_d[p]                 (direct per-axis differences)
//   d2   = sum_d r_d^2
//   mag  = 3((h^2 + d2) rsqrt(d2) - 2h)      on 0 < d2 < h^2, else 0
//   Tg   = sig_g mag v_w,  Tw = sig_w max(h^2 - d2, 0)^3 v_w
//   gA_d[p, :] += Tg r_d S_w[:],  rowsum_d[p] += Tg r_d,  sm[p] += Tw alive_w
// and finally gA_d[p, :] -= S_b[p, :] rowsum_d[p], stored d-major [P, D*F].
// alive_w is S_w[3] > thr (use_alpha) or v_w > 0.
//
// Numerics. d2 comes from per-axis differences, never from
// |a|^2 + |b|^2 - 2ab: the self pair has d2 == 0 exactly and contributes 0,
// and the spiky magnitude would amplify any cancellation error near d -> 0.
// Padded slots sit at PAD_POS = 1e6, so d2 ~ 1e12 and h^2 - d2 clamps to 0
// before the cube. Everything is fp32 (no TF32, no fast-math); rsqrtf as the
// TPU kernel's lax.rsqrt.
//
// The window states are read straight from the cell-layout state S [C*M, F]
// through the bucket's win_cells table (one 512-byte row per window cell), so
// no [nb, W, F] window copy is ever written.
//
// Bound at the gecko 128x128 shapes (C = 2320 subcells; bucket 1: 218 blocks
// at W = 664, bucket 2: 72 blocks at W = 912): 13.46 M pairs a step. The
// forward does ~125 fp32 operations a pair (d2 8, spiky magnitude 5 + rsqrt,
// Tg 2, Tw 6, mask 2, and D * (2 + 2F) = 102 for the gradient products), i.e.
// 1.7 GFLOP a step: ~25 us on the 67 TFLOP/s fp32 cores. It moves ~10 MB
// (positions, volumes, the state, gA), ~3 us at 3.35 TB/s: the forward is
// bound by operations. The mask pass does ~16 operations a pair (~3 us) over
// ~4 MB (~1 us), also bound by operations.
//
// Design, simple first: one thread block per bucket block, 4 groups of 64
// threads; thread (p, g) owns row p and every 4th slot of each window tile,
// keeping gA [D*F], rowsum [D] and sm in registers. A tile of 64 window slots
// (positions, volumes, states) is staged in shared memory and read as
// warp-wide broadcasts. The 4 partial sums meet in shared memory, which also
// stages the coalesced gA store. What it leaves on the table: the F-wide
// products run as fp32 FMAs on the CUDA cores (no tensor cores; the
// [P, W] x [W, F] product could run as TF32/3xTF32 wgmma), the tiles are
// loaded by the threads themselves (no TMA, no cp.async double buffering),
// and pairs beyond h are evaluated like any other (~80% of the window).

#include <cuda_runtime.h>

namespace {

constexpr int P = 64;              // block rows
constexpr int G = 4;               // thread groups splitting the window
constexpr int THREADS = P * G;
constexpr int TW = 64;             // window slots staged per tile
constexpr float FAR = 1.0e6f;      // position of the tile's tail slots

template <int D, int F>
__global__ void __launch_bounds__(THREADS) sph_fwd_kernel(
    const float* __restrict__ xs_b,    // [nb, D, P]
    const float* __restrict__ S,       // [C*M, F] cell-layout state
    const float* __restrict__ ab,      // [nb, P, F] the blocks' own rows
    const float* __restrict__ xw_b,    // [nb, D, W]
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu] window cells
    int M, int W, int Wu, float h, float sig_w, float sig_g, float thr,
    int use_alpha,
    float* __restrict__ ga,            // [nb, P, D*F]
    float* __restrict__ sm)            // [nb, P]
{
    constexpr int DF = D * F;
    constexpr int K = DF + D + 1;      // partials: gA, rowsum_d, sm
    __shared__ float s_x[D][TW];
    __shared__ float s_v[TW];
    __shared__ float s_S[TW][F];
    __shared__ float s_red[G - 1][K][P + 1];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int p = tid % P;
    const int g = tid / P;
    const float hh = h * h;
    const float two_h = 2.0f * h;

    const float* xw = xw_b + (size_t)b * D * W;
    const float* vw = vw_b + (size_t)b * W;
    const int* wc = win + (size_t)b * Wu;

    float xr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xr[d] = xs_b[((size_t)b * D + d) * P + p];

    float acc[DF];
    float rsum[D];
    float msum = 0.0f;
#pragma unroll
    for (int k = 0; k < DF; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) rsum[d] = 0.0f;

    for (int t0 = 0; t0 < W; t0 += TW) {
        __syncthreads();  // the previous tile is consumed
        for (int i = tid; i < TW; i += THREADS) {
            const int w = t0 + i;
            const bool in = w < W;
#pragma unroll
            for (int d = 0; d < D; ++d) s_x[d][i] = in ? xw[(size_t)d * W + w] : FAR;
            s_v[i] = in ? vw[w] : 0.0f;
        }
        for (int i = tid; i < TW * F; i += THREADS) {
            const int j = i / F;
            const int f = i % F;
            const int w = t0 + j;
            float val = 0.0f;
            if (w < W) {
                const int cell = wc[w / M];
                val = S[((size_t)cell * M + (w % M)) * F + f];
            }
            s_S[j][f] = val;
        }
        __syncthreads();

        const int n = min(TW, W - t0);
        for (int j = g; j < n; j += G) {
            float r[D];
#pragma unroll
            for (int d = 0; d < D; ++d) r[d] = s_x[d][j] - xr[d];
            float d2 = r[0] * r[0];
#pragma unroll
            for (int d = 1; d < D; ++d) d2 = d2 + r[d] * r[d];
            const float v = s_v[j];

            const float rs = rsqrtf(d2 > 0.0f ? d2 : 1.0f);
            const float mag =
                (d2 > 0.0f && d2 < hh) ? 3.0f * ((hh + d2) * rs - two_h) : 0.0f;
            const float tg = sig_g * mag * v;
            const float c = fmaxf(hh - d2, 0.0f);
            const float tw = sig_w * (c * c * c) * v;
            const bool alive = use_alpha ? (s_S[j][3] > thr) : (v > 0.0f);
            msum += alive ? tw : 0.0f;

#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float td = tg * r[d];
                rsum[d] += td;
#pragma unroll
                for (int f = 0; f < F; ++f) acc[d * F + f] += td * s_S[j][f];
            }
        }
    }

    // groups 1..G-1 hand their partials to group 0
    if (g > 0) {
#pragma unroll
        for (int k = 0; k < DF; ++k) s_red[g - 1][k][p] = acc[k];
#pragma unroll
        for (int d = 0; d < D; ++d) s_red[g - 1][DF + d][p] = rsum[d];
        s_red[g - 1][K - 1][p] = msum;
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
        for (int q = 0; q < G - 1; ++q) {
#pragma unroll
            for (int k = 0; k < DF; ++k) acc[k] += s_red[q][k][p];
#pragma unroll
            for (int d = 0; d < D; ++d) rsum[d] += s_red[q][DF + d][p];
            msum += s_red[q][K - 1][p];
        }
        const float* abr = ab + ((size_t)b * P + p) * F;
#pragma unroll
        for (int d = 0; d < D; ++d) {
#pragma unroll
            for (int f = 0; f < F; ++f)
                s_red[0][d * F + f][p] = acc[d * F + f] - abr[f] * rsum[d];
        }
        sm[(size_t)b * P + p] = msum;
    }
    __syncthreads();
    float* out = ga + (size_t)b * P * DF;
    for (int i = tid; i < P * DF; i += THREADS) out[i] = s_red[0][i % DF][i / DF];
}

template <int D>
__global__ void __launch_bounds__(THREADS) sph_mask_kernel(
    const float* __restrict__ xs_b,    // [nb, D, P]
    const float* __restrict__ S,       // [C*M, F] cell-layout state
    const float* __restrict__ xw_b,    // [nb, D, W]
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu]
    int F, int M, int W, int Wu, float h, float sig_w, float thr,
    int use_alpha,
    float* __restrict__ sm)            // [nb, P]
{
    __shared__ float s_x[D][TW];
    __shared__ float s_va[TW];         // v_w * alive_w
    __shared__ float s_red[G - 1][P];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int p = tid % P;
    const int g = tid / P;
    const float hh = h * h;

    const float* xw = xw_b + (size_t)b * D * W;
    const float* vw = vw_b + (size_t)b * W;
    const int* wc = win + (size_t)b * Wu;

    float xr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xr[d] = xs_b[((size_t)b * D + d) * P + p];
    float msum = 0.0f;

    for (int t0 = 0; t0 < W; t0 += TW) {
        __syncthreads();
        for (int i = tid; i < TW; i += THREADS) {
            const int w = t0 + i;
            float va = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) s_x[d][i] = w < W ? xw[(size_t)d * W + w] : FAR;
            if (w < W) {
                const float v = vw[w];
                bool alive = v > 0.0f;
                if (use_alpha) {
                    const int cell = wc[w / M];
                    alive = S[((size_t)cell * M + (w % M)) * F + 3] > thr;
                }
                va = alive ? v : 0.0f;
            }
            s_va[i] = va;
        }
        __syncthreads();

        const int n = min(TW, W - t0);
        for (int j = g; j < n; j += G) {
            float r[D];
#pragma unroll
            for (int d = 0; d < D; ++d) r[d] = s_x[d][j] - xr[d];
            float d2 = r[0] * r[0];
#pragma unroll
            for (int d = 1; d < D; ++d) d2 = d2 + r[d] * r[d];
            const float c = fmaxf(hh - d2, 0.0f);
            msum += sig_w * (c * c * c) * s_va[j];
        }
    }

    if (g > 0) s_red[g - 1][p] = msum;
    __syncthreads();
    if (g == 0) {
#pragma unroll
        for (int q = 0; q < G - 1; ++q) msum += s_red[q][p];
        sm[(size_t)b * P + p] = msum;
    }
}

}  // namespace

// Plain C launchers for ctypes: raw device pointers, sizes and the caller's
// stream; each returns the cudaGetLastError() code of its launch (0 = ok).

extern "C" int sph_fwd_launch(
    const float* xs_b, const float* S, const float* ab, const float* xw_b,
    const float* vw_b, const int* win, int nb, int D, int F, int P_, int M,
    int W, int Wu, float h, float sig_w, float sig_g, float thr,
    int use_alpha, float* ga, float* sm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (P_ != P || F != 16 || nb <= 0) return (int)cudaErrorInvalidValue;
    if (D == 2) {
        sph_fwd_kernel<2, 16><<<nb, THREADS, 0, st>>>(
            xs_b, S, ab, xw_b, vw_b, win, M, W, Wu, h, sig_w, sig_g, thr,
            use_alpha, ga, sm);
    } else if (D == 3) {
        sph_fwd_kernel<3, 16><<<nb, THREADS, 0, st>>>(
            xs_b, S, ab, xw_b, vw_b, win, M, W, Wu, h, sig_w, sig_g, thr,
            use_alpha, ga, sm);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int sph_mask_launch(
    const float* xs_b, const float* S, const float* xw_b, const float* vw_b,
    const int* win, int nb, int D, int F, int P_, int M, int W, int Wu,
    float h, float sig_w, float thr, int use_alpha, float* sm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (P_ != P || F < 4 || nb <= 0) return (int)cudaErrorInvalidValue;
    if (D == 2) {
        sph_mask_kernel<2><<<nb, THREADS, 0, st>>>(
            xs_b, S, xw_b, vw_b, win, F, M, W, Wu, h, sig_w, thr, use_alpha, sm);
    } else if (D == 3) {
        sph_mask_kernel<3><<<nb, THREADS, 0, st>>>(
            xs_b, S, xw_b, vw_b, win, F, M, W, Wu, h, sig_w, thr, use_alpha, sm);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
