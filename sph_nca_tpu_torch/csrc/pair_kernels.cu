// SPH pair-pass kernels of the cell engine, for Hopper (sm_90a).
//
// sph_fwd_kernel replaces the Pallas TPU kernel
//   sph_nca_tpu/ops/pallas/pair_kernel.py:79 _fwd_kernel
// (the SPH gradient of the state plus the pre-update life-mask blur), and
// sph_mask_kernel replaces
//   sph_nca_tpu/ops/pallas/pair_kernel.py:625 _mask_kernel
// (the post-update life-mask blur), and sph_bwd_kernel replaces
//   sph_nca_tpu/ops/pallas/pair_kernel.py:437 _bwd_kernel
// (the adjoint of the SPH gradient, the backward of the perception).
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
// Batch. Every kernel takes a leading batch axis B on blockIdx.y: the
// geometry (positions, volumes, window tables) is shared, and each sample's
// state, own rows, cotangents and outputs sit at that sample's offset. The
// training step runs all B samples of a batch in one launch per bucket, as
// the JAX trainer vmaps the pallas_call; inference launches with B = 1.
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
//
// The adjoint (sph_bwd_kernel), for every pair (p, w) of a block:
//   r_d  = xb_d[p] - xw_d[w]                 (the OPPOSITE sign of the forward)
//   mag  = 3((h^2 + d2) rsqrt(d2) - 2h)      on 0 < d2 < h^2, else 0
//   acc[p, :] += sum_d mag r_d G_w[d*F : (d+1)*F]
// and finally dA[p, :] = sig_g v_b[p] acc[p, :] - sum_d gsum[p, d] gbar_p[d*F:]
// with G the d-major cotangent of gA [C*M, D*F], read through win_cells like
// the forward reads S, gbar_p the row's own cotangent and gsum the
// geometry's self term (ops/cells.py). mag carries no v_w: the row's own
// volume v_b multiplies the sum instead. Pad rows have v_b = 0 and gsum = 0,
// so their dA is exactly 0. Bound: the same pairs as the forward with
// ~5 + D * (1 + 2F) = 104 operations for a pair inside h, so it is bound by
// operations like the forward. Design: the forward's (4 groups of 64 threads
// split each 64-slot window tile, the tile's positions and its D*F cotangent
// columns staged in shared memory, partial sums meeting in shared memory),
// with acc [F] in registers; a warp whose 32 rows all lie beyond h of a slot
// skips the slot's products (mag == 0 adds nothing).

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
    const float* __restrict__ S,       // [B][C*M, F] cell-layout state
    long long s_bs,                    // S's sample stride (elements)
    const float* __restrict__ ab,      // [B][nb, P, F] the blocks' own rows
    long long ab_bs,                   // ab's sample stride (elements)
    const float* __restrict__ xw_b,    // [nb, D, W]
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu] window cells
    int M, int W, int Wu, float h, float sig_w, float sig_g, float thr,
    int use_alpha,
    float* __restrict__ ga,            // [B, nb, P, D*F]
    float* __restrict__ sm)            // [B, nb, P]
{
    constexpr int DF = D * F;
    constexpr int K = DF + D + 1;      // partials: gA, rowsum_d, sm
    __shared__ float s_x[D][TW];
    __shared__ float s_v[TW];
    __shared__ float s_S[TW][F];
    __shared__ float s_red[G - 1][K][P + 1];

    const int b = blockIdx.x;
    const int nb = gridDim.x;
    const int y = blockIdx.y;          // sample
    const int tid = threadIdx.x;
    const int p = tid % P;
    const int g = tid / P;
    const float hh = h * h;
    const float two_h = 2.0f * h;

    const float* xw = xw_b + (size_t)b * D * W;
    const float* vw = vw_b + (size_t)b * W;
    const int* wc = win + (size_t)b * Wu;
    const float* Sy = S + (size_t)y * s_bs;

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
                val = Sy[((size_t)cell * M + (w % M)) * F + f];
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
    const size_t blk = (size_t)y * nb + b;  // output block of this sample
    if (g == 0) {
#pragma unroll
        for (int q = 0; q < G - 1; ++q) {
#pragma unroll
            for (int k = 0; k < DF; ++k) acc[k] += s_red[q][k][p];
#pragma unroll
            for (int d = 0; d < D; ++d) rsum[d] += s_red[q][DF + d][p];
            msum += s_red[q][K - 1][p];
        }
        const float* abr = ab + (size_t)y * ab_bs + ((size_t)b * P + p) * F;
#pragma unroll
        for (int d = 0; d < D; ++d) {
#pragma unroll
            for (int f = 0; f < F; ++f)
                s_red[0][d * F + f][p] = acc[d * F + f] - abr[f] * rsum[d];
        }
        sm[blk * P + p] = msum;
    }
    __syncthreads();
    float* out = ga + blk * P * DF;
    for (int i = tid; i < P * DF; i += THREADS) out[i] = s_red[0][i % DF][i / DF];
}

template <int D>
__global__ void __launch_bounds__(THREADS) sph_mask_kernel(
    const float* __restrict__ xs_b,    // [nb, D, P]
    const float* __restrict__ S,       // [B][C*M, F] cell-layout state
    long long s_bs,                    // S's sample stride (elements)
    const float* __restrict__ xw_b,    // [nb, D, W]
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu]
    int F, int M, int W, int Wu, float h, float sig_w, float thr,
    int use_alpha,
    float* __restrict__ sm)            // [B, nb, P]
{
    __shared__ float s_x[D][TW];
    __shared__ float s_va[TW];         // v_w * alive_w
    __shared__ float s_red[G - 1][P];

    const int b = blockIdx.x;
    const int nb = gridDim.x;
    const int y = blockIdx.y;
    const int tid = threadIdx.x;
    const int p = tid % P;
    const int g = tid / P;
    const float hh = h * h;

    const float* xw = xw_b + (size_t)b * D * W;
    const float* vw = vw_b + (size_t)b * W;
    const int* wc = win + (size_t)b * Wu;
    const float* Sy = S + (size_t)y * s_bs;

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
                    alive = Sy[((size_t)cell * M + (w % M)) * F + 3] > thr;
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
        sm[((size_t)y * nb + b) * P + p] = msum;
    }
}

template <int D, int F>
__global__ void __launch_bounds__(THREADS) sph_bwd_kernel(
    const float* __restrict__ xs_b,    // [nb, D, P]
    const float* __restrict__ vs_b,    // [nb, P] the rows' own volumes
    const float* __restrict__ gsum_b,  // [nb, P, D] adjoint self term
    const float* __restrict__ gb,      // [B][nb, P, D*F] the rows' cotangents
    long long gb_bs,                   // gb's sample stride (elements)
    const float* __restrict__ xw_b,    // [nb, D, W]
    const float* __restrict__ Gc,      // [B][C*M, D*F] cotangent of gA
    long long g_bs,                    // Gc's sample stride (elements)
    const int* __restrict__ win,       // [nb, Wu] window cells
    int M, int W, int Wu, float h, float sig_g,
    float* __restrict__ da)            // [B, nb, P, F]
{
    constexpr int DF = D * F;
    __shared__ float s_x[D][TW];
    __shared__ float s_G[TW][DF];
    __shared__ float s_red[G - 1][F][P + 1];

    const int b = blockIdx.x;
    const int nb = gridDim.x;
    const int y = blockIdx.y;
    const int tid = threadIdx.x;
    const int p = tid % P;
    const int g = tid / P;
    const float hh = h * h;
    const float two_h = 2.0f * h;

    const float* xw = xw_b + (size_t)b * D * W;
    const int* wc = win + (size_t)b * Wu;
    const float* Gy = Gc + (size_t)y * g_bs;

    float xr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xr[d] = xs_b[((size_t)b * D + d) * P + p];

    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;

    for (int t0 = 0; t0 < W; t0 += TW) {
        __syncthreads();  // the previous tile is consumed
        for (int i = tid; i < TW; i += THREADS) {
            const int w = t0 + i;
#pragma unroll
            for (int d = 0; d < D; ++d) s_x[d][i] = w < W ? xw[(size_t)d * W + w] : FAR;
        }
        for (int i = tid; i < TW * DF; i += THREADS) {
            const int j = i / DF;
            const int k = i % DF;
            const int w = t0 + j;
            float val = 0.0f;
            if (w < W) {
                const int cell = wc[w / M];
                val = Gy[((size_t)cell * M + (w % M)) * DF + k];
            }
            s_G[j][k] = val;
        }
        __syncthreads();

        const int n = min(TW, W - t0);
        for (int j = g; j < n; j += G) {
            float r[D];
#pragma unroll
            for (int d = 0; d < D; ++d) r[d] = xr[d] - s_x[d][j];
            float d2 = r[0] * r[0];
#pragma unroll
            for (int d = 1; d < D; ++d) d2 = d2 + r[d] * r[d];
            const float rs = rsqrtf(d2 > 0.0f ? d2 : 1.0f);
            const float mag =
                (d2 > 0.0f && d2 < hh) ? 3.0f * ((hh + d2) * rs - two_h) : 0.0f;
            if (mag == 0.0f) continue;  // adds nothing (pairs beyond h)
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float md = mag * r[d];
#pragma unroll
                for (int f = 0; f < F; ++f) acc[f] += md * s_G[j][d * F + f];
            }
        }
    }

    if (g > 0) {
#pragma unroll
        for (int f = 0; f < F; ++f) s_red[g - 1][f][p] = acc[f];
    }
    __syncthreads();
    const size_t blk = (size_t)y * nb + b;
    if (g == 0) {
#pragma unroll
        for (int q = 0; q < G - 1; ++q) {
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] += s_red[q][f][p];
        }
        const size_t row = (size_t)b * P + p;
        const float sv = sig_g * vs_b[row];
        const float* gbr = gb + (size_t)y * gb_bs + row * DF;
        float gs[D];
#pragma unroll
        for (int d = 0; d < D; ++d) gs[d] = gsum_b[row * D + d];
#pragma unroll
        for (int f = 0; f < F; ++f) {
            float t2 = gs[0] * gbr[f];
#pragma unroll
            for (int d = 1; d < D; ++d) t2 = t2 + gs[d] * gbr[d * F + f];
            s_red[0][f][p] = sv * acc[f] - t2;
        }
    }
    __syncthreads();
    float* out = da + blk * P * F;
    for (int i = tid; i < P * F; i += THREADS) out[i] = s_red[0][i % F][i / F];
}

}  // namespace

// Plain C launchers for ctypes: raw device pointers, sizes, sample strides
// and the caller's stream; the grid is (nb blocks, B samples). Each returns
// the cudaGetLastError() code of its launch (0 = ok).

extern "C" int sph_fwd_launch(
    const float* xs_b, const float* S, long long s_bs, const float* ab,
    long long ab_bs, const float* xw_b, const float* vw_b, const int* win,
    int B, int nb, int D, int F, int P_, int M, int W, int Wu, float h,
    float sig_w, float sig_g, float thr, int use_alpha, float* ga, float* sm,
    void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (P_ != P || F != 16 || nb <= 0 || B <= 0 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(nb, B);
    if (D == 2) {
        sph_fwd_kernel<2, 16><<<grid, THREADS, 0, st>>>(
            xs_b, S, s_bs, ab, ab_bs, xw_b, vw_b, win, M, W, Wu, h, sig_w,
            sig_g, thr, use_alpha, ga, sm);
    } else if (D == 3) {
        sph_fwd_kernel<3, 16><<<grid, THREADS, 0, st>>>(
            xs_b, S, s_bs, ab, ab_bs, xw_b, vw_b, win, M, W, Wu, h, sig_w,
            sig_g, thr, use_alpha, ga, sm);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int sph_mask_launch(
    const float* xs_b, const float* S, long long s_bs, const float* xw_b,
    const float* vw_b, const int* win, int B, int nb, int D, int F, int P_,
    int M, int W, int Wu, float h, float sig_w, float thr, int use_alpha,
    float* sm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (P_ != P || F < 4 || nb <= 0 || B <= 0 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(nb, B);
    if (D == 2) {
        sph_mask_kernel<2><<<grid, THREADS, 0, st>>>(
            xs_b, S, s_bs, xw_b, vw_b, win, F, M, W, Wu, h, sig_w, thr,
            use_alpha, sm);
    } else if (D == 3) {
        sph_mask_kernel<3><<<grid, THREADS, 0, st>>>(
            xs_b, S, s_bs, xw_b, vw_b, win, F, M, W, Wu, h, sig_w, thr,
            use_alpha, sm);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int sph_bwd_launch(
    const float* xs_b, const float* vs_b, const float* gsum_b,
    const float* gb, long long gb_bs, const float* xw_b, const float* Gc,
    long long g_bs, const int* win, int B, int nb, int D, int F, int P_,
    int M, int W, int Wu, float h, float sig_g, float* da, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (P_ != P || F != 16 || nb <= 0 || B <= 0 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(nb, B);
    if (D == 2) {
        sph_bwd_kernel<2, 16><<<grid, THREADS, 0, st>>>(
            xs_b, vs_b, gsum_b, gb, gb_bs, xw_b, Gc, g_bs, win, M, W, Wu, h,
            sig_g, da);
    } else if (D == 3) {
        sph_bwd_kernel<3, 16><<<grid, THREADS, 0, st>>>(
            xs_b, vs_b, gsum_b, gb, gb_bs, xw_b, Gc, g_bs, win, M, W, Wu, h,
            sig_g, da);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
