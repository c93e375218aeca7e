// Pair-TABLE kernels of the cell engine, for Hopper (sm_90a).
//
// With build_cell_engine(pair_tables="float32" | "bfloat16") every block b of
// a window-size bucket stores, once for the whole rollout,
//   md [D*P, W]  mag * (xw_d - xb_d), rows d-major (the spiky factors)
//   w6 [P, W]    max(h^2 - d2, 0)^3 (the poly6 core)
// in the table type T (float or __nv_bfloat16), P = 64 rows, W union-window
// slots (a multiple of 8). Every pass is then a product over stored tables,
// with no per-pair geometry work left. The four kernels here replace the
// Pallas TPU kernels of sph_nca_tpu/ops/pallas/pair_kernel.py:
//
//   sph_fwd_tab_kernel   _fwd_tab_kernel  (:134)  the perception:
//       gA_d = sig_g md_d @ (v_w S_w) - S_b gsum_d     -> [P, D*F] d-major
//       sm   = w6 @ (sig_w v_w alive_w)                -> [P]
//   sph_bwd_tab_kernel   _bwd_tab_kernel  (:208)  its adjoint:
//       dA = -sig_g v_b sum_d md_d @ G_d - sum_d gsum_d gbar_b,d  -> [P, F]
//   sph_mask_tab_kernel  _mask_tab_kernel (:270)  the post-update mask:
//       sm = w6 @ (sig_w v_w alive_w)                  -> [P]
//   sph_blur_tab_kernel  _blur_tab_kernel (:249)  the tangent-diffusion blur:
//       out = sig_w w6 @ (v_w X_w)                     -> [P, F]
//
// alive_w is S_w[3] > thr (use_alpha) or v_w > 0. The window's states,
// cotangents or values are read straight from the cell-layout tensor
// [C*M, F] through the bucket's win_cells table (no window copy is written).
// gsum is the one derived from the QUANTIZED md (ops/cells.py), so a constant
// state cancels in the forward to f32 rounding.
//
// Numerics, as the TPU kernels (pair_kernel.py:175-181): the tables are read
// in their type and upcast; every product and sum is f32, and the right-hand
// sides (v_w S_w, v_w X_w, the alive column, the cotangents) stay f32, since
// quantizing them would bring back the |A| * eps error the gsum removes. No
// TF32, no fast-math. Pad rows (v_b = 0, gsum = 0, md and w6 rows that only
// meet pad slots of v = 0) and pad slots come out as exact zeros, and the
// tail of the last tile is staged as zeros.
//
// Bound on this card. At the surface path's shapes (stripes, a 25,600-point
// sphere at h = 0.1: 370 + 124 blocks at W = 576 / 1000, B = 1) the tables
// are 345 MB in f32 (173 MB in bf16). A rollout step streams md and w6 once
// in the forward and w6 once in each of the mask and blur passes, ~517 MB in
// f32, ~0.15 ms at 3.35 TB/s, against ~2 GFLOP of f32 products (~0.03 ms at
// 67 TFLOP/s): every table pass is bound by BYTES, the table read.
//
// Design, simple first. The table is the one stream that matters, so every
// kernel reads it in coalesced 16-byte vectors (4 floats or 8 bf16) and reads
// it once per launch; what it is multiplied with sits in shared memory.
//   fwd / bwd: one thread block (256 threads) per (block, sample). A tile of
//     TW = 32 window slots of md (and w6) is staged, upcast, in shared memory
//     with a padded row stride (conflict-free per-row reads), beside the
//     tile's f32 right-hand side; the next tile's chunks and right-hand side
//     are loaded into registers before the current tile's products, so their
//     latency hides behind them (1-3 blocks fit an SM). fwd: thread r < D*P
//     owns md row r and its F sums, the next 64 threads own the w6 rows
//     (sm). bwd: thread (p, q) owns row p and features 4q..4q+3, summing
//     over d and w.
//   mask / blur: matrix-vector shaped, so one warp per 8 rows; a warp reads
//     its rows 16 bytes a lane straight from device memory (a 512-byte
//     coalesced load per row and step) against a 256-slot chunk of the
//     right-hand side staged f-major in shared memory.
// Left for later: tensor cores (the [D*P, W] @ [W, F] product fits wgmma),
// TMA / cp.async double buffering of the tiles, and reading the table once
// for all B samples of a launch (B rides blockIdx.y, so at B > 1 the table is
// read B times, from L2 when it fits).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int P = 64;          // block rows
constexpr int THREADS = 256;
constexpr int TW = 32;         // window slots per staged table tile
constexpr int LD = TW + 1;     // padded shared row stride
constexpr int CH = THREADS;    // window slots per staged chunk (mask, blur)
constexpr int WARPS = THREADS / 32;
constexpr int RPW = P / WARPS; // rows per warp (mask, blur)

// 16 bytes of table -> V floats
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void unpack16(const uint4& raw, float* out,
                                         float) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack16(const uint4& raw, float* out,
                                         __nv_bfloat16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        out[2 * k] = f.x;
        out[2 * k + 1] = f.y;
    }
}

// One TW-slot tile of ROWS table rows (row stride W), held in registers
// between its load and its store to shared memory: each thread owns
// ceil(ROWS * TW / V / THREADS) 16-byte chunks. Rows below SPLIT come from
// `a`, the rest from `b` (the forward stages md and w6 as one tile). The
// loads of the next tile are issued before the current tile's products and
// land while they run.
template <typename T, int ROWS, int SPLIT>
struct TableTile {
    static constexpr int V = Vec<T>::N;
    static constexpr int CPR = TW / V;  // 16-byte chunks per row and tile
    static constexpr int N = (ROWS * CPR + THREADS - 1) / THREADS;
    uint4 raw[N];

    __device__ __forceinline__ void load(const T* __restrict__ a,
                                         const T* __restrict__ b, int W,
                                         int t0) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
            const int i = threadIdx.x + k * THREADS;
            const int r = i / CPR;
            const int w = t0 + (i % CPR) * V;
            raw[k] = make_uint4(0u, 0u, 0u, 0u);  // slots at or past W: 0
            if (i < ROWS * CPR && w < W) {
                const T* row = r < SPLIT ? a + (size_t)r * W
                                         : b + (size_t)(r - SPLIT) * W;
                raw[k] = *reinterpret_cast<const uint4*>(row + w);
            }
        }
    }

    __device__ __forceinline__ void store(float (*dst)[LD]) const {
#pragma unroll
        for (int k = 0; k < N; ++k) {
            const int i = threadIdx.x + k * THREADS;
            if (i < ROWS * CPR) {
                float v[V];
                unpack16(raw[k], v, T());
#pragma unroll
                for (int e = 0; e < V; ++e)
                    dst[i / CPR][(i % CPR) * V + e] = v[e];
            }
        }
    }
};

__device__ __forceinline__ size_t win_row(const int* __restrict__ wc, int w,
                                          int M) {
    return (size_t)wc[w / M] * M + (w % M);
}

template <typename T, int D, int F>
__global__ void __launch_bounds__(THREADS) sph_fwd_tab_kernel(
    const T* __restrict__ md,          // [nb, D*P, W]
    const T* __restrict__ w6,          // [nb, P, W]
    const float* __restrict__ gsum_b,  // [nb, P, D]
    const float* __restrict__ S,       // [B][C*M, F] cell-layout state
    long long s_bs,                    // S's sample stride (elements)
    const float* __restrict__ ab,      // [B][nb, P, F] the blocks' own rows
    long long ab_bs,
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu] window cells
    int M, int W, int Wu, float sig_w, float sig_g, float thr,
    int use_alpha,
    float* __restrict__ ga,            // [B, nb, P, D*F]
    float* __restrict__ sm)            // [B, nb, P]
{
    constexpr int R = D * P;  // md rows; rows R..R+P-1 of s_t hold w6
    static_assert(R + P <= THREADS, "one thread per table row");
    static_assert(F % 4 == 0, "float4 right-hand side rows");
    __shared__ float s_t[R + P][LD];
    __shared__ __align__(16) float s_rhs[TW][F];  // v_w S_w
    __shared__ float s_col[TW];                   // sig_w v_w alive_w

    const int b = blockIdx.x;
    const int nb = gridDim.x;
    const int y = blockIdx.y;
    const int tid = threadIdx.x;
    const T* mdb = md + (size_t)b * R * W;
    const T* w6b = w6 + (size_t)b * P * W;
    const float* vw = vw_b + (size_t)b * W;
    const int* wc = win + (size_t)b * Wu;
    const float* Sy = S + (size_t)y * s_bs;

    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;

    // per tile and thread: table chunks, RK right-hand-side values (v_w and
    // the raw state) and, for the first TW threads, the column's inputs
    constexpr int RK = TW * F / THREADS;
    static_assert(TW * F % THREADS == 0 && TW <= THREADS, "rhs split");
    TableTile<T, R + P, R> tile;
    float rv[RK], rs[RK], cv = 0.0f, ca = 0.0f;
    auto prefetch = [&](int t0) {
        tile.load(mdb, w6b, W, t0);
#pragma unroll
        for (int k = 0; k < RK; ++k) {
            const int i = tid + k * THREADS;
            const int w = t0 + i / F;
            rv[k] = w < W ? vw[w] : 0.0f;
            rs[k] = w < W ? Sy[win_row(wc, w, M) * F + i % F] : 0.0f;
        }
        if (tid < TW) {
            const int w = t0 + tid;
            cv = w < W ? vw[w] : 0.0f;
            ca = (w < W && use_alpha) ? Sy[win_row(wc, w, M) * F + 3] : 0.0f;
        }
    };

    prefetch(0);
    for (int t0 = 0; t0 < W; t0 += TW) {
        __syncthreads();  // the previous tile is consumed
        tile.store(s_t);
#pragma unroll
        for (int k = 0; k < RK; ++k) {
            const int i = tid + k * THREADS;
            s_rhs[i / F][i % F] = rv[k] * rs[k];
        }
        if (tid < TW) {
            const bool alive = use_alpha ? ca > thr : cv > 0.0f;
            s_col[tid] = alive ? sig_w * cv : 0.0f;
        }
        __syncthreads();
        if (t0 + TW < W) prefetch(t0 + TW);  // in flight during the products

        if (tid < R) {
            for (int j = 0; j < TW; ++j) {
                const float m = s_t[tid][j];
                const float4* rr = reinterpret_cast<const float4*>(s_rhs[j]);
#pragma unroll
                for (int q = 0; q < F / 4; ++q) {
                    const float4 v = rr[q];
                    acc[4 * q] += m * v.x;
                    acc[4 * q + 1] += m * v.y;
                    acc[4 * q + 2] += m * v.z;
                    acc[4 * q + 3] += m * v.w;
                }
            }
        } else if (tid < R + P) {
            for (int j = 0; j < TW; ++j) acc[0] += s_t[tid][j] * s_col[j];
        }
    }

    const size_t blk = (size_t)y * nb + b;  // output block of this sample
    if (tid < R) {
        const int d = tid / P;
        const int p = tid % P;
        const float g = gsum_b[((size_t)b * P + p) * D + d];
        const float* abr = ab + (size_t)y * ab_bs + ((size_t)b * P + p) * F;
        float4* out = reinterpret_cast<float4*>(
            ga + (blk * P + p) * (D * F) + d * F);
#pragma unroll
        for (int q = 0; q < F / 4; ++q) {
            out[q] = make_float4(sig_g * acc[4 * q] - abr[4 * q] * g,
                                 sig_g * acc[4 * q + 1] - abr[4 * q + 1] * g,
                                 sig_g * acc[4 * q + 2] - abr[4 * q + 2] * g,
                                 sig_g * acc[4 * q + 3] - abr[4 * q + 3] * g);
        }
    } else if (tid < R + P) {
        sm[blk * P + (tid - R)] = acc[0];
    }
}

template <typename T, int D, int F>
__global__ void __launch_bounds__(THREADS) sph_bwd_tab_kernel(
    const T* __restrict__ md,          // [nb, D*P, W]
    const float* __restrict__ vs_b,    // [nb, P] the rows' own volumes
    const float* __restrict__ gsum_b,  // [nb, P, D]
    const float* __restrict__ gb,      // [B][nb, P, D*F] the rows' cotangents
    long long gb_bs,
    const float* __restrict__ Gc,      // [B][C*M, D*F] cotangent of gA
    long long g_bs,
    const int* __restrict__ win,       // [nb, Wu]
    int M, int W, int Wu, float sig_g,
    float* __restrict__ da)            // [B, nb, P, F]
{
    constexpr int R = D * P;
    constexpr int DF = D * F;
    constexpr int Q = F / 4;  // feature quads: thread (p, q) owns 4q..4q+3
    static_assert(P * Q == THREADS, "one thread per row and feature quad");
    __shared__ float s_t[R][LD];
    __shared__ __align__(16) float s_G[TW][DF];

    const int b = blockIdx.x;
    const int nb = gridDim.x;
    const int y = blockIdx.y;
    const int tid = threadIdx.x;
    const int p = tid % P;
    const int q = tid / P;
    const T* mdb = md + (size_t)b * R * W;
    const int* wc = win + (size_t)b * Wu;
    const float* Gy = Gc + (size_t)y * g_bs;

    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    constexpr int GK = TW * DF / THREADS;  // cotangent values per thread
    static_assert(TW * DF % THREADS == 0, "cotangent split");
    TableTile<T, R, R> tile;
    float gv[GK];
    auto prefetch = [&](int t0) {
        tile.load(mdb, mdb, W, t0);
#pragma unroll
        for (int k = 0; k < GK; ++k) {
            const int i = tid + k * THREADS;
            const int w = t0 + i / DF;
            gv[k] = w < W ? Gy[win_row(wc, w, M) * DF + i % DF] : 0.0f;
        }
    };

    prefetch(0);
    for (int t0 = 0; t0 < W; t0 += TW) {
        __syncthreads();
        tile.store(s_t);
#pragma unroll
        for (int k = 0; k < GK; ++k) {
            const int i = tid + k * THREADS;
            s_G[i / DF][i % DF] = gv[k];
        }
        __syncthreads();
        if (t0 + TW < W) prefetch(t0 + TW);  // in flight during the products
        for (int j = 0; j < TW; ++j) {
            const float4* gr = reinterpret_cast<const float4*>(s_G[j]);
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float m = s_t[d * P + p][j];
                const float4 g = gr[d * Q + q];
                acc[0] += m * g.x;
                acc[1] += m * g.y;
                acc[2] += m * g.z;
                acc[3] += m * g.w;
            }
        }
    }

    const size_t row = (size_t)b * P + p;
    const float sv = -sig_g * vs_b[row];
    const float* gbr = gb + (size_t)y * gb_bs + row * DF + 4 * q;
    float t2[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) t2[k] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const float g = gsum_b[row * D + d];
#pragma unroll
        for (int k = 0; k < 4; ++k) t2[k] += g * gbr[d * F + k];
    }
    const size_t blk = (size_t)y * nb + b;
    *reinterpret_cast<float4*>(da + (blk * P + p) * F + 4 * q) =
        make_float4(sv * acc[0] - t2[0], sv * acc[1] - t2[1],
                    sv * acc[2] - t2[2], sv * acc[3] - t2[3]);
}

// The body of the mask and blur kernels:
// out[p, :] = scale * sum_w w6[p, w] rhs[w, :], with rhs[w, :] built from the
// window: MASK: rhs = sig_w v_w alive_w (F = 1, alive from channel 3 of the
// FX-channel state X, or v_w > 0), scale 1; else rhs = v_w X_w (FX = F),
// scale sig_w.
template <typename T, int F, bool MASK>
__device__ __forceinline__ void rows_tab_body(
    const T* __restrict__ w6,          // [nb, P, W]
    const float* __restrict__ X,       // [B][C*M, FX]
    long long x_bs, int FX,
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu]
    int M, int W, int Wu, float sig_w, float thr, int use_alpha,
    float* __restrict__ out)           // [B, nb, P, F]
{
    constexpr int V = Vec<T>::N;
    __shared__ __align__(16) float s_rhs[F][CH];

    const int b = blockIdx.x;
    const int nb = gridDim.x;
    const int y = blockIdx.y;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const T* w6b = w6 + (size_t)b * P * W;
    const float* vw = vw_b + (size_t)b * W;
    const int* wc = win + (size_t)b * Wu;
    const float* Xy = X + (size_t)y * x_bs;

    float acc[RPW][F];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int f = 0; f < F; ++f) acc[r][f] = 0.0f;

    for (int c0 = 0; c0 < W; c0 += CH) {
        __syncthreads();
        const int w = c0 + tid;
        if (MASK) {
            float c = 0.0f;
            if (w < W) {
                const float v = vw[w];
                const bool alive = use_alpha
                    ? Xy[win_row(wc, w, M) * FX + 3] > thr : v > 0.0f;
                c = alive ? sig_w * v : 0.0f;
            }
            s_rhs[0][tid] = c;
        } else {
            const size_t src = w < W ? win_row(wc, w, M) * FX : 0;
            const float v = w < W ? vw[w] : 0.0f;
#pragma unroll
            for (int f = 0; f < F; ++f)
                s_rhs[f][tid] = w < W ? v * Xy[src + f] : 0.0f;
        }
        __syncthreads();

        const int n = min(CH, W - c0);  // a multiple of 8
        for (int k = lane * V; k < n; k += 32 * V) {
            float rv[F][V];
#pragma unroll
            for (int f = 0; f < F; ++f)
#pragma unroll
                for (int e = 0; e < V; e += 4) {
                    const float4 v4 =
                        *reinterpret_cast<const float4*>(&s_rhs[f][k + e]);
                    rv[f][e] = v4.x;
                    rv[f][e + 1] = v4.y;
                    rv[f][e + 2] = v4.z;
                    rv[f][e + 3] = v4.w;
                }
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                float tv[V];
                unpack16(*reinterpret_cast<const uint4*>(
                             w6b + (size_t)(warp * RPW + r) * W + c0 + k),
                         tv, T());
#pragma unroll
                for (int f = 0; f < F; ++f)
#pragma unroll
                    for (int e = 0; e < V; ++e) acc[r][f] += tv[e] * rv[f][e];
            }
        }
    }

    const size_t blk = (size_t)y * nb + b;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
            float v = acc[r][f];
#pragma unroll
            for (int off = 16; off > 0; off /= 2)
                v += __shfl_xor_sync(0xffffffffu, v, off);
            if (lane == 0)
                out[(blk * P + warp * RPW + r) * F + f] = MASK ? v : sig_w * v;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) sph_mask_tab_kernel(
    const T* __restrict__ w6, const float* __restrict__ S, long long s_bs,
    int F, const float* __restrict__ vw_b, const int* __restrict__ win,
    int M, int W, int Wu, float sig_w, float thr, int use_alpha,
    float* __restrict__ sm)
{
    rows_tab_body<T, 1, true>(w6, S, s_bs, F, vw_b, win, M, W, Wu, sig_w, thr,
                              use_alpha, sm);
}

template <typename T, int F>
__global__ void __launch_bounds__(THREADS) sph_blur_tab_kernel(
    const T* __restrict__ w6, const float* __restrict__ X, long long x_bs,
    const float* __restrict__ vw_b, const int* __restrict__ win,
    int M, int W, int Wu, float sig_w, float* __restrict__ out)
{
    rows_tab_body<T, F, false>(w6, X, x_bs, F, vw_b, win, M, W, Wu, sig_w,
                               0.0f, 0, out);
}

bool bad_grid(int P_, int nb, int B, int W, int M) {
    return P_ != P || nb <= 0 || B <= 0 || B > 65535 || W <= 0 || W % 8
        || M <= 0 || W % M;
}

template <typename T>
int fwd_tab(const void* md, const void* w6, const float* gsum, const float* S,
            long long s_bs, const float* ab, long long ab_bs, const float* vw,
            const int* win, int B, int nb, int D, int M, int W, int Wu,
            float sig_w, float sig_g, float thr, int use_alpha, float* ga,
            float* sm, cudaStream_t st) {
    const dim3 grid(nb, B);
    const T* m = static_cast<const T*>(md);
    const T* w = static_cast<const T*>(w6);
    if (D == 2) {
        sph_fwd_tab_kernel<T, 2, 16><<<grid, THREADS, 0, st>>>(
            m, w, gsum, S, s_bs, ab, ab_bs, vw, win, M, W, Wu, sig_w, sig_g,
            thr, use_alpha, ga, sm);
    } else if (D == 3) {
        sph_fwd_tab_kernel<T, 3, 16><<<grid, THREADS, 0, st>>>(
            m, w, gsum, S, s_bs, ab, ab_bs, vw, win, M, W, Wu, sig_w, sig_g,
            thr, use_alpha, ga, sm);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <typename T>
int bwd_tab(const void* md, const float* vs, const float* gsum,
            const float* gb, long long gb_bs, const float* G, long long g_bs,
            const int* win, int B, int nb, int D, int M, int W, int Wu,
            float sig_g, float* da, cudaStream_t st) {
    const dim3 grid(nb, B);
    const T* m = static_cast<const T*>(md);
    if (D == 2) {
        sph_bwd_tab_kernel<T, 2, 16><<<grid, THREADS, 0, st>>>(
            m, vs, gsum, gb, gb_bs, G, g_bs, win, M, W, Wu, sig_g, da);
    } else if (D == 3) {
        sph_bwd_tab_kernel<T, 3, 16><<<grid, THREADS, 0, st>>>(
            m, vs, gsum, gb, gb_bs, G, g_bs, win, M, W, Wu, sig_g, da);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <typename T>
int mask_tab(const void* w6, const float* S, long long s_bs, int F,
             const float* vw, const int* win, int B, int nb, int M, int W,
             int Wu, float sig_w, float thr, int use_alpha, float* sm,
             cudaStream_t st) {
    sph_mask_tab_kernel<T><<<dim3(nb, B), THREADS, 0, st>>>(
        static_cast<const T*>(w6), S, s_bs, F, vw, win, M, W, Wu, sig_w, thr,
        use_alpha, sm);
    return (int)cudaGetLastError();
}

template <typename T>
int blur_tab(const void* w6, const float* X, long long x_bs, int F,
             const float* vw, const int* win, int B, int nb, int M, int W,
             int Wu, float sig_w, float* out, cudaStream_t st) {
    if (F != 4) return (int)cudaErrorInvalidValue;  // the diffusion's [m, m t]
    sph_blur_tab_kernel<T, 4><<<dim3(nb, B), THREADS, 0, st>>>(
        static_cast<const T*>(w6), X, x_bs, vw, win, M, W, Wu, sig_w, out);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C launchers for ctypes: raw device pointers, sizes, sample strides,
// the table type (0 = float32, 1 = bfloat16) and the caller's stream; the grid
// is (nb blocks, B samples). Each returns the cudaGetLastError() code of its
// launch (0 = ok).

extern "C" int sph_fwd_tab_launch(
    int bf16, const void* md, const void* w6, const float* gsum,
    const float* S, long long s_bs, const float* ab, long long ab_bs,
    const float* vw, const int* win, int B, int nb, int D, int F, int P_,
    int M, int W, int Wu, float sig_w, float sig_g, float thr, int use_alpha,
    float* ga, float* sm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bad_grid(P_, nb, B, W, M) || F != 16) return (int)cudaErrorInvalidValue;
    return bf16
        ? fwd_tab<__nv_bfloat16>(md, w6, gsum, S, s_bs, ab, ab_bs, vw, win, B,
                                 nb, D, M, W, Wu, sig_w, sig_g, thr,
                                 use_alpha, ga, sm, st)
        : fwd_tab<float>(md, w6, gsum, S, s_bs, ab, ab_bs, vw, win, B, nb, D,
                         M, W, Wu, sig_w, sig_g, thr, use_alpha, ga, sm, st);
}

extern "C" int sph_bwd_tab_launch(
    int bf16, const void* md, const float* vs, const float* gsum,
    const float* gb, long long gb_bs, const float* G, long long g_bs,
    const int* win, int B, int nb, int D, int F, int P_, int M, int W, int Wu,
    float sig_g, float* da, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bad_grid(P_, nb, B, W, M) || F != 16) return (int)cudaErrorInvalidValue;
    return bf16
        ? bwd_tab<__nv_bfloat16>(md, vs, gsum, gb, gb_bs, G, g_bs, win, B, nb,
                                 D, M, W, Wu, sig_g, da, st)
        : bwd_tab<float>(md, vs, gsum, gb, gb_bs, G, g_bs, win, B, nb, D, M, W,
                         Wu, sig_g, da, st);
}

extern "C" int sph_mask_tab_launch(
    int bf16, const void* w6, const float* S, long long s_bs, int F,
    const float* vw, const int* win, int B, int nb, int P_, int M, int W,
    int Wu, float sig_w, float thr, int use_alpha, float* sm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bad_grid(P_, nb, B, W, M) || F < 4) return (int)cudaErrorInvalidValue;
    return bf16
        ? mask_tab<__nv_bfloat16>(w6, S, s_bs, F, vw, win, B, nb, M, W, Wu,
                                  sig_w, thr, use_alpha, sm, st)
        : mask_tab<float>(w6, S, s_bs, F, vw, win, B, nb, M, W, Wu, sig_w,
                          thr, use_alpha, sm, st);
}

extern "C" int sph_blur_tab_launch(
    int bf16, const void* w6, const float* X, long long x_bs, int F,
    const float* vw, const int* win, int B, int nb, int P_, int M, int W,
    int Wu, float sig_w, float* out, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bad_grid(P_, nb, B, W, M)) return (int)cudaErrorInvalidValue;
    return bf16
        ? blur_tab<__nv_bfloat16>(w6, X, x_bs, F, vw, win, B, nb, M, W, Wu,
                                  sig_w, out, st)
        : blur_tab<float>(w6, X, x_bs, F, vw, win, B, nb, M, W, Wu, sig_w,
                          out, st);
}
