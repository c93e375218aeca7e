// Update-MLP kernel of the batched-lane cell path, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _mlp_kernel
// (sph_nca_tpu/ops/pallas/mlp_kernel.py:48, grid (row tiles, B) at :114-134).
// For every item n, one slot of one sample:
//
//   X = [S_n | gx_n | gy_n]          3F = 48 inputs (state, gA_x, gA_y)
//   H = relu(X @ W1k + b1)           hid hidden units, rounded to T
//   O = H @ W2 + b2                  K = 2F + 1 (gated) or F (orig)
//
// gated: gate = O[:F], delta = O[F:2F], mult = O[2F], all pre-activation;
// orig: dA = O. The perception scale h k is already folded into the gA rows
// of W1k by the caller (models/cell_step.py), as the JAX step folds it
// (cell_step.py:480-484). T is float or __nv_bfloat16 for the inputs and the
// two weight matrices; the biases and outputs are f32, every sum is f32, and
// H is rounded to T before the second product, as the TPU kernel rounds it
// (mlp_kernel.py:57).
//
// Layout. S is [n, F] with row stride ld_s; ga is [n, >= 2F] with row stride
// ld_ga, gx its first F columns and gy the next F (the per-sample d-major
// perception, whose z block, if any, the MLP does not read). On the port's
// batched path n = B * C * M, sample-major. The outputs are contiguous
// [n, F], [n, F] and [n].
//
// Bound on this card. At the training shapes (C * M = 20,224 slots, B = 8:
// 161,792 items, hid = 256, K = 33) a launch needs 2 (48 * 256 + 256 * 33) =
// 41,472 FLOP an item, 6.71 GFLOP, and moves ~52 MB (0.016 ms at 3.35 TB/s).
// On the tensor cores with f32 inputs the products are 3 TF32 products
// (below): 20.1 GFLOP, 0.041 ms at 495 TFLOP/s, so bound by OPERATIONS; with
// bf16 inputs (the batched gecko, 148,480 items) one bf16 product, 6.2 GFLOP
// (0.006 ms at 989 TFLOP/s) against ~34 MB (0.010 ms): bound by BYTES.
//
// Design. Persistent thread blocks of up to 8 warps stage the weights once
// in shared memory and stride over item tiles; each warp owns its tiles of
// ITEMS = 32 items (two m16 tiles) and double-buffers their X rows in shared
// memory with cp.async (16 bytes a request, from S and ga at their row
// strides; rows past n are zero-filled and never stored, so any n is taken).
// For each chunk of HC hidden units (32 f32, 64 bf16) a warp runs
//   layer 1: Z = X @ W1k[:, chunk] on mma.sync tiles (m16 x n8), the 2 x
//            HC / 8 tiles' sums in registers; then bias, relu and (bf16) the
//            rounding to T, in registers;
//   layer 2: O += H_chunk @ W2[chunk, :], with H fed straight from the
//            layer-1 accumulators as the A operand (FlashAttention-2's P V
//            trick): an m16n8 accumulator holds columns 2t, 2t+1 of row g,
//            the TF32 k8 A fragment wants t, t+4, so W2's rows are permuted
//            within each group of 8 at staging (k position t <- hidden 2t,
//            t + 4 <- 2t + 1); bf16's k16 fragment takes the accumulators'
//            pairs as they are.
// The [32 items, K] output sums (K = 33 padded to 40 columns, 5 n8 tiles)
// stay in registers across the chunks; H never leaves the registers. hid is
// padded with zero hidden units to a multiple of 64 (they add exact zeros).
//
// Arithmetic. f32 inputs: 3xTF32, x = big + small (mma_util.cuh), X and H
// split in registers as their fragments are made, the weights split in
// registers as their B fragments are read (the f32 weights are stored once,
// unsplit: split, they would take 176 KB at hid = 256 and 352 KB at hid =
// 512, which does not fit); acc += A_small B_big + A_big B_small + A_big B_big.
// bf16 inputs: one bf16 product (a product of two bf16 values is exact in
// f32). Either way, the tensor core truncates its f32 sums, so each k step's
// products start from zero and are added to the running sums in
// round-to-nearest f32 (the small terms, then the big one), as in the table
// kernels; tests/test_torch_mlp_split.py emulates the scheme on the CPU.
//
// mma.sync rather than wgmma: both layers take their A operand from
// registers (X's split fragments, H from the accumulators), every k step's
// products go into fresh sums that are added in round-to-nearest f32, and
// the f32 weights are split as they are read; wgmma reads TF32 B operands
// from shared memory only, K-major, so the split weights would have to be
// staged twice, and 64-item M tiles per warpgroup would double the
// accumulators the RN sums keep. The weights' shared-memory rows are padded
// (W1k^T and W2^T rows of 52 / 56 elements and hid + 4 / hid + 8) so that
// every fragment read is free of bank conflicts. ptxas (sm_90a, CUDA 12.8):
// f32 157 (K = 16) and 255 (K = 33) registers, bf16 153 and 179, the fused
// variant 189 and 189, none spilled (one block of 8 warps an SM:
// __launch_bounds__(256, 1)); chip_smoke.py prints the counts of the build
// it runs.
//
// The fused variant (sph_mlp_kernel<K>, bf16, F = 16, three axes) is the
// whole update of the batched surface step on a band engine, from the md
// pass's raw moments to the pre-life-mask state. It replaces no TPU kernel:
// on the TPU, XLA fused the same glue (the gradient's finish, the tangent
// projection, the casts, the rule and the fire select) around the Pallas
// call; in PyTorch it was ~35 launches over [B, nb, P, 16..48] tensors,
// ~3 GB a step at the benchmark's shape. Per row it stages, with cp.async
// into two Raw buffers a warp, the row's three moments (bf16), its state
// (f32), tangent, normal, self term and fire draw; builds the row of X in
// shared memory, rounded where PyTorch's composition rounds:
//   ga_a = bf16(bf16(sg mom_a) - bf16(bf16(S) bf16(gsum_a)))
//   b = n x t, proj_e = ((ga_0 e_0 + ga_1 e_1) + ga_2 e_2) in f32
//   X = [bf16(S) | bf16(proj_t) | bf16(proj_b)]
// (every f32 product and sum rounded on its own, __fmul_rn / __fadd_rn, so
// nothing contracts into an FMA); runs the same two products, so the MLP's
// outputs are bit-equal to kernel 2.8's on the composition's rows; then the
// gated rule fl(fl(S sigmoid(g)) + fl(tanh(d) sigmoid(m))) (m passed from
// the quad's lane t = 0 by a shuffle) or the orig rule S + dA scale, and
// the select u <= fire_rate ? nS : S, with sigmoid 1 / (1 + expf(-x)) and
// tanhf as PyTorch's kernels compute them (no fast math). Bound on this
// card at the benchmark's shape (B = 8, 1600 blocks of 64 rows: 819,200
// rows, hid = 256, K = 33): 96 B of moments, 64 B of state, 16 B of
// tangent and draw, 64 B out a row and 24 B a block row shared by the 8
// samples, ~199 MB (0.059 ms at 3.35 TB/s) against 34.0 GFLOP (0.034 ms
// at 989 TFLOP/s): bound by BYTES.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "mma_util.cuh"

namespace {

constexpr int F = 16;          // channels
constexpr int IN = 3 * F;      // MLP inputs
constexpr int HID_MAX = 512;
constexpr int HPAD = 64;       // hid is padded to a multiple of this
constexpr int MT = 2;          // m16 tiles a warp
constexpr int ITEMS = 16 * MT; // items a warp tile
constexpr int NW_MAX = 8;      // warps a thread block

// Per input type: k of one product, the hidden units of a chunk (f32 keeps
// half as many layer-1 sums as bf16 in registers: at 64, ptxas spilled), the
// row stride (elements) of X and of W1k^T in shared memory, and the padding
// of W2^T's rows.
template <typename T> struct Mlp;
template <> struct Mlp<float> {
    static constexpr int KS = 8;
    static constexpr int HC = 32;
    static constexpr int XS = IN + 4;   // 208 B: conflict-free fragments
    static constexpr int W2PAD = 4;
};
template <> struct Mlp<__nv_bfloat16> {
    static constexpr int KS = 16;
    static constexpr int HC = 64;
    static constexpr int XS = IN + 8;   // 112 B
    static constexpr int W2PAD = 8;
};

// Shared-memory layout (bytes) for hid hidden units and K outputs: W1k^T
// [hidP][XS], W2^T [NO8][hidP + W2PAD] (f32: hidden rows permuted in groups
// of 8), b1 [hidP], b2 [NO8], then each warp's two X buffers [ITEMS][XS].
template <typename T, int K>
struct Layout {
    static constexpr int NO8 = (K + 7) / 8 * 8;
    int hidP, w2, b1, b2, x;
    __host__ __device__ explicit Layout(int hid)
        : hidP((hid + HPAD - 1) / HPAD * HPAD) {
        w2 = hidP * Mlp<T>::XS * (int)sizeof(T);
        b1 = w2 + NO8 * (hidP + Mlp<T>::W2PAD) * (int)sizeof(T);
        b2 = b1 + hidP * 4;
        x = b2 + NO8 * 4;
    }
    __host__ __device__ static constexpr int per_warp() {
        return 2 * ITEMS * Mlp<T>::XS * (int)sizeof(T);
    }
    __host__ __device__ int bytes(int nw) const { return x + nw * per_warp(); }
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>()
{
    return __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p)
{
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                    "r"(bytes)
                 : "memory");
}

// The X rows of item tile `tile` into dst [ITEMS][XS]: per row its S (F
// values) and the first 2F values of ga, 16 bytes a request; rows past n
// are filled with zeros.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, long long tile,
                                          const T* __restrict__ S,
                                          long long ld_s,
                                          const T* __restrict__ ga,
                                          long long ld_ga, long long n,
                                          int lane)
{
    constexpr int E = 16 / (int)sizeof(T);  // values a request
    constexpr int CS = F / E;               // requests of S a row
    constexpr int CR = IN / E;              // requests a row
    static_assert(ITEMS * CR % 32 == 0, "whole requests a lane");
#pragma unroll
    for (int u = 0; u < ITEMS * CR / 32; ++u) {
        const int i = u * 32 + lane;
        const int r = i / CR, c = i - r * CR;
        const long long item = tile * ITEMS + r;
        const long long src = item < n ? item : 0;
        const T* p = c < CS ? S + src * ld_s + c * E
                            : ga + src * ld_ga + (c - CS) * E;
        cp_async16(dst + r * Mlp<T>::XS + c * E, p, item < n ? 16 : 0);
    }
}

// store(i, load(i)) for i < n over the block's threads, with SU loads in
// flight a thread before their stores (the weights are staged once a block:
// one load at a time, each an L2 round trip, took a large part of a launch)
constexpr int SU = 16;

template <typename V, typename Load, typename Store>
__device__ __forceinline__ void stage(int n, Load load, Store store)
{
    for (int i0 = threadIdx.x; i0 < n; i0 += SU * blockDim.x) {
        V v[SU];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
            const int i = i0 + u * blockDim.x;
            if (i < n) v[u] = load(i);
        }
#pragma unroll
        for (int u = 0; u < SU; ++u) {
            const int i = i0 + u * blockDim.x;
            if (i < n) store(i, v[u]);
        }
    }
}

// ---- fragments and the products of one k step ----------------------------

// f32: A fragment (rows r0 + g, r0 + g + 8; k columns t, t + 4) of X from a
// row-major [.., XS] tile at column k0, split into big and small
struct AF32 {
    uint32_t big[4], small[4];
    __device__ __forceinline__ void set(float a0, float a1, float a2,
                                        float a3) {
        split(a0, big[0], small[0]);
        split(a1, big[1], small[1]);
        split(a2, big[2], small[2]);
        split(a3, big[3], small[3]);
    }
};
struct BF32 {
    uint32_t big[2], small[2];
    // row p: k-contiguous weights of output column g at the step's k0
    __device__ __forceinline__ void load(const float* p, int t) {
        split(p[t], big[0], small[0]);
        split(p[t + 4], big[1], small[1]);
    }
};

__device__ __forceinline__ void step(float* acc, const AF32& a,
                                     const BF32& b)
{
    float c[4];
    mma_tf32(c, a.small, b.big[0], b.big[1]);
    mma_tf32_acc(c, a.big, b.small[0], b.small[1]);
    add4(acc, c);
    mma_tf32(c, a.big, b.big[0], b.big[1]);
    add4(acc, c);
}

// bf16: A fragment (rows g, g + 8; k pairs 2t, 2t + 8), two values a register
struct ABF {
    uint32_t r[4];
};
struct BBF {
    uint32_t r[2];
    __device__ __forceinline__ void load(const __nv_bfloat16* p, int t) {
        r[0] = word(p + 2 * t);
        r[1] = word(p + 2 * t + 8);
    }
};

__device__ __forceinline__ void step(float* acc, const ABF& a, const BBF& b)
{
    float c[4];
    mma_bf16(c, a.r, b.r[0], b.r[1]);
    add4(acc, c);
}

template <typename T> struct Frag;
template <> struct Frag<float> {
    using A = AF32;
    using B = BF32;
    // X rows x0 (row g) and x8 (row g + 8), at the step's k0
    static __device__ __forceinline__ A from_x(const float* x0,
                                               const float* x8, int t) {
        A a;
        a.set(x0[t], x8[t], x0[t + 4], x8[t + 4]);
        return a;
    }
    // H of layer-1 tile j (hidden 8j .. 8j + 7 of the chunk): c0 (g, 2t),
    // c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1) at k positions t,
    // t + 4, t, t + 4 (W2^T's rows are permuted to match)
    static __device__ __forceinline__ A from_h(const float (*h)[4], int kk) {
        A a;
        a.set(h[kk][0], h[kk][2], h[kk][1], h[kk][3]);
        return a;
    }
};
template <> struct Frag<__nv_bfloat16> {
    using A = ABF;
    using B = BBF;
    static __device__ __forceinline__ A from_x(const __nv_bfloat16* x0,
                                               const __nv_bfloat16* x8,
                                               int t) {
        A a;
        a.r[0] = word(x0 + 2 * t);
        a.r[1] = word(x8 + 2 * t);
        a.r[2] = word(x0 + 2 * t + 8);
        a.r[3] = word(x8 + 2 * t + 8);
        return a;
    }
    // H of layer-1 tiles 2kk and 2kk + 1 (hidden 16kk .. 16kk + 15 of the
    // chunk), rounded to bf16 here
    static __device__ __forceinline__ A from_h(const float (*h)[4], int kk) {
        A a;
        a.r[0] = pack(h[2 * kk][0], h[2 * kk][1]);
        a.r[1] = pack(h[2 * kk][2], h[2 * kk][3]);
        a.r[2] = pack(h[2 * kk + 1][0], h[2 * kk + 1][1]);
        a.r[3] = pack(h[2 * kk + 1][2], h[2 * kk + 1][3]);
        return a;
    }
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<const uint32_t*>(&v);
    }
};

// ---- the two products, shared by both variants -----------------------------

// The weights, once a block, into shared memory: W1k^T, W2^T (f32: rows
// permuted), b1, b2 (the caller synchronizes the block after it)
template <typename T, int K>
__device__ __forceinline__ void stage_weights(
    unsigned char* smem, const Layout<T, K>& lay, const T* __restrict__ w1k,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, int hid)
{
    constexpr int XS = Mlp<T>::XS;
    constexpr int NO = (K + 7) / 8;
    const int hidP = lay.hidP;
    const int w2s_ld = hidP + Mlp<T>::W2PAD;
    T* w1s = reinterpret_cast<T*>(smem);
    T* w2s = reinterpret_cast<T*>(smem + lay.w2);
    float* b1s = reinterpret_cast<float*>(smem + lay.b1);
    float* b2s = reinterpret_cast<float*>(smem + lay.b2);
    stage<T>(IN * hidP, [&](int i) {
        const int k = i / hidP, j = i - k * hidP;  // coalesced over j
        return j < hid ? w1k[(size_t)k * hid + j] : zero<T>();
    }, [&](int i, T v) {
        const int k = i / hidP, j = i - k * hidP;
        w1s[j * XS + k] = v;
    });
    stage<T>(NO * 8 * hidP, [&](int i) {
        const int o = i / hidP, p = i - o * hidP, q = p & 7;
        const int hu = sizeof(T) == 4 ? (p - q) + (q < 4 ? 2 * q : 2 * q - 7)
                                      : p;
        return o < K && hu < hid ? w2[(size_t)hu * K + o] : zero<T>();
    }, [&](int i, T v) { w2s[i / hidP * w2s_ld + i % hidP] = v; });
    stage<float>(hidP, [&](int j) { return j < hid ? b1[j] : 0.0f; },
                 [&](int j, float v) { b1s[j] = v; });
    stage<float>(NO * 8, [&](int o) { return o < K ? b2[o] : 0.0f; },
                 [&](int o, float v) { b2s[o] = v; });
}

// O = relu(X @ W1k + b1) @ W2 (b2 not added) for the warp tile whose X rows
// xt [ITEMS][XS] are in shared memory: o[m][j] holds the m16 x n8 sums of
// rows 16m + (g, g + 8), columns 8j + (2t, 2t + 1)
template <typename T, int K>
__device__ __forceinline__ void tile_products(
    const unsigned char* smem, const Layout<T, K>& lay, const T* xt, int g,
    int t, float (&o)[MT][(K + 7) / 8][4])
{
    using C = Mlp<T>;
    using Fr = Frag<T>;
    constexpr int KS = C::KS;
    constexpr int XS = C::XS;
    constexpr int NO = (K + 7) / 8;     // n8 output tiles
    constexpr int HC = C::HC;
    constexpr int NJ = HC / 8;          // n8 tiles of a chunk
    const int hidP = lay.hidP;
    const int w2s_ld = hidP + C::W2PAD;
    const T* w1s = reinterpret_cast<const T*>(smem);
    const T* w2s = reinterpret_cast<const T*>(smem + lay.w2);
    const float* b1s = reinterpret_cast<const float*>(smem + lay.b1);

#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[m][j][e] = 0.0f;

    for (int h0 = 0; h0 < hidP; h0 += HC) {
        // ---- layer 1: Z = X @ W1k[:, h0 .. h0 + HC) ----
        float z[MT][NJ][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) z[m][j][e] = 0.0f;
#pragma unroll
        for (int k0 = 0; k0 < IN; k0 += KS) {
            // each step's shared-memory reads stay in it: hoisting them
            // across steps took 255 registers and spilled (f32, K = 33)
            asm volatile("" ::: "memory");
            typename Fr::A a[MT];
#pragma unroll
            for (int m = 0; m < MT; ++m)
                a[m] = Fr::from_x(xt + (m * 16 + g) * XS + k0,
                                  xt + (m * 16 + g + 8) * XS + k0, t);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                typename Fr::B bw;
                bw.load(w1s + (h0 + 8 * j + g) * XS + k0, t);
#pragma unroll
                for (int m = 0; m < MT; ++m) step(z[m][j], a[m], bw);
            }
        }
        // ---- H = relu(Z + b1), in registers ----
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const float2 bb = *reinterpret_cast<const float2*>(
                b1s + h0 + 8 * j + 2 * t);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                z[m][j][0] = fmaxf(z[m][j][0] + bb.x, 0.0f);
                z[m][j][1] = fmaxf(z[m][j][1] + bb.y, 0.0f);
                z[m][j][2] = fmaxf(z[m][j][2] + bb.x, 0.0f);
                z[m][j][3] = fmaxf(z[m][j][3] + bb.y, 0.0f);
            }
        }
        // ---- layer 2: O += H @ W2[h0 .. h0 + HC, :] ----
#pragma unroll
        for (int kk = 0; kk < HC / KS; ++kk) {
            asm volatile("" ::: "memory");
            typename Fr::A a[MT];
#pragma unroll
            for (int m = 0; m < MT; ++m) a[m] = Fr::from_h(z[m], kk);
#pragma unroll
            for (int j = 0; j < NO; ++j) {
                typename Fr::B bw;
                bw.load(w2s + (j * 8 + g) * w2s_ld + h0 + kk * KS, t);
#pragma unroll
                for (int m = 0; m < MT; ++m) step(o[m][j], a[m], bw);
            }
        }
    }
}

// ---- kernel 2.8: rows in, the MLP's outputs out ----------------------------

template <typename T, int K>
__global__ void __launch_bounds__(NW_MAX * 32, 1) sph_mlp_kernel(
    const T* __restrict__ S, long long ld_s,
    const T* __restrict__ ga, long long ld_ga,
    const T* __restrict__ w1k,  // [IN, hid]
    const float* __restrict__ b1,  // [hid]
    const T* __restrict__ w2,  // [hid, K]
    const float* __restrict__ b2,  // [K]
    long long n, int hid,
    float* __restrict__ gate, float* __restrict__ delta,
    float* __restrict__ mult)
{
    constexpr int XS = Mlp<T>::XS;
    constexpr int NO = (K + 7) / 8;
    const Layout<T, K> lay(hid);
    extern __shared__ __align__(16) unsigned char smem[];
    stage_weights<T, K>(smem, lay, w1k, b1, w2, b2, hid);
    __syncthreads();

    const int nw = blockDim.x / 32;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    T* xw = reinterpret_cast<T*>(smem + lay.x) + (size_t)warp * 2 * ITEMS * XS;
    const long long ntiles = (n + ITEMS - 1) / ITEMS;
    const long long stride = (long long)gridDim.x * nw;
    long long tile = (long long)blockIdx.x * nw + warp;
    if (tile < ntiles) load_tile(xw, tile, S, ld_s, ga, ld_ga, n, lane);
    asm volatile("cp.async.commit_group;" ::: "memory");

    for (int it = 0; tile < ntiles; tile += stride, ++it) {
        const T* xt = xw + (it & 1) * ITEMS * XS;
        if (tile + stride < ntiles)
            load_tile(xw + ((it + 1) & 1) * ITEMS * XS, tile + stride, S,
                      ld_s, ga, ld_ga, n, lane);
        asm volatile("cp.async.commit_group;" ::: "memory");
        asm volatile("cp.async.wait_group 1;" ::: "memory");
        __syncwarp();

        float o[MT][NO][4];
        tile_products<T, K>(smem, lay, xt, g, t, o);
        __syncwarp();  // the tile's X rows are read: its buffer may refill

        // ---- O + b2 -> gate | delta | mult ----
        const float* b2s = reinterpret_cast<const float*>(smem + lay.b2);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int up = 0; up < 2; ++up) {
                const long long item = tile * ITEMS + m * 16 + g + 8 * up;
                if (item >= n) continue;
#pragma unroll
                for (int j = 0; j < NO; ++j) {
                    const int col = j * 8 + 2 * t;
                    const float v0 = o[m][j][2 * up] + b2s[col];
                    const float v1 = o[m][j][2 * up + 1] + b2s[col + 1];
                    if (col < F) {
                        *reinterpret_cast<float2*>(gate + item * F + col) =
                            make_float2(v0, v1);
                    } else if (col < 2 * F) {
                        *reinterpret_cast<float2*>(
                            delta + item * F + col - F) = make_float2(v0, v1);
                    } else if (col == 2 * F) {
                        mult[item] = v0;
                    }
                }
            }
        }
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ---- kernel 2.8, fused variant: band moments in, the pre-mask state out ----

// What the fused variant reads and writes. Items are (sample b, block c,
// row p), item = (b * nb + c) * P + p, the order of S [B, nb, P, F].
struct Fused {
    const __nv_bfloat16* mom;  // [nb, 3P, B*F]: the md pass's raw moments
    const float* S;            // [B, nb, P, F]
    const float* gsum;         // [nb, P, 3]: the gradient's self term
    const float* tan[3];       // [B, nb, P]: the tangents' components,
    long long ts[3];           // at these strides (sample, block, row)
    const float* nrm[3];       // [nb, P]: the normals' components
    const float* u;            // [B, nb, P]: the fire draws
    long long np;              // nb * P
    int p, bf;                 // P, B * F
    float sg;                  // sigma_g rounded to bf16
    float fire_rate, scale;    // the fire test; the orig rule's factor
    float* out;                // [B, nb, P, F]
};

// One warp tile's inputs as they lie in device memory: the rows' states,
// their three moments, and ten scalars a row (tangent, fire draw, normal,
// self term)
constexpr int NSC = 10;
struct Raw {
    float s[ITEMS][F];
    __nv_bfloat16 m[ITEMS][3][F];
    float sc[NSC][ITEMS];
};

// A warp's shared memory past the weights: its X rows and two Raw buffers
__host__ __device__ constexpr int fused_per_warp()
{
    return ITEMS * Mlp<__nv_bfloat16>::XS * 2 + 2 * (int)sizeof(Raw);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                    "r"(bytes)
                 : "memory");
}

// The tile's raw inputs into dst, 20 requests a lane: its own row's
// scalars, then the states (16 bytes a request) and the moments (16 bytes,
// each row's base found by the lane that owns the row). Rows past n read
// zeros.
__device__ __forceinline__ void load_raw(Raw* dst, long long tile,
                                         const Fused& f, long long n,
                                         int lane)
{
    const long long first = tile * ITEMS;
    const long long item = first + lane;
    const int ok = item < n ? 4 : 0;
    const long long it = ok ? item : 0;
    const long long b = it / f.np, cp = it - b * f.np;
    const long long c = cp / f.p, p = cp - c * f.p;
    // mom[c, axis * P + p, b * F + f]: axis 0 here
    const long long mrow = (c * 3 * f.p + p) * f.bf + b * F;
    const long long tk = b * f.ts[0] + c * f.ts[1] + p * f.ts[2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        cp_async4(&dst->sc[a][lane], f.tan[a] + tk, ok);
        cp_async4(&dst->sc[4 + a][lane], f.nrm[a] + cp, ok);
        cp_async4(&dst->sc[7 + a][lane], f.gsum + cp * 3 + a, ok);
    }
    cp_async4(&dst->sc[3][lane], f.u + it, ok);
#pragma unroll
    for (int k = 0; k < ITEMS * F / 4 / 32; ++k) {
        const int i = k * 32 + lane, r = i / 4, q = i % 4;
        const bool in = first + r < n;
        cp_async16(&dst->s[r][4 * q], f.S + (in ? first + r : 0) * F + 4 * q,
                   in ? 16 : 0);
    }
#pragma unroll
    for (int k = 0; k < ITEMS * 6 / 32; ++k) {
        const int i = k * 32 + lane, r = i / 6, a = i % 6 / 2, h = i % 2;
        const long long base = __shfl_sync(0xffffffffu, mrow, r);
        cp_async16(&dst->m[r][a][8 * h],
                   f.mom + base + (long long)a * f.p * f.bf + 8 * h,
                   first + r < n ? 16 : 0);
    }
}

__device__ __forceinline__ float bf16r(float x)
{
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The MLP's input rows [bf16(S) | bf16(ga . t) | bf16(ga . (n x t))] of the
// tile from its raw inputs, rounded where PyTorch's composition rounds
// (models/cell_step.py; ops/bands.py band_gradient; ops/mlp_kernel.py
// project_td): ga_a = bf16(bf16(sg mom_a) - bf16(bf16(S) bf16(gsum_a))), the
// bitangent and the projections in f32, each product and sum rounded on its
// own (no FMA). A lane takes 4 channels of a row, 8 rows a pass.
__device__ __forceinline__ void build_x(__nv_bfloat16* x, const Raw* raw,
                                        float sg, int lane)
{
    constexpr int XS = Mlp<__nv_bfloat16>::XS;
#pragma unroll
    for (int q = 0; q < ITEMS / 8; ++q) {
        const int r = q * 8 + lane / 4, k0 = lane % 4 * 4;
        float tv[3], nv[3], gs[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            tv[a] = raw->sc[a][r];
            nv[a] = raw->sc[4 + a][r];
            gs[a] = bf16r(raw->sc[7 + a][r]);
        }
        const float bt[3] = {
            __fsub_rn(__fmul_rn(nv[1], tv[2]), __fmul_rn(nv[2], tv[1])),
            __fsub_rn(__fmul_rn(nv[2], tv[0]), __fmul_rn(nv[0], tv[2])),
            __fsub_rn(__fmul_rn(nv[0], tv[1]), __fmul_rn(nv[1], tv[0]))};
        const float4 s4 = *reinterpret_cast<const float4*>(&raw->s[r][k0]);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        float xs[4], xt[4], xb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float xo = bf16r(sv[j]);
            float gv[3];
#pragma unroll
            for (int a = 0; a < 3; ++a)
                gv[a] = bf16r(__fsub_rn(
                    bf16r(__fmul_rn(sg,
                                    __bfloat162float(raw->m[r][a][k0 + j]))),
                    bf16r(__fmul_rn(xo, gs[a]))));
            const float pt = __fadd_rn(
                __fadd_rn(__fmul_rn(gv[0], tv[0]), __fmul_rn(gv[1], tv[1])),
                __fmul_rn(gv[2], tv[2]));
            const float pb = __fadd_rn(
                __fadd_rn(__fmul_rn(gv[0], bt[0]), __fmul_rn(gv[1], bt[1])),
                __fmul_rn(gv[2], bt[2]));
            xs[j] = xo;
            xt[j] = pt;
            xb[j] = pb;
        }
        using Fr = Frag<__nv_bfloat16>;  // pack() rounds to nearest
        *reinterpret_cast<uint2*>(x + r * XS + k0) =
            make_uint2(Fr::pack(xs[0], xs[1]), Fr::pack(xs[2], xs[3]));
        *reinterpret_cast<uint2*>(x + r * XS + F + k0) =
            make_uint2(Fr::pack(xt[0], xt[1]), Fr::pack(xt[2], xt[3]));
        *reinterpret_cast<uint2*>(x + r * XS + 2 * F + k0) =
            make_uint2(Fr::pack(xb[0], xb[1]), Fr::pack(xb[2], xb[3]));
    }
}

// sigmoid as PyTorch's CUDA kernel computes it in f32
__device__ __forceinline__ float sigm(float x)
{
    return 1.0f / (1.0f + expf(-x));
}

template <int K>
__global__ void __launch_bounds__(NW_MAX * 32, 1) sph_mlp_kernel(
    const Fused f,
    const __nv_bfloat16* __restrict__ w1k,  // [IN, hid]
    const float* __restrict__ b1,  // [hid]
    const __nv_bfloat16* __restrict__ w2,  // [hid, K]
    const float* __restrict__ b2,  // [K]
    long long n, int hid)
{
    using T = __nv_bfloat16;
    constexpr int XS = Mlp<T>::XS;
    constexpr int NO = (K + 7) / 8;
    constexpr bool GATED = K == 2 * F + 1;
    const Layout<T, K> lay(hid);
    extern __shared__ __align__(16) unsigned char smem[];
    stage_weights<T, K>(smem, lay, w1k, b1, w2, b2, hid);
    __syncthreads();
    const float* b2s = reinterpret_cast<const float*>(smem + lay.b2);

    const int nw = blockDim.x / 32;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    unsigned char* wbase = smem + lay.x + (size_t)warp * fused_per_warp();
    T* xt = reinterpret_cast<T*>(wbase);
    Raw* raw = reinterpret_cast<Raw*>(wbase + ITEMS * XS * sizeof(T));
    const long long ntiles = (n + ITEMS - 1) / ITEMS;
    const long long stride = (long long)gridDim.x * nw;
    long long tile = (long long)blockIdx.x * nw + warp;
    if (tile < ntiles) load_raw(raw, tile, f, n, lane);
    asm volatile("cp.async.commit_group;" ::: "memory");

    for (int it = 0; tile < ntiles; tile += stride, ++it) {
        const Raw* rt = raw + (it & 1);
        if (tile + stride < ntiles)
            load_raw(raw + ((it + 1) & 1), tile + stride, f, n, lane);
        asm volatile("cp.async.commit_group;" ::: "memory");
        asm volatile("cp.async.wait_group 1;" ::: "memory");
        __syncwarp();
        build_x(xt, rt, f.sg, lane);
        __syncwarp();

        float o[MT][NO][4];
        tile_products<T, K>(smem, lay, xt, g, t, o);

        // ---- the rule and the fire select, per row and channel pair ----
        // every channel of a row needs its mult column (K - 1), which the
        // quad's lane t = 0 holds
        float mv[MT][2] = {};
        if constexpr (GATED) {
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int up = 0; up < 2; ++up)
                    mv[m][up] = sigm(__shfl_sync(
                        0xffffffffu, o[m][NO - 1][2 * up] + b2s[2 * F],
                        lane & ~3));
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int up = 0; up < 2; ++up) {
                const int r = m * 16 + g + 8 * up;
                const long long item = tile * ITEMS + r;
                if (item >= n) continue;
                const bool fire = rt->sc[3][r] <= f.fire_rate;
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                    const int col = jj * 8 + 2 * t;
                    const float2 s2 =
                        *reinterpret_cast<const float2*>(&rt->s[r][col]);
                    const float sv[2] = {s2.x, s2.y};
                    float nv[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float gv = o[m][jj][2 * up + e] + b2s[col + e];
                        if constexpr (GATED) {
                            const float dv = o[m][jj + 2][2 * up + e]
                                             + b2s[F + col + e];
                            nv[e] = __fadd_rn(__fmul_rn(sv[e], sigm(gv)),
                                              __fmul_rn(tanhf(dv),
                                                        mv[m][up]));
                        } else {
                            nv[e] = __fadd_rn(sv[e], __fmul_rn(gv, f.scale));
                        }
                    }
                    *reinterpret_cast<float2*>(f.out + item * F + col) =
                        fire ? make_float2(nv[0], nv[1]) : s2;
                }
            }
        }
        __syncwarp();  // the tile's rows are read: its buffers may refill
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The launch shape for (kernel, device, hid), worked out on its first
// launch: the warps a block (up to NW_MAX, as many as the weights leave
// shared memory for, at per_warp bytes a warp past the weights), the
// dynamic shared memory, and the blocks that fit on the card at once (the
// occupancy calculator). Later launches read the cache.
struct Shape {
    int nw, smem;
    long long most;
};

cudaError_t launch_shape(const void* kern, int dev, int hid, int weights,
                         int per_warp, Shape* out)
{
    static std::mutex mu;
    static std::map<std::tuple<const void*, int, int>, Shape> cache;
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(kern, dev, hid);
    const auto it = cache.find(key);
    if (it != cache.end()) {
        *out = it->second;
        return cudaSuccess;
    }
    cudaFuncAttributes fa;
    int optin = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return err;
    const int room = optin - (int)fa.sharedSizeBytes;
    int nw = NW_MAX;
    while (nw > 1 && weights + nw * per_warp > room) --nw;
    if (weights + nw * per_warp > room) return cudaErrorInvalidValue;
    Shape sh{nw, weights + nw * per_warp, 0};
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, room))
            != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kern, 32 * nw, sh.smem)) != cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    sh.most = (long long)sms * per_sm;
    *out = cache[key] = sh;
    return cudaSuccess;
}

// The blocks of a launch over n items: enough for every warp tile, at most
// as many as fit on the card at once (the blocks stride over the tiles)
int blocks_for(long long n, const Shape& sh)
{
    const long long tiles = (n + ITEMS - 1) / ITEMS;
    const long long need = (tiles + sh.nw - 1) / sh.nw;
    return (int)(need < sh.most ? need : sh.most);
}

template <typename T, int K>
int mlp(const void* S, long long ld_s, const void* ga, long long ld_ga,
        const void* w1k, const float* b1, const void* w2, const float* b2,
        long long n, int hid, float* gate, float* delta, float* mult,
        cudaStream_t st)
{
    const auto kern = sph_mlp_kernel<T, K>;
    int dev = 0;
    Shape sh;
    const Layout<T, K> lay(hid);
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = launch_shape((const void*)kern, dev, hid, lay.x,
                           Layout<T, K>::per_warp(), &sh);
    if (err != cudaSuccess) return (int)err;
    kern<<<blocks_for(n, sh), 32 * sh.nw, sh.smem, st>>>(
        static_cast<const T*>(S), ld_s, static_cast<const T*>(ga), ld_ga,
        static_cast<const T*>(w1k), b1, static_cast<const T*>(w2), b2, n, hid,
        gate, delta, mult);
    return (int)cudaGetLastError();
}

template <typename T>
int mlp_k(int K, const void* S, long long ld_s, const void* ga,
          long long ld_ga, const void* w1k, const float* b1, const void* w2,
          const float* b2, long long n, int hid, float* gate, float* delta,
          float* mult, cudaStream_t st)
{
    return K == 2 * F + 1
        ? mlp<T, 2 * F + 1>(S, ld_s, ga, ld_ga, w1k, b1, w2, b2, n, hid, gate,
                            delta, mult, st)
        : mlp<T, F>(S, ld_s, ga, ld_ga, w1k, b1, w2, b2, n, hid, gate, delta,
                    mult, st);
}

template <int K>
int mlp_fused(const Fused& f, const void* w1k, const float* b1,
              const void* w2, const float* b2, long long n, int hid,
              cudaStream_t st)
{
    using T = __nv_bfloat16;
    const auto kern = sph_mlp_kernel<K>;
    int dev = 0;
    Shape sh;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = launch_shape((const void*)kern, dev, hid, Layout<T, K>(hid).x,
                           fused_per_warp(), &sh);
    if (err != cudaSuccess) return (int)err;
    kern<<<blocks_for(n, sh), 32 * sh.nw, sh.smem, st>>>(
        f, static_cast<const T*>(w1k), b1, static_cast<const T*>(w2), b2, n,
        hid);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C launcher for ctypes: raw device pointers, the row strides of S and
// ga (in elements), the input type (0 = float32, 1 = bfloat16), n items, F,
// hid, K and the caller's stream. delta and mult are written for the gated
// rule only (K = 2F + 1). Returns the cudaGetLastError() code of the launch
// (0 = ok), or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int sph_mlp_launch(
    int bf16, const void* S, long long ld_s, const void* ga, long long ld_ga,
    const void* w1k, const float* b1, const void* w2, const float* b2,
    long long n, int F_, int hid, int K, float* gate, float* delta,
    float* mult, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (F_ != F || (K != 2 * F + 1 && K != F) || hid < 1 || hid > HID_MAX
        || n < 0 || ld_s % 8 || ld_ga % 8 || ld_s < F || ld_ga < 2 * F)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    return bf16
        ? mlp_k<__nv_bfloat16>(K, S, ld_s, ga, ld_ga, w1k, b1, w2, b2, n, hid,
                               gate, delta, mult, st)
        : mlp_k<float>(K, S, ld_s, ga, ld_ga, w1k, b1, w2, b2, n, hid, gate,
                       delta, mult, st);
}

// Plain C launcher of the fused variant (bfloat16 moments and weights, F =
// 16, D = 3): the device pointers of mom [nb, 3P, B*F], S [B, nb, P, F],
// gsum [nb, P, 3], the tangents' components and their strides (elements:
// sample, block, row), the normals' components, u, the weights,
// B, nb, P, F, hid, K, sigma_g rounded to bf16, the fire rate, the orig
// rule's factor, out [B, nb, P, F] and the stream. Returns as
// sph_mlp_launch.
extern "C" int sph_mlp_fused_launch(
    const void* mom, const float* S, const float* gsum, const float* t0,
    const float* t1, const float* t2, long long tsb, long long tsc,
    long long tsp, const float* n0, const float* n1,
    const float* n2, const float* u, const void* w1k, const float* b1,
    const void* w2, const float* b2, int B, int nb, int P, int F_, int hid,
    int K, float sg, float fire_rate, float scale, float* out, void* stream)
{
    if (F_ != F || (K != 2 * F + 1 && K != F) || hid < 1 || hid > HID_MAX
        || B < 0 || nb < 0 || P < 1)
        return (int)cudaErrorInvalidValue;
    const long long n = (long long)B * nb * P;
    if (n == 0) return 0;
    const Fused f{static_cast<const __nv_bfloat16*>(mom), S, gsum,
                  {t0, t1, t2}, {tsb, tsc, tsp}, {n0, n1, n2}, u,
                  (long long)nb * P, P, B * F,
                  sg, fire_rate, scale, out};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return K == 2 * F + 1
        ? mlp_fused<2 * F + 1>(f, w1k, b1, w2, b2, n, hid, st)
        : mlp_fused<F>(f, w1k, b1, w2, b2, n, hid, st);
}
