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
// two weight matrices; the biases are f32, every product and sum is f32 (a
// product of two bf16 values is exact in f32), H is rounded to T before the
// second product as the TPU kernel rounds it (mlp_kernel.py:57), and the
// outputs are f32. No TF32, no fast-math.
//
// Layout. S is [n, F] with row stride ld_s; ga is [n, >= 2F] with row stride
// ld_ga, gx its first F columns and gy the next F (the per-sample d-major
// perception, whose z block, if any, the MLP does not read). On the port's
// batched path n = B * C * M, sample-major. The outputs are contiguous
// [n, F], [n, F] and [n].
//
// Bound on this card. At the training shapes (C * M = 20,224 slots, B = 8:
// 161,792 items) a launch does 2 (48 * 256 + 256 * 33) = 41,472 FLOP an item,
// 6.71 GFLOP, 0.100 ms at 67 TFLOP/s fp32, and moves ~52 MB, 0.016 ms at
// 3.35 TB/s: bound by OPERATIONS.
//
// Design, simple first: one thread per item, X in 48 registers and the K
// outputs in K registers, accumulated over the hidden units. The weights sit
// in shared memory as f32, W1k transposed ([hid, 48], so hidden unit j's
// column is one contiguous row) and W2 with rows padded to a multiple of 4;
// every thread of a warp reads the same address, so each 16-byte shared load
// is a broadcast that feeds 4 FMAs. Layer 1 sums each hidden unit in 4
// interleaved partial sums (independent FMA chains). In f32 at hid = 256 the
// weights take 48 KB + 36 KB, over the 48 KB default, so the launcher raises
// the block's dynamic shared memory limit. Blocks stride over the items, so
// each block stages the weights once. The Pallas BlockSpec restack of the
// TPU kernel (16-lane sample blocks of a 128-lane row) has no counterpart:
// here a sample's 16 features are simply 64 contiguous bytes.
// Left for later: tensor cores (wgmma over 64-item tiles), TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int F = 16;          // channels
constexpr int IN = 3 * F;      // MLP inputs
constexpr int THREADS = 256;
constexpr int HID_MAX = 512;   // 512 * (48 + 36 + 1) floats = 170 KB shared

__device__ __forceinline__ void load16(const float* p, float* x)
{
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float4 v = q[i];
        x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z;
        x[4 * i + 3] = v.w;
    }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x)
{
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        uint4 v = q[i];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            float2 f = __bfloat1622float2(h[k]);
            x[8 * i + 2 * k] = f.x;
            x[8 * i + 2 * k + 1] = f.y;
        }
    }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v)
{
    return __bfloat162float(v);
}

// round an f32 value to T and back
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v)
{
    return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v)
{
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <int K> struct Pad { static constexpr int KP = (K + 3) / 4 * 4; };

template <int K>
constexpr int smem_floats(int hid) { return hid * (IN + Pad<K>::KP + 1); }

template <typename T, int K>
__global__ void __launch_bounds__(THREADS, 2) sph_mlp_kernel(
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
    constexpr int KP = Pad<K>::KP;
    extern __shared__ float4 smem4[];
    float* w1s = reinterpret_cast<float*>(smem4);  // [hid, IN]
    float* w2s = w1s + hid * IN;                   // [hid, KP]
    float* b1s = w2s + hid * KP;                   // [hid]

    for (int i = threadIdx.x; i < IN * hid; i += THREADS) {
        const int k = i / hid, j = i - k * hid;  // coalesced over j
        w1s[j * IN + k] = to_f32(w1k[i]);
    }
    for (int i = threadIdx.x; i < hid * KP; i += THREADS) {
        const int j = i / KP, o = i - j * KP;
        w2s[i] = o < K ? to_f32(w2[j * K + o]) : 0.0f;
    }
    for (int j = threadIdx.x; j < hid; j += THREADS) b1s[j] = b1[j];
    __syncthreads();

    const long long stride = (long long)gridDim.x * THREADS;
    for (long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
         item < n; item += stride) {
        float x[IN];
        load16(S + item * ld_s, x);
        load16(ga + item * ld_ga, x + F);
        load16(ga + item * ld_ga + F, x + 2 * F);
        float o[KP];  // the pad columns stay unused
#pragma unroll
        for (int k = 0; k < KP; ++k) o[k] = k < K ? b2[k] : 0.0f;

        for (int j = 0; j < hid; ++j) {
            const float4* w = reinterpret_cast<const float4*>(w1s + j * IN);
            float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
            for (int q = 0; q < IN / 4; ++q) {
                const float4 v = w[q];
                a0 = fmaf(x[4 * q], v.x, a0);
                a1 = fmaf(x[4 * q + 1], v.y, a1);
                a2 = fmaf(x[4 * q + 2], v.z, a2);
                a3 = fmaf(x[4 * q + 3], v.w, a3);
            }
            const float hj =
                round_to<T>(fmaxf((a0 + a1) + (a2 + a3) + b1s[j], 0.0f));
            const float4* u = reinterpret_cast<const float4*>(w2s + j * KP);
#pragma unroll
            for (int q = 0; q < KP / 4; ++q) {
                const float4 v = u[q];
                if (4 * q < K) o[4 * q] = fmaf(hj, v.x, o[4 * q]);
                if (4 * q + 1 < K) o[4 * q + 1] = fmaf(hj, v.y, o[4 * q + 1]);
                if (4 * q + 2 < K) o[4 * q + 2] = fmaf(hj, v.z, o[4 * q + 2]);
                if (4 * q + 3 < K) o[4 * q + 3] = fmaf(hj, v.w, o[4 * q + 3]);
            }
        }

        float4* g = reinterpret_cast<float4*>(gate + item * F);
#pragma unroll
        for (int q = 0; q < F / 4; ++q)
            g[q] = make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2],
                               o[4 * q + 3]);
        if constexpr (K == 2 * F + 1) {
            float4* d = reinterpret_cast<float4*>(delta + item * F);
#pragma unroll
            for (int q = 0; q < F / 4; ++q)
                d[q] = make_float4(o[F + 4 * q], o[F + 4 * q + 1],
                                   o[F + 4 * q + 2], o[F + 4 * q + 3]);
            mult[item] = o[2 * F];
        }
    }
}

// The blocks that fit on the card at once for (device, hid), worked out on
// the first launch of each pair: the dynamic shared memory limit is raised to
// what HID_MAX needs (so one setting serves every hid) and the occupancy
// calculator gives the blocks per SM. Later launches read the cache and skip
// those runtime calls.
template <typename T, int K>
cudaError_t resident_blocks(int dev, int hid, size_t smem, long long* most)
{
    static std::mutex mu;
    static std::map<std::pair<int, int>, long long> cache;
    std::lock_guard<std::mutex> lock(mu);
    const auto it = cache.find({dev, hid});
    if (it != cache.end()) {
        *most = it->second;
        return cudaSuccess;
    }
    auto kern = sph_mlp_kernel<T, K>;
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * smem_floats<K>(HID_MAX)));
    if (err != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, THREADS, smem)) != cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *most = cache[{dev, hid}] = (long long)sms * per_sm;
    return cudaSuccess;
}

template <typename T, int K>
int mlp(const void* S, long long ld_s, const void* ga, long long ld_ga,
        const void* w1k, const float* b1, const void* w2, const float* b2,
        long long n, int hid, float* gate, float* delta, float* mult,
        cudaStream_t st)
{
    const size_t smem = sizeof(float) * smem_floats<K>(hid);
    int dev = 0;
    long long most = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if ((err = resident_blocks<T, K>(dev, hid, smem, &most)) != cudaSuccess)
        return (int)err;
    const long long need = (n + THREADS - 1) / THREADS;
    const int blocks = (int)(need < most ? need : most);
    sph_mlp_kernel<T, K><<<blocks, THREADS, smem, st>>>(
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
