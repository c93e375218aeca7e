// The pieces the sample-tiled tensor-core kernels share, for sm_90a: the
// forward and adjoint table kernels (table_kernels.cu) and the recompute
// forward and adjoint kernels (pair_kernels.cu). Their launch geometry
// (64-row blocks in two halves of 32 rows, tiles of 8 samples, 8 warps), the
// PTX of mbarriers and TMA / bulk copies, the swizzled A-tile addressing, the
// A fragment with its warp vote on all-zero 16 x 8 tiles, the 3xTF32 passes
// of a k8 step, the stage ring, and the host side of the TMA:
// cuTensorMapEncodeTiled reached through the runtime, the cell-layout tensor
// map and the dynamic shared memory opt-in.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

#include "mma_util.cuh"

namespace {

constexpr int P = 64;          // block rows
constexpr int FF = 16;         // features
constexpr int BT = 8;          // samples per tile (and an n8 tile's)
constexpr int HALF = P / 2;    // rows of a block per thread block
constexpr int CELL = 8;        // slots per cell (M): one contiguous run
constexpr int WARPS_T = 8;     // warps of a thread block (fwd / bwd)
constexpr int TAB_THREADS = WARPS_T * 32;

// A lane's addressing of a TMA-swizzled table tile whose rows are ROWB
// bytes (CU_TENSOR_MAP_SWIZZLE_{128,64,32}B): the 16-byte chunk index of a
// byte offset is XORed with its bits 7.. (128 B: bits 7-9, 64 B: 7-8, 32 B:
// 7). For the A fragment of an m16 tile starting at a row that is a
// multiple of 16, rows g and g + 8 get the same XOR, so a lane keeps the
// in-row offsets of its columns t and t + 4; a k8 step at k0 XORs in
// k0 * sizeof(T), whose bits do not overlap theirs.
template <typename T, int ROWB>
struct TileLane {
    uint32_t x0, x4;

    __device__ __forceinline__ TileLane(int g, int t) {
        const uint32_t xs = ((uint32_t)(g * ROWB) >> 7 & (ROWB / 16 - 1)) << 4;
        x0 = (uint32_t)(t * sizeof(T)) ^ xs;
        x4 = (uint32_t)((t + 4) * sizeof(T)) ^ xs;
    }
};

// The byte offset of byte `off` of row R in a tile of ROWB-byte rows laid
// out as the TMA swizzles it (the layout TileLane reads): for A tiles the
// threads write themselves (the recompute kernels compute theirs on chip).
// A 4-, 8- or 16-byte piece at an offset aligned to its size stays whole.
template <int ROWB>
__device__ __forceinline__ uint32_t swz(int R, uint32_t off) {
    const uint32_t row = (uint32_t)R * ROWB;
    return row + (off ^ (((row >> 7) & (ROWB / 16 - 1)) << 4));
}

// A table entry as f32 (a bf16 entry is exact in f32 and in TF32)
template <typename T>
__device__ __forceinline__ float tab_ld(const unsigned char* p) {
    if constexpr (sizeof(T) == 4) {
        return *reinterpret_cast<const float*>(p);
    } else {
        return __uint_as_float(
            (uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
    }
}

// ---- PTX: mbarriers, bulk and tensor copies ------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_u32(bar);
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(a), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
    uint64_t pol;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(pol));
    return pol;
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       uint64_t* bar, uint64_t pol) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4, %5}], [%6], %7;"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar)), "l"(pol)
        : "memory");
}

// a cell box of the state / cotangent map (cell, first sample): no cache
// hint, they should stay
__device__ __forceinline__ void tma_cell(void* dst, const CUtensorMap* map,
                                         int cell, int y0, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %2, %3, %4}], [%5];"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(0), "r"(cell), "r"(y0), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// The A fragment of the m16 tile at rows r0.. (a multiple of 16) and the k8
// step at k0 of a table tile. load() reads it (into big, as f32 bits) and
// tells, warp-wide, whether any entry is nonzero: most 16 x 8 tiles of a
// table are all zero (only pairs within h are not), and their products add
// exact zeros, so they are skipped; which are skipped depends on the table
// only. read() reads it alone, for a caller that knows. split_parts() then
// makes big + small (f32 tables; a bf16 entry is exact).
template <typename T, int ROWB>
struct AFrag {
    uint32_t big[4], small[4];

    __device__ __forceinline__ bool load(const unsigned char* tile, int r0,
                                         int k0, int g,
                                         const TileLane<T, ROWB>& ln) {
        read(tile, r0, k0, g, ln);
        // nonzero but for the sign bit (-0 is a zero)
        return __any_sync(0xffffffffu,
                          ((big[0] | big[1] | big[2] | big[3]) << 1) != 0);
    }

    // the fragment alone, for a caller that knows the tile is not all zero
    __device__ __forceinline__ void read(const unsigned char* tile, int r0,
                                         int k0, int g,
                                         const TileLane<T, ROWB>& ln) {
        const unsigned char* row = tile + (r0 + g) * ROWB;
        const uint32_t k = (uint32_t)(k0 * sizeof(T));
        big[0] = __float_as_uint(tab_ld<T>(row + (k ^ ln.x0)));
        big[1] = __float_as_uint(tab_ld<T>(row + 8 * ROWB + (k ^ ln.x0)));
        big[2] = __float_as_uint(tab_ld<T>(row + (k ^ ln.x4)));
        big[3] = __float_as_uint(tab_ld<T>(row + 8 * ROWB + (k ^ ln.x4)));
    }

    __device__ __forceinline__ void split_parts() {
        if constexpr (sizeof(T) == 4) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
                split(__uint_as_float(big[i]), big[i], small[i]);
        }
    }
};

// The products of a k8 step in two passes, each into c from zero: pass 0
// the small terms (A_small B_big + A_big B_small for f32 tables, A B_small
// for bf16), pass 1 the big one (A_big B_big). The tensor core's f32 sums
// are truncated, and an addend much smaller than the sum loses its low
// bits, so the caller adds each pass to its running sums in
// round-to-nearest f32; the small terms' truncation is ~2^-11 of theirs.
// Chaining the passes in the tensor core (over the window, or the 3
// products of a step) left ~1e-6 of the largest output, which 16 chaotic
// surface rollout steps amplified past 1e-4.
template <typename T, int ROWB>
__device__ __forceinline__ void product(int pass, float* c,
                                        const AFrag<T, ROWB>& a,
                                        const uint32_t* bb,
                                        const uint32_t* bs) {
    if (pass == 1) {
        mma_tf32(c, a.big, bb[0], bb[1]);
    } else if constexpr (sizeof(T) == 4) {
        mma_tf32(c, a.small, bb[0], bb[1]);
        mma_tf32_acc(c, a.big, bs[0], bs[1]);
    } else {
        mma_tf32(c, a.big, bs[0], bs[1]);
    }
}

// Stage ring: the dynamic shared memory, 1024-byte aligned (NS stages of
// `bytes`, then the block's Wu window cells, read once at the start so that
// no copy waits on a load of its cell index); per stage a "full" mbarrier
// (the copies landed) and a count of the warps done with it. The warp that
// finishes a stage last refills its slot with the stage NS ahead, at
// once: no warp waits for a free slot.
template <int NS>
struct Ring {
    unsigned char* base;
    uint64_t* full;
    int* done;
    int* cells;

    __device__ __forceinline__ void init(unsigned char* dyn, int bytes,
                                         uint64_t* bars, int* counts,
                                         const int* __restrict__ wc, int Wu) {
        const uint32_t a = smem_u32(dyn);
        base = dyn + ((1024u - (a & 1023u)) & 1023u);
        full = bars;
        done = counts;
        cells = reinterpret_cast<int*>(base + NS * bytes);
        for (int i = threadIdx.x; i < Wu; i += blockDim.x) cells[i] = wc[i];
        if (threadIdx.x < NS) {
            bar_init(&full[threadIdx.x], 1);
            done[threadIdx.x] = 0;
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        __syncthreads();
    }

    // After a warp's last read of slot s: true in the warp that is the last
    // of the block to leave it (which may then overwrite it)
    __device__ __forceinline__ bool leave(int s, int lane) {
        __syncwarp();
        int last = 0;
        if (lane == 0) {
            __threadfence_block();
            last = atomicAdd(&done[s], 1) == WARPS_T - 1;
            if (last) done[s] = 0;
            __threadfence_block();
        }
        last = __shfl_sync(0xffffffffu, last, 0);
        if (last)  // the block's reads before the copy engine's writes
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        return last;
    }
};

// cuTensorMapEncodeTiled, reached through the runtime (the build links no
// libcuda).
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* out) {
    static std::once_flag once;
    static EncodeTiled fn = nullptr;
    static cudaError_t err = cudaSuccess;
    std::call_once(once, [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                               12000, cudaEnableDefault, &q);
#else
        err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                      cudaEnableDefault, &q);
#endif
        if (err == cudaSuccess && (q != cudaDriverEntryPointSuccess || !p))
            err = cudaErrorSymbolNotFound;
        fn = reinterpret_cast<EncodeTiled>(p);
    });
    *out = fn;
    return err;
}

// The TMA map of a cell-layout tensor X [B][C, M*K] (f32, sample stride
// x_bs elements) read in boxes of one cell of min(B, btc) samples,
// [nbx][M*K], unswizzled: a sample's cell is one contiguous run of M*K
// floats, seen as R rows of E = M*K / R <= 256 floats (the fewer and longer
// the rows, the fewer requests the TMA makes). Samples past B are filled
// with zeros.
cudaError_t cell_map(CUtensorMap* map, const float* X, long long x_bs, int K,
                     int B, int btc) {
    EncodeTiled enc = nullptr;
    cudaError_t err = encode_tiled(&enc);
    if (err != cudaSuccess) return err;
    const int run = CELL * K;
    const int R = (run + 255) / 256;
    const cuuint64_t E = (cuuint64_t)(run / R);
    const cuuint64_t dims[4] = {E, (cuuint64_t)R,
                                (cuuint64_t)(x_bs / run), (cuuint64_t)B};
    const cuuint64_t strides[3] = {E * 4, (cuuint64_t)run * 4,
                                   (cuuint64_t)x_bs * 4};
    const cuuint32_t box[4] = {(cuuint32_t)E, (cuuint32_t)R, 1,
                               (cuuint32_t)(B < btc ? B : btc)};
    const cuuint32_t one[4] = {1, 1, 1, 1};
    if (run % R) return cudaErrorInvalidValue;
    const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                           const_cast<float*>(X), dims, strides, box, one,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Raise a kernel's dynamic shared memory limit to the most a block may use
// beside its static shared memory, once per device; a launch that asks for
// more is refused.
cudaError_t allow_smem(const void* kern) {
    static std::mutex mu;
    static std::set<std::pair<const void*, int>> done;
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    if (done.count({kern, dev})) return cudaSuccess;
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, kern)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
               != cudaSuccess)
        return err;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
    if (err == cudaSuccess) done.insert({kern, dev});
    return err;
}

}  // namespace
