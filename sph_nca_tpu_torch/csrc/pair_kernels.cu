// SPH pair-pass kernels of the cell engine without pair tables (the
// recompute path), for Hopper (sm_90a).
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
// All run over one window-size bucket of the cell engine
// (sph_nca_tpu_torch/ops/cells.py): block b holds P = 64 rows (8 subcells x 8
// slots) and a union window of W slots. For every pair (p, w) of a block:
//   r_d  = xw_d[w] - xb_d[p]                 (direct per-axis differences)
//   d2   = sum_d r_d^2
//   mag  = 3((h^2 + d2) rsqrt(d2) - 2h)      on 0 < d2 < h^2, else 0
//   Tg   = sig_g mag v_w,  Tw = sig_w max(h^2 - d2, 0)^3 v_w
//   gA_d[p, :] += Tg r_d S_w[:],  rowsum_d[p] += Tg r_d,  sm[p] += Tw alive_w
// and finally gA_d[p, :] -= S_b[p, :] rowsum_d[p], stored d-major [P, D*F].
// alive_w is S_w[3] > thr (use_alpha) or v_w > 0. The adjoint, for every
// pair, with the OPPOSITE sign r_d = xb_d[p] - xw_d[w]:
//   acc[p, :] += sum_d mag r_d G_w[d*F : (d+1)*F]
// and finally dA[p, :] = sig_g v_b[p] acc[p, :] - sum_d gsum[p, d]
// gbar_p[d*F:]
// with G the d-major cotangent of gA [C*M, D*F], gbar_p the row's own
// cotangent and gsum the geometry's self term (ops/cells.py). Pad rows have
// v_b = 0 and gsum = 0, so their dA is exactly 0.
//
// Batch. Every kernel takes a leading batch axis B: the geometry (positions,
// volumes, window tables) is shared, and each sample's state, own rows,
// cotangents and outputs sit at that sample's offset. The training step runs
// all B samples of a batch in one launch per bucket; inference launches with
// B = 1.
//
// Numerics. d2 comes from per-axis differences, never from
// |a|^2 + |b|^2 - 2ab: the self pair has d2 == 0 exactly and contributes 0,
// and the spiky magnitude would amplify any cancellation error near d -> 0.
// Padded slots sit at PAD_POS = 1e6, so d2 ~ 1e12 and h^2 - d2 clamps to 0
// before the cube. The geometry is fp32 (rsqrtf as the TPU kernel's
// lax.rsqrt, no fast-math); the products are f32-accurate (below).
//
// ---- sph_fwd_kernel and sph_bwd_kernel -------------------------------------
//
// Bound on this card. At the training shapes (B = 8, D = 3, F = 16; 237 + 79
// blocks at W = 536 / 680: 11.57 M pairs a sample, 1.41 M of them within h)
// a forward call reads the state and writes gA (~45 MB, ~13 us at 3.35
// TB/s); its geometry is ~0.13 GFLOP once per pass (~2 us on the 67 TFLOP/s
// fp32 cores) and its products for the pairs within h 8 x 1.41 M x 98 x 2
// FLOP, tripled by the 3xTF32 route (~7 us at the 495 TFLOP/s TF32 rate).
// Bound by BYTES; the adjoint likewise. The first design recomputed the
// geometry for every sample and ran every pair's F-wide products as fp32
// FMAs (2-6% of its operation bound).
//
// The design is the table kernels' (table_kernels.cu, sph_fwd_tab_kernel /
// sph_bwd_tab_kernel) with the A tile computed on chip instead of read from
// a table. A thread block owns one half of a block's rows (32) and a tile of
// BT = 8 samples (the forward 1 for B = 1, the inference path, and 2 for B
// = 2; the adjoint 2 for B <= 2); the grid is (2 nb, ceil(B / BT)). At its
// start the block reads its window's cell indices, positions and (forward)
// volumes into shared memory, and marks, for each 16-row group of its rows
// and each window cell, whether their bounding boxes lie more than h apart
// (pads included, so that only tiles whose every pair is beyond h are
// marked). The window then streams through in stages of TW slots (forward
// 32, adjoint 16). Per stage:
//   - by TMA, into a ring of NS shared-memory stages (tile_ring.cuh's Ring):
//     one box per window cell of the tile's samples' state (forward) or
//     cotangents (adjoint);
//   - each warp computes the pair geometry of one 16 x 8 tile (16 rows, one
//     window cell) ONCE for all the tile's samples, unless the tile is
//     marked far: the forward's A = mag v_w (xw - xb)_d for the D md tiles
//     and sig_w v_w max(h^2 - d2, 0)^3 for the w6 tile, the adjoint's A =
//     mag (xb - xw)_d, written into a double buffer in the TMA's swizzled
//     layout that the table kernels' A-fragment reads expect (tile_ring.cuh
//     swz, TileLane), with a warp vote a bit for each of its A tiles that
//     is not all zero. The geometry of stage k + 1 is computed before stage
//     k's products; one __syncthreads a stage hands the buffers over, and
//     warp 0 then refills the ring slot just consumed;
//   - the products run on the tensor cores as in the table kernels:
//     mma.sync.m16n8k8 TF32 with both operands split in registers, "3xTF32"
//     (x = big + small, acc += A_small B_big + A_big B_small + A_big B_big),
//     each k8 step's passes into fresh sums added to the running sums in
//     round-to-nearest f32 (the tensor core's own sums truncate; chained sums
//     failed the 16-step surface check, PERF.md). The 16 x 8 tiles whose
//     bit is clear (the pairs beyond h, the pad slots, the self pairs) are
//     skipped without a read, so which products run depends on the geometry
//     only. Warps: 8, as 2 (rows) x 4 (n8 tiles of (sample, half of F)): a
//     warp owns D m16 tiles of md (the forward: one 16-row half of each d,
//     so that both row warps have the same work when an axis is flat, as in
//     a 2D cloud padded to 3D) or 16 rows (the adjoint) and BT / 2 n8 tiles;
//     with one sample, 4 (md tiles) x 2 (halves of F), so that every warp
//     has products. The forward's w6 product runs on the tensor cores too,
//     against the samples' alive columns (1 or 0: exact in TF32, 2
//     products a step).
//
// v_w is folded into the forward's A tile once per sample tile, rather than
// applied to the right-hand side at every B-fragment load of every warp;
// the rowsum the forward subtracts, sum_w A, is then the sum of exactly the
// f32 values the products split, accumulated by the geometry threads in
// stage order (each row's 8 partial sums added as a butterfly would), so a
// constant state cancels to f32 rounding: gA = sig_g (A @ S_w - S_b sum A).
// Nothing in a sample's sums depends on B or on the sample's place in its
// tile, so one launch of B samples equals B launches of one, bit for bit.
//
// wgmma is still not used: its A operand may come from registers, but its
// TF32 B operand comes from shared memory, K-major, so the split state or
// cotangents would be staged there twice, and its M tiles of 64 rows double
// the accumulators the round-to-nearest sums keep; the A tile computed on
// chip changes neither.
//
// Per thread block (B > 2, D = 3, W = 680): forward 3 stages of 16 KB, two
// 16 KB geometry buffers and 11 KB of window rows (~95 KB of dynamic shared
// memory), adjoint 3 of 24 KB, two of 6 KB and 8 KB (~95 KB): two blocks an
// SM, 8 warps each (__launch_bounds__(256, 2): 128 registers a thread; three
// blocks for tiles of 1 or 2 samples). chip_smoke.py prints ptxas's counts.
//
// ---- sph_mask_kernel -------------------------------------------------------
//
// Bound on this card: the geometry, ~9 operations a pair once per pass and 5
// more a pair within h, and 2 a pair within h and sample (~2 us at the gecko
// and the training shapes on the 67 TFLOP/s fp32 cores), over a few MB read
// (~1 us): bound by OPERATIONS, by the geometry above all, which a sample
// tile shares.
//
// The design is 2.1's geometry without its products. A thread block owns
// one half of a block's rows (32) and a tile of BT = 8 samples (1 for B = 1,
// the inference path); the grid is (2 nb, ceil(B / BT)): 580 thread blocks
// at the gecko shapes. At its start the block reads its window's positions
// and cell indices into shared memory once (RcWindow, as 2.1 / 2.2 keep
// theirs) and marks, for each 16-row group of its rows and each group of 8
// window slots, whether their bounding boxes lie more than h apart (pads in
// the boxes, cut h^2 1.0001, as 2.1); the marked tiles are skipped whole.
// For every other pair a thread computes w6 = max(h^2 - d2, 0)^3 once per
// sample tile, d2 from per-axis differences, and adds w6 times each of the
// tile's columns sig_w v_w alive_w into that sample's sum on the fp32 CUDA
// cores: a w6 matvec has too few columns for the tensor cores (2.1's w6
// product runs there only because its A tile is there already). The alive
// column is gathered one chunk of 256 slots ahead into shared memory, as
// sph_mask_tab_kernel gathers its own (table_kernels.cu); with one sample
// the chunks are 1024 slots, so that a window of up to 1024 slots is
// gathered once, behind the far bits, and the sums wait on no load and no
// barrier. Culling depends on positions only, and every sum is taken in an
// order fixed by the window (see the kernel), so one launch of B samples
// equals B launches of one, bit for bit. The warp roles are the same for
// one sample and for eight: every warp computes the geometry of its own
// tiles, and there are no products to balance. Per thread block (D = 3, W =
// 1000): 16 KB of columns (8 KB with one sample), 12 KB of positions, 0.5
// KB of cell indices and 4 KB static.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_ring.cuh"

namespace {

constexpr float FAR = 1.0e6f;      // position of a window's tail slots

// Shared memory of the recompute forward (FWD) or adjoint at D for sample
// tiles of BTC samples, 1024-byte aligned: a ring of NS stages (filled by
// the TMA) of the window's state (K = F floats a slot) or cotangents (K =
// D*F) as TW / 8 cell boxes [nbx][8][K] of the tile's nbx = min(B, BTC)
// samples; the window's Wu cell indices; two geometry buffers (written by
// the threads: the md tile [D*32][TW] and, forward, the w6 tile [32][TW],
// f32, swizzled as the TMA would store them, which the A-fragment reads
// expect); the whole window's positions [D][Wp] and, forward, volumes [Wp]
// (Wp = W rounded up to a stage); for each of the half's two 16-row groups a
// bit a window cell, set where every pair of the group and the cell lies
// beyond h. NS: 3 stages with tiles of 8 samples (two blocks an SM), more
// with smaller tiles.
template <int D, bool FWD, int BTC>
struct RcLayout {
    static constexpr int TW = FWD ? 32 : 16;          // window slots a stage
    static constexpr int ROWB = TW * 4;               // 128 or 64
    static constexpr int K = FWD ? FF : D * FF;       // floats per slot
    static constexpr int RHS = BTC * TW * K * 4;      // bytes of a stage
    static constexpr int NS = BTC == BT ? 3 : FWD ? 5 : 8;
    static constexpr int MD = 0;
    static constexpr int W6 = MD + D * HALF * ROWB;
    static constexpr int GEO =
        (W6 + (FWD ? HALF * ROWB : 0) + 1023) / 1024 * 1024;
    static constexpr int NX = FWD ? D + 1 : D;        // window rows staged
    __host__ __device__ static constexpr int wpad(int W) {
        return (W + TW - 1) / TW * TW;
    }
    __host__ __device__ static constexpr int cells(int Wu) {
        return (Wu * 4 + 1023) / 1024 * 1024;
    }
    static constexpr int smem(int W, int Wu) {
        return 1024 + NS * RHS + cells(Wu) + 2 * GEO + NX * wpad(W) * 4
            + 2 * ((Wu + 31) / 32) * 4;
    }
    static_assert(GEO % 1024 == 0 && RHS % 1024 == 0, "alignment");
};

__device__ __forceinline__ float elem(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ float elem(const float2& v, int c) {
    return c == 0 ? v.x : v.y;
}

// The window rows of one block, in shared memory and read once: positions
// [D][Wp] (FAR past W) and, with NX = D + 1, volumes [Wp] (0 past W); and,
// for each of the thread block's two 16-row groups, a bit for each group of
// CELL window slots (a window cell where M = CELL), set where every pair of
// the two lies beyond h. The recompute forward and adjoint (RcBlock) and
// the mask kernel keep their window here.
template <int D, int NX>
struct RcWindow {
    float* xw;            // [D][Wp] window positions ([Wp] volumes after)
    unsigned* farw;       // [2][nwd] bits: row group and slot group far
    int nwd;              // words a row group: (ng + 31) / 32
    int Wp;

    // bytes of the rows and the bits for a window of Wp slots, ng groups
    __host__ __device__ static constexpr int bytes(int Wp, int ng) {
        return NX * Wp * 4 + 2 * ((ng + 31) / 32) * 4;
    }

    // carve [at, at + bytes) (16-byte aligned) and read the rows: 16 bytes
    // a thread where vec (W % 4 == 0 and 16-byte aligned rows), else 4. No
    // __syncthreads.
    __device__ __forceinline__ void load(
        unsigned char* at, int b, int W, int wp, int ng,
        const float* __restrict__ xw_b, const float* __restrict__ vw_b,
        bool vec) {
        Wp = wp;
        xw = reinterpret_cast<float*>(at);
        farw = reinterpret_cast<unsigned*>(xw + NX * Wp);
        nwd = (ng + 31) / 32;
        // row d of the window: axis d of the positions, or the volumes
        auto row = [&](int d) {
            return d < D ? xw_b + ((size_t)b * D + d) * W
                         : vw_b + (size_t)b * W;
        };
        if (vec) {
            const int w4 = Wp / 4;
            for (int i = threadIdx.x; i < NX * w4; i += blockDim.x) {
                const int d = i / w4;
                const int w = (i - d * w4) * 4;
                float4 v = d < D ? make_float4(FAR, FAR, FAR, FAR)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                if (w < W) v = *reinterpret_cast<const float4*>(row(d) + w);
                *reinterpret_cast<float4*>(xw + d * Wp + w) = v;
            }
        } else {
            for (int i = threadIdx.x; i < NX * Wp; i += blockDim.x) {
                const int d = i / Wp;
                const int w = i - d * Wp;
                xw[i] = w < W ? row(d)[w] : d < D ? FAR : 0.0f;
            }
        }
    }

    // the far bits: for the half's two 16-row groups (rows of xb [D][32])
    // and each of the ng groups of CELL slots, whether their bounding boxes
    // lie more than h apart (the boxes' gap, squared, above cut: h^2 and a
    // margin above the pairs' own rounding). A slot or row of a pad sits
    // near PAD_POS and stays in its box, so that a tile is culled only where
    // every pair of it is beyond h. Ends with a __syncthreads.
    __device__ __forceinline__ void far_bits(int ng, const float (*xb)[HALF],
                                             float (*gbox)[2][D], float cut) {
        if (threadIdx.x < 2 * D) {
            const int mg = threadIdx.x / D;
            const int d = threadIdx.x - mg * D;
            float lo = xb[d][mg * 16], hi = lo;
            for (int j = 1; j < 16; ++j) {
                lo = fminf(lo, xb[d][mg * 16 + j]);
                hi = fmaxf(hi, xb[d][mg * 16 + j]);
            }
            gbox[mg][0][d] = lo;
            gbox[mg][1][d] = hi;
        }
        __syncthreads();
        // a warp a word: lanes the groups of word i % nwd of row group
        // i / nwd
        for (int i = threadIdx.x; i < 2 * nwd * 32; i += blockDim.x) {
            const int mg = i / (nwd * 32);
            const int c = i - mg * nwd * 32;
            bool far = false;
            if (c < ng) {
                float g2 = 0.0f;
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    const float* x = xw + d * Wp + c * CELL;
                    float lo = x[0], hi = x[0];
#pragma unroll
                    for (int j = 1; j < CELL; ++j) {
                        lo = fminf(lo, x[j]);
                        hi = fmaxf(hi, x[j]);
                    }
                    const float gap = fmaxf(fmaxf(lo - gbox[mg][1][d],
                                                  gbox[mg][0][d] - hi), 0.0f);
                    g2 = g2 + gap * gap;
                }
                far = g2 > cut;
            }
            const unsigned word = __ballot_sync(0xffffffffu, far);
            if (i % 32 == 0) farw[i / 32] = word;
        }
        __syncthreads();
    }

    // whether slot group c and 16-row group mg are far apart
    __device__ __forceinline__ bool far(int c, int mg) const {
        return farw[mg * nwd + c / 32] >> (c % 32) & 1;
    }
};

// The recompute forward's or adjoint's shared memory (RcLayout): the TMA
// ring of the state or the cotangents (tile_ring.cuh's Ring, which also
// reads the window's cells), the geometry buffers, and the window's rows
// (RcWindow, one slot group a window cell).
template <int D, bool FWD, int BTC>
struct RcBlock : RcWindow<D, RcLayout<D, FWD, BTC>::NX> {
    using L = RcLayout<D, FWD, BTC>;
    Ring<L::NS> ring;
    unsigned char* geo;   // two geometry buffers

    // carve the dynamic shared memory; read the window's cells, positions
    // (FAR past W) and volumes (0 past W); end with a __syncthreads
    __device__ __forceinline__ void init(
        unsigned char* dyn, uint64_t* bars, int* counts, int b, int W,
        int Wu, const float* __restrict__ xw_b,
        const float* __restrict__ vw_b, const int* __restrict__ win) {
        ring.init(dyn, L::RHS, bars, counts, win + (size_t)b * Wu, Wu);
        geo = ring.base + L::NS * L::RHS + L::cells(Wu);
        this->load(geo + 2 * L::GEO, b, W, L::wpad(W), Wu, xw_b, vw_b, true);
        __syncthreads();
    }

    // one warp: the TMA copies of stage k into slot k % NS, one box a
    // window cell (lane c: cell c) of the tile's samples, counted on the
    // slot's mbarrier
    __device__ __forceinline__ void issue(int k, int W, const CUtensorMap* map,
                                          int y0, int nbx, int lane) {
        const int s = k % L::NS;
        const int t0 = k * L::TW;
        const int nc = min(L::TW, W - t0) / CELL;
        unsigned char* st = ring.base + s * L::RHS;
        const int cell = lane < nc ? ring.cells[t0 / CELL + lane] : 0;
        if (lane == 0)
            bar_expect(&ring.full[s], nc * nbx * CELL * L::K * 4);
        __syncwarp();
        if (lane < nc)
            tma_cell(st + lane * nbx * CELL * L::K * 4, map, cell, y0,
                     &ring.full[s]);
    }

    // stage k's boxes, once they have landed
    __device__ __forceinline__ const float* stage(int k) {
        bar_wait(&ring.full[k % L::NS], (k / L::NS) & 1);
        return reinterpret_cast<const float*>(ring.base
                                              + (k % L::NS) * L::RHS);
    }
};

// whether any lane holds a nonzero value (-0 is a zero, as in AFrag::load)
template <int C>
__device__ __forceinline__ bool warp_any(const float (&v)[C]) {
    bool any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) any |= (__float_as_uint(v[c]) << 1) != 0;
    return __any_sync(0xffffffffu, any);
}

// The block's warp 0, after a __syncthreads that ends every read of a ring
// slot: order those reads before the copy engine's writes into it
__device__ __forceinline__ void release_slot() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int D, int BTC>
__global__ void __launch_bounds__(TAB_THREADS, BTC <= 2 ? 3 : 2)
sph_fwd_kernel(
    const __grid_constant__ CUtensorMap s_map,  // S as [B, C*M, F]
    const float* __restrict__ xs_b,    // [nb, D, P]
    const float* __restrict__ ab,      // [B][nb, P, F] the blocks' own rows
    long long ab_bs,                   // ab's sample stride (elements)
    const float* __restrict__ xw_b,    // [nb, D, W]
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu] window cells
    int B, int W, int Wu, float h, float sig_w, float sig_g, float thr,
    int use_alpha,
    float* __restrict__ ga,            // [B, nb, P, D*F]
    float* __restrict__ sm)            // [B, nb, P]
{
    using L = RcLayout<D, true, BTC>;
    constexpr int NS = L::NS;
    // warp roles. Tiles of 2 or 8 samples: 2 (the D md m16 tiles wm, wm +
    // 2, ..: one 16-row half of each d, so that both have the same work
    // when one axis is flat, as in a 2D cloud padded to 3D) x 4 (BTC / 2 n8
    // tiles of (sample, half of F) each). One sample: 4 (md m16 tiles wm,
    // wm + 4) x 2 (the n8 tile of one half of F), so that every warp has
    // products.
    constexpr bool ONE = BTC == 1;
    constexpr int NG = ONE ? 2 : 4;
    constexpr int NJ = ONE ? 1 : BTC / 2;
    constexpr int MPW = ONE ? (2 * D + 3) / 4 : D;
    extern __shared__ unsigned char dyn[];
    __shared__ uint64_t bars[NS];
    __shared__ int counts[NS];
    // the w6 product's partial sums: [k phase][m16 tile][lane][4]
    __shared__ float4 red[4][2][32];
    // the half's row positions; the rowsums' 8 partial sums a row and d
    // (one a geometry thread), then the rowsums
    __shared__ float xb[D][HALF];
    __shared__ float rsp[D][HALF][8];
    __shared__ float rowsum[D][HALF];
    // which 16 x 8 tiles of stage k's md and w6 are not all zero, bit
    // (m16 tile) * 4 + (k8 step) (w6 tiles after the 2 D md tiles), in word
    // k % 3: set by the geometry, read by the products, reset the stage
    // after (three words, so that a reset never meets a reader or a writer)
    __shared__ unsigned nzw[3];
    __shared__ float gbox[2][2][D];       // the 16-row groups' boxes
    const int b = blockIdx.x / 2;
    const int hh = blockIdx.x % 2;        // rows hh*32 .. hh*32+31
    if (threadIdx.x < 3) nzw[threadIdx.x] = 0;
    for (int i = threadIdx.x; i < D * HALF; i += blockDim.x)
        xb[i / HALF][i % HALF] =
            xs_b[((size_t)b * D + i / HALF) * P + hh * HALF + i % HALF];
    RcBlock<D, true, BTC> blk;  // (init and far_bits end in a __syncthreads)
    blk.init(dyn, bars, counts, b, W, Wu, xw_b, vw_b, win);
    blk.far_bits(Wu, xb, gbox, h * h * 1.0001f);

    const int nb = gridDim.x / 2;
    const int y0 = blockIdx.y * BTC;      // first sample of the tile
    const int nbt = min(BTC, B - y0);     // samples of this tile
    const int nbx = min(BTC, B);          // samples a cell box holds
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int nt = (W + L::TW - 1) / L::TW;
    const float h2 = h * h;
    const float two_h = 2.0f * h;
    if (warp == 0)
        for (int k = 0; k < min(NS, nt); ++k)
            blk.issue(k, W, &s_map, y0, nbx, lane);

    // ---- the geometry of stage k, once for the tile's samples: warp (mg,
    // s) = (warp / 4, warp % 4) owns the 16 x 8 tile of the half's rows mg *
    // 16 .. and the stage's k8 step s (window cell 4 k + s), lane the row
    // gr = mg * 16 + lane / 2 and the slots 4 gq .. 4 gq + 3 of the stage,
    // gq = 2 s + lane % 2. A tile whose boxes lie beyond h is skipped (its
    // values would all be 0); otherwise A = mag v_w (xw - xb)_d, the w6
    // tile sig_w v_w max(h^2 - d2, 0)^3, the tile's bits in word k % 3 and
    // the rowsum partial of (gr, gq), kept in shared memory (registers are
    // the scarcer). Slots past W sit at FAR with v = 0. ----
    const int gr = (warp / 4) * 16 + lane / 2;
    const int gq = 2 * (warp % 4) + lane % 2;
#pragma unroll
    for (int d = 0; d < D; ++d) rsp[d][gr][gq] = 0.0f;
    auto geometry = [&](int k) {
        const int mg = warp / 4;
        const int cw = k * (L::TW / CELL) + warp % 4;  // the window cell
        if (cw >= Wu || blk.far(cw, mg)) return;
        unsigned char* gt = blk.geo + (k & 1) * L::GEO;
        const int w0 = k * L::TW + gq * 4;
        float4 x4[D];
#pragma unroll
        for (int d = 0; d < D; ++d)
            x4[d] = *reinterpret_cast<const float4*>(blk.xw + d * blk.Wp + w0);
        const float4 v4 =
            *reinterpret_cast<const float4*>(blk.xw + D * blk.Wp + w0);
        float md[D][4], w6[4], rs[D];
#pragma unroll
        for (int d = 0; d < D; ++d) rs[d] = rsp[d][gr][gq];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            float r[D];
#pragma unroll
            for (int d = 0; d < D; ++d) r[d] = elem(x4[d], c) - xb[d][gr];
            float d2 = r[0] * r[0];
#pragma unroll
            for (int d = 1; d < D; ++d) d2 = d2 + r[d] * r[d];
            const float rsq = rsqrtf(d2 > 0.0f ? d2 : 1.0f);
            const float mag = (d2 > 0.0f && d2 < h2)
                ? 3.0f * ((h2 + d2) * rsq - two_h) : 0.0f;
            const float mv = mag * elem(v4, c);
#pragma unroll
            for (int d = 0; d < D; ++d) {
                md[d][c] = mv * r[d];
                rs[d] += md[d][c];
            }
            const float cc = fmaxf(h2 - d2, 0.0f);
            w6[c] = (cc * cc * cc) * (sig_w * elem(v4, c));
        }
        unsigned nz = 0;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            rsp[d][gr][gq] = rs[d];
            *reinterpret_cast<float4*>(
                gt + L::MD + swz<L::ROWB>(d * HALF + gr, gq * 16)) =
                make_float4(md[d][0], md[d][1], md[d][2], md[d][3]);
            if (warp_any(md[d])) nz |= 1u << ((2 * d + mg) * 4 + warp % 4);
        }
        *reinterpret_cast<float4*>(gt + L::W6 + swz<L::ROWB>(gr, gq * 16)) =
            make_float4(w6[0], w6[1], w6[2], w6[3]);
        if (warp_any(w6)) nz |= 1u << ((2 * D + mg) * 4 + warp % 4);
        if (lane == 0 && nz) atomicOr(&nzw[k % 3], nz);
    };
    geometry(0);
    __syncthreads();

    // ---- products ----
    const int wm = warp / NG;
    const int wn = warp % NG;
    const int g = lane / 4;
    const int t = lane % 4;
    const bool busy = wn * NJ / 2 < nbt;  // the warp's first sample is real
    // md m16 tile i of this warp (rows d * 32 + (mt % 2) * 16 of the half,
    // d = mt / 2), valid below 2 D
    auto mtile = [&](int i) { return ONE ? wm + 4 * i : wm + 2 * i; };
    const TileLane<float, L::ROWB> ln(g, t);
    float acc[MPW][NJ][4];
#pragma unroll
    for (int i = 0; i < MPW; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    float acc6[4] = {0.0f, 0.0f, 0.0f, 0.0f};

    for (int it = 0; it < nt; ++it) {
        if (threadIdx.x == 0) nzw[(it + 2) % 3] = 0;  // stage it - 1's
        if (it + 1 < nt) geometry(it + 1);
        const int nv = min(L::TW, W - it * L::TW);
        const unsigned char* gt = blk.geo + (it & 1) * L::GEO;
        const float* rhs = blk.stage(it);
        const unsigned nz = nzw[it % 3];

        if (busy) {
#pragma unroll
            for (int k0 = 0; k0 < L::TW; k0 += 8) {
                if (k0 >= nv) break;
                // cell box k0 / 8: (sample, slot, f) at (s * 8 + slot) * F;
                // its B fragments split at the step's first nonzero A tile
                const float* box = rhs + (k0 / CELL) * nbx * CELL * FF;
                uint32_t bb[NJ][2], bs[NJ][2];
                bool have_b = false;
#pragma unroll
                for (int i = 0; i < MPW; ++i) {
                    if (mtile(i) >= 2 * D
                        || !(nz >> (mtile(i) * 4 + k0 / 8) & 1))
                        continue;
                    AFrag<float, L::ROWB> a;
                    a.read(gt + L::MD, mtile(i) * 16, k0, g, ln);
                    if (!have_b) {
#pragma unroll
                        for (int j = 0; j < NJ; ++j) {
                            const int nj = wn * NJ + j;
                            const float* col = box + ((nj / 2) * CELL + t) * FF
                                + (nj % 2) * 8 + g;
                            split(col[0], bb[j][0], bs[j][0]);
                            split(col[4 * FF], bb[j][1], bs[j][1]);
                        }
                        have_b = true;
                    }
                    a.split_parts();
                    // with one n8 tile, each pass in sums of its own, so
                    // that the second's products need not wait for the
                    // first's adds
                    float c[NJ == 1 ? 2 : 1][NJ][4];
#pragma unroll
                    for (int pass = 0; pass < 2; ++pass) {
                        float (&cp)[NJ][4] = c[NJ == 1 ? pass : 0];
#pragma unroll
                        for (int j = 0; j < NJ; ++j)
                            if ((wn * NJ + j) / 2 < nbt)
                                product(pass, cp[j], a, bb[j], bs[j]);
#pragma unroll
                        for (int j = 0; j < NJ; ++j)
                            if ((wn * NJ + j) / 2 < nbt)
                                add4(acc[i][j], cp[j]);
                    }
                }
            }
        }
        // (sig_w v_w w6) @ alive on the tensor cores: warp w takes the k8
        // step w % 4 of the stage and the m16 tile w / 4 of the w6 tile, the
        // n8 tile of the samples' alive columns (1 or 0, exact in TF32, so
        // 2 products: A_small alive, A_big alive; columns past nbt are 0
        // and not stored)
        const int k0 = (warp % 4) * 8;
        if (k0 < nv && (nz >> ((2 * D + warp / 4) * 4 + warp % 4) & 1)) {
            AFrag<float, L::ROWB> a6;
            a6.read(gt + L::W6, (warp / 4) * 16, k0, g, ln);
            const float* vv = blk.xw + D * blk.Wp + it * L::TW;
            uint32_t cb[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int k = k0 + t + 4 * q;
                const bool alive = g < nbt && (use_alpha
                    ? rhs[((k / CELL) * nbx + g) * CELL * FF
                          + (k % CELL) * FF + 3] > thr
                    : vv[k] > 0.0f);
                cb[q] = alive ? 0x3f800000u : 0u;  // 1.0f or 0.0f
            }
            a6.split_parts();
            float c6[2][4];
            mma_tf32(c6[0], a6.small, cb[0], cb[1]);
            mma_tf32(c6[1], a6.big, cb[0], cb[1]);
            add4(acc6, c6[0]);
            add4(acc6, c6[1]);
        }
        __syncthreads();  // stage it and geometry buffer it & 1 consumed
        if (warp == 0 && it + NS < nt) {
            release_slot();
            blk.issue(it + NS, W, &s_map, y0, nbx, lane);
        }
    }

    // ---- the rowsums: a row's 8 partials, added as a butterfly would
    // (the last __syncthreads of the loop published them) ----
    if (gq == 0) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const float* q = rsp[d][gr];
            rowsum[d][gr] = ((q[0] + q[1]) + (q[2] + q[3]))
                + ((q[4] + q[5]) + (q[6] + q[7]));
        }
    }
    red[warp % 4][warp / 4][lane] =
        make_float4(acc6[0], acc6[1], acc6[2], acc6[3]);
    __syncthreads();

    // ---- epilogue: sig_g acc - S_b sig_g rowsum_d, d-major ----
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
        const int mt = mtile(i);
        if (mt >= 2 * D) continue;
        const int d = mt / 2;
#pragma unroll
        for (int up = 0; up < 2; ++up) {
            const int rr = (mt % 2) * 16 + g + 8 * up;  // row of the half
            const int p = hh * HALF + rr;
            const size_t row = (size_t)b * P + p;
            const float gs = sig_g * rowsum[d][rr];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int nj = wn * NJ + j;
                const int smp = nj / 2;
                if (smp >= nbt) continue;
                const int f = (nj % 2) * 8 + 2 * t;
                const float* abr = ab + (size_t)(y0 + smp) * ab_bs
                    + row * FF + f;
                const size_t bo = (size_t)(y0 + smp) * nb + b;
                *reinterpret_cast<float2*>(
                    ga + (bo * P + p) * (D * FF) + d * FF + f) =
                    make_float2(sig_g * acc[i][j][2 * up] - abr[0] * gs,
                                sig_g * acc[i][j][2 * up + 1] - abr[1] * gs);
            }
        }
    }
    // ---- sm: the 4 k phases' partial sums, added in a fixed order ----
    const int r = threadIdx.x / BT;      // row of the half, 0..31
    const int smp = threadIdx.x % BT;    // sample of the tile
    if (smp < nbt) {
        // (row r, column smp) is c[2 * up + smp % 2] of lane
        // (r % 8) * 4 + smp / 2 of the tile r / 16, up = r % 16 / 8
        const int src = (r % 8) * 4 + smp / 2;
        const int e = 2 * (r % 16 / 8) + smp % 2;
        float v = 0.0f;
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
            const float4 c4 = red[ph][r / 16][src];
            v += e == 0 ? c4.x : e == 1 ? c4.y : e == 2 ? c4.z : c4.w;
        }
        sm[((size_t)(y0 + smp) * nb + b) * P + hh * HALF + r] = v;
    }
}

// The mask kernel's dynamic shared memory, 16-byte aligned: two column
// buffers [2][BTC][CHUNK] (sig_w v_w alive_w of the tile's samples for a
// chunk of CHUNK window slots), the window's Wu cell indices, and its
// positions (RcWindow<D, D>: W rounded up to a slot group of CELL, FAR past
// W) with the far bits. One sample takes chunks of 1024 slots, 4 a thread:
// a window of up to 1024 slots is one chunk, gathered before the sums.
template <int D, int BTC>
struct MaskLayout {
    static constexpr int CHUNK = BTC == 1 ? 4 * TAB_THREADS : TAB_THREADS;
    static constexpr int SPT = CHUNK / TAB_THREADS;   // column slots a thread
    static constexpr int COL = BTC * CHUNK * 4;   // bytes of one buffer
    __host__ __device__ static constexpr int wpad(int W) {
        return (W + CELL - 1) / CELL * CELL;
    }
    __host__ __device__ static constexpr int cells(int Wu) {
        return (Wu * 4 + 15) / 16 * 16;
    }
    static constexpr int smem(int W, int Wu) {
        return 16 + 2 * COL + cells(Wu)
            + RcWindow<D, D>::bytes(wpad(W), wpad(W) / CELL);
    }
};

// sph_mask_kernel: sm[y, b, p] = sum_w sig_w max(h^2 - d2, 0)^3 v_w
// alive_w, alive_w = S[y][win(w), 3] > thr (use_alpha) or v_w > 0; grid (2
// nb row halves, ceil(B / BTC) sample tiles), 8 warps. Warp w owns the
// half's 16-row group mg = w / 4 and, of every chunk of CHUNK slots, the
// slot groups (of CELL slots) wq, wq + 4, .. (wq = w % 4); lane l the row mg
// * 16 + l / 2 and slots 4 (l % 2) .. + 3 of each of those groups. Per kept
// group (its far bit clear, a warp-uniform test) a thread computes the
// poly6 core of its 4 pairs once, from per-axis differences (d2 = r_0^2,
// then fmaf(r_d, r_d, d2): written out, so that every instantiation rounds
// alike), and adds it times each sample's column into that sample's sum
// with fmaf, slot after slot; a row's 8
// partial sums (2 lanes x 4 warps) are then added as ((l0 + l1) of warp 0 +
// .. of warp 1) + (.. of warp 2 + .. of warp 3). No order depends on B or
// on the sample's place in its tile. The column is gathered as
// sph_mask_tab_kernel gathers its own: thread t loads the volume and the
// samples' channel 3 of its slots of chunk j (slots j CHUNK + k 256 + t) at
// the start of chunk j - 1, keeps them in registers while that chunk is
// summed, and writes the column at its end (one __syncthreads a chunk).
template <int D, int BTC>
__global__ void __launch_bounds__(TAB_THREADS, BTC == 1 ? 5 : 4)
sph_mask_kernel(
    const float* __restrict__ xs_b,    // [nb, D, P]
    const float* __restrict__ S,       // [B][C*M, F] cell-layout state
    long long s_bs,                    // S's sample stride (elements)
    const float* __restrict__ xw_b,    // [nb, D, W]
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu]
    int B, int F, int M, int W, int Wu, float h, float sig_w, float thr,
    int use_alpha, int vec,
    float* __restrict__ sm)            // [B, nb, P]
{
    using L = MaskLayout<D, BTC>;
    constexpr int CHUNK = L::CHUNK;
    constexpr int SPT = L::SPT;
    constexpr int GPC = CHUNK / CELL;     // slot groups a chunk
    extern __shared__ unsigned char dyn[];
    __shared__ float xb[D][HALF];
    __shared__ float gbox[2][2][D];       // the 16-row groups' boxes
    __shared__ float red[4][HALF][BTC];   // a row's sums of each warp
    const int b = blockIdx.x / 2;
    const int hh = blockIdx.x % 2;        // rows hh*32 .. hh*32+31
    const int nb = gridDim.x / 2;
    const int y0 = blockIdx.y * BTC;      // first sample of the tile
    const int nbt = min(BTC, B - y0);     // samples of this tile
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    unsigned char* base = dyn + ((16u - (smem_u32(dyn) & 15u)) & 15u);
    float* col = reinterpret_cast<float*>(base);
    int* cells = reinterpret_cast<int*>(base + 2 * L::COL);
    const int Wp = L::wpad(W);
    const int ng = Wp / CELL;
    RcWindow<D, D> wnd;
    wnd.load(base + 2 * L::COL + L::cells(Wu), b, W, Wp, ng, xw_b, nullptr,
             vec);
    for (int i = threadIdx.x; i < Wu; i += blockDim.x)
        cells[i] = win[(size_t)b * Wu + i];
    for (int i = threadIdx.x; i < D * HALF; i += blockDim.x)
        xb[i / HALF][i % HALF] =
            xs_b[((size_t)b * D + i / HALF) * P + hh * HALF + i % HALF];
    __syncthreads();

    // ---- the column: slots w = j CHUNK + k 256 + thread of chunk j ----
    float vol[SPT], alpha[SPT][BTC];
    auto gather = [&](int j) {  // the loads, left in flight
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            const int w = j * CHUNK + k * TAB_THREADS + threadIdx.x;
            vol[k] = w < W ? vw_b[(size_t)b * W + w] : 0.0f;
            const size_t row = use_alpha && w < W
                ? (size_t)cells[w / M] * M + w % M : 0;
#pragma unroll
            for (int s = 0; s < BTC; ++s)
                alpha[k][s] = use_alpha && w < W && s < nbt
                    ? S[(size_t)(y0 + s) * s_bs + row * F + 3] : 0.0f;
        }
    };
    auto store = [&](int j) {
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            float* cb = col + (j & 1) * BTC * CHUNK + k * TAB_THREADS
                + threadIdx.x;
#pragma unroll
            for (int s = 0; s < BTC; ++s) {
                const bool alive =
                    use_alpha ? alpha[k][s] > thr : vol[k] > 0.0f;
                cb[s * CHUNK] = alive && s < nbt ? sig_w * vol[k] : 0.0f;
            }
        }
    };
    gather(0);  // in flight while the far bits are marked
    wnd.far_bits(ng, xb, gbox, h * h * 1.0001f);  // (ends in a sync)
    store(0);
    __syncthreads();

    // ---- the pair sums ----
    const int mg = warp / 4;
    const int wq = warp % 4;
    const int gr = mg * 16 + lane / 2;    // the thread's row of the half
    const int q = lane % 2;               // its slots 4q .. 4q + 3 a group
    float xr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xr[d] = xb[d][gr];
    const float h2 = __fmul_rn(h, h);
    float acc[BTC];
#pragma unroll
    for (int s = 0; s < BTC; ++s) acc[s] = 0.0f;
    const int nc = (W + CHUNK - 1) / CHUNK;
    for (int j = 0; j < nc; ++j) {
        if (j + 1 < nc) gather(j + 1);
        const float* cb = col + (j & 1) * BTC * CHUNK;
        for (int i = wq; i < GPC; i += 4) {
            const int cg = j * GPC + i;       // the slot group
            if (cg >= ng || wnd.far(cg, mg)) continue;
            const int k = i * CELL + 4 * q;   // the first slot, of the chunk
            float4 x4[D];
#pragma unroll
            for (int d = 0; d < D; ++d)
                x4[d] = *reinterpret_cast<const float4*>(
                    wnd.xw + d * Wp + j * CHUNK + k);
            float w6[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float d2 = 0.0f;
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    const float r = elem(x4[d], c) - xr[d];
                    d2 = d == 0 ? __fmul_rn(r, r) : __fmaf_rn(r, r, d2);
                }
                const float cc = fmaxf(__fsub_rn(h2, d2), 0.0f);
                w6[c] = __fmul_rn(__fmul_rn(cc, cc), cc);
            }
#pragma unroll
            for (int s = 0; s < BTC; ++s) {
                if (s >= nbt) break;
                const float4 c4 =
                    *reinterpret_cast<const float4*>(cb + s * CHUNK + k);
                acc[s] = fmaf(w6[0], c4.x, acc[s]);
                acc[s] = fmaf(w6[1], c4.y, acc[s]);
                acc[s] = fmaf(w6[2], c4.z, acc[s]);
                acc[s] = fmaf(w6[3], c4.w, acc[s]);
            }
        }
        if (j + 1 < nc) store(j + 1);
        __syncthreads();
    }

    // ---- a row's 8 partial sums, in a fixed order ----
#pragma unroll
    for (int s = 0; s < BTC; ++s) {
        const float v = acc[s] + __shfl_xor_sync(0xffffffffu, acc[s], 1);
        if (q == 0) red[wq][gr][s] = v;
    }
    __syncthreads();
    const int r = threadIdx.x / BTC;      // row of the half
    const int s = threadIdx.x % BTC;      // sample of the tile
    if (r < HALF && s < nbt)
        sm[((size_t)(y0 + s) * nb + b) * P + hh * HALF + r] =
            (red[0][r][s] + red[1][r][s]) + (red[2][r][s] + red[3][r][s]);
}

template <int D, int BTC>
__global__ void __launch_bounds__(TAB_THREADS, BTC <= 2 ? 3 : 2)
sph_bwd_kernel(
    const __grid_constant__ CUtensorMap g_map,  // G as [B, C*M, D*F]
    const float* __restrict__ xs_b,    // [nb, D, P]
    const float* __restrict__ vs_b,    // [nb, P] the rows' own volumes
    const float* __restrict__ gsum_b,  // [nb, P, D] adjoint self term
    const float* __restrict__ gb,      // [B][nb, P, D*F] the rows' cotangents
    long long gb_bs,                   // gb's sample stride (elements)
    const float* __restrict__ xw_b,    // [nb, D, W]
    const int* __restrict__ win,       // [nb, Wu] window cells
    int B, int W, int Wu, float h, float sig_g,
    float* __restrict__ da)            // [B, nb, P, F]
{
    using L = RcLayout<D, false, BTC>;
    constexpr int NS = L::NS;
    constexpr int NJ = BTC / 2;        // n8 tiles a warp: (sample, half of F)
    constexpr int DF = D * FF;
    extern __shared__ unsigned char dyn[];
    __shared__ uint64_t bars[NS];
    __shared__ int counts[NS];
    __shared__ float xb[D][HALF];
    // the forward's nonzero-tile words, bit (m16 tile) * 2 + (k8 step)
    __shared__ unsigned nzw[3];
    __shared__ float gbox[2][2][D];       // the 16-row groups' boxes
    const int b = blockIdx.x / 2;
    const int hh = blockIdx.x % 2;
    if (threadIdx.x < 3) nzw[threadIdx.x] = 0;
    for (int i = threadIdx.x; i < D * HALF; i += blockDim.x)
        xb[i / HALF][i % HALF] =
            xs_b[((size_t)b * D + i / HALF) * P + hh * HALF + i % HALF];
    RcBlock<D, false, BTC> blk;  // (init and far_bits end in a __syncthreads)
    blk.init(dyn, bars, counts, b, W, Wu, xw_b, nullptr, win);
    blk.far_bits(Wu, xb, gbox, h * h * 1.0001f);

    const int nb = gridDim.x / 2;
    const int y0 = blockIdx.y * BTC;
    const int nbt = min(BTC, B - y0);     // samples of this tile
    const int nbx = min(BTC, B);          // samples a cell box holds
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int nt = (W + L::TW - 1) / L::TW;
    const float h2 = h * h;
    const float two_h = 2.0f * h;
    if (warp == 0)
        for (int k = 0; k < min(NS, nt); ++k)
            blk.issue(k, W, &g_map, y0, nbx, lane);

    // ---- the geometry of stage k: warps (2 mg + s) * 2 + u own the 16 x 8
    // tile of the half's rows mg * 16 .. and the stage's k8 step s (window
    // cell 2 k + s), lane the row mg * 16 + u * 8 + lane / 4 and the slots 2
    // (lane % 4), + 1 of the step: A = mag (xb - xw)_d, skipped where the
    // boxes lie beyond h, and the tile's bits in word k % 3 ----
    const int mg = warp / 4;
    const int gs = (warp / 2) % 2;
    const int gr = mg * 16 + (warp % 2) * 8 + lane / 4;
    const int gc = gs * 8 + (lane % 4) * 2;  // slot of the stage
    auto geometry = [&](int k) {
        const int cw = k * (L::TW / CELL) + gs;  // the window cell
        if (cw >= Wu || blk.far(cw, mg)) return;
        unsigned char* gt = blk.geo + (k & 1) * L::GEO;
        const int w0 = k * L::TW + gc;
        float2 x2[D];
#pragma unroll
        for (int d = 0; d < D; ++d)
            x2[d] = *reinterpret_cast<const float2*>(blk.xw + d * blk.Wp + w0);
        float md[D][2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            float r[D];
#pragma unroll
            for (int d = 0; d < D; ++d) r[d] = xb[d][gr] - elem(x2[d], c);
            float d2 = r[0] * r[0];
#pragma unroll
            for (int d = 1; d < D; ++d) d2 = d2 + r[d] * r[d];
            const float rsq = rsqrtf(d2 > 0.0f ? d2 : 1.0f);
            const float mag = (d2 > 0.0f && d2 < h2)
                ? 3.0f * ((h2 + d2) * rsq - two_h) : 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) md[d][c] = mag * r[d];
        }
        unsigned nz = 0;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            *reinterpret_cast<float2*>(
                gt + L::MD + swz<L::ROWB>(d * HALF + gr, gc * 4)) =
                make_float2(md[d][0], md[d][1]);
            if (warp_any(md[d])) nz |= 1u << ((2 * d + mg) * 2 + gs);
        }
        if (lane == 0 && nz) atomicOr(&nzw[k % 3], nz);
    };
    geometry(0);
    __syncthreads();

    // ---- products ----
    const int wm = warp / 4;              // rows wm*16 .. wm*16+15 of the half
    const int wn = warp % 4;              // n8 tiles wn*NJ ..
    const int g = lane / 4;
    const int t = lane % 4;
    const bool busy = wn * NJ / 2 < nbt;
    const TileLane<float, L::ROWB> ln(g, t);
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

    for (int it = 0; it < nt; ++it) {
        if (threadIdx.x == 0) nzw[(it + 2) % 3] = 0;  // stage it - 1's
        if (it + 1 < nt) geometry(it + 1);
        const int nv = min(L::TW, W - it * L::TW);
        const unsigned char* gt = blk.geo + (it & 1) * L::GEO;
        const float* rhs = blk.stage(it);
        const unsigned nz = nzw[it % 3];
        if (busy) {
#pragma unroll
            for (int k0 = 0; k0 < L::TW; k0 += 8) {
                if (k0 >= nv) break;
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    if (!(nz >> ((2 * d + wm) * 2 + k0 / 8) & 1)) continue;
                    AFrag<float, L::ROWB> a;
                    a.read(gt + L::MD, d * HALF + wm * 16, k0, g, ln);
                    a.split_parts();
                    uint32_t bb[NJ][2], bs[NJ][2];
#pragma unroll
                    for (int j = 0; j < NJ; ++j) {
                        const int nj = wn * NJ + j;
                        const float* col = rhs
                            + (((k0 / CELL) * nbx + nj / 2) * CELL + t) * DF
                            + d * FF + (nj % 2) * 8 + g;
                        split(col[0], bb[j][0], bs[j][0]);
                        split(col[4 * DF], bb[j][1], bs[j][1]);
                    }
                    float c[NJ][4];
#pragma unroll
                    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
                        for (int j = 0; j < NJ; ++j)
                            if ((wn * NJ + j) / 2 < nbt)
                                product(pass, c[j], a, bb[j], bs[j]);
#pragma unroll
                        for (int j = 0; j < NJ; ++j)
                            if ((wn * NJ + j) / 2 < nbt) add4(acc[j], c[j]);
                    }
                }
            }
        }
        __syncthreads();  // stage it and geometry buffer it & 1 consumed
        if (warp == 0 && it + NS < nt) {
            release_slot();
            blk.issue(it + NS, W, &g_map, y0, nbx, lane);
        }
    }

    // ---- epilogue: sig_g v_b acc - sum_d gsum_d gbar_d ----
#pragma unroll
    for (int up = 0; up < 2; ++up) {
        const int p = hh * HALF + wm * 16 + g + 8 * up;
        const size_t row = (size_t)b * P + p;
        const float sv = sig_g * vs_b[row];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int nj = wn * NJ + j;
            const int smp = nj / 2;
            if (smp >= nbt) continue;
            const int f = (nj % 2) * 8 + 2 * t;
            const float* gbr = gb + (size_t)(y0 + smp) * gb_bs + row * DF + f;
            float t2[2] = {0.0f, 0.0f};
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float gs = gsum_b[row * D + d];
                t2[0] += gs * gbr[d * FF];
                t2[1] += gs * gbr[d * FF + 1];
            }
            const size_t bo = (size_t)(y0 + smp) * nb + b;
            *reinterpret_cast<float2*>(da + (bo * P + p) * FF + f) =
                make_float2(sv * acc[j][2 * up] - t2[0],
                            sv * acc[j][2 * up + 1] - t2[1]);
        }
    }
}

// ---- host side ----------------------------------------------------------

template <int D, int BTC>
int fwd_rc(const float* xs_b, const float* S, long long s_bs, const float* ab,
           long long ab_bs, const float* xw_b, const float* vw_b,
           const int* win, int B, int nb, int W, int Wu, float h, float sig_w,
           float sig_g, float thr, int use_alpha, float* ga, float* sm,
           cudaStream_t st) {
    using L = RcLayout<D, true, BTC>;
    CUtensorMap s_map;
    cudaError_t err = cell_map(&s_map, S, s_bs, FF, B, BTC);
    if (err == cudaSuccess)
        err = allow_smem((const void*)sph_fwd_kernel<D, BTC>);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(2 * nb, (B + BTC - 1) / BTC);
    sph_fwd_kernel<D, BTC><<<grid, TAB_THREADS, L::smem(W, Wu), st>>>(
        s_map, xs_b, ab, ab_bs, xw_b, vw_b, win, B, W, Wu, h, sig_w, sig_g,
        thr, use_alpha, ga, sm);
    return (int)cudaGetLastError();
}

template <int D, int BTC>
int bwd_rc(const float* xs_b, const float* vs_b, const float* gsum_b,
           const float* gb, long long gb_bs, const float* xw_b,
           const float* G, long long g_bs, const int* win, int B, int nb,
           int W, int Wu, float h, float sig_g, float* da, cudaStream_t st) {
    using L = RcLayout<D, false, BTC>;
    CUtensorMap g_map;
    cudaError_t err = cell_map(&g_map, G, g_bs, D * FF, B, BTC);
    if (err == cudaSuccess)
        err = allow_smem((const void*)sph_bwd_kernel<D, BTC>);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(2 * nb, (B + BTC - 1) / BTC);
    sph_bwd_kernel<D, BTC><<<grid, TAB_THREADS, L::smem(W, Wu), st>>>(
        g_map, xs_b, vs_b, gsum_b, gb, gb_bs, xw_b, win, B, W, Wu, h,
        sig_g, da);
    return (int)cudaGetLastError();
}

template <int D, int BTC>
int mask_rc(const float* xs_b, const float* S, long long s_bs,
            const float* xw_b, const float* vw_b, const int* win, int B,
            int nb, int F, int M, int W, int Wu, float h, float sig_w,
            float thr, int use_alpha, float* sm, cudaStream_t st) {
    using L = MaskLayout<D, BTC>;
    const cudaError_t err = allow_smem((const void*)sph_mask_kernel<D, BTC>);
    if (err != cudaSuccess) return (int)err;
    // the positions 16 bytes at a time where every row is 16-byte aligned
    const int vec =
        W % 4 == 0 && reinterpret_cast<uintptr_t>(xw_b) % 16 == 0;
    const dim3 grid(2 * nb, (B + BTC - 1) / BTC);
    sph_mask_kernel<D, BTC><<<grid, TAB_THREADS, L::smem(W, Wu), st>>>(
        xs_b, S, s_bs, xw_b, vw_b, win, B, F, M, W, Wu, h, sig_w, thr,
        use_alpha, vec, sm);
    return (int)cudaGetLastError();
}

// what the recompute forward and adjoint take: P = 64, F = 16, M = 8 slots a
// cell (one copy of 8 slots a window cell), W a multiple of M, D in {2, 3}
bool bad_rc(int P_, int F, int M, int D, int nb, int B, int W, int Wu) {
    return P_ != P || F != FF || M != CELL || (D != 2 && D != 3) || nb <= 0
        || B <= 0 || B > 65535 || W <= 0 || W % CELL || Wu != W / CELL;
}

}  // namespace

// Plain C launchers for ctypes: raw device pointers, sizes, sample strides
// and the caller's stream. All run on a grid of (2 nb row halves, tiles of
// 8 samples; the forward and the mask one of 1 for B = 1, the forward one
// of 2 for B = 2, the adjoint one of 2 for B <= 2). The forward and adjoint
// take 16-byte aligned state / cotangents, window positions and volumes,
// and M = 8 slots a cell; the mask any alignment, M and F >= 4. Each
// returns the CUDA error code of its set-up or launch (0 = ok).

extern "C" int sph_fwd_launch(
    const float* xs_b, const float* S, long long s_bs, const float* ab,
    long long ab_bs, const float* xw_b, const float* vw_b, const int* win,
    int B, int nb, int D, int F, int P_, int M, int W, int Wu, float h,
    float sig_w, float sig_g, float thr, int use_alpha, float* ga, float* sm,
    void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bad_rc(P_, F, M, D, nb, B, W, Wu)) return (int)cudaErrorInvalidValue;
    // tiles of 1 sample for B = 1, of 2 for B = 2 (see RcLayout and the
    // warp roles), else of 8
    auto f = D == 2
        ? (B == 1 ? fwd_rc<2, 1> : B == 2 ? fwd_rc<2, 2> : fwd_rc<2, BT>)
        : (B == 1 ? fwd_rc<3, 1> : B == 2 ? fwd_rc<3, 2> : fwd_rc<3, BT>);
    return f(xs_b, S, s_bs, ab, ab_bs, xw_b, vw_b, win, B, nb, W, Wu, h,
             sig_w, sig_g, thr, use_alpha, ga, sm, st);
}

extern "C" int sph_mask_launch(
    const float* xs_b, const float* S, long long s_bs, const float* xw_b,
    const float* vw_b, const int* win, int B, int nb, int D, int F, int P_,
    int M, int W, int Wu, float h, float sig_w, float thr, int use_alpha,
    float* sm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (P_ != P || F < 4 || nb <= 0 || B <= 0 || B > 65535 || M <= 0
        || W < 0 || W % M || Wu != W / M || (D != 2 && D != 3))
        return (int)cudaErrorInvalidValue;
    // tiles of 1 sample for B = 1, else of 8
    auto f = D == 2 ? (B == 1 ? mask_rc<2, 1> : mask_rc<2, BT>)
                    : (B == 1 ? mask_rc<3, 1> : mask_rc<3, BT>);
    return f(xs_b, S, s_bs, xw_b, vw_b, win, B, nb, F, M, W, Wu, h, sig_w,
             thr, use_alpha, sm, st);
}

extern "C" int sph_bwd_launch(
    const float* xs_b, const float* vs_b, const float* gsum_b,
    const float* gb, long long gb_bs, const float* xw_b, const float* Gc,
    long long g_bs, const int* win, int B, int nb, int D, int F, int P_,
    int M, int W, int Wu, float h, float sig_g, float* da, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bad_rc(P_, F, M, D, nb, B, W, Wu)) return (int)cudaErrorInvalidValue;
    auto f = D == 2 ? (B <= 2 ? bwd_rc<2, 2> : bwd_rc<2, BT>)
                    : (B <= 2 ? bwd_rc<3, 2> : bwd_rc<3, BT>);
    return f(xs_b, vs_b, gsum_b, gb, gb_bs, xw_b, Gc, g_bs, win, B, nb, W, Wu,
             h, sig_g, da, st);
}
