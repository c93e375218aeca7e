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
// Bound: ~16 operations a pair (~3 us at the gecko shapes) over ~4 MB (~1
// us), bound by operations. Design, simple first: one thread block per
// (bucket block, sample), 4 groups of 64 threads; thread (p, g) owns row p
// and every 4th slot of each 64-slot window tile (positions and the
// alive-weighted volumes staged in shared memory); the 4 partial sums meet
// in shared memory.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_ring.cuh"

namespace {

constexpr int G = 4;               // mask: thread groups splitting the window
constexpr int THREADS = P * G;     // mask
constexpr int TW = 64;             // mask: window slots staged per tile
constexpr float FAR = 1.0e6f;      // position of a tile's tail slots

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

// The block's shared memory (RcLayout): the TMA ring of the state or the
// cotangents (tile_ring.cuh's Ring, which also reads the window's cells),
// the geometry buffers, and the window's positions and volumes, read once.
template <int D, bool FWD, int BTC>
struct RcBlock {
    using L = RcLayout<D, FWD, BTC>;
    Ring<L::NS> ring;
    unsigned char* geo;   // two geometry buffers
    float* xw;            // [D][Wp] window positions ([Wp] volumes after)
    unsigned* farw;       // [2][nwd] bits: group and window cell far apart
    int nwd;              // words a group: (Wu + 31) / 32
    int Wp;

    // carve the dynamic shared memory; read the window's cells, positions
    // (FAR past W) and volumes (0 past W); end with a __syncthreads
    __device__ __forceinline__ void init(
        unsigned char* dyn, uint64_t* bars, int* counts, int b, int W,
        int Wu, const float* __restrict__ xw_b,
        const float* __restrict__ vw_b, const int* __restrict__ win) {
        ring.init(dyn, L::RHS, bars, counts, win + (size_t)b * Wu, Wu);
        geo = ring.base + L::NS * L::RHS + L::cells(Wu);
        Wp = L::wpad(W);
        xw = reinterpret_cast<float*>(geo + 2 * L::GEO);
        farw = reinterpret_cast<unsigned*>(xw + L::NX * Wp);
        nwd = (Wu + 31) / 32;
        const int w4 = Wp / 4;
        for (int i = threadIdx.x; i < L::NX * w4; i += blockDim.x) {
            const int d = i / w4;
            const int w = (i - d * w4) * 4;
            float4 v = d < D ? make_float4(FAR, FAR, FAR, FAR)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (w < W)
                v = *reinterpret_cast<const float4*>(
                    d < D ? xw_b + ((size_t)b * D + d) * W + w
                          : vw_b + (size_t)b * W + w);
            *reinterpret_cast<float4*>(xw + d * Wp + w) = v;
        }
        __syncthreads();
    }

    // the far bits: for the half's two 16-row groups (rows of xb [D][32])
    // and each window cell, whether their bounding boxes lie more than h
    // apart (the boxes' gap, squared, above cut: h^2 and a margin above the
    // pairs' own rounding). A slot or row of a pad sits near PAD_POS and
    // stays in its box, so that a tile is culled only where every pair of it
    // is beyond h. Ends with a __syncthreads.
    __device__ __forceinline__ void far_bits(int Wu, const float (*xb)[HALF],
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
        // a warp a word: lanes the cells of word i % nwd of group i / nwd
        for (int i = threadIdx.x; i < 2 * nwd * 32; i += blockDim.x) {
            const int mg = i / (nwd * 32);
            const int c = i - mg * nwd * 32;
            bool far = false;
            if (c < Wu) {
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

    // whether window cell c and 16-row group mg are far apart
    __device__ __forceinline__ bool far(int c, int mg) const {
        return farw[mg * nwd + c / 32] >> (c % 32) & 1;
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

// what the recompute forward and adjoint take: P = 64, F = 16, M = 8 slots a
// cell (one copy of 8 slots a window cell), W a multiple of M, D in {2, 3}
bool bad_rc(int P_, int F, int M, int D, int nb, int B, int W, int Wu) {
    return P_ != P || F != FF || M != CELL || (D != 2 && D != 3) || nb <= 0
        || B <= 0 || B > 65535 || W <= 0 || W % CELL || Wu != W / CELL;
}

}  // namespace

// Plain C launchers for ctypes: raw device pointers, sizes, sample strides
// and the caller's stream. The forward and adjoint run on a grid of (2 nb
// row halves, tiles of 8 samples; the forward one of 1 for B = 1 and of 2
// for B = 2, the adjoint one of 2 for B <= 2) and take 16-byte aligned
// state / cotangents, window positions and volumes; the mask on (nb
// blocks, B samples). Each returns the CUDA error code of its set-up or
// launch (0 = ok).

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
    if (bad_rc(P_, F, M, D, nb, B, W, Wu)) return (int)cudaErrorInvalidValue;
    auto f = D == 2 ? (B <= 2 ? bwd_rc<2, 2> : bwd_rc<2, BT>)
                    : (B <= 2 ? bwd_rc<3, 2> : bwd_rc<3, BT>);
    return f(xs_b, vs_b, gsum_b, gb, gb_bs, xw_b, Gc, g_bs, win, B, nb, W, Wu,
             h, sig_g, da, st);
}
