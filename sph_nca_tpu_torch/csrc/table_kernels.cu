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
// in their type; every product is f32-accurate and every sum f32, and the
// right-hand sides (v_w S_w, v_w X_w, the alive column, the cotangents) stay
// f32, since quantizing them would bring back the |A| * eps error the gsum
// removes. Pad rows (v_b = 0, gsum = 0, md and w6 rows of zeros) come out as
// exact zeros.
//
// ---- sph_fwd_tab_kernel and sph_bwd_tab_kernel -------------------------
//
// Bound on this card. At the training shapes (f32 tables, B = 8, D = 3, F =
// 16; 237 + 79 blocks at W = 536 / 680, 185 MB of tables) one forward call
// must read md and w6 once (~0.07 ms at 3.35 TB/s); its dense products are
// 2 * 192 * 16 * 180,752 * 8 = 8.9 GFLOP (~0.13 ms at the 67 TFLOP/s fp32
// rate), of which only the pairs within h (~12%) are not zero. Bound by
// BYTES, the table read, once per sample tile (not once per sample).
//
// One table read per sample tile. A thread block owns one half of a block's
// rows (P/2 = 32 rows: the forward's D*32 md rows and 32 w6 rows, the
// adjoint's D*32 md rows) and a tile of BT = 8 samples; the grid is
// (2 nb, ceil(B / BT)). The forward is one product [D*32, W] @ [W, BT*F]
// per thread block plus [32, W] @ [W, BT] for w6; the adjoint is [32, D*W]
// @ [D*W, BT*F], K running over (w, d). Halving the rows (rather than one
// thread block a table block) gives 474 + 158 thread blocks of the forward
// at the training shapes, two resident on each of the 132 SMs.
//
// Tensor cores at f32 accuracy: mma.sync.m16n8k8 TF32 with the operands
// split, "3xTF32": x = big + small, big and small x and x - big rounded to
// TF32 (to nearest, ties away, by integer arithmetic: cvt.rna.tf32.f32
// costs more); acc += A_small B_big + A_big B_small + A_big B_big. A bf16
// table entry is exact in TF32, so bf16 tables take 2 products (A B_small +
// A B_big). One TF32 product would leave an error of |A| 2^-11 that the
// gsum cannot cancel (tests/test_torch_tf32_split.py emulates both on the
// CPU). The tensor core's f32 sums are truncated, not rounded: each k8
// step's products go into fresh sums, the small terms and the big one
// apart, which are added to the running sums in round-to-nearest f32 (see
// product()). The split is made in registers as the fragments are loaded;
// wgmma, whose TF32 operands come from shared memory, K-major, would need
// the split, transposed right-hand side staged there twice and M tiles of
// 64 rows (ROADMAP). Most 16 x 8 tiles of a table are all zero (only the
// pairs within h are not): a warp vote on the A fragment skips their split
// and products, which would add exact zeros; which tiles are skipped
// depends on the table only.
//
// A ring of NS = 3 shared-memory stages (more for B <= 2) fed by the TMA. Per
// stage one warp posts the stage's byte count on its "full" mbarrier and
// issues one TMA copy of the md tile (a 4D map [nb*D, 2, 32, W], box [D, 1,
// 32, TW]: the D row groups of this half in one request), one of the w6 tile
// (the same view, one group), both with an L2 evict-first policy so that the
// state and the cotangents, read by ~9 windows each, stay in L2 while the
// tables stream past, and one bulk copy of v_w; then its lane c copies window
// cell c of the stage for the tile's samples, one TMA box of a 4D map of the
// cell-layout tensor ([B, C, R, E]: a sample's cell is one contiguous run of 8
// x F floats of S, 8 x D*F of G, seen as R rows of E <= 256 floats, so that
// the TMA makes few, long requests). Warp 0 issues the first NS stages; after
// that the warp that leaves a stage last (a count in shared memory) refills
// its slot at once, so no warp waits for a free one. The window's cell indices
// are read into shared memory at the start. Copies past W are not made: the
// TMA fills the table tile's tail, and the box's samples past B, with zeros,
// and the warps stop at the last valid 8-slot step. Table tiles are TW slots
// wide (forward 32, adjoint 16) and stored with the TMA's 128 B / 64 B / 32 B
// swizzle (the tile row's width), which makes the A-fragment reads
// conflict-free.
//
// Warps: 8, as 2 (rows) x 4 (sample pairs). A warp owns 16*D md rows (D m16
// tiles) in the forward, 16 rows in the adjoint, and the 4 n8 tiles of its
// two samples; v_w is applied and the right-hand side split while the B
// fragments are loaded. A warp whose samples lie past B (a ragged last
// tile, or B < 8) skips their products. The forward's w6 product runs on
// the tensor cores too, one n8 tile of the 8 samples' alive columns: warp
// (m, n) takes w6 tile m at the k8 step n of each stage, and the 4 partial
// sums are added in a fixed order at the end.
//
// Per thread block (3 stages): forward D = 3 f32 102,400 B of dynamic
// shared memory (and the window's cell indices) + 4 KB static, 128
// registers; adjoint D = 3 f32 96,256 B, ~80 registers: two blocks an SM,
// 8 warps each (with 9, two blocks' odd warps share one sub-partition's
// 16 K registers and ptxas allows 96 a thread, which spilled). chip_smoke.py
// prints ptxas's counts. The sums of one sample do not depend on B or on
// the sample's place in its tile (the k order is the block's and W's only),
// so one launch of B samples equals B launches of one, bit for bit.
//
// ---- sph_mask_tab_kernel ------------------------------------------------
//
// Bound on this card. At the training shapes (f32 tables, B = 8) a call must
// read w6 once (46.3 MB, ~0.014 ms at 3.35 TB/s); its products are 2 * 64 *
// 180,752 * 8 = 0.19 GFLOP, ~3 us at the fp32 CUDA-core rate. Bound by
// BYTES: the table read, once per sample tile. The tensor cores are not
// needed: each 16-byte table read feeds 8 samples x 4 (f32) or 8 (bf16)
// FMAs.
//
// The design is 2.4's: a thread block owns half a block's rows and a tile of
// BT = 8 samples (a second instantiation takes 2 for B <= 2, the surface
// path), so each table tile is read once per sample tile; the grid (2 nb,
// ceil(B / BT)) gives 474 + 158 thread blocks at the training shapes (one
// launch a bucket). A stage is the half's 32 rows x 512 bytes of w6 (128 f32
// or 256 bf16 slots), one TMA box, unswizzled; the stages stream through a
// ring of NS = 3 (2.4's Ring, tma_4d and table map), and three blocks an SM
// (__launch_bounds__(256, 3)) keep up to 144 KB of table in flight on each
// SM, where Little's law at 3.35 TB/s and ~1 us asks for ~25 KB. Stages of
// 512-byte rows, where 2.4 takes 128, cut the ring round trips a block waits
// on fourfold: a block's rows are only 536-1000 slots wide. The alive
// column, a gathered channel of the state, is outside the TMA's reach; the
// block gathers it one chunk of 256 slots ahead into shared memory (see the
// kernel). Per thread block (f32 or bf16, B = 8): 66,560 B of dynamic
// shared memory and the window's cells. ptxas (sm_90a, CUDA 12.8): 72
// registers (f32, 8-sample tiles), 48 (f32, 2), 80 with 48 bytes spilled
// (bf16, 8), 71 (bf16, 2); chip_smoke.py prints the counts of the build it
// runs.
//
// ---- sph_blur_tab_kernel ---------------------------------------------------
//
// Bound on this card. At the surface shapes (bf16 tables, B = 1, F = 4; 370
// + 124 blocks at W = 576 / 1000) a call must read w6 once (43 MB, ~0.013 ms
// at 3.35 TB/s): bound by BYTES, the table read once per sample tile. At B =
// 8 the dense FMAs (every table entry times 32 columns, 0.69 G FMA) take
// ~0.02 ms at the fp32 CUDA-core rate, so a batch is bound by those.
//
// The design is the mask table kernel's (its stages, ring and table map:
// the half's rows, sample tiles, 512-byte stages of w6 by TMA, columns
// gathered a chunk ahead) with 4 columns a sample (v_w X_w), copied into
// shared memory with cp.async (the state rows a gathered set of cells, out
// of the TMA's reach; no registers wait on them while a chunk is summed)
// and scaled by v_w in place once they land. B = 1, the surface path, takes
// tiles of 1 sample (4 columns, three blocks an SM); B > 1 tiles of 4 (16
// columns, two blocks an SM), the tiles of a row half adjacent in the grid,
// so that the later ones read its table from L2, the 16 columns split
// between the warps so that each column value read feeds 8 rows. The
// columns of a stage sit so that the lanes' reads are conflict-free with
// bf16 tables too, and the 32 lanes' sums are added by recursive halving
// (see the kernel). One body with the mask's was tried: the same sums, but
// the mask slower at the training shapes, so each keeps its own. Per
// thread block (bf16, 4 samples): 48 KB of stages, 32 KB of column buffers
// and the window's cells. chip_smoke.py prints ptxas's counts.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "tile_ring.cuh"

namespace {

// 16 bytes of table -> V floats (mask, blur)
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

// 4 table entries (16 bytes of f32, 8 of bf16) -> 4 floats
__device__ __forceinline__ void unpack4(const unsigned char* p, float* out,
                                        float) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack4(const unsigned char* p, float* out,
                                        __nv_bfloat16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = lo.x;
    out[1] = lo.y;
    out[2] = hi.x;
    out[3] = hi.y;
}

// ---- shared-memory layout of one stage -----------------------------------

// Forward (FWD) or adjoint stage of table type T at D for sample tiles of
// BTC samples: the md tile [D*32][TW], the w6 tile [32][TW] (forward), the
// window's state (K = F floats a slot) or cotangents (K = D*F) as TW / 8
// cell boxes [nbx][8][K] of the tile's nbx = min(B, BTC) samples, and v_w
// (forward). Table tiles start 1024-byte aligned, as the 128 B swizzle
// needs; cell boxes 128-byte aligned, as the TMA needs. NS stages: 3 with
// tiles of 8 samples (two blocks an SM), more with tiles of 2 (B <= 2, the
// surface path: the stages are smaller, and more of them in flight hide
// the copies' latency when few warps have products to do).
template <typename T, int D, bool FWD, int BTC>
struct Stage {
    static constexpr int TW = FWD ? 32 : 16;
    static constexpr int ROWB = TW * (int)sizeof(T);  // 128, 64 or 32
    static constexpr int K = FWD ? FF : D * FF;       // floats per slot
    static constexpr int MD = 0;
    static constexpr int W6 = MD + D * HALF * ROWB;
    static constexpr int RHS = W6 + (FWD ? HALF * ROWB : 0);
    static constexpr int V = RHS + BTC * TW * K * 4;
    static constexpr int END = V + (FWD ? TW * 4 : 0);
    static constexpr int BYTES = (END + 1023) / 1024 * 1024;
    static constexpr int NS = BTC == BT ? 3 : FWD ? 5 : 8;
    // dynamic shared memory of a launch: the stages, the window's Wu cell
    // indices and 1024 bytes of alignment slack
    static constexpr int smem(int Wu) {
        return 1024 + NS * BYTES + (Wu * 4 + 15) / 16 * 16;
    }
    static_assert(W6 % 1024 == 0 && RHS % 1024 == 0 && V % 16 == 0
                  && CELL * K * 4 % 128 == 0, "tile alignment");
};

template <typename T, int D, int BTC>
__global__ void __launch_bounds__(TAB_THREADS, 2) sph_fwd_tab_kernel(
    const __grid_constant__ CUtensorMap md_map,  // md as [nb*D, 2, 32, W]
    const __grid_constant__ CUtensorMap w6_map,  // w6 as [nb, 2, 32, W]
    const __grid_constant__ CUtensorMap s_map,   // S as [B, C*M, F]
    const float* __restrict__ gsum_b,  // [nb, P, D]
    const float* __restrict__ ab,      // [B][nb, P, F] the blocks' own rows
    long long ab_bs,
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu] window cells
    int B, int W, int Wu, float sig_w, float sig_g, float thr,
    int use_alpha,
    float* __restrict__ ga,            // [B, nb, P, D*F]
    float* __restrict__ sm)            // [B, nb, P]
{
    using L = Stage<T, D, true, BTC>;
    constexpr int TW = L::TW;
    constexpr int NS = L::NS;
    extern __shared__ unsigned char dyn[];
    __shared__ uint64_t bars[NS];
    __shared__ int counts[NS];
    // the w6 product's partial sums: [k phase][m16 tile][lane][4]
    __shared__ float4 red[4][2][32];
    Ring<NS> ring;
    ring.init(dyn, L::BYTES, bars, counts, win + (size_t)(blockIdx.x / 2) * Wu,
              Wu);

    const int nb = gridDim.x / 2;
    const int b = blockIdx.x / 2;
    const int hh = blockIdx.x % 2;        // rows hh*32 .. hh*32+31
    const int y0 = blockIdx.y * BTC;      // first sample of the tile
    const int nbt = min(BTC, B - y0);     // samples of this tile
    const int nbx = min(BTC, B);          // samples a cell box holds
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int nt = (W + TW - 1) / TW;

    // ---- the copies of stage k into slot k % NS, by one warp ----
    const uint64_t pol = evict_first_policy();
    auto issue = [&](int k) {
        const int s = k % NS;
        const int t0 = k * TW;
        const int nv = min(TW, W - t0);
        unsigned char* st = ring.base + s * L::BYTES;
        const int cell = lane < nv / CELL ? ring.cells[t0 / CELL + lane] : 0;
        if (lane == 0) {
            bar_expect(&ring.full[s],
                       L::RHS + (nv / CELL) * nbx * CELL * FF * 4 + nv * 4);
            tma_4d(st + L::MD, &md_map, t0, 0, hh, b * D, &ring.full[s], pol);
            tma_4d(st + L::W6, &w6_map, t0, 0, hh, b, &ring.full[s], pol);
            bulk_copy(st + L::V, vw_b + (size_t)b * W + t0, nv * 4,
                      &ring.full[s]);
        }
        __syncwarp();
        if (lane < nv / CELL)  // lane c: window cell c of the tile's samples
            tma_cell(st + L::RHS + lane * nbx * CELL * FF * 4, &s_map, cell,
                     y0, &ring.full[s]);
    };
    if (warp == 0)
        for (int k = 0; k < min(NS, nt); ++k) issue(k);

    // ---- products ----
    const int wm = warp / 4;  // md m16 tiles wm*D .. wm*D+D-1; w6 tile wm
    const int wn = warp % 4;  // samples 2wn, 2wn+1; w6 k8 step wn a stage
    const int s0 = 2 * wn;
    const int g = lane / 4;
    const int t = lane % 4;
    const TileLane<T, L::ROWB> ln(g, t);
    float acc[D][4][4];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    float acc6[4] = {0.0f, 0.0f, 0.0f, 0.0f};

    for (int it = 0; it < nt; ++it) {
        const int s = it % NS;
        const int nv = min(TW, W - it * TW);
        const unsigned char* st = ring.base + s * L::BYTES;
        const float* rhs = reinterpret_cast<const float*>(st + L::RHS);
        const float* vv = reinterpret_cast<const float*>(st + L::V);
        bar_wait(&ring.full[s], (it / NS) & 1);

        if (s0 < nbt) {
#pragma unroll
            for (int k0 = 0; k0 < TW; k0 += 8) {
                if (k0 >= nv) break;
                AFrag<T, L::ROWB> a[D];
                bool nz[D], any = false;
#pragma unroll
                for (int i = 0; i < D; ++i) {
                    nz[i] = a[i].load(st + L::MD, (wm * D + i) * 16, k0, g,
                                      ln);
                    any |= nz[i];
                }
                if (!any) continue;
                const float v0 = vv[k0 + t];
                const float v1 = vv[k0 + t + 4];
                // cell box k0 / 8: (sample, slot, f) at (s * 8 + slot) * F
                const float* box = rhs + (k0 / CELL) * nbx * CELL * FF;
                uint32_t bb[4][2], bs[4][2];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float* col = box + ((s0 + j / 2) * CELL + t) * FF
                        + (j % 2) * 8 + g;
                    split(v0 * col[0], bb[j][0], bs[j][0]);
                    split(v1 * col[4 * FF], bb[j][1], bs[j][1]);
                }
#pragma unroll
                for (int i = 0; i < D; ++i) {
                    if (!nz[i]) continue;
                    a[i].split_parts();
                    // pass by pass: 4 independent products between two
                    // into the same registers
                    float c[4][4];
#pragma unroll
                    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            if (s0 + j / 2 < nbt)
                                product(pass, c[j], a[i], bb[j], bs[j]);
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            if (s0 + j / 2 < nbt) add4(acc[i][j], c[j]);
                    }
                }
            }
        }
        // w6 @ column, on the tensor cores as well: this warp's k8 step of
        // the stage, its m16 tile of w6, the n8 tile of the 8 samples
        // (columns past nbt are 0 and not stored)
        const int k0 = wn * 8;
        AFrag<T, L::ROWB> a6;
        if (k0 < nv && a6.load(st + L::W6, wm * 16, k0, g, ln)) {
            uint32_t cb[2], cs[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int k = k0 + t + 4 * h;
                const float v = vv[k];
                const bool alive = g < nbt && (use_alpha
                    ? rhs[((k / CELL) * nbx + g) * CELL * FF
                          + (k % CELL) * FF + 3] > thr
                    : v > 0.0f);
                split(alive ? sig_w * v : 0.0f, cb[h], cs[h]);
            }
            a6.split_parts();
#pragma unroll
            for (int pass = 0; pass < 2; ++pass) {
                float c6[4];
                product(pass, c6, a6, cb, cs);
                add4(acc6, c6);
            }
        }
        if (ring.leave(s, lane) && it + NS < nt) issue(it + NS);
    }

    // ---- epilogue: sig_g acc - S_b gsum_d, d-major ----
#pragma unroll
    for (int i = 0; i < D; ++i) {
        const int mt = wm * D + i;
        const int d = mt / 2;
#pragma unroll
        for (int up = 0; up < 2; ++up) {
            const int p = hh * HALF + (mt % 2) * 16 + g + 8 * up;
            const size_t row = (size_t)b * P + p;
            const float gs = gsum_b[row * D + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int smp = s0 + j / 2;
                if (smp >= nbt) continue;
                const int f = (j % 2) * 8 + 2 * t;
                const float* abr = ab + (size_t)(y0 + smp) * ab_bs
                    + row * FF + f;
                const size_t blk = (size_t)(y0 + smp) * nb + b;
                *reinterpret_cast<float2*>(
                    ga + (blk * P + p) * (D * FF) + d * FF + f) =
                    make_float2(sig_g * acc[i][j][2 * up] - abr[0] * gs,
                                sig_g * acc[i][j][2 * up + 1]
                                    - abr[1] * gs);
            }
        }
    }
    // ---- sm: the 4 k phases' partial sums, added in a fixed order ----
    red[wn][wm][lane] = make_float4(acc6[0], acc6[1], acc6[2], acc6[3]);
    __syncthreads();
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

template <typename T, int D, int BTC>
__global__ void __launch_bounds__(TAB_THREADS, 2) sph_bwd_tab_kernel(
    const __grid_constant__ CUtensorMap md_map,  // md as [nb*D, 2, 32, W]
    const __grid_constant__ CUtensorMap g_map,   // G as [B, C*M, D*F]
    const float* __restrict__ vs_b,    // [nb, P] the rows' own volumes
    const float* __restrict__ gsum_b,  // [nb, P, D]
    const float* __restrict__ gb,      // [B][nb, P, D*F] the rows' cotangents
    long long gb_bs,
    const int* __restrict__ win,       // [nb, Wu]
    int B, int W, int Wu, float sig_g,
    float* __restrict__ da)            // [B, nb, P, F]
{
    using L = Stage<T, D, false, BTC>;
    constexpr int TW = L::TW;
    constexpr int NS = L::NS;
    constexpr int DF = D * FF;
    extern __shared__ unsigned char dyn[];
    __shared__ uint64_t bars[NS];
    __shared__ int counts[NS];
    Ring<NS> ring;
    ring.init(dyn, L::BYTES, bars, counts, win + (size_t)(blockIdx.x / 2) * Wu,
              Wu);

    const int nb = gridDim.x / 2;
    const int b = blockIdx.x / 2;
    const int hh = blockIdx.x % 2;
    const int y0 = blockIdx.y * BTC;
    const int nbt = min(BTC, B - y0);     // samples of this tile
    const int nbx = min(BTC, B);          // samples a cell box holds
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int nt = (W + TW - 1) / TW;

    // ---- the copies (as in the forward) ----
    const uint64_t pol = evict_first_policy();
    auto issue = [&](int k) {
        const int s = k % NS;
        const int t0 = k * TW;
        const int ncell = min(TW, W - t0) / CELL;
        unsigned char* st = ring.base + s * L::BYTES;
        const int cell = lane < ncell ? ring.cells[t0 / CELL + lane] : 0;
        if (lane == 0) {
            bar_expect(&ring.full[s], L::RHS + ncell * nbx * CELL * DF * 4);
            tma_4d(st + L::MD, &md_map, t0, 0, hh, b * D, &ring.full[s], pol);
        }
        __syncwarp();
        if (lane < ncell)
            tma_cell(st + L::RHS + lane * nbx * CELL * DF * 4, &g_map, cell,
                     y0, &ring.full[s]);
    };
    if (warp == 0)
        for (int k = 0; k < min(NS, nt); ++k) issue(k);

    // ---- products ----
    const int wm = warp / 4;              // rows wm*16 .. wm*16+15 of the half
    const int s0 = 2 * (warp % 4);
    const int g = lane / 4;
    const int t = lane % 4;
    const TileLane<T, L::ROWB> ln(g, t);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

    for (int it = 0; it < nt; ++it) {
        const int s = it % NS;
        const int nv = min(TW, W - it * TW);
        const unsigned char* st = ring.base + s * L::BYTES;
        const float* rhs = reinterpret_cast<const float*>(st + L::RHS);
        bar_wait(&ring.full[s], (it / NS) & 1);
        if (s0 < nbt) {
#pragma unroll
            for (int k0 = 0; k0 < TW; k0 += 8) {
                if (k0 >= nv) break;
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    AFrag<T, L::ROWB> a;
                    if (!a.load(st + L::MD, d * HALF + wm * 16, k0, g, ln))
                        continue;
                    a.split_parts();
                    uint32_t bb[4][2], bs[4][2];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float* col = rhs
                            + (((k0 / CELL) * nbx + s0 + j / 2) * CELL + t)
                                * DF
                            + d * FF + (j % 2) * 8 + g;
                        split(col[0], bb[j][0], bs[j][0]);
                        split(col[4 * DF], bb[j][1], bs[j][1]);
                    }
                    float c[4][4];
#pragma unroll
                    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            if (s0 + j / 2 < nbt)
                                product(pass, c[j], a, bb[j], bs[j]);
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            if (s0 + j / 2 < nbt) add4(acc[j], c[j]);
                    }
                }
            }
        }
        if (ring.leave(s, lane) && it + NS < nt) issue(it + NS);
    }

    // ---- epilogue: -sig_g v_b acc - sum_d gsum_d gbar_d ----
#pragma unroll
    for (int up = 0; up < 2; ++up) {
        const int p = hh * HALF + wm * 16 + g + 8 * up;
        const size_t row = (size_t)b * P + p;
        const float sv = -sig_g * vs_b[row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int smp = s0 + j / 2;
            if (smp >= nbt) continue;
            const int f = (j % 2) * 8 + 2 * t;
            const float* gbr = gb + (size_t)(y0 + smp) * gb_bs + row * DF + f;
            float t2[2] = {0.0f, 0.0f};
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float gs = gsum_b[row * D + d];
                t2[0] += gs * gbr[d * FF];
                t2[1] += gs * gbr[d * FF + 1];
            }
            const float a0 = acc[j][2 * up];
            const float a1 = acc[j][2 * up + 1];
            const size_t blk = (size_t)(y0 + smp) * nb + b;
            *reinterpret_cast<float2*>(da + (blk * P + p) * FF + f) =
                make_float2(sv * a0 - t2[0], sv * a1 - t2[1]);
        }
    }
}

// sph_mask_tab_kernel: sm[y, b, p] = sum_w w6[b, p, w] col[y, w], col[y, w] =
// sig_w v_w alive_w (alive from channel 3 of the F-channel state S, or v_w >
// 0). A thread block owns one half of a block's rows and a tile of BTC samples
// (8, or 2 for B <= 2); the grid is (2 nb, ceil(B / BTC)). A stage is the
// half's 32 rows x SEG = 512 bytes of w6 (TW = 128 f32 / 256 bf16 slots), one
// TMA box, unswizzled; stages stream through the ring (tile_ring.cuh's Ring;
// the warp that leaves a stage last refills it). The column is not in the
// TMA's reach (a gathered channel of the state): the block's threads gather
// it, one chunk of CHUNK slots ahead, for the tile's samples into a double
// buffer [2][BTC][CHUNK]: a thread loads slot w's volume and the samples'
// channel 3 at the start of a chunk, keeps them in registers while the chunk's
// stages are summed, and writes the column at its end (one __syncthreads a
// chunk). Warp w sums rows 4w .. 4w + 3, lane q the 16-byte piece q of each (a
// warp reads 512 contiguous bytes a row: no bank conflicts), against the
// samples' columns: each table read feeds BTC x 4 (f32) or BTC x 8 (bf16)
// FMAs, each column read 4 rows. The 32 pieces of a row are added by a
// butterfly of shuffles. Every sum of a sample is taken in the same order
// whatever B and the sample's place in its tile, so one launch of B samples
// equals B launches of one, bit for bit.
template <typename T, int BTC>
struct MaskStage {
    static constexpr int SEG = 512;                   // bytes of a row
    static constexpr int TW = SEG / (int)sizeof(T);   // slots of a stage
    static constexpr int BYTES = HALF * SEG;          // one w6 box
    static constexpr int NS = 3;
    static constexpr int CHUNK = TAB_THREADS;         // column slots a chunk
    static constexpr int COL = CHUNK * BTC * 4;       // one column buffer
    static constexpr int RPW = HALF / WARPS_T;        // rows a warp
    __host__ __device__ static constexpr int cells(int Wu) {
        return (Wu * 4 + 15) / 16 * 16;
    }
    // dynamic shared memory of a launch: 1024 bytes of alignment slack, the
    // stages, the window's Wu cell indices and the two column buffers
    static constexpr int smem(int Wu) {
        return 1024 + NS * BYTES + cells(Wu) + 2 * COL;
    }
    static_assert(CHUNK % TW == 0, "a chunk holds whole stages");
};

template <typename T, int BTC>
__global__ void __launch_bounds__(TAB_THREADS, 3) sph_mask_tab_kernel(
    const __grid_constant__ CUtensorMap w6_map,  // w6 as [nb, 2, 32, W]
    const float* __restrict__ S,       // [B][C*M, F]
    long long s_bs, int F,
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu] window cells
    int B, int M, int W, int Wu, float sig_w, float thr, int use_alpha,
    float* __restrict__ sm)            // [B, nb, P]
{
    using L = MaskStage<T, BTC>;
    constexpr int TW = L::TW;
    constexpr int NS = L::NS;
    constexpr int CHUNK = L::CHUNK;
    constexpr int SPC = CHUNK / TW;    // stages a chunk
    constexpr int RPW = L::RPW;
    constexpr int V = Vec<T>::N;       // slots of a 16-byte piece
    extern __shared__ unsigned char dyn[];
    __shared__ uint64_t bars[NS];
    __shared__ int counts[NS];
    Ring<NS> ring;
    const int b = blockIdx.x / 2;
    const int hh = blockIdx.x % 2;        // rows hh*32 .. hh*32+31
    ring.init(dyn, L::BYTES, bars, counts, win + (size_t)b * Wu, Wu);
    float* col = reinterpret_cast<float*>(ring.base + NS * L::BYTES
                                          + L::cells(Wu));

    const int nb = gridDim.x / 2;
    const int y0 = blockIdx.y * BTC;      // first sample of the tile
    const int nbt = min(BTC, B - y0);     // samples of this tile
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int nt = (W + TW - 1) / TW;
    const int nc = (W + CHUNK - 1) / CHUNK;

    const uint64_t pol = evict_first_policy();
    auto issue = [&](int k) {  // one thread: the w6 box of stage k
        const int s = k % NS;
        bar_expect(&ring.full[s], L::BYTES);
        tma_4d(ring.base + s * L::BYTES, &w6_map, k * TW, 0, hh, b,
               &ring.full[s], pol);
    };
    if (threadIdx.x == 0)
        for (int k = 0; k < min(NS, nt); ++k) issue(k);

    // ---- the column: slot w = j CHUNK + thread of chunk j ----
    float vol = 0.0f, alpha[BTC];
    auto gather = [&](int j) {  // the loads, left in flight
        const int w = j * CHUNK + threadIdx.x;
        vol = w < W ? vw_b[(size_t)b * W + w] : 0.0f;
        const size_t row = use_alpha && w < W
            ? (size_t)ring.cells[w / M] * M + w % M : 0;
#pragma unroll
        for (int s = 0; s < BTC; ++s)
            alpha[s] = use_alpha && w < W && s < nbt
                ? S[(size_t)(y0 + s) * s_bs + row * F + 3] : 0.0f;
    };
    auto store = [&](int j) {
        float* cb = col + (j & 1) * BTC * CHUNK + threadIdx.x;
#pragma unroll
        for (int s = 0; s < BTC; ++s) {
            const bool alive = use_alpha ? alpha[s] > thr : vol > 0.0f;
            cb[s * CHUNK] = alive && s < nbt ? sig_w * vol : 0.0f;
        }
    };
    gather(0);
    store(0);
    __syncthreads();

    // ---- products: warp rows RPW * warp .., lane the 16-byte piece ----
    float acc[RPW][BTC];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int s = 0; s < BTC; ++s) acc[i][s] = 0.0f;

    for (int it = 0; it < nt; ++it) {
        const int j = it / SPC;
        if (it % SPC == 0 && j + 1 < nc) gather(j + 1);
        const int s = it % NS;
        bar_wait(&ring.full[s], (it / NS) & 1);
        const unsigned char* rows = ring.base + s * L::BYTES
            + warp * RPW * L::SEG + lane * 16;
        float tv[RPW][V];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
            unpack16(*reinterpret_cast<const uint4*>(rows + i * L::SEG),
                     tv[i], T());
        const float* cb = col + (j & 1) * BTC * CHUNK + (it % SPC) * TW
            + lane * V;
#pragma unroll
        for (int smp = 0; smp < BTC; ++smp) {
            if (smp >= nbt) break;
#pragma unroll
            for (int e = 0; e < V; e += 4) {
                const float4 c4 =
                    *reinterpret_cast<const float4*>(cb + smp * CHUNK + e);
#pragma unroll
                for (int i = 0; i < RPW; ++i) {
                    acc[i][smp] = fmaf(tv[i][e], c4.x, acc[i][smp]);
                    acc[i][smp] = fmaf(tv[i][e + 1], c4.y, acc[i][smp]);
                    acc[i][smp] = fmaf(tv[i][e + 2], c4.z, acc[i][smp]);
                    acc[i][smp] = fmaf(tv[i][e + 3], c4.w, acc[i][smp]);
                }
            }
        }
        if (ring.leave(s, lane) && lane == 0 && it + NS < nt) issue(it + NS);
        if (it % SPC == SPC - 1 || it == nt - 1) {  // the chunk's last stage
            if (j + 1 < nc) store(j + 1);
            __syncthreads();
        }
    }

    // ---- the 32 pieces of a row, added by a butterfly (the same sum in
    // every lane); lane i * BTC + s stores (row i, sample s) ----
    float out = 0.0f;
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int smp = 0; smp < BTC; ++smp) {
            float v = acc[i][smp];
#pragma unroll
            for (int off = 1; off < 32; off *= 2)
                v += __shfl_xor_sync(0xffffffffu, v, off);
            if (lane == i * BTC + smp) out = v;
        }
    const int i = lane / BTC, smp = lane % BTC;
    if (i < RPW && smp < nbt)
        sm[((size_t)(y0 + smp) * nb + b) * P + hh * HALF + warp * RPW + i] =
            out;
}

// 4-byte asynchronous copies into shared memory, waited for by the thread
// that issued them
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The 32 lanes' sums of N values a lane (N a power of 2), by recursive
// halving: at the step of offset o (1, 2, 4, 8, 16) each lane keeps half of
// its values, adds its partner's (lane ^ o) half of them and sends the other
// half, or, with one value left, adds its partner's. Every sum pairs the
// same lanes in the same order as the butterfly (v += shfl_xor(v, o)) and a
// + b = b + a, so each total is the butterfly's, bit for bit, for 62
// shuffles (N = 64) or 16 (N = 16) where the butterfly takes 5 N. Returns
// the index of v[0]'s value; the lane holds the totals first .. first +
// max(N / 32, 1) - 1 in v[0 ..].
template <int N>
__device__ __forceinline__ int halving_sum(float (&v)[N], int lane) {
    int first = 0;
    int n = N;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
        if (n > 1) {
            n /= 2;
            const bool up = lane & o;
#pragma unroll
            for (int k = 0; k < N / 2; ++k) {
                if (k >= n) break;
                const float send = up ? v[k] : v[k + n];
                const float keep = up ? v[k + n] : v[k];
                v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
            }
            if (up) first += n;
        } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
        }
    }
    return first;
}

// Where slot n of a chunk sits in a column buffer of the blur: within a
// 512-byte stage (TW slots, V a lane's 16-byte piece), slot q V + e of lane
// q's piece at (e / 4) (4 TW / V) + 4 q + e % 4, so that the lanes' reads
// of a quad of their slots are 16 consecutive bytes apiece (with bf16
// tables, V = 8, lanes 32 bytes apart would meet in the same banks 8 at a
// time); the identity for f32 tables (V = 4)
template <typename T>
__device__ __forceinline__ int stage_pos(int n) {
    constexpr int TW = 512 / (int)sizeof(T);
    constexpr int V = 16 / (int)sizeof(T);
    const int k = n % TW;
    return n - k + k % V / 4 * (4 * TW / V) + k / V * 4 + k % 4;
}

// sph_blur_tab_kernel: out[y, b, p, :] = sig_w sum_w w6[b, p, w] v_w
// X[y][win(w), :], F = 4 (the tangent diffusion's [m, m t]). The design is
// sph_mask_tab_kernel's (its MaskStage, Ring and table map: the half's 32
// rows, sample tiles, 512-byte stages of w6 by TMA, columns gathered a chunk
// ahead) with 4 columns a sample, v_w X_w: a tile of BTC samples is NC = 4
// BTC columns. B = 1, the surface path, takes tiles of 1 (8 warps x 4 rows,
// 4 columns); B > 1 tiles of 4, whose 16 columns the warps split in two (4
// warps x 8 rows along the rows, 2 x 8 columns), so that a column value read
// from shared memory feeds 8 rows (with 4 rows x 16 columns the column reads
// alone took as many shared-memory cycles as the FMAs took issue cycles);
// the tiles of a row half are adjacent in the grid (blockIdx.x = half x
// tiles + tile), so that the later ones read its table from L2. The
// columns: thread t copies slot j 256 + t's X rows of the tile's samples
// with cp.async into buffer j % 2 at the start of chunk j - 1 (no registers
// held while the chunk before is summed) and scales them by v_w in place at
// its end, once its own copies have landed (v_w X_w, the plain version's
// product); slots past W get zeros; a stage's values sit at stage_pos. Lane
// q sums its 16-byte piece of each of its warp's rows against each column,
// slot after slot, stage after stage (the table unpacked a quad at a time),
// and the 32 lanes' sums are added by recursive halving (halving_sum: the
// butterfly's sums, 62 shuffles for 64 where 64 butterflies take 320).
// Every sum of a sample is taken in the same
// order whatever B and the sample's place in its tile, so one launch of B
// samples equals B launches of one, bit for bit.
template <typename T, int BTC>
__global__ void __launch_bounds__(TAB_THREADS, BTC == 1 ? 3 : 2)
sph_blur_tab_kernel(
    const __grid_constant__ CUtensorMap w6_map,  // w6 as [nb, 2, 32, W]
    const float* __restrict__ X,       // [B][C*M, 4]
    long long x_bs,
    const float* __restrict__ vw_b,    // [nb, W]
    const int* __restrict__ win,       // [nb, Wu]
    int B, int M, int W, int Wu, float sig_w,
    float* __restrict__ out)           // [B, nb, P, 4]
{
    constexpr int K = 4;                  // columns a sample
    constexpr int NC = BTC * K;           // columns of a sample tile
    using L = MaskStage<T, NC>;           // 2.6's stages, NC columns
    constexpr int TW = L::TW;
    constexpr int NS = L::NS;
    constexpr int CHUNK = L::CHUNK;
    constexpr int SPC = CHUNK / TW;       // stages a chunk
    constexpr int V = Vec<T>::N;          // slots of a 16-byte piece
    constexpr int CS = BTC >= 4 ? 2 : 1;  // warps along the columns
    constexpr int WR = WARPS_T / CS;      // warps along the rows
    constexpr int RPW = HALF / WR;        // rows a warp
    constexpr int NCW = NC / CS;          // columns a warp
    extern __shared__ unsigned char dyn[];
    __shared__ uint64_t bars[NS];
    __shared__ int counts[NS];
    const int nty = (B + BTC - 1) / BTC;  // sample tiles
    const int b = blockIdx.x / nty / 2;
    const int hh = blockIdx.x / nty % 2;  // rows hh*32 .. hh*32+31
    const int y0 = blockIdx.x % nty * BTC;
    const int nbt = min(BTC, B - y0);     // samples of this tile
    const int nb = gridDim.x / (2 * nty);
    Ring<NS> ring;
    ring.init(dyn, L::BYTES, bars, counts, win + (size_t)b * Wu, Wu);
    float* col = reinterpret_cast<float*>(ring.base + NS * L::BYTES
                                          + L::cells(Wu));
    const float* vw = vw_b + (size_t)b * W;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wr = CS == 1 ? warp : warp % WR;  // rows wr*RPW ..
    const int wc = CS == 1 ? 0 : warp / WR;     // columns wc*NCW ..
    const int nt = (W + TW - 1) / TW;
    const int nc = (W + CHUNK - 1) / CHUNK;

    const uint64_t pol = evict_first_policy();
    auto issue = [&](int k) {  // one thread: the w6 box of stage k
        const int s = k % NS;
        bar_expect(&ring.full[s], L::BYTES);
        tma_4d(ring.base + s * L::BYTES, &w6_map, k * TW, 0, hh, b,
               &ring.full[s], pol);
    };
    if (threadIdx.x == 0)
        for (int k = 0; k < min(NS, nt); ++k) issue(k);

    // ---- the columns: slot w = j CHUNK + thread of chunk j, in buffer
    // j % 2 at the thread's stage_pos ----
    const int tpos = stage_pos<T>(threadIdx.x);
    float vol = 0.0f;
    auto gather = [&](int j) {  // the copies, left in flight
        const int w = j * CHUNK + threadIdx.x;
        float* c = col + (j & 1) * NC * CHUNK + tpos;
        if (w < W) {
            vol = vw[w];
            const size_t row = (size_t)ring.cells[w / M] * M + w % M;
#pragma unroll
            for (int s = 0; s < BTC; ++s)
                if (s < nbt)
#pragma unroll
                    for (int f = 0; f < K; ++f)
                        cp_async4(c + (s * K + f) * CHUNK,
                                  X + (size_t)(y0 + s) * x_bs + row * K + f);
            cp_async_commit();
        } else {
            vol = 0.0f;
#pragma unroll
            for (int i = 0; i < NC; ++i) c[i * CHUNK] = 0.0f;
        }
    };
    auto store = [&](int j) {  // the thread's own copies landed: v_w X_w
        if (j * CHUNK + (int)threadIdx.x >= W) return;
        cp_async_wait_all();
        float* c = col + (j & 1) * NC * CHUNK + tpos;
#pragma unroll
        for (int s = 0; s < BTC; ++s)
            if (s < nbt)
#pragma unroll
                for (int f = 0; f < K; ++f) c[(s * K + f) * CHUNK] *= vol;
    };
    gather(0);
    store(0);
    __syncthreads();

    // ---- products: lane the 16-byte piece of each of the warp's rows ----
    float acc[RPW][NCW];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int c = 0; c < NCW; ++c) acc[i][c] = 0.0f;

    for (int it = 0; it < nt; ++it) {
        const int j = it / SPC;
        if (it % SPC == 0 && j + 1 < nc) gather(j + 1);
        const int s = it % NS;
        bar_wait(&ring.full[s], (it / NS) & 1);
        const unsigned char* rows = ring.base + s * L::BYTES
            + wr * RPW * L::SEG + lane * 16;
        const float* cb = col + (j & 1) * NC * CHUNK + (it % SPC) * TW
            + lane * 4 + wc * NCW * CHUNK;
#pragma unroll
        for (int e = 0; e < V; e += 4) {  // the lane's quads of slots
            float tv[RPW][4];
#pragma unroll
            for (int i = 0; i < RPW; ++i)
                unpack4(rows + i * L::SEG + e * sizeof(T), tv[i], T());
#pragma unroll
            for (int c = 0; c < NCW; ++c) {
                if ((wc * NCW + c) / K >= nbt) break;
                const float4 c4 = *reinterpret_cast<const float4*>(
                    cb + c * CHUNK + e / 4 * (4 * TW / V));
#pragma unroll
                for (int i = 0; i < RPW; ++i) {
                    acc[i][c] = fmaf(tv[i][0], c4.x, acc[i][c]);
                    acc[i][c] = fmaf(tv[i][1], c4.y, acc[i][c]);
                    acc[i][c] = fmaf(tv[i][2], c4.z, acc[i][c]);
                    acc[i][c] = fmaf(tv[i][3], c4.w, acc[i][c]);
                }
            }
        }
        if (ring.leave(s, lane) && lane == 0 && it + NS < nt) issue(it + NS);
        if (it % SPC == SPC - 1 || it == nt - 1) {  // the chunk's last stage
            if (j + 1 < nc) store(j + 1);
            __syncthreads();
        }
    }

    // ---- each (row, column)'s 32 pieces (halving_sum); the lanes that
    // hold a total store sig_w times it ----
    constexpr int N = RPW * NCW;
    constexpr int PER = N / 32 > 0 ? N / 32 : 1;  // totals a lane holds
    float v[N];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int c = 0; c < NCW; ++c) v[i * NCW + c] = acc[i][c];
    const int first = halving_sum(v, lane);
    if (N < 32 && lane >= N) return;  // a copy of another lane's totals
#pragma unroll
    for (int e = 0; e < PER; ++e) {
        const int i = (first + e) / NCW;
        const int c = wc * NCW + (first + e) % NCW;
        if (c / K < nbt)
            out[(((size_t)(y0 + c / K) * nb + b) * P + hh * HALF + wr * RPW
                  + i) * K + c % K] = sig_w * v[e];
    }
}

bool bad_grid(int P_, int nb, int B, int W, int M) {
    return P_ != P || nb <= 0 || B <= 0 || B > 65535 || W <= 0 || W % 8
        || M <= 0 || W % M;
}

// The TMA map of a table [nb, rows, W] in type T, read in tiles of TW slots
// and `box` rows, swizzled by the tile row's width. With `groups` > 1 the
// table is seen as [nb*groups, 2, 32, W] (md: the D row groups of a block,
// each in two halves) and a box takes the D groups of one half. A map is a
// function of (table, nb, groups, W) alone, and an engine's tables stay put
// for its life, so maps are cached by those (only the state's or the
// cotangents' map is encoded per launch).
template <typename T, int TW>
cudaError_t table_map(CUtensorMap* map, const void* table, int nb, int groups,
                      int W) {
    using Key = std::tuple<const void*, int, int, int>;
    static std::mutex mu;
    static std::map<Key, CUtensorMap> cache;
    const Key key{table, nb, groups, W};
    std::lock_guard<std::mutex> lock(mu);
    const auto hit = cache.find(key);
    if (hit != cache.end()) {
        *map = hit->second;
        return cudaSuccess;
    }
    EncodeTiled enc = nullptr;
    cudaError_t err = encode_tiled(&enc);
    if (err != cudaSuccess) return err;
    constexpr int ROWB = TW * (int)sizeof(T);
    const CUtensorMapSwizzle sw = ROWB > 128 ? CU_TENSOR_MAP_SWIZZLE_NONE
        : ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
        : ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUtensorMapDataType dt = sizeof(T) == 4
        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const cuuint64_t row = (cuuint64_t)W * sizeof(T);
    const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)HALF, 2,
                                (cuuint64_t)nb * groups};
    const cuuint64_t strides[3] = {row, HALF * row, 2 * HALF * row};
    const cuuint32_t box[4] = {(cuuint32_t)TW, (cuuint32_t)HALF, 1,
                               (cuuint32_t)groups};
    const cuuint32_t one[4] = {1, 1, 1, 1};
    const CUresult r = enc(map, dt, 4, const_cast<void*>(table), dims,
                           strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           sw, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
    if (cache.size() >= 1024) cache.clear();  // tables freed and made anew
    cache.emplace(key, *map);
    return cudaSuccess;
}

template <typename T, int D, int BTC>
int fwd_tab(const void* md, const void* w6, const float* gsum, const float* S,
            long long s_bs, const float* ab, long long ab_bs, const float* vw,
            const int* win, int B, int nb, int W, int Wu, float sig_w,
            float sig_g, float thr, int use_alpha, float* ga, float* sm,
            cudaStream_t st) {
    using L = Stage<T, D, true, BTC>;
    CUtensorMap md_map, w6_map, s_map;
    cudaError_t err = table_map<T, L::TW>(&md_map, md, nb, D, W);
    if (err == cudaSuccess) err = table_map<T, L::TW>(&w6_map, w6, nb, 1, W);
    if (err == cudaSuccess) err = cell_map(&s_map, S, s_bs, FF, B, BTC);
    if (err == cudaSuccess)
        err = allow_smem((const void*)sph_fwd_tab_kernel<T, D, BTC>);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(2 * nb, (B + BTC - 1) / BTC);
    sph_fwd_tab_kernel<T, D, BTC><<<grid, TAB_THREADS, L::smem(Wu), st>>>(
        md_map, w6_map, s_map, gsum, ab, ab_bs, vw, win, B, W, Wu, sig_w,
        sig_g, thr, use_alpha, ga, sm);
    return (int)cudaGetLastError();
}

template <typename T, int D, int BTC>
int bwd_tab(const void* md, const float* vs, const float* gsum,
            const float* gb, long long gb_bs, const float* G, long long g_bs,
            const int* win, int B, int nb, int W, int Wu, float sig_g,
            float* da, cudaStream_t st) {
    using L = Stage<T, D, false, BTC>;
    CUtensorMap md_map, g_map;
    cudaError_t err = table_map<T, L::TW>(&md_map, md, nb, D, W);
    if (err == cudaSuccess) err = cell_map(&g_map, G, g_bs, D * FF, B, BTC);
    if (err == cudaSuccess)
        err = allow_smem((const void*)sph_bwd_tab_kernel<T, D, BTC>);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(2 * nb, (B + BTC - 1) / BTC);
    sph_bwd_tab_kernel<T, D, BTC><<<grid, TAB_THREADS, L::smem(Wu), st>>>(
        md_map, g_map, vs, gsum, gb, gb_bs, win, B, W, Wu, sig_g, da);
    return (int)cudaGetLastError();
}

template <typename T>
int fwd_tab_d(int D, const void* md, const void* w6, const float* gsum,
              const float* S, long long s_bs, const float* ab,
              long long ab_bs, const float* vw, const int* win, int B, int nb,
              int W, int Wu, float sig_w, float sig_g, float thr,
              int use_alpha, float* ga, float* sm, cudaStream_t st) {
    if (D != 2 && D != 3) return (int)cudaErrorInvalidValue;
    // tiles of 2 samples for B <= 2 (see Stage), else of 8
    auto f = D == 2 ? (B <= 2 ? fwd_tab<T, 2, 2> : fwd_tab<T, 2, BT>)
                    : (B <= 2 ? fwd_tab<T, 3, 2> : fwd_tab<T, 3, BT>);
    return f(md, w6, gsum, S, s_bs, ab, ab_bs, vw, win, B, nb, W, Wu, sig_w,
             sig_g, thr, use_alpha, ga, sm, st);
}

template <typename T>
int bwd_tab_d(int D, const void* md, const float* vs, const float* gsum,
              const float* gb, long long gb_bs, const float* G,
              long long g_bs, const int* win, int B, int nb, int W, int Wu,
              float sig_g, float* da, cudaStream_t st) {
    if (D != 2 && D != 3) return (int)cudaErrorInvalidValue;
    auto f = D == 2 ? (B <= 2 ? bwd_tab<T, 2, 2> : bwd_tab<T, 2, BT>)
                    : (B <= 2 ? bwd_tab<T, 3, 2> : bwd_tab<T, 3, BT>);
    return f(md, vs, gsum, gb, gb_bs, G, g_bs, win, B, nb, W, Wu, sig_g, da,
             st);
}

template <typename T, int BTC>
int mask_tab(const void* w6, const float* S, long long s_bs, int F,
             const float* vw, const int* win, int B, int nb, int M, int W,
             int Wu, float sig_w, float thr, int use_alpha, float* sm,
             cudaStream_t st) {
    using L = MaskStage<T, BTC>;
    CUtensorMap w6_map;
    cudaError_t err = table_map<T, L::TW>(&w6_map, w6, nb, 1, W);
    if (err == cudaSuccess)
        err = allow_smem((const void*)sph_mask_tab_kernel<T, BTC>);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(2 * nb, (B + BTC - 1) / BTC);
    sph_mask_tab_kernel<T, BTC><<<grid, TAB_THREADS, L::smem(Wu), st>>>(
        w6_map, S, s_bs, F, vw, win, B, M, W, Wu, sig_w, thr, use_alpha, sm);
    return (int)cudaGetLastError();
}

template <typename T>
int mask_tab_b(const void* w6, const float* S, long long s_bs, int F,
               const float* vw, const int* win, int B, int nb, int M, int W,
               int Wu, float sig_w, float thr, int use_alpha, float* sm,
               cudaStream_t st) {
    // tiles of 2 samples for B <= 2 (see MaskStage), else of 8
    auto f = B <= 2 ? mask_tab<T, 2> : mask_tab<T, BT>;
    return f(w6, S, s_bs, F, vw, win, B, nb, M, W, Wu, sig_w, thr, use_alpha,
             sm, st);
}

template <typename T, int BTC>
int blur_tab(const void* w6, const float* X, long long x_bs, const float* vw,
             const int* win, int B, int nb, int M, int W, int Wu,
             float sig_w, float* out, cudaStream_t st) {
    using L = MaskStage<T, 4 * BTC>;
    CUtensorMap w6_map;
    cudaError_t err = table_map<T, L::TW>(&w6_map, w6, nb, 1, W);
    if (err == cudaSuccess)
        err = allow_smem((const void*)sph_blur_tab_kernel<T, BTC>);
    if (err != cudaSuccess) return (int)err;
    // (2 nb) halves x sample tiles, the tiles of a half adjacent
    const dim3 grid(2 * nb * ((B + BTC - 1) / BTC));
    sph_blur_tab_kernel<T, BTC><<<grid, TAB_THREADS, L::smem(Wu), st>>>(
        w6_map, X, x_bs, vw, win, B, M, W, Wu, sig_w, out);
    return (int)cudaGetLastError();
}

template <typename T>
int blur_tab_b(const void* w6, const float* X, long long x_bs, int F,
               const float* vw, const int* win, int B, int nb, int M, int W,
               int Wu, float sig_w, float* out, cudaStream_t st) {
    if (F != 4) return (int)cudaErrorInvalidValue;  // the diffusion's [m, m t]
    // tiles of 1 sample for B = 1, else of 4
    auto f = B == 1 ? blur_tab<T, 1> : blur_tab<T, 4>;
    return f(w6, X, x_bs, vw, win, B, nb, M, W, Wu, sig_w, out, st);
}

}  // namespace

// Plain C launchers for ctypes: raw device pointers, sizes, sample strides,
// the table type (0 = float32, 1 = bfloat16) and the caller's stream. All run
// on a grid of (2 nb row halves, sample tiles: of 8, or one of 2 for B <= 2;
// the blur's of 4, or one of 1 for B = 1) and take 16-byte aligned tables
// (the forward and adjoint also M = 8 slots a cell and 16-byte aligned
// state, cotangents and volumes). Each returns the CUDA error code of its
// set-up or launch (0 = ok).

extern "C" int sph_fwd_tab_launch(
    int bf16, const void* md, const void* w6, const float* gsum,
    const float* S, long long s_bs, const float* ab, long long ab_bs,
    const float* vw, const int* win, int B, int nb, int D, int F, int P_,
    int M, int W, int Wu, float sig_w, float sig_g, float thr, int use_alpha,
    float* ga, float* sm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bad_grid(P_, nb, B, W, M) || F != FF || M != CELL)
        return (int)cudaErrorInvalidValue;
    return bf16
        ? fwd_tab_d<__nv_bfloat16>(D, md, w6, gsum, S, s_bs, ab, ab_bs, vw,
                                   win, B, nb, W, Wu, sig_w, sig_g, thr,
                                   use_alpha, ga, sm, st)
        : fwd_tab_d<float>(D, md, w6, gsum, S, s_bs, ab, ab_bs, vw, win, B,
                           nb, W, Wu, sig_w, sig_g, thr, use_alpha, ga, sm,
                           st);
}

extern "C" int sph_bwd_tab_launch(
    int bf16, const void* md, const float* vs, const float* gsum,
    const float* gb, long long gb_bs, const float* G, long long g_bs,
    const int* win, int B, int nb, int D, int F, int P_, int M, int W, int Wu,
    float sig_g, float* da, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bad_grid(P_, nb, B, W, M) || F != FF || M != CELL)
        return (int)cudaErrorInvalidValue;
    return bf16
        ? bwd_tab_d<__nv_bfloat16>(D, md, vs, gsum, gb, gb_bs, G, g_bs, win,
                                   B, nb, W, Wu, sig_g, da, st)
        : bwd_tab_d<float>(D, md, vs, gsum, gb, gb_bs, G, g_bs, win, B, nb,
                           W, Wu, sig_g, da, st);
}

extern "C" int sph_mask_tab_launch(
    int bf16, const void* w6, const float* S, long long s_bs, int F,
    const float* vw, const int* win, int B, int nb, int P_, int M, int W,
    int Wu, float sig_w, float thr, int use_alpha, float* sm, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bad_grid(P_, nb, B, W, M) || F < 4) return (int)cudaErrorInvalidValue;
    return bf16
        ? mask_tab_b<__nv_bfloat16>(w6, S, s_bs, F, vw, win, B, nb, M, W,
                                    Wu, sig_w, thr, use_alpha, sm, st)
        : mask_tab_b<float>(w6, S, s_bs, F, vw, win, B, nb, M, W, Wu, sig_w,
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
        ? blur_tab_b<__nv_bfloat16>(w6, X, x_bs, F, vw, win, B, nb, M, W,
                                    Wu, sig_w, out, st)
        : blur_tab_b<float>(w6, X, x_bs, F, vw, win, B, nb, M, W, Wu, sig_w,
                            out, st);
}
