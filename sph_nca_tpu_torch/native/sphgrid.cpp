// Host-side SPH grid analytics — native core for preprocessing.
//
// The TPU owns the compute path (XLA/Pallas); this library owns the
// host-side, latency-critical preprocessing that the reference does with
// numba/numpy/torch host code (sphops/preprocess.py, test.py FPS):
//
//   sphgrid_capacity     exact max cell occupancy + max neighbor count
//                        (sizes the static shapes of the neighbor engine;
//                        O(N * 3^D * occupancy) via a periodic cell grid,
//                        same modulo hash as the device engine)
//   sphgrid_cell_hash    periodic mixed-radix cell hash per point
//   sphgrid_fps          greedy farthest-point sampling (O(M*N)),
//                        the host fallback for utils.meshes FPS
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
// Build: g++ -O3 -march=native -shared -fPIC -o libsphgrid.so sphgrid.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

static double now_s() {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + 1e-9 * t.tv_nsec;
}

extern "C" {

// Periodic mixed-radix cell hash (matches ops/hashgrid.cell_index:
// floor(x/h) mod dims, flattened with dim-0 fastest).
void sphgrid_cell_hash(const float* x, int64_t n, int d, float h,
                       const int32_t* dims, int32_t* out) {
  std::vector<int64_t> stride(d);
  stride[0] = 1;
  for (int i = 1; i < d; ++i) stride[i] = stride[i - 1] * dims[i - 1];
  for (int64_t p = 0; p < n; ++p) {
    int64_t hash = 0;
    for (int i = 0; i < d; ++i) {
      int64_t c = (int64_t)std::floor(x[p * d + i] / h) % dims[i];
      if (c < 0) c += dims[i];
      hash += c * stride[i];
    }
    out[p] = (int32_t)hash;
  }
}

// Exact max hash-cell occupancy and max neighbor count within radius h.
// periodic: if non-null, period[d] for minimum-image displacements.
// Returns 0 on success.
int sphgrid_capacity(const float* x, int64_t n, int d, float h,
                     const int32_t* dims, const float* period,
                     int32_t* max_occupancy, int32_t* max_neighbors) {
  if (d < 1 || d > 3) return 1;
  std::vector<int64_t> stride(d);
  stride[0] = 1;
  int64_t num_cells = dims[0];
  for (int i = 1; i < d; ++i) {
    stride[i] = stride[i - 1] * dims[i - 1];
    num_cells *= dims[i];
  }

  // cell hash per point + counting sort into cell buckets
  std::vector<int32_t> hash(n);
  std::vector<int32_t> ci(n * d);
  for (int64_t p = 0; p < n; ++p) {
    int64_t hv = 0;
    for (int i = 0; i < d; ++i) {
      int64_t c = (int64_t)std::floor(x[p * d + i] / h) % dims[i];
      if (c < 0) c += dims[i];
      ci[p * d + i] = (int32_t)c;
      hv += c * stride[i];
    }
    hash[p] = (int32_t)hv;
  }
  std::vector<int32_t> count(num_cells + 1, 0);
  for (int64_t p = 0; p < n; ++p) count[hash[p] + 1]++;
  int32_t occ = 0;
  for (int64_t c = 0; c < num_cells; ++c)
    if (count[c + 1] > occ) occ = count[c + 1];
  *max_occupancy = occ;
  for (int64_t c = 0; c < num_cells; ++c) count[c + 1] += count[c];
  std::vector<int32_t> order(n);
  {
    std::vector<int32_t> cursor(count.begin(), count.end() - 1);
    for (int64_t p = 0; p < n; ++p) order[cursor[hash[p]]++] = (int32_t)p;
  }

  // neighbor counting over the 3^D stencil
  const float h2 = h * h;
  int32_t maxn = 0;
  int span = 1;
  for (int i = 0; i < d; ++i) span *= 3;
  for (int64_t p = 0; p < n; ++p) {
    int32_t cnt = 0;
    for (int s = 0; s < span; ++s) {
      int64_t hv = 0;
      int t = s;
      for (int i = 0; i < d; ++i) {
        int off = (t % 3) - 1;
        t /= 3;
        int64_t c = (ci[p * d + i] + off + dims[i]) % dims[i];
        hv += c * stride[i];
      }
      for (int32_t q = count[hv]; q < count[hv + 1]; ++q) {
        const float* xj = x + (int64_t)order[q] * d;
        float d2 = 0.f;
        for (int i = 0; i < d; ++i) {
          float r = xj[i] - x[p * d + i];
          if (period) r -= std::nearbyint(r / period[i]) * period[i];
          d2 += r * r;
        }
        if (d2 < h2) cnt++;
      }
    }
    if (cnt > maxn) maxn = cnt;
  }
  *max_neighbors = maxn;
  return 0;
}

// Greedy farthest-point sampling: pick m indices from x [n, d].
void sphgrid_fps(const float* x, int64_t n, int d, int64_t m, int64_t start,
                 int32_t* out) {
  std::vector<float> mind(n, 1e30f);
  int64_t cur = start;
  out[0] = (int32_t)cur;
  for (int64_t k = 1; k < m; ++k) {
    const float* xc = x + cur * d;
    int64_t best = 0;
    float bestd = -1.f;
    for (int64_t p = 0; p < n; ++p) {
      float d2 = 0.f;
      for (int i = 0; i < d; ++i) {
        float r = x[p * d + i] - xc[i];
        d2 += r * r;
      }
      if (d2 < mind[p]) mind[p] = d2;
      if (mind[p] > bestd) {
        bestd = mind[p];
        best = p;
      }
    }
    cur = best;
    out[k] = (int32_t)cur;
  }
}

// ---------------------------------------------------------------------------
// Band-engine build core (ops/bands.py) — replaces the numpy hot paths
// (_true_pairs, fill_table, the ml_dtypes bf16 cast) that dominated the
// host build time (profiled round 3: 10.5 s + 13.2 s + 15.6 s of a 43 s
// build at 100k points).
// ---------------------------------------------------------------------------

// Enumerate all true SPH pairs |r| < h of rank-ordered positions via a
// cell grid (cell size h; periodic: per/ncell with wrapped stencil and
// per-image shifts, matching ops/bands._true_pairs — multi-image pairs
// are emitted once per contributing image, self pairs included).
//
// Call with cap = 0 (null outputs) to count; call again with cap >= E
// to fill. Returns the total pair count E, or -1 if the grid would be
// degenerate (caller falls back to numpy).
// w6sum / nbr (nullable, length n): per-particle sums of the poly6
// core (h^2-d2)^3 and neighbor counts, accumulated during the scan so
// the caller never materializes per-pair weight arrays (zeroed here).
int64_t sphgrid_true_pairs(const double* x, int64_t n, int d, double h,
                           const double* period, int64_t cap, int32_t* pi,
                           int32_t* pj, float* dx_out, float* d2_out,
                           double* w6sum, int32_t* nbr) {
  if (d < 1 || d > 3 || n <= 0) return -1;
  double cell[3], per[3];
  int64_t ncell[3];
  bool periodic = period != nullptr;
  double lo[3], hi[3];
  for (int i = 0; i < d; ++i) {
    lo[i] = 1e300;
    hi[i] = -1e300;
  }
  for (int64_t p = 0; p < n; ++p)
    for (int i = 0; i < d; ++i) {
      double v = x[p * d + i];
      if (v < lo[i]) lo[i] = v;
      if (v > hi[i]) hi[i] = v;
    }
  int64_t dims[3], stride[3], num_cells = 1;
  if (periodic) {
    for (int i = 0; i < d; ++i) {
      per[i] = period[i];
      ncell[i] = (int64_t)std::floor(per[i] / h);
      if (ncell[i] < 3) ncell[i] = 3;
      cell[i] = per[i] / ncell[i];
      dims[i] = ncell[i];
    }
  } else {
    for (int i = 0; i < d; ++i) {
      cell[i] = h;
      // grid over the occupied bounding box
      dims[i] = (int64_t)std::floor(hi[i] / h) -
                (int64_t)std::floor(lo[i] / h) + 1;
    }
  }
  for (int i = 0; i < d; ++i) {
    stride[i] = num_cells;
    num_cells *= dims[i];
    if (num_cells > (int64_t)1 << 33) return -1;  // degenerate/sparse
  }

  if (num_cells > ((int64_t)1 << 31) - 2) return -1;  // int32 grid keys
  // cell coordinate per point (+ counting sort); int32 keys/counters —
  // this host slows to ~45 MB/s on fresh pages after GBs of allocation
  // churn (measured), so every build-side byte counts double
  std::vector<int32_t> cc(n * d);
  std::vector<int32_t> chash(n);
  for (int64_t p = 0; p < n; ++p) {
    int64_t hsh = 0;
    for (int i = 0; i < d; ++i) {
      int64_t c;
      if (periodic) {
        c = (int64_t)std::floor(x[p * d + i] / cell[i]) % ncell[i];
        if (c < 0) c += ncell[i];
      } else {
        c = (int64_t)std::floor(x[p * d + i] / h) -
            (int64_t)std::floor(lo[i] / h);
      }
      cc[p * d + i] = (int32_t)c;
      hsh += c * stride[i];
    }
    chash[p] = (int32_t)hsh;
  }
  std::vector<int32_t> cstart(num_cells + 1, 0);
  for (int64_t p = 0; p < n; ++p) cstart[chash[p] + 1]++;
  for (int64_t c = 0; c < num_cells; ++c) cstart[c + 1] += cstart[c];
  std::vector<int32_t> by_cell(n);
  {
    std::vector<int32_t> cur(cstart.begin(), cstart.end() - 1);
    for (int64_t p = 0; p < n; ++p) by_cell[cur[chash[p]]++] = (int32_t)p;
  }

  const double h2 = h * h;
  if (w6sum) std::memset(w6sum, 0, n * sizeof(double));
  if (nbr) std::memset(nbr, 0, n * sizeof(int32_t));
  int64_t e = 0;
  int off[3] = {0, 0, 0};
  for (int64_t p = 0; p < n; ++p) {
    const double* xp = x + p * d;
    // 3^d stencil around the particle's cell
    int span = d >= 1 ? 3 : 1;
    int tot = 1;
    for (int i = 0; i < d; ++i) tot *= 3;
    (void)span;
    for (int s = 0; s < tot; ++s) {
      int t = s;
      double shift[3] = {0.0, 0.0, 0.0};
      int64_t hsh = 0;
      bool ok = true;
      for (int i = 0; i < d; ++i) {
        off[i] = t % 3 - 1;
        t /= 3;
        int64_t c = (int64_t)cc[p * d + i] + off[i];
        if (periodic) {
          int64_t cw = c % ncell[i];
          if (cw < 0) cw += ncell[i];
          shift[i] = (double)((c - cw) / ncell[i]) * per[i];
          c = cw;
        } else if (c < 0 || c >= dims[i]) {
          ok = false;
          break;
        }
        hsh += c * stride[i];
      }
      if (!ok) continue;
      for (int64_t q = cstart[hsh]; q < cstart[hsh + 1]; ++q) {
        int64_t j = by_cell[q];
        double dxv[3], dd = 0.0;
        for (int i = 0; i < d; ++i) {
          dxv[i] = x[j * d + i] - xp[i] + shift[i];
          dd += dxv[i] * dxv[i];
        }
        if (dd < h2) {
          if (e < cap) {
            pi[e] = (int32_t)p;
            pj[e] = (int32_t)j;
            for (int i = 0; i < d; ++i) dx_out[e * d + i] = (float)dxv[i];
            d2_out[e] = (float)dd;
          }
          if (w6sum)
            w6sum[p] += (h2 - dd) * (h2 - dd) * (h2 - dd);
          if (nbr) nbr[p]++;
          ++e;
        }
      }
    }
  }
  return e;
}

// Per-pair band-window column (ops/bands.py slot logic): slot 1 = same
// block, 2 = next (mod nb), 0 = previous (mod nb), column = slot*P +
// pj%P; -1 for curve-far pairs. Replaces six E-length numpy int
// temporaries on the churn-sensitive host.
void sphgrid_band_cols(const int32_t* __restrict pi,
                       const int32_t* __restrict pj, int64_t e, int64_t P,
                       int64_t nb, int32_t* __restrict band_col) {
  for (int64_t k = 0; k < e; ++k) {
    const int64_t bi = pi[k] / P, bj = pj[k] / P;
    const int64_t dbf = ((bj - bi) % nb + nb) % nb;
    int64_t slot;
    if (dbf == 0)
      slot = 1;
    else if (dbf == 1)
      slot = 2;
    else if (dbf == nb - 1)
      slot = 0;
    else {
      band_col[k] = -1;
      continue;
    }
    band_col[k] = (int32_t)(slot * P + pj[k] % P);
  }
}

// Band-table fill + bf16 quantize + quantized row sums, driven directly
// by the pair arrays: rows/ri derive from pi (sorted), cols from
// band_col (negative = far pair, skipped). No selection arrays at all.
void sphgrid_fill_band_bf16(const int32_t* __restrict pi,
                            const int32_t* __restrict band_col,
                            int64_t e, const float* __restrict dx,
                            const float* __restrict d2,
                            const int32_t* __restrict pj,
                            const double* __restrict v, double h, int d,
                            int64_t P, int64_t nrows, uint16_t* __restrict out,
                            float* __restrict gs) {
  const int64_t cc = (d + 1) * P;
  const int64_t wcols = 3 * P;
  const int64_t row_elems = wcols * cc;
  const double h2 = h * h;
  int64_t chunk = ((int64_t)256 << 20) / (4 * row_elems);
  if (chunk < 1) chunk = 1;
  std::vector<float> scratch;
  int64_t k = 0;
  for (int64_t r0 = 0; r0 < nrows; r0 += chunk) {
    const int64_t r1 = std::min(r0 + chunk, nrows);
    scratch.assign((r1 - r0) * row_elems, 0.f);
    for (; k < e && pi[k] / P < r1; ++k) {
      const int32_t col = band_col[k];
      if (col < 0) continue;  // far pair
      const double dd = (double)d2[k];
      const double vj = v[pj[k]];
      const double w6 = (h2 - dd) * (h2 - dd) * (h2 - dd);
      double mag = 0.0;
      if (dd > 0.0) {
        const double dist = std::sqrt(dd);
        mag = 3.0 * (h - dist) * (h - dist) / dist;
      }
      float* base = scratch.data() +
                    ((int64_t)(pi[k] / P - r0) * wcols + col) * cc +
                    pi[k] % P;
      for (int c = 0; c < d; ++c)
        base[c * P] += (float)(mag * dx[k * d + c] * vj);
      base[d * P] += (float)(w6 * vj);
    }
    // fused cast + quantized-row-sum pass: one read of scratch, one
    // write of out, no 2x re-read of the bf16 table from RAM (the
    // separate gsum loop cost a full extra pass over the output)
    for (int64_t r = r0; r < r1; ++r) {
      const uint32_t* __restrict sr =
          (const uint32_t*)scratch.data() + (r - r0) * row_elems;
      uint16_t* __restrict dr = out + r * row_elems;
      float* __restrict gr = gs + r * cc;
      for (int64_t w = 0; w < wcols; ++w) {
        const uint32_t* __restrict sw = sr + w * cc;
        uint16_t* __restrict dw = dr + w * cc;
        for (int64_t c = 0; c < cc; ++c) {
          const uint32_t u = sw[c];
          const uint16_t q =
              (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
          dw[c] = q;
          const uint32_t back = (uint32_t)q << 16;
          float f;
          std::memcpy(&f, &back, 4);
          gr[c] += f;
        }
      }
    }
  }
}

// Accumulate pair weights into a zeroed f32 table
// tab [nrows, wcols, (d+1)*P]: per pair k, component c < d adds
// mdv[k, c] at column c*P + ri[k], and w6v[k] at column d*P + ri[k]
// (the band/far table layout of ops/bands.fill_table). Multi-image
// duplicates accumulate.
void sphgrid_accum_table(const int32_t* rows, const int32_t* cols,
                         const int32_t* ri, const double* mdv,
                         const double* w6v, int64_t e, int d, int64_t P,
                         int64_t wcols, float* tab) {
  const int64_t ccn = (d + 1) * P;
  for (int64_t k = 0; k < e; ++k) {
    float* base = tab + ((int64_t)rows[k] * wcols + cols[k]) * ccn + ri[k];
    for (int c = 0; c < d; ++c) base[c * P] += (float)mdv[k * d + c];
    base[d * P] += (float)w6v[k];
  }
}

// Fused table fill + bf16 quantize + quantized row sums for one band/far
// table, computing the pair weights (spiky md components and poly6 w6v,
// reference kernels_impl.py math as in ops/bands.build_band_engine) on
// the fly from raw pair data — the Python path materialized mdv/w6v and
// their fancy-indexed selections as ~300 MB of fresh f64 temporaries,
// which dominated the build on this host (page-fault-bound).
//
// rows/cols/ri are per-SELECTED-pair (aligned with psel, which indexes
// the full pair arrays dx/d2/pj); rows must be non-decreasing so the
// fill runs in row chunks against a small reusable f32 scratch (peak
// scratch <= ~256 MB regardless of table size). out is the bf16 table
// as uint16 bit patterns [nrows, wcols, (d+1)*P]; gs [nrows, (d+1)*P]
// (zeroed by caller) receives the sums of the QUANTIZED entries over
// the window-column axis.
void sphgrid_fill_cast_bf16(const int32_t* __restrict rows,
                            const int32_t* __restrict cols,
                            const int32_t* __restrict ri,
                            const int64_t* __restrict psel, int64_t e,
                            const float* __restrict dx,
                            const float* __restrict d2,
                            const int32_t* __restrict pj,
                            const double* __restrict v, double h, int d,
                            int64_t P, int64_t wcols, int64_t nrows,
                            uint16_t* __restrict out, float* __restrict gs) {
  const int64_t cc = (d + 1) * P;
  const int64_t row_elems = wcols * cc;
  const double h2 = h * h;
  int64_t chunk = ((int64_t)256 << 20) / (4 * row_elems);
  if (chunk < 1) chunk = 1;
  const bool prof = std::getenv("SPH_NCA_BUILD_PROFILE") != nullptr;
  double t_fill = 0, t_cast = 0, t_gsum = 0, t_zero = 0;
  std::vector<float> scratch;
  int64_t k = 0;
  for (int64_t r0 = 0; r0 < nrows; r0 += chunk) {
    const int64_t r1 = std::min(r0 + chunk, nrows);
    double tb = prof ? now_s() : 0;
    scratch.assign((r1 - r0) * row_elems, 0.f);
    if (prof) { t_zero += now_s() - tb; tb = now_s(); }
    for (; k < e && rows[k] < r1; ++k) {
      const int64_t pk = psel ? psel[k] : k;
      const double dd = (double)d2[pk];
      const double vj = v[pj[pk]];
      const double w6 = (h2 - dd) * (h2 - dd) * (h2 - dd);
      double mag = 0.0;
      if (dd > 0.0) {
        const double dist = std::sqrt(dd);
        mag = 3.0 * (h - dist) * (h - dist) / dist;
      }
      float* base = scratch.data() +
                    ((int64_t)(rows[k] - r0) * wcols + cols[k]) * cc + ri[k];
      for (int c = 0; c < d; ++c)
        base[c * P] += (float)(mag * dx[pk * d + c] * vj);
      base[d * P] += (float)(w6 * vj);
    }
    if (prof) { t_fill += now_s() - tb; tb = now_s(); }
    // quantize the chunk (RTE) + accumulate quantized row sums
    const uint32_t* __restrict su = (const uint32_t*)scratch.data();
    uint16_t* __restrict du = out + r0 * row_elems;
    const int64_t total = (r1 - r0) * row_elems;
    for (int64_t t = 0; t < total; ++t) {
      const uint32_t u = su[t];
      du[t] = (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
    }
    if (prof) { t_cast += now_s() - tb; tb = now_s(); }
    for (int64_t r = r0; r < r1; ++r) {
      const uint16_t* __restrict dr = out + r * row_elems;
      float* __restrict gr = gs + r * cc;
      for (int64_t w = 0; w < wcols; ++w) {
        const uint16_t* __restrict dw = dr + w * cc;
        for (int64_t c = 0; c < cc; ++c) {
          const uint32_t back = (uint32_t)dw[c] << 16;
          float f;
          std::memcpy(&f, &back, 4);
          gr[c] += f;
        }
      }
    }
    if (prof) t_gsum += now_s() - tb;
  }
  if (prof)
    std::fprintf(stderr,
                 "[sphgrid fill_cast] zero %.2fs fill %.2fs cast %.2fs "
                 "gsum %.2fs (e=%lld, rows=%lld)\n",
                 t_zero, t_fill, t_cast, t_gsum, (long long)e,
                 (long long)nrows);
}

// f32 -> bf16 cast (round-to-nearest-even, matching ml_dtypes/TPU),
// optionally accumulating the QUANTIZED values over the window-row axis
// into gs [nrows, cc] f32 (the gsum self-term of ops/bands, derived
// from quantized tables so a constant field has zero gradient).
// src [nrows, wrows, cc] -> dst (same shape, uint16 bit pattern).
void sphgrid_cast_bf16_gsum(const float* src, uint16_t* dst, int64_t nrows,
                            int64_t wrows, int64_t cc, float* gs) {
  // flat vectorizable cast pass (round to nearest even on the upper
  // 16 bits), then an optional row-sum pass over the quantized values
  const uint32_t* su = (const uint32_t*)src;
  const int64_t total = nrows * wrows * cc;
  for (int64_t t = 0; t < total; ++t) {
    const uint32_t u = su[t];
    dst[t] = (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
  }
  if (!gs) return;
  for (int64_t r = 0; r < nrows; ++r) {
    const uint16_t* dr = dst + r * wrows * cc;
    float* gr = gs + r * cc;
    for (int64_t w = 0; w < wrows; ++w)
      for (int64_t c = 0; c < cc; ++c) {
        const uint32_t back = (uint32_t)dr[w * cc + c] << 16;
        float f;
        std::memcpy(&f, &back, 4);
        gr[c] += f;
      }
  }
}

// Far-group structure, phase A: the distinct (block, group) entries
// among curve-far pairs (band_col < 0), per block. Replaces
// ops/bands.py's np.unique over E_far int64 keys (a full sort of the
// far-pair key array plus several 100-MB temporaries): pairs arrive
// pi-sorted, so groups dedupe block-locally against a small reusable
// scratch. groups_flat must have capacity >= the number of far pairs
// (each far pair contributes at most one distinct group). Writes
// grp_count [nb], offsets [nb+1] (prefix sums), and the per-block
// ASCENDING group ids to groups_flat (matching np.unique order).
// Returns the total number of distinct entries.
int64_t sphgrid_far_groups(const int32_t* __restrict pi,
                           const int32_t* __restrict pj,
                           const int32_t* __restrict band_col, int64_t e,
                           int64_t P, int64_t g, int64_t nb,
                           int32_t* __restrict grp_count,
                           int64_t* __restrict offsets,
                           int32_t* __restrict groups_flat) {
  std::vector<int32_t> scratch;
  scratch.reserve(1024);
  int64_t total = 0, k = 0;
  offsets[0] = 0;
  for (int64_t b = 0; b < nb; ++b) {
    scratch.clear();
    for (; k < e && pi[k] / P == b; ++k) {
      if (band_col[k] >= 0) continue;
      scratch.push_back(pj[k] / (int32_t)g);
    }
    std::sort(scratch.begin(), scratch.end());
    scratch.erase(std::unique(scratch.begin(), scratch.end()),
                  scratch.end());
    grp_count[b] = (int32_t)scratch.size();
    std::memcpy(groups_flat + total, scratch.data(),
                scratch.size() * sizeof(int32_t));
    total += (int64_t)scratch.size();
    offsets[b + 1] = total;
  }
  return total;
}

// Far-group structure, phase C: given the bucket cuts (from the Python
// DP over grp_count), derive every per-block and per-pair quantity the
// far-table fill needs in ONE linear pass — replacing the per-bucket
// searchsorted / repeat / cumsum numpy chains:
//   block_bucket [nb]  bucket id of each block (-1 if no far groups)
//   block_row    [nb]  row of the block within its bucket's table
//   bucket_nblocks/bucket_npairs [T]
//   pair_bucket  [e]   bucket id per pair (-1 for band pairs)
//   pair_row     [e]   row of the pair's block in its bucket table
//   pair_col     [e]   (position of the pair's group) * g + pj % g
// Pairs stay in pi order, so per bucket the row sequence is
// non-decreasing — the contract of sphgrid_fill_cast_bf16.
void sphgrid_far_meta(const int32_t* __restrict pi,
                      const int32_t* __restrict pj,
                      const int32_t* __restrict band_col, int64_t e,
                      int64_t P, int64_t g, int64_t nb,
                      const int32_t* __restrict grp_count,
                      const int64_t* __restrict offsets,
                      const int32_t* __restrict groups_flat,
                      const int64_t* __restrict cuts, int64_t T,
                      int8_t* __restrict block_bucket,
                      int32_t* __restrict block_row,
                      int64_t* __restrict bucket_nblocks,
                      int64_t* __restrict bucket_npairs,
                      int8_t* __restrict pair_bucket,
                      int32_t* __restrict pair_row,
                      int32_t* __restrict pair_col) {
  for (int64_t t = 0; t < T; ++t) bucket_nblocks[t] = bucket_npairs[t] = 0;
  for (int64_t b = 0; b < nb; ++b) {
    const int32_t c = grp_count[b];
    if (c == 0) {
      block_bucket[b] = -1;
      block_row[b] = -1;
      continue;
    }
    // first bucket t with c <= cuts[t]  (== np.searchsorted(cuts, c))
    int64_t t = 0;
    while (t < T && c > cuts[t]) ++t;
    block_bucket[b] = (int8_t)t;
    block_row[b] = (int32_t)bucket_nblocks[t]++;
  }
  for (int64_t k = 0; k < e; ++k) {
    if (band_col[k] >= 0) {
      pair_bucket[k] = -1;
      continue;
    }
    const int64_t b = pi[k] / P;
    const int32_t grp = pj[k] / (int32_t)g;
    const int32_t* lo = groups_flat + offsets[b];
    const int32_t* hi = groups_flat + offsets[b + 1];
    const int64_t pos = std::lower_bound(lo, hi, grp) - lo;
    const int8_t t = block_bucket[b];
    pair_bucket[k] = t;
    pair_row[k] = block_row[b];
    pair_col[k] = (int32_t)(pos * g + pj[k] % g);
    ++bucket_npairs[t];
  }
}

}  // extern "C"
