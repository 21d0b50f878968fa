// Binned pair counts on the grid hash, for Hopper (sm_90a).
//
// Replaces the neighbour fold of the JAX package's pair counting,
// nbodykit_tpu/algorithms/pair_counters/core.py:103-151 (_fold_body under
// GridHash.fold, nbodykit_tpu/ops/gridhash.py:136-148), which XLA runs as
// a loop of gathers and bincounts over every (offset, slot) candidate; no
// Pallas kernel computes it. For every live query i and every candidate j
// of its neighbour cells (j indexes the grid's cell-sorted secondaries):
//
//     dn = p2[j] - p1[i], minimum-imaged when periodic;  d = -dn
//     r2 = (dx*dx + dy*dy) + dz*dz
//     ok = is_auto ? r2 > 0 : r2 >= 0     (every coincident pair drops
//                                          out of an auto count)
//     row = digitize(r2 or rp2, r2edges), col = the mu or pi bin
//     npairs[row * nb2 + col] += 1; wpairs[...] += w1[i] * w2[j]   if ok
//
// with the modes of core.py: '1d' and 'angular' (nb2 = 1), '2d' (mu =
// dlos / r, col = trunc(mu * nb2) clipped), 'projected' (rp2 = r2 -
// dlos^2 binned, col = trunc(dlos) clipped, ok only for dlos < pimax);
// dlos is |d[los]| for an axis, or |d . mid| / |mid| for the 'midpoint'
// line of sight, mid = 0.5 * (p1 + p2) + origin. Rows 0 and nb1 + 1 hold
// the pairs below the first and above the last edge, as the JAX bincount
// leaves them. The histograms are (nb1 + 2) * nb2 long: npairs as exact
// 64-bit integer counts, wpairs f64.
//
// What bounds it: f64 arithmetic, at the least. At the boss_like sample
// (1e6 points, r_max = 150 in a box of 2500: 16^3 cells of ~244) every
// query visits ~6.6e3 candidates, 6.6e9 in all (3.3e9 when an auto count
// takes each pair once), ~5/6 of them past r_max; each costs the
// separation and r2 (8 f64 operations) and a compare, an in-range one a
// few more (paircount_cuda.candidate_ops). The first design (a warp a
// query, csrc/variants/paircount_first_design.cu) spent ~86 SM cycles a
// warp step against ~11 of arithmetic: each query re-read its candidates
// from L1/L2 with a load's latency on every step, searched the edges for
// every candidate, grouped the step's lanes by bin (match, shuffles, shared
// f64 compare-and-swap adds) and searched 9 columns twice a query. This
// design is bound by latency: each thread's chain of dependent f64
// operations and shared loads a candidate, hidden only by the warps an SM
// holds, which its shared memory sets (kernel_variants.py probes: more
// CTAs an SM, or more candidates a loop step, buy time, and every
// instruction on the chain costs more than its issue slot). Design:
//  - A CTA takes an item: up to PC_THREADS consecutive queries of one grid
//    cell (the wrapper's list, ops/paircount_cuda.query_items; queries in
//    the grid's cell order fill them), a thread a query, CTAs striding
//    over the items. The cell's 9 columns are searched once
//    an item (grid_columns.cuh column_runs), not once a query.
//  - The candidates of each run are staged in shared memory, PC_TILE at a
//    time, double-buffered: each thread loads one candidate of the next
//    tile (x, y, z, w: coalesced) into registers before the current tile
//    is computed, and stores it after. Every thread of a warp then reads
//    the same candidate: a broadcast, two 16-byte shared loads a warp step
//    of 32 pairs.
//  - The bin: one compare against the last edge sends a pair to the
//    overflow row, one against the first to row 0; inside, the wrapper's
//    bucket table of r2's bits gives a lower bound that one compare makes
//    exact where the table holds at most one edge in a bucket (a walk
//    where it is coarser; grid_columns.cuh table_digitize): the bin is
//    np.digitize's, edges <= x, bit for bit.
//  - Privatised histograms, no match or shuffle on the warp step. '1d'
//    and 'angular': the overflow row of a thread's query stays in its
//    registers, rows 0..nb1 in its own column of shared memory
//    ([row][thread]: conflict-free, no atomics). '2d': the overflow row's
//    nb2 columns, where 5/6 of the pairs go, are the thread's own column
//    the same way, rows 0..nb1 one histogram a CTA fed by shared atomics
//    (f64 sums by compare-and-swap on Hopper, u32 counts native, moved to
//    u64 totals when an item ends; a copy a warp measured slower: its
//    shared memory cost CTAs on the SM); 'projected' every bin by those
//    atomics. A thread's own rows sum w2[j] in f64 (8 bytes a row a
//    thread) and count in u32 a warp (4 bytes a row a warp), by shared
//    atomics no thread waits on: five '1d' CTAs fit an SM, where 12 bytes
//    a row a thread fitted four. When the item ends each sum is scaled
//    once by w1[i], summed over the warp by shuffles and added to the
//    CTA's totals with the counts. The totals and the shared histogram go
//    to the outputs once, by global atomics.
//  - The '2d' column without a division: an f32 estimate of mu nb2 decides
//    trunc(mu nb2) wherever it is more than its error bound from an
//    integer; the plain version's f64 sqrt and division run only near a
//    boundary (mu_col), so the column is the plain one bit for bit.
//  - Each pair once in an auto count of the grid's own points (the
//    wrapper's paircount_cuda.each_pair_once), every one live (a flag the
//    wrapper computes on the card, read here): a query counts
//    only the slots after its own, runs wholly before the item are
//    skipped, and the counts and sums are doubled when added to the
//    outputs (exact). The pair's bin is the same
//    from either end: d is negated exactly, rint and fabs are symmetric,
//    the midpoint sum commutes, and w1 w2 = w2 w1.
//  - The minimum image is computed only on the runs where it can change a
//    separation (grid_columns.cuh column_runs: image); elsewhere it is the
//    identity, bit for bit, and only divides where |d| > box / 4.
//
// Float arithmetic of the bins is the plain version's, operation by
// operation, in its order; _build.py compiles with -fmad=false, so nothing
// is fused into an FMA and a pair whose r2 sits on an edge bins as it does
// there. Counts are exact; the f64 sums differ from the plain version's by
// the order of the additions, the query weight factored out of a '1d'
// row's sum, and the atomics.
//
// Built by nbodykit_tpu_torch/_build.py into a shared library with a plain
// C interface; nbk_paircount_hist returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_columns.cuh"

#define PC_THREADS 128
#define PC_WARPS (PC_THREADS / 32)
// candidates a staged tile
#define PC_TILE PC_THREADS
// the largest bin table the wrapper builds (entries)
#define PC_TAB_MAX 1024

enum { MODE_1D = 0, MODE_2D = 1, MODE_PROJECTED = 2 };

struct PcGeo {
  int dlo[3], dhi[3];
  int ncell[3];
  double box[3];
  double origin[3];
  double pimax;
  int nb1, nb2;
  int los;      // the axis, or -1 for the midpoint line of sight
  int is_auto, periodic;
  int self;     // queries are the grid's own points: each pair once
  // with self, the card's flag that every query is live (read by the
  // kernel: a dead query's pairs count once, from their other end)
  const unsigned char* all_live;
  BinTable tab;
};

// The row of x among the edges e[0..nb1]: 0 below, nb1 + 1 from the last
// edge on (and NaN), else np.digitize by the table.
template <bool ONE_STEP>
__device__ __forceinline__ int row_of(const PcGeo& g,
                                      const double* __restrict__ e,
                                      const int4* __restrict__ tab,
                                      double x) {
  if (!(x < e[g.nb1])) return g.nb1 + 1;
  if (x < e[0]) return 0;
  return table_digitize<ONE_STEP>(e, tab, g.tab, x);
}

// dlos of a pair: |d[los]|, or |d . mid| / |mid| for the midpoint line of
// sight (mid = 0.5 (p1 + p2) + origin), as the plain version computes it.
// (ex, ey, ez) = d, primary minus secondary.
__device__ __forceinline__ double pair_dlos(const PcGeo& g, double px,
                                            double py, double pz, double sx,
                                            double sy, double sz, double ex,
                                            double ey, double ez) {
  if (g.los < 0) {
    const double mx = 0.5 * (px + sx) + g.origin[0];
    const double my = 0.5 * (py + sy) + g.origin[1];
    const double mz = 0.5 * (pz + sz) + g.origin[2];
    const double mnorm = sqrt((mx * mx + my * my) + mz * mz);
    const double dot = (ex * mx + ey * my) + ez * mz;
    return fabs(dot) / (mnorm == 0.0 ? 1.0 : mnorm);
  }
  return fabs(g.los == 0 ? ex : (g.los == 1 ? ey : ez));
}

// The '2d' column of a pair, trunc(mu nb2) clipped, mu = dlos / sqrt(r2)
// (0 where r2 == 0), exactly as the plain version computes it. An f32
// estimate t of mu nb2 (relative error below 1e-6: the conversions, the
// rsqrt and the products) decides it where it lies more than 4e-6 t +
// 1e-6 from an integer: there the f64 value, within 1e-15 of the same
// real number, truncates alike. Elsewhere (inside that band around an
// integer, and r2 == 0, a zero dlos or |mid|) the plain version's f64
// operations run.
__device__ __forceinline__ int mu_col(const PcGeo& g, double px, double py,
                                      double pz, double sx, double sy,
                                      double sz, double ex, double ey,
                                      double ez, double r2) {
  float t;
  if (g.los < 0) {
    const double mx = 0.5 * (px + sx) + g.origin[0];
    const double my = 0.5 * (py + sy) + g.origin[1];
    const double mz = 0.5 * (pz + sz) + g.origin[2];
    const double m2 = (mx * mx + my * my) + mz * mz;
    const double dot = (ex * mx + ey * my) + ez * mz;
    t = fabsf(__double2float_rn(dot)) * rsqrtf(__double2float_rn(m2)) *
        rsqrtf(__double2float_rn(r2));
  } else {
    t = __double2float_rn(fabs(g.los == 0 ? ex : (g.los == 1 ? ey : ez))) *
        rsqrtf(__double2float_rn(r2));
  }
  t = t * (float)g.nb2;
  // floor(t) for 0 <= t < 2^23: the sum rounded down keeps it in the low
  // mantissa bits
  const float big = __fadd_rd(t, 8388608.0f);
  const float frac = t - (big - 8388608.0f);
  const float eps = 4e-6f * t + 1e-6f;
  int col;
  if (frac > eps && frac < 1.0f - eps && t < 8388608.0f) {
    col = __float_as_int(big) & 0x7fffff;
  } else {
    const double dlos = pair_dlos(g, px, py, pz, sx, sy, sz, ex, ey, ez);
    const double rr = sqrt(r2 == 0.0 ? 1.0 : r2);
    const double mu = r2 == 0.0 ? 0.0 : dlos / rr;
    col = (int)(mu * (double)g.nb2);
  }
  return col < 0 ? 0 : (col > g.nb2 - 1 ? g.nb2 - 1 : col);
}

// A thread's query and its private accumulators.
struct Query {
  double x, y, z, w;
  bool on;
  int lim;               // MASKED: count candidate c of the tile if c > lim
  unsigned far_n;        // '1d': row nb1 + 1 of this query, the sum
  double far_w;          // of w2[j]
};

// The candidates [0, cnt) of a staged tile against the thread's query.
// IMAGE: minimum-image the separation; MASKED: only candidates c > q.lim.
// '1d': the overflow row into q's registers. pw: the thread's private
// rows (stride PC_THREADS), sums of w2[j]; pn: their u32 counts, one
// copy a warp, by shared atomics whose result no one waits for: '1d'
// rows 0..nb1, '2d' the columns of row nb1 + 1.
// (hw, hn): the CTA's shared histogram, f64 sums and u32 counts ('2d'
// rows 0..nb1, 'projected' every bin; the counts go to the CTA's u64
// totals when an item ends).
template <int MODE, bool IMAGE, bool MASKED, bool ONE_STEP>
__device__ __forceinline__ void count_tile(
    const PcGeo& g, const double* __restrict__ e,
    const int4* __restrict__ tab, const double2* __restrict__ tile, int cnt,
    Query& q, double* pw, unsigned* pn, double* hw,
    unsigned* hn) {
  const double elast = e[g.nb1], efirst = e[0];
  // r2 > rmin: r2 > 0 in an auto count, else r2 >= 0 (NaN fails both)
  const double rmin = g.is_auto ? 0.0 : -1.0;
  auto one = [&](int c) {
    const double2 xy = tile[2 * c], zw = tile[2 * c + 1];
    double dx = xy.x - q.x, dy = xy.y - q.y, dz = zw.x - q.z;
    if (IMAGE) {
      dx = min_image(dx, g.box[0]);
      dy = min_image(dy, g.box[1]);
      dz = min_image(dz, g.box[2]);
    }
    const double r2 = (dx * dx + dy * dy) + dz * dz;
    const bool ok = q.on && (!MASKED || c > q.lim) && r2 > rmin;
    if (MODE == MODE_1D) {
      // past the last edge: the registers, by selects
      const bool far = ok && r2 >= elast;
      q.far_n += far ? 1u : 0u;
      q.far_w += far ? zw.y : 0.0;
      if (ok && r2 < elast) {
        const int k =
            r2 < efirst ? 0 : table_digitize<ONE_STEP>(e, tab, g.tab, r2);
        pw[k * PC_THREADS] += zw.y;
        atomicAdd(pn + k, 1u);
      }
    } else if (MODE == MODE_2D) {
      if (ok) {
        const int col = mu_col(g, q.x, q.y, q.z, xy.x, xy.y, zw.x, -dx, -dy,
                               -dz, r2);
        if (r2 >= elast) {
          pw[col * PC_THREADS] += zw.y;
          atomicAdd(pn + col, 1u);
        } else {
          const int bin = (r2 < efirst ? 0
                                       : table_digitize<ONE_STEP>(
                                             e, tab, g.tab, r2)) *
                              g.nb2 +
                          col;
          atomicAdd(hn + bin, 1u);
          atomicAdd(hw + bin, q.w * zw.y);
        }
      }
    } else {  // MODE_PROJECTED
      if (ok) {
        const double dlos =
            pair_dlos(g, q.x, q.y, q.z, xy.x, xy.y, zw.x, -dx, -dy, -dz);
        if (dlos < g.pimax) {
          int col = (int)dlos;
          col = col < 0 ? 0 : (col > g.nb2 - 1 ? g.nb2 - 1 : col);
          const int bin =
              row_of<ONE_STEP>(g, e, tab, r2 - dlos * dlos) * g.nb2 + col;
          atomicAdd(hn + bin, 1u);
          atomicAdd(hw + bin, q.w * zw.y);
        }
      }
    }
  };
#pragma unroll 2
  for (int c = 0; c < cnt; ++c) one(c);
}

// Loads candidate base + threadIdx.x of the run (if below hi) into v.
__device__ __forceinline__ void load_candidate(
    const double* __restrict__ pos, const double* __restrict__ w2, int base,
    int hi, double (&v)[4]) {
  const int j = base + (int)threadIdx.x;
  if (j < hi) {
    const size_t j3 = (size_t)3 * j;
    v[0] = pos[j3];
    v[1] = pos[j3 + 1];
    v[2] = pos[j3 + 2];
    v[3] = w2[j];
  }
}

// The thread's private rows: '1d' rows 0..nb1, '2d' the nb2 columns of
// row nb1 + 1, 'projected' none.
__host__ __device__ static int private_rows(int mode, int nb1, int nb2) {
  return mode == MODE_1D ? nb1 + 1 : (mode == MODE_2D ? nb2 : 0);
}

// Shared memory of a CTA: the two staged tiles, the bin table (16 bytes
// an entry), the edges and the CTA's totals (f64, then u64), the shared
// histogram's sums ('2d', 'projected': every bin, f64), the threads'
// private rows (f64) and their counts a warp (u32), the shared
// histogram's counts (u32) and the runs (int).
__host__ __device__ static size_t smem_bytes(int mode, int nb1, int nb2,
                                             int tab_len) {
  const size_t nbins = (size_t)(nb1 + 2) * nb2;
  size_t b = (size_t)2 * PC_TILE * 32 + (size_t)tab_len * 16 +
             (size_t)(nb1 + 1) * 8 + nbins * 16;
  if (mode != MODE_1D) b += nbins * 12;
  b += (size_t)private_rows(mode, nb1, nb2) * (PC_THREADS * 8 + PC_WARPS * 4);
  return b + (size_t)3 * GC_RUNS * 4;
}

template <typename K, int MODE, bool ONE_STEP>
__global__ void __launch_bounds__(PC_THREADS)
paircount_kernel(const double* __restrict__ pos, const double* __restrict__ w2,
                 const K* __restrict__ flat, const int* __restrict__ cols,
                 const double* __restrict__ p1,
                 const double* __restrict__ w1,
                 const unsigned char* __restrict__ live,
                 const int* __restrict__ ci, int n1,
                 const int* __restrict__ items, int max_items,
                 const double* __restrict__ r2edges,
                 const int4* __restrict__ tab_g,
                 unsigned long long* __restrict__ out_n,
                 double* __restrict__ out_w, const PcGeo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int nb1 = g.nb1, nb2 = g.nb2, nbins = (nb1 + 2) * nb2;
  const int hsize = MODE == MODE_1D ? 0 : nbins;
  const int prows = private_rows(MODE, nb1, nb2);
  double2* tiles = (double2*)smem;                        // 2 x PC_TILE x 2
  int4* tab = (int4*)(smem + 2 * PC_TILE * 32);           // g.tab.len
  double* e = (double*)(tab + g.tab.len);                 // nb1 + 1
  double* tot_w = e + nb1 + 1;                            // nbins
  unsigned long long* tot_n = (unsigned long long*)(tot_w + nbins);
  double* hw = (double*)(tot_n + nbins);                  // hsize
  double* pw_all = hw + hsize;                            // prows x threads
  unsigned* pn_all = (unsigned*)(pw_all + prows * PC_THREADS);
  unsigned* hn = pn_all + prows * PC_WARPS;               // hsize
  int* run_lo = (int*)(hn + hsize);
  int* run_hi = run_lo + GC_RUNS;
  int* run_im = run_hi + GC_RUNS;

  for (int b = tid; b <= nb1; b += PC_THREADS) e[b] = r2edges[b];
  for (int k = tid; k < g.tab.len; k += PC_THREADS) tab[k] = tab_g[k];
  for (int b = tid; b < nbins; b += PC_THREADS) {
    tot_w[b] = 0.0;
    tot_n[b] = 0ull;
  }
  for (int b = tid; b < hsize; b += PC_THREADS) {
    hw[b] = 0.0;
    hn[b] = 0u;
  }
  for (int b = tid; b < prows * PC_WARPS; b += PC_THREADS) pn_all[b] = 0u;
  // this thread's private rows, and their counts (this warp's)
  double* pw = pw_all + tid;
  unsigned* pn = pn_all + (tid >> 5) * prows;
  // where the private rows go: '1d' row r, '2d' bin (nb1 + 1) nb2 + r
  const int prow0 = MODE == MODE_1D ? 0 : (nb1 + 1) * nb2;
  // each pair once: the grid's own points, every one live
  const bool once = g.self && *g.all_live;

  for (int item = blockIdx.x; item < max_items; item += gridDim.x) {
    const int q0 = items[item];
    if (q0 >= n1) break;  // items past the last hold n1
    const int q1 = items[item + 1];
    __syncthreads();  // the previous item's runs and tiles are read
    if (tid < 9) {
      const size_t c3 = (size_t)3 * q0;
      column_runs<K>(tid, flat, cols, ci[c3], ci[c3 + 1], ci[c3 + 2], g.dlo,
                     g.dhi, g.ncell, g.periodic, run_lo, run_hi, run_im);
    }
    Query q;
    const int qi = q0 + tid;
    q.on = qi < q1 && live[qi];
    q.x = q.on ? p1[(size_t)3 * qi] : 0.0;
    q.y = q.on ? p1[(size_t)3 * qi + 1] : 0.0;
    q.z = q.on ? p1[(size_t)3 * qi + 2] : 0.0;
    q.w = q.on ? w1[qi] : 0.0;
    q.far_n = 0u;
    q.far_w = 0.0;
    for (int r = 0; r < prows; ++r) pw[r * PC_THREADS] = 0.0;
    __syncthreads();
    if (once && tid < GC_RUNS) {
      // each pair once: slots after the item's first query only
      if (run_lo[tid] <= q0) run_lo[tid] = q0 + 1;
      if (run_hi[tid] < run_lo[tid]) run_hi[tid] = run_lo[tid];
    }
    __syncthreads();

    // the tiles of the runs in turn; the next one loaded into registers
    // while the current one is counted
    int r = 0;
    while (r < GC_RUNS && run_lo[r] >= run_hi[r]) ++r;
    if (r < GC_RUNS) {
      int base = run_lo[r];
      double v[4] = {0.0, 0.0, 0.0, 0.0};
      load_candidate(pos, w2, base, run_hi[r], v);
      int cur = 0;
      double2* t0 = tiles + cur * 2 * PC_TILE;
      t0[2 * tid] = make_double2(v[0], v[1]);
      t0[2 * tid + 1] = make_double2(v[2], v[3]);
      __syncthreads();
      while (true) {
        // the next tile: the rest of this run, or the next non-empty run
        int rn = r, bn = base + PC_TILE;
        if (bn >= run_hi[r]) {
          rn = r + 1;
          while (rn < GC_RUNS && run_lo[rn] >= run_hi[rn]) ++rn;
          bn = rn < GC_RUNS ? run_lo[rn] : 0;
        }
        if (rn < GC_RUNS) load_candidate(pos, w2, bn, run_hi[rn], v);
        const int hi = run_hi[r];
        const int cnt = hi - base < PC_TILE ? hi - base : PC_TILE;
        const double2* tile = tiles + cur * 2 * PC_TILE;
        const bool image = run_im[r];
        // MASKED where the run reaches below the item's last query
        const bool masked = once && base < q1;
        q.lim = qi - base;
        if (image) {
          if (masked)
            count_tile<MODE, true, true, ONE_STEP>(g, e, tab, tile, cnt, q,
                                                   pw, pn, hw, hn);
          else
            count_tile<MODE, true, false, ONE_STEP>(g, e, tab, tile, cnt, q,
                                                    pw, pn, hw, hn);
        } else {
          if (masked)
            count_tile<MODE, false, true, ONE_STEP>(g, e, tab, tile, cnt, q,
                                                    pw, pn, hw, hn);
          else
            count_tile<MODE, false, false, ONE_STEP>(g, e, tab, tile, cnt, q,
                                                     pw, pn, hw, hn);
        }
        if (rn == GC_RUNS) break;
        cur ^= 1;
        double2* tn = tiles + cur * 2 * PC_TILE;
        tn[2 * tid] = make_double2(v[0], v[1]);
        tn[2 * tid + 1] = make_double2(v[2], v[3]);
        __syncthreads();
        r = rn;
        base = bn;
      }
    }
    // the warp's counts of the private rows into the CTA's totals; the
    // query's private sums (and '1d' its far row), scaled by its weight
    // once, summed over the warp, into the CTA's totals
    __syncwarp();
    for (int row = lane; row < prows; row += 32) {
      const unsigned n = pn[row];
      pn[row] = 0u;
      if (n) atomicAdd(&tot_n[prow0 + row], (unsigned long long)n);
    }
    const int rows = MODE == MODE_1D ? prows + 1 : prows;
    for (int row = 0; row < rows; ++row) {
      unsigned long long n = row < prows ? 0ull : q.far_n;
      double s = row < prows ? pw[row * PC_THREADS] : q.far_w;
      s = q.on ? q.w * s : 0.0;
      for (int o = 16; o > 0; o >>= 1) {
        n += __shfl_down_sync(0xffffffffu, n, o);
        s += __shfl_down_sync(0xffffffffu, s, o);
      }
      if (lane == 0) {
        if (n) atomicAdd(&tot_n[prow0 + row], n);
        if (s != 0.0) atomicAdd(&tot_w[prow0 + row], s);
      }
    }
    if (MODE != MODE_1D) {
      // the shared histogram's u32 counts into the u64 totals (its bins
      // are not the private rows': no other writer)
      __syncthreads();
      for (int b = tid; b < hsize; b += PC_THREADS) {
        const unsigned n = hn[b];
        if (n) {
          hn[b] = 0u;
          tot_n[b] += n;
        }
      }
    }
  }
  __syncthreads();
  // each pair once: every count and sum doubled (exact)
  const unsigned long long mult = once ? 2ull : 1ull;
  for (int b = tid; b < nbins; b += PC_THREADS) {
    unsigned long long n = tot_n[b];
    double s = tot_w[b];
    if (MODE != MODE_1D) s += hw[b];
    if (n) {
      atomicAdd(&out_n[b], mult * n);
      atomicAdd(&out_w[b], (double)mult * s);
    }
  }
}

template <typename K, int MODE, bool ONE_STEP>
static int launch(const double* pos, const double* w2, const void* flat,
                  const int* cols, const double* p1, const double* w1,
                  const unsigned char* live, const int* ci, int n1,
                  const int* items, int max_items, const double* r2edges,
                  const int4* tab, unsigned long long* out_n, double* out_w,
                  const PcGeo& g, cudaStream_t s) {
  const size_t smem = smem_bytes(MODE, g.nb1, g.nb2, g.tab.len);
  auto kernel = paircount_kernel<K, MODE, ONE_STEP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      PC_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(max_items < cap ? max_items : cap);
  if (blocks < 1) return 0;
  kernel<<<blocks, PC_THREADS, smem, s>>>(pos, w2, (const K*)flat, cols, p1,
                                          w1, live, ci, n1, items, max_items,
                                          r2edges, tab, out_n, out_w, g);
  return (int)cudaGetLastError();
}

template <typename K, bool ONE_STEP>
static int launch_mode(int mode, const double* pos, const double* w2,
                       const void* flat, const int* cols, const double* p1,
                       const double* w1, const unsigned char* live,
                       const int* ci, int n1, const int* items, int max_items,
                       const double* r2edges, const int4* tab,
                       unsigned long long* out_n, double* out_w,
                       const PcGeo& g, cudaStream_t s) {
  if (mode == MODE_1D)
    return launch<K, MODE_1D, ONE_STEP>(pos, w2, flat, cols, p1, w1, live,
                                        ci, n1, items, max_items, r2edges,
                                        tab, out_n, out_w, g, s);
  if (mode == MODE_2D)
    return launch<K, MODE_2D, ONE_STEP>(pos, w2, flat, cols, p1, w1, live,
                                        ci, n1, items, max_items, r2edges,
                                        tab, out_n, out_w, g, s);
  return launch<K, MODE_PROJECTED, ONE_STEP>(pos, w2, flat, cols, p1, w1,
                                             live, ci, n1, items, max_items,
                                             r2edges, tab, out_n, out_w, g,
                                             s);
}

template <typename K>
static int launch_steps(int one_step, int mode, const double* pos,
                        const double* w2, const void* flat, const int* cols,
                        const double* p1, const double* w1,
                        const unsigned char* live, const int* ci, int n1,
                        const int* items, int max_items,
                        const double* r2edges, const int4* tab,
                        unsigned long long* out_n, double* out_w,
                        const PcGeo& g, cudaStream_t s) {
  if (one_step)
    return launch_mode<K, true>(mode, pos, w2, flat, cols, p1, w1, live, ci,
                                n1, items, max_items, r2edges, tab, out_n,
                                out_w, g, s);
  return launch_mode<K, false>(mode, pos, w2, flat, cols, p1, w1, live, ci,
                               n1, items, max_items, r2edges, tab, out_n,
                               out_w, g, s);
}

extern "C" int nbk_paircount_hist(
    const double* pos, const double* w2, const void* flat, const int* cols,
    long long n2, int key_bytes, const double* p1, const double* w1,
    const unsigned char* live, const int* ci, long long n1,
    const double* r2edges, int nb1, int nb2, int mode, int los,
    const double* origin, double pimax, int is_auto, int periodic,
    const int* dlo, const int* dhi, const int* ncell, const double* box,
    unsigned long long* out_n, double* out_w, const int* items,
    int max_items, const void* tab, int tab_len, int tab_shift,
    long long tab_base, int tab_steps, int each_pair_once,
    const unsigned char* all_live, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n1 <= 0 || n2 <= 0) return 0;
  if (n1 >= (1LL << 31) || n2 >= (1LL << 31) || nb1 < 1 || nb2 < 1 ||
      mode < MODE_1D || mode > MODE_PROJECTED || los < -1 || los > 2 ||
      max_items < 1 || tab_len < 2 || tab_len > PC_TAB_MAX + 1 ||
      tab_shift < 0 || tab_shift > 63 || tab_steps < 0 ||
      (mode == MODE_1D && nb2 != 1) ||
      (each_pair_once && (n1 != n2 || !is_auto || !all_live)))
    return (int)cudaErrorInvalidValue;
  PcGeo g;
  for (int k = 0; k < 3; ++k) {
    if (dlo[k] < -1 || dlo[k] > 0 || dhi[k] < 0 || dhi[k] > 1 ||
        ncell[k] < 1)
      return (int)cudaErrorInvalidValue;
    g.dlo[k] = dlo[k];
    g.dhi[k] = dhi[k];
    g.ncell[k] = ncell[k];
    g.box[k] = box[k];
    g.origin[k] = origin[k];
  }
  g.pimax = pimax;
  g.nb1 = nb1;
  g.nb2 = nb2;
  g.los = los;
  g.is_auto = is_auto;
  g.periodic = periodic;
  g.self = each_pair_once;
  g.all_live = all_live;
  g.tab.base = tab_base;
  g.tab.shift = tab_shift;
  g.tab.len = tab_len;
  g.tab.nedges = nb1 + 1;
  const int m = (int)n1;
  const int one = tab_steps <= 1;
  if (key_bytes == 4)
    return launch_steps<int>(one, mode, pos, w2, flat, cols, p1, w1, live, ci,
                             m, items, max_items, r2edges, (const int4*)tab,
                             out_n, out_w, g, s);
  if (key_bytes == 8)
    return launch_steps<long long>(one, mode, pos, w2, flat, cols, p1, w1,
                                   live, ci, m, items, max_items, r2edges,
                                   (const int4*)tab, out_n, out_w, g, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
