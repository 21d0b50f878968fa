// The first design of csrc/paircount.cu, kept so that
// nbodykit_tpu_torch/kernel_variants.py and chip_smoke.py can time it beside
// the kernel as built (the "first_design" take-back variants). It computes the
// same function through the same C interface; nothing else builds or calls it.
//
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
// leaves them; a masked candidate adds nothing (it adds 0 to the overflow
// slot there). The histograms are (nb1 + 2) * nb2 long: npairs as exact
// 64-bit integer counts, wpairs f64.
//
// What bounds it: f64 arithmetic. At the boss_like sample (1e6 points,
// r_max = 150 in a box of 2500: 16^3 cells of ~244) every query visits
// ~6.6e3 candidates, 6.6e9 in all, of 13 to 40 f64 operations each
// (paircount_cuda.candidate_ops); the inputs are 1e6 * 45 bytes. Design:
//  - One warp per query, warps striding over the cell-ordered queries, so
//    the warps in flight share their neighbour columns in L1/L2. The
//    column table of fof_sweep.cu (the first slot of every (a, b) column)
//    gives each query its 9 columns; two short binary searches inside a
//    column bound each run of up to 3 consecutive cells along c, and the
//    32 lanes take 32 consecutive slots of a run at a time: coalesced
//    loads, no per-thread walk.
//  - A histogram pair in shared memory per CTA (u64 counts, f64 sums),
//    flushed once per CTA with global atomics. The candidates of one
//    warp step land in few bins, so the step aggregates first: lanes with
//    one bin find each other (__match_any_sync), each sums its group's
//    weights in lane order by shuffles, and the lowest lane adds the
//    count and the sum. Shared f64 atomicAdd is a compare-and-swap loop
//    on Hopper: one per group keeps its retries rare.
//  - Past r_max lie ~5/6 of the candidates, all in the overflow row. With
//    one column ('1d', 'angular') that row is one bin, and its group of
//    ~27 lanes made the shuffle loop the step's largest cost; there each
//    lane keeps the row's count and sum in registers, reduced over the
//    warp once at the end; a count with more columns runs the kernel
//    without it (ONE_COLUMN false; kernel_variants.py paircount takes it
//    back).
//  - The minimum image divides only where |d| > box / 4: below that
//    rint(d / box) is 0 and d is unchanged, bit for bit.
//
// Float arithmetic is the plain version's, operation by operation, in its
// order; _build.py compiles with -fmad=false, so nothing is fused into an
// FMA and a pair whose r2 sits on an edge bins as it does there. Counts
// are exact; the f64 sums differ from the plain version's by the order of
// the additions (the atomics).
//
// Built by nbodykit_tpu_torch/_build.py into a shared library with a plain
// C interface; nbk_paircount_hist returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_columns.cuh"

// the number of edges <= x (np.digitize, right=False, increasing edges):
// a binary search over all of them
__device__ __forceinline__ int search_digitize(const double* __restrict__ e,
                                               int nedges, double x) {
  int lo = 0, hi = nedges;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

#define PC_THREADS 256
#define PC_WARPS (PC_THREADS / 32)
// CTAs a streaming multiprocessor of the grid-stride launch
#define PC_CTAS_PER_SM 8

enum { MODE_1D = 0, MODE_2D = 1, MODE_PROJECTED = 2 };

struct PcGeo {
  int dlo[3], dhi[3];
  int ncell[3];
  double box[3];
  double origin[3];
  double pimax;
  int nb1, nb2;
  int mode;     // MODE_*; 'angular' is MODE_1D
  int los;      // the axis, or -1 for the midpoint line of sight
  int is_auto, periodic;
};

// The bin of one candidate, or -1 where it is masked.
__device__ __forceinline__ int pair_bin(const PcGeo& g,
                                        const double* __restrict__ e,
                                        double px, double py, double pz,
                                        double sx, double sy, double sz) {
  double dx = sx - px, dy = sy - py, dz = sz - pz;
  if (g.periodic) {
    dx = min_image(dx, g.box[0]);
    dy = min_image(dy, g.box[1]);
    dz = min_image(dz, g.box[2]);
  }
  const double r2 = (dx * dx + dy * dy) + dz * dz;
  if (g.is_auto ? !(r2 > 0.0) : !(r2 >= 0.0)) return -1;
  const int nedges = g.nb1 + 1;
  int row = 0, col = 0;
  if (g.mode == MODE_1D) return search_digitize(e, nedges, r2) * g.nb2;
  // d = -dn: primary minus secondary
  const double ex = -dx, ey = -dy, ez = -dz;
  double dlos;
  if (g.los < 0) {
    const double mx = 0.5 * (px + sx) + g.origin[0];
    const double my = 0.5 * (py + sy) + g.origin[1];
    const double mz = 0.5 * (pz + sz) + g.origin[2];
    const double mnorm = sqrt((mx * mx + my * my) + mz * mz);
    const double dot = (ex * mx + ey * my) + ez * mz;
    dlos = fabs(dot) / (mnorm == 0.0 ? 1.0 : mnorm);
  } else {
    dlos = fabs(g.los == 0 ? ex : (g.los == 1 ? ey : ez));
  }
  if (g.mode == MODE_2D) {
    row = search_digitize(e, nedges, r2);
    const double rr = sqrt(r2 == 0.0 ? 1.0 : r2);
    const double mu = r2 == 0.0 ? 0.0 : dlos / rr;
    col = (int)(mu * (double)g.nb2);
  } else {  // MODE_PROJECTED
    if (!(dlos < g.pimax)) return -1;
    const double drp2 = r2 - dlos * dlos;
    row = search_digitize(e, nedges, drp2);
    col = (int)dlos;
  }
  col = col < 0 ? 0 : (col > g.nb2 - 1 ? g.nb2 - 1 : col);
  return row * g.nb2 + col;
}

// Adds one warp step's candidates to the CTA's histograms: the lanes of
// one bin sum their weights in lane order, and the lowest adds count and
// sum. Every lane of the warp calls it (bin -1: nothing to add).
__device__ __forceinline__ void warp_add(int bin, double w,
                                         unsigned long long* hn,
                                         double* hw) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(full, bin);
  const int size = __popc(peers);
  // the largest group that adds anything (masked lanes add nothing)
  const int steps = (int)__reduce_max_sync(full, bin >= 0 ? size : 0);
  double s = 0.0;
  unsigned rest = peers;
  for (int t = 0; t < steps; ++t) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    const double o = __shfl_sync(full, w, src);
    if (rest) {
      s += o;
      rest &= rest - 1;
    }
  }
  if (bin >= 0 && lane == __ffs(peers) - 1) {
    atomicAdd(&hn[bin], (unsigned long long)size);
    atomicAdd(&hw[bin], s);
  }
}

// The slots [lo, hi) against query (px, py, pz) of weight wq, 32 at once.
// With one column (ONE_COLUMN: nb2 = 1) the overflow row, the pairs past
// the last edge (5/6 of a 1d count's candidates at boss_like), goes to the
// lane's own sums far_n and far_w, added once at the end, not through
// warp_add.
template <bool ONE_COLUMN>
__device__ __forceinline__ void count_run(const PcGeo& g,
                                          const double* __restrict__ e,
                                          const double* __restrict__ pos,
                                          const double* __restrict__ w2,
                                          int lo, int hi, double px,
                                          double py, double pz, double wq,
                                          unsigned long long* hn,
                                          double* hw,
                                          unsigned long long& far_n,
                                          double& far_w) {
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += 32) {
    const int j = base + lane;
    int bin = -1;
    double w = 0.0;
    if (j < hi) {
      const size_t j3 = (size_t)3 * j;
      bin = pair_bin(g, e, px, py, pz, pos[j3], pos[j3 + 1], pos[j3 + 2]);
      if (bin >= 0) w = wq * w2[j];
    }
    if (ONE_COLUMN && bin == g.nb1 + 1) {
      far_n += 1;
      far_w += w;
      bin = -1;
    }
    warp_add(bin, w, hn, hw);
  }
}

template <typename K, bool ONE_COLUMN>
__global__ void __launch_bounds__(PC_THREADS)
paircount_kernel(const double* __restrict__ pos, const double* __restrict__ w2,
                 const K* __restrict__ flat, const int* __restrict__ cols,
                 const double* __restrict__ p1,
                 const double* __restrict__ w1,
                 const unsigned char* __restrict__ live,
                 const int* __restrict__ ci, int n1,
                 const double* __restrict__ r2edges,
                 unsigned long long* __restrict__ out_n,
                 double* __restrict__ out_w, const PcGeo g) {
  extern __shared__ double smem[];
  const int nbins = (g.nb1 + 2) * g.nb2;
  double* hw = smem;
  unsigned long long* hn = (unsigned long long*)(smem + nbins);
  double* e = smem + 2 * nbins;
  for (int b = threadIdx.x; b < nbins; b += PC_THREADS) {
    hw[b] = 0.0;
    hn[b] = 0ull;
  }
  for (int b = threadIdx.x; b <= g.nb1; b += PC_THREADS) e[b] = r2edges[b];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int nwarps = gridDim.x * PC_WARPS;
  const int nc1 = g.ncell[1];
  const K nc2 = (K)g.ncell[2];
  unsigned long long far_n = 0ull;
  double far_w = 0.0;
  for (int q = blockIdx.x * PC_WARPS + warp; q < n1; q += nwarps) {
    if (!live[q]) continue;
    const size_t q3 = (size_t)3 * q;
    const double px = p1[q3], py = p1[q3 + 1], pz = p1[q3 + 2];
    const double wq = w1[q];
    const Cells ca = axis_cells(ci[q3], g.ncell[0], g.dlo[0], g.dhi[0],
                                g.periodic);
    const Cells cb = axis_cells(ci[q3 + 1], g.ncell[1], g.dlo[1], g.dhi[1],
                                g.periodic);
    const Runs rc = axis_runs(ci[q3 + 2], g.ncell[2], g.dlo[2], g.dhi[2],
                              g.periodic);
    for (int t = 0; t < 9; ++t) {
      const int ka = t / 3, kb = t % 3;
      if (ka >= ca.m || kb >= cb.m) continue;
      const int col = ca.v[ka] * nc1 + cb.v[kb];
      const K base = (K)col * nc2;
      const int end = cols[col + 1];
      int lo = lower_bound<K>(flat, cols[col], end, base + (K)rc.lo0);
      int hi = lower_bound<K>(flat, lo, end, base + (K)rc.hi0 + 1);
      count_run<ONE_COLUMN>(g, e, pos, w2, lo, hi, px, py, pz, wq, hn, hw,
                            far_n, far_w);
      if (rc.m == 2) {
        lo = lower_bound<K>(flat, hi, end, base + (K)rc.lo1);
        hi = lower_bound<K>(flat, lo, end, base + (K)rc.hi1 + 1);
        count_run<ONE_COLUMN>(g, e, pos, w2, lo, hi, px, py, pz, wq, hn,
                              hw, far_n, far_w);
      }
    }
  }
  if (ONE_COLUMN) {
    // the lanes' overflow-row sums: a tree over the warp, one add a warp
    for (int o = 16; o > 0; o >>= 1) {
      far_n += __shfl_down_sync(0xffffffffu, far_n, o);
      far_w += __shfl_down_sync(0xffffffffu, far_w, o);
    }
    if ((threadIdx.x & 31) == 0 && far_n) {
      atomicAdd(&hn[g.nb1 + 1], far_n);
      atomicAdd(&hw[g.nb1 + 1], far_w);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += PC_THREADS) {
    if (hn[b]) {
      atomicAdd(&out_n[b], hn[b]);
      atomicAdd(&out_w[b], hw[b]);
    }
  }
}

// Shared memory a CTA takes for nbins bins and nb1 + 1 edges.
static size_t smem_bytes(int nbins, int nb1) {
  return (size_t)nbins * 16 + (size_t)(nb1 + 1) * 8;
}

template <typename K, bool ONE_COLUMN>
static int launch(const double* pos, const double* w2, const void* flat,
                  const int* cols, const double* p1, const double* w1,
                  const unsigned char* live, const int* ci, int n1,
                  const double* r2edges, unsigned long long* out_n,
                  double* out_w, const PcGeo& g, cudaStream_t s) {
  const int nbins = (g.nb1 + 2) * g.nb2;
  const size_t smem = smem_bytes(nbins, g.nb1);
  cudaError_t err = cudaFuncSetAttribute(
      paircount_kernel<K, ONE_COLUMN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = ((long long)n1 + PC_WARPS - 1) / PC_WARPS;
  const long long cap = (long long)sms * PC_CTAS_PER_SM;
  const int blocks = (int)(need < cap ? need : cap);
  paircount_kernel<K, ONE_COLUMN><<<blocks, PC_THREADS, smem, s>>>(
      pos, w2, (const K*)flat, cols, p1, w1, live, ci, n1, r2edges, out_n,
      out_w, g);
  return (int)cudaGetLastError();
}

extern "C" int nbk_paircount_hist(
    const double* pos, const double* w2, const void* flat, const int* cols,
    long long n2, int key_bytes, const double* p1, const double* w1,
    const unsigned char* live, const int* ci, long long n1,
    const double* r2edges, int nb1, int nb2, int mode, int los,
    const double* origin, double pimax, int is_auto, int periodic,
    const int* dlo, const int* dhi, const int* ncell, const double* box,
    unsigned long long* out_n, double* out_w, const int* items,
    int max_items, const short* tab, int tab_len, int tab_shift,
    long long tab_base, int tab_steps, int each_pair_once,
    const unsigned char* all_live, void* stream) {
  // the kernel's interface: the item list, the bin table and the one-end
  // count of an auto count are not used here (every query counts every
  // candidate, so the histograms are the same)
  (void)items, (void)max_items, (void)tab, (void)tab_len, (void)tab_shift;
  (void)tab_base, (void)tab_steps, (void)each_pair_once, (void)all_live;
  cudaStream_t s = (cudaStream_t)stream;
  if (n1 <= 0 || n2 <= 0) return 0;
  if (n1 >= (1LL << 31) || n2 >= (1LL << 31) || nb1 < 1 || nb2 < 1 ||
      mode < MODE_1D || mode > MODE_PROJECTED || los < -1 || los > 2)
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
  g.mode = mode;
  g.los = los;
  g.is_auto = is_auto;
  g.periodic = periodic;
  const int m = (int)n1;
  if (key_bytes != 4 && key_bytes != 8) return (int)cudaErrorInvalidValue;
  if (key_bytes == 4)
    return nb2 == 1 ? launch<int, true>(pos, w2, flat, cols, p1, w1, live, ci,
                                        m, r2edges, out_n, out_w, g, s)
                    : launch<int, false>(pos, w2, flat, cols, p1, w1, live,
                                         ci, m, r2edges, out_n, out_w, g, s);
  return nb2 == 1
             ? launch<long long, true>(pos, w2, flat, cols, p1, w1, live, ci,
                                       m, r2edges, out_n, out_w, g, s)
             : launch<long long, false>(pos, w2, flat, cols, p1, w1, live,
                                        ci, m, r2edges, out_n, out_w, g, s);
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
