// The column walk of the grid-hash kernels (fof_sweep.cu, paircount.cu,
// threept_alm.cu): the neighbour cells of a query along each axis, as runs
// of consecutive cells or one by one, and the binary search that finds a
// run's first slot inside a column of the cell-sorted ids; for the f64
// kernels the minimum image, np.digitize by a bucket table, and the runs
// of a cell shared by the queries of an item.
//
// The cells visited are the deduplicated set of ops/gridhash.py
// neighbor_offsets: per axis the sorted distinct cells of c + d for the
// offsets d in [dlo, dhi] (wrapped when periodic: all cells when the
// offsets cover the axis; dropped when open and out of the grid).

#pragma once

// The sorted distinct cells of one axis seen from cell c: at most two
// runs [lo, hi] of consecutive cells, in increasing order.
struct Runs {
  int lo0, hi0, lo1, hi1;
  int m;
};

__device__ __forceinline__ Runs axis_runs(int c, int n, int dlo, int dhi,
                                          int periodic) {
  Runs r;
  const int lo = c + dlo, hi = c + dhi;
  r.m = 1;
  r.lo1 = r.hi1 = 0;
  if (!periodic) {
    r.lo0 = lo < 0 ? 0 : lo;
    r.hi0 = hi >= n ? n - 1 : hi;
  } else if (hi - lo + 1 >= n) {  // the offsets cover the axis
    r.lo0 = 0;
    r.hi0 = n - 1;
  } else if (lo < 0) {  // wraps below 0: [0, hi], then [lo + n, n - 1]
    r.m = 2;
    r.lo0 = 0;
    r.hi0 = hi;
    r.lo1 = lo + n;
    r.hi1 = n - 1;
  } else if (hi >= n) {  // wraps above n - 1: [0, hi - n], then [lo, n - 1]
    r.m = 2;
    r.lo0 = 0;
    r.hi0 = hi - n;
    r.lo1 = lo;
    r.hi1 = n - 1;
  } else {
    r.lo0 = lo;
    r.hi0 = hi;
  }
  return r;
}

// The same cells one by one: v[0] < v[1] < v[2], the first m of them.
struct Cells {
  int v[3];
  int m;
};

__device__ __forceinline__ Cells axis_cells(int c, int n, int dlo, int dhi,
                                            int periodic) {
  const Runs r = axis_runs(c, n, dlo, dhi, periodic);
  const int len0 = r.hi0 - r.lo0 + 1;
  Cells o;
#pragma unroll
  for (int t = 0; t < 3; ++t)
    o.v[t] = t < len0 ? r.lo0 + t : r.lo1 + t - len0;
  o.m = len0 + (r.m == 2 ? r.hi1 - r.lo1 + 1 : 0);
  return o;
}

// The first slot in [lo, hi) whose key is not below key (hi if none).
template <typename K>
__device__ __forceinline__ int lower_bound(const K* __restrict__ flat,
                                           int lo, int hi, K key) {
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (flat[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// d - rint(d / box) * box; unchanged (bit for bit) where |d| <= box / 4
__device__ __forceinline__ double min_image(double d, double box) {
  if (fabs(d) > 0.25 * box) d = d - rint(d / box) * box;
  return d;
}

// np.digitize (right=False, increasing edges: the number of edges <= x)
// for x in [e[0], e[nedges - 1]), exactly, from the wrapper's table
// (ops/paircount_cuda.bin_table, device_table). Positive doubles order as
// their bit patterns, so bits(x) >> shift is a monotone bucket k of x:
// 2^(52 - shift) buckets an octave, the first at the smallest positive
// edge. Entry k + 1 of the table holds g, the number of edges <= the
// bucket's least value (a lower bound of the answer), and e[g] beside it
// (+inf past the last edge): one 16-byte load. Entry 0 serves x below the
// first bucket (only when e[0] == 0): g = 1. ONE_STEP: the table holds at
// most one edge inside a bucket (bin_table's steps), so one compare with
// the e[g] loaded beside g ends the walk; else a walk over e. Callers
// decide x < e[0] and x >= e[nedges - 1] by one compare each, before.
struct BinTable {
  long long base;  // bits(smallest positive edge) >> shift
  int shift;
  int len;         // entries of the table, entry 0 included
  int nedges;
};

template <bool ONE_STEP>
__device__ __forceinline__ int table_digitize(const double* __restrict__ e,
                                              const int4* __restrict__ tab,
                                              const BinTable& t, double x) {
  const long long k = (__double_as_longlong(x) >> t.shift) - t.base;
  const int4 v = tab[k < 0 ? 0 : (int)k + 1];
  int g = v.x;
  if (ONE_STEP)
    g += __hiloint2double(v.w, v.z) <= x ? 1 : 0;
  else
    while (e[g] <= x) ++g;
  return g;
}

// The neighbour runs of one grid cell, shared by every query of an item
// (a chunk of queries in one cell): column t = 3 * ka + kb of the 3 x 3
// neighbour columns gives runs 2t and 2t + 1, each [lo, hi) of consecutive
// slots (empty: lo == hi), found by binary searches in the column. image
// is set where a candidate may lie more than a quarter box away along an
// axis, so that the minimum image can change its separation: a periodic
// grid with fewer than 9 cells on an axis, or a neighbour cell reached
// across the wrap. Elsewhere, for positions inside the box (the grid's
// contract), |d| < 2 cells < box / 4, and the minimum image leaves d as
// it is, bit for bit. Thread t < 9 writes its column's two runs.
#define GC_RUNS 18

template <typename K>
__device__ __forceinline__ void column_runs(
    int t, const K* __restrict__ flat, const int* __restrict__ cols, int a,
    int b, int c, const int* dlo, const int* dhi, const int* ncell,
    int periodic, int* lo, int* hi, int* image) {
  const Cells ca = axis_cells(a, ncell[0], dlo[0], dhi[0], periodic);
  const Cells cb = axis_cells(b, ncell[1], dlo[1], dhi[1], periodic);
  const Runs rc = axis_runs(c, ncell[2], dlo[2], dhi[2], periodic);
  const int ka = t / 3, kb = t % 3;
  lo[2 * t] = hi[2 * t] = lo[2 * t + 1] = hi[2 * t + 1] = 0;
  image[2 * t] = image[2 * t + 1] = 0;
  if (ka >= ca.m || kb >= cb.m) return;
  const int va = ca.v[ka], vb = cb.v[kb];
  const int col = va * ncell[1] + vb;
  const K base = (K)col * (K)ncell[2];
  const int end = cols[col + 1];
  const bool small = ncell[0] < 9 || ncell[1] < 9 || ncell[2] < 9;
  const bool wrap_ab = va < a - 1 || va > a + 1 || vb < b - 1 || vb > b + 1;
  int l = lower_bound<K>(flat, cols[col], end, base + (K)rc.lo0);
  int h = lower_bound<K>(flat, l, end, base + (K)rc.hi0 + 1);
  lo[2 * t] = l;
  hi[2 * t] = h;
  image[2 * t] = periodic && (small || wrap_ab || rc.lo0 < c - 1 ||
                              rc.hi0 > c + 1);
  if (rc.m == 2) {
    l = lower_bound<K>(flat, h, end, base + (K)rc.lo1);
    h = lower_bound<K>(flat, l, end, base + (K)rc.hi1 + 1);
    lo[2 * t + 1] = l;
    hi[2 * t + 1] = h;
    image[2 * t + 1] = periodic && (small || wrap_ab || rc.lo1 < c - 1 ||
                                    rc.hi1 > c + 1);
  }
}
