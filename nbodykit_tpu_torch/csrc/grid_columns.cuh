// The column walk of the grid-hash kernels (fof_sweep.cu, paircount.cu,
// threept_alm.cu): the neighbour cells of a query along each axis, as runs
// of consecutive cells or one by one, and the binary search that finds a
// run's first slot inside a column of the cell-sorted ids; for the f64
// kernels the minimum image and np.digitize.
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

// the number of edges <= x (np.digitize, right=False, increasing edges)
__device__ __forceinline__ int digitize(const double* __restrict__ e,
                                        int nedges, double x) {
  int lo = 0, hi = nedges;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}
