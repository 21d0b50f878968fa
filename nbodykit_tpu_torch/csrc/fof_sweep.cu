// The min-label sweeps of the grid-hash friends-of-friends, for Hopper
// (sm_90a): a column table, a link list built once, and two sweep modes.
//
// Computes neighbor_min of nbodykit_tpu/ops/devicehash.py:190-194 (the
// body that local_fof_labels folds over DeviceGridHash.fold, :148-168),
// which the JAX package leaves to XLA as a lax.while_loop of gathers per
// neighbour offset; no Pallas kernel computes it. For every particle i of
// the cell-sorted arrays:
//
//     out[i] = min(labels[i], min{labels[j] : j in the deduplicated
//              neighbour cells of i, r2(i, j) <= ll2})   if valid[i]
//     out[i] = labels[i]                                 otherwise
//
// The column table. A column is a cell's (a, b) pair; c is the third
// coordinate. cols[a * nc1 + b] is the first sorted slot of column (a, b)
// (searchsorted of (a * nc1 + b) * nc2, built once per FOF in torch), and
// cols[nc0 * nc1] the first dead slot. At 1077^3 cells it holds 1.16e6
// int32 entries, 4.6 MB: it stays in the 50 MB L2. Inside a column the
// ids are sorted by c, so the neighbour cells along c of one (da, db) pair
// are one or two runs of consecutive cells (two where c wraps), each one
// contiguous range of slots. A query therefore reads 9 columns (two
// L2-resident loads each) and one short binary search per run inside the
// column (~8.6 particles a column at 1e7 particles), against 27 searches
// of ~24 dependent loads into all n ids in the first form of this kernel.
// The columns go one after another. Advancing their table loads and
// searches side by side, 3 or 9 at a time, so that a query waits for one
// column's chain of dependent loads, not nine, was slower on the H100: 9
// lanes take 62 registers against 32, and the occupancy lost costs more
// latency hiding than the lanes give (kernel_variants.py fof_sweep).
//
// The cells visited are the deduplicated set of ops/gridhash.py
// neighbor_offsets: per axis the sorted distinct cells of c + d for the
// offsets d in [dlo, dhi] (wrapped when periodic: all cells when the
// offsets cover the axis; dropped when open and out of the grid, the JAX
// package's oob offset). Columns are visited in increasing (a, b) order
// and runs in increasing c, so the slots j of a query come in increasing
// order: the link list is sorted within each row, as the plain version's.
//
// Four kernels, one thread per sorted query each:
//  - fof_search_kernel: the search-mode sweep, the column lookups and the
//    pair test in every sweep. Bound by latency (the dependent loads of
//    the column searches); its byte bound is the inputs read once and the
//    labels written once, 37 bytes a particle at f32 with int32 ids.
//  - fof_link_count_kernel, once per FOF: the same traversal, counting
//    the linked j != i of each valid query (r2 <= ll2). Latency-bound as
//    the search sweep; bytes: the inputs once and 4 a count.
//  - fof_link_fill_kernel, once per FOF: the same traversal again,
//    writing each query's linked j (int32) at its CSR row offset (int64,
//    the torch cumsum of the counts). Invalid queries have no links.
//  - fof_links_sweep_kernel: the links-mode sweep, out[i] = min(labels[i],
//    min labels[links[k]] over the row). Bound by bytes: the row offsets,
//    labels and output, 16 bytes a particle, and 4 bytes a link (plus the
//    label it gathers), no search at all.
// The caller (ops/devicehash.py fof_fixpoint) counts the links, then
// takes the links mode when the list fits the card's free memory beside
// the fixpoint's label arrays, and the search mode otherwise.
//
// The link kernels keep this thread-a-query walk. A design of tiles of
// 128 consecutive sorted queries that stage their shared neighbour
// columns' keys, column-table entries and cell masks in shared memory
// and walk them there (csrc/variants/fof_links_tiles.cu) ran slower on
// the H100 than this walk with the division skip below, on the FOF
// flow's grid, a clustered catalog and a sparse sphere grid
// (kernel_variants.py fof_sweep, PERF.md): the ~8 consecutive queries of
// a column already share its lookups through L1, and the tiles' rounds
// and stage cost more than the shared memory saves.
//
// Every sweep reads the sweep's input labels and writes a separate array
// (a Jacobi sweep), so each equals the plain version exactly in either
// mode; pointer jumping and the convergence test stay in torch.
//
// Float arithmetic: the cell coordinates come from torch, so the only
// float operations here are the plain version's, in its order and in the
// positions' type: d = p_j - p_i; d - rint(d / box) * box (round half to
// even, an IEEE divide); r2 = (dx*dx + dy*dy) + dz*dz. _build.py compiles
// with -fmad=false, so no multiply and add are fused and a pair whose r2
// sits within an ulp of ll2 links as it does in the plain version. The
// division runs only where |d| > box / 4: below that d / box rounds to at
// most 0.25 (box / 4 is exact), rint gives 0 and d is unchanged, bit for
// bit but for a zero's sign, which r2 does not see. On the FOF flow's
// grid nearly every candidate is that close, and the three divisions
// took about an eighth of the link count's time on the H100
// (kernel_variants.py fof_links_first_design).
// The count and the fill run the same code, so they agree on every pair.
//
// Built by nbodykit_tpu_torch/_build.py into a shared library with a plain
// C interface; each nbk_* entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_columns.cuh"

#define SWEEP_THREADS 256

template <typename F>
struct Geo {
  int dlo[3], dhi[3];  // the offsets along each axis: [dlo, dhi]
  int ncell[3];
  F box[3];
  F qbox[3];  // box / 4: below it the minimum image leaves d as it is
  F ll2;
  int periodic;
};

__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_even(double x) { return rint(x); }
__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ double magnitude(double x) { return fabs(x); }

// d - rint(d / box) * box, dividing only where |d| > box / 4
template <typename F>
__device__ __forceinline__ F image(F d, F box, F qbox) {
  return magnitude(d) > qbox ? d - round_even(d / box) * box : d;
}

// Visits the slots j >= s of one run of cells (keys up to khi) in the
// linking length of the query at (px, py, pz); returns the first slot
// past the run. Past a column's last slot come larger keys (the next
// column's, then the dead slots' sentinel), so the walk stops there.
template <typename F, typename K, typename Visit>
__device__ __forceinline__ int walk(const Geo<F>& g,
                                    const F* __restrict__ pos,
                                    const K* __restrict__ flat, int s, int n,
                                    K khi, F px, F py, F pz, Visit& visit) {
  int j = s;
  for (; j < n && flat[j] <= khi; ++j) {
    const size_t j3 = (size_t)3 * j;
    F dx = pos[j3] - px, dy = pos[j3 + 1] - py, dz = pos[j3 + 2] - pz;
    if (g.periodic) {
      dx = image(dx, g.box[0], g.qbox[0]);
      dy = image(dy, g.box[1], g.qbox[1]);
      dz = image(dz, g.box[2], g.qbox[2]);
    }
    const F r2 = (dx * dx + dy * dy) + dz * dz;
    if (r2 <= g.ll2) visit(j);
  }
  return j;
}

// Calls visit(j) for every slot j of a neighbour cell of query i within
// the linking length, in increasing j. The (up to 9) columns go one after
// another in increasing (a, b) order: two column-table loads, a search
// inside the column for the first run along c and a walk over it; where
// c wraps, a search from there for the second run and a walk over it.
template <typename F, typename K, typename Visit>
__device__ __forceinline__ void for_each_link(
    const Geo<F>& g, const F* __restrict__ pos, const int* __restrict__ ci,
    const K* __restrict__ flat, const int* __restrict__ cols, int i, int n,
    Visit& visit) {
  const size_t i3 = (size_t)3 * i;
  const F px = pos[i3], py = pos[i3 + 1], pz = pos[i3 + 2];
  const Cells ca = axis_cells(ci[i3], g.ncell[0], g.dlo[0], g.dhi[0],
                              g.periodic);
  const Cells cb = axis_cells(ci[i3 + 1], g.ncell[1], g.dlo[1], g.dhi[1],
                              g.periodic);
  const Runs rc = axis_runs(ci[i3 + 2], g.ncell[2], g.dlo[2], g.dhi[2],
                            g.periodic);
  const int nc1 = g.ncell[1];
  const K nc2 = (K)g.ncell[2];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int ka = q / 3, kb = q % 3;
    if (ka >= ca.m || kb >= cb.m) continue;
    const int col = ca.v[ka] * nc1 + cb.v[kb];
    const K base = (K)col * nc2;
    const int end = cols[col + 1];
    const int lo = lower_bound<K>(flat, cols[col], end, base + (K)rc.lo0);
    const int j = walk<F, K>(g, pos, flat, lo, n, base + (K)rc.hi0, px, py,
                             pz, visit);
    if (rc.m == 2)
      walk<F, K>(g, pos, flat, lower_bound<K>(flat, j, end, base + (K)rc.lo1),
                 n, base + (K)rc.hi1, px, py, pz, visit);
  }
}

struct MinLabel {
  const int* __restrict__ labels;
  int best;
  __device__ __forceinline__ void operator()(int j) {
    const int l = labels[j];
    best = l < best ? l : best;
  }
};

struct CountLinks {
  int i, count;
  __device__ __forceinline__ void operator()(int j) { count += j != i; }
};

struct FillLinks {
  int i;
  int* __restrict__ links;
  long long k, end;
  __device__ __forceinline__ void operator()(int j) {
    if (j != i && k < end) links[k++] = j;
  }
};

template <typename F, typename K>
__global__ void __launch_bounds__(SWEEP_THREADS)
fof_search_kernel(const F* __restrict__ pos, const int* __restrict__ ci,
                  const K* __restrict__ flat,
                  const unsigned char* __restrict__ valid,
                  const int* __restrict__ cols,
                  const int* __restrict__ labels, int* __restrict__ out,
                  int n, const Geo<F> g) {
  const int i = blockIdx.x * SWEEP_THREADS + threadIdx.x;
  if (i >= n) return;
  MinLabel v{labels, labels[i]};
  if (valid[i]) for_each_link<F, K>(g, pos, ci, flat, cols, i, n, v);
  out[i] = v.best;
}

template <typename F, typename K>
__global__ void __launch_bounds__(SWEEP_THREADS)
fof_link_count_kernel(const F* __restrict__ pos, const int* __restrict__ ci,
                      const K* __restrict__ flat,
                      const unsigned char* __restrict__ valid,
                      const int* __restrict__ cols, int* __restrict__ counts,
                      int n, const Geo<F> g) {
  const int i = blockIdx.x * SWEEP_THREADS + threadIdx.x;
  if (i >= n) return;
  CountLinks v{i, 0};
  if (valid[i]) for_each_link<F, K>(g, pos, ci, flat, cols, i, n, v);
  counts[i] = v.count;
}

template <typename F, typename K>
__global__ void __launch_bounds__(SWEEP_THREADS)
fof_link_fill_kernel(const F* __restrict__ pos, const int* __restrict__ ci,
                     const K* __restrict__ flat,
                     const unsigned char* __restrict__ valid,
                     const int* __restrict__ cols,
                     const long long* __restrict__ row,
                     int* __restrict__ links, int n, const Geo<F> g) {
  const int i = blockIdx.x * SWEEP_THREADS + threadIdx.x;
  if (i >= n) return;
  FillLinks v{i, links, row[i], row[i + 1]};
  if (valid[i] && v.k < v.end)
    for_each_link<F, K>(g, pos, ci, flat, cols, i, n, v);
}

__global__ void __launch_bounds__(SWEEP_THREADS)
fof_links_sweep_kernel(const long long* __restrict__ row,
                       const int* __restrict__ links,
                       const int* __restrict__ labels, int* __restrict__ out,
                       int n) {
  const int i = blockIdx.x * SWEEP_THREADS + threadIdx.x;
  if (i >= n) return;
  int best = labels[i];
  const long long end = row[i + 1];
  for (long long k = row[i]; k < end; ++k) {
    const int l = labels[links[k]];
    best = l < best ? l : best;
  }
  out[i] = best;
}

// what a launch of the traversal kernels computes
enum { SEARCH = 0, COUNT = 1, FILL = 2 };

template <typename F, typename K>
static int launch(int what, const void* pos, const int* ci, const void* flat,
                  const unsigned char* valid, const int* cols,
                  const int* labels, int* out, const long long* row, int n,
                  const int* dlo, const int* dhi, const int* ncell,
                  const double* box, double ll2, int periodic,
                  cudaStream_t s) {
  Geo<F> g;
  for (int k = 0; k < 3; ++k) {
    g.dlo[k] = dlo[k];
    g.dhi[k] = dhi[k];
    g.ncell[k] = ncell[k];
    g.box[k] = (F)box[k];  // the JAX package's jnp.asarray(box, pos.dtype)
    g.qbox[k] = g.box[k] * (F)0.25;
  }
  g.ll2 = (F)ll2;
  g.periodic = periodic;
  const int blocks = (n + SWEEP_THREADS - 1) / SWEEP_THREADS;
  const F* p = (const F*)pos;
  const K* f = (const K*)flat;
  if (what == SEARCH)
    fof_search_kernel<F, K><<<blocks, SWEEP_THREADS, 0, s>>>(
        p, ci, f, valid, cols, labels, out, n, g);
  else if (what == COUNT)
    fof_link_count_kernel<F, K><<<blocks, SWEEP_THREADS, 0, s>>>(
        p, ci, f, valid, cols, out, n, g);
  else
    fof_link_fill_kernel<F, K><<<blocks, SWEEP_THREADS, 0, s>>>(
        p, ci, f, valid, cols, row, out, n, g);
  return (int)cudaGetLastError();
}

static int dispatch(int what, const void* pos, const int* ci,
                    const void* flat, const unsigned char* valid,
                    const int* cols, const int* labels, int* out,
                    const long long* row, long long n, int pos_bytes,
                    int key_bytes, const int* dlo, const int* dhi,
                    const int* ncell, const double* box, double ll2,
                    int periodic, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 3; ++k)
    if (dlo[k] < -1 || dlo[k] > 0 || dhi[k] < 0 || dhi[k] > 1 ||
        ncell[k] < 1)
      return (int)cudaErrorInvalidValue;
  const int m = (int)n;
  if (pos_bytes == 4 && key_bytes == 4)
    return launch<float, int>(what, pos, ci, flat, valid, cols, labels, out,
                              row, m, dlo, dhi, ncell, box, ll2, periodic, s);
  if (pos_bytes == 4 && key_bytes == 8)
    return launch<float, long long>(what, pos, ci, flat, valid, cols, labels,
                                    out, row, m, dlo, dhi, ncell, box, ll2,
                                    periodic, s);
  if (pos_bytes == 8 && key_bytes == 4)
    return launch<double, int>(what, pos, ci, flat, valid, cols, labels,
                               out, row, m, dlo, dhi, ncell, box, ll2,
                               periodic, s);
  if (pos_bytes == 8 && key_bytes == 8)
    return launch<double, long long>(what, pos, ci, flat, valid, cols,
                                     labels, out, row, m, dlo, dhi, ncell,
                                     box, ll2, periodic, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nbk_fof_sweep(const void* pos, const int* ci, const void* flat,
                             const unsigned char* valid, const int* cols,
                             const int* labels, int* out, long long n,
                             int pos_bytes, int key_bytes, const int* dlo,
                             const int* dhi, const int* ncell,
                             const double* box, double ll2, int periodic,
                             void* stream) {
  return dispatch(SEARCH, pos, ci, flat, valid, cols, labels, out, nullptr,
                  n, pos_bytes, key_bytes, dlo, dhi, ncell, box, ll2,
                  periodic, stream);
}

extern "C" int nbk_fof_link_count(const void* pos, const int* ci,
                                  const void* flat,
                                  const unsigned char* valid,
                                  const int* cols, int* counts, long long n,
                                  int pos_bytes, int key_bytes,
                                  const int* dlo, const int* dhi,
                                  const int* ncell, const double* box,
                                  double ll2, int periodic, void* stream) {
  return dispatch(COUNT, pos, ci, flat, valid, cols, nullptr, counts,
                  nullptr, n, pos_bytes, key_bytes, dlo, dhi, ncell, box,
                  ll2, periodic, stream);
}

extern "C" int nbk_fof_link_fill(const void* pos, const int* ci,
                                 const void* flat,
                                 const unsigned char* valid, const int* cols,
                                 const long long* row, int* links,
                                 long long n, int pos_bytes, int key_bytes,
                                 const int* dlo, const int* dhi,
                                 const int* ncell, const double* box,
                                 double ll2, int periodic, void* stream) {
  return dispatch(FILL, pos, ci, flat, valid, cols, nullptr, links, row, n,
                  pos_bytes, key_bytes, dlo, dhi, ncell, box, ll2, periodic,
                  stream);
}

extern "C" int nbk_fof_links_sweep(const long long* row, const int* links,
                                   const int* labels, int* out, long long n,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int m = (int)n;
  fof_links_sweep_kernel<<<(m + SWEEP_THREADS - 1) / SWEEP_THREADS,
                           SWEEP_THREADS, 0, s>>>(row, links, labels, out, m);
  return (int)cudaGetLastError();
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
