// The first design of the FOF link kernels of csrc/fof_sweep.cu
// (fof_link_count_kernel, fof_link_fill_kernel), kept so that
// nbodykit_tpu_torch/kernel_variants.py and chip_smoke.py can time it beside
// the kernels as built (the "first_design" take-back variant). It computes
// the same functions through the same C interface (nbk_fof_link_count,
// nbk_fof_link_fill); nothing else builds or calls it.
//
// One thread a sorted query. For each of its (up to 9) neighbour columns,
// in increasing (a, b) order: two column-table loads, a binary search
// inside the column for the first run of cells along c, and a walk that
// loads each candidate's key before its position; where c wraps, a second
// search and walk. Each step of that chain waits for the last (dependent
// L2 loads), and the ~8 consecutive threads whose queries share a column
// repeat the same lookups. The count adds the linked j != i of a valid
// query; the fill writes them (int32) at the query's CSR row offset
// (int64), one 4-byte store each. Every periodic candidate pays three IEEE
// divisions, d - rint(d / box) * box on each axis.
//
// Float arithmetic is the plain version's, in its order and in the
// positions' type; _build.FLAGS compile with -fmad=false, so a pair whose
// r2 sits within an ulp of ll2 links as it does in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_columns.cuh"

#define SWEEP_THREADS 256

template <typename F>
struct Geo {
  int dlo[3], dhi[3];  // the offsets along each axis: [dlo, dhi]
  int ncell[3];
  F box[3];
  F ll2;
  int periodic;
};

__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_even(double x) { return rint(x); }

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
      dx = dx - round_even(dx / g.box[0]) * g.box[0];
      dy = dy - round_even(dy / g.box[1]) * g.box[1];
      dz = dz - round_even(dz / g.box[2]) * g.box[2];
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

// what a launch of the link kernels computes
enum { COUNT = 1, FILL = 2 };

template <typename F, typename K>
static int launch(int what, const void* pos, const int* ci, const void* flat,
                  const unsigned char* valid, const int* cols, int* out,
                  const long long* row, int n, const int* dlo,
                  const int* dhi, const int* ncell, const double* box,
                  double ll2, int periodic, cudaStream_t s) {
  Geo<F> g;
  for (int k = 0; k < 3; ++k) {
    g.dlo[k] = dlo[k];
    g.dhi[k] = dhi[k];
    g.ncell[k] = ncell[k];
    g.box[k] = (F)box[k];  // the JAX package's jnp.asarray(box, pos.dtype)
  }
  g.ll2 = (F)ll2;
  g.periodic = periodic;
  const int blocks = (n + SWEEP_THREADS - 1) / SWEEP_THREADS;
  const F* p = (const F*)pos;
  const K* f = (const K*)flat;
  if (what == COUNT)
    fof_link_count_kernel<F, K><<<blocks, SWEEP_THREADS, 0, s>>>(
        p, ci, f, valid, cols, out, n, g);
  else
    fof_link_fill_kernel<F, K><<<blocks, SWEEP_THREADS, 0, s>>>(
        p, ci, f, valid, cols, row, out, n, g);
  return (int)cudaGetLastError();
}

static int dispatch(int what, const void* pos, const int* ci,
                    const void* flat, const unsigned char* valid,
                    const int* cols, int* out, const long long* row,
                    long long n, int pos_bytes, int key_bytes,
                    const int* dlo, const int* dhi, const int* ncell,
                    const double* box, double ll2, int periodic,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 3; ++k)
    if (dlo[k] < -1 || dlo[k] > 0 || dhi[k] < 0 || dhi[k] > 1 ||
        ncell[k] < 1)
      return (int)cudaErrorInvalidValue;
  const int m = (int)n;
  if (pos_bytes == 4 && key_bytes == 4)
    return launch<float, int>(what, pos, ci, flat, valid, cols, out, row, m,
                              dlo, dhi, ncell, box, ll2, periodic, s);
  if (pos_bytes == 4 && key_bytes == 8)
    return launch<float, long long>(what, pos, ci, flat, valid, cols, out,
                                    row, m, dlo, dhi, ncell, box, ll2,
                                    periodic, s);
  if (pos_bytes == 8 && key_bytes == 4)
    return launch<double, int>(what, pos, ci, flat, valid, cols, out, row,
                               m, dlo, dhi, ncell, box, ll2, periodic, s);
  if (pos_bytes == 8 && key_bytes == 8)
    return launch<double, long long>(what, pos, ci, flat, valid, cols, out,
                                     row, m, dlo, dhi, ncell, box, ll2,
                                     periodic, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nbk_fof_link_count(const void* pos, const int* ci,
                                  const void* flat,
                                  const unsigned char* valid,
                                  const int* cols, int* counts, long long n,
                                  int pos_bytes, int key_bytes,
                                  const int* dlo, const int* dhi,
                                  const int* ncell, const double* box,
                                  double ll2, int periodic, void* stream) {
  return dispatch(COUNT, pos, ci, flat, valid, cols, counts, nullptr, n,
                  pos_bytes, key_bytes, dlo, dhi, ncell, box, ll2, periodic,
                  stream);
}

extern "C" int nbk_fof_link_fill(const void* pos, const int* ci,
                                 const void* flat,
                                 const unsigned char* valid, const int* cols,
                                 const long long* row, int* links,
                                 long long n, int pos_bytes, int key_bytes,
                                 const int* dlo, const int* dhi,
                                 const int* ncell, const double* box,
                                 double ll2, int periodic, void* stream) {
  return dispatch(FILL, pos, ci, flat, valid, cols, links, row, n,
                  pos_bytes, key_bytes, dlo, dhi, ncell, box, ll2, periodic,
                  stream);
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
