// One min-label sweep of the grid-hash friends-of-friends, for Hopper
// (sm_90a).
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
// What bounds it on the H100: bytes, counted as the inputs read once (the
// sorted positions, cell coordinates, cell ids, valid flags and labels)
// and the labels written once, 37 bytes a particle at f32 with int32 ids.
// The work depends on the data: each query runs one binary search into
// the sorted cell ids per neighbour offset (~24 dependent loads at 1e7
// particles) and reads every particle of the neighbour cell, so the time
// goes to latency, not to bandwidth.
//
// Design (the first, simple form): one thread per sorted query. The
// queries are in cell order, so a dense cell's queries sit in one warp and
// share the neighbour cells' cache lines. Per offset the thread finds the
// first slot of the neighbour cell with a lower-bound search and walks the
// cell's slots while the id matches; that visits the same slots as the
// JAX package's (start, count) from a lower- and an upper-bound search.
// The labels read are the sweep's input labels and the result goes to a
// separate array (a Jacobi sweep), so each sweep equals its plain version
// exactly; pointer jumping and the convergence test stay in torch.
//
// Float arithmetic: the cell coordinates come from torch, so the only
// float operations here are the plain version's, in its order and in the
// positions' type: d = p_j - p_i; d - rint(d / box) * box (round half to
// even, an IEEE divide); r2 = (dx*dx + dy*dy) + dz*dz. _build.py compiles
// with -fmad=false, so no multiply and add are fused and a pair whose r2
// sits within an ulp of ll2 links as it does in the plain version.
//
// Built by nbodykit_tpu_torch/_build.py into a shared library with a plain
// C interface; nbk_fof_sweep returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#define SWEEP_THREADS 256
#define MAX_OFFSETS 27

template <typename F>
struct SweepParams {
  int noff;
  int off[MAX_OFFSETS][3];
  int ncell[3];
  F box[3];
  F ll2;
  int periodic;
};

__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_even(double x) { return rint(x); }

__device__ __forceinline__ int wrap(int x, int n) {
  return x < 0 ? x + n : (x >= n ? x - n : x);
}

template <typename F, typename K>
__global__ void __launch_bounds__(SWEEP_THREADS)
fof_sweep_kernel(const F* __restrict__ pos, const int* __restrict__ ci,
                 const K* __restrict__ flat,
                 const unsigned char* __restrict__ valid,
                 const int* __restrict__ labels, int* __restrict__ out, int n,
                 const SweepParams<F> p) {
  const int i = blockIdx.x * SWEEP_THREADS + threadIdx.x;
  if (i >= n) return;
  int best = labels[i];
  if (!valid[i]) {
    out[i] = best;
    return;
  }
  const size_t i3 = (size_t)3 * i;
  const F px = pos[i3], py = pos[i3 + 1], pz = pos[i3 + 2];
  const int c0 = ci[i3], c1 = ci[i3 + 1], c2 = ci[i3 + 2];
  const K nc1 = (K)p.ncell[1], nc2 = (K)p.ncell[2];
  for (int o = 0; o < p.noff; ++o) {
    int a = c0 + p.off[o][0], b = c1 + p.off[o][1], c = c2 + p.off[o][2];
    if (p.periodic) {
      a = wrap(a, p.ncell[0]);
      b = wrap(b, p.ncell[1]);
      c = wrap(c, p.ncell[2]);
    } else if (a < 0 || a >= p.ncell[0] || b < 0 || b >= p.ncell[1] ||
               c < 0 || c >= p.ncell[2]) {
      continue;  // the JAX package's oob offset: no candidate
    }
    const K key = ((K)a * nc1 + (K)b) * nc2 + (K)c;
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
      if (flat[mid] < key) lo = mid + 1; else hi = mid;
    }
    for (int j = lo; j < n && flat[j] == key; ++j) {
      const size_t j3 = (size_t)3 * j;
      F dx = pos[j3] - px, dy = pos[j3 + 1] - py, dz = pos[j3 + 2] - pz;
      if (p.periodic) {
        dx = dx - round_even(dx / p.box[0]) * p.box[0];
        dy = dy - round_even(dy / p.box[1]) * p.box[1];
        dz = dz - round_even(dz / p.box[2]) * p.box[2];
      }
      const F r2 = (dx * dx + dy * dy) + dz * dz;
      if (r2 <= p.ll2) {
        const int l = labels[j];
        best = l < best ? l : best;
      }
    }
  }
  out[i] = best;
}

template <typename F, typename K>
static int launch(const void* pos, const int* ci, const void* flat,
                  const unsigned char* valid, const int* labels, int* out,
                  int n, const int* offs, int noff, const int* ncell,
                  const double* box, double ll2, int periodic,
                  cudaStream_t s) {
  SweepParams<F> p;
  p.noff = noff;
  for (int o = 0; o < noff; ++o)
    for (int k = 0; k < 3; ++k) p.off[o][k] = offs[3 * o + k];
  for (int k = 0; k < 3; ++k) {
    p.ncell[k] = ncell[k];
    p.box[k] = (F)box[k];  // the JAX package's jnp.asarray(box, pos.dtype)
  }
  p.ll2 = (F)ll2;
  p.periodic = periodic;
  const int blocks = (n + SWEEP_THREADS - 1) / SWEEP_THREADS;
  fof_sweep_kernel<F, K><<<blocks, SWEEP_THREADS, 0, s>>>(
      (const F*)pos, ci, (const K*)flat, valid, labels, out, n, p);
  return (int)cudaGetLastError();
}

extern "C" int nbk_fof_sweep(const void* pos, const int* ci, const void* flat,
                             const unsigned char* valid, const int* labels,
                             int* out, long long n, int pos_bytes,
                             int key_bytes, const int* offs, int noff,
                             const int* ncell, const double* box, double ll2,
                             int periodic, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (n >= (1LL << 31) || noff < 1 || noff > MAX_OFFSETS)
    return (int)cudaErrorInvalidValue;
  const int m = (int)n;
  if (pos_bytes == 4 && key_bytes == 4)
    return launch<float, int>(pos, ci, flat, valid, labels, out, m, offs,
                              noff, ncell, box, ll2, periodic, s);
  if (pos_bytes == 4 && key_bytes == 8)
    return launch<float, long long>(pos, ci, flat, valid, labels, out, m,
                                    offs, noff, ncell, box, ll2, periodic, s);
  if (pos_bytes == 8 && key_bytes == 4)
    return launch<double, int>(pos, ci, flat, valid, labels, out, m, offs,
                               noff, ncell, box, ll2, periodic, s);
  if (pos_bytes == 8 && key_bytes == 8)
    return launch<double, long long>(pos, ci, flat, valid, labels, out, m,
                                     offs, noff, ncell, box, ll2, periodic,
                                     s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
