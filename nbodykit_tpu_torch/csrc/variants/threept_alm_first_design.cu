// The first design of csrc/threept_alm.cu, kept so that
// nbodykit_tpu_torch/kernel_variants.py and chip_smoke.py can time it beside
// the kernel as built (the "first_design" take-back variants). It computes the
// same function through the same C interface; nothing else builds or calls it.
//
// Spherical-harmonic moments of each query's neighbours, the inner loop of
// the Slepian & Eisenstein three-point function, for Hopper (sm_90a).
//
// Replaces the fold body of the JAX package's 3PCF,
// nbodykit_tpu/algorithms/threeptcf.py:58-72 (_se_chunk_zeta under
// GridHash.fold), which XLA runs as gathers, the 2 ell + 1 real Y_lm of
// every candidate and a one-hot product per (offset, slot); no Pallas
// kernel computes it. For every live query i:
//
//     a[i, lm, b] = sum_j w[j] Y_lm(d / |d|) [digitize(r2, r2edges) - 1 == b]
//
// over the candidates j of its neighbour cells with r2 > 1e-20 and b in
// [0, nbins), d = p[j] - p[i] (minimum-imaged when periodic), r2 = (dx*dx
// + dy*dy) + dz*dz; zero rows for a query that is not live. The Y_lm are
// the port's get_real_Ylm (algorithms/convpower/fkp.py), evaluated here
// by the same recurrence in the same order: W_mm, W_{m+1,m} = (z (2m+1))
// W_mm, W_lm = (((2l-1) z) W_{l-1,m} - (l+m-1) W_{l-2,m}) / (l-m), the
// azimuthal factor as Re or Im of (x + iy)^|m| by repeated products, and
// (norm * W) * azim. The wrapper passes each lm's (l, m, norm, W_mm).
//
// What bounds it: f64 arithmetic. At the boss_like sample (1e6 points,
// edges 20..150 in a box of 2500) each query has ~900 neighbours in its
// bins among ~6.6e3 candidates; every in-bin pair costs 2 ell + 1 Y_lm at
// each pole (25 at poles 0-4: 160 f64 operations with the products and
// sums, threept_cuda.ylm_ops), every candidate ~20. Design:
//  - One warp per query, warps striding over the cell-ordered queries,
//    the 9 columns of the column table as in paircount.cu; the 32 lanes
//    test 32 consecutive slots of a run at once.
//  - Only ~1 candidate in 7 is in a bin, so the in-bin ones are queued in
//    the warp's shared memory (unit vector, weight, bin) in candidate
//    order, and taken 32 at a time: lane t evaluates every Y_lm of pair t
//    in one pass (the recurrence in l for each |m|, the powers of x + iy
//    once), all lanes busy and no lane waiting on another's chain.
//  - Then lane t adds row t (t + 32, ...) of each pair of the batch, in
//    queue order, to the warp's moments in shared memory (nlm x nbins
//    f64, 2.6 KB at poles 0-4 and 13 bins): one writer per entry, no
//    atomics, the pairs of a query in one fixed order. The first form
//    of this kernel (lane t evaluating Y_lm number t of one pair after
//    another, the pair broadcast by shuffles) added in the same order;
//    its warps waited on each pair's dependent recurrence.
//  - The moments go to the output row once per query, coalesced.
//
// Float arithmetic: -fmad=false (_build.py), so no product and sum fuse;
// the plain version (ops/threept_cuda.py) sums in another order (its
// fold goes offset by offset and its einsum sums a block of slots), so
// the moments agree to the f64 rounding of those sums.
//
// Built by nbodykit_tpu_torch/_build.py into a shared library with a plain
// C interface; nbk_threept_alm returns the launch's cudaError_t.

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

#define TA_THREADS 128
#define TA_WARPS (TA_THREADS / 32)
#define TA_CTAS_PER_SM 8

struct TaGeo {
  int dlo[3], dhi[3];
  int ncell[3];
  double box[3];
  int periodic;
  int nbins, nlm, lmax;
};

// The per-warp shared memory: a queue of in-bin pairs (QCAP entries), the
// harmonics of QBATCH of them, and the nlm x nbins moments of the query.
#define QCAP 64
#define QBATCH 32

struct WarpMem {
  double* qx;   // QCAP unit vectors, weights and bins of queued pairs
  double* qy;
  double* qz;
  double* qw;
  int* qb;
  double* ys;   // QBATCH x nlm harmonics of a batch
  double* acc;  // nlm x nbins moments
};

// Every requested Y_lm of the unit vector (x, y, z) into ys[0..nlm), as
// get_real_Ylm computes each: for each |m| the recurrence in l from W_mm
// (W_{m+1,m} = (z (2m+1)) W_mm, then (((2l-1) z) W - (l+m-1) W_prev) /
// (l-m)), and (x + iy)^|m| by repeated products; Y = (norm * W) * Re or
// Im of it (* 1.0 for m = 0). lbase[l] is the index of (l, -l), -1 for an
// l not requested; wmm[m] = (-1)^m (2m-1)!!.
__device__ __forceinline__ void all_ylm(int lmax, const int* __restrict__ lbase,
                                        const double* __restrict__ norms,
                                        const double* __restrict__ wmm,
                                        double x, double y, double z,
                                        double* __restrict__ ys) {
  double re = 1.0, im = 0.0;
  for (int m = 0; m <= lmax; ++m) {
    if (m == 1) {
      re = x;
      im = y;
    } else if (m > 1) {
      const double nr = re * x - im * y;
      im = re * y + im * x;
      re = nr;
    }
    const double wm = wmm[m];
    double W = wm, Wp = 0.0;
    for (int l = m; l <= lmax; ++l) {
      if (l == m + 1) {
        Wp = W;
        W = z * (double)(2 * m + 1) * wm;
      } else if (l > m + 1) {
        const double Wn = ((double)(2 * l - 1) * z * W -
                           (double)(l + m - 1) * Wp) / (double)(l - m);
        Wp = W;
        W = Wn;
      }
      const int b = lbase[l];
      if (b < 0) continue;
      if (m == 0) {
        ys[b + l] = norms[b + l] * W * 1.0;
      } else {
        ys[b + l + m] = norms[b + l + m] * W * re;
        ys[b + l - m] = norms[b + l - m] * W * im;
      }
    }
  }
}

// The first np queued pairs into the moments, in queue order: lane t
// evaluates the harmonics of pair t, then lane t adds row t (t + 32, ...)
// of every pair: acc[t][bin] += Y_t * w.
__device__ __forceinline__ void drain(const TaGeo& g, int lmax,
                                      const int* __restrict__ lbase,
                                      const double* __restrict__ norms,
                                      const double* __restrict__ wmm,
                                      const WarpMem& wm, int np) {
  const int lane = threadIdx.x & 31;
  if (lane < np)
    all_ylm(lmax, lbase, norms, wmm, wm.qx[lane], wm.qy[lane], wm.qz[lane],
            wm.ys + lane * g.nlm);
  __syncwarp();
  for (int p = 0; p < np; ++p) {
    const int b = wm.qb[p];
    const double w = wm.qw[p];
    const double* y = wm.ys + p * g.nlm;
    for (int t = lane; t < g.nlm; t += 32) wm.acc[t * g.nbins + b] += y[t] * w;
  }
  __syncwarp();
}

// The in-bin candidates of slots [lo, hi) queued, and the queue drained
// QBATCH at a time; qn, the queue's length, is warp-uniform.
__device__ __forceinline__ void moments_run(
    const TaGeo& g, const double* __restrict__ e,
    const double* __restrict__ pos, const double* __restrict__ w, int lo,
    int hi, double px, double py, double pz, int lmax,
    const int* __restrict__ lbase, const double* __restrict__ norms,
    const double* __restrict__ wmm, const WarpMem& wm, int& qn) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += 32) {
    const int j = base + lane;
    bool inb = false;
    double ux = 0.0, uy = 0.0, uz = 0.0, wj = 0.0;
    int bin = 0;
    if (j < hi) {
      const size_t j3 = (size_t)3 * j;
      double dx = pos[j3] - px, dy = pos[j3 + 1] - py, dz = pos[j3 + 2] - pz;
      if (g.periodic) {
        dx = min_image(dx, g.box[0]);
        dy = min_image(dy, g.box[1]);
        dz = min_image(dz, g.box[2]);
      }
      const double r2 = (dx * dx + dy * dy) + dz * dz;
      if (r2 > 1e-20) {
        const int dig = search_digitize(e, g.nbins + 1, r2) - 1;
        if (dig >= 0 && dig < g.nbins) {
          inb = true;
          const double rr = sqrt(r2);
          ux = dx / rr;
          uy = dy / rr;
          uz = dz / rr;
          wj = w[j];
          bin = dig;
        }
      }
    }
    const unsigned ball = __ballot_sync(full, inb);
    if (inb) {
      const int at = qn + __popc(ball & ((1u << lane) - 1u));
      wm.qx[at] = ux;
      wm.qy[at] = uy;
      wm.qz[at] = uz;
      wm.qw[at] = wj;
      wm.qb[at] = bin;
    }
    qn += __popc(ball);
    __syncwarp();
    if (qn >= QBATCH) {
      drain(g, lmax, lbase, norms, wmm, wm, QBATCH);
      // the rest (fewer than 32) to the front of the queue
      if (lane < qn - QBATCH) {
        wm.qx[lane] = wm.qx[lane + QBATCH];
        wm.qy[lane] = wm.qy[lane + QBATCH];
        wm.qz[lane] = wm.qz[lane + QBATCH];
        wm.qw[lane] = wm.qw[lane + QBATCH];
        wm.qb[lane] = wm.qb[lane + QBATCH];
      }
      qn -= QBATCH;
      __syncwarp();
    }
  }
}

// Shared memory of one warp: the queue (36 bytes an entry), a batch's
// harmonics and the moments.
__host__ __device__ static size_t warp_bytes(int nbins, int nlm) {
  return (size_t)QCAP * 36 + (size_t)QBATCH * nlm * 8 +
         (size_t)nlm * nbins * 8;
}

// Shared memory of one CTA: the edges, the lm table (norms; lbase and
// wmm for l, m <= lmax), then the warps' memory.
static size_t smem_bytes(int nbins, int nlm, int lmax) {
  return (size_t)(nbins + 1) * 8 + (size_t)nlm * 8 + (size_t)(lmax + 1) * 16 +
         (size_t)TA_WARPS * warp_bytes(nbins, nlm);
}

template <typename K>
__global__ void __launch_bounds__(TA_THREADS)
threept_alm_kernel(const double* __restrict__ pos,
                   const double* __restrict__ w, const K* __restrict__ flat,
                   const int* __restrict__ cols,
                   const double* __restrict__ p,
                   const unsigned char* __restrict__ live,
                   const int* __restrict__ ci, int m,
                   const double* __restrict__ r2edges,
                   const int* __restrict__ lm_l, const int* __restrict__ lm_m,
                   const double* __restrict__ lm_norm,
                   const double* __restrict__ lm_wmm,
                   double* __restrict__ out, const TaGeo g) {
  extern __shared__ double smem[];
  const int per = g.nlm * g.nbins;
  const int lmax = g.lmax;
  double* e = smem;                              // nbins + 1
  double* norms = e + (g.nbins + 1);             // nlm
  double* wmm = norms + g.nlm;                   // lmax + 1
  int* lbase = (int*)(wmm + lmax + 1);           // lmax + 1 (8 B each)
  char* wbase = (char*)(lbase + 2 * (lmax + 1));
  for (int b = threadIdx.x; b <= g.nbins; b += TA_THREADS) e[b] = r2edges[b];
  for (int t = threadIdx.x; t < g.nlm; t += TA_THREADS) norms[t] = lm_norm[t];
  for (int l = threadIdx.x; l <= lmax; l += TA_THREADS) lbase[l] = -1;
  __syncthreads();
  // the table is sorted by l, m from -l to l: (l, -l) starts each l, and
  // the largest l holds every |m| <= lmax
  for (int t = threadIdx.x; t < g.nlm; t += TA_THREADS) {
    if (lm_m[t] == -lm_l[t]) lbase[lm_l[t]] = t;
    if (lm_l[t] == lmax && lm_m[t] >= 0) wmm[lm_m[t]] = lm_wmm[t];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t wbytes = warp_bytes(g.nbins, g.nlm);
  char* mine = wbase + (size_t)warp * wbytes;
  WarpMem wm;
  wm.qx = (double*)mine;
  wm.qy = wm.qx + QCAP;
  wm.qz = wm.qy + QCAP;
  wm.qw = wm.qz + QCAP;
  wm.ys = wm.qw + QCAP;
  wm.acc = wm.ys + QBATCH * g.nlm;
  wm.qb = (int*)(wm.acc + per);
  const int nwarps = gridDim.x * TA_WARPS;
  const int nc1 = g.ncell[1];
  const K nc2 = (K)g.ncell[2];
  for (int q = blockIdx.x * TA_WARPS + warp; q < m; q += nwarps) {
    for (int t = lane; t < per; t += 32) wm.acc[t] = 0.0;
    __syncwarp();
    if (live[q]) {
      const size_t q3 = (size_t)3 * q;
      const double px = p[q3], py = p[q3 + 1], pz = p[q3 + 2];
      const Cells ca = axis_cells(ci[q3], g.ncell[0], g.dlo[0], g.dhi[0],
                                  g.periodic);
      const Cells cb = axis_cells(ci[q3 + 1], g.ncell[1], g.dlo[1],
                                  g.dhi[1], g.periodic);
      const Runs rc = axis_runs(ci[q3 + 2], g.ncell[2], g.dlo[2], g.dhi[2],
                                g.periodic);
      int qn = 0;
      for (int t = 0; t < 9; ++t) {
        const int ka = t / 3, kb = t % 3;
        if (ka >= ca.m || kb >= cb.m) continue;
        const int col = ca.v[ka] * nc1 + cb.v[kb];
        const K base = (K)col * nc2;
        const int end = cols[col + 1];
        int lo = lower_bound<K>(flat, cols[col], end, base + (K)rc.lo0);
        int hi = lower_bound<K>(flat, lo, end, base + (K)rc.hi0 + 1);
        moments_run(g, e, pos, w, lo, hi, px, py, pz, lmax, lbase, norms,
                    wmm, wm, qn);
        if (rc.m == 2) {
          lo = lower_bound<K>(flat, hi, end, base + (K)rc.lo1);
          hi = lower_bound<K>(flat, lo, end, base + (K)rc.hi1 + 1);
          moments_run(g, e, pos, w, lo, hi, px, py, pz, lmax, lbase, norms,
                      wmm, wm, qn);
        }
      }
      if (qn > 0) drain(g, lmax, lbase, norms, wmm, wm, qn);
    }
    double* o = out + (size_t)q * per;
    for (int t = lane; t < per; t += 32) o[t] = wm.acc[t];
    __syncwarp();
  }
}

template <typename K>
static int launch(const double* pos, const double* w, const void* flat,
                  const int* cols, const double* p, const unsigned char* live,
                  const int* ci, int m, const double* r2edges,
                  const int* lm_l, const int* lm_m, const double* lm_norm,
                  const double* lm_wmm, double* out, const TaGeo& g,
                  cudaStream_t s) {
  const size_t smem = smem_bytes(g.nbins, g.nlm, g.lmax);
  cudaError_t err = cudaFuncSetAttribute(
      threept_alm_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = ((long long)m + TA_WARPS - 1) / TA_WARPS;
  const long long cap = (long long)sms * TA_CTAS_PER_SM;
  const int blocks = (int)(need < cap ? need : cap);
  threept_alm_kernel<K><<<blocks, TA_THREADS, smem, s>>>(
      pos, w, (const K*)flat, cols, p, live, ci, m, r2edges, lm_l, lm_m,
      lm_norm, lm_wmm, out, g);
  return (int)cudaGetLastError();
}

extern "C" int nbk_threept_alm(
    const double* pos, const double* w, const void* flat, const int* cols,
    long long n2, int key_bytes, const double* p, const unsigned char* live,
    const int* ci, long long m, const double* r2edges, int nbins,
    const int* lm_l, const int* lm_m, const double* lm_norm,
    const double* lm_wmm, int nlm, int lmax, int periodic, const int* dlo,
    const int* dhi, const int* ncell, const double* box, double* out,
    const int* items, int max_items, const short* tab, int tab_len,
    int tab_shift, long long tab_base, int tab_steps, void* stream) {
  // the kernel's interface: the item list and the bin table are not used
  // here
  (void)items, (void)max_items, (void)tab, (void)tab_len, (void)tab_shift;
  (void)tab_base, (void)tab_steps;
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 0) return 0;
  if (m >= (1LL << 31) || n2 >= (1LL << 31) || nbins < 1 || nlm < 1 ||
      lmax < 0)
    return (int)cudaErrorInvalidValue;
  TaGeo g;
  for (int k = 0; k < 3; ++k) {
    if (dlo[k] < -1 || dlo[k] > 0 || dhi[k] < 0 || dhi[k] > 1 ||
        ncell[k] < 1)
      return (int)cudaErrorInvalidValue;
    g.dlo[k] = dlo[k];
    g.dhi[k] = dhi[k];
    g.ncell[k] = ncell[k];
    g.box[k] = box[k];
  }
  g.periodic = periodic;
  g.nbins = nbins;
  g.nlm = nlm;
  g.lmax = lmax;
  const int mm = (int)m;
  if (key_bytes == 4)
    return launch<int>(pos, w, flat, cols, p, live, ci, mm, r2edges, lm_l,
                       lm_m, lm_norm, lm_wmm, out, g, s);
  if (key_bytes == 8)
    return launch<long long>(pos, w, flat, cols, p, live, ci, mm, r2edges,
                             lm_l, lm_m, lm_norm, lm_wmm, out, g, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
