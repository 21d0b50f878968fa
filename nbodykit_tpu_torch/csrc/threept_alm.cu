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
// each pole (25 at poles 0-4: ~150 f64 operations with the products and
// sums, threept_cuda.ylm_ops), every candidate ~10. The first design
// (csrc/variants/threept_alm_first_design.cu) lost most of its time in
// the drain (lanes 0-24 each a chain of 32 shared read-modify-writes a
// batch, 7 lanes idle), then in the candidate pass (a binary search over
// the edges and 18 searches in global memory a query) and the f64
// divisions of the recurrence and the unit vector. This design is bound
// by latency, as paircount.cu is: the candidate pass and queue, the
// tensor-core drain and the harmonics each take a share (kernel_variants.py
// probes). Design:
//  - A CTA takes an item: up to TA_ITEM queries of one grid cell (the
//    wrapper's list, ops/paircount_cuda.query_items), a warp a query at a
//    time. The cell's 9 columns are searched once an item
//    (grid_columns.cuh column_runs, as in paircount.cu); the 32 lanes test
//    32 consecutive slots of a run at once, the next 32 loaded while these
//    are binned, the warps of the CTA reading the same runs through L1.
//  - The bin as in paircount.cu: one compare against each end of the
//    edges, then the wrapper's bucket table and one compare (a walk where
//    the table is coarser; grid_columns.cuh table_digitize), np.digitize
//    bit for bit.
//  - The in-bin candidates (~1 in 7) are queued in the warp's shared
//    memory (unit vector, weight, bin) in candidate order and taken 32 at
//    a time: lane t evaluates every Y_lm of pair t in one pass (the
//    recurrence in l for each |m|, the powers of x + iy once), times the
//    weight, into the batch's rows.
//  - The moments in registers, added by the FP64 tensor cores: a drained
//    batch is a product, moments[lm][bin] += Y^T (one-hot of the pairs'
//    bins), 4 pairs a step of mma m8n8k4 (4 tiles of 8 lm, 2 of 8 bins:
//    TA_NB doubles a lane). The one-hot factors are exact, so each moment
//    is a sum of the same products in another order. No shared
//    read-modify-write, no branch on a bin (a switch on each pair's bin
//    into register rows, a select, and a batch sorted by bin were all
//    measured slower). The moments go to the output once a query,
//    coalesced through the batch buffer. The register path is compiled
//    for each lmax up to TA_LMAX (at most 25 harmonics), its recurrences
//    unrolled; past TA_LMAX or 16 bins the moments stay in shared memory
//    (a lane a row), as in the first design, at a run-time lmax.
//  - Fewer divisions: the recurrence multiplies by 1 / (l - m) from a
//    table (exact for 2 and 4, within an ulp for 3) and the unit vector by
//    one 1 / |d|; single moments move by about an ulp, far inside the
//    1e-12 of the largest that the checks allow.
//
// Float arithmetic: -fmad=false (_build.py), so no product and sum fuse
// (the tensor cores' fused adds multiply by exactly 0 or 1); the plain
// version (ops/threept_cuda.py) sums in another order (its fold goes
// offset by offset and its einsum sums a block of slots) and divides, so
// the moments agree to the f64 rounding of those sums.
//
// Built by nbodykit_tpu_torch/_build.py into a shared library with a plain
// C interface; nbk_threept_alm returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_columns.cuh"

#define TA_THREADS 128
#define TA_WARPS (TA_THREADS / 32)
// queries an item (of one grid cell)
#define TA_ITEM 16
// the register moments of a lane: 32 harmonics x 16 bins over 32 lanes
#define TA_NB 16
// the largest ell of the register moments ((TA_LMAX + 1)^2 <= 32 harmonics)
#define TA_LMAX 4
#define TA_TAB_MAX 1024

struct TaGeo {
  int dlo[3], dhi[3];
  int ncell[3];
  double box[3];
  int periodic;
  int nbins, nlm, lmax;
  BinTable tab;
};

// The per-warp shared memory: a queue of in-bin pairs (QCAP entries), the
// weighted harmonics of QBATCH of them, and (shared-memory moments only)
// the nlm x nbins moments of the query.
#define QCAP 64
#define QBATCH 32

struct WarpMem {
  double* qx;   // QCAP unit vectors, weights and bins of queued pairs
  double* qy;
  double* qz;
  double* qw;
  int* qb;
  double* ys;   // QBATCH x nlm weighted harmonics of a batch
  double* acc;  // nlm x nbins moments (shared-memory moments only)
};

// Every requested Y_lm of the unit vector (x, y, z), times w, into
// ys[0..nlm), as get_real_Ylm computes each: for each |m| the recurrence
// in l from W_mm (W_{m+1,m} = (z (2m+1)) W_mm, then (((2l-1) z) W -
// (l+m-1) W_prev) * (1 / (l-m))), and (x + iy)^|m| by repeated products;
// Y = (norm * W) * Re or Im of it (* 1.0 for m = 0). lbase[l] is the
// index of (l, -l), -1 for an l not requested; wmm[m] = (-1)^m (2m-1)!!;
// rcp[k] = 1 / k. LMAX >= 0 (the register path): lmax is LMAX and the
// loops unroll, so the recurrences of the |m| interleave; else (the
// shared-memory path) lmax is lmax_rt.
template <int LMAX>
__device__ __forceinline__ void all_ylm(int lmax_rt,
                                        const int* __restrict__ lbase,
                                        const double* __restrict__ norms,
                                        const double* __restrict__ wmm,
                                        const double* __restrict__ rcp,
                                        double x, double y, double z,
                                        double w, double* __restrict__ ys) {
  const int lmax = LMAX >= 0 ? LMAX : lmax_rt;
  double re = 1.0, im = 0.0;
#pragma unroll
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
#pragma unroll
    for (int l = m; l <= lmax; ++l) {
      if (l == m + 1) {
        Wp = W;
        W = z * (double)(2 * m + 1) * wm;
      } else if (l > m + 1) {
        const double Wn = ((double)(2 * l - 1) * z * W -
                           (double)(l + m - 1) * Wp) * rcp[l - m];
        Wp = W;
        W = Wn;
      }
      const int b = lbase[l];
      if (b < 0) continue;
      if (m == 0) {
        ys[b + l] = norms[b + l] * W * 1.0 * w;
      } else {
        ys[b + l + m] = norms[b + l + m] * W * re * w;
        ys[b + l - m] = norms[b + l - m] * W * im * w;
      }
    }
  }
}

// The shared tables of a CTA.
struct Tables {
  const double* e;
  const int4* tab;
  const int* lbase;
  const double* norms;
  const double* wmm;
  const double* rcp;
};

// One FP64 tensor-core step, D = A B + C, m8n8k4: lane l holds A[l / 4]
// [l % 4] (a), B[l % 4][l / 4] (b) and C, D[l / 4][2 (l % 4) + {0, 1}].
__device__ __forceinline__ void mma_f64(double& c0, double& c1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// The first np queued pairs into the moments: lane t evaluates the
// weighted harmonics of pair t. REG: the FP64 tensor cores add the batch
// into the register moments, acc[4 mt + 2 nt + j] holding moment (lm =
// 8 mt + l / 4, bin = 8 nt + 2 (l % 4) + j) of lane l (4 tiles of 8 lm,
// 2 of 8 bins). Else lane t adds rows t, t + 32, ... of each pair to the
// warp's shared moments in queue order.
template <bool REG, int LMAX>
__device__ __forceinline__ void drain(const TaGeo& g, const Tables& tb,
                                      const WarpMem& wm, int np,
                                      double (&acc)[TA_NB]) {
  const int lane = threadIdx.x & 31;
  if (lane < np)
    all_ylm<LMAX>(g.lmax, tb.lbase, tb.norms, tb.wmm, tb.rcp, wm.qx[lane],
                  wm.qy[lane], wm.qz[lane], wm.qw[lane],
                  wm.ys + lane * g.nlm);
  __syncwarp();
  if (REG) {
    // moments[lm][bin] += sum_p Y[p][lm] [bin_p == bin], 4 pairs a step:
    // A (8 x 4) = Y of the step's pairs for 8 lm, B (4 x 8) = their
    // one-hot bins for 8 bins (exact 0 and 1: the products are exact)
    // every step of a full batch, unrolled, so that the loads go first
    // (the pairs past np add exact zeros)
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int k = 0; k < QBATCH; k += 4) {
      const int p = k + tig;
      const int b = p < np ? wm.qb[p] : -1;
      const double b0 = b == gid ? 1.0 : 0.0;
      const double b1 = b == 8 + gid ? 1.0 : 0.0;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int lm = mt * 8 + gid;
        const double a = p < np && lm < g.nlm ? wm.ys[p * g.nlm + lm] : 0.0;
        mma_f64(acc[4 * mt], acc[4 * mt + 1], a, b0);
        mma_f64(acc[4 * mt + 2], acc[4 * mt + 3], a, b1);
      }
    }
  } else {
    for (int p = 0; p < np; ++p) {
      const int b = wm.qb[p];
      const double* y = wm.ys + p * g.nlm;
      for (int t = lane; t < g.nlm; t += 32) wm.acc[t * g.nbins + b] += y[t];
    }
  }
  __syncwarp();
}

// The in-bin candidates of slots [lo, hi) queued, and the queue drained
// QBATCH at a time; qn, the queue's length, is warp-uniform. IMAGE:
// minimum-image the separations.
template <bool REG, bool IMAGE, bool ONE_STEP, int LMAX>
__device__ __forceinline__ void moments_run(
    const TaGeo& g, const Tables& tb, const double* __restrict__ pos,
    const double* __restrict__ w, int lo, int hi, double px, double py,
    double pz, const WarpMem& wm, int& qn, double (&acc)[TA_NB]) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const double efirst = tb.e[0], elast = tb.e[g.nbins];
  // the next step's candidate is loaded while this one is binned
  double nx = 0.0, ny = 0.0, nz = 0.0, nw = 0.0;
  auto load = [&](int j) {
    if (j < hi) {
      const size_t j3 = (size_t)3 * j;
      nx = pos[j3];
      ny = pos[j3 + 1];
      nz = pos[j3 + 2];
      nw = w[j];
    }
  };
  load(lo + lane);
  for (int base = lo; base < hi; base += 32) {
    const int j = base + lane;
    const double sx = nx, sy = ny, sz = nz, sw = nw;
    load(j + 32);
    bool inb = false;
    double ux = 0.0, uy = 0.0, uz = 0.0, wj = 0.0;
    int bin = 0;
    if (j < hi) {
      double dx = sx - px, dy = sy - py, dz = sz - pz;
      if (IMAGE) {
        dx = min_image(dx, g.box[0]);
        dy = min_image(dy, g.box[1]);
        dz = min_image(dz, g.box[2]);
      }
      const double r2 = (dx * dx + dy * dy) + dz * dz;
      if (r2 < elast && r2 >= efirst && r2 > 1e-20) {
        inb = true;
        const double inv = 1.0 / sqrt(r2);
        ux = dx * inv;
        uy = dy * inv;
        uz = dz * inv;
        wj = sw;
        bin = table_digitize<ONE_STEP>(tb.e, tb.tab, g.tab, r2) - 1;
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
      drain<REG, LMAX>(g, tb, wm, QBATCH, acc);
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
// harmonics and (shared-memory moments only) the moments.
__host__ __device__ static size_t warp_bytes(int nbins, int nlm, int reg) {
  return (size_t)QCAP * 36 + (size_t)QBATCH * nlm * 8 +
         (reg ? (size_t)0 : (size_t)nlm * nbins * 8);
}

// Shared memory of one CTA: the bin table (16 bytes an entry), the edges,
// the lm table (norms; lbase, wmm and 1 / k for l, m, k <= lmax), the
// runs, then the warps' memory.
static size_t smem_bytes(int nbins, int nlm, int lmax, int tab_len, int reg) {
  const size_t head = (size_t)tab_len * 16 + (size_t)(nbins + 1) * 8 +
                      (size_t)nlm * 8 + (size_t)(lmax + 1) * 24 +
                      (size_t)3 * GC_RUNS * 4;
  return (head + 15) / 16 * 16 +
         (size_t)TA_WARPS * warp_bytes(nbins, nlm, reg);
}

template <typename K, bool REG, bool ONE_STEP, int LMAX>
__global__ void __launch_bounds__(TA_THREADS)
threept_alm_kernel(const double* __restrict__ pos,
                   const double* __restrict__ w, const K* __restrict__ flat,
                   const int* __restrict__ cols,
                   const double* __restrict__ p,
                   const unsigned char* __restrict__ live,
                   const int* __restrict__ ci, int m,
                   const int* __restrict__ items, int max_items,
                   const double* __restrict__ r2edges,
                   const int4* __restrict__ tab_g,
                   const int* __restrict__ lm_l, const int* __restrict__ lm_m,
                   const double* __restrict__ lm_norm,
                   const double* __restrict__ lm_wmm,
                   double* __restrict__ out, const TaGeo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int per = g.nlm * g.nbins;
  const int lmax = g.lmax;
  int4* tab = (int4*)smem_raw;                   // g.tab.len
  double* e = (double*)(tab + g.tab.len);        // nbins + 1
  double* norms = e + (g.nbins + 1);             // nlm
  double* wmm = norms + g.nlm;                   // lmax + 1
  double* rcp = wmm + lmax + 1;                  // lmax + 1
  int* lbase = (int*)(rcp + lmax + 1);           // lmax + 1 (8 B each)
  int* run_lo = lbase + 2 * (lmax + 1);
  int* run_hi = run_lo + GC_RUNS;
  int* run_im = run_hi + GC_RUNS;
  const size_t head = (size_t)g.tab.len * 16 + (size_t)(g.nbins + 1) * 8 +
                      (size_t)g.nlm * 8 + (size_t)(lmax + 1) * 24 +
                      (size_t)3 * GC_RUNS * 4;
  char* wbase = (char*)smem_raw + (head + 15) / 16 * 16;
  for (int b = threadIdx.x; b <= g.nbins; b += TA_THREADS) e[b] = r2edges[b];
  for (int t = threadIdx.x; t < g.nlm; t += TA_THREADS) norms[t] = lm_norm[t];
  for (int k = threadIdx.x; k < g.tab.len; k += TA_THREADS) tab[k] = tab_g[k];
  for (int l = threadIdx.x; l <= lmax; l += TA_THREADS) {
    lbase[l] = -1;
    rcp[l] = l > 0 ? 1.0 / (double)l : 0.0;
  }
  __syncthreads();
  // the table is sorted by l, m from -l to l: (l, -l) starts each l, and
  // the largest l holds every |m| <= lmax
  for (int t = threadIdx.x; t < g.nlm; t += TA_THREADS) {
    if (lm_m[t] == -lm_l[t]) lbase[lm_l[t]] = t;
    if (lm_l[t] == lmax && lm_m[t] >= 0) wmm[lm_m[t]] = lm_wmm[t];
  }
  Tables tb;
  tb.e = e;
  tb.tab = tab;
  tb.lbase = lbase;
  tb.norms = norms;
  tb.wmm = wmm;
  tb.rcp = rcp;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t wbytes = warp_bytes(g.nbins, g.nlm, REG);
  char* mine = wbase + (size_t)warp * wbytes;
  WarpMem wm;
  wm.qx = (double*)mine;
  wm.qy = wm.qx + QCAP;
  wm.qz = wm.qy + QCAP;
  wm.qw = wm.qz + QCAP;
  wm.ys = wm.qw + QCAP;
  wm.acc = wm.ys + QBATCH * g.nlm;
  wm.qb = (int*)(wm.acc + (REG ? 0 : per));
  double acc[TA_NB];

  for (int item = blockIdx.x; item < max_items; item += gridDim.x) {
    const int q0 = items[item];
    if (q0 >= m) break;  // items past the last hold m
    const int q1 = items[item + 1];
    __syncthreads();  // the previous item's runs are read
    if (tid < 9) {
      const size_t c3 = (size_t)3 * q0;
      column_runs<K>(tid, flat, cols, ci[c3], ci[c3 + 1], ci[c3 + 2], g.dlo,
                     g.dhi, g.ncell, g.periodic, run_lo, run_hi, run_im);
    }
    __syncthreads();
    for (int q = q0 + warp; q < q1; q += TA_WARPS) {
#pragma unroll
      for (int b = 0; b < TA_NB; ++b) acc[b] = 0.0;
      if (!REG) {
        for (int t = lane; t < per; t += 32) wm.acc[t] = 0.0;
        __syncwarp();
      }
      if (live[q]) {
        const size_t q3 = (size_t)3 * q;
        const double px = p[q3], py = p[q3 + 1], pz = p[q3 + 2];
        int qn = 0;
        for (int r = 0; r < GC_RUNS; ++r) {
          if (run_lo[r] >= run_hi[r]) continue;
          if (run_im[r])
            moments_run<REG, true, ONE_STEP, LMAX>(g, tb, pos, w, run_lo[r],
                                             run_hi[r], px, py, pz, wm, qn,
                                             acc);
          else
            moments_run<REG, false, ONE_STEP, LMAX>(g, tb, pos, w,
                                                    run_lo[r],
                                              run_hi[r], px, py, pz, wm, qn,
                                              acc);
        }
        if (qn > 0) drain<REG, LMAX>(g, tb, wm, qn, acc);
      }
      double* o = out + (size_t)q * per;
      if (REG) {
        // row lane of the moments through the batch buffer, then out
        // coalesced
        // the moments through the batch buffer, then out coalesced
        // (constant indices keep acc in registers)
#pragma unroll
        for (int i = 0; i < TA_NB; ++i) {
          const int lm = 8 * (i / 4) + (lane >> 2);
          const int b = 8 * ((i / 2) % 2) + 2 * (lane & 3) + i % 2;
          if (lm < g.nlm && b < g.nbins) wm.ys[lm * g.nbins + b] = acc[i];
        }
        __syncwarp();
        for (int t = lane; t < per; t += 32) o[t] = wm.ys[t];
      } else {
        for (int t = lane; t < per; t += 32) o[t] = wm.acc[t];
      }
      __syncwarp();
    }
  }
}

template <typename K, bool REG, bool ONE_STEP, int LMAX>
static int launch(const double* pos, const double* w, const void* flat,
                  const int* cols, const double* p, const unsigned char* live,
                  const int* ci, int m, const int* items, int max_items,
                  const double* r2edges, const int4* tab, const int* lm_l,
                  const int* lm_m, const double* lm_norm,
                  const double* lm_wmm, double* out, const TaGeo& g,
                  cudaStream_t s) {
  const size_t smem = smem_bytes(g.nbins, g.nlm, g.lmax, g.tab.len, REG);
  auto kernel = threept_alm_kernel<K, REG, ONE_STEP, LMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      TA_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(max_items < cap ? max_items : cap);
  if (blocks < 1) return 0;
  kernel<<<blocks, TA_THREADS, smem, s>>>(
      pos, w, (const K*)flat, cols, p, live, ci, m, items, max_items, r2edges,
      tab, lm_l, lm_m, lm_norm, lm_wmm, out, g);
  return (int)cudaGetLastError();
}

// The moments in registers where a lane's row fits them and the register
// path is compiled for lmax.
static int moments_in_registers(int nbins, int lmax) {
  return nbins <= TA_NB && lmax <= TA_LMAX;
}

template <typename K, bool ONE_STEP>
static int launch_any(const double* pos, const double* w, const void* flat,
                      const int* cols, const double* p,
                      const unsigned char* live, const int* ci, int m,
                      const int* items, int max_items, const double* r2edges,
                      const int4* tab, const int* lm_l, const int* lm_m,
                      const double* lm_norm, const double* lm_wmm,
                      double* out, const TaGeo& g, cudaStream_t s) {
#define TA_LAUNCH(REG, LMAX)                                                \
  launch<K, REG, ONE_STEP, LMAX>(pos, w, flat, cols, p, live, ci, m, items, \
                                 max_items, r2edges, tab, lm_l, lm_m,       \
                                 lm_norm, lm_wmm, out, g, s)
  if (moments_in_registers(g.nbins, g.lmax)) {
    static_assert(TA_LMAX == 4, "a case for each lmax <= TA_LMAX");
    switch (g.lmax) {
      case 0: return TA_LAUNCH(true, 0);
      case 1: return TA_LAUNCH(true, 1);
      case 2: return TA_LAUNCH(true, 2);
      case 3: return TA_LAUNCH(true, 3);
      default: return TA_LAUNCH(true, 4);
    }
  }
  return TA_LAUNCH(false, -1);
#undef TA_LAUNCH
}

template <typename K>
static int launch_steps(int one_step, const double* pos, const double* w,
                        const void* flat, const int* cols, const double* p,
                        const unsigned char* live, const int* ci, int m,
                        const int* items, int max_items,
                        const double* r2edges, const int4* tab,
                        const int* lm_l, const int* lm_m,
                        const double* lm_norm, const double* lm_wmm,
                        double* out, const TaGeo& g, cudaStream_t s) {
  if (one_step)
    return launch_any<K, true>(pos, w, flat, cols, p, live, ci, m, items,
                               max_items, r2edges, tab, lm_l, lm_m, lm_norm,
                               lm_wmm, out, g, s);
  return launch_any<K, false>(pos, w, flat, cols, p, live, ci, m, items,
                              max_items, r2edges, tab, lm_l, lm_m, lm_norm,
                              lm_wmm, out, g, s);
}

extern "C" int nbk_threept_alm(
    const double* pos, const double* w, const void* flat, const int* cols,
    long long n2, int key_bytes, const double* p, const unsigned char* live,
    const int* ci, long long m, const double* r2edges, int nbins,
    const int* lm_l, const int* lm_m, const double* lm_norm,
    const double* lm_wmm, int nlm, int lmax, int periodic, const int* dlo,
    const int* dhi, const int* ncell, const double* box, double* out,
    const int* items, int max_items, const void* tab, int tab_len,
    int tab_shift, long long tab_base, int tab_steps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 0) return 0;
  if (m >= (1LL << 31) || n2 >= (1LL << 31) || nbins < 1 || nlm < 1 ||
      lmax < 0 || max_items < 1 || tab_len < 2 || tab_len > TA_TAB_MAX + 1 ||
      tab_shift < 0 || tab_shift > 63 || tab_steps < 0)
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
  g.tab.base = tab_base;
  g.tab.shift = tab_shift;
  g.tab.len = tab_len;
  g.tab.nedges = nbins + 1;
  const int mm = (int)m;
  const int one = tab_steps <= 1;
  if (key_bytes == 4)
    return launch_steps<int>(one, pos, w, flat, cols, p, live, ci, mm, items,
                             max_items, r2edges, (const int4*)tab, lm_l,
                             lm_m, lm_norm, lm_wmm, out, g, s);
  if (key_bytes == 8)
    return launch_steps<long long>(one, pos, w, flat, cols, p, live, ci, mm,
                                   items, max_items, r2edges,
                                   (const int4*)tab, lm_l, lm_m, lm_norm,
                                   lm_wmm, out, g, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
