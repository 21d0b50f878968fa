// Tile deposit of the mxu paint, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nbodykit_tpu/ops/paint_pallas.py
// _deposit_kernel. For every bucket (x-stripe t, y-tile ty) and padded slot
// of the bucket payload (x, y, z, mass), it adds the slot's s^3 window
// terms to
//
//     out[t][ty][(rloc + a) * cbh + (yloc + b)][(b2 + c) mod N2]
//         += (A)(w0[a] * w1[b]) * mass * (A)w2[c]
//
// with M = (rb+s-1)(cb+s-1) tile columns. Columns outside [0, M) and slots
// of mass 0 contribute nothing, as with the TPU's one-hot product. The
// index arithmetic (window base, the periodic mod, rloc / yloc of slab
// blocks with origin != 0) is that of the TPU kernel and of the plain
// version in ops/paint_cuda.py; positions keep their own type P (f32 or
// f64) and only the weights are cast to the accumulation type A.
//
// What bounds it on the H100: bytes. The payload is read once (masses of
// every slot, positions of occupied slots) and the (M, N2) blocks are
// written once; two thirds of the bytes are the blocks, so the write-out
// has to stream while the deposit runs. Beside the bytes, each occupied
// slot costs s^3 shared-memory float atomics, which Hopper runs as
// compare-and-swap loops.
//
// Design:
//  - One CTA, or one thread-block cluster of nz CTAs, owns a whole bucket
//    at a time, so every slot is read once. A CTA keeps (M, zc) cells of
//    the bucket's tile in shared memory; with nz > 1 CTA r owns z cells
//    [r*zc, (r+1)*zc) and the cluster's CTAs split the slots, adding each
//    term with an atomic into the tile of the CTA that owns its z cell
//    (distributed shared memory). ops/paint_cuda.py deposit_plan picks nz
//    and zc; the single-CTA kernel (CL = false) adds through a pointer the
//    compiler knows is shared, without the generic address dispatch.
//  - The CTAs are persistent (as many clusters as fit on the card) and
//    walk the buckets. A finished tile leaves by asynchronous bulk copies
//    (cp.async.bulk, shared -> global) in 16-byte aligned pieces; rows or
//    edges that are not 16-byte aligned in both memories are stored by
//    plain stores. While the copies drain, each thread loads its slots of
//    the next bucket into registers (masses first, then the positions of
//    the occupied slots), so the deposit that follows waits on no load.
//  - Window indices wrap with one add or subtract where they can
//    (pmod), not with an integer division.
//
// Atomics make the summation order vary from run to run. Built by
// nbodykit_tpu_torch/_build.py with -fmad=false, so the window weights
// round as the plain version's separate operations do; the C entry point
// returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define DEP_THREADS 512
#define DEP_WARPS (DEP_THREADS / 32)
#define STAGE_WORDS 56    // registers per thread for staged slots
#define SLOTS_PER_STEP 4  // slots per thread per step beyond those
#define PIECE_BYTES 8192  // at most this many bytes per bulk copy

// a mod n in [0, n), n > 0; one add or subtract for a in [-n, 2n)
__device__ __forceinline__ int pmod(int a, int n) {
  int r = a;
  if (r < 0) r += n;
  if (r >= n) r -= n;
  if ((unsigned)r < (unsigned)n) return r;
  r = a % n;
  return r < 0 ? r + n : r;
}

template <int S, typename P>
__device__ __forceinline__ int window_base(P x) {
  if (S % 2 == 0) return (int)floor(x) - (S / 2 - 1);
  return (int)floor(x + P(0.5)) - (S - 1) / 2;
}

template <int S, typename P>
__device__ __forceinline__ P bspline(P d) {
  if (S == 1) return P(1);
  if (S == 2) return fmax(P(1) - d, P(0));
  if (S == 3) {
    const P t = fmax(P(1.5) - d, P(0));
    return d <= P(0.5) ? P(0.75) - d * d : P(0.5) * (t * t);
  }
  const P t = fmax(P(2) - d, P(0));
  return d <= P(1) ? (P(4) - P(6) * d * d + P(3) * (d * d * d)) / P(6)
                   : (t * t * t) / P(6);
}

template <int S, typename P>
__device__ __forceinline__ void weights(P x, int base, P* w) {
#pragma unroll
  for (int a = 0; a < S; ++a) w[a] = bspline<S, P>(fabs(x - P(base + a)));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// shared -> global bulk copy; both addresses 16-byte aligned, bytes a
// multiple of 16
__device__ __forceinline__ void bulk_store(void* g, const void* s,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          (unsigned long long)g),
      "r"(smem_u32(s)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until this thread's bulk copies have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy (bulk copy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy n cells from shared s to global g: plain stores for what is not
// 16-byte aligned in both memories, one bulk copy per PIECE_BYTES of the
// aligned body, issued by lane 0. The caller commits the copies.
template <typename A>
__device__ __forceinline__ void write_segment(A* g, const A* s, int n,
                                              int lane) {
  const uintptr_t ga = (uintptr_t)g, sa = (uintptr_t)s;
  if ((ga & 15) != (sa & 15)) {
    for (int i = lane; i < n; i += 32) g[i] = s[i];
    return;
  }
  const int head = min((int)(((16 - (ga & 15)) & 15) / sizeof(A)), n);
  const int body = (int)(((n - head) * sizeof(A)) & ~(size_t)15);
  const int tail0 = head + body / (int)sizeof(A);
  for (int i = lane; i < head; i += 32) g[i] = s[i];
  for (int i = tail0 + lane; i < n; i += 32) g[i] = s[i];
  if (lane == 0) {
    const char* src = (const char*)(s + head);
    char* dst = (char*)(g + head);
    for (int off = 0; off < body; off += PIECE_BYTES)
      bulk_store(dst + off, src + off,
                 (unsigned)min(PIECE_BYTES, body - off));
  }
}

// Copy z cells [zlo, zlo + zw) of rows [0, M) of a bucket's tile from a
// shared buffer of row stride `stride` to the output: warp w takes rows
// w, w + DEP_WARPS, ...; its lane 0 issues their bulk copies and commits
// them as one group (an empty one if every row went by plain stores).
template <typename A>
__device__ __forceinline__ void write_rows(A* gtile, const A* buf, int M,
                                           int N2, int zlo, int zw,
                                           int stride, int warp, int lane) {
  for (int r = warp; r < M; r += DEP_WARPS)
    write_segment<A>(gtile + (long long)r * N2 + zlo, buf + r * stride, zw,
                     lane);
  if (lane == 0) bulk_commit();
}

// One occupied slot made ready to deposit: its S * S (x, y) weights times
// the mass and its S z weights, in the accumulation type, the tile column
// of its (a, b) = (0, 0) term and its first z cell.
template <int S, typename A>
struct Term {
  A wxy[S * S];
  A wz[S];
  int col0, z0;
};

template <int S, typename P, typename A>
__device__ __forceinline__ void make_term(P x, P y, P z, A m, int t, int ty,
                                          int rb, int cb, int n0l, int p0,
                                          int N1, int N2, int origin,
                                          Term<S, A>& tm) {
  const int cbh = cb + S - 1;
  const int b0 = window_base<S, P>(x);
  const int b1 = window_base<S, P>(y);
  const int b2 = window_base<S, P>(z);
  P w0[S], w1[S], w2[S];
  weights<S, P>(x, b0, w0);
  weights<S, P>(y, b1, w1);
  weights<S, P>(z, b2, w2);
  int r0 = pmod(b0 - origin, p0);
  if (r0 >= n0l) r0 -= p0;
  const int rloc = min(max(r0 + rb - t * rb, 0), rb - 1);
  const int yloc = pmod(b1, N1) - ty * cb;
  tm.col0 = rloc * cbh + yloc;
  tm.z0 = pmod(b2, N2);
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int bb = 0; bb < S; ++bb)
      tm.wxy[a * S + bb] = (A)(w0[a] * w1[bb]) * m;
#pragma unroll
  for (int c = 0; c < S; ++c) tm.wz[c] = (A)w2[c];
}

// Add a slot's terms to the tile: tile column col0 + a * cbh + b (skipped
// outside [0, M)), z cell (z0 + c) mod N2. Without a cluster the tile is
// the CTA's (M, N2) shared array (zc == N2); with one, z cell z lives in
// CTA z / zc of the cluster at (col, z mod zc) of its (M, zc) array.
template <int S, typename A, bool CL>
__device__ __forceinline__ void deposit_term(const Term<S, A>& tm, A* tile,
                                             int M, int cbh, int N2, int zc,
                                             int rank) {
  A* dst[S];
  int zl[S];
#pragma unroll
  for (int c = 0; c < S; ++c) {
    int z = tm.z0 + c;
    if (z >= N2) z -= N2;
    if (CL) {
      const int own = z / zc;
      zl[c] = z - own * zc;
      dst[c] = own == rank ? tile
                           : cg::this_cluster().map_shared_rank(tile, own);
    } else {
      zl[c] = z;
    }
  }
#pragma unroll
  for (int a = 0; a < S; ++a) {
#pragma unroll
    for (int bb = 0; bb < S; ++bb) {
      const int col = tm.col0 + a * cbh + bb;
      if (col < 0 || col >= M) continue;
      const A w = tm.wxy[a * S + bb];
#pragma unroll
      for (int c = 0; c < S; ++c) {
        if (CL)
          atomicAdd(dst[c] + col * zc + zl[c], w * tm.wz[c]);
        else
          atomicAdd(tile + col * zc + zl[c], w * tm.wz[c]);
      }
    }
  }
}

// A thread's share of one bucket's payload, held in registers: slots
// first + r * step for r < R, masses loaded first and positions only for
// occupied slots, all issued before any is used.
template <typename P, typename A, int R>
struct Staged {
  A m[R];
  P x[R], y[R], z[R];
};

// slots a thread stages: as many as fit STAGE_WORDS registers, at least 1
template <typename P, typename A>
__host__ __device__ constexpr int stage_slots() {
  return STAGE_WORDS >= (int)(sizeof(A) + 3 * sizeof(P)) / 4
             ? STAGE_WORDS / ((int)(sizeof(A) + 3 * sizeof(P)) / 4)
             : 1;
}

template <typename P, typename A, int R>
__device__ __forceinline__ void stage(const P* __restrict__ xs,
                                      const P* __restrict__ ys,
                                      const P* __restrict__ zs,
                                      const A* __restrict__ ms,
                                      long long slot0, int K, int first,
                                      int step, Staged<P, A, R>& st) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = first + r * step;
    st.m[r] = k < K ? ms[slot0 + k] : A(0);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = slot0 + first + r * step;
    const bool occ = st.m[r] != A(0);
    st.x[r] = occ ? xs[i] : P(0);
    st.y[r] = occ ? ys[i] : P(0);
    st.z[r] = occ ? zs[i] : P(0);
  }
}

// Slots past the R * step staged ones, SLOTS_PER_STEP at a time straight
// from global memory.
template <int S, typename P, typename A, bool CL, int R>
__device__ __forceinline__ void deposit_rest(
    const P* __restrict__ xs, const P* __restrict__ ys,
    const P* __restrict__ zs, const A* __restrict__ ms, long long slot0,
    int K, int first, int step, int t, int ty, int rb, int cb, int n0l,
    int p0, int N1, int N2, int origin, A* tile, int M, int zc, int rank) {
  for (int k0 = first + R * step; k0 < K; k0 += SLOTS_PER_STEP * step) {
    A m[SLOTS_PER_STEP];
    P x[SLOTS_PER_STEP], y[SLOTS_PER_STEP], z[SLOTS_PER_STEP];
#pragma unroll
    for (int g = 0; g < SLOTS_PER_STEP; ++g) {
      const int k = k0 + g * step;
      m[g] = k < K ? ms[slot0 + k] : A(0);
    }
#pragma unroll
    for (int g = 0; g < SLOTS_PER_STEP; ++g) {
      const long long i = slot0 + k0 + g * step;
      const bool occ = m[g] != A(0);
      x[g] = occ ? xs[i] : P(0);
      y[g] = occ ? ys[i] : P(0);
      z[g] = occ ? zs[i] : P(0);
    }
#pragma unroll
    for (int g = 0; g < SLOTS_PER_STEP; ++g) {
      if (m[g] == A(0)) continue;
      Term<S, A> tm;
      make_term<S, P, A>(x[g], y[g], z[g], m[g], t, ty, rb, cb, n0l, p0, N1,
                         N2, origin, tm);
      deposit_term<S, A, CL>(tm, tile, M, cb + S - 1, N2, zc, rank);
    }
  }
}

__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  float4* q = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += DEP_THREADS)
    q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The deposit when a bucket's whole (M, N2) tile fits one CTA. Grid:
// persistent CTAs; CTA q deposits buckets q, q + gridDim.x, ... into the
// tile in its arena_bytes of dynamic shared memory.
template <int S, typename P, typename A>
__global__ void __launch_bounds__(DEP_THREADS, 1)
    deposit_single(const P* __restrict__ xs, const P* __restrict__ ys,
                   const P* __restrict__ zs, const A* __restrict__ ms,
                   A* __restrict__ out, int nbuckets, int nty, int K,
                   int rb, int cb, int n0l, int p0, int N1, int N2,
                   int origin, int zc, int nz, int arena_bytes) {
  constexpr int R = stage_slots<P, A>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cbh = cb + S - 1, M = (rb + S - 1) * cbh;
  A* tile = reinterpret_cast<A*>(smem);

  Staged<P, A, R> st;
  int bucket = (int)blockIdx.x;
  if (bucket < nbuckets)
    stage<P, A, R>(xs, ys, zs, ms, (long long)bucket * K, K, tid,
                   DEP_THREADS, st);
  zero_smem(smem, arena_bytes);
  __syncthreads();
  for (; bucket < nbuckets; bucket += gridDim.x) {
    const int t = bucket / nty, ty = bucket - t * nty;
    A* gtile = out + (long long)bucket * M * N2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (st.m[r] == A(0)) continue;
      Term<S, A> tm;
      make_term<S, P, A>(st.x[r], st.y[r], st.z[r], st.m[r], t, ty, rb, cb,
                         n0l, p0, N1, N2, origin, tm);
      deposit_term<S, A, false>(tm, tile, M, cbh, N2, N2, 0);
    }
    deposit_rest<S, P, A, false, R>(xs, ys, zs, ms, (long long)bucket * K, K,
                                    tid, DEP_THREADS, t, ty, rb, cb, n0l, p0,
                                    N1, N2, origin, tile, M, N2, 0);
    fence_proxy_async();
    __syncthreads();
    write_rows<A>(gtile, tile, M, N2, 0, N2, N2, warp, lane);
    // load the next bucket's slots while the copies drain
    const int next = bucket + gridDim.x;
    if (next < nbuckets)
      stage<P, A, R>(xs, ys, zs, ms, (long long)next * K, K, tid,
                     DEP_THREADS, st);
    if (lane == 0) bulk_wait_read();
    __syncthreads();
    zero_smem(smem, arena_bytes);
    __syncthreads();
  }
}

// The deposit when a bucket's tile needs a cluster of nz CTAs. Grid:
// nclusters clusters of nz CTAs (cluster dimension nz along x); cluster q
// deposits buckets q, q + nclusters, ... A CTA's arena_bytes of dynamic
// shared memory hold its (M, zc) share of the tile.
template <int S, typename P, typename A>
__global__ void __launch_bounds__(DEP_THREADS, 1)
    deposit_cluster(const P* __restrict__ xs, const P* __restrict__ ys,
                    const P* __restrict__ zs, const A* __restrict__ ms,
                    A* __restrict__ out, int nbuckets, int nty, int K,
                    int rb, int cb, int n0l, int p0, int N1, int N2,
                    int origin, int zc, int nz, int arena_bytes) {
  constexpr int R = stage_slots<P, A>();
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cbh = cb + S - 1, M = (rb + S - 1) * cbh;
  const int nclusters = gridDim.x / nz;
  const int z0 = rank * zc;
  const int zw = min(zc, N2 - z0);
  // the cluster's CTAs split each bucket's slots: this thread takes
  // first, first + step, ...
  const int step = nz * DEP_THREADS;
  const int first = rank * DEP_THREADS + tid;
  A* tile = reinterpret_cast<A*>(smem);

  Staged<P, A, R> st;
  int bucket = (int)(blockIdx.x / nz);
  if (bucket < nbuckets)
    stage<P, A, R>(xs, ys, zs, ms, (long long)bucket * K, K, first, step,
                   st);
  zero_smem(smem, arena_bytes);
  cluster.sync();

  for (; bucket < nbuckets; bucket += nclusters) {
    const int t = bucket / nty, ty = bucket - t * nty;
    A* gtile = out + (long long)bucket * M * N2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (st.m[r] == A(0)) continue;
      Term<S, A> tm;
      make_term<S, P, A>(st.x[r], st.y[r], st.z[r], st.m[r], t, ty, rb, cb,
                         n0l, p0, N1, N2, origin, tm);
      deposit_term<S, A, true>(tm, tile, M, cbh, N2, zc, rank);
    }
    deposit_rest<S, P, A, true, R>(xs, ys, zs, ms, (long long)bucket * K, K,
                                   first, step, t, ty, rb, cb, n0l, p0, N1,
                                   N2, origin, tile, M, zc, rank);
    // every term of the bucket is in its owner's tile
    cluster.sync();
    fence_proxy_async();
    __syncthreads();
    write_rows<A>(gtile, tile, M, N2, z0, zw, zc, warp, lane);
    // load the next bucket's slots while the copies drain
    const int next = bucket + nclusters;
    if (next < nbuckets)
      stage<P, A, R>(xs, ys, zs, ms, (long long)next * K, K, first, step,
                     st);
    if (lane == 0) bulk_wait_read();
    __syncthreads();
    zero_smem(smem, arena_bytes);
    // every tile of the cluster is clear before anyone deposits again
    cluster.sync();
  }
}

template <int S, typename P, typename A>
static int launch(const void* x, const void* y, const void* z, const void* m,
                  void* out, int T, int nty, int K, int rb, int cb, int n0l,
                  int p0, int N1, int N2, int origin, int zc, int nz,
                  int smem, cudaStream_t stream) {
  auto kern = nz > 1 ? deposit_cluster<S, P, A> : deposit_single<S, P, A>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (nz > 8) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  const int nbuckets = T * nty;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nz;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nbuckets * nz));
  cfg.blockDim = dim3(DEP_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  e = cudaOccupancyMaxActiveClusters(&resident, (void*)kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const int nclusters = resident < nbuckets ? resident : nbuckets;
  cfg.gridDim = dim3((unsigned)(nclusters * nz));
  e = cudaLaunchKernelEx(&cfg, kern, (const P*)x, (const P*)y, (const P*)z,
                         (const A*)m, (A*)out, nbuckets, nty, K, rb, cb, n0l,
                         p0, N1, N2, origin, zc, nz, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int S>
static int launch_types(int pos_f64, int acc_f64, const void* x,
                        const void* y, const void* z, const void* m,
                        void* out, int T, int nty, int K, int rb, int cb,
                        int n0l, int p0, int N1, int N2, int origin, int zc,
                        int nz, int smem, cudaStream_t s) {
  if (pos_f64 && acc_f64)
    return launch<S, double, double>(x, y, z, m, out, T, nty, K, rb, cb,
                                     n0l, p0, N1, N2, origin, zc, nz, smem,
                                     s);
  if (pos_f64)
    return launch<S, double, float>(x, y, z, m, out, T, nty, K, rb, cb, n0l,
                                    p0, N1, N2, origin, zc, nz, smem, s);
  if (acc_f64)
    return launch<S, float, double>(x, y, z, m, out, T, nty, K, rb, cb, n0l,
                                    p0, N1, N2, origin, zc, nz, smem, s);
  return launch<S, float, float>(x, y, z, m, out, T, nty, K, rb, cb, n0l,
                                 p0, N1, N2, origin, zc, nz, smem, s);
}

// zc, nz, smem: z cells per CTA, CTAs per cluster and dynamic shared
// memory bytes per CTA, from ops/paint_cuda.py deposit_plan.
extern "C" int nbk_deposit(const void* x, const void* y, const void* z,
                           const void* m, void* out, int pos_f64,
                           int acc_f64, int s, int T, int nty, int K, int rb,
                           int cb, int n0l, int p0, int N1, int N2,
                           int origin, int zc, int nz, int smem,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (s) {
    case 1:
      return launch_types<1>(pos_f64, acc_f64, x, y, z, m, out, T, nty, K,
                             rb, cb, n0l, p0, N1, N2, origin, zc, nz, smem,
                             st);
    case 2:
      return launch_types<2>(pos_f64, acc_f64, x, y, z, m, out, T, nty, K,
                             rb, cb, n0l, p0, N1, N2, origin, zc, nz, smem,
                             st);
    case 3:
      return launch_types<3>(pos_f64, acc_f64, x, y, z, m, out, T, nty, K,
                             rb, cb, n0l, p0, N1, N2, origin, zc, nz, smem,
                             st);
    case 4:
      return launch_types<4>(pos_f64, acc_f64, x, y, z, m, out, T, nty, K,
                             rb, cb, n0l, p0, N1, N2, origin, zc, nz, smem,
                             st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
