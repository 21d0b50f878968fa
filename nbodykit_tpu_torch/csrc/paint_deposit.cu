// Tile deposit of the mxu paint, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nbodykit_tpu/ops/paint_pallas.py
// _deposit_kernel. For every x-stripe t, y-tile ty and padded slot of the
// bucket payload (x, y, z, mass), it adds the slot's s^3 window terms to
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
// Design: the TPU builds one-hot matrices because it has a matrix unit and
// no scatter. Here one block per (stripe, y-tile, z-range) keeps its
// (M, zc) tile in shared memory, walks the bucket's K slots (one thread per
// slot), adds each term with a shared-memory atomic and writes the tile out
// once, coalesced along z. z is split into ranges so that a tile fits the
// shared memory the wrapper budgets (ops/paint_cuda.py z_range).
//
// Bound: bytes (the payload read once, the blocks written once). Atomics
// make the summation order vary from run to run.
//
// Built by nbodykit_tpu_torch/_build.py with -fmad=false, so the window
// weights round as the plain version's separate operations do; the C entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>

__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
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

template <int S, typename P, typename A>
__global__ void deposit_kernel(const P* __restrict__ xs,
                               const P* __restrict__ ys,
                               const P* __restrict__ zs,
                               const A* __restrict__ ms, A* __restrict__ out,
                               int nty, int K, int rb, int cb, int n0l,
                               int p0, int N1, int N2, int origin, int zc,
                               int nzr) {
  extern __shared__ __align__(16) unsigned char smem[];
  A* tile = reinterpret_cast<A*>(smem);
  const int rbh = rb + S - 1, cbh = cb + S - 1, M = rbh * cbh;
  long long b = blockIdx.x;
  const int zr = (int)(b % nzr);
  b /= nzr;
  const int ty = (int)(b % nty);
  const int t = (int)(b / nty);
  const int z0 = zr * zc;
  const int zw = min(zc, N2 - z0);

  for (int i = threadIdx.x; i < M * zw; i += blockDim.x) tile[i] = A(0);
  __syncthreads();

  const long long slot0 = ((long long)t * nty + ty) * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const A m = ms[slot0 + k];
    if (m == A(0)) continue;
    const P x = xs[slot0 + k], y = ys[slot0 + k], z = zs[slot0 + k];
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
    int zl[S];
    A wz[S];
#pragma unroll
    for (int c = 0; c < S; ++c) {
      zl[c] = pmod(b2 + c, N2) - z0;
      wz[c] = (A)w2[c];
    }
#pragma unroll
    for (int a = 0; a < S; ++a) {
#pragma unroll
      for (int bb = 0; bb < S; ++bb) {
        const int col = (rloc + a) * cbh + (yloc + bb);
        if (col < 0 || col >= M) continue;
        const A w = (A)(w0[a] * w1[bb]) * m;
        A* row = tile + col * zw;
#pragma unroll
        for (int c = 0; c < S; ++c)
          if (zl[c] >= 0 && zl[c] < zw) atomicAdd(row + zl[c], w * wz[c]);
      }
    }
  }
  __syncthreads();

  A* o = out + ((long long)t * nty + ty) * M * N2 + z0;
  for (int i = threadIdx.x; i < M * zw; i += blockDim.x) {
    const int col = i / zw;
    o[(long long)col * N2 + (i - col * zw)] = tile[i];
  }
}

template <int S, typename P, typename A>
static int launch(const void* x, const void* y, const void* z, const void* m,
                  void* out, int T, int nty, int K, int rb, int cb, int n0l,
                  int p0, int N1, int N2, int origin, int zc,
                  cudaStream_t stream) {
  const int M = (rb + S - 1) * (cb + S - 1);
  const size_t smem = (size_t)M * zc * sizeof(A);
  auto kern = deposit_kernel<S, P, A>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nzr = (N2 + zc - 1) / zc;
  const long long nblocks = (long long)T * nty * nzr;
  kern<<<(unsigned)nblocks, 256, smem, stream>>>(
      (const P*)x, (const P*)y, (const P*)z, (const A*)m, (A*)out, nty, K,
      rb, cb, n0l, p0, N1, N2, origin, zc, nzr);
  return (int)cudaGetLastError();
}

template <int S>
static int launch_types(int pos_f64, int acc_f64, const void* x,
                        const void* y, const void* z, const void* m,
                        void* out, int T, int nty, int K, int rb, int cb,
                        int n0l, int p0, int N1, int N2, int origin, int zc,
                        cudaStream_t s) {
  if (pos_f64 && acc_f64)
    return launch<S, double, double>(x, y, z, m, out, T, nty, K, rb, cb,
                                     n0l, p0, N1, N2, origin, zc, s);
  if (pos_f64)
    return launch<S, double, float>(x, y, z, m, out, T, nty, K, rb, cb, n0l,
                                    p0, N1, N2, origin, zc, s);
  if (acc_f64)
    return launch<S, float, double>(x, y, z, m, out, T, nty, K, rb, cb, n0l,
                                    p0, N1, N2, origin, zc, s);
  return launch<S, float, float>(x, y, z, m, out, T, nty, K, rb, cb, n0l,
                                 p0, N1, N2, origin, zc, s);
}

extern "C" int nbk_deposit(const void* x, const void* y, const void* z,
                           const void* m, void* out, int pos_f64,
                           int acc_f64, int s, int T, int nty, int K, int rb,
                           int cb, int n0l, int p0, int N1, int N2,
                           int origin, int zc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (s) {
    case 1:
      return launch_types<1>(pos_f64, acc_f64, x, y, z, m, out, T, nty, K,
                             rb, cb, n0l, p0, N1, N2, origin, zc, st);
    case 2:
      return launch_types<2>(pos_f64, acc_f64, x, y, z, m, out, T, nty, K,
                             rb, cb, n0l, p0, N1, N2, origin, zc, st);
    case 3:
      return launch_types<3>(pos_f64, acc_f64, x, y, z, m, out, T, nty, K,
                             rb, cb, n0l, p0, N1, N2, origin, zc, st);
    case 4:
      return launch_types<4>(pos_f64, acc_f64, x, y, z, m, out, T, nty, K,
                             rb, cb, n0l, p0, N1, N2, origin, zc, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
