// Rank pass of the radix counting sort, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nbodykit_tpu/ops/radix_pallas.py
// _rank_kernel:
//
//     rank[i] = #{j < i : digit[j] == digit[i]},   hist[d] = #{digit == d}
//
// for int32 digits in [0, D), D <= 1024. The TPU kernel carries a running
// per-digit base across a sequential grid; Hopper blocks run in no order,
// so the pass is split in three kernels on one stream:
//
//   1. chunk_hist_kernel  per-chunk digit histograms (shared-memory counts)
//   2. chunk_scan_kernel  exclusive scan of those histograms over chunks,
//                         per digit; the totals are hist
//   3. chunk_rank_kernel  stable in-chunk rank plus the chunk's base
//
// Kernel 3 is stable without atomics: warp w of a block owns the w-th
// contiguous sub-chunk, ranks 32 digits at a time with __match_any_sync
// and __popc(peers & lanemask_lt), and starts from per-warp per-digit
// counts that were scanned across warps in warp order. Digits outside
// [0, D) are skipped and counted into *bad, a device counter the caller
// reads where it synchronizes anyway (no host round trip per pass).
//
// Bound: bytes (n int32 in, n int32 out, D int32 out). The digits are
// read twice and the chunk histograms add D/4096 of the digit stream.
//
// Built by nbodykit_tpu_torch/_build.py into a shared library with a plain
// C interface; nbk_rank_pass returns cudaGetLastError().

#include <cuda_runtime.h>

#define RANK_CHUNK 4096                       // elements per block
#define RANK_WARPS 8
#define RANK_THREADS (RANK_WARPS * 32)
#define WARP_SPAN (RANK_CHUNK / RANK_WARPS)   // elements per warp
#define SCAN_SEGS 32

__global__ void chunk_hist_kernel(const int* __restrict__ digit, long long n,
                                  int D, int* __restrict__ chunk_hist,
                                  int* __restrict__ bad) {
  extern __shared__ int cnt[];  // D
  __shared__ int nbad;
  for (int d = threadIdx.x; d < D; d += blockDim.x) cnt[d] = 0;
  if (threadIdx.x == 0) nbad = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * RANK_CHUNK;
  const long long end = min(base + RANK_CHUNK, n);
  for (long long i = base + threadIdx.x; i < end; i += blockDim.x) {
    const int d = digit[i];
    if (d >= 0 && d < D)
      atomicAdd(&cnt[d], 1);
    else
      atomicAdd(&nbad, 1);
  }
  __syncthreads();
  int* out = chunk_hist + (long long)blockIdx.x * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) out[d] = cnt[d];
  if (threadIdx.x == 0 && nbad) atomicAdd(bad, nbad);
}

// block (32, SCAN_SEGS): x = digit within a group of 32, y = segment of
// chunks. In place: chunk_hist[c][d] becomes the exclusive prefix over
// chunks; hist[d] gets the total.
__global__ void chunk_scan_kernel(int* __restrict__ chunk_hist, int nch,
                                  int D, int* __restrict__ hist) {
  __shared__ int seg[SCAN_SEGS][33];
  const int d = blockIdx.x * 32 + threadIdx.x;
  const int per = (nch + SCAN_SEGS - 1) / SCAN_SEGS;
  const int c0 = threadIdx.y * per;
  const int c1 = min(c0 + per, nch);
  int s = 0;
  if (d < D) {
#pragma unroll 8
    for (int c = c0; c < c1; ++c) s += chunk_hist[(long long)c * D + d];
  }
  seg[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0) {
    int run = 0;
    for (int j = 0; j < SCAN_SEGS; ++j) {
      const int t = seg[j][threadIdx.x];
      seg[j][threadIdx.x] = run;
      run += t;
    }
    if (d < D) hist[d] = run;
  }
  __syncthreads();
  if (d < D) {
    int run = seg[threadIdx.y][threadIdx.x];
#pragma unroll 8
    for (int c = c0; c < c1; ++c) {
      const long long k = (long long)c * D + d;
      const int t = chunk_hist[k];
      chunk_hist[k] = run;
      run += t;
    }
  }
}

__device__ __forceinline__ int load_digit(const int* __restrict__ digit,
                                          long long i, long long n, int D) {
  if (i >= n) return -1;
  const int d = digit[i];
  return (d >= 0 && d < D) ? d : -1;
}

__global__ void chunk_rank_kernel(const int* __restrict__ digit, long long n,
                                  int D, const int* __restrict__ chunk_base,
                                  int* __restrict__ rank) {
  extern __shared__ int cnt[];  // RANK_WARPS x D
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int* mine = cnt + warp * D;
  for (int i = threadIdx.x; i < RANK_WARPS * D; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  const long long base =
      (long long)blockIdx.x * RANK_CHUNK + (long long)warp * WARP_SPAN;
  // this warp's per-digit counts; one leader lane per distinct digit
  // writes, so no two lanes touch one counter
  for (int it = 0; it < WARP_SPAN; it += 32) {
    const int d = load_digit(digit, base + it + lane, n, D);
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d >= 0 && (peers & lt) == 0) mine[d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // exclusive scan across warps, in warp order, from the chunk's base
  const int* cb = chunk_base + (long long)blockIdx.x * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    int run = cb[d];
    for (int w = 0; w < RANK_WARPS; ++w) {
      const int t = cnt[w * D + d];
      cnt[w * D + d] = run;
      run += t;
    }
  }
  __syncthreads();

  for (int it = 0; it < WARP_SPAN; it += 32) {
    const long long i = base + it + lane;
    const int d = load_digit(digit, i, n, D);
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d >= 0) rank[i] = mine[d] + __popc(peers & lt);
    __syncwarp();
    if (d >= 0 && (peers & lt) == 0) mine[d] += __popc(peers);
    __syncwarp();
  }
}

// hist needs no zeroing: chunk_scan_kernel writes every hist[d], d < D.
// *bad is added to, never reset.
extern "C" int nbk_rank_pass(const int* digit, int* rank, int* hist,
                             int* chunk_hist, int* bad, long long n, int D,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nch = (int)((n + RANK_CHUNK - 1) / RANK_CHUNK);
  chunk_hist_kernel<<<nch, RANK_THREADS, D * sizeof(int), s>>>(
      digit, n, D, chunk_hist, bad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_scan_kernel<<<(D + 31) / 32, dim3(32, SCAN_SEGS), 0, s>>>(
      chunk_hist, nch, D, hist);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_rank_kernel<<<nch, RANK_THREADS, RANK_WARPS * D * sizeof(int), s>>>(
      digit, n, D, chunk_hist, rank);
  return (int)cudaGetLastError();
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
