// Rank pass of the radix counting sort, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nbodykit_tpu/ops/radix_pallas.py
// _rank_kernel:
//
//     rank[i] = #{j < i : digit[j] == digit[i]},   hist[d] = #{digit == d}
//
// for int32 digits in [0, D), D <= 1024.
//
// What bounds it on the H100: bytes (n int32 digits in, n int32 ranks out,
// D counts). The TPU kernel carries a running per-digit base across its
// sequential grid; Hopper CTAs run in no order, and a multi-kernel pass
// (histograms, a scan over chunks, the rank) reads the digits twice.
//
// Design: one kernel, a single-pass counting rank with decoupled
// look-back, that reads each digit once and writes each rank once.
//  - A CTA takes its chunk of RANK_CHUNK digits from an atomic ticket, so
//    every lower chunk has already started and the look-back below cannot
//    wait on a CTA that is not running.
//  - It loads the chunk with 16-byte loads into shared memory. Warp w owns
//    the w-th contiguous sub-chunk and ranks it 32 digits at a time in
//    index order, from per-warp per-digit counters: the lanes that hold
//    the same digit are found with one __ballot_sync per digit bit (which
//    costs the same for any mix of digits, where __match_any_sync slows
//    with the number of distinct ones) and ranked by __popc(peers &
//    lanemask_lt); the in-warp ranks stay in registers.
//  - The per-warp counts are scanned across warps in warp order, which
//    keeps the ranks stable; their totals are the chunk's per-digit
//    aggregate. The CTA writes the aggregate, then sets the chunk's status
//    word to AGGREGATE. One warp then looks back over the status words of
//    the LOOKBACK_WINDOW lower chunks at a time until it meets an
//    INCLUSIVE one; the whole CTA sums those chunks' per-digit counts,
//    writes its own inclusive prefix and sets its status to INCLUSIVE.
//    Counts are written, fenced (__threadfence) and then flagged with a
//    release store; the flags are read with acquire loads and the counts
//    past L1 (__ldcg).
//  - Ranks leave through shared memory with 16-byte stores. The last
//    chunk's inclusive prefix is hist.
// The ticket and the status words sit in scratch that the entry point
// clears with cudaMemsetAsync on the stream before the kernel (4 bytes per
// chunk); the counts (8 * D bytes per chunk) need no clearing. Digits
// outside [0, D) are skipped, take no rank and are counted into *bad, a
// device counter the caller reads where it synchronizes anyway. The result
// is bit-identical to the plain version.
//
// Built by nbodykit_tpu_torch/_build.py into a shared library with a plain
// C interface; nbk_rank_pass returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#define RANK_THREADS 512
#define RANK_WARPS (RANK_THREADS / 32)
#define RANK_PER_THREAD 16
#define RANK_CHUNK (RANK_THREADS * RANK_PER_THREAD)   // 8192 digits
#define WARP_SPAN (RANK_CHUNK / RANK_WARPS)           // 512 digits
#define LOOKBACK_ROUNDS 4                             // flags a lane reads
#define LOOKBACK_WINDOW (32 * LOOKBACK_ROUNDS)
#define SUM_BATCH 8  // look-back loads in flight per thread

#define STATUS_AGGREGATE 1u
#define STATUS_INCLUSIVE 2u

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"((unsigned long long)p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;\n" ::"l"(
                   (unsigned long long)p),
               "r"(v)
               : "memory");
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// status[c]: 0, STATUS_AGGREGATE or STATUS_INCLUSIVE; aggs[c][d] and
// incls[c][d]: chunk c's count of digit d and the count up to and
// including chunk c. Shared memory: buf[RANK_CHUNK] (digits, then ranks),
// cnt[RANK_WARPS][D] (per-warp counts, then their exclusive scan), agg[D],
// excl[D].
__global__ void __launch_bounds__(RANK_THREADS, 3)
    rank_lookback_kernel(const int* __restrict__ digit,
                         int* __restrict__ rank, int* __restrict__ hist,
                         unsigned* __restrict__ ticket,
                         unsigned* __restrict__ status,
                         int* __restrict__ aggs, int* __restrict__ incls,
                         int* __restrict__ bad, long long n, int D, int nch,
                         int vec) {
  extern __shared__ __align__(16) int sm[];
  int* buf = sm;
  int* cnt = buf + RANK_CHUNK;
  int* agg = cnt + RANK_WARPS * D;
  int* excl = agg + D;
  __shared__ int s_chunk, s_bad, s_first;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;

  if (tid == 0) {
    s_chunk = (int)atomicAdd(ticket, 1u);
    s_bad = 0;
  }
  for (int i = tid; i < RANK_WARPS * D; i += RANK_THREADS) cnt[i] = 0;
  for (int d = tid; d < D; d += RANK_THREADS) excl[d] = 0;
  __syncthreads();
  const int c = s_chunk;
  const long long base = (long long)c * RANK_CHUNK;
  const int len = (int)min((long long)RANK_CHUNK, n - base);
  const bool full = vec && len == RANK_CHUNK;

  if (full) {
    const int4* src = reinterpret_cast<const int4*>(digit + base);
    int4* dst = reinterpret_cast<int4*>(buf);
    for (int i = tid; i < RANK_CHUNK / 4; i += RANK_THREADS)
      dst[i] = __ldcs(src + i);
  } else {
    for (int i = tid; i < len; i += RANK_THREADS) buf[i] = digit[base + i];
  }
  __syncthreads();

  // in-warp ranks, in index order, from this warp's per-digit counters;
  // one leader lane per distinct digit updates its counter
  int* mine = cnt + warp * D;
  int loc[RANK_PER_THREAD];
  int nbad = 0;
  // keys 0..D (D marks a skipped digit) take nbits bits
  const int nbits = 32 - __clz(D);
#pragma unroll
  for (int it = 0; it < RANK_PER_THREAD; ++it) {
    const int e = warp * WARP_SPAN + it * 32 + lane;
    const int d = e < len ? buf[e] : -1;
    const bool good = d >= 0 && d < D;
    nbad += (e < len && !good) ? 1 : 0;
    const int key = good ? d : D;
    // the lanes holding the same key: one ballot per key bit
    unsigned peers = 0xffffffffu;
    for (int b = 0; b < nbits; ++b) {
      const unsigned bit = (key >> b) & 1u;
      const unsigned m = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? m : ~m;
    }
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (good && leader == lane) {
      before = mine[d];
      mine[d] = before + __popc(peers);
    }
    before = __shfl_sync(0xffffffffu, before, leader);
    loc[it] = before + __popc(peers & lt);
    __syncwarp();
  }
  nbad = warp_sum(nbad);
  if (lane == 0 && nbad) atomicAdd(&s_bad, nbad);
  __syncthreads();

  // exclusive scan across warps in warp order; the totals are this
  // chunk's aggregate (chunk 0's is also its inclusive prefix)
  for (int d = tid; d < D; d += RANK_THREADS) {
    int run = 0;
    for (int w = 0; w < RANK_WARPS; ++w) {
      const int t = cnt[w * D + d];
      cnt[w * D + d] = run;
      run += t;
    }
    agg[d] = run;
    __stcg(&aggs[(long long)c * D + d], run);
    if (c == 0) __stcg(&incls[d], run);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    store_release(&status[c], c == 0 ? STATUS_INCLUSIVE : STATUS_AGGREGATE);

  // look-back: warp 0 reads the status of chunks j, j-1, ..., j -
  // LOOKBACK_WINDOW + 1 (a chunk below 0 counts as inclusive and empty),
  // waits until all are set and finds the nearest inclusive one; then the
  // CTA adds up the counts of the chunks down to it
  for (long long j = (long long)c - 1; c > 0; j -= LOOKBACK_WINDOW) {
    if (warp == 0) {
      unsigned f[LOOKBACK_ROUNDS];
#pragma unroll
      for (int q = 0; q < LOOKBACK_ROUNDS; ++q) {
        const long long jj = j - lane - 32 * q;
        f[q] = jj < 0 ? STATUS_INCLUSIVE : load_acquire(&status[jj]);
      }
#pragma unroll
      for (int q = 0; q < LOOKBACK_ROUNDS; ++q) {
        const long long jj = j - lane - 32 * q;
        while (__any_sync(0xffffffffu, f[q] == 0))
          if (f[q] == 0) f[q] = load_acquire(&status[jj]);
      }
      int first = -1;
#pragma unroll
      for (int q = LOOKBACK_ROUNDS - 1; q >= 0; --q) {
        const unsigned m =
            __ballot_sync(0xffffffffu, f[q] == STATUS_INCLUSIVE);
        if (m) first = 32 * q + __ffs(m) - 1;
      }
      if (lane == 0) s_first = first;
    }
    __syncthreads();
    const int first = s_first;
    const int span = first >= 0 ? first + 1 : LOOKBACK_WINDOW;
    // `groups` threads per digit, each summing every groups-th chunk of
    // the span with SUM_BATCH loads in flight
    const int groups = max(1, RANK_THREADS / D);
    for (int q = tid; q < groups * D; q += RANK_THREADS) {
      const int g = q / D, d = q - g * D;
      int acc = 0;
      for (int i0 = g; i0 < span; i0 += SUM_BATCH * groups) {
        int v[SUM_BATCH];
#pragma unroll
        for (int u = 0; u < SUM_BATCH; ++u) {
          const int i = i0 + u * groups;
          const long long jj = j - i;
          v[u] = i < span && jj >= 0
                     ? __ldcg((i == first ? incls : aggs) + jj * D + d)
                     : 0;
        }
#pragma unroll
        for (int u = 0; u < SUM_BATCH; ++u) acc += v[u];
      }
      if (acc) atomicAdd(&excl[d], acc);
    }
    __syncthreads();
    if (first >= 0) break;
  }

  if (c > 0) {
    for (int d = tid; d < D; d += RANK_THREADS)
      __stcg(&incls[(long long)c * D + d], excl[d] + agg[d]);
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(&status[c], STATUS_INCLUSIVE);
  }
  if (c == nch - 1)
    for (int d = tid; d < D; d += RANK_THREADS) hist[d] = excl[d] + agg[d];

  // ranks into shared memory in index order (a skipped digit gets 0)
#pragma unroll
  for (int it = 0; it < RANK_PER_THREAD; ++it) {
    const int e = warp * WARP_SPAN + it * 32 + lane;
    if (e < len) {
      const int d = buf[e];
      buf[e] = (d >= 0 && d < D) ? excl[d] + cnt[warp * D + d] + loc[it]
                                 : 0;
    }
  }
  __syncthreads();
  if (full) {
    const int4* src = reinterpret_cast<const int4*>(buf);
    int4* dst = reinterpret_cast<int4*>(rank + base);
    for (int i = tid; i < RANK_CHUNK / 4; i += RANK_THREADS)
      __stcs(dst + i, src[i]);
  } else {
    for (int i = tid; i < len; i += RANK_THREADS) rank[base + i] = buf[i];
  }
  if (tid == 0 && s_bad) atomicAdd(bad, s_bad);
}

// scratch (ops/radix_cuda.py rank_plan): a 16-byte ticket, the chunks'
// status words (4 bytes each, padded to 16), then aggs and incls (nch * D
// int32 each). The ticket and the status words are cleared here on the
// stream. hist needs no zeroing: the last chunk writes every hist[d].
// *bad is added to, never reset.
extern "C" int nbk_rank_pass(const int* digit, int* rank, int* hist,
                             void* scratch, int* bad, long long n, int D,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nch = (int)((n + RANK_CHUNK - 1) / RANK_CHUNK);
  const size_t flag_bytes = ((size_t)nch * 4 + 15) / 16 * 16;
  char* p = (char*)scratch;
  cudaError_t e = cudaMemsetAsync(p, 0, 16 + flag_bytes, s);
  if (e != cudaSuccess) return (int)e;
  const int smem = (RANK_CHUNK + (RANK_WARPS + 2) * D) * (int)sizeof(int);
  e = cudaFuncSetAttribute(rank_lookback_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = ((uintptr_t)digit % 16 == 0) && ((uintptr_t)rank % 16 == 0);
  unsigned* ticket = (unsigned*)p;
  unsigned* status = (unsigned*)(p + 16);
  int* aggs = (int*)(p + 16 + flag_bytes);
  int* incls = aggs + (size_t)nch * D;
  rank_lookback_kernel<<<nch, RANK_THREADS, smem, s>>>(
      digit, rank, hist, ticket, status, aggs, incls, bad, n, D, nch, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
