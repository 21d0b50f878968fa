// Threefry-2x32 draws equal to JAX's, for Hopper (sm_90a).
//
// Not a port of a Pallas kernel: the JAX package draws with jax.random
// (nbodykit_tpu/rng.py), which XLA computes. Torch has no uint32 add or
// shift, so the plain-torch threefry (ops/threefry_cuda.py) runs about 140
// full-array int64 passes per draw; these kernels hash in registers.
//
// threefry_fill_kernel: element i is the threefry2x32 hash of the 64-bit
// counter c0 + i (hi word, lo word) under key (k0, k1), written as
//   bits32    h1 ^ h2                              (JAX random_bits, 32)
//   bits64    h1 << 32 | h2                        (JAX random_bits, 64)
//   uniform   JAX's mantissa trick, then max(lo, fma(f, hi - lo, lo))
//   normal    sqrt(2) erf_inv(u), u uniform in (nextafter(-1, 0), 1), with
//             XLA's erf_inv (Giles' polynomials, Horner steps as fma)
// in f32 or f64. What bounds it on the H100: integer operations, at 64
// results per clock per SM; the output is written once. A hash is 20 rounds
// of add, funnel-shift rotate and xor plus 6 key injections of two adds; in
// SASS, IADD3 merges five of the x0 injections into the next round's add, so
// it is 67 instructions (chip_smoke.py counts them in the built library).
// One thread per element in a grid-stride loop; the key schedule is hoisted.
//
// poisson_draw_kernel and its two later phases: JAX's random.poisson
// (jax/_src/random.py _poisson) on f32 lam. JAX runs Knuth's loop and the
// transformed-rejection loop over every cell until the last cell is done. A
// cell's draw at iteration j is a uniform under subkey j at the cell's
// counter, and the subkey chains are the same for every cell, so the host
// passes them as tables and each thread runs its own cells' loops:
//   phase 0  Knuth cells (lam < 10 or NaN): the count, stopping when done.
//            Rejection cells: their first accepting iteration; the loop
//            length JAX reaches is max(first) + 1 over all cells, kept in
//            scratch by atomicMax.
//   phase 1  only if a rejection cell exists: the Knuth cells' first
//            acceptance in the rejection loop, which JAX runs with
//            lam = 1e5 there, also bounds the loop length.
//   phase 2  only if a rejection cell exists: JAX keeps the k of the LAST
//            accepting iteration before its loop ends; each rejection cell
//            replays the loop to that length.
// Phases 1 and 2 are launched on the same stream every call and return at
// once when phase 0 found no rejection cell. A cell that runs past a table
// sets a scratch flag; the wrapper raises. The hashes used are summed into
// scratch for the bound.
//
// Two output modes of the one phase-0 kernel:
//   full mesh       int64 counts of lam's shape (rng.poisson). Bound:
//                   bytes, 4 B of lam in and 8 B out per cell.
//   occupied cells  the raster-ordered (cell id, count) list of the cells
//                   whose count is nonzero, the list's length and the
//                   counts' sum (mockmaker.poisson_cells): nonzero() of the
//                   full mesh, in the same launch that draws it. Bound:
//                   the hashes (lam is read once, the list is ~1% of it).
// Design, for the H100: resident CTAs of 1024 threads take tiles of 16384
// cells; a thread issues four float4 loads of lam (16 cells) before it
// hashes any, so each SM keeps tens of KB of loads in flight, and hashes a
// vector's four cells together, branch-free. Iteration 0's subkey is the same for every cell,
// and its key schedule sits in registers; at the lognormal mock's lam
// (mean ~0.01) > 99% of cells stop there. Whether a cell stops is decided
// by a __logf screen with a proven margin; the cells that go on or sit
// near the boundary, and the rejection cells, go to a per-warp queue in
// shared memory that the warp drains one cell a lane, reading later
// subkeys from shared memory. The occupied cells are ranked in the tile by
// one packed warp scan per warp and placed by decoupled look-back over
// ticket-ordered tiles (as csrc/radix_rank.cu), the next ticket taken once
// the tile's inclusive count is out: one pass over lam, no count mesh, and
// the host reads one block of scratch per call.
//
// Arithmetic matches the plain versions operation for operation (built
// with -fmad=false; fused multiply-adds only where XLA contracts them, as
// explicit fmaf/fma; true divisions; logf/log1pf/sqrtf as torch's CUDA
// kernels call them), so kernel and plain version agree bit for bit.
//
// Built by nbodykit_tpu_torch/_build.py into a shared library with a plain
// C interface; each entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FILL_THREADS 256

enum Kind { BITS32 = 0, BITS64, UNIFORM32, UNIFORM64, NORMAL32, NORMAL64 };

struct KeySchedule {
  uint32_t k0, k1, k2;
};

__device__ __forceinline__ KeySchedule schedule(uint32_t k0, uint32_t k1) {
  KeySchedule ks;
  ks.k0 = k0;
  ks.k1 = k1;
  ks.k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  return ks;
}

#define TF_ROUND(r)              \
  x0 += x1;                      \
  x1 = __funnelshift_l(x1, x1, r); \
  x1 ^= x0;

__device__ __forceinline__ void threefry(const KeySchedule& ks, uint32_t& x0,
                                         uint32_t& x1) {
  x0 += ks.k0;
  x1 += ks.k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks.k1;
  x1 += ks.k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += ks.k2;
  x1 += ks.k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks.k0;
  x1 += ks.k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += ks.k1;
  x1 += ks.k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks.k2;
  x1 += ks.k0 + 5u;
}

__device__ __forceinline__ float unit32(uint32_t h1, uint32_t h2) {
  return __uint_as_float(((h1 ^ h2) >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ double unit64(uint32_t h1, uint32_t h2) {
  const unsigned long long b = ((unsigned long long)h1 << 32) | h2;
  return __longlong_as_double((long long)((b >> 12) |
                                          0x3FF0000000000000ull)) - 1.0;
}

// XLA's erf_inv, f32: Giles' single-precision polynomials
__device__ __forceinline__ float erf_inv32(float x) {
  float w = -log1pf(-x * x);
  float p;
  if (w < 5.0f) {
    w = w - 2.5f;
    p = 2.81022636e-08f;
    p = fmaf(p, w, 3.43273939e-07f);
    p = fmaf(p, w, -3.5233877e-06f);
    p = fmaf(p, w, -4.39150654e-06f);
    p = fmaf(p, w, 0.00021858087f);
    p = fmaf(p, w, -0.00125372503f);
    p = fmaf(p, w, -0.00417768164f);
    p = fmaf(p, w, 0.246640727f);
    p = fmaf(p, w, 1.50140941f);
  } else {
    w = sqrtf(w) - 3.0f;
    p = -0.000200214257f;
    p = fmaf(p, w, 0.000100950558f);
    p = fmaf(p, w, 0.00134934322f);
    p = fmaf(p, w, -0.00367342844f);
    p = fmaf(p, w, 0.00573950773f);
    p = fmaf(p, w, -0.0076224613f);
    p = fmaf(p, w, 0.00943887047f);
    p = fmaf(p, w, 1.00167406f);
    p = fmaf(p, w, 2.83297682f);
  }
  const float r = p * x;
  return fabsf(x) == 1.0f ? x * INFINITY : r;
}

__constant__ double kErfInv64A[23] = {
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18,  1.115787767802518096e-17,
    -1.333171662854620906e-16,  2.0972767875968561637e-17,
    6.6376381343583238325e-15,  -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09,   -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352,   -0.00074070253416626697512,
    -0.0060336708714301490533,  0.24015818242558961693,
    1.6536545626831027356};
__constant__ double kErfInv64B[19] = {
    2.2137376921775787049e-09,  9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06,  -4.013867526981545969e-06,
    2.9234449089955446044e-06,  1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05,  -0.0003550375203628474796,
    0.00095328937973738049703,  -0.0016882755560235047313,
    0.0024914420961078508066,   -0.0037512085075692412107,
    0.005370914553590063617,    1.0052589676941592334,
    3.0838856104922207635};
__constant__ double kErfInv64C[17] = {
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09,  -3.7894654401267369937e-09,
    7.6157012080783393804e-09,  -1.4960026627149240478e-08,
    2.9147953450901080826e-08,  -6.7711997758452339498e-08,
    2.2900482228026654717e-07,  -9.9298272942317002539e-07,
    4.5260625972231537039e-06,  -1.9681778105531670567e-05,
    7.5995277030017761139e-05,  -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221};

__device__ __forceinline__ double horner64(const double* c, int n, double w) {
  double p = c[0];
  for (int i = 1; i < n; ++i) p = fma(p, w, c[i]);
  return p;
}

// XLA's erf_inv, f64: Giles' double-precision polynomials
__device__ __forceinline__ double erf_inv64(double x) {
  const double w = -log1p(-x * x);
  double p;
  if (w < 6.25) {
    p = horner64(kErfInv64A, 23, w - 3.125);
  } else if (w < 16.0) {
    p = horner64(kErfInv64B, 19, sqrt(w) - 3.25);
  } else {
    p = horner64(kErfInv64C, 17, sqrt(w) - 5.0);
  }
  const double r = p * x;
  return fabs(x) == 1.0 ? x * (double)INFINITY : r;
}

template <int KIND>
__global__ void __launch_bounds__(FILL_THREADS)
threefry_fill_kernel(uint32_t k0, uint32_t k1, unsigned long long c0,
                     long long n, double lo, double scale, void* out) {
  const KeySchedule ks = schedule(k0, k1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long c = c0 + (unsigned long long)i;
    uint32_t h1 = (uint32_t)(c >> 32), h2 = (uint32_t)c;
    threefry(ks, h1, h2);
    if (KIND == BITS32) {
      ((uint32_t*)out)[i] = h1 ^ h2;
    } else if (KIND == BITS64) {
      ((unsigned long long*)out)[i] = ((unsigned long long)h1 << 32) | h2;
    } else if (KIND == UNIFORM32 || KIND == NORMAL32) {
      const float lo32 = (float)lo;
      float u = fmaxf(lo32, fmaf(unit32(h1, h2), (float)scale, lo32));
      if (KIND == NORMAL32) u = erf_inv32(u) * 1.41421356237309504880f;
      ((float*)out)[i] = u;
    } else {
      double u = fmax(lo, fma(unit64(h1, h2), scale, lo));
      if (KIND == NORMAL64) u = erf_inv64(u) * 1.41421356237309504880;
      ((double*)out)[i] = u;
    }
  }
}

// ---------------------------------------------------------------------------
// Poisson

__device__ __forceinline__ float uniform_ks(const KeySchedule& ks,
                                            unsigned long long cell) {
  uint32_t h1 = (uint32_t)(cell >> 32), h2 = (uint32_t)cell;
  threefry(ks, h1, h2);
  return unit32(h1, h2);
}

__device__ __forceinline__ float uniform_at(const uint32_t* key,
                                            unsigned long long cell) {
  return uniform_ks(schedule(key[0], key[1]), cell);
}

// lgamma as XLA writes it (Lanczos, g = 7), for x >= 0.5
__device__ __forceinline__ float lgamma_xla(float x) {
  const float z = x - 1.0f;
  float acc = 0.99999999999980993227684700473478f;
  acc = acc + 676.520368121885098567009190444019f / ((z + 0.0f) + 1.0f);
  acc = acc + -1259.13921672240287047156078755283f / ((z + 1.0f) + 1.0f);
  acc = acc + 771.3234287776530788486528258894f / ((z + 2.0f) + 1.0f);
  acc = acc + -176.61502916214059906584551354f / ((z + 3.0f) + 1.0f);
  acc = acc + 12.507343278686904814458936853f / ((z + 4.0f) + 1.0f);
  acc = acc + -0.13857109526572011689554707f / ((z + 5.0f) + 1.0f);
  acc = acc + 9.984369578019570859563e-6f / ((z + 6.0f) + 1.0f);
  acc = acc + 1.50563273514931155834e-7f / ((z + 7.0f) + 1.0f);
  const float t = z + 7.5f;
  const float log_t = log1pf(z / 7.5f) + 2.01490302054226474f;
  return fmaf((z + 0.5f) - t / log_t, log_t, 0.91893853320467274178f) +
         logf(acc);
}

struct Rejection {
  float lam, log_lam, b, a, inv_alpha, v_r;
};

__device__ __forceinline__ Rejection rejection_setup(float lam) {
  Rejection r;
  r.lam = lam;
  r.log_lam = logf(lam);
  r.b = fmaf(2.53f, sqrtf(lam), 0.931f);
  r.a = fmaf(0.02483f, r.b, -0.059f);
  r.inv_alpha = 1.1239f + 1.1328f / (r.b - 3.4f);
  r.v_r = 0.9277f - 3.6224f / (r.b - 2.0f);
  return r;
}

// one iteration of JAX's transformed rejection on the cell's uniforms
__device__ __forceinline__ bool rejection_step(const Rejection& r,
                                               const uint32_t* key2,
                                               unsigned long long cell,
                                               float* k_out) {
  const float u = uniform_at(key2, cell) - 0.5f;
  const float v = uniform_at(key2 + 2, cell);
  const float us = 0.5f - fabsf(u);
  const float k = floorf(fmaf(2.0f * r.a / us + r.b, u, r.lam) + 0.43f);
  const float s = logf(v * r.inv_alpha / (r.a / (us * us) + r.b));
  const float t = fmaf(k, r.log_lam, -r.lam) - lgamma_xla(k + 1.0f);
  const bool accept1 = (us >= 0.07f) && (v <= r.v_r);
  const bool reject = (k < 0.0f) || ((us < 0.013f) && (v > us));
  *k_out = k;
  return accept1 || (!reject && (s <= t));
}

// the first accepting iteration of a cell, or -1 past the table
__device__ __noinline__ int rejection_first(float lam, const uint32_t* rej,
                                            int rlen,
                                            unsigned long long cell) {
  const Rejection r = rejection_setup(lam);
  float k;
  for (int i = 0; i < rlen; ++i)
    if (rejection_step(r, rej + 4 * i, cell, &k)) return i;
  return -1;
}

// k at the last accepting iteration of the first `iters`
__device__ __noinline__ long long rejection_replay(float lam,
                                                  const uint32_t* rej,
                                                  int iters,
                                                  unsigned long long cell) {
  const Rejection r = rejection_setup(lam);
  float k_out = -1.0f, k;
  for (int it = 0; it < iters; ++it)
    if (rejection_step(r, rej + 4 * it, cell, &k)) k_out = k;
  return (long long)k_out;
}

// Knuth's first step stops a cell unless logf(u0) > -lam. With the
// screen, __logf (MUFU.LG2 and a multiply) settles it wherever it lies
// farther than screen_margin from -lam, and a cell near the boundary is
// settled later with the exact logf (knuth_rest). nbk_poisson_screen_check
// proves the margin on the card: |__logf(u) - logf(u)| <=
// screen_margin(__logf(u)) / 2 for every u the uniform can take (k 2^-23,
// 0 < k < 2^23; at u = 0 both are -inf, the screen's compares fail and the
// cell is settled exactly).
__device__ __forceinline__ float screen_margin(float g) {
  return fmaf(fabsf(g), 0x1p-19f, 0x1p-19f);
}

// whether Knuth's first step certainly stops the cell
__device__ __forceinline__ bool knuth_stops(float u, float neg) {
  const float g = __logf(u);
  return g + screen_margin(g) <= neg;
}

#define KNUTH_OVERFLOW (-2)

// Knuth's count of a cell that Knuth's first step may not stop: its loop
// from iteration 0 (again, with the exact logf), the later subkeys from
// shared memory. It draws count + 1 times, or klen times and returns
// KNUTH_OVERFLOW past the table.
__device__ __forceinline__ int knuth_rest(const KeySchedule& ks0,
                                          const uint32_t* knuth, int klen,
                                          float lam,
                                          unsigned long long cell) {
  const float neg = -lam;
  float lp = logf(uniform_ks(ks0, cell));
  int k = 1;
  while (lp > neg) {
    if (k == klen) return KNUTH_OVERFLOW;
    lp = lp + logf(uniform_at(knuth + 2 * k, cell));
    ++k;
  }
  return k - 1;
}

#define POISSON_THREADS 1024
#define POISSON_WARPS (POISSON_THREADS / 32)
#define POISSON_VEC 4     // cells per vector load
#define POISSON_UNROLL 4  // vector loads in flight per thread
#define POISSON_CELLS (POISSON_VEC * POISSON_UNROLL)    // per thread
#define POISSON_SPAN (32 * POISSON_CELLS)               // per warp
#define POISSON_TILE (POISSON_THREADS * POISSON_CELLS)  // 16384 cells

static_assert(POISSON_UNROLL <= 4 && POISSON_VEC * 32 < 256,
              "a lane's flag counts per vector load pack into bytes");
static_assert(POISSON_VEC == 4, "load_cells and store_counts move 4 cells");

enum PoissonMode { FULL_MESH = 0, OCCUPIED_CELLS = 1 };

// scratch, int64 words cleared by the entry point, then (occupied cells)
// one status word per tile
#define SCR_ITERS 0     // the rejection loop's length; 0: no rejection cell
#define SCR_OVERFLOW 1  // a cell ran past a subkey table
#define SCR_HASHES 2    // threefry hashes used
#define SCR_TOTAL 3     // the counts' sum (occupied cells)
#define SCR_OCCUPIED 4  // list entries (occupied cells)
#define SCR_ZEROS 5     // listed rejection cells whose count is 0
#define SCR_TICKET 6    // tiles handed out (occupied cells)
#define SCR_WORDS 8

// a tile's status word: its count << 2 | STATUS_*; 0 while unset
#define STATUS_AGGREGATE 1ull
#define STATUS_INCLUSIVE 2ull

// a rejection cell's entry in the tile's counts until phase 2
#define REJECTION_MARK ((short)-32768)

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// inclusive scan over the warp's lanes (modulo 2^32)
__device__ __forceinline__ unsigned warp_scan(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// vector loads and stores; p is 16-byte aligned
__device__ __forceinline__ void load_cells(const float* p, float* l) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  l[0] = q.x, l[1] = q.y, l[2] = q.z, l[3] = q.w;
}

__device__ __forceinline__ void store_counts(long long* p, const int* c) {
  __stcs(reinterpret_cast<longlong2*>(p), make_longlong2(c[0], c[1]));
  __stcs(reinterpret_cast<longlong2*>(p + 2), make_longlong2(c[2], c[3]));
}

// Warp 0 of the tile's CTA: publish the tile's aggregate, look back over
// the lower tiles' status words, 32 at a time, to the nearest inclusive
// one, publish the inclusive count; returns the count before the tile.
// Tiles come from a ticket, so every lower tile's CTA is running.
__device__ __forceinline__ long long tile_lookback(unsigned long long* status,
                                                   long long tile, int agg,
                                                   int lane) {
  if (lane == 0)
    st_relaxed(status + tile, ((unsigned long long)agg << 2) |
                                  (tile == 0 ? STATUS_INCLUSIVE
                                             : STATUS_AGGREGATE));
  if (tile == 0) return 0;
  long long prefix = 0;
  for (long long j = tile - 1;; j -= 32) {
    const long long jj = j - lane;
    unsigned long long s = jj >= 0 ? ld_relaxed(status + jj)
                                   : STATUS_INCLUSIVE;
    while (__any_sync(0xffffffffu, s == 0))
      if (s == 0) s = ld_relaxed(status + jj);
    const unsigned incl =
        __ballot_sync(0xffffffffu, (s & 3ull) == STATUS_INCLUSIVE);
    const int first = incl ? __ffs(incl) - 1 : 32;
    prefix += warp_sum64(lane <= first ? (long long)(s >> 2) : 0);
    if (incl) break;
  }
  if (lane == 0)
    st_relaxed(status + tile,
               ((unsigned long long)(prefix + agg) << 2) | STATUS_INCLUSIVE);
  return prefix;
}

__device__ __forceinline__ void flush_counters(long long* scratch,
                                               unsigned long long hashes,
                                               long long total, int iters,
                                               bool overflow, int lane) {
  hashes = (unsigned long long)warp_sum64((long long)hashes);
  total = warp_sum64(total);
  iters = __reduce_max_sync(0xffffffffu, iters);
  overflow = __any_sync(0xffffffffu, overflow);
  if (lane == 0) {
    if (hashes)
      atomicAdd((unsigned long long*)(scratch + SCR_HASHES), hashes);
    if (total)
      atomicAdd((unsigned long long*)(scratch + SCR_TOTAL),
                (unsigned long long)total);
    if (iters) atomicMax(scratch + SCR_ITERS, (long long)iters);
    if (overflow) scratch[SCR_OVERFLOW] = 1;
  }
}

// a thread's slot (u, v) in its tile: warp w holds the tile's w-th span
// of POISSON_SPAN cells, and its lanes' vector loads u are consecutive
__device__ __forceinline__ int slot_of(int u, int v, int tid) {
  return (tid >> 5) * POISSON_SPAN + (u * 32 + (tid & 31)) * POISSON_VEC + v;
}

// Dynamic shared memory of phase 0: the subkey tables (2 klen + 4 rlen
// words), a queue of POISSON_SPAN (lam, slot) entries per warp and, for
// the occupied cells, the queued cells' counts (POISSON_TILE shorts, by
// slot).
__host__ __device__ inline int poisson_smem(int klen, int rlen, int mode) {
  return ((2 * klen + 4 * rlen) * 4 + 15) / 16 * 16 + POISSON_TILE * 6 +
         (mode == OCCUPIED_CELLS ? POISSON_TILE * 2 : 0);
}

// Phase 0. CTAs stay resident and take tiles of POISSON_TILE cells: by
// block index (full mesh) or from the ticket (occupied cells). Slot s of a
// tile is its cell v0 + s, in raster order; warp w holds the w-th span of
// POISSON_SPAN slots, a thread POISSON_UNROLL vector loads of POISSON_VEC
// cells in it, issued together, the warp's lanes on consecutive vectors.
// Slot 0 sits `shift` cells before lam, where 16-byte alignment falls; the
// head and the tail load cell by cell.
// Each vector's cells hash together, branch-free, under iteration 0's key
// schedule (in registers); the screen stops > 99% of cells at the
// lognormal mock's lam. The others, and every rejection cell, go to the
// warp's queue in shared memory, which the warp then drains one cell a
// lane: the rare long loops run side by side, not one lane of a warp at a
// time, and no warp waits for another.
//  full mesh: int64 counts with vector stores (out is aligned like lam),
//             a queued cell's count written by the drain after them
//             (a rejection cell's waits for phase 2). No block barrier.
//  occupied cells: a lane flags its cells with a nonzero count and its
//             rejection cells (a queued cell's count comes back from the
//             drain through shared memory); one warp scan of its flag
//             counts per vector load, packed in bytes, ranks them in
//             raster order. Warp 0 scans the warps' totals, finds the
//             tile's base by decoupled look-back and, once the tile's
//             inclusive count is out, takes the next tile; each lane
//             writes its flagged (cell id, count) pairs at base + rank
//             while below cap. Two block barriers a tile. The list length,
//             the counts' sum and the tables' overflow go to scratch.
template <int MODE>
__global__ void __launch_bounds__(POISSON_THREADS)
    poisson_draw_kernel(const float* __restrict__ lam, long long n,
                        int shift, long long ntiles,
                        const uint32_t* __restrict__ tables, int klen,
                        int rlen, long long* __restrict__ a,
                        long long* __restrict__ b, long long cap,
                        long long* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem);
  float* q_lam = reinterpret_cast<float*>(
      smem + ((2 * klen + 4 * rlen) * 4 + 15) / 16 * 16);
  short* q_slot = reinterpret_cast<short*>(q_lam + POISSON_TILE);
  short* s_cnt = q_slot + POISSON_TILE;  // occupied cells only
  __shared__ int s_qn[POISSON_WARPS], s_wn[POISSON_WARPS];
  __shared__ long long s_tile[2], s_wbase[POISSON_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 2 * klen + 4 * rlen; i += POISSON_THREADS)
    s_tab[i] = tables[i];
  // iteration 0's subkey, the same for every cell, in registers
  const KeySchedule ks0 = schedule(tables[0], tables[1]);
  const uint32_t* s_rej = s_tab + 2 * klen;
  float* wq_lam = q_lam + warp * POISSON_SPAN;  // this warp's queue
  short* wq_slot = q_slot + warp * POISSON_SPAN;
  unsigned long long* status = (unsigned long long*)(scratch + SCR_WORDS);
  unsigned long long hashes = 0;
  long long total = 0, occupied = 0;
  int iters = 0;
  bool overflow = false;
  if (lane == 0) s_qn[warp] = 0;
  if (MODE == OCCUPIED_CELLS && tid == 0)
    s_tile[0] = (long long)atomicAdd(
        (unsigned long long*)(scratch + SCR_TICKET), 1ull);
  __syncthreads();

  for (int step = 0;; ++step) {
    const int p = step & 1;
    const long long tile = MODE == OCCUPIED_CELLS
                               ? s_tile[p]
                               : blockIdx.x + (long long)step * gridDim.x;
    if (tile >= ntiles) break;
    const long long v0 = tile * POISSON_TILE - shift;  // cell of slot 0
    float l[POISSON_CELLS];
#pragma unroll
    for (int u = 0; u < POISSON_UNROLL; ++u) {
      const long long i = v0 + slot_of(u, 0, tid);
      if (i >= 0 && i + POISSON_VEC <= n) {
        load_cells(lam + i, l + u * POISSON_VEC);
      } else {
#pragma unroll
        for (int v = 0; v < POISSON_VEC; ++v)
          l[u * POISSON_VEC + v] =
              (i + v >= 0 && i + v < n) ? lam[i + v] : 0.0f;
      }
    }

    // flags: cells that go in the list; pend: queued cells
    unsigned flags = 0, pend = 0;
#pragma unroll
    for (int u = 0; u < POISSON_UNROLL; ++u) {
      int cnt[POISSON_VEC];
      uint32_t h1[POISSON_VEC], h2[POISSON_VEC];
#pragma unroll
      for (int v = 0; v < POISSON_VEC; ++v) {
        const unsigned long long cell =
            (unsigned long long)(v0 + slot_of(u, v, tid));
        h1[v] = (uint32_t)(cell >> 32), h2[v] = (uint32_t)cell;
      }
#pragma unroll
      for (int v = 0; v < POISSON_VEC; ++v) threefry(ks0, h1[v], h2[v]);
#pragma unroll
      for (int v = 0; v < POISSON_VEC; ++v) {
        const float x = l[u * POISSON_VEC + v];
        const bool knuth = isnan(x) || x < 10.0f;
        const bool draws = knuth && x > 0.0f;  // NaN, lam <= 0: none
        const bool stops = knuth_stops(unit32(h1[v], h2[v]), -x);
        // NaN and lam < 0 count -1; a queued cell's count comes later
        cnt[v] = (x == 0.0f || draws || !knuth) ? 0 : -1;
        hashes += draws;
        if (draws && klen == 0) overflow = true;
        if ((draws && !stops && klen > 0) || !knuth) {
          const int q = atomicAdd(&s_qn[warp], 1);
          wq_slot[q] = (short)slot_of(u, v, tid);
          wq_lam[q] = x;
          pend |= 1u << (u * POISSON_VEC + v);
        }
        if (cnt[v]) flags |= 1u << (u * POISSON_VEC + v);
        total += cnt[v];
      }
      if (MODE == FULL_MESH) {
        const long long i = v0 + slot_of(u, 0, tid);
        if (i >= 0 && i + POISSON_VEC <= n) {
          store_counts(a + i, cnt);
        } else {
#pragma unroll
          for (int v = 0; v < POISSON_VEC; ++v)
            if (i + v >= 0 && i + v < n) a[i + v] = cnt[v];
        }
      }
    }
    __syncwarp();
    const int qn = s_qn[warp];
    __syncwarp();
    if (lane == 0) s_qn[warp] = 0;

    // the warp's queue, one cell a lane: Knuth's loop for cells that may
    // go on, the first acceptance for rejection cells
    for (int e = lane; e < qn; e += 32) {
      const int slot = wq_slot[e];
      const float x = wq_lam[e];
      const unsigned long long cell = (unsigned long long)(v0 + slot);
      short val;
      if (x < 10.0f) {
        int r = knuth_rest(ks0, s_tab, klen, x, cell);
        if (r == KNUTH_OVERFLOW) {
          overflow = true;
          r = klen - 1;
        }
        hashes += r;
        val = (short)r;
        if (MODE == FULL_MESH) a[v0 + slot] = r;
      } else {
        const int first = rejection_first(x, s_rej, rlen, cell);
        if (first < 0) {
          overflow = true;
          hashes += 2ull * rlen;
        } else {
          iters = max(iters, first + 1);
          hashes += 2ull * (first + 1);
        }
        val = REJECTION_MARK;
      }
      if (MODE == OCCUPIED_CELLS) s_cnt[slot] = val;
    }
    __syncwarp();  // the queue is the warp's own again
    if (MODE == FULL_MESH) continue;

    // occupied cells: the queued cells' counts back from the drain
    if (pend) {
#pragma unroll
      for (int c = 0; c < POISSON_CELLS; ++c) {
        if (!((pend >> c) & 1u)) continue;
        const int r = s_cnt[slot_of(c / POISSON_VEC, c % POISSON_VEC, tid)];
        if (r != REJECTION_MARK) total += r;
        if (r) flags |= 1u << c;
      }
    }
    // the flags' ranks in the warp's span: per-vector counts packed in
    // bytes, one warp scan; byte u of `tot` is the warp's count of vector u
    unsigned packed = 0;
#pragma unroll
    for (int u = 0; u < POISSON_UNROLL; ++u)
      packed |= (unsigned)__popc((flags >> (u * POISSON_VEC)) &
                                 ((1u << POISSON_VEC) - 1u))
                << (8 * u);
    const unsigned incl = warp_scan(packed, lane);
    const unsigned tot = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == 0)
      s_wn[warp] = (int)((tot & 0xffu) + ((tot >> 8) & 0xffu) +
                         ((tot >> 16) & 0xffu) + (tot >> 24));
    __syncthreads();
    if (warp == 0) {
      // the warps' counts in order, the tile's base by look-back, then
      // the next tile: every tile below it is out or under way
      const int x = lane < POISSON_WARPS ? s_wn[lane] : 0;
      const int inc = (int)warp_scan((unsigned)x, lane);
      const int agg = __shfl_sync(0xffffffffu, inc, 31);
      const long long base = tile_lookback(status, tile, agg, lane);
      if (lane < POISSON_WARPS) s_wbase[lane] = base + inc - x;
      if (lane == 0) {
        occupied += agg;
        s_tile[p ^ 1] = (long long)atomicAdd(
            (unsigned long long*)(scratch + SCR_TICKET), 1ull);
      }
    }
    __syncthreads();
    long long off = s_wbase[warp];
#pragma unroll
    for (int u = 0; u < POISSON_UNROLL; ++u) {
      const unsigned cu = (packed >> (8 * u)) & 0xffu;
      if (cu) {
        long long at = off + ((incl >> (8 * u)) & 0xffu) - cu;
#pragma unroll
        for (int v = 0; v < POISSON_VEC; ++v) {
          const int c = u * POISSON_VEC + v;
          if (!((flags >> c) & 1u)) continue;
          if (at < cap) {
            const int slot = slot_of(u, v, tid);
            const int r = (pend >> c) & 1u ? s_cnt[slot] : -1;
            a[at] = v0 + slot;
            b[at] = r == REJECTION_MARK ? 0 : r;
          }
          ++at;
        }
      }
      off += (tot >> (8 * u)) & 0xffu;
    }
  }

  flush_counters(scratch, hashes, total, iters, overflow, lane);
  if (MODE == OCCUPIED_CELLS && tid == 0 && occupied)
    atomicAdd((unsigned long long*)(scratch + SCR_OCCUPIED),
              (unsigned long long)occupied);
}

// Phase 1, only if a rejection cell exists: the Knuth cells' first
// acceptance in JAX's rejection loop, which runs there with lam = 1e5,
// also bounds the loop's length.
__global__ void __launch_bounds__(POISSON_THREADS)
    poisson_idle_kernel(const float* __restrict__ lam, long long n,
                        const uint32_t* __restrict__ tables, int klen,
                        int rlen, long long* scratch) {
  if (*(volatile long long*)(scratch + SCR_ITERS) == 0) return;
  const uint32_t* rej = tables + 2 * klen;
  unsigned long long hashes = 0;
  int iters = 0;
  bool overflow = false;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = lam[i];
    if (!(isnan(x) || x < 10.0f)) continue;
    const int first = rejection_first(1e5f, rej, rlen, i);
    if (first < 0) {
      overflow = true;
      hashes += 2ull * rlen;
    } else {
      iters = max(iters, first + 1);
      hashes += 2ull * (first + 1);
    }
  }
  flush_counters(scratch, hashes, 0, iters, overflow, threadIdx.x & 31);
}

// Phase 2, only if a rejection cell exists: JAX keeps the k of the LAST
// accepting iteration before its loop ends; each rejection cell replays
// the loop to that length. Full mesh: over the mesh, into the counts.
__global__ void __launch_bounds__(POISSON_THREADS)
    poisson_replay_mesh_kernel(const float* __restrict__ lam, long long n,
                               const uint32_t* __restrict__ tables, int klen,
                               long long* __restrict__ out,
                               long long* scratch) {
  const int iters = (int)*(volatile long long*)(scratch + SCR_ITERS);
  if (iters == 0) return;
  const uint32_t* rej = tables + 2 * klen;
  unsigned long long hashes = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = lam[i];
    if (isnan(x) || x < 10.0f) continue;
    out[i] = rejection_replay(x, rej, iters, i);
    hashes += 2ull * iters;
  }
  flush_counters(scratch, hashes, 0, 0, false, threadIdx.x & 31);
}

// Phase 2 of the occupied cells: over the list, not the mesh. The counts'
// sum takes the rejection cells' counts; those that come out 0 are
// counted, and the wrapper drops them.
__global__ void __launch_bounds__(POISSON_THREADS)
    poisson_replay_list_kernel(const float* __restrict__ lam,
                               const uint32_t* __restrict__ tables, int klen,
                               const long long* __restrict__ ids,
                               long long* __restrict__ cnts, long long cap,
                               long long* scratch) {
  const int iters = (int)*(volatile long long*)(scratch + SCR_ITERS);
  if (iters == 0) return;
  const long long m = min(*(volatile long long*)(scratch + SCR_OCCUPIED),
                          cap);
  const uint32_t* rej = tables + 2 * klen;
  unsigned long long hashes = 0;
  long long total = 0, zeros = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < m;
       e += stride) {
    const long long i = ids[e];
    const float x = lam[i];
    if (isnan(x) || x < 10.0f) continue;
    const long long k = rejection_replay(x, rej, iters, i);
    cnts[e] = k;
    total += k;
    zeros += k == 0;
    hashes += 2ull * iters;
  }
  flush_counters(scratch, hashes, total, 0, false, threadIdx.x & 31);
  zeros = warp_sum64(zeros);
  if ((threadIdx.x & 31) == 0 && zeros)
    atomicAdd((unsigned long long*)(scratch + SCR_ZEROS),
              (unsigned long long)zeros);
}

// |__logf(u) - logf(u)| against the screen's margin over every uniform
// k 2^-23, 0 < k < 2^23: counts the u where it exceeds half the margin
// into *bad, and the largest |difference| / margin into *worst.
__global__ void screen_check_kernel(unsigned long long* bad, float* worst) {
  unsigned long long nbad = 0;
  float w = 0.0f;
  const int stride = gridDim.x * blockDim.x;
  for (int k = 1 + blockIdx.x * blockDim.x + threadIdx.x; k < (1 << 23);
       k += stride) {
    const float u = (float)k * 0x1p-23f;
    const float g = __logf(u);
    const double d = fabs((double)g - (double)logf(u));
    const double m = (double)screen_margin(g);
    nbad += d > 0.5 * m;
    w = fmaxf(w, (float)(d / m));
  }
  nbad = (unsigned long long)warp_sum64((long long)nbad);
  const int wmax = __reduce_max_sync(0xffffffffu, __float_as_int(w));
  if ((threadIdx.x & 31) == 0) {
    if (nbad) atomicAdd(bad, nbad);
    atomicMax((int*)worst, wmax);
  }
}

static int grid_for(long long n, int threads, int per_sm) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)sms * per_sm;
  return (int)(blocks < cap ? blocks : cap);
}

extern "C" int nbk_threefry_fill(uint32_t k0, uint32_t k1,
                                 unsigned long long c0, long long n, int kind,
                                 double lo, double scale, void* out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  const int grid = grid_for(n, FILL_THREADS, 16);
  switch (kind) {
    case BITS32:
      threefry_fill_kernel<BITS32><<<grid, FILL_THREADS, 0, s>>>(
          k0, k1, c0, n, lo, scale, out);
      break;
    case BITS64:
      threefry_fill_kernel<BITS64><<<grid, FILL_THREADS, 0, s>>>(
          k0, k1, c0, n, lo, scale, out);
      break;
    case UNIFORM32:
      threefry_fill_kernel<UNIFORM32><<<grid, FILL_THREADS, 0, s>>>(
          k0, k1, c0, n, lo, scale, out);
      break;
    case UNIFORM64:
      threefry_fill_kernel<UNIFORM64><<<grid, FILL_THREADS, 0, s>>>(
          k0, k1, c0, n, lo, scale, out);
      break;
    case NORMAL32:
      threefry_fill_kernel<NORMAL32><<<grid, FILL_THREADS, 0, s>>>(
          k0, k1, c0, n, lo, scale, out);
      break;
    case NORMAL64:
      threefry_fill_kernel<NORMAL64><<<grid, FILL_THREADS, 0, s>>>(
          k0, k1, c0, n, lo, scale, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}


// Phases 0, 1 and 2 on the stream; phases 1 and 2 return at once unless
// phase 0 found a rejection cell (the check stays on the device).
// lam: n f32 cells, 4-byte aligned; shift = (address / 4) % 4.
//  mode FULL_MESH: a = n int64 counts, aligned like lam; b, cap unused.
//  mode OCCUPIED_CELLS: a, b = cap int64 cell ids and counts, cap >= 1.
// scratch: SCR_WORDS int64 words, and for the occupied cells one status
// word per tile (ops/threefry_cuda.py poisson_plan), cleared here.
extern "C" int nbk_poisson_threefry(const float* lam, long long n, int shift,
                                    const uint32_t* tables, int klen,
                                    int rlen, long long* a, long long* b,
                                    long long cap, long long* scratch,
                                    int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || shift < 0 || shift >= POISSON_VEC ||
      ((uintptr_t)lam - 4u * shift) % 16 != 0 ||
      (mode == FULL_MESH && ((uintptr_t)a - 8u * shift) % 16 != 0) ||
      (mode == OCCUPIED_CELLS && cap < 1) ||
      (mode != FULL_MESH && mode != OCCUPIED_CELLS))
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + shift + POISSON_TILE - 1) / POISSON_TILE;
  const size_t clear =
      8 * (SCR_WORDS + (mode == OCCUPIED_CELLS ? (size_t)ntiles : 0));
  cudaError_t e = cudaMemsetAsync(scratch, 0, clear, s);
  if (e != cudaSuccess) return (int)e;
  const int smem = poisson_smem(klen, rlen, mode);
  int dev = 0, sms = 132, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto* kernel = mode == FULL_MESH ? poisson_draw_kernel<FULL_MESH>
                                   : poisson_draw_kernel<OCCUPIED_CELLS>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    POISSON_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(ntiles < resident ? ntiles : resident);
  kernel<<<grid, POISSON_THREADS, smem, s>>>(lam, n, shift, ntiles, tables,
                                             klen, rlen, a, b, cap, scratch);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  poisson_idle_kernel<<<grid_for(n, POISSON_THREADS, 16), POISSON_THREADS,
                        0, s>>>(lam, n, tables, klen, rlen, scratch);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (mode == FULL_MESH) {
    poisson_replay_mesh_kernel<<<grid_for(n, POISSON_THREADS, 16),
                                 POISSON_THREADS, 0, s>>>(
        lam, n, tables, klen, a, scratch);
  } else {
    poisson_replay_list_kernel<<<grid_for(cap, POISSON_THREADS, 16),
                                 POISSON_THREADS, 0, s>>>(
        lam, tables, klen, a, b, cap, scratch);
  }
  return (int)cudaGetLastError();
}

// bad: one uint64, worst: one f32, both zeroed by the caller
extern "C" int nbk_poisson_screen_check(unsigned long long* bad, float* worst,
                                        void* stream) {
  screen_check_kernel<<<grid_for(1 << 23, 256, 8), 256, 0,
                        (cudaStream_t)stream>>>(bad, worst);
  return (int)cudaGetLastError();
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
