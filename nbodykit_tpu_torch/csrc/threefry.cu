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
// poisson_kernel: JAX's random.poisson (jax/_src/random.py _poisson) on f32
// lam. JAX runs Knuth's loop and the transformed-rejection loop over every
// cell until the last cell is done. A cell's draw at iteration j is a
// uniform under subkey j at the cell's counter, and the subkey chains are
// the same for every cell, so the host passes them as tables and each
// thread runs its own cell's loop:
//   phase 0  Knuth cells (lam < 10 or NaN): the count, stopping when done.
//            Rejection cells: their first accepting iteration; the loop
//            length JAX reaches is max(first) + 1 over all cells, kept in
//            scratch[0] by atomicMax.
//   phase 1  only if a rejection cell exists: the Knuth cells' first
//            acceptance in the rejection loop, which JAX runs with
//            lam = 1e5 there, also bounds the loop length.
//   phase 2  only if a rejection cell exists: JAX keeps the k of the LAST
//            accepting iteration before its loop ends; each rejection cell
//            replays the loop to that length.
// A cell that runs past a table sets scratch[1]; the wrapper raises. The
// threefry hashes used are summed into scratch[2:4] for the bound.
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
#define POISSON_THREADS 256

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

__device__ __forceinline__ float uniform_at(const uint32_t* key,
                                            unsigned long long cell) {
  uint32_t h1 = (uint32_t)(cell >> 32), h2 = (uint32_t)cell;
  threefry(schedule(key[0], key[1]), h1, h2);
  return unit32(h1, h2);
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
__device__ __forceinline__ int rejection_first(float lam, const uint32_t* rej,
                                               int rlen,
                                               unsigned long long cell) {
  const Rejection r = rejection_setup(lam);
  float k;
  for (int i = 0; i < rlen; ++i)
    if (rejection_step(r, rej + 4 * i, cell, &k)) return i;
  return -1;
}

__global__ void __launch_bounds__(POISSON_THREADS)
poisson_kernel(const float* __restrict__ lam, long long n,
               const uint32_t* __restrict__ tables, int klen, int rlen,
               long long* __restrict__ out, int* scratch, int phase) {
  const uint32_t* knuth = tables;
  const uint32_t* rej = tables + 2 * klen;  // (rlen, 2 subkeys, 2 words)
  const int iters = phase > 0 ? *(volatile int*)scratch : 0;
  if (phase > 0 && iters == 0) return;      // no rejection cell
  unsigned long long hashes = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float l = lam[i];
    const bool knuth_cell = isnan(l) || l < 10.0f;
    const unsigned long long cell = (unsigned long long)i;
    if (phase == 0 && knuth_cell) {
      const float neg = -l;
      float lp = 0.0f;
      int k = 0;
      while (lp > neg) {
        if (k == klen) {
          scratch[1] = 1;
          break;
        }
        lp = lp + logf(uniform_at(knuth + 2 * k, cell));
        ++k;
      }
      hashes += k;
      out[i] = l == 0.0f ? 0 : (long long)(k - 1);
    } else if ((phase == 0 && !knuth_cell) || (phase == 1 && knuth_cell)) {
      const int first = rejection_first(knuth_cell ? 1e5f : l, rej, rlen,
                                        cell);
      if (first < 0) {
        scratch[1] = 1;
        hashes += 2ull * rlen;
      } else {
        atomicMax(scratch, first + 1);
        hashes += 2ull * (first + 1);
      }
    } else if (phase == 2 && !knuth_cell) {
      const Rejection r = rejection_setup(l);
      float k_out = -1.0f, k;
      for (int it = 0; it < iters; ++it)
        if (rejection_step(r, rej + 4 * it, cell, &k)) k_out = k;
      hashes += 2ull * iters;
      out[i] = (long long)k_out;
    }
  }
  hashes = __reduce_add_sync(0xFFFFFFFFu, (unsigned)hashes);
  if ((threadIdx.x & 31) == 0 && hashes)
    atomicAdd((unsigned long long*)(scratch + 2), hashes);
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

// scratch: 4 ints, zeroed by the caller: [0] the rejection loop's length,
// [1] table overflow flag, [2:4] threefry hashes used (uint64)
extern "C" int nbk_poisson_threefry(const float* lam, long long n,
                                    const uint32_t* tables, int klen,
                                    int rlen, long long* out, int* scratch,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  const int grid = grid_for(n, POISSON_THREADS, 16);
  for (int phase = 0; phase < 3; ++phase) {
    poisson_kernel<<<grid, POISSON_THREADS, 0, s>>>(lam, n, tables, klen,
                                                    rlen, out, scratch, phase);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
