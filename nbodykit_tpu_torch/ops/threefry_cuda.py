"""Threefry-2x32 draws equal to JAX's: Hopper kernels and plain versions.

The JAX package draws its random numbers with ``jax.random`` under the
partitionable threefry setting (``nbodykit_tpu/rng.py``). XLA computes
them; there is no Pallas kernel to port. Torch has no ``uint32`` add or
shift, so a plain-torch threefry costs about 140 full-array int64
passes per draw. ``csrc/threefry.cu`` does each draw in one pass from
registers instead:

- ``threefry_fill``: element i of a draw is the threefry2x32 hash of the
  64-bit counter ``counter0 + i`` (hi word, lo word) under a key,
  turned into raw 32- or 64-bit bits, a uniform (JAX's mantissa trick,
  ``minval``/``maxval`` through a fused multiply-add as XLA contracts
  it) or a normal (``sqrt(2) * erf_inv(u)`` with XLA's polynomial
  ``erf_inv``). Bound on the H100: integer operations.
- ``poisson_threefry``: JAX's Poisson sampler. JAX runs Knuth's loop
  and the rejection loop over every cell until the last cell is done;
  the kernel gives each cell its own loop over the same chain of
  subkeys, on its own branch only, and stops it when the cell is done.
  The subkey chains are the same for every cell, so they are computed
  once on the host (``poisson_tables``) and passed as tables. Two
  output modes: the int64 count mesh (``poisson_threefry_cuda``; bound:
  bytes) and the occupied cells (``poisson_cells_cuda``): the
  raster-ordered ids and counts of the nonzero cells and their sum,
  compacted in the launch that draws them (bound: the hashes).

The plain versions below repeat the kernels' arithmetic in torch with
int64 words held in [0, 2**32) and are what the CPU uses. The fused
multiply-adds are emulated exactly (``fma``), so a kernel and its plain
version agree bit for bit on the card.
"""

import ctypes
import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

KINDS = ('bits32', 'bits64', 'uniform32', 'uniform64', 'normal32',
         'normal64')
DTYPES = {'bits32': torch.uint32, 'bits64': torch.uint64,
          'uniform32': torch.float32, 'uniform64': torch.float64,
          'normal32': torch.float32, 'normal64': torch.float64}

# lengths of the Poisson sampler's subkey tables, read at each call:
# Knuth's loop takes k + 1 draws for a count k (k <= 40 at lam < 10 has
# a tail of ~1e-13); each rejection iteration accepts with probability
# > 0.8
KNUTH_TABLE = 64
REJECTION_TABLE = 48
# lam at and above which JAX switches to the rejection sampler, and the
# lam its rejection loop runs with in the Knuth cells
KNUTH_MAX = 10.0
REJECTION_IDLE_LAM = 1e5

# the Poisson kernel's geometry (csrc/threefry.cu POISSON_*): threads per
# CTA, cells per vector load, vector loads per thread; one CTA step is a
# tile of POISSON_TILE cells
POISSON_THREADS = 1024
POISSON_VEC = 4
POISSON_UNROLL = 4
POISSON_TILE = POISSON_THREADS * POISSON_VEC * POISSON_UNROLL
# its two output modes, and its scratch words (int64): the rejection
# loop's length, the tables' overflow flag, the hashes used, the counts'
# sum, the list's length, the listed rejection cells whose count is 0,
# the tile ticket
FULL_MESH, OCCUPIED_CELLS = 0, 1
(SCR_ITERS, SCR_OVERFLOW, SCR_HASHES, SCR_TOTAL, SCR_OCCUPIED, SCR_ZEROS,
 SCR_TICKET) = range(7)
SCRATCH_WORDS = 8


def poisson_plan(n, shift=0):
    """Launch geometry of the Poisson kernel for n cells, the first of
    them ``shift`` cells past a 16-byte boundary: ``tile`` (cells per
    CTA step), ``tiles``, ``threads`` (per CTA), ``out_words`` (the full-mesh
    counts' buffer; the counts start ``shift`` words into it, aligned
    like lam), ``scratch_words`` (SCRATCH_WORDS, then one look-back
    status word per tile for the occupied cells) and ``clear_bytes``
    (what the entry point clears before an occupied-cells draw)."""
    n, shift = int(n), int(shift)
    if n < 1 or not 0 <= shift < POISSON_VEC:
        raise ValueError("poisson_plan takes n >= 1 and 0 <= shift < %d, "
                         "got %d, %d" % (POISSON_VEC, n, shift))
    tiles = -(-(n + shift) // POISSON_TILE)
    return dict(threads=POISSON_THREADS, tile=POISSON_TILE, tiles=tiles,
                shift=shift, out_words=n + shift,
                scratch_words=SCRATCH_WORDS + tiles,
                clear_bytes=8 * (SCRATCH_WORDS + tiles))


def cell_capacity(expected, n):
    """List entries for an occupied-cells draw of n cells whose lam sums
    to ``expected``. The counts' sum is Poisson(expected) and bounds the
    occupied cells, so expected + 8 sqrt(expected) + 1024 entries, at
    most n and at least 1; a sum that is not finite and positive gives
    the floor. A longer list is drawn again at its length."""
    s = float(expected)
    s = s if math.isfinite(s) and s > 0 else 0.0
    return int(max(1, min(int(n), math.ceil(s + 8 * math.sqrt(s) + 1024))))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter words (x0, x1) under key words
    (k0, k1), as JAX's ``threefry2x32_p``. Works on Python ints and on
    int64 tensors holding words in [0, 2**32); the key words are
    Python ints."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def split_key(key, num=2):
    """JAX's partitionable ``split``: key i is the hash of counter
    (0, i). Returns a (num, 2) uint32 array."""
    k0, k1 = (int(w) for w in key)
    return np.array([threefry2x32(k0, k1, 0, i) for i in range(num)],
                    dtype=np.uint32).reshape(num, 2)


# -- exact fused multiply-add in torch ----------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """a*b = p + e exactly (Veltkamp splitting; f64)."""
    p = a * b
    ca = a * 134217729.0
    ah = ca - (ca - a)
    al = a - ah
    cb = b * 134217729.0
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_to_odd(s, err):
    """s, rounded to odd: where s = RN(exact) was inexact (err != 0) and
    its last bit is even, step one ulp towards the exact value."""
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(fix, (bits + step).view(torch.float64), s)


def fma(a, b, c):
    """Correctly rounded a*b + c for f32 or f64 tensors (CUDA's
    ``fmaf``/``fma``, and the fused multiply-add XLA emits on the CPU).
    f32: the f64 product is exact and the f64 sum is rounded to odd, so
    the final rounding to f32 is correct. f64: Boldo and Melquiond's
    emulation through rounding to odd (IEEE Trans. Comput. 57, 2008)."""
    if a.dtype == torch.float32:
        p = a.double() * b.double()
        s, e = _two_sum(p, c.double())
        return _round_to_odd(s, e).float()
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, ve = _two_sum(tl, ul)
    return th + _round_to_odd(v, ve)


def _div(a, b):
    """IEEE a / b with a scalar operand made a tensor: torch divides a
    CUDA tensor by a scalar through its reciprocal, and a scalar by a
    tensor as ``reciprocal(b) * a``; the kernel divides."""
    ref = b if isinstance(b, torch.Tensor) else a
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(ref, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(ref, b)
    return torch.div(a, b)


# -- XLA's erf_inv and lgamma, written out --------------------------------

# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011):
# single precision, w < 5 and w >= 5
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
# double precision, w < 6.25, w < 16 and w >= 16
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))


def _horner(coeffs, w):
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = fma(p, w, torch.full_like(w, c))
    return p


def erf_inv(x):
    """XLA's ``erf_inv`` (Giles' polynomials, Horner steps as fused
    multiply-adds): f32 or f64 tensor in, same dtype out; +-inf at +-1.
    """
    w = -torch.log1p(-x * x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        p = torch.empty_like(x)
        for sel, coeffs, wv in ((lt, _ERFINV32[0], lambda v: v - 2.5),
                                (~lt, _ERFINV32[1],
                                 lambda v: torch.sqrt(v) - 3.0)):
            if sel.any():
                p[sel] = _horner(coeffs, wv(w[sel]))
    else:
        b1 = w < 6.25
        b2 = ~b1 & (w < 16.0)
        b3 = ~b1 & ~b2
        p = torch.empty_like(x)
        for sel, coeffs, wv in ((b1, _ERFINV64[0], lambda v: v - 3.125),
                                (b2, _ERFINV64[1],
                                 lambda v: torch.sqrt(v) - 3.25),
                                (b3, _ERFINV64[2],
                                 lambda v: torch.sqrt(v) - 5.0)):
            if sel.any():
                p[sel] = _horner(coeffs, wv(w[sel]))
    out = p * x
    return torch.where(x.abs() == 1, x * math.inf, out)


# Lanczos approximation as XLA writes lgamma (g = 7, 8 terms)
_LANCZOS_G = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)
_LOG_SQRT_2PI = 0.91893853320467274178
_LOG_G_HALF = math.log(_LANCZOS_G + 0.5)


def lgamma_f32(x):
    """log Gamma(x) for f32 x >= 0.5 by XLA's Lanczos sum (the rejection
    sampler evaluates it at k + 1 >= 1 wherever its value decides)."""
    z = x - 1.0
    acc = torch.full_like(x, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        acc = acc + _div(c, (z + float(i)) + 1.0)
    t = z + (_LANCZOS_G + 0.5)
    log_t = torch.log1p(_div(z, _LANCZOS_G + 0.5)) + _LOG_G_HALF
    return fma((z + 0.5) - t / log_t, log_t,
               torch.full_like(x, _LOG_SQRT_2PI)) + torch.log(acc)


# -- the plain fill -------------------------------------------------------

def _uniform_from_words(b1, b2, dtype, minval, maxval):
    """JAX's ``_uniform`` on the hash words: mantissa bits under the
    exponent of 1, minus 1, scaled by one fused multiply-add."""
    if dtype == torch.float32:
        fb = (b1 ^ b2) >> 9 | 0x3F800000
        f = fb.to(torch.int32).view(torch.float32) - 1.0
        lo, hi = np.float32(minval), np.float32(maxval)
    else:
        fb = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        f = fb.view(torch.float64) - 1.0
        lo, hi = np.float64(minval), np.float64(maxval)
    if (lo, hi) == (0, 1):
        return f
    scale = torch.full_like(f, float(hi - lo))
    lo_t = torch.full_like(f, float(lo))
    return torch.maximum(lo_t, fma(f, scale, lo_t))


def _normal_from_uniform(u):
    """``sqrt(2) * erf_inv(u)`` in u's dtype (JAX's ``_normal_real``)."""
    sqrt2 = float(np.sqrt(2).astype(np.float32)) if u.dtype == \
        torch.float32 else math.sqrt(2)
    return erf_inv(u) * sqrt2


def _normal_bounds(dtype):
    npdt = np.float32 if dtype == torch.float32 else np.float64
    return float(np.nextafter(npdt(-1), npdt(0))), 1.0


# elements per step of the plain versions, which bounds their int64
# temporaries (about 40 bytes an element) on a 1024^3 draw
PLAIN_CHUNK = 1 << 24


def _fill_words(b1, b2, kind, minval, maxval):
    if kind == 'bits32':
        return (b1 ^ b2).to(torch.int32).view(torch.uint32)
    if kind == 'bits64':
        # (b1 << 32) | b2 as two's complement int64, without overflow
        hi_s = b1.to(torch.int32).to(torch.int64)
        return (hi_s * 4294967296 + b2).view(torch.uint64)
    dtype = DTYPES[kind]
    if kind.startswith('uniform'):
        return _uniform_from_words(b1, b2, dtype, minval, maxval)
    nlo, nhi = _normal_bounds(dtype)
    return _normal_from_uniform(_uniform_from_words(b1, b2, dtype, nlo, nhi))


def threefry_fill_plain(key, counter0, n, kind, minval=0.0, maxval=1.0,
                        device='cpu'):
    """Plain PyTorch ``threefry_fill``: ``n`` values of ``kind`` for
    counters ``counter0 + i`` under ``key`` (two uint32 words), on
    ``device``, in steps of ``PLAIN_CHUNK`` counters. Bits come as
    uint32 / uint64 tensors, draws as f32 / f64."""
    if kind not in KINDS:
        raise ValueError("kind must be one of %s, got %r" % (KINDS, kind))
    k0, k1 = _check_key(key)
    counter0, n = _check_count(counter0, n)
    out = torch.empty(n, dtype=DTYPES[kind], device=device)
    for a in range(0, n, PLAIN_CHUNK):
        m = min(PLAIN_CHUNK, n - a)
        c = torch.arange(m, dtype=torch.int64, device=device) \
            + (counter0 + a)
        b1, b2 = threefry2x32(k0, k1, c >> 32, c & M32)
        out[a:a + m] = _fill_words(b1, b2, kind, minval, maxval)
    return out


# -- the plain Poisson sampler -------------------------------------------

def poisson_tables(key):
    """The subkey chains of JAX's Poisson sampler under ``key``: Knuth
    iteration j draws with ``knuth[j]`` (``rng, sub = split(rng)``);
    rejection iteration i with ``rejection[i, 0]`` and
    ``rejection[i, 1]`` (``key, sub0, sub1 = split(key, 3)``). Returns
    uint32 arrays of shape (KNUTH_TABLE, 2) and (REJECTION_TABLE, 2,
    2)."""
    knuth = np.empty((KNUTH_TABLE, 2), np.uint32)
    rng = np.asarray(key, np.uint32)
    for j in range(KNUTH_TABLE):
        rng, knuth[j] = split_key(rng)
    rej = np.empty((REJECTION_TABLE, 2, 2), np.uint32)
    k = np.asarray(key, np.uint32)
    for i in range(REJECTION_TABLE):
        k, rej[i, 0], rej[i, 1] = split_key(k, 3)
    return knuth, rej


def _uniform32_at(key, idx):
    k0, k1 = (int(w) for w in key)
    b1, b2 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return _uniform_from_words(b1, b2, torch.float32, 0.0, 1.0)


def _rejection_setup(lam):
    """The per-cell constants of JAX's transformed rejection (Hormann),
    f32, with XLA's fused multiply-adds."""
    f = lambda c: torch.full_like(lam, c)       # noqa: E731
    b = fma(f(2.53), torch.sqrt(lam), f(0.931))
    a = fma(f(0.02483), b, f(-0.059))
    inv_alpha = 1.1239 + _div(1.1328, b - 3.4)
    v_r = 0.9277 - _div(3.6224, b - 2.0)
    return torch.log(lam), b, a, inv_alpha, v_r


def _rejection_step(lam, log_lam, b, a, inv_alpha, v_r, u, v):
    """One iteration of the rejection sampler on uniforms (u, v):
    returns (k, accept)."""
    u = u - 0.5
    us = 0.5 - u.abs()
    k = torch.floor(fma((2.0 * a) / us + b, u, lam) + 0.43)
    s = torch.log(v * inv_alpha / (a / (us * us) + b))
    t = fma(k, log_lam, -lam) - lgamma_f32(k + 1.0)
    accept1 = (us >= 0.07) & (v <= v_r)
    reject = (k < 0) | ((us < 0.013) & (v > us))
    return k, accept1 | (~reject & (s <= t))


class PoissonTableExhausted(RuntimeError):
    """A Poisson cell needed more iterations than the subkey tables
    hold; the draw is refused rather than truncated."""


def _knuth(lam, cells, knuth):
    """Knuth's count at ``cells``: draws until the running f32 sum of
    log u falls to -lam or below; the count is one less. Returns
    (counts, hashes)."""
    neg = -lam
    lp = torch.zeros_like(lam)
    k = torch.zeros(lam.shape, dtype=torch.int64, device=lam.device)
    act = torch.nonzero(lp > neg).reshape(-1)
    hashes = 0
    for j in range(len(knuth) + 1):
        if not act.numel():
            break
        if j == len(knuth):
            raise PoissonTableExhausted(
                "a Knuth cell needs more than %d draws" % len(knuth))
        u = _uniform32_at(knuth[j], cells[act])
        hashes += act.numel()
        lp[act] = lp[act] + torch.log(u)
        k[act] += 1
        act = act[lp[act] > neg[act]]
    return k - 1, hashes


def _rejection_first(lam, cells, rej):
    """The first accepting iteration of each cell. Returns (first,
    hashes)."""
    consts = _rejection_setup(lam)
    first = torch.zeros(lam.shape, dtype=torch.int64, device=lam.device)
    act = torch.arange(lam.numel(), device=lam.device)
    hashes = 0
    for i in range(len(rej) + 1):
        if not act.numel():
            break
        if i == len(rej):
            raise PoissonTableExhausted(
                "a rejection cell needs more than %d iterations" % len(rej))
        u = _uniform32_at(rej[i, 0], cells[act])
        v = _uniform32_at(rej[i, 1], cells[act])
        hashes += 2 * act.numel()
        _, acc = _rejection_step(lam[act], *(c[act] for c in consts), u, v)
        first[act[acc]] = i
        act = act[~acc]
    return first, hashes


def poisson_threefry_plain(key, lam, stats=None):
    """Plain PyTorch ``poisson_threefry``: JAX's ``random.poisson(key,
    lam)`` (lam cast to f32, as JAX does) as int64 counts of lam's
    shape. The kernel's three phases as masked tensor iterations, in
    steps of ``PLAIN_CHUNK`` cells: Knuth's count in its cells and the
    rejection cells' first acceptance; if a rejection cell exists, the
    Knuth cells' first acceptance at lam = 1e5 (JAX's loop runs there
    too, and runs until every cell has accepted once); then each
    rejection cell's k at its last acceptance within that loop.
    ``stats``, a dict, receives the threefry hashes used under
    ``'hashes'``."""
    shape = lam.shape
    lam = lam.to(torch.float32).reshape(-1)
    n = lam.numel()
    knuth, rej = poisson_tables(key)
    out = torch.zeros(n, dtype=torch.int64, device=lam.device)
    hashes, iters = 0, 0
    chunks = [slice(a, min(a + PLAIN_CHUNK, n))
              for a in range(0, n, PLAIN_CHUNK)]

    def cells_of(sl, sel):
        idx = torch.nonzero(sel).reshape(-1)
        return idx, idx + sl.start

    for sl in chunks:                               # phase 0
        lc = lam[sl]
        use_knuth = torch.isnan(lc) | (lc < KNUTH_MAX)
        idx, cells = cells_of(sl, use_knuth)
        counts, h = _knuth(lc[idx], cells, knuth)
        out[sl][idx] = counts
        idx, cells = cells_of(sl, ~use_knuth)
        if idx.numel():
            first, h2 = _rejection_first(lc[idx], cells, rej)
            iters = max(iters, int(first.max()) + 1)
            h += h2
        hashes += h
    if iters:
        for sl in chunks:                           # phase 1
            lc = lam[sl]
            idx, cells = cells_of(sl, torch.isnan(lc) | (lc < KNUTH_MAX))
            if idx.numel():
                first, h = _rejection_first(
                    torch.full((idx.numel(),), REJECTION_IDLE_LAM,
                               device=lam.device), cells, rej)
                iters = max(iters, int(first.max()) + 1)
                hashes += h
        for sl in chunks:                           # phase 2
            lc = lam[sl]
            idx, cells = cells_of(sl, ~(torch.isnan(lc) | (lc < KNUTH_MAX)))
            if not idx.numel():
                continue
            lam_c = lc[idx]
            consts = _rejection_setup(lam_c)
            kout = torch.full_like(lam_c, -1.0)
            for i in range(iters):
                u = _uniform32_at(rej[i, 0], cells)
                v = _uniform32_at(rej[i, 1], cells)
                kk, acc = _rejection_step(lam_c, *consts, u, v)
                kout = torch.where(acc, kk, kout)
            hashes += 2 * iters * idx.numel()
            out[sl][idx] = kout.to(torch.int64)
    out[lam == 0] = 0
    if stats is not None:
        stats['hashes'] = hashes
    return out.reshape(shape)


def poisson_cells_plain(key, lam, stats=None):
    """Plain PyTorch occupied-cells Poisson draw: (ids, counts, N), the
    raster-ordered flat ids of the cells whose count is nonzero, their
    int64 counts and the counts' sum: ``nonzero`` of
    :func:`poisson_threefry_plain`'s counts. ``stats`` receives
    ``'hashes'``."""
    counts = poisson_threefry_plain(key, lam, stats=stats).reshape(-1)
    ids = torch.nonzero(counts).reshape(-1)
    return ids, counts[ids], int(counts.sum())


# -- the kernels ----------------------------------------------------------

_fns = {}


def _lib_fn(name, argtypes):
    fn = _fns.get(name)
    if fn is None:
        from .._build import load
        fn = getattr(load('threefry'), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_key(key):
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError("a threefry key is a (2,) uint32 array, got %s %s"
                         % (key.dtype, key.shape))
    return int(key[0]), int(key[1])


def _check_count(counter0, n):
    counter0, n = int(counter0), int(n)
    if n < 0 or counter0 < 0 or counter0 + n > 2 ** 63:
        raise ValueError("counters [%d, %d) outside [0, 2**63)"
                         % (counter0, counter0 + n))
    return counter0, n


def threefry_fill_cuda(key, counter0, n, kind, minval=0.0, maxval=1.0,
                       device='cuda'):
    """``threefry_fill`` on the CUDA kernel (``csrc/threefry.cu``): a
    new tensor of ``n`` values on ``device``. Same contract as
    :func:`threefry_fill_plain`, bit-identical output."""
    from .._build import check
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError("threefry_fill_cuda runs on a CUDA device")
    if kind not in KINDS:
        raise ValueError("kind must be one of %s, got %r" % (KINDS, kind))
    k0, k1 = _check_key(key)
    counter0, n = _check_count(counter0, n)
    out = torch.empty(n, dtype=DTYPES[kind], device=device)
    if n == 0:
        return out
    if kind.startswith('normal'):
        minval, maxval = _normal_bounds(DTYPES[kind])
    npdt = np.float32 if DTYPES[kind] == torch.float32 else np.float64
    lo, hi = npdt(minval), npdt(maxval)
    fn = _lib_fn('nbk_threefry_fill',
                 [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
                  ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
                  ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(device).cuda_stream
    check('threefry', fn(k0, k1, counter0, n, KINDS.index(kind),
                         float(lo), float(hi - lo), out.data_ptr(), stream))
    threefry_fill_cuda.launches += 1
    return out


threefry_fill_cuda.launches = 0


def threefry_fill(key, counter0, n, kind, minval=0.0, maxval=1.0,
                  device=None):
    """``threefry_fill`` dispatched on ``device`` (default: the
    ``device`` option, else ``cuda``): the plain version on the CPU, the
    CUDA kernel on a CUDA device."""
    from .. import resolve_device
    device = resolve_device(device)
    if device.type == 'cpu':
        return threefry_fill_plain(key, counter0, n, kind, minval, maxval,
                                   device)
    if device.type == 'cuda':
        return threefry_fill_cuda(key, counter0, n, kind, minval, maxval,
                                  device)
    raise ValueError("no threefry_fill for device %s" % device)


_tables = {}


def _device_tables(key, device):
    """The subkey tables of :func:`poisson_tables` as one int32 tensor
    on ``device`` (Knuth's, then the rejection sampler's), kept for the
    last few keys: the chains cost ~3 ms of host hashing."""
    k0, k1 = _check_key(key)
    ident = (k0, k1, KNUTH_TABLE, REJECTION_TABLE, str(device))
    t = _tables.get(ident)
    if t is None:
        knuth, rej = poisson_tables(key)
        t = torch.from_numpy(np.concatenate(
            [knuth.reshape(-1), rej.reshape(-1)]).view(np.int32)).to(device)
        if len(_tables) >= 16:
            _tables.pop(next(iter(_tables)))
        _tables[ident] = t
    return t


def _lam32(lam):
    """lam as a flat f32 tensor (a view where it already is one) and its
    cells' offset from 16-byte alignment, in cells."""
    lam32 = lam.to(torch.float32).contiguous().reshape(-1)
    return lam32, (lam32.data_ptr() // 4) % POISSON_VEC


def _poisson_launch(key, lam32, shift, mode, a, b, cap, scratch):
    """One call of the kernel's three phases on the current stream;
    ``scratch``'s first SCRATCH_WORDS words hold the results."""
    from .._build import check
    tables = _device_tables(key, lam32.device)
    fn = _lib_fn('nbk_poisson_threefry',
                 [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(lam32.device).cuda_stream
    check('threefry', fn(lam32.data_ptr(), lam32.numel(), shift,
                         tables.data_ptr(), KNUTH_TABLE, REJECTION_TABLE,
                         a.data_ptr(), 0 if b is None else b.data_ptr(),
                         cap, scratch.data_ptr(), mode, stream))


def _require_cuda(name, lam):
    if not isinstance(lam, torch.Tensor) or lam.device.type != 'cuda':
        raise ValueError("%s takes a CUDA tensor" % name)


def poisson_threefry_cuda(key, lam, stats=None):
    """``poisson_threefry`` on the CUDA kernel, full-mesh mode. Same
    contract as :func:`poisson_threefry_plain`, bit-identical counts.
    It reads the scratch words back once (the tables' overflow flag,
    with the hash count), so the call synchronizes with the stream."""
    _require_cuda('poisson_threefry_cuda', lam)
    shape = lam.shape
    lam32, shift = _lam32(lam)
    n = lam32.numel()
    if n == 0:
        return torch.empty(shape, dtype=torch.int64, device=lam.device)
    plan = poisson_plan(n, shift)
    # the counts start `shift` words into their buffer, so that they are
    # 16-byte aligned where lam is
    out = torch.empty(plan['out_words'], dtype=torch.int64,
                      device=lam.device)[shift:]
    scratch = torch.empty(SCRATCH_WORDS, dtype=torch.int64,
                          device=lam.device)
    _poisson_launch(key, lam32, shift, FULL_MESH, out, None, 0, scratch)
    poisson_threefry_cuda.launches += 1
    w = scratch.cpu().numpy()
    if w[SCR_OVERFLOW]:
        raise PoissonTableExhausted(
            "a Poisson cell needed more iterations than the tables hold "
            "(Knuth %d, rejection %d)" % (KNUTH_TABLE, REJECTION_TABLE))
    if stats is not None:
        stats['hashes'] = int(w[SCR_HASHES])
    return out.reshape(shape)


poisson_threefry_cuda.launches = 0


def _collect_cells(run, cap, stats):
    """The occupied-cells wrapper's side of the kernel's protocol.
    ``run(cap)`` launches once into lists of ``cap`` entries and returns
    (ids, counts, scratch words); a list longer than ``cap`` is drawn
    again at its reported length (same bits), and listed rejection cells
    whose count came out 0 are dropped. Returns (ids, counts, N)."""
    runs = 0
    while True:
        ids, cnts, w = run(cap)
        runs += 1
        if w[SCR_OVERFLOW]:
            raise PoissonTableExhausted(
                "a Poisson cell needed more iterations than the tables "
                "hold (Knuth %d, rejection %d)"
                % (KNUTH_TABLE, REJECTION_TABLE))
        occupied = int(w[SCR_OCCUPIED])
        if occupied <= cap:
            break
        cap = occupied
    ids, cnts = ids[:occupied], cnts[:occupied]
    if w[SCR_ZEROS]:
        keep = cnts != 0
        ids, cnts = ids[keep], cnts[keep]
    if stats is not None:
        stats.update(hashes=int(w[SCR_HASHES]), runs=runs, capacity=cap)
    return ids, cnts, int(w[SCR_TOTAL])


def poisson_cells_cuda(key, lam, expected, stats=None):
    """:func:`poisson_cells_plain` on the CUDA kernel, occupied-cells
    mode: the list and N from the launch that draws the counts, with no
    count mesh; bit-identical to the plain version. ``expected``, the
    sum of lam (which a caller that normalized lam knows), sizes the
    list (:func:`cell_capacity`). Each launch reads its scratch words
    (list length, N, overflow flag) back once; a list longer than its
    capacity is drawn again at the reported length. ``stats`` receives
    ``'hashes'``, ``'runs'`` (launches) and ``'capacity'``."""
    _require_cuda('poisson_cells_cuda', lam)
    lam32, shift = _lam32(lam)
    n = lam32.numel()
    if n == 0:
        empty = torch.empty(0, dtype=torch.int64, device=lam.device)
        return empty, empty.clone(), 0
    plan = poisson_plan(n, shift)
    scratch = torch.empty(plan['scratch_words'], dtype=torch.int64,
                          device=lam.device)

    def run(cap):
        ids = torch.empty(cap, dtype=torch.int64, device=lam.device)
        cnts = torch.empty(cap, dtype=torch.int64, device=lam.device)
        _poisson_launch(key, lam32, shift, OCCUPIED_CELLS, ids, cnts, cap,
                        scratch)
        poisson_cells_cuda.launches += 1
        return ids, cnts, scratch[:SCRATCH_WORDS].cpu().numpy()

    return _collect_cells(run, cell_capacity(expected, n), stats)


poisson_cells_cuda.launches = 0


def poisson_screen_check(device='cuda'):
    """The margin of the kernel's ``__logf`` screen, over every uniform
    Knuth's first step can draw (k 2^-23, 0 < k < 2^23), on the card:
    (how many exceed half the margin, the largest |__logf(u) - logf(u)|
    over the margin). The screen is sound when the first is 0."""
    from .._build import check
    if torch.device(device).type != 'cuda':
        raise ValueError("poisson_screen_check runs on a CUDA device")
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    worst = torch.zeros(1, dtype=torch.float32, device=device)
    fn = _lib_fn('nbk_poisson_screen_check', [ctypes.c_void_p] * 3)
    check('threefry', fn(bad.data_ptr(), worst.data_ptr(),
                         torch.cuda.current_stream(device).cuda_stream))
    return int(bad), float(worst)


def poisson_threefry(key, lam, stats=None):
    """JAX's ``random.poisson(key, lam)`` dispatched on lam's device."""
    if lam.device.type == 'cpu':
        return poisson_threefry_plain(key, lam, stats=stats)
    if lam.device.type == 'cuda':
        return poisson_threefry_cuda(key, lam, stats=stats)
    raise ValueError("no poisson_threefry for device %s" % lam.device)


def poisson_cells(key, lam, expected, stats=None):
    """(ids, counts, N) of JAX's ``random.poisson(key, lam)`` reduced to
    its occupied cells, dispatched on lam's device; ``expected``, the
    sum of lam, sizes the kernel's list."""
    if lam.device.type == 'cpu':
        return poisson_cells_plain(key, lam, stats)
    if lam.device.type == 'cuda':
        return poisson_cells_cuda(key, lam, expected, stats)
    raise ValueError("no poisson_cells for device %s" % lam.device)
