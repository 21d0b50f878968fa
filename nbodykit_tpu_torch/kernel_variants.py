"""Time the design steps of the hand-written kernels on one CUDA card.

Each variant is a kernel source of ``csrc/`` with one design step taken
back by a text substitution. The variants are built with the same
``nvcc`` flags as the kernels, into ``_build/variants/``, and timed
beside the kernel as built at the main path's shapes: the rank pass on
9,998,863 int32 digits of alphabet 65, the deposit on the CIC payload
of ``UniformCatalog(nbar=1e-2, BoxSize=1000, seed=42)`` at 512^3, the
Poisson draw (both output modes) on the lognormal path's 1024^3 lam,
the FOF's link count, link fill and search sweep on the FOF flow's grid,
a clustered 2e6 catalog and FiberCollisions' sparse sphere grid, the
pair count's '1d' and '2d' counts of the particles path's boss_like
sample and the 3PCF moments of its first chunk (65,536 queries). The
first designs of the particle kernels and of the FOF link kernels, and
the link kernels' tile design, are whole sources under
``csrc/variants/``, timed as variants of the kernels they were (with
probes that take one of their elements out, whose results differ); a
case whose function a library does not define (the link kernels' first
design has no search sweep) skips it. Every output starts as -1 (no
count, slot or label) and is reset after each check, so a launch that
writes nothing does not match. Run from the repository root on a CUDA
machine::

    python -m nbodykit_tpu_torch.kernel_variants [kernel ...]

(kernels: radix_rank, paint_deposit, poisson, fof_sweep, paircount,
threept, pipes; default all). It
prints one JSON line per timing: the mean CUDA-event time of 20
launches into preallocated outputs, the kernels in turn (as built,
each variant, as built again), and whether the variant's result
matches (ranks and counts bit for bit, blocks within 1e-5 of their
maximum, pair counts bit for bit and their sums within 1e-12). The Poisson case also times the occupied cells as the
full-mesh draw followed by ``nonzero`` (the compaction unfused). The
``pipes`` probe runs loops of ALU-pipe (LOP3, SHF) and FMA-pipe (IMAD)
instructions, alone and together, one CTA per SM, and prints their
results per clock per SM: whether the two pipes issue side by side.
Without CUDA it exits 1.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

from . import _build

VARIANT_DIR = os.path.join(_build.BUILD_DIR, 'variants')

BALLOT_PEERS = '''    unsigned peers = 0xffffffffu;
    for (int b = 0; b < nbits; ++b) {
      const unsigned bit = (key >> b) & 1u;
      const unsigned m = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? m : ~m;
    }'''
FAST_PMOD = '''  int r = a;
  if (r < 0) r += n;
  if (r >= n) r -= n;
  if ((unsigned)r < (unsigned)n) return r;
  r = a % n;'''

# the Poisson draw's lam loads and count stores cell by cell, for any
# POISSON_VEC
SCALAR_IO = [
    ('''  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  l[0] = q.x, l[1] = q.y, l[2] = q.z, l[3] = q.w;''',
     '  for (int v = 0; v < POISSON_VEC; ++v) l[v] = __ldcs(p + v);'),
    ('''  __stcs(reinterpret_cast<longlong2*>(p), make_longlong2(c[0], c[1]));
  __stcs(reinterpret_cast<longlong2*>(p + 2), make_longlong2(c[2], c[3]));''',
     '  for (int v = 0; v < POISSON_VEC; ++v)\n'
     '    __stcs(p + v, (long long)c[v]);')]
VEC4_ASSERT = ('static_assert(POISSON_VEC == 4, "load_cells and store_counts '
               'move 4 cells");')

# the FOF traversal's loop over the neighbour columns, one at a time
FOF_COLUMN_LOOP = '''  for (int q = 0; q < 9; ++q) {
    const int ka = q / 3, kb = q % 3;
    if (ka >= ca.m || kb >= cb.m) continue;
    const int col = ca.v[ka] * nc1 + cb.v[kb];
    const K base = (K)col * nc2;
    const int end = cols[col + 1];
    const int lo = lower_bound<K>(flat, cols[col], end, base + (K)rc.lo0);
    const int j = walk<F, K>(g, pos, flat, lo, n, base + (K)rc.hi0, px, py,
                             pz, visit);
    if (rc.m == 2)
      walk<F, K>(g, pos, flat, lower_bound<K>(flat, j, end, base + (K)rc.lo1),
                 n, base + (K)rc.hi1, px, py, pz, visit);
  }'''


def fof_columns_side_by_side(lanes):
    """The same loop with ``lanes`` columns' table loads and first
    searches advancing in lockstep, then their walks in turn."""
    return '''  for (int q0 = 0; q0 < 9; q0 += LANES) {
    int col[LANES], lo[LANES], hi[LANES];
#pragma unroll
    for (int t = 0; t < LANES; ++t) {
      const int ka = (q0 + t) / 3, kb = (q0 + t) % 3;
      col[t] = ka < ca.m && kb < cb.m ? ca.v[ka] * nc1 + cb.v[kb] : -1;
      const int c = col[t] < 0 ? 0 : col[t];
      lo[t] = cols[c];
      hi[t] = col[t] < 0 ? lo[t] : cols[c + 1];
    }
    bool more = true;
    while (more) {
      more = false;
#pragma unroll
      for (int t = 0; t < LANES; ++t) {
        if (lo[t] < hi[t]) {
          const int mid = (int)(((unsigned)lo[t] + (unsigned)hi[t]) >> 1);
          if (flat[mid] < (K)col[t] * nc2 + (K)rc.lo0) lo[t] = mid + 1;
          else hi[t] = mid;
          more |= lo[t] < hi[t];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < LANES; ++t) {
      if (col[t] < 0) continue;
      const K base = (K)col[t] * nc2;
      const int j = walk<F, K>(g, pos, flat, lo[t], n, base + (K)rc.hi0, px,
                               py, pz, visit);
      if (rc.m == 2)
        walk<F, K>(g, pos, flat,
                   lower_bound<K>(flat, j, cols[col[t] + 1],
                                  base + (K)rc.lo1),
                   n, base + (K)rc.hi1, px, py, pz, visit);
    }
  }'''.replace('LANES', str(int(lanes)))


# the first designs' binary search over the edges, and a stand-in of one
# compare (a probe: wrong bins)
SEARCH_DIGITIZE = '''  int lo = 0, hi = nedges;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;'''
CHEAP_DIGITIZE = '  return x < e[nedges - 1] ? 1 : nedges;'
# parts of the redesigned kernels that the probes drop
PRIVATE_ADDS = '''        pw[k * PC_THREADS] += zw.y;
        atomicAdd(pn + k, 1u);
'''
TABLE_ROW = '''        const int k =
            r2 < efirst ? 0 : table_digitize<ONE_STEP>(e, tab, g.tab, r2);
'''
YLM_CALL = '''  if (lane < np)
    all_ylm<LMAX>(g.lmax, tb.lbase, tb.norms, tb.wmm, tb.rcp, wm.qx[lane],
                  wm.qy[lane], wm.qz[lane], wm.qw[lane],
                  wm.ys + lane * g.nlm);
'''
# the 3PCF drain on the tensor cores, and the same with a switch on each
# pair's bin into a lane's register row
MMA_DRAIN = '''  if (REG) {
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
'''
SWITCH_DRAIN = '''  if (REG) {
    for (int p = 0; p < np; ++p) {
      const int b = wm.qb[p];
      const double v = lane < g.nlm ? wm.ys[p * g.nlm + lane] : 0.0;
      switch (b) {
#define TA_CASE(k) case k: acc[k] += v; break;
        TA_CASE(0) TA_CASE(1) TA_CASE(2) TA_CASE(3) TA_CASE(4) TA_CASE(5)
        TA_CASE(6) TA_CASE(7) TA_CASE(8) TA_CASE(9) TA_CASE(10) TA_CASE(11)
        TA_CASE(12) TA_CASE(13) TA_CASE(14) TA_CASE(15)
#undef TA_CASE
        default: break;
      }
    }
'''
MMA_OUT = '''#pragma unroll
        for (int i = 0; i < TA_NB; ++i) {
          const int lm = 8 * (i / 4) + (lane >> 2);
          const int b = 8 * ((i / 2) % 2) + 2 * (lane & 3) + i % 2;
          if (lm < g.nlm && b < g.nbins) wm.ys[lm * g.nbins + b] = acc[i];
        }
'''
ROWS_OUT = '''        if (lane < g.nlm) {
#pragma unroll
          for (int b = 0; b < TA_NB; ++b)
            if (b < g.nbins) wm.ys[lane * g.nbins + b] = acc[b];
        }
'''
# the redesigned kernels' table lookup replaced by that search
GRID_INCLUDE = '#include "grid_columns.cuh"\n'
SEARCH_TABLE = ('template <bool ONE_STEP>\n'
                '__device__ __forceinline__ int search_table_digitize('
                'const double* __restrict__ e, const int4* __restrict__, '
                'const BinTable& t, double x) {\n'
                '  const int nedges = t.nedges;\n'
                + SEARCH_DIGITIZE + '\n}\n'
                '#define table_digitize search_table_digitize\n')
WARP_ADD_BODY = '''  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(full, bin);'''
NO_WARP_ADD = '''  if (bin == 0x7fffffff) hn[0] = (unsigned long long)w;
  return;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(full, bin);'''
THREEPT_NO_DIVISIONS = [
    ('(double)(l + m - 1) * Wp) / (double)(l - m);',
     '(double)(l + m - 1) * Wp) * (double)(l - m);'),
    ('''          ux = dx / rr;
          uy = dy / rr;
          uz = dz / rr;''', '''          ux = dx * rr;
          uy = dy * rr;
          uz = dz * rr;''')]
DRAIN_ADD = ('    for (int t = lane; t < g.nlm; t += 32) '
             'wm.acc[t * g.nbins + b] += y[t] * w;\n')


# name: (source, [(text, replacement)], what the substitution takes back)
VARIANTS = {
    'rank_match_any': ('radix_rank', [
        (BALLOT_PEERS,
         '    const unsigned peers = __match_any_sync(0xffffffffu, key);')],
        'peer masks from __match_any_sync instead of one ballot per bit'),
    'rank_256_threads': ('radix_rank', [
        ('#define RANK_THREADS 512', '#define RANK_THREADS 256')],
        'CTAs of 256 threads and 4096 digits'),
    'rank_one_load_in_flight': ('radix_rank', [
        ('#define SUM_BATCH 8 ', '#define SUM_BATCH 1 ')],
        'look-back sums with one load in flight per thread'),
    'rank_no_min_blocks': ('radix_rank', [
        ('__launch_bounds__(RANK_THREADS, 3)',
         '__launch_bounds__(RANK_THREADS)')],
        'no register cap for three resident CTAs per SM'),
    'deposit_pmod_division': ('paint_deposit', [
        (FAST_PMOD, '  int r = a % n;')],
        'every window index wrapped by an integer division'),
    'deposit_generic_atomics': ('paint_deposit', [
        ('          atomicAdd(tile + col * zc + zl[c], w * tm.wz[c]);',
         '          { A* g = tile; asm volatile("" : "+l"(g));'
         ' atomicAdd(g + col * zc + zl[c], w * tm.wz[c]); }')],
        'atomics through a pointer the compiler cannot see is shared'),
    'deposit_no_staging': ('paint_deposit', [
        ('#define STAGE_WORDS 56 ', '#define STAGE_WORDS 7 ')],
        'one slot a thread loaded while the copies drain, the rest '
        'loaded in the deposit'),
    'poisson_scalar_loads': ('threefry', SCALAR_IO,
        'scalar loads of lam and scalar stores of the counts, the same 16 '
        'cells a thread in flight and the same tiles, not float4 loads '
        'and longlong2 stores'),
    'poisson_four_cells_a_thread': ('threefry', SCALAR_IO + [
        ('#define POISSON_VEC 4 ', '#define POISSON_VEC 1 '),
        (VEC4_ASSERT, '')],
        'four scalar cells a thread (a quarter of the loads in flight) and '
        'tiles of 4096 cells, not four float4 loads and tiles of 16384'),
    'poisson_one_load_in_flight': ('threefry', SCALAR_IO + [
        ('#define POISSON_VEC 4 ', '#define POISSON_VEC 1 '),
        ('#define POISSON_UNROLL 4 ', '#define POISSON_UNROLL 1 '),
        (VEC4_ASSERT, '')],
        'one cell per thread per step: one scalar load in flight'),
    'poisson_subkey_reload': ('threefry', [
        ('for (int v = 0; v < POISSON_VEC; ++v) threefry(ks0, h1[v], h2[v]);',
         'for (int v = 0; v < POISSON_VEC; ++v) { int z;'
         ' asm volatile("mov.u32 %0, 0;" : "=r"(z));'
         ' threefry(schedule(tables[2 * z], tables[2 * z + 1]), h1[v],'
         ' h2[v]); }')],
        'iteration 0\'s subkey loaded and its key schedule rebuilt for '
        'every cell'),
    'poisson_no_screen': ('threefry', [
        ('  const float g = __logf(u);\n'
         '  return g + screen_margin(g) <= neg;',
         '  return !(logf(u) > neg);')],
        'the exact logf for every cell\'s first step, no __logf screen'),
    'poisson_256_threads': ('threefry', [
        ('#define POISSON_THREADS 1024', '#define POISSON_THREADS 256')],
        'CTAs of 256 threads and tiles of 4096 cells'),
    # probes of a step not taken: the neighbour columns' searches side by
    # side (slower on the H100; the kernel takes one column at a time)
    'fof_nine_columns_side_by_side': ('fof_sweep', [
        (FOF_COLUMN_LOOP, fof_columns_side_by_side(9))],
        'the 9 neighbour columns\' table loads and searches side by side, '
        'not one column after another'),
    'fof_three_columns_side_by_side': ('fof_sweep', [
        (FOF_COLUMN_LOOP, fof_columns_side_by_side(3))],
        'the neighbour columns\' table loads and searches three at a time '
        '(one row of the table), not one column after another'),
    'paircount_overflow_row_by_groups': ('variants/paircount_first_design', [
        ('''    if (ONE_COLUMN && bin == g.nb1 + 1) {
      far_n += 1;
      far_w += w;
      bin = -1;
    }
''', '')],
        'the first design\'s step: the overflow row of a one-column count '
        'through the warp step\'s groups (a shuffle loop over ~27 lanes), '
        'not in the lanes\' registers'),
    # the redesigned particle kernels, one element taken back each
    'paircount_binary_search_bin': ('paircount', [
        (GRID_INCLUDE, GRID_INCLUDE + SEARCH_TABLE)],
        'the bin inside the edges by a binary search over them, not the '
        'bucket table and its walk'),
    'paircount_every_pair_twice': ('paircount', [
        ('  g.self = each_pair_once;', '  g.self = 0;')],
        'an auto count of the grid\'s points counts every pair from both '
        'ends, not once and doubled'),
    'paircount_image_everywhere': ('paircount', [
        ('const bool image = run_im[r];', 'const bool image = g.periodic;')],
        'the minimum image tested on every candidate of a periodic grid, '
        'not only on the runs where it can change a separation'),
    'paircount_far_row_by_atomics': ('paircount', [
        ('''        if (r2 >= elast) {
          pw[col * PC_THREADS] += zw.y;
          atomicAdd(pn + col, 1u);
        } else {
          const int bin = (r2 < efirst ? 0
                                       : table_digitize<ONE_STEP>(
                                             e, tab, g.tab, r2)) *
                              g.nb2 +
                          col;''', '''        {
          const int bin = row_of<ONE_STEP>(g, e, tab, r2) * g.nb2 + col;''')],
        '\'2d\': the overflow row through the warp\'s copy and its shared '
        'atomics, not the thread\'s own columns'),
    'paircount_mu_exact': ('paircount', [
        ('if (frac > eps && frac < 1.0f - eps && t < 8388608.0f) {',
         'if (false) {')],
        '\'2d\': every column by the f64 sqrt and division, not the f32 '
        'estimate'),
    'paircount_walk_loop': ('paircount', [
        ('  const int one = tab_steps <= 1;', '  const int one = 0;')],
        'the table\'s walk as a loop, not one compare'),
    'threept_moments_in_shared_memory': ('threept_alm', [
        ('  return nbins <= TA_NB && lmax <= TA_LMAX;', '  return 0;')],
        'the moments in shared memory, a lane a row read-modify-written '
        'for every pair, not in the lanes\' registers'),
    'threept_divisions': ('threept_alm', [
        ('(double)(l + m - 1) * Wp) * rcp[l - m];',
         '(double)(l + m - 1) * Wp) / (double)(l - m);'),
        ('''        const double inv = 1.0 / sqrt(r2);
        ux = dx * inv;
        uy = dy * inv;
        uz = dz * inv;''', '''        const double rr = sqrt(r2);
        ux = dx / rr;
        uy = dy / rr;
        uz = dz / rr;''')],
        'f64 divisions by (l - m) in the recurrence and three by |d| for '
        'the unit vector, not products with reciprocals'),
    'threept_binary_search_bin': ('threept_alm', [
        (GRID_INCLUDE, GRID_INCLUDE + SEARCH_TABLE)],
        'the bin inside the edges by a binary search over them, not the '
        'bucket table and its walk'),
    'threept_drain_by_switch': ('threept_alm', [
        (MMA_DRAIN, SWITCH_DRAIN), (MMA_OUT, ROWS_OUT)],
        'each drained pair added into a lane\'s register row (lm = lane) '
        'through a switch on the pair\'s bin, not the batch on the FP64 '
        'tensor cores'),
    'threept_ylm_loops': ('threept_alm', [
        ('  const int lmax = LMAX >= 0 ? LMAX : lmax_rt;',
         '  const int lmax = lmax_rt;')],
        'the recurrences of all_ylm as loops over a run-time lmax, not '
        'unrolled at the register path\'s lmax'),
    'threept_walk_loop': ('threept_alm', [
        ('  const int one = tab_steps <= 1;', '  const int one = 0;')],
        'the table\'s walk as a loop, not one compare'),
    'threept_image_everywhere': ('threept_alm', [
        ('          if (run_im[r])', '          if (g.periodic)')],
        'the minimum image tested on every candidate of a periodic grid, '
        'not only on the runs where it can change a separation'),
    # the FOF sweeps' division skip taken back (every kernel of the source)
    'fof_divide_always': ('fof_sweep', [
        ('  return magnitude(d) > qbox ? d - round_even(d / box) * box : d;',
         '  return d - round_even(d / box) * box;')],
        'the minimum image divided on every periodic candidate, not only '
        'past a quarter box'),
    # the FOF link kernels' earlier designs (csrc/variants/), whole
    'fof_links_first_design': ('variants/fof_links_first_design', [],
        'the first design: the kernels as built without the division '
        'skip, three divisions a periodic candidate'),
    'fof_links_tiles': ('variants/fof_links_tiles', [],
        'the tile design: 128 consecutive queries a CTA in rounds, their '
        'neighbour columns\' keys, column-table entries and cell masks '
        'staged in shared memory, each query walking the columns its '
        'masks hit; a sparse round walks global memory'),
    # the particle kernels' first designs (csrc/variants/), whole
    'paircount_first_design': ('variants/paircount_first_design', [],
        'the first design: a warp a query, its neighbour runs found by '
        'binary searches per query, the bin by a binary search over the '
        'edges, one histogram a CTA fed by __match_any_sync groups'),
    'threept_first_design': ('variants/threept_alm_first_design', [],
        'the first design: a warp a query, per-query run searches, the bin '
        'by a binary search, the moments in shared memory (a lane a row, '
        'read-modify-write), f64 divisions in the recurrence and the unit '
        'vector'),
    # probes of the first designs, not designs (their results differ):
    # what each element of them costs
    'probe_paircount_first_no_bin_search': (
        'variants/paircount_first_design', [(SEARCH_DIGITIZE, CHEAP_DIGITIZE)],
        'the binary search over the edges replaced by one compare (wrong '
        'bins): what the search costs'),
    'probe_paircount_first_no_group_add': (
        'variants/paircount_first_design', [(WARP_ADD_BODY, NO_WARP_ADD)],
        'the warp step\'s match/shuffle groups and shared atomics dropped '
        '(no histogram): what the aggregation costs'),
    'probe_threept_first_no_bin_search': (
        'variants/threept_alm_first_design',
        [(SEARCH_DIGITIZE, CHEAP_DIGITIZE)],
        'the binary search over the edges replaced by one compare (wrong '
        'bins): what the search costs'),
    'probe_threept_first_no_divisions': (
        'variants/threept_alm_first_design', THREEPT_NO_DIVISIONS,
        'every f64 division multiplied instead (wrong values): what the '
        'divisions cost'),
    'probe_threept_first_no_drain_adds': (
        'variants/threept_alm_first_design', [(DRAIN_ADD, '')],
        'the drain\'s shared read-modify-writes dropped (the harmonics '
        'still computed and stored): what the adds cost'),
    # probes of the redesigned kernels, not designs (their results
    # differ): what each part of the '1d' loop and of the 3PCF costs
    'probe_paircount_no_private_adds': ('paircount', [
        (PRIVATE_ADDS, '        q.far_n += (unsigned)k;\n')],
        'the in-range pairs\' shared read-modify-writes dropped (the bin '
        'still found)'),
    'probe_paircount_no_table': ('paircount', [
        (TABLE_ROW, '        const int k = 0;\n')],
        'the in-range pairs\' table lookup dropped (row 0)'),
    'probe_paircount_far_only': ('paircount', [
        ('      if (ok && r2 < elast) {', '      if (false) {')],
        'nothing done for the in-range pairs: the separation and the far '
        'row only'),
    'probe_paircount_staging_only': ('paircount', [
        ('  for (int c = 0; c < cnt; ++c) one(c);',
         '  for (int c = cnt; c < cnt; ++c) one(c);')],
        'no pair computed: the items, runs and staged tiles only'),
    'probe_paircount_far_only_unroll_8': ('paircount', [
        ('      if (ok && r2 < elast) {', '      if (false) {'),
        ('#pragma unroll 2\n  for (int c = 0; c < cnt; ++c) one(c);',
         '#pragma unroll 8\n  for (int c = 0; c < cnt; ++c) one(c);')],
        'the far-only probe with 8 candidates a loop step, not 2: what '
        'more independent work a warp buys'),
    'probe_paircount_far_only_no_private_rows': ('paircount', [
        ('      if (ok && r2 < elast) {', '      if (false) {'),
        ('  return mode == MODE_1D ? nb1 + 1 : (mode == MODE_2D ? nb2 : 0);',
         '  return mode == MODE_1D ? 0 : (mode == MODE_2D ? nb2 : 0);')],
        'the far-only probe without the 46 KB of private rows: what more '
        'CTAs on an SM buy'),
    'probe_threept_no_ylm': ('threept_alm', [(YLM_CALL, '')],
        'the harmonics not computed (the drain adds stale values)'),
    'probe_threept_no_drain_adds': ('threept_alm', [
        ('        mma_f64(acc[4 * mt], acc[4 * mt + 1], a, b0);\n'
         '        mma_f64(acc[4 * mt + 2], acc[4 * mt + 3], a, b1);',
         '        if (b == 12345) acc[0] += a;')],
        'the drain\'s tensor-core steps dropped (the harmonics and the '
        'one-hot factors still loaded)'),
    'probe_threept_no_drain': ('threept_alm', [
        ('    if (qn >= QBATCH) {', '    if (qn >= QBATCH) qn -= QBATCH;\n'
         '    if (false) {'),
        ('        if (qn > 0) drain<REG, LMAX>(g, tb, wm, qn, acc);', '')],
        'no drain: the candidate pass and the queue only'),
    # a probe, not a design: what the ordered look-back costs (its list is
    # out of raster order, so it does not match)
    'poisson_unordered_bases': ('threefry', [
        ('const long long base = tile_lookback(status, tile, agg, lane);',
         'long long base = 0; if (lane == 0) base = (long long)atomicAdd('
         '(unsigned long long*)(scratch + SCR_TICKET + 1), '
         '(unsigned long long)agg); base = __shfl_sync(0xffffffffu, base, '
         '0);')],
        'tile bases in raster order: each tile takes its base from an '
        'atomic counter instead (timing probe; the list is unordered)'),
}


# the kernels timed and the source each is built from
SOURCE = {'radix_rank': 'radix_rank', 'paint_deposit': 'paint_deposit',
          'poisson': 'threefry', 'fof_sweep': 'fof_sweep',
          'paircount': 'paircount', 'threept': 'threept_alm'}


# an earlier design under ``variants/`` whose name is not its source's
EARLIER_DESIGN_OF = {'fof_links': 'fof_sweep', 'fof_links_tiles': 'fof_sweep'}


def built_source(src):
    """The kernel source a variant's source is timed against: itself, or
    for an earlier design under ``variants/`` the source it was."""
    base = os.path.basename(src).replace('_first_design', '')
    return EARLIER_DESIGN_OF.get(base, base)


def _build_variants(names):
    """Build the named variants, one nvcc each, all together; returns
    {name: ctypes library}."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = []
    for name in names:
        src, subs, _ = VARIANTS[name]
        with open(os.path.join(_build.SRC_DIR, src + '.cu')) as f:
            text = f.read()
        for old, new in subs:
            if old not in text:
                raise RuntimeError("variant %s: %r not in %s.cu"
                                   % (name, old[:40], src))
            text = text.replace(old, new)
        cu = os.path.join(VARIANT_DIR, name + '.cu')
        with open(cu, 'w') as f:
            f.write(text)
        so = os.path.join(VARIANT_DIR, 'lib%s.so' % name)
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc()] + _build.FLAGS + ['-o', so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError("nvcc failed on variant %s:\n%s"
                               % (name, out))
        libs[name] = ctypes.CDLL(so)
    return libs


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _rank_case():
    from .ops import radix_cuda
    n, D = 9998863, 65
    gen = torch.Generator(device='cuda')
    gen.manual_seed(11)
    d = torch.randint(0, D, (n,), generator=gen, device='cuda',
                      dtype=torch.int32)
    ref, _ = radix_cuda.pass_rank_hist_cuda(d, D)
    rank = torch.empty_like(d)
    hist = torch.empty(D, dtype=torch.int32, device='cuda')
    # room for the smallest chunk any variant takes
    scratch = torch.empty(radix_cuda.rank_plan(2 * n, D)['scratch_words'],
                          dtype=torch.int64, device='cuda')
    bad = torch.zeros((), dtype=torch.int32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        fn = lib.nbk_rank_pass
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        return lambda: _build.check('radix_rank', fn(
            d.data_ptr(), rank.data_ptr(), hist.data_ptr(),
            scratch.data_ptr(), bad.data_ptr(), n, D, stream))

    def same():
        return bool(torch.equal(rank, ref))
    return run, same


def _deposit_case():
    from .ops.paint import mxu_payload, mxu_plan
    from .ops.paint_cuda import deposit_blocks_cuda, deposit_plan
    from .source.catalog import UniformCatalog
    nmesh = 512
    cat = UniformCatalog(nbar=1e-2, BoxSize=1000.0, seed=42)
    pos = cat['Position'] * (nmesh / 1000.0)
    mass = torch.ones(pos.shape[0], dtype=torch.float32, device='cuda')
    full = (nmesh,) * 3
    mp = mxu_plan(pos.shape[0], full, 'cic', full, 4)
    sx, sy, sz, sm, _ = mxu_payload(pos, mass, mp, 'cic', 0, 'radix')
    geom = dict(resampler='cic', rb=mp['rb'], cb=mp['cb'], n0l=nmesh,
                p0=nmesh, N1=nmesh, N2=nmesh, origin=0)
    ref = deposit_blocks_cuda(sx, sy, sz, sm, **geom)
    out = torch.empty_like(ref)
    T, nty, K = sx.shape
    M = ref.shape[2]
    plan = deposit_plan(M, nmesh, 4)
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        fn = lib.nbk_deposit
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 \
            + [ctypes.c_void_p]
        return lambda: _build.check('paint_deposit', fn(
            sx.data_ptr(), sy.data_ptr(), sz.data_ptr(), sm.data_ptr(),
            out.data_ptr(), 1, 0, 2, T, nty, K, mp['rb'], mp['cb'], nmesh,
            nmesh, nmesh, nmesh, 0, plan['zc'], plan['nz'],
            plan['smem_bytes'], stream))

    def same():
        return float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    return run, same


def _lognormal_lam():
    """The lognormal path's lam at 1024^3 (LogNormalCatalog's first
    steps: white noise, power, c2r, lognormal transform) and its sum."""
    from . import cosmology, mockmaker
    from .pmesh import ParticleMesh
    box, nmesh, nbar = 5000.0, 1024, 1e7 / 5000.0 ** 3
    pm = ParticleMesh(nmesh, box, dtype='f4')
    plin = cosmology.LinearPower(cosmology.Planck15, 0.55, 'EisensteinHu')
    delta_k, _ = mockmaker.gaussian_complex_fields(pm, plin, 42)
    delta = pm.c2r(delta_k.value)
    del delta_k
    return mockmaker.lognormal_lambda(delta, pm, nbar, 2.0), nbar * box ** 3


_BOSS = {}


def _boss_like():
    """The particles path's boss_like sample on the card (LogNormalCatalog,
    1e6 in a box of 2500, seed 42, numpy-seeded weights): (pos, w, box),
    built once."""
    if not _BOSS:
        import numpy as np
        from . import cosmology
        from .source.catalog import LogNormalCatalog
        box = 2500.0
        plin = cosmology.LinearPower(cosmology.Planck15, 0.55,
                                     'EisensteinHu')
        cat = LogNormalCatalog(plin, nbar=1e6 / box ** 3, BoxSize=box,
                               Nmesh=1024, bias=2.0, seed=42)
        _BOSS['pos'] = cat['Position'].double()
        _BOSS['w'] = torch.as_tensor(
            np.random.RandomState(7).uniform(0.5, 1.5, len(cat)),
            device='cuda')
        _BOSS['box'] = box
    return _BOSS['pos'], _BOSS['w'], _BOSS['box']


def _paircount_cases():
    """(label, run, same) of the pair-count kernel on the particles path's
    boss_like sample: the '1d' auto count (one column) and the '2d' one
    (Nmu 10) on r in linspace(5, 150, 30), the histograms zeroed before
    each launch (in the timing, alike for every variant)."""
    import numpy as np
    from .algorithms.pair_counters.core import paircount_inputs
    from .ops import paircount_cuda as pc
    pos, w, box = _boss_like()
    edges = np.linspace(5, 150, 30)
    cases = []
    for label, kw in (('1d', {}), ('2d', dict(mode='2d', Nmu=10))):
        args, kwargs, _, _ = paircount_inputs(pos, w, pos, w, np.full(3, box),
                                              edges, is_auto=True, **kw)
        ref_n, ref_w = pc.paircount_hist_cuda(*args, **kwargs)
        out_n = torch.zeros(ref_n.numel(), dtype=torch.int64, device='cuda')
        out_w = torch.zeros_like(ref_w)
        call, made = pc.launch_args(*args[:7], args[7], kwargs['nb2'],
                                    kwargs['pimax'], kwargs['los'],
                                    kwargs['origin'], True, out_n, out_w)

        # the closure holds the tensors behind the pointers
        def run(lib, call=call, out=(out_n, out_w), keep=(args, made)):
            fn = lib.nbk_paircount_hist
            fn.argtypes = pc.ARGTYPES

            def go():
                out[0].zero_()
                out[1].zero_()
                _build.check('paircount', fn(*call))
            return go

        def same(out_n=out_n, out_w=out_w, ref_n=ref_n, ref_w=ref_w):
            return bool(torch.equal(out_n.double(), ref_n)) and float(
                (out_w - ref_w).abs().max()) <= 1e-12 * float(
                ref_w.abs().max())
        cases.append(('paircount_hist %s boss_like' % label, run, same))
    return cases


def _threept_case():
    """(label, run, same) of the 3PCF moments kernel at the particles
    path's chunk: the first 65,536 of the boss_like sample's cell-ordered
    points against all of them, poles 0-4, r in linspace(20, 150, 14)
    (moments within 1e-12 of their largest)."""
    import numpy as np
    from .algorithms.threeptcf import CHUNK, se_inputs
    from .ops import threept_cuda as tc
    pos, w, box = _boss_like()
    edges = np.linspace(20, 150, 14)
    poles = [0, 1, 2, 3, 4]
    grid, w_s, p, live, ci = se_inputs(pos, w, edges, box, True)
    nq = min(CHUNK, p.shape[0])
    chunk = (grid, w_s, p[:nq], live[:nq], ci[:nq], edges ** 2, poles)
    ref = tc.threept_alm_cuda(*chunk)
    out = torch.zeros_like(ref)
    call, keep = tc.launch_args(*chunk, out)

    def run(lib, keep=(chunk, keep)):
        fn = lib.nbk_threept_alm
        fn.argtypes = tc.ARGTYPES
        return lambda: _build.check('threept_alm', fn(*call))

    def same():
        return float((out - ref).abs().max()) <= 1e-12 * float(
            ref.abs().max())
    return [('threept_alm chunk of %d boss_like' % nq, run, same)]


def clustered_catalog(n=2 * 10 ** 6, box=1000.0, blobs=10 ** 4, seed=42):
    """(positions on the card, linking length) of a clustered FOF case:
    half uniform, half in ``blobs`` Gaussian blobs of 0.6 ll, ll = 0.2
    of the mean separation; f32, from numpy's RandomState(seed)."""
    import numpy as np
    ll = 0.2 * box / n ** (1. / 3)
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, box, (blobs, 3))
    half = n // 2
    pos = np.concatenate([
        centres[rng.randint(blobs, size=half)]
        + rng.normal(scale=0.6 * ll, size=(half, 3)),
        rng.uniform(0, box, (n - half, 3))])
    pos = np.mod(pos, box).astype('f4')
    return torch.as_tensor(pos, device='cuda'), ll


def sphere_catalog(n=10 ** 6, seed=42):
    """(f64 positions on the card, box, linking length) of a sparse FOF
    grid as FiberCollisions makes it: ``n`` points uniform on the unit
    sphere shifted by 2 in a box of 4 (open), ll the chord of 62
    arcseconds, so the grid is capped at 4096 cells a side; from numpy's
    RandomState(seed)."""
    import numpy as np
    v = np.random.RandomState(seed).normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1)[:, None]
    return (torch.as_tensor(v + 2.0, device='cuda'), 4.0,
            2 * np.sin(0.5 * np.radians(62. / 3600)))


def _fof_grids():
    """(label, grid, ll) of the FOF flow (``benchmarks/test_fof.py`` at
    desi_like: the lognormal catalog at BoxSize 5000, Nmesh 1024, nbar
    1e7 / 5000^3, bias 2, seed 42; ll 0.2 of the mean separation), of
    :func:`clustered_catalog` and of :func:`sphere_catalog`."""
    from . import cosmology
    from .ops.devicehash import DeviceGridHash
    from .source.catalog import LogNormalCatalog
    box, n = 5000.0, 1e7
    cat = LogNormalCatalog(
        cosmology.LinearPower(cosmology.Planck15, 0.55, 'EisensteinHu'),
        nbar=n / box ** 3, BoxSize=box, Nmesh=1024, bias=2.0, seed=42)
    ll = 0.2 * box / len(cat) ** (1. / 3)
    out = [('fof_1024', DeviceGridHash(cat['Position'], box, ll), ll)]
    del cat
    pos, ll = clustered_catalog()
    out.append(('clustered_2e6', DeviceGridHash(pos, 1000.0, ll), ll))
    pos, box, ll = sphere_catalog()
    out.append(('sphere_1e6', DeviceGridHash(pos, box, ll, periodic=False),
                ll))
    return out


def _fof_cases():
    """(label, run, same) of the FOF's link count, link fill and
    search-mode sweep on each grid of :func:`_fof_grids`, into
    preallocated outputs."""
    from .ops import fof_cuda as fc
    cases = []
    for label, grid, ll in _fof_grids():
        ci_s = grid.cell_of(grid.pos_s).contiguous()
        args = (grid.pos_s, ci_s, grid.flat_s, grid.valid_s, grid.columns())
        geo = grid.geometry(ll ** 2)
        n = ci_s.shape[0]
        counts = fc.fof_link_count_cuda(*args, *geo)
        row = torch.zeros(n + 1, dtype=torch.int64, device='cuda')
        torch.cumsum(counts, 0, out=row[1:])
        links = fc.fof_link_fill_cuda(*args, row, *geo)
        labels = torch.arange(n, dtype=torch.int32, device='cuda')
        swept = fc.fof_sweep_cuda(*args[:4], labels, *geo, cols=args[4])
        for name, a, ref in (('nbk_fof_link_count', None, counts),
                             ('nbk_fof_link_fill', row, links),
                             ('nbk_fof_sweep', labels, swept)):
            # -1 is no count, slot or label: a launch that writes nothing
            # does not match
            out = torch.full_like(ref, -1)
            call = fc.grid_launch_args(*args, a, out, *geo)

            # the closure holds the tensors behind the pointers; None for a
            # library without the function
            def run(lib, name=name, call=call, keep=(args, a, out)):
                if not hasattr(lib, name):
                    return None
                fn = getattr(lib, name)
                fn.argtypes = fc.grid_argtypes(name)
                return lambda: _build.check('fof_sweep', fn(*call))

            def same(out=out, ref=ref):
                ok = bool(torch.equal(out, ref))
                out.fill_(-1)  # each variant writes its own result
                return ok
            cases.append(('%s %s' % (name[4:], label), run, same))
    return cases


def _poisson_cases():
    """(label, run, same) for both modes of the Poisson kernel on the
    lognormal path's lam, and the occupied cells drawn unfused (the full
    mesh, then nonzero, the counts' gather and sum)."""
    from . import rng
    from .ops import threefry_cuda as tf
    lam, expected = _lognormal_lam()
    lam = lam.reshape(-1)
    n = lam.numel()
    key = rng.split(rng.key(42))[0]
    ref_full = tf.poisson_threefry_cuda(key, lam)
    ref_ids, ref_cnts, ref_n = tf.poisson_cells_cuda(key, lam, expected)
    tables = tf._device_tables(key, lam.device)
    cap = tf.cell_capacity(expected, n)
    out = torch.empty(n, dtype=torch.int64, device='cuda')
    ids = torch.empty(cap, dtype=torch.int64, device='cuda')
    cnts = torch.empty(cap, dtype=torch.int64, device='cuda')
    # room for the smallest tile any variant takes (1024 cells)
    scratch = torch.zeros(tf.SCRATCH_WORDS + n // 1024 + 1,
                          dtype=torch.int64, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def run(mode):
        a, b = (out, None) if mode == tf.FULL_MESH else (ids, cnts)

        def launch(lib):
            fn = lib.nbk_poisson_threefry
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]
            return lambda: _build.check('threefry', fn(
                lam.data_ptr(), n, 0, tables.data_ptr(), tf.KNUTH_TABLE,
                tf.REJECTION_TABLE, a.data_ptr(),
                0 if b is None else b.data_ptr(), cap, scratch.data_ptr(),
                mode, stream))
        return launch

    def same_full():
        return bool(torch.equal(out, ref_full))

    def same_cells():
        w = scratch[:tf.SCRATCH_WORDS].cpu()
        occ = int(w[tf.SCR_OCCUPIED])
        return bool(occ == ref_ids.numel() and int(w[tf.SCR_TOTAL]) == ref_n
                    and torch.equal(ids[:occ], ref_ids)
                    and torch.equal(cnts[:occ], ref_cnts))

    def unfused():
        counts = tf.poisson_threefry_cuda(key, lam)
        cells = torch.nonzero(counts).reshape(-1)
        c = counts[cells]
        return cells, c, int(c.sum())

    def fused():
        return tf.poisson_cells_cuda(key, lam, expected)
    return [('poisson full_mesh', run(tf.FULL_MESH), same_full),
            ('poisson occupied_cells', run(tf.OCCUPIED_CELLS), same_cells)
            ], fused, unfused


PIPE_PROBE = r'''
// Loops of one instruction mix, eight independent chains a thread, one
// CTA of 1024 threads per SM (the shared memory asked for keeps a second
// CTA off the SM); thread 0 reads the SM clock around the loop.
#include <cuda_runtime.h>
#include <stdint.h>

template <int ALU, int FMA>
__global__ void __launch_bounds__(1024) probe(uint32_t seed, int iters,
                                              uint32_t* sink,
                                              long long* clocks) {
  uint32_t x[8], y[8];
  const uint32_t sh = seed & 31u, m = seed | 1u;
  for (int j = 0; j < 8; ++j) {
    x[j] = seed + threadIdx.x * 8 + j;
    y[j] = seed ^ (threadIdx.x + 3 * j);
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int a = 0; a < ALU; ++a) {
        if (a & 1)
          asm volatile("shf.l.wrap.b32 %0, %0, %0, %1;" : "+r"(x[j])
                       : "r"(sh));
        else
          asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(x[j])
                       : "r"(m), "r"(sh));
      }
#pragma unroll
      for (int f = 0; f < FMA; ++f)
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(y[j])
                     : "r"(m), "r"(sh));
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t acc = 0;
  for (int j = 0; j < 8; ++j) acc ^= x[j] ^ y[j];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}

template <int ALU, int FMA>
static int launch(int ctas, int iters, uint32_t* sink, long long* clocks,
                  cudaStream_t s) {
  const int smem = 150 * 1024;
  cudaError_t e = cudaFuncSetAttribute(
      probe<ALU, FMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  probe<ALU, FMA><<<ctas, 1024, smem, s>>>(0x9E3779B9u, iters, sink, clocks);
  return (int)cudaGetLastError();
}

// mix 0: 4 ALU-pipe instructions a chain and round (LOP3, SHF); 1: 4
// FMA-pipe ones (IMAD); 2: both
extern "C" int nbk_pipe_probe(int mix, int ctas, int iters, uint32_t* sink,
                              long long* clocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mix == 0) return launch<4, 0>(ctas, iters, sink, clocks, s);
  if (mix == 1) return launch<0, 4>(ctas, iters, sink, clocks, s);
  return launch<4, 4>(ctas, iters, sink, clocks, s);
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
'''


def pipe_probe():
    """Results per clock per SM of the probe's three mixes: ALU pipe
    alone, FMA pipe alone, both. If the pipes run side by side, the mix
    of both takes about as many clocks as the slower alone."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    cu = os.path.join(VARIANT_DIR, 'pipe_probe.cu')
    so = os.path.join(VARIANT_DIR, 'libpipe_probe.so')
    with open(cu, 'w') as f:
        f.write(PIPE_PROBE)
    out = subprocess.run([_build.nvcc()] + _build.FLAGS + ['-o', so, cu],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError("nvcc failed on the pipe probe:\n%s"
                           % (out.stdout + out.stderr))
    fn = ctypes.CDLL(so).nbk_pipe_probe
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    ctas = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    sink = torch.empty(ctas * 1024, dtype=torch.int32, device='cuda')
    clocks = torch.empty(ctas, dtype=torch.int64, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for mix, label, per_chain in ((0, 'alu_pipe', (4, 0)),
                                  (1, 'fma_pipe', (0, 4)),
                                  (2, 'alu_and_fma', (4, 4))):
        for _ in range(2):                      # the second is timed
            err = fn(mix, ctas, iters, sink.data_ptr(), clocks.data_ptr(),
                     stream)
            if err:
                raise RuntimeError("pipe probe launch failed: CUDA error "
                                   "%d" % err)
        torch.cuda.synchronize()
        cyc = float(clocks.double().median())
        alu, fma = (1024 * iters * 8 * k for k in per_chain)
        res[label] = {'clocks': cyc, 'alu_per_clock': alu / cyc,
                      'fma_per_clock': fma / cyc,
                      'clocks_max_over_min': float(clocks.max())
                      / float(clocks.min())}
    res['both_over_slower_alone'] = res['alu_and_fma']['clocks'] / max(
        res['alu_pipe']['clocks'], res['fma_pipe']['clocks'])
    return res


def _cases(kernel):
    """(label, run, same) of a kernel's timed cases."""
    if kernel == 'radix_rank':
        run, same = _rank_case()
        return [('radix_rank', run, same)]
    if kernel == 'fof_sweep':
        return _fof_cases()
    if kernel == 'paircount':
        return _paircount_cases()
    if kernel == 'threept':
        return _threept_case()
    run, same = _deposit_case()
    return [('paint_deposit', run, same)]


def main(argv=()):
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    which = list(argv) or ['radix_rank', 'paint_deposit', 'poisson',
                           'fof_sweep', 'paircount', 'threept', 'pipes']
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'nvidia_smi': smi}), flush=True)
    # the kernels timed, and those that make their inputs (the grid's
    # order, the catalogs' draws, the column table)
    _build.build_all(sorted({SOURCE[k] for k in which if k in SOURCE}
                            | {'radix_rank', 'threefry', 'fof_sweep'}))
    names = sorted(n for n in VARIANTS
                   if built_source(VARIANTS[n][0]) in
                   [SOURCE[k] for k in which if k in SOURCE])
    libs = _build_variants(names)
    for kernel in which:
        if kernel == 'pipes':
            print(json.dumps({'probe': 'pipes', **pipe_probe()}), flush=True)
            continue
        extra = None
        if kernel == 'poisson':
            cases, fused, unfused = _poisson_cases()
            extra = [('as_built', fused), ('poisson_unfused_compaction',
                                           unfused), ('as_built', fused)]
        else:
            cases = _cases(kernel)
        src = SOURCE[kernel]
        built = _build.load(src)
        for label, run, same in cases:
            order = [('as_built', run(built))] + [
                (n, run(libs[n])) for n in names
                if built_source(VARIANTS[n][0]) == src] + [
                ('as_built', run(built))]
            for name, fn in order:
                if fn is None:
                    continue
                ms = _ms(fn)
                rec = {'kernel': label, 'variant': name, 'ms': ms,
                       'matches': same()}
                if name in VARIANTS:
                    rec['takes_back'] = VARIANTS[name][2]
                print(json.dumps(rec), flush=True)
        for name, fn in extra or ():
            rec = {'kernel': 'poisson occupied_cells, through the wrapper',
                   'variant': name, 'ms': _ms(fn)}
            if name != 'as_built':
                rec['takes_back'] = ('the compaction fused into the draw: '
                                     'the full mesh, then nonzero(), the '
                                     'counts\' gather and sum')
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
