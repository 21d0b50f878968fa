// The tile design of the FOF link kernels (fof_link_count_kernel,
// fof_link_fill_kernel), kept whole so that
// nbodykit_tpu_torch/kernel_variants.py and chip_smoke.py can time it
// beside the kernels of csrc/fof_sweep.cu (the "fof_links_tiles"
// variant). It is csrc/fof_sweep.cu as that design stood, with the same C
// interface; nothing else builds or calls it. On the H100 it ran slower
// than the kernels as built (a thread a query, the minimum image divided
// only past a quarter box) on the FOF flow's grid, a clustered catalog
// and a sparse sphere grid (PERF.md).
//
// The min-label sweeps of the grid-hash friends-of-friends, for Hopper
// (sm_90a): a column table, a link list built once, and two sweep modes.
//
// Computes neighbor_min of nbodykit_tpu/ops/devicehash.py:190-194 (the
// body that local_fof_labels folds over DeviceGridHash.fold, :148-168),
// which the JAX package leaves to XLA as a lax.while_loop of gathers per
// neighbour offset; no Pallas kernel computes it. For every particle i of
// the cell-sorted arrays:
//
//     out[i] = min(labels[i], min{labels[j] : j in the deduplicated
//              neighbour cells of i, r2(i, j) <= ll2})   if valid[i]
//     out[i] = labels[i]                                 otherwise
//
// The column table. A column is a cell's (a, b) pair; c is the third
// coordinate. cols[a * nc1 + b] is the first sorted slot of column (a, b)
// (searchsorted of (a * nc1 + b) * nc2, built once per FOF in torch), and
// cols[nc0 * nc1] the first dead slot. At 1077^3 cells it holds 1.16e6
// int32 entries, 4.6 MB: it stays in the 50 MB L2. Inside a column the
// ids are sorted by c, so the neighbour cells along c of one (da, db) pair
// are one or two runs of consecutive cells (two where c wraps), each one
// contiguous range of slots. A query therefore reads 9 columns (two
// L2-resident loads each) and one short binary search per run inside the
// column (~8.6 particles a column at 1e7 particles), against 27 searches
// of ~24 dependent loads into all n ids in the first form of this kernel.
// The columns go one after another. Advancing their table loads and
// searches side by side, 3 or 9 at a time, so that a query waits for one
// column's chain of dependent loads, not nine, was slower on the H100: 9
// lanes take 62 registers against 32, and the occupancy lost costs more
// latency hiding than the lanes give (kernel_variants.py fof_sweep).
//
// The cells visited are the deduplicated set of ops/gridhash.py
// neighbor_offsets: per axis the sorted distinct cells of c + d for the
// offsets d in [dlo, dhi] (wrapped when periodic: all cells when the
// offsets cover the axis; dropped when open and out of the grid, the JAX
// package's oob offset). Columns are visited in increasing (a, b) order
// and runs in increasing c, so the slots j of a query come in increasing
// order: the link list is sorted within each row, as the plain version's.
//
// Four kernels:
//  - fof_search_kernel, one thread a sorted query: the search-mode sweep,
//    the column lookups and the pair test in every sweep. Bound by latency
//    (the dependent loads of the column searches); its byte bound is the
//    inputs read once and the labels written once, 37 bytes a particle at
//    f32 with int32 ids.
//  - fof_link_count_kernel, once per FOF: for each valid query, the linked
//    j != i (r2 <= ll2). Bytes: the inputs once and 4 a count.
//  - fof_link_fill_kernel, once per FOF: the same traversal again, writing
//    each query's linked j (int32) at its CSR row offset (int64, the torch
//    cumsum of the counts). Invalid queries have no links.
//  - fof_links_sweep_kernel: the links-mode sweep, out[i] = min(labels[i],
//    min labels[links[k]] over the row). Bound by bytes: the row offsets,
//    labels and output, 16 bytes a particle, and 4 bytes a link (plus the
//    label it gathers), no search at all.
// The caller (ops/devicehash.py fof_fixpoint) counts the links, then
// takes the links mode when the list fits the card's free memory beside
// the fixpoint's label arrays, and the search mode otherwise.
//
// The link kernels work on tiles (their first design, a thread a query
// walking its 9 columns through chains of dependent L1/L2 loads, is
// csrc/variants/fof_links_first_design.cu). On the FOF flow's grid (1e7
// particles in 1077^3 cells: ~0.008 a cell, ~8.6 a column) a query has
// ~1.5 candidates besides itself, so the work is the 9 column lookups,
// and the ~8 consecutive queries of one column repeat the same ones. A
// CTA takes LINK_THREADS consecutive sorted slots, a thread a query. The
// slots are sorted by (a * nc1 + b) * nc2 + c, so the queries of one
// plane a cover a short run of columns (a, bmin..bmax), and the neighbour
// columns of all of them, plane by plane a' of a's (up to 3), are the
// columns (a', bmin + dlo .. bmax + dhi): one contiguous range of slots,
// or two where b wraps (grid_columns.cuh axis_runs over the widened
// offsets). The tile goes in rounds:
//  1. The round's group: the pending queries of the least plane a among
//     them, and their least and greatest b (warp reductions, then shared
//     atomics). A tile that crosses a plane takes a round for each plane.
//  2. Its ranges (up to LINK_RANGES: 3 planes x 2 pieces of b), read from
//     the column table by one thread each (plan_range, plan_offsets). A
//     sparse round (more columns than keys: a grid much finer than the
//     particles) walks global memory as the first design does. Else its
//     keys, column-table entries and column masks must fit
//     LINK_STAGE_BYTES; where they do not (dense columns), the group
//     keeps the queries of the lower half of its b range, again until it
//     fits or holds one column, which then walks global memory; the
//     other queries wait for later rounds.
//  3. The CTA stages the keys and the column-table entries with cp.async
//     (one loop over all of them, every copy in flight at once, no
//     registers), then each column's mask, a thread a column: bit c for
//     cell c along c (up to LINK_EXACT_CELLS cells; beyond, 256 bits of
//     2^mshift cells each).
//  4. Each thread of the group tests its 9 columns' masks against its own
//     cells along c (two words at most), then walks the columns that hold
//     a key there, in increasing (a', b'), one a step (a warp steps as
//     often as its busiest lane, not once for every column some lane
//     needs): the column's bounds from the staged entries (rebased to the
//     stage), a binary search of the staged keys, the staged keys to the
//     run's end, the query itself skipped without a load. A candidate's
//     position comes from global memory.
// On the H100 (kernel_variants.py fof_sweep, PERF.md) the kernel is bound
// by issue and latency, not bytes: the rounds and the stage cost about
// what the first design's L1-served lookups cost, so on the FOF flow's
// grid the tiles run level with the first design (the fill ahead); they
// gain where columns are denser (a clustered catalog, KDDensity's ~1
// point a cell). The designs that were tried on the card and lost are
// listed in PERF.md.
//
// Every sweep reads the sweep's input labels and writes a separate array
// (a Jacobi sweep), so each equals the plain version exactly in either
// mode; pointer jumping and the convergence test stay in torch.
//
// Float arithmetic: the cell coordinates come from torch, so the only
// float operations here are the plain version's, in its order and in the
// positions' type: d = p_j - p_i; d - rint(d / box) * box (round half to
// even, an IEEE divide); r2 = (dx*dx + dy*dy) + dz*dz. _build.py compiles
// with -fmad=false, so no multiply and add are fused and a pair whose r2
// sits within an ulp of ll2 links as it does in the plain version. The
// link kernels divide only where |d| > box / 4: below that d / box rounds
// to at most 0.25, rint gives 0 and d is unchanged (bit for bit; a zero's
// sign does not reach r2). That holds for every pair of a grid of 9 or
// more cells an axis whose positions lie in the box; elsewhere the
// division runs as before. The count and the fill run the same code, so
// they agree on every pair, and both visit a query's slots in the order
// of for_each_link: each row of the list is sorted, as the plain
// version's.
//
// Built by nbodykit_tpu_torch/_build.py into a shared library with a plain
// C interface; each nbk_* entry point returns the launch's cudaError_t.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_columns.cuh"

#define SWEEP_THREADS 256

template <typename F>
struct Geo {
  int dlo[3], dhi[3];  // the offsets along each axis: [dlo, dhi]
  int ncell[3];
  F box[3];
  F qbox[3];  // box / 4: below it the minimum image leaves d as it is
  F ll2;
  int periodic;
  int mshift;  // a column mask's bit c >> mshift holds cell c
  int mwords;  // 32-bit words of a column's mask
};

__device__ __forceinline__ float round_even(float x) { return rintf(x); }
__device__ __forceinline__ double round_even(double x) { return rint(x); }

// Visits the slots j >= s of one run of cells (keys up to khi) in the
// linking length of the query at (px, py, pz); returns the first slot
// past the run. Past a column's last slot come larger keys (the next
// column's, then the dead slots' sentinel), so the walk stops there.
template <typename F, typename K, typename Visit>
__device__ __forceinline__ int walk(const Geo<F>& g,
                                    const F* __restrict__ pos,
                                    const K* __restrict__ flat, int s, int n,
                                    K khi, F px, F py, F pz, Visit& visit) {
  int j = s;
  for (; j < n && flat[j] <= khi; ++j) {
    const size_t j3 = (size_t)3 * j;
    F dx = pos[j3] - px, dy = pos[j3 + 1] - py, dz = pos[j3 + 2] - pz;
    if (g.periodic) {
      dx = dx - round_even(dx / g.box[0]) * g.box[0];
      dy = dy - round_even(dy / g.box[1]) * g.box[1];
      dz = dz - round_even(dz / g.box[2]) * g.box[2];
    }
    const F r2 = (dx * dx + dy * dy) + dz * dz;
    if (r2 <= g.ll2) visit(j);
  }
  return j;
}

// Calls visit(j) for every slot j of a neighbour cell of query i within
// the linking length, in increasing j. The (up to 9) columns go one after
// another in increasing (a, b) order: two column-table loads, a search
// inside the column for the first run along c and a walk over it; where
// c wraps, a search from there for the second run and a walk over it.
template <typename F, typename K, typename Visit>
__device__ __forceinline__ void for_each_link(
    const Geo<F>& g, const F* __restrict__ pos, const int* __restrict__ ci,
    const K* __restrict__ flat, const int* __restrict__ cols, int i, int n,
    Visit& visit) {
  const size_t i3 = (size_t)3 * i;
  const F px = pos[i3], py = pos[i3 + 1], pz = pos[i3 + 2];
  const Cells ca = axis_cells(ci[i3], g.ncell[0], g.dlo[0], g.dhi[0],
                              g.periodic);
  const Cells cb = axis_cells(ci[i3 + 1], g.ncell[1], g.dlo[1], g.dhi[1],
                              g.periodic);
  const Runs rc = axis_runs(ci[i3 + 2], g.ncell[2], g.dlo[2], g.dhi[2],
                            g.periodic);
  const int nc1 = g.ncell[1];
  const K nc2 = (K)g.ncell[2];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
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
  }
}

struct MinLabel {
  const int* __restrict__ labels;
  int best;
  __device__ __forceinline__ void operator()(int j) {
    const int l = labels[j];
    best = l < best ? l : best;
  }
};

template <typename F, typename K>
__global__ void __launch_bounds__(SWEEP_THREADS)
fof_search_kernel(const F* __restrict__ pos, const int* __restrict__ ci,
                  const K* __restrict__ flat,
                  const unsigned char* __restrict__ valid,
                  const int* __restrict__ cols,
                  const int* __restrict__ labels, int* __restrict__ out,
                  int n, const Geo<F> g) {
  const int i = blockIdx.x * SWEEP_THREADS + threadIdx.x;
  if (i >= n) return;
  MinLabel v{labels, labels[i]};
  if (valid[i]) for_each_link<F, K>(g, pos, ci, flat, cols, i, n, v);
  out[i] = v.best;
}

// --- the link kernels: tiles of consecutive queries ---

// queries a tile (threads a CTA of the link kernels)
#define LINK_THREADS 128
// shared bytes of a round's staged keys, column-table entries and masks
#define LINK_STAGE_BYTES 20480
// slot ranges of a round: 3 planes a' x 2 pieces of b
#define LINK_RANGES 6
// ints of LinkPlan (ops/fof_cuda.py LINK_PLAN_INTS)
#define LINK_PLAN_INTS 53
// cells along c up to which a column's mask holds a bit a cell; beyond,
// a bit for 2^mshift cells, at most 256 bits
#define LINK_EXACT_CELLS 1088

// One round of a tile in shared memory: its group (plane a, b in
// [bmin, bhi]), the b pieces, and range t = 2 * (plane index) + piece:
// columns col0 .. col0 + ncol - 1 of the table, slots [slot0, slot1),
// staged at u = slot + shift from u0 (keys) and e0 (entries, and the
// columns' cell masks beside them); fit: staged (else the round walks
// global memory), stop: the round is final.
struct LinkPlan {
  int a, bmin, bmax;
  int blo0, bhi0, blo1;
  int ncol[LINK_RANGES], col0[LINK_RANGES];
  int slot0[LINK_RANGES], slot1[LINK_RANGES];
  int u0[LINK_RANGES], e0[LINK_RANGES], shift[LINK_RANGES];
  int keys, entries, fit, stop, pad;
};
static_assert(sizeof(LinkPlan) == LINK_PLAN_INTS * sizeof(int),
              "LinkPlan holds LINK_PLAN_INTS ints");

__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ double magnitude(double x) { return fabs(x); }

// d - rint(d / box) * box, dividing only where |d| > box / 4
template <typename F>
__device__ __forceinline__ F image(F d, F box, F qbox) {
  return magnitude(d) > qbox ? d - round_even(d / box) * box : d;
}

// the cells of a Runs one by one: their number, and the t-th in order
__device__ __forceinline__ int run_cells(const Runs& r) {
  return r.hi0 - r.lo0 + 1 + (r.m == 2 ? r.hi1 - r.lo1 + 1 : 0);
}
__device__ __forceinline__ int cell_at(const Runs& r, int t) {
  const int len0 = r.hi0 - r.lo0 + 1;
  return t < len0 ? r.lo0 + t : r.lo1 + t - len0;
}

// A query's cells along c as bits of a column's mask (g.mwords 32-bit
// words; bit c >> g.mshift holds cell c: a column whose mask misses the
// query's bits holds no key in its cells; a bit a cell up to
// LINK_EXACT_CELLS, else 256 bits, which keep a sparse grid's stage
// small): run r
// covers bits lo of word w and hi of word w + 1 (0 where the run ends in
// word w). A run holds at most three cells (offsets in [-1, 1]), so two
// words.
struct CellBits {
  int w0, w1;
  unsigned lo0, hi0, lo1, hi1;
};

__device__ __forceinline__ void run_bits(int lo, int hi, int& w,
                                         unsigned& mlo, unsigned& mhi) {
  w = lo >> 5;
  const unsigned top = ~0u >> (31 - (hi & 31));
  const bool one = (hi >> 5) == w;
  mlo = (~0u << (lo & 31)) & (one ? top : ~0u);
  mhi = one ? 0u : top;
}

__device__ __forceinline__ CellBits cell_bits(const Runs& rc, int sh) {
  CellBits q;
  run_bits(rc.lo0 >> sh, rc.hi0 >> sh, q.w0, q.lo0, q.hi0);
  q.w1 = 0;
  q.lo1 = q.hi1 = 0u;
  if (rc.m == 2) run_bits(rc.lo1 >> sh, rc.hi1 >> sh, q.w1, q.lo1, q.hi1);
  return q;
}

// whether the column whose mask is m holds a key in the query's cells
__device__ __forceinline__ bool column_hit(const unsigned* m,
                                           const CellBits& q) {
  unsigned x = m[q.w0] & q.lo0;
  if (q.hi0) x |= m[q.w0 + 1] & q.hi0;
  if (q.lo1) x |= m[q.w1] & q.lo1;
  if (q.hi1) x |= m[q.w1 + 1] & q.hi1;
  return x != 0u;
}

// Visits the staged slots from u of one run of cells (keys up to khi,
// below the column's end ue) in the linking length of query i; returns
// the first u past the run. Only a candidate other than i is loaded (its
// position from global memory).
template <typename F, typename K, typename Visit>
__device__ __forceinline__ int staged_walk(const Geo<F>& g,
                                           const F* __restrict__ pos,
                                           const K* skeys, int u, int ue,
                                           int shift, K khi, int i, F px,
                                           F py, F pz, Visit& visit) {
  for (; u < ue && skeys[u] <= khi; ++u) {
    const int j = u - shift;
    if (j == i) continue;
    const size_t j3 = (size_t)3 * j;
    F dx = __ldg(pos + j3) - px, dy = __ldg(pos + j3 + 1) - py,
      dz = __ldg(pos + j3 + 2) - pz;
    if (g.periodic) {
      dx = image(dx, g.box[0], g.qbox[0]);
      dy = image(dy, g.box[1], g.qbox[1]);
      dz = image(dz, g.box[2], g.qbox[2]);
    }
    const F r2 = (dx * dx + dy * dy) + dz * dz;
    if (r2 <= g.ll2) visit(j);
  }
  return u;
}

// Calls visit(j) for every slot j of a neighbour cell of query i (cell
// (a, b, c), a the round's plane) within the linking length, from the
// round's stage, in increasing j: the columns in increasing (a', b'),
// the runs along c in increasing c, as for_each_link.
template <typename F, typename K, typename Visit>
__device__ __forceinline__ void staged_links(
    const Geo<F>& g, const F* __restrict__ pos, const K* skeys,
    const unsigned* smask, const int* sent, const LinkPlan& P, int i, int a,
    int b, int c, F px, F py, F pz, Visit& visit) {
  const Runs ra = axis_runs(a, g.ncell[0], g.dlo[0], g.dhi[0], g.periodic);
  const Runs rb = axis_runs(b, g.ncell[1], g.dlo[1], g.dhi[1], g.periodic);
  const Runs rc = axis_runs(c, g.ncell[2], g.dlo[2], g.dhi[2], g.periodic);
  const CellBits qb = cell_bits(rc, g.mshift);
  const int ma = run_cells(ra), mb = run_cells(rb);
  const int nc1 = g.ncell[1], W = g.mwords;
  const K nc2 = (K)g.ncell[2];
  const int bhi0 = P.bhi0;
  // each b cell's piece of the round's b range and its column's place
  // in that piece's ranges
  int piece[3], off[3];
#pragma unroll
  for (int kb = 0; kb < 3; ++kb) {
    const int vb = cell_at(rb, kb);
    piece[kb] = vb > bhi0;
    off[kb] = vb - (piece[kb] ? P.blo1 : P.blo0);
  }
  // the columns holding a key in the query's cells: bit 3 ka + kb
  unsigned todo = 0;
#pragma unroll
  for (int ka = 0; ka < 3; ++ka) {
    if (ka >= ma) break;
    const int e0 = P.e0[2 * ka], e1 = P.e0[2 * ka + 1];
#pragma unroll
    for (int kb = 0; kb < 3; ++kb) {
      if (kb >= mb) break;
      if (column_hit(smask + W * ((piece[kb] ? e1 : e0) + off[kb]), qb))
        todo |= 1u << (3 * ka + kb);
    }
  }
  // one of them a step, in increasing (a', b'): a warp steps as often as
  // its busiest lane, not once for every column some lane needs
  while (todo) {
    const int q = __ffs(todo) - 1;
    todo &= todo - 1;
    const int ka = q / 3, kb = q - 3 * ka;
    const int va = cell_at(ra, ka), vb = cell_at(rb, kb);
    const int t = 2 * ka + (vb > bhi0);
    const int e = P.e0[t] + vb - (vb > bhi0 ? P.blo1 : P.blo0);
    const int shift = P.shift[t];
    const int us = sent[e] + shift, ue = sent[e + 1] + shift;
    const K base = (K)(va * nc1 + vb) * nc2;
    const int u = staged_walk<F, K>(
        g, pos, skeys, lower_bound<K>(skeys, us, ue, base + (K)rc.lo0), ue,
        shift, base + (K)rc.hi0, i, px, py, pz, visit);
    if (rc.m == 2)
      staged_walk<F, K>(g, pos, skeys,
                        lower_bound<K>(skeys, u, ue, base + (K)rc.lo1), ue,
                        shift, base + (K)rc.hi1, i, px, py, pz, visit);
  }
}

// Thread t < LINK_RANGES: range t of the round (plane a, b in [bmin,
// bhi]) from the column table; empty where the plane or the piece does
// not exist.
template <typename F>
__device__ __forceinline__ void plan_range(const Geo<F>& g,
                                           const int* __restrict__ cols,
                                           int a, int bmin, int bhi, int t,
                                           LinkPlan& P) {
  const Runs ra = axis_runs(a, g.ncell[0], g.dlo[0], g.dhi[0], g.periodic);
  // the b cells of every query of the round: the offsets widened by the
  // round's span of b
  const Runs rb = axis_runs(bmin, g.ncell[1], g.dlo[1],
                            g.dhi[1] + (bhi - bmin), g.periodic);
  const int ka = t >> 1, piece = t & 1;
  int ncol = 0, col0 = 0, s0 = 0, s1 = 0;
  if (ka < run_cells(ra) && piece < rb.m) {
    const int lo = piece ? rb.lo1 : rb.lo0, hi = piece ? rb.hi1 : rb.hi0;
    ncol = hi - lo + 1;
    col0 = cell_at(ra, ka) * g.ncell[1] + lo;
    s0 = cols[col0];
    s1 = cols[col0 + ncol];
  }
  P.ncol[t] = ncol;
  P.col0[t] = col0;
  P.slot0[t] = s0;
  P.slot1[t] = s1;
  if (t == 0) {
    P.blo0 = rb.lo0;
    P.bhi0 = rb.hi0;
    P.blo1 = rb.lo1;
  }
}

// Thread 0: the stage's layout and mode. The keys, then the columns' cell
// masks (mwords 32-bit words an entry), then the column-table entries
// (each range's ncol + 1 of them). Staged where all fit
// LINK_STAGE_BYTES; a sparse round (more columns than keys, as on a grid
// much finer than the particles) walks global memory as the first design
// does, whose column lookups cost less there than staging every empty
// column.
template <typename F, typename K>
__device__ __forceinline__ void plan_offsets(const Geo<F>& g, LinkPlan& P) {
  int u = 0, e = 0;
  for (int t = 0; t < LINK_RANGES; ++t) {
    P.u0[t] = u;
    P.e0[t] = e;
    P.shift[t] = u - P.slot0[t];
    if (P.ncol[t] > 0) {
      u += P.slot1[t] - P.slot0[t];
      e += P.ncol[t] + 1;
    }
  }
  P.keys = u;
  P.entries = e;
  const bool sparse = e > u;
  P.fit = !sparse && (long long)u * sizeof(K) + 4LL * e * (g.mwords + 1) <=
                         (long long)LINK_STAGE_BYTES;
  P.stop = sparse || P.fit;
}

// The range holding element x of a staged run of ranges that start at
// o[0] <= o[1] <= ... (an empty range starts where the next one does):
// the number of later starts at or below x.
__device__ __forceinline__ int range_of(const int* o, int x) {
  int t = 0;
#pragma unroll
  for (int k = 1; k < LINK_RANGES; ++k) t += x >= o[k];
  return t;
}

// Stages the round's keys and column-table entries, all threads: every
// element's copy in flight at once (cp.async, no registers), one loop
// over all of them; then each column's mask from its keys, a thread a
// column. Ends on a barrier.
template <typename F, typename K>
__device__ __forceinline__ void stage_round(const Geo<F>& g,
                                            const K* __restrict__ flat,
                                            const int* __restrict__ cols,
                                            const LinkPlan& P, K* skeys,
                                            unsigned* smask, int* sent) {
  const int tid = threadIdx.x;
  const int L = P.keys;
  for (int x = tid; x < L + P.entries; x += LINK_THREADS) {
    if (x < L) {
      __pipeline_memcpy_async(skeys + x,
                              flat + x - P.shift[range_of(P.u0, x)],
                              sizeof(K));
    } else {
      const int y = x - L, t = range_of(P.e0, y);
      __pipeline_memcpy_async(sent + y, cols + P.col0[t] + y - P.e0[t], 4);
    }
  }
  __pipeline_commit();
  const int W = g.mwords;
  for (int x = tid; x < W * P.entries; x += LINK_THREADS) smask[x] = 0u;
  __pipeline_wait_prior(0);
  __syncthreads();
  const K nc2 = (K)g.ncell[2];
  for (int e = tid; e < P.entries; e += LINK_THREADS) {
    const int t = range_of(P.e0, e);
    const int x = e - P.e0[t];
    if (x == P.ncol[t]) continue;  // the range's closing entry
    const K base = (K)(P.col0[t] + x) * nc2;
    unsigned* m = smask + W * e;
    const int hi = sent[e + 1] + P.shift[t];
    for (int u = sent[e] + P.shift[t]; u < hi; ++u) {
      const int bit = (int)(skeys[u] - base) >> g.mshift;
      m[bit >> 5] |= 1u << (bit & 31);
    }
  }
  __syncthreads();
}

struct CountLinks {
  int i, count;
  __device__ __forceinline__ void operator()(int j) { count += j != i; }
};

struct FillLinks {
  int i;
  int* __restrict__ links;
  long long k, end;
  __device__ __forceinline__ void operator()(int j) {
    if (j != i && k < end) links[k++] = j;
  }
};

// The links of a tile of LINK_THREADS consecutive sorted queries, in
// rounds (see the head of this file), each visited by v (CountLinks or
// FillLinks) of its query v.i; pending: the query searches.
template <typename F, typename K, typename Visit>
__device__ __forceinline__ void link_tile(
    const F* __restrict__ pos, const int* __restrict__ ci,
    const K* __restrict__ flat, const int* __restrict__ cols, int n,
    const Geo<F>& g, bool pending, Visit& v, unsigned char* stage,
    LinkPlan& P) {
  const int tid = threadIdx.x;
  const int i = v.i;
  int a = 0, b = 0, c = 0;
  F px = 0, py = 0, pz = 0;
  if (pending) {
    const size_t i3 = (size_t)3 * i;
    a = ci[i3];
    b = ci[i3 + 1];
    c = ci[i3 + 2];
    px = pos[i3];
    py = pos[i3 + 1];
    pz = pos[i3 + 2];
  }
  while (true) {
    if (tid == 0) {
      P.a = 0x7fffffff;
      P.bmin = 0x7fffffff;
      P.bmax = -1;
    }
    __syncthreads();
    // a warp's least, then the CTA's (every lane takes part)
    const int wa = __reduce_min_sync(0xffffffffu, pending ? a : 0x7fffffff);
    if ((tid & 31) == 0) atomicMin(&P.a, wa);
    __syncthreads();
    const int ag = P.a;
    if (ag == 0x7fffffff) break;  // no query left
    const bool in = pending && a == ag;
    const int wbmin = __reduce_min_sync(0xffffffffu, in ? b : 0x7fffffff);
    const int wbmax = __reduce_max_sync(0xffffffffu, in ? b : -1);
    if ((tid & 31) == 0) {
      atomicMin(&P.bmin, wbmin);
      atomicMax(&P.bmax, wbmax);
    }
    __syncthreads();
    const int bmin = P.bmin;
    int bhi = P.bmax;
    // the group's b range, halved until the round is final or a column
    while (true) {
      if (tid < LINK_RANGES) plan_range<F>(g, cols, ag, bmin, bhi, tid, P);
      __syncthreads();
      if (tid == 0) plan_offsets<F, K>(g, P);
      __syncthreads();
      if (P.stop || bhi == bmin) break;
      bhi = bmin + (bhi - bmin) / 2;
    }
    const bool fit = P.fit;
    const bool go = in && b <= bhi;
    K* skeys = (K*)stage;
    unsigned* smask = (unsigned*)(skeys + P.keys);
    int* sent = (int*)(smask + g.mwords * P.entries);
    if (fit) stage_round<F, K>(g, flat, cols, P, skeys, smask, sent);
    if (go) {
      if (fit)
        staged_links<F, K>(g, pos, skeys, smask, sent, P, i, a, b, c, px,
                           py, pz, v);
      else
        for_each_link<F, K>(g, pos, ci, flat, cols, i, n, v);
      pending = false;
    }
    __syncthreads();  // the next round reuses the stage and the plan
  }
}

template <typename F, typename K>
__global__ void __launch_bounds__(LINK_THREADS)
fof_link_count_kernel(const F* __restrict__ pos, const int* __restrict__ ci,
                      const K* __restrict__ flat,
                      const unsigned char* __restrict__ valid,
                      const int* __restrict__ cols, int* __restrict__ counts,
                      int n, const Geo<F> g) {
  __shared__ __align__(16) unsigned char stage[LINK_STAGE_BYTES];
  __shared__ LinkPlan P;
  const int i = blockIdx.x * LINK_THREADS + threadIdx.x;
  CountLinks v{i, 0};
  link_tile<F, K>(pos, ci, flat, cols, n, g, i < n && valid[i], v, stage,
                  P);
  if (i < n) counts[i] = v.count;
}

template <typename F, typename K>
__global__ void __launch_bounds__(LINK_THREADS)
fof_link_fill_kernel(const F* __restrict__ pos, const int* __restrict__ ci,
                     const K* __restrict__ flat,
                     const unsigned char* __restrict__ valid,
                     const int* __restrict__ cols,
                     const long long* __restrict__ row,
                     int* __restrict__ links, int n, const Geo<F> g) {
  __shared__ __align__(16) unsigned char stage[LINK_STAGE_BYTES];
  __shared__ LinkPlan P;
  const int i = blockIdx.x * LINK_THREADS + threadIdx.x;
  FillLinks v{i, links, 0, 0};
  if (i < n) {
    v.k = row[i];
    v.end = row[i + 1];
  }
  link_tile<F, K>(pos, ci, flat, cols, n, g,
                  i < n && valid[i] && v.k < v.end, v, stage, P);
}

__global__ void __launch_bounds__(SWEEP_THREADS)
fof_links_sweep_kernel(const long long* __restrict__ row,
                       const int* __restrict__ links,
                       const int* __restrict__ labels, int* __restrict__ out,
                       int n) {
  const int i = blockIdx.x * SWEEP_THREADS + threadIdx.x;
  if (i >= n) return;
  int best = labels[i];
  const long long end = row[i + 1];
  for (long long k = row[i]; k < end; ++k) {
    const int l = labels[links[k]];
    best = l < best ? l : best;
  }
  out[i] = best;
}

// what a launch of the traversal kernels computes
enum { SEARCH = 0, COUNT = 1, FILL = 2 };


template <typename F, typename K>
static int launch(int what, const void* pos, const int* ci, const void* flat,
                  const unsigned char* valid, const int* cols,
                  const int* labels, int* out, const long long* row, int n,
                  const int* dlo, const int* dhi, const int* ncell,
                  const double* box, double ll2, int periodic,
                  cudaStream_t s) {
  Geo<F> g;
  for (int k = 0; k < 3; ++k) {
    g.dlo[k] = dlo[k];
    g.dhi[k] = dhi[k];
    g.ncell[k] = ncell[k];
    g.box[k] = (F)box[k];  // the JAX package's jnp.asarray(box, pos.dtype)
    g.qbox[k] = g.box[k] * (F)0.25;
  }
  g.mshift = 0;
  if (ncell[2] > LINK_EXACT_CELLS)
    while ((ncell[2] - 1) >> g.mshift >= 256) ++g.mshift;
  g.mwords = (((ncell[2] - 1) >> g.mshift) >> 5) + 1;
  g.ll2 = (F)ll2;
  g.periodic = periodic;
  const int blocks = (n + SWEEP_THREADS - 1) / SWEEP_THREADS;
  const int tiles = (n + LINK_THREADS - 1) / LINK_THREADS;
  const F* p = (const F*)pos;
  const K* f = (const K*)flat;
  if (what == SEARCH)
    fof_search_kernel<F, K><<<blocks, SWEEP_THREADS, 0, s>>>(
        p, ci, f, valid, cols, labels, out, n, g);
  else if (what == COUNT)
    fof_link_count_kernel<F, K><<<tiles, LINK_THREADS, 0, s>>>(
        p, ci, f, valid, cols, out, n, g);
  else
    fof_link_fill_kernel<F, K><<<tiles, LINK_THREADS, 0, s>>>(
        p, ci, f, valid, cols, row, out, n, g);
  return (int)cudaGetLastError();
}

static int dispatch(int what, const void* pos, const int* ci,
                    const void* flat, const unsigned char* valid,
                    const int* cols, const int* labels, int* out,
                    const long long* row, long long n, int pos_bytes,
                    int key_bytes, const int* dlo, const int* dhi,
                    const int* ncell, const double* box, double ll2,
                    int periodic, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 3; ++k)
    if (dlo[k] < -1 || dlo[k] > 0 || dhi[k] < 0 || dhi[k] > 1 ||
        ncell[k] < 1)
      return (int)cudaErrorInvalidValue;
  const int m = (int)n;
  if (pos_bytes == 4 && key_bytes == 4)
    return launch<float, int>(what, pos, ci, flat, valid, cols, labels, out,
                              row, m, dlo, dhi, ncell, box, ll2, periodic, s);
  if (pos_bytes == 4 && key_bytes == 8)
    return launch<float, long long>(what, pos, ci, flat, valid, cols, labels,
                                    out, row, m, dlo, dhi, ncell, box, ll2,
                                    periodic, s);
  if (pos_bytes == 8 && key_bytes == 4)
    return launch<double, int>(what, pos, ci, flat, valid, cols, labels,
                               out, row, m, dlo, dhi, ncell, box, ll2,
                               periodic, s);
  if (pos_bytes == 8 && key_bytes == 8)
    return launch<double, long long>(what, pos, ci, flat, valid, cols,
                                     labels, out, row, m, dlo, dhi, ncell,
                                     box, ll2, periodic, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nbk_fof_sweep(const void* pos, const int* ci, const void* flat,
                             const unsigned char* valid, const int* cols,
                             const int* labels, int* out, long long n,
                             int pos_bytes, int key_bytes, const int* dlo,
                             const int* dhi, const int* ncell,
                             const double* box, double ll2, int periodic,
                             void* stream) {
  return dispatch(SEARCH, pos, ci, flat, valid, cols, labels, out, nullptr,
                  n, pos_bytes, key_bytes, dlo, dhi, ncell, box, ll2,
                  periodic, stream);
}

extern "C" int nbk_fof_link_count(const void* pos, const int* ci,
                                  const void* flat,
                                  const unsigned char* valid,
                                  const int* cols, int* counts, long long n,
                                  int pos_bytes, int key_bytes,
                                  const int* dlo, const int* dhi,
                                  const int* ncell, const double* box,
                                  double ll2, int periodic, void* stream) {
  return dispatch(COUNT, pos, ci, flat, valid, cols, nullptr, counts,
                  nullptr, n, pos_bytes, key_bytes, dlo, dhi, ncell, box,
                  ll2, periodic, stream);
}

extern "C" int nbk_fof_link_fill(const void* pos, const int* ci,
                                 const void* flat,
                                 const unsigned char* valid, const int* cols,
                                 const long long* row, int* links,
                                 long long n, int pos_bytes, int key_bytes,
                                 const int* dlo, const int* dhi,
                                 const int* ncell, const double* box,
                                 double ll2, int periodic, void* stream) {
  return dispatch(FILL, pos, ci, flat, valid, cols, nullptr, links, row, n,
                  pos_bytes, key_bytes, dlo, dhi, ncell, box, ll2, periodic,
                  stream);
}

extern "C" int nbk_fof_links_sweep(const long long* row, const int* links,
                                   const int* labels, int* out, long long n,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int m = (int)n;
  fof_links_sweep_kernel<<<(m + SWEEP_THREADS - 1) / SWEEP_THREADS,
                           SWEEP_THREADS, 0, s>>>(row, links, labels, out, m);
  return (int)cudaGetLastError();
}

extern "C" const char* nbk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
