"""The FOF sweeps' column table, link list and two sweep modes
(``ops/fof_cuda.py``), on the CPU through their plain versions, against
``searchsorted``, a brute-force O(n^2) pair list and the JAX package's
``neighbor_min`` fold and ``local_fof_labels``: f4 and f8, periodic and
open, uniform and clustered, grids of 1, 2 and 3 cells on an axis, and a
grid of int64 cell ids; the column-table entries of the link kernels'
byte bound; and a model of the link kernels' tile design
(``csrc/variants/fof_links_tiles.cu``; ``link_rounds``, here): every
plain pair inside its query's staged ranges, and the staged walk
emulated row by row. Every comparison is exact (integer outputs)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu.ops import devicehash as jdh
from nbodykit_tpu_torch.lab import FOF, ArrayCatalog
from nbodykit_tpu_torch.ops import devicehash as tdh
from nbodykit_tpu_torch.ops import fof_cuda

N = 3000
BOX = 100.0
LL = 0.4 * BOX / N ** (1. / 3)      # 2.77: a 36^3 grid
NTINY = 400
TINY_LL = 1.0


@pytest.fixture(autouse=True)
def _on_cpu():
    # one intra-op thread: the plain sweeps are many small ops, and the
    # thread pools of parallel test workers slow each by milliseconds
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with nbodykit_tpu_torch.set_options(device='cpu'):
            yield
    finally:
        torch.set_num_threads(threads)


def positions(kind, dtype, box, ll, n, seed=5):
    """Uniform in the box, or clustered: three quarters in Gaussian
    blobs of 0.6 ll around n / 40 centres (some across the boundary),
    the rest uniform."""
    box = np.ones(3) * np.asarray(box, 'f8')
    rng = np.random.RandomState(seed)
    if kind == 'uniform':
        pos = rng.uniform(0, 1, (n, 3)) * box
    else:
        nc = max(n // 40, 2)
        centres = rng.uniform(0, 1, (nc, 3)) * box
        centres[:2, 0] = [0.05 * ll, box[0] - 0.05 * ll]
        nblob = (3 * n) // 4
        pos = np.concatenate([
            centres[rng.randint(nc, size=nblob)]
            + rng.normal(scale=0.6 * ll, size=(nblob, 3)),
            rng.uniform(0, 1, (n - nblob, 3)) * box])
        pos = np.mod(pos, box)
    return pos.astype(dtype)


# (label, dtype, kind, periodic, box, ll, n): the 36^3 grid, and grids
# of 1, 2 and 3 cells on an axis (box / ll = 1.5, 2.5, 3.5)
CASES = [('%s-%s-%s' % (dt, kind, 'periodic' if per else 'open'),
          dt, kind, per, BOX, LL, N)
         for dt in ('f4', 'f8') for kind in ('uniform', 'clustered')
         for per in (True, False)]
TINY = [('cells%s-%s-%s' % (''.join(map(str, nc)), dt,
                            'periodic' if per else 'open'),
         dt, 'clustered', per, (np.asarray(nc) + 0.5) * TINY_LL, TINY_LL,
         NTINY)
        for nc, dt, per in [((1, 1, 1), 'f8', True), ((2, 2, 2), 'f4', True),
                            ((3, 3, 3), 'f8', True), ((1, 2, 3), 'f4', True),
                            ((3, 1, 2), 'f8', False),
                            ((2, 3, 1), 'f4', False)]]
ALL = CASES + TINY
IDS = [c[0] for c in ALL]
# against JAX (one jit a case): each dtype, boundary and kind twice on
# the 36^3 grid, and every tiny grid but the (3, 3, 3) one
JAX_CASES = [CASES[i] for i in (0, 3, 6, 5)] + TINY[:2] + TINY[3:]
JAX_IDS = [c[0] for c in JAX_CASES]


def case_grid(case, invalid=True):
    """(positions, valid, box, ll, periodic, the port's grid) of a case;
    every 53rd slot invalid."""
    _, dt, kind, periodic, box, ll, n = case
    pos = positions(kind, dt, box, ll, n)
    valid = np.ones(n, bool)
    if invalid:
        valid[7::53] = False
    box = np.ones(3) * np.asarray(box, 'f8')
    grid = tdh.DeviceGridHash(torch.as_tensor(pos), box, ll,
                              valid=torch.as_tensor(valid),
                              periodic=periodic)
    return pos, valid, box, ll, periodic, grid


def brute_pairs(grid, ll):
    """Every (i, j != i) of the sorted arrays with valid i and j and
    r2 <= ll2, the plain version's float operations in numpy (round half
    to even, the positions' dtype), sorted by i, then j."""
    p = grid.pos_s.numpy()
    valid = grid.valid_s.numpy()
    ll2 = p.dtype.type(float(ll) ** 2)
    box = grid.box_np.astype(p.dtype)
    ii, jj = [], []
    for i0 in range(0, len(p), 500):
        d = p[None, :, :] - p[i0:i0 + 500, None, :]
        if grid.periodic:
            d = d - np.round(d / box) * box
        r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        ok = (r2 <= ll2) & valid[i0:i0 + 500, None] & valid[None, :]
        i, j = np.nonzero(ok)
        keep = i + i0 != j
        ii.append(i[keep] + i0)
        jj.append(j[keep])
    return np.concatenate(ii), np.concatenate(jj)


def link_list(grid, ci_s, ll):
    """(row, links): the CSR row offsets (the cumsum of the link counts)
    and the link list of a grid, through ``fof_cuda``'s dispatch."""
    sorted_args = (grid.pos_s, ci_s, grid.flat_s, grid.valid_s,
                   grid.columns())
    geo = grid.geometry(ll ** 2)
    counts = fof_cuda.fof_link_count(*sorted_args, *geo)
    row = torch.zeros(counts.shape[0] + 1, dtype=torch.int64)
    torch.cumsum(counts, 0, out=row[1:])
    return row, fof_cuda.fof_link_fill(*sorted_args, row, *geo)


def search_fixpoint(grid, ll):
    """The search mode's fixpoint: (labels, sweeps)."""
    ci_s = grid.cell_of(grid.pos_s)
    return tdh.sweep_to_fixpoint(lambda lab: grid.sweep(ci_s, lab, ll ** 2),
                                 grid.pos_s.shape[0], grid.pos_s.device)


@pytest.mark.parametrize('case', ALL, ids=IDS)
def test_column_table_equals_searchsorted(case):
    *_, grid = case_grid(case)
    cols = fof_cuda.column_table(grid.flat_s, grid.ncell_np)
    nc0, nc1, nc2 = grid.ncell_np
    flat = grid.flat_s.numpy()
    keys = np.arange(nc0 * nc1 + 1, dtype='i8') * nc2
    assert cols.dtype == torch.int32 and cols.shape == (nc0 * nc1 + 1,)
    np.testing.assert_array_equal(cols.numpy(),
                                  np.searchsorted(flat, keys))
    # the same table from the live particles' column counts
    live = flat[flat < grid.ncells_tot]
    counts = np.bincount(live // nc2, minlength=nc0 * nc1)
    np.testing.assert_array_equal(cols.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))


def test_column_table_of_int64_ids():
    """A grid of 2048 x 1024 x 1024 cells takes int64 ids; its table
    (2**21 + 1 entries) still holds int32 slots."""
    rng = np.random.RandomState(2)
    nc = np.array([2048, 1024, 1024])
    flat = torch.as_tensor(np.sort(np.concatenate([
        rng.randint(0, 2 ** 31, 5000), np.full(7, 2 ** 31)])))
    cols = fof_cuda.column_table(flat, nc)
    assert cols.dtype == torch.int32 and cols.shape == (2 ** 21 + 1,)
    np.testing.assert_array_equal(
        cols.numpy(), np.searchsorted(flat.numpy(),
                                      np.arange(2 ** 21 + 1) * 1024))
    assert int(cols[-1]) == 5000


@pytest.mark.parametrize('case', ALL, ids=IDS)
def test_plain_links_equal_brute_force(case):
    """The plain link list (per offset with searchsorted, as the plain
    sweep) holds exactly the pairs of an O(n^2) search, sorted within
    each row, each pair once."""
    *_, ll, _, grid = case_grid(case)
    row, links = link_list(grid, grid.cell_of(grid.pos_s), ll)
    bi, bj = brute_pairs(grid, ll)
    assert row.dtype == torch.int64 and links.dtype == torch.int32
    np.testing.assert_array_equal(
        np.diff(row.numpy()), np.bincount(bi, minlength=row.shape[0] - 1))
    np.testing.assert_array_equal(links.numpy(), bj)
    assert len(bj) > 50                            # links were made
    assert not np.diff(row.numpy())[~grid.valid_s.numpy()].any()


@pytest.mark.parametrize('dt', ['f4', 'f8'])
def test_links_on_int64_ids_equal_brute_force(dt):
    """A grid of 2**31 cells (int64 ids): the link list, and both
    modes' fixpoint labels."""
    box, ll = np.array([2048.0, 1024.0, 1024.0]), 1.0
    pos = positions('clustered', dt, box, ll, 1500, seed=8)
    grid = tdh.DeviceGridHash(torch.as_tensor(pos), box, ll)
    assert grid.flat_s.dtype == torch.int64
    row, links = link_list(grid, grid.cell_of(grid.pos_s), ll)
    bi, bj = brute_pairs(grid, ll)
    np.testing.assert_array_equal(links.numpy(), bj)
    np.testing.assert_array_equal(
        np.diff(row.numpy()), np.bincount(bi, minlength=len(pos)))
    assert len(bj) > 500
    stats = {}
    a, sa, _ = tdh.fof_fixpoint(grid, ll, stats=stats)
    b, sb = search_fixpoint(grid, ll)
    assert stats == {'sweep_mode': 'links', 'links': len(bj)}
    assert torch.equal(a, b) and sa == sb >= 2


_jax_sweep = {}


def jax_neighbor_min(case, labels):
    """JAX's fold with ``neighbor_min``'s body (devicehash.py:190-194)
    on arbitrary labels (one jit per case, shared)."""
    pos, valid, box, ll, periodic, _ = case_grid(case)
    if case[0] not in _jax_sweep:
        def sweep(p, v, lab):
            grid = jdh.DeviceGridHash(p, box, ll, valid=v, periodic=periodic)
            ci_s = grid.cell_of(grid.pos_s)
            ll2 = jnp.asarray(float(ll) ** 2, p.dtype)
            vs = grid.valid_s

            def body(best, j, ok, d, r2):
                ok = ok & vs & (r2 <= ll2)
                return jnp.minimum(best, jnp.where(ok, lab[j], best))
            return grid.fold(grid.pos_s, ci_s, body, lab)
        _jax_sweep[case[0]] = jax.jit(sweep)
    return np.asarray(_jax_sweep[case[0]](pos, valid, labels))


@pytest.mark.parametrize('mode', ['links', 'search'])
@pytest.mark.parametrize('case', JAX_CASES, ids=JAX_IDS)
def test_one_sweep_equals_jax_neighbor_min(case, mode):
    """One sweep of either mode on arbitrary labels (not the first
    sweep's arange) against JAX's fold."""
    *_, ll, _, grid = case_grid(case)
    n = grid.pos_s.shape[0]
    labels = np.random.RandomState(3).randint(0, n, n).astype('i4')
    want = jax_neighbor_min(case, labels)
    ci_s = grid.cell_of(grid.pos_s)
    lab = torch.as_tensor(labels)
    if mode == 'links':
        got = fof_cuda.fof_links_sweep(*link_list(grid, ci_s, ll), lab)
    else:
        got = grid.sweep(ci_s, lab, ll ** 2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != labels).sum() > 20      # the sweep did work


_jax_roots = {}


def jax_roots(case):
    """JAX's ``local_fof_labels`` (one jit per case, shared)."""
    if case[0] not in _jax_roots:
        pos, valid, box, ll, periodic, _ = case_grid(case)
        _jax_roots[case[0]] = np.asarray(jax.jit(
            lambda p, v: jdh.local_fof_labels(
                p, v, box, ll, periodic=periodic))(pos, valid))
    return _jax_roots[case[0]]


@pytest.mark.parametrize('mode', ['links', 'search'])
@pytest.mark.parametrize('case', JAX_CASES, ids=JAX_IDS)
def test_local_fof_labels_equal_jax(case, mode, monkeypatch):
    """Each mode's labels against JAX's: links where the list fits the
    free memory, search where none is free."""
    pos, valid, box, ll, periodic, _ = case_grid(case)
    if mode == 'search':
        monkeypatch.setattr(tdh, 'fits', lambda nbytes, device: False)
    stats = {}
    got = tdh.local_fof_labels(torch.as_tensor(pos), torch.as_tensor(valid),
                               box, ll, periodic=periodic, stats=stats)
    np.testing.assert_array_equal(got.numpy(), jax_roots(case))
    assert stats['sweep_mode'] == mode and stats['sweeps'] >= 2
    assert stats['links'] > 50


def test_mode_follows_free_device_memory(monkeypatch):
    """The links mode while the list (4 bytes a link) and the fixpoint's
    label arrays fit the free bytes, search beyond them; the labels and
    sweeps are the same, and equal the search sweep's own fixpoint."""
    assert tdh.fits(2 ** 62, torch.device('cpu'))          # no limit
    case = CASES[2]                                 # f4 clustered periodic
    *_, ll, _, grid = case_grid(case)
    n = grid.pos_s.shape[0]
    stats = {}
    la, sa, _ = tdh.fof_fixpoint(grid, ll, stats=stats)
    E = stats['links']
    assert stats['sweep_mode'] == 'links' and E > 1000
    need = 4 * E + tdh.FIXPOINT_LABEL_BYTES * n
    for free, mode in ((need, 'links'), (need - 1, 'search'), (0, 'search')):
        monkeypatch.setattr(tdh, 'fits',
                            lambda nbytes, device, f=free: nbytes <= f)
        stats = {}
        lb, sb, _ = tdh.fof_fixpoint(grid, ll, stats=stats)
        assert stats == {'sweep_mode': mode, 'links': E}
        assert torch.equal(la, lb) and sa == sb
    lc, sc = search_fixpoint(grid, ll)
    assert torch.equal(la, lc) and sa == sc


@pytest.mark.parametrize('free', [None, 0])
def test_fof_reports_its_mode(free, monkeypatch):
    """FOF keeps the mode its fixpoint took, the link count and the
    sweeps: links where the list fits, search where no memory is free,
    with the same labels."""
    pos = positions('clustered', 'f8', BOX, LL, N)
    cat = ArrayCatalog({'Position': pos}, BoxSize=BOX)
    ref = FOF(cat, linking_length=0.4, nmin=5)
    if free is not None:
        monkeypatch.setattr(tdh, 'fits', lambda nbytes, device: False)
    fof = FOF(cat, linking_length=0.4, nmin=5)
    assert ref.sweep_mode == 'links' and ref.links > 1000
    assert fof.sweep_mode == ('links' if free is None else 'search')
    assert fof.links == ref.links and fof.sweeps == ref.sweeps >= 2
    assert torch.equal(fof.labels, ref.labels)


def test_links_sweep_plain_is_a_row_min():
    """The CSR sweep on a hand-made list: empty rows keep their label,
    and a row's min takes its own label into account."""
    row = torch.tensor([0, 2, 2, 3, 5], dtype=torch.int64)
    links = torch.tensor([1, 3, 0, 0, 1], dtype=torch.int32)
    labels = torch.tensor([7, 4, 1, 9], dtype=torch.int32)
    out = fof_cuda.fof_links_sweep_plain(row, links, labels)
    np.testing.assert_array_equal(out.numpy(), [4, 4, 1, 4])
    with pytest.raises(ValueError):
        fof_cuda.fof_links_sweep_plain(row[:-1], links, labels)


@pytest.mark.parametrize('periodic', [True, False])
@pytest.mark.parametrize('ncell', [[1, 1, 1], [2, 3, 1], [3, 2, 5]])
def test_axis_offsets_of_neighbor_offsets(ncell, periodic):
    """The per-axis runs the kernels take, for every grid the offsets
    come from; other offset sets are refused."""
    from nbodykit_tpu_torch.ops.gridhash import neighbor_offsets
    offs = neighbor_offsets(ncell, periodic)
    dlo, dhi = fof_cuda.axis_offsets(offs)
    for k, n in enumerate(ncell):
        span = {1: (0, 0), 2: (0, 1) if periodic else (-1, 1)}.get(n,
                                                                   (-1, 1))
        assert (dlo[k], dhi[k]) == span
    assert len(offs) == np.prod([b - a + 1 for a, b in zip(dlo, dhi)])


@pytest.mark.parametrize('offsets', [[(0, 0, 0), (1, 1, 1)],
                                     [(0, 0, 2), (0, 0, 0)],
                                     [(1, 0, 0)]])
def test_axis_offsets_refuse_other_sets(offsets):
    with pytest.raises(ValueError):
        fof_cuda.axis_offsets(offsets)


def test_new_wrappers_refuse_cpu_tensors():
    n = 4
    args = (torch.zeros((n, 3)), torch.zeros((n, 3), dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool),
            torch.zeros(2, dtype=torch.int32))
    geo = ([(0, 0, 0)], [1, 1, 1], [1.0, 1.0, 1.0], 0.01, True)
    row = torch.zeros(n + 1, dtype=torch.int64)
    with pytest.raises(ValueError, match='CUDA tensors'):
        fof_cuda.fof_link_count_cuda(*args, *geo)
    with pytest.raises(ValueError, match='CUDA tensors'):
        fof_cuda.fof_link_fill_cuda(*args, row, *geo)
    with pytest.raises(ValueError, match='CUDA tensors'):
        fof_cuda.fof_links_sweep_cuda(row, torch.zeros(0, dtype=torch.int32),
                                      torch.arange(n, dtype=torch.int32))


# A model of the link kernels' tile design in torch
# (``csrc/variants/fof_links_tiles.cu`` ``axis_runs``, ``plan_range``,
# ``plan_offsets`` and ``link_tile``), for the tests below. The kernels as
# built take a query a thread; the tile design is kept as a variant that
# the card times beside them.
TILES_CU = os.path.join(os.path.dirname(fof_cuda.__file__), os.pardir,
                        'csrc', 'variants', 'fof_links_tiles.cu')


def tiles_define(name):
    """An integer ``#define`` of the tile design's source."""
    with open(TILES_CU) as f:
        return int(re.search(r'^#define %s (\w+)' % name, f.read(),
                             re.M).group(1))


# queries a tile (threads a CTA), shared bytes of a round's staged keys,
# column-table entries and column masks, slot ranges a round (3 planes x
# 2 pieces of b), the ints of a round's plan, and the cells along c up
# to which a staged column's mask holds a bit a cell
LINK_THREADS = tiles_define('LINK_THREADS')
LINK_STAGE_BYTES = tiles_define('LINK_STAGE_BYTES')
LINK_RANGES = tiles_define('LINK_RANGES')
LINK_PLAN_INTS = tiles_define('LINK_PLAN_INTS')
LINK_EXACT_CELLS = tiles_define('LINK_EXACT_CELLS')
MSHIFT_RULE = '''  if (ncell[2] > LINK_EXACT_CELLS)
    while ((ncell[2] - 1) >> g.mshift >= 256) ++g.mshift;
  g.mwords = (((ncell[2] - 1) >> g.mshift) >> 5) + 1;'''


def mask_shift(ncell):
    """The shift of a staged column's mask: bit ``c >> shift`` holds
    cell c along c; 0 up to ``LINK_EXACT_CELLS`` cells, else the least
    that keeps 256 bits (``Geo::mshift``, ``MSHIFT_RULE``)."""
    shift = 0
    if int(ncell[2]) > LINK_EXACT_CELLS:
        while (int(ncell[2]) - 1) >> shift >= 256:
            shift += 1
    return shift


def mask_words(ncell):
    """32-bit words of a staged column's mask (``Geo::mwords``)."""
    return (((int(ncell[2]) - 1) >> mask_shift(ncell)) >> 5) + 1


def test_link_kernels_match_their_source():
    """The tile design's tile, stage, ranges and plan as its source
    states them; its static shared memory fits a CTA's 48 KB and lets 10
    CTAs (1280 threads) share an SM's 228 KB; the mask rule is the
    source's; the kernels as built and the first design keep 256 threads
    a block."""
    assert (LINK_THREADS, LINK_STAGE_BYTES, LINK_RANGES, LINK_PLAN_INTS,
            LINK_EXACT_CELLS) == (128, 20480, 6, 53, 1088)
    # the plan: the group (3), the b pieces (3), 7 ints a range, the
    # stage's keys, entries, fit and stop, one of padding (5)
    assert LINK_PLAN_INTS == 3 + 3 + 7 * LINK_RANGES + 5
    smem = LINK_STAGE_BYTES + 4 * LINK_PLAN_INTS
    assert smem == 20480 + 4 * 53 <= 48 * 1024
    assert 10 * (smem + 1024) <= 228 * 1024
    with open(TILES_CU) as f:
        assert MSHIFT_RULE in f.read()
    csrc = os.path.dirname(os.path.dirname(TILES_CU))
    for source in ('fof_sweep.cu', 'variants/fof_links_first_design.cu'):
        with open(os.path.join(csrc, source)) as f:
            assert re.search(r'^#define SWEEP_THREADS 256$', f.read(), re.M)
    assert fof_cuda.SWEEP_THREADS == 256
    # the column masks: a bit a cell up to LINK_EXACT_CELLS (the FOF
    # flow's 1077 cells: 34 words), then 256 bits (4096 cells: a bit for
    # 16, 8 words)
    for nc2, shift, words in ((1, 0, 1), (100, 0, 4), (1077, 0, 34),
                              (1088, 0, 34), (1089, 3, 5), (4096, 4, 8)):
        assert mask_shift([1, 1, nc2]) == shift
        assert mask_words([1, 1, nc2]) == words


def _axis_runs(cmin, cmax, n, dlo, dhi, periodic):
    """``grid_columns.cuh`` ``axis_runs`` over int64 tensors, for the
    cells reached from every cell in [cmin, cmax] (offsets [dlo, dhi]):
    (lo0, hi0, lo1, hi1, m), at most two runs, the second above."""
    lo, hi = cmin + dlo, cmax + dhi
    zero = torch.zeros_like(lo)
    if not periodic:
        return (lo.clamp(min=0), hi.clamp(max=n - 1), zero, zero,
                torch.ones_like(lo))
    cover = hi - lo + 1 >= n
    below = ~cover & (lo < 0)
    above = ~cover & ~below & (hi >= n)
    wrap = below | above
    lo0 = torch.where(cover | wrap, zero, lo)
    hi0 = torch.where(cover, n - 1, torch.where(above, hi - n, hi))
    lo1 = torch.where(below, lo + n, torch.where(above, lo, zero))
    hi1 = torch.where(wrap, n - 1, zero)
    return lo0, hi0, lo1, hi1, 1 + wrap.long()


def _cells_of(runs, t):
    """(the t-th cell of the runs, whether it exists)."""
    lo0, hi0, lo1, hi1, m = runs
    len0 = hi0 - lo0 + 1
    count = len0 + torch.where(m == 2, hi1 - lo1 + 1, 0)
    return torch.where(t < len0, lo0 + t, lo1 + t - len0), t < count


def round_ranges(a, bmin, bhi, cols, ncell, dlo, dhi, periodic):
    """The slot ranges the link kernels stage for rounds of plane ``a``
    and b in [bmin, bhi] ((m,) int64 each): ((m, LINK_RANGES, 2) slots
    [lo, hi), (m, LINK_RANGES) columns, (m, LINK_RANGES) first column
    index, the b pieces (lo0, hi0, lo1), and whether a's planes wrap);
    range t is plane ``t // 2`` of a's neighbour planes and piece ``t %
    2`` of b's, empty where either does not exist (``plan_range``)."""
    nc0, nc1 = int(ncell[0]), int(ncell[1])
    ra = _axis_runs(a, a, nc0, dlo[0], dhi[0], periodic)
    rb = _axis_runs(bmin, bhi, nc1, dlo[1], dhi[1], periodic)
    cols = cols.long()
    slots, ncols, col0s = [], [], []
    for t in range(LINK_RANGES):
        va, ok = _cells_of(ra, torch.full_like(a, t // 2))
        piece = t % 2
        ok = ok & (rb[4] > piece)
        lo, hi = (rb[2], rb[3]) if piece else (rb[0], rb[1])
        ncol = torch.where(ok, hi - lo + 1, 0)
        col0 = torch.where(ok, va * nc1 + lo, 0)
        s0 = torch.where(ok, cols[col0], 0)
        s1 = torch.where(ok, cols[col0 + ncol], 0)
        slots.append(torch.stack([s0, s1], -1))
        ncols.append(ncol)
        col0s.append(col0)
    return (torch.stack(slots, 1), torch.stack(ncols, 1),
            torch.stack(col0s, 1), (rb[0], rb[1], rb[2]), ra[4] == 2)


def link_rounds(ci_s, searching, cols, ncell, offsets, periodic, key_bytes,
                threads=LINK_THREADS,
                stage_bytes=LINK_STAGE_BYTES):
    """A model of the link kernels' rounds: the rounds of their tiles
    computed in torch as ``csrc/fof_sweep.cu`` ``link_tile`` computes
    them, for every tile at once. Nothing checks it against the kernel
    (the card's bit-for-bit checks of the counts and lists are the
    kernel's test); these tests check the design it describes.

    ci_s : (n, 3) int32 cell coordinates of the sorted queries;
    searching : (n,) bool, the queries that search (valid; for the fill
    also a non-empty row); cols : the column table; key_bytes : 4 or 8.
    A tile is ``threads`` consecutive queries; each round takes the
    searching queries of the least plane a left in it with b in [bmin,
    bhi], bhi halved from the greatest b until the round is final
    (``plan_offsets``): sparse (more column-table entries than keys: it
    walks global memory), or its keys and entries (4 bytes an entry and
    ``mask_words(ncell) * 4`` of its column's mask) fit ``stage_bytes``
    (staged), or one column that does not fit (global).
    Returns a dict of tensors on ``ci_s``'s device: ``round_of`` (n,)
    int64 (-1 for a query that does not search), and for each round
    ``tile``, ``staged`` (False: its queries walk global memory),
    ``sparse``, ``halved`` (bhi below the plane's greatest b), ``slots``
    (R, LINK_RANGES, 2), ``ncol``, ``col0``, ``pieces`` (R, 3: b pieces
    lo0, hi0, lo1), ``a_wrapped`` (its planes wrap), ``keys`` and ``entries``
    (R,); ``c_wrapped``, the searching queries whose cells along c
    wrap (an int)."""
    n = ci_s.shape[0]
    dev = ci_s.device
    dlo, dhi = fof_cuda.axis_offsets(offsets)
    big = 2 ** 62
    nt = -(-n // threads)
    pad = nt * threads - n

    def tiled(x, fill):
        return torch.nn.functional.pad(x, (0, pad), value=fill).view(
            nt, threads)
    a = tiled(ci_s[:, 0].long(), 0)
    b = tiled(ci_s[:, 1].long(), 0)
    pending = tiled(searching.to(torch.int64), 0).bool()
    round_of = torch.full((nt, threads), -1, dtype=torch.int64, device=dev)
    out = {k: [] for k in ('tile', 'staged', 'sparse', 'halved', 'slots',
                           'ncol', 'col0', 'pieces', 'a_wrapped', 'keys',
                           'entries')}
    words = mask_words(ncell)
    first = 0
    while True:
        tiles = torch.nonzero(pending.any(1)).flatten()
        if tiles.numel() == 0:
            break
        pend, at, bt = pending[tiles], a[tiles], b[tiles]
        ag = torch.where(pend, at, big).amin(1)
        group = pend & (at == ag[:, None])
        bmin = torch.where(group, bt, big).amin(1)
        bmax = torch.where(group, bt, -1).amax(1)
        bhi = bmax.clone()
        while True:
            slots, ncol, col0, pieces, a_wrapped = round_ranges(
                ag, bmin, bhi, cols, ncell, dlo, dhi, periodic)
            keys = (slots[..., 1] - slots[..., 0]).sum(1)
            entries = torch.where(ncol > 0, ncol + 1, 0).sum(1)
            sparse = entries > keys
            fit = ~sparse & (key_bytes * keys + 4 * (words + 1) * entries
                             <= stage_bytes)
            more = ~(sparse | fit) & (bhi > bmin)
            if not bool(more.any()):
                break
            bhi = torch.where(more, bmin + (bhi - bmin) // 2, bhi)
        go = group & (bt <= bhi[:, None])
        ids = torch.arange(first, first + tiles.numel(), device=dev)
        round_of[tiles] = torch.where(go, ids[:, None], round_of[tiles])
        pending[tiles] = pend & ~go
        first += tiles.numel()
        for k, v in (('tile', tiles), ('staged', fit), ('sparse', sparse),
                     ('halved', bhi < bmax), ('slots', slots),
                     ('ncol', ncol), ('col0', col0),
                     ('pieces', torch.stack(pieces, 1)),
                     ('a_wrapped', a_wrapped), ('keys', keys),
                     ('entries', entries)):
            out[k].append(v)
    plan = {k: torch.cat(v) if v else torch.zeros(0, dtype=torch.int64,
                                                  device=dev)
            for k, v in out.items()}
    plan['round_of'] = round_of.flatten()[:n]
    c = ci_s[:, 2].long()
    plan['c_wrapped'] = int((_axis_runs(c, c, int(ncell[2]), dlo[2], dhi[2],
                                        periodic)[4] == 2)[searching].sum())
    return plan


# the link kernels' rounds (link_rounds) on every grid above,
# the two of int64 ids and one of 4096 cells along c (masks of a bit for
# 16 cells), with the kernels' stage and with one of 1,200 bytes that
# halves rounds and sends single columns to the global walk
INT64 = [('int64-%s' % dt, dt) for dt in ('f4', 'f8')] + [('coarse-f8', 'f8')]
STAGES = [LINK_STAGE_BYTES, 1200]


def round_grid(case):
    """(grid, ll) of a case of ALL or INT64."""
    if case[0] == 'coarse-f8':
        box, ll = np.array([8.0, 8.0, 4096.0]), 1.0
        pos = positions('clustered', 'f8', box, ll, 1500, seed=9)
        return tdh.DeviceGridHash(torch.as_tensor(pos), box, ll), ll
    if case[0].startswith('int64'):
        box, ll = np.array([2048.0, 1024.0, 1024.0]), 1.0
        pos = positions('clustered', case[1], box, ll, 1500, seed=8)
        return tdh.DeviceGridHash(torch.as_tensor(pos), box, ll), ll
    *_, ll, _, grid = case_grid(case)
    return grid, ll


def grid_rounds(grid, stage):
    ci_s = grid.cell_of(grid.pos_s)
    cols = fof_cuda.column_table(grid.flat_s, grid.ncell_np)
    return ci_s, cols, link_rounds(
        ci_s, grid.valid_s, cols, grid.ncell_np, grid.offsets, grid.periodic,
        grid.flat_s.element_size(), stage_bytes=stage)


@pytest.mark.parametrize('stage', STAGES)
@pytest.mark.parametrize('case', ALL + INT64, ids=IDS + [c[0] for c in INT64])
def test_link_rounds_cover_every_plain_pair(case, stage):
    """Every valid query takes one round of its own tile, every query of
    a round lies in one plane, and a staged round's slot ranges hold
    every j the plain list links to its queries (and fit the stage)."""
    grid, ll = round_grid(case)
    ci_s, cols, plan = grid_rounds(grid, stage)
    n = grid.pos_s.shape[0]
    r = plan['round_of']
    valid = grid.valid_s
    assert bool((r[valid] >= 0).all()) and bool((r[~valid] == -1).all())
    live = torch.nonzero(valid).flatten()
    assert torch.equal(plan['tile'][r[live]],
                       live // LINK_THREADS)
    # one plane a round
    a = ci_s[live, 0].long()
    amin = torch.full((plan['tile'].numel(),), 2 ** 40).scatter_reduce(
        0, r[live], a, 'amin')
    assert torch.equal(amin[r[live]], a)
    kb = grid.flat_s.element_size()
    staged = plan['staged']
    words = mask_words(grid.ncell_np)
    nbytes = kb * plan['keys'] + 4 * (words + 1) * plan['entries']
    assert bool((nbytes[staged] <= stage).all())
    assert not bool((staged & plan['sparse']).any())
    i, j = fof_cuda.fof_pairs_plain(grid.pos_s, ci_s, grid.flat_s, valid,
                                    *grid.geometry(ll ** 2))
    assert j.numel() > 50
    ri = r[i]
    lo, hi = plan['slots'][ri, :, 0], plan['slots'][ri, :, 1]
    inside = ((j[:, None] >= lo) & (j[:, None] < hi)).any(1)
    assert bool(inside[staged[ri]].all())
    if stage < LINK_STAGE_BYTES:
        # rounds halved, or (a grid of one column) walked globally
        assert int(plan['halved'].sum()) + int((~staged).sum()) > 0


def np_runs(c, n, dlo, dhi, periodic):
    """grid_columns.cuh axis_runs: [(lo, hi), ...] in increasing order."""
    lo, hi = c + dlo, c + dhi
    if not periodic:
        return [(max(lo, 0), min(hi, n - 1))]
    if hi - lo + 1 >= n:
        return [(0, n - 1)]
    if lo < 0:
        return [(0, hi), (lo + n, n - 1)]
    if hi >= n:
        return [(0, hi - n), (lo, n - 1)]
    return [(lo, hi)]


@pytest.mark.parametrize('case', ALL + INT64, ids=IDS + [c[0] for c in INT64])
def test_link_table_entries_count_the_reached_columns(case):
    """The column-table entries of the link kernels' byte bound: for the
    valid queries (and for a third of them), the first and the one-past
    entry of every neighbour column, counted once, as a set built query
    by query in Python."""
    grid, _ = round_grid(case)
    ci_s = grid.cell_of(grid.pos_s)
    nc = [int(v) for v in grid.ncell_np]
    dlo, dhi = fof_cuda.axis_offsets(grid.offsets)
    for searching in (grid.valid_s,
                      grid.valid_s & (torch.arange(len(ci_s)) % 3 == 0)):
        want = set()
        for a, b, _ in ci_s[searching].tolist():
            for la, ha in np_runs(a, nc[0], dlo[0], dhi[0], grid.periodic):
                for lb, hb in np_runs(b, nc[1], dlo[1], dhi[1],
                                      grid.periodic):
                    for va in range(la, ha + 1):
                        for vb in range(lb, hb + 1):
                            want |= {va * nc[1] + vb, va * nc[1] + vb + 1}
        got = fof_cuda.link_table_entries(ci_s, searching, grid.ncell_np,
                                          grid.offsets, grid.periodic)
        assert got == len(want) <= nc[0] * nc[1] + 1


def emulated_rows(grid, ll, ci_s, cols, plan):
    """{query: [j, ...]} of every query of a staged round, built as the
    kernels build it (``plan_offsets``, ``stage_round``,
    ``staged_links``): the round's keys and column-table entries staged
    range by range, each column's mask (bit ``c >> mask_shift`` for
    cell c) from its staged keys, a column skipped where its mask holds
    none of the query's bits, each column's bounds rebased from the
    staged entries, a lower bound in the staged keys, the walk to the
    run's end, the query
    itself skipped, the minimum image divided only past a quarter box,
    in numpy in the positions' dtype."""
    flat, colsn = grid.flat_s.numpy(), cols.numpy().astype('i8')
    pos, ci = grid.pos_s.numpy(), ci_s.numpy()
    nc = [int(v) for v in grid.ncell_np]
    dlo, dhi = fof_cuda.axis_offsets(grid.offsets)
    per = grid.periodic
    dt = pos.dtype.type
    box = grid.box_np.astype(pos.dtype)
    qbox = box * dt(0.25)
    ll2 = dt(float(ll) ** 2)
    sh = mask_shift(grid.ncell_np)
    round_of = plan['round_of'].numpy()
    rows = {}
    for rd in np.nonzero(plan['staged'].numpy())[0]:
        slots = plan['slots'][rd].numpy()
        ncol, col0 = plan['ncol'][rd].numpy(), plan['col0'][rd].numpy()
        blo0, bhi0, blo1 = plan['pieces'][rd].tolist()
        skeys, sent, e0, shift = [], [], [], []
        for t in range(LINK_RANGES):
            e0.append(len(sent))
            shift.append(len(skeys) - int(slots[t, 0]))
            if ncol[t] > 0:
                skeys.extend(flat[slots[t, 0]:slots[t, 1]].tolist())
                sent.extend(colsn[col0[t]:col0[t] + ncol[t] + 1].tolist())
        sbits = {}
        for t in range(LINK_RANGES):
            for x in range(ncol[t]):
                e, base = e0[t] + x, int(col0[t] + x) * nc[2]
                sbits[e] = 0
                for u in range(sent[e] + shift[t], sent[e + 1] + shift[t]):
                    sbits[e] |= 1 << ((skeys[u] - base) >> sh)
        for i in np.nonzero(round_of == rd)[0]:
            a, b, c = (int(v) for v in ci[i])
            out = []

            def walk(u, ue, khi, sh):
                while u < ue and skeys[u] <= khi:
                    j = u - sh
                    if j != i:
                        d = pos[j] - pos[i]
                        if per:
                            far = np.abs(d) > qbox
                            d = np.where(far, d - np.round(d / box) * box, d)
                        r2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
                        if r2 <= ll2:
                            out.append(j)
                    u += 1
                return u
            cells_a = [v for lo, hi in np_runs(a, nc[0], dlo[0], dhi[0], per)
                       for v in range(lo, hi + 1)]
            cells_b = [v for lo, hi in np_runs(b, nc[1], dlo[1], dhi[1], per)
                       for v in range(lo, hi + 1)]
            rc = np_runs(c, nc[2], dlo[2], dhi[2], per)
            want = 0
            for lo, hi in rc:
                want |= sum(1 << k for k in range(lo >> sh, (hi >> sh) + 1))
            for ka, va in enumerate(cells_a):
                for vb in cells_b:
                    piece = int(vb > bhi0)
                    t = 2 * ka + piece
                    e = e0[t] + vb - (blo1 if piece else blo0)
                    if not sbits[e] & want:
                        continue
                    us, ue = sent[e] + shift[t], sent[e + 1] + shift[t]
                    base = (va * nc[1] + vb) * nc[2]
                    u = us
                    for lo, hi in rc:
                        # lower_bound in [u, ue), then the walk
                        u += int(np.searchsorted(skeys[u:ue], base + lo))
                        u = walk(u, ue, base + hi, shift[t])
            rows[int(i)] = out
    return rows


@pytest.mark.parametrize('stage', STAGES)
@pytest.mark.parametrize('case', ALL + INT64, ids=IDS + [c[0] for c in INT64])
def test_staged_walk_gives_the_plain_rows(case, stage):
    """The kernels' staged walk, emulated on the rounds, gives every
    staged query's row of the plain list: the same slots in the same
    order (the minimum image skipped below a quarter box, bit for bit)."""
    grid, ll = round_grid(case)
    ci_s, cols, plan = grid_rounds(grid, stage)
    row, links = link_list(grid, ci_s, ll)
    rows = emulated_rows(grid, ll, ci_s, cols, plan)
    r = plan['round_of'][grid.valid_s]
    assert len(rows) == int(plan['staged'][r].sum())
    if stage == LINK_STAGE_BYTES:
        # every round is staged but a sparse one (the int64 grids')
        assert bool((plan['staged'] | plan['sparse']).all())
    for i, got in rows.items():
        want = links[row[i]:row[i + 1]].tolist()
        assert got == want, (i, got, want)
