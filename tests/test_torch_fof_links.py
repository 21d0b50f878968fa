"""The FOF sweeps' column table, link list and two sweep modes
(``ops/fof_cuda.py``), on the CPU through their plain versions, against
``searchsorted``, a brute-force O(n^2) pair list and the JAX package's
``neighbor_min`` fold and ``local_fof_labels``: f4 and f8, periodic and
open, uniform and clustered, grids of 1, 2 and 3 cells on an axis, and a
grid of int64 cell ids. Every comparison is exact (integer outputs)."""

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
