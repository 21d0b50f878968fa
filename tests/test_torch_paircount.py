"""Pair counting through the PyTorch port and the JAX package on the same
seeded numpy inputs: ``core.paircount`` in every mode, auto and cross,
periodic and open, axis and midpoint line of sight (``npairs`` exact,
``wnpairs`` to 1e-12 relative); a lattice whose separations fall on the
integer edges; ``paircount_hist_plain`` against the JAX fold body itself
(every slot of the flat histograms); the two count classes, with their
totals; the JSON round trip of a count. The host-side pieces of the
Hopper kernel's design: its bin table and lookup against np.digitize on
the chip path's edges, and each pair counted once (an auto count's
pair bin is the same from either end) against every query counting
every candidate."""

import functools

import numpy as np
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu.algorithms.pair_counters import core as jcore
from nbodykit_tpu.algorithms.pair_counters import (
    SimulationBoxPairCount as JSimBox, SurveyDataPairCount as JSurvey)
from nbodykit_tpu.cosmology import Planck15 as JPlanck15
from nbodykit_tpu.ops.gridhash import GridHash as JGridHash
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JArray
from nbodykit_tpu_torch.algorithms.pair_counters import core as tcore
from nbodykit_tpu_torch.cosmology import Planck15
from nbodykit_tpu_torch.lab import (ArrayCatalog, PairCountBase,
                                    SimulationBoxPairCount,
                                    SurveyDataPairCount)
from nbodykit_tpu_torch.ops.devicehash import GridHash
from nbodykit_tpu_torch.ops import paircount_cuda as pc
from nbodykit_tpu_torch.ops.paircount_cuda import paircount_hist_plain

BOX = 100.0
N1, N2 = 1200, 900
EDGES = np.linspace(3.0, 18.0, 6)
RP_EDGES = np.array([1.0, 2.5, 5.0, 8.0, 12.0])
PIMAX = 12
THETA = np.array([0.5, 2.0, 4.0, 7.0, 10.0])
# the survey observer sits at -SHIFT of the work coordinates
SHIFT = np.array([300.0, 200.0, 250.0])
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _on_cpu():
    # one intra-op thread: the plain folds are many small ops, and the
    # thread pools of parallel test workers slow each by milliseconds
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with nbodykit_tpu_torch.set_options(device='cpu'):
            yield
    finally:
        torch.set_num_threads(threads)


def inputs(mode):
    """(pos1, w1, pos2, w2): uniform in the box, or unit vectors in a
    band of the sky for 'angular'."""
    rng = np.random.RandomState(11)
    if mode == 'angular':
        def sky(n):
            ra = np.radians(rng.uniform(0, 60, n))
            dec = np.arcsin(rng.uniform(-0.4, 0.4, n))
            return np.stack([np.cos(dec) * np.cos(ra),
                             np.cos(dec) * np.sin(ra), np.sin(dec)], -1)
        p1, p2 = sky(N1), sky(N2)
    else:
        p1 = rng.uniform(0, BOX, (N1, 3))
        p2 = rng.uniform(0, BOX, (N2, 3))
    return p1, rng.uniform(0.5, 1.5, N1), p2, rng.uniform(0.5, 1.5, N2)


def case_kwargs(mode, periodic, los):
    kw = dict(mode=mode, periodic=periodic)
    if mode == '2d':
        kw['Nmu'] = 5
    if mode == 'projected':
        kw['pimax'] = PIMAX
    if los == 'midpoint':
        kw.update(pair_los='midpoint', grid_origin=SHIFT)
    return kw


def edges_of(mode):
    return {'angular': THETA, 'projected': RP_EDGES}.get(mode, EDGES)


@functools.lru_cache(maxsize=None)
def jax_counts(mode, auto, periodic, los):
    p1, w1, p2, w2 = inputs(mode)
    if auto:
        p2, w2 = p1, w1
    if los == 'midpoint':
        p1, p2 = p1 + SHIFT, p2 + SHIFT
    return jcore.paircount(p1, w1, p2, w2, np.full(3, BOX), edges_of(mode),
                           is_auto=auto, **case_kwargs(mode, periodic, los))


def port_counts(mode, auto, periodic, los):
    p1, w1, p2, w2 = inputs(mode)
    if auto:
        p2, w2 = p1, w1
    if los == 'midpoint':
        p1, p2 = p1 + SHIFT, p2 + SHIFT
    return tcore.paircount(p1, w1, p2, w2, np.full(3, BOX), edges_of(mode),
                           is_auto=auto, **case_kwargs(mode, periodic, los))


CASES = ([('1d', a, p, 'axis') for a in (True, False) for p in (True, False)]
         + [('angular', a, False, 'axis') for a in (True, False)]
         + [(m, a, p, los) for m in ('2d', 'projected')
            for a in (True, False) for p in (True, False)
            for los in ('axis', 'midpoint')])
IDS = ['%s-%s-%s-%s' % (m, 'auto' if a else 'cross',
                        'periodic' if p else 'open', los)
       for m, a, p, los in CASES]


def assert_counts(got, want):
    np.testing.assert_array_equal(got['npairs'], np.asarray(want['npairs']))
    w = np.asarray(want['wnpairs'])
    assert np.abs(got['wnpairs'] - w).max() <= RTOL * np.abs(w).max()


@pytest.mark.parametrize('mode,auto,periodic,los', CASES, ids=IDS)
def test_paircount_matches_jax(mode, auto, periodic, los):
    want = jax_counts(mode, auto, periodic, los)
    got = port_counts(mode, auto, periodic, los)
    assert got['npairs'].shape == np.asarray(want['npairs']).shape
    assert got['npairs'].sum() > 0
    assert_counts(got, want)


@pytest.mark.parametrize('mode', ['1d', 'projected'])
def test_lattice_pairs_on_the_edges(mode):
    """Integer positions and integer edges: r2 and rp2 fall exactly on
    the squared edges, and digitize puts them in the upper bin."""
    g = np.arange(8.0)
    pos = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    w = np.random.RandomState(3).uniform(0.5, 1.5, len(pos))
    kw = dict(mode=mode, is_auto=True)
    edges = np.array([1.0, 2.0, 3.0])
    if mode == 'projected':
        kw['pimax'] = 3
    want = jcore.paircount(pos, w, pos, w, np.full(3, 8.0), edges, **kw)
    got = tcore.paircount(pos, w, pos, w, np.full(3, 8.0), edges, **kw)
    assert_counts(got, want)
    if mode == '1d':
        # per point: r2 = 1, 2, 3 (6 + 12 + 8 neighbours) in [1, 2);
        # r2 = 4, 5, 6, 8 (6 + 24 + 24 + 12) in [2, 3); r2 = 9 past it
        np.testing.assert_array_equal(got['npairs'],
                                      [512 * 26.0, 512 * 66.0])


def jax_fold(pos2, w2, p1, w1, live, r2edges, mode, nb1, nb2, los,
             pair_los, origin, periodic, is_auto, rmax):
    import jax.numpy as jnp
    grid = JGridHash(pos2, np.full(3, BOX), rmax, periodic=periodic)
    w2_s = jnp.asarray(w2[grid.order])
    body = jcore._fold_body(grid, w2_s, jnp.asarray(r2edges), mode, nb1, nb2,
                            PIMAX, los, jnp.asarray(origin), pair_los,
                            is_auto, jnp.asarray(p1), jnp.asarray(w1),
                            jnp.asarray(live))
    nbins = (nb1 + 2) * nb2
    p1j = jnp.asarray(p1)
    out = grid.fold(p1j, grid.cell_of(p1j), body,
                    (jnp.zeros(nbins), jnp.zeros(nbins)))
    return np.asarray(out[0]), np.asarray(out[1])


@pytest.mark.parametrize('mode,periodic,pair_los', [
    ('2d', False, 'midpoint'), ('projected', True, 'axis')])
def test_plain_hist_matches_the_jax_fold_body(mode, periodic, pair_los):
    """Every slot of the flat histograms, the rows outside the edges
    included, for queries with dead entries, against the JAX package's
    ``_fold_body`` folded over its own ``GridHash``."""
    p1, w1, p2, w2 = inputs(mode)
    live = np.arange(N1) % 7 != 3
    edges = edges_of(mode)
    nb1 = len(edges) - 1
    nb2 = 5 if mode == '2d' else PIMAX
    rmax = float(edges[-1]) if mode == '2d' else \
        float(np.hypot(edges[-1], PIMAX))
    origin = -SHIFT
    want_n, want_w = jax_fold(p2, w2, p1, w1, live, edges ** 2, mode, nb1,
                              nb2, 2, pair_los, origin, periodic, False,
                              rmax)
    grid = GridHash(p2, np.full(3, BOX), rmax, periodic=periodic)
    w2_s = torch.as_tensor(w2)[grid.order]
    q = torch.as_tensor(p1)
    n, w = paircount_hist_plain(
        grid, w2_s, q, torch.as_tensor(w1), torch.as_tensor(live),
        grid.cell_of(q), edges ** 2, mode, nb2=nb2, pimax=PIMAX,
        los='midpoint' if pair_los == 'midpoint' else 2, origin=origin)
    np.testing.assert_array_equal(n.numpy(), want_n)
    assert np.abs(w.numpy() - want_w).max() <= RTOL * np.abs(want_w).max()
    assert want_n[nb2 * (nb1 + 1):].sum() > 0     # pairs past the edges


# the particles path's edges (chip_smoke.py PB_EDGES, PB_RP_EDGES,
# PB_3PT_EDGES, PB_THETA as chords), squared as the kernels take them,
# and a set that starts at 0
KERNEL_EDGES = {
    'r': np.linspace(5, 150, 30) ** 2,
    'rp': np.logspace(0, 2, 21) ** 2,
    '3pt': np.linspace(20, 150, 14) ** 2,
    'theta': (2 * np.sin(0.5 * np.radians(np.logspace(-1, 0.5, 11)))) ** 2,
    'from_zero': np.linspace(0, 10, 11) ** 2,
}


@pytest.mark.parametrize('name', sorted(KERNEL_EDGES))
def test_bin_table_gives_digitize(name):
    """The kernels' row of x (one compare at each end, then the bucket
    table and its walk) is np.digitize bit for bit: on every edge, on
    its neighbours one ulp either side, at 0 and on seeded randoms; and
    the walk passes at most one edge."""
    e = KERNEL_EDGES[name]
    tab, shift, base = pc.bin_table(e)
    assert 1 <= len(tab) <= pc.PC_TAB_MAX and tab.dtype == np.int16
    rng = np.random.RandomState(13)
    x = np.concatenate([e, np.nextafter(e, -np.inf), np.nextafter(e, np.inf),
                        [0.0, 5e-324, e[-1] * 2],
                        rng.uniform(0, 1.2 * e[-1], 20000),
                        np.exp(rng.uniform(np.log(e[1]), np.log(e[-1]),
                                           20000))])
    got = pc.row_of(torch.as_tensor(e), tab, shift, base, torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.digitize(x, e))
    inside = x[(x >= e[0]) & (x < e[-1]) & (x >= e[e > 0][0])]
    k = (inside.view('i8') >> shift) - base
    steps = pc.table_steps(e, tab, shift, base)
    assert (np.digitize(inside, e) - tab[k] <= steps).all()
    # these edges take the kernels' one-compare walk, on the device
    # table's entries: the guess g and e[g] beside it
    assert steps <= 1
    dev = pc.device_table(e, tab)
    inside = x[(x >= e[0]) & (x < e[-1])]
    k = (inside.view('i8') >> shift) - base
    ent = dev[np.where(k < 0, 0, k + 1)]
    eg = np.ascontiguousarray(ent[:, 2:]).view('f8')[:, 0]
    np.testing.assert_array_equal(ent[:, 0] + (eg <= inside),
                                  np.digitize(inside, e))


def test_table_steps_of_close_edges():
    # edges closer than the finest table allows: a walk of several steps
    e = np.concatenate([[1.0], 1.0 + np.arange(1, 40) * 1e-13, [2.0]])
    tab, shift, base = pc.bin_table(e)
    assert pc.table_steps(e, tab, shift, base) > 1
    x = np.concatenate([e, np.nextafter(e, np.inf), np.linspace(1, 2, 999)])
    got = pc.row_of(torch.as_tensor(e), tab, shift, base, torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.digitize(x, e))
    # several zero edges: the walk below the first bucket
    z = np.array([0.0, 0.0, 0.0, 1.0, 4.0])
    tab, shift, base = pc.bin_table(z)
    assert pc.table_steps(z, tab, shift, base) == 2


def test_query_items_cover_the_queries_cell_by_cell():
    flat = torch.tensor([0, 0, 0, 1, 1, 5, 5, 5, 5, 5, 9])
    items, bound = pc.query_items(flat, 2)
    assert bound == 11
    n = int((items[:bound] < 11).sum())
    starts = items[:n].tolist()
    assert starts == [0, 2, 3, 5, 7, 9, 10]
    assert (items[n:bound + 1] == 11).all()
    # every item lies in one cell and holds at most 2 queries
    ends = starts[1:] + [11]
    for s, e in zip(starts, ends):
        assert 1 <= e - s <= 2 and len(set(flat[s:e].tolist())) == 1


def test_each_pair_once_only_for_the_grids_own_points():
    """The wrapper takes each pair once only for an auto count whose
    queries are the grid's own points and weights (the kernel then also
    reads that every query is live)."""
    p, w = symmetric_inputs('1d')
    args, kwargs, _, _ = tcore.paircount_inputs(
        p, w, p, w, np.full(3, BOX), edges_of('1d'), is_auto=True)
    grid, w2_s, p1, w1 = args[:4]
    assert pc.each_pair_once(grid, w2_s, p1, w1, True)
    assert not pc.each_pair_once(grid, w2_s, p1, w1, False)
    assert not pc.each_pair_once(grid, w2_s, p1.clone(), w1, True)
    assert not pc.each_pair_once(grid, w2_s, p1, w1.clone(), True)
    assert not pc.each_pair_once(grid, w2_s, p1[:-1], w1[:-1], True)
    # a cross count's queries are copies
    args, kwargs, _, _ = tcore.paircount_inputs(
        p, w, p, w, np.full(3, BOX), edges_of('1d'))
    assert not pc.each_pair_once(*args[:4], kwargs['is_auto'])


def test_query_items_take_queries_in_any_order():
    """Out of the grid's cell order the items are still runs of one
    cell, within their bound; every query is in exactly one."""
    flat = torch.tensor([5, 0, 0, 5, 5, 5, 1, 0, 9, 9, 9])
    items, bound = pc.query_items(flat, 2)
    n = int((items[:bound] < 11).sum())
    assert n <= bound
    starts = items[:n].tolist()
    assert starts == [0, 1, 3, 5, 6, 7, 8, 10]
    ends = starts[1:] + [11]
    for s, e in zip(starts, ends):
        assert 1 <= e - s <= 2 and len(set(flat[s:e].tolist())) == 1


def once_a_pair(grid, w2_s, p1, w1, live1, ci1, r2edges, mode, nb2=1,
                pimax=None, los=2, origin=None, is_auto=False):
    """The kernel's auto count of the grid's own points, in torch: the
    plain fold body with each query counting only the slots after its
    own, every count and sum doubled."""
    assert pc.each_pair_once(grid, w2_s, p1, w1, is_auto) \
        and bool(live1.all())
    e = torch.as_tensor(r2edges, dtype=torch.float64)
    nbins = pc.hist_bins(e.numel(), nb2)
    org = torch.as_tensor(np.zeros(3) if origin is None
                          else np.array(origin, 'f8'))
    body = pc._fold_body(grid, w2_s, e, mode, e.numel() - 1, int(nb2),
                         pimax, los, org, is_auto, p1, w1, live1)
    q = torch.arange(p1.shape[0])

    def once(carry, j, valid, dneg, r2):
        return body(carry, j, valid & (j > q[:, None]), dneg, r2)
    n, w = grid.fold(p1, ci1, once, (torch.zeros(nbins, dtype=torch.float64),
                                     torch.zeros(nbins, dtype=torch.float64)),
                     block=32)
    return 2 * n, 2 * w


def symmetric_inputs(mode):
    """The seeded points of ``inputs`` plus pairs exactly half a box
    apart along each axis and coincident duplicates (their r2 == 0
    drops out of the auto count)."""
    p1, w1, _, _ = inputs(mode)
    if mode != 'angular':
        half = np.array([[10.0, 20.0, 30.0], [60.0, 20.0, 30.0],
                         [40.0, 5.0, 70.0], [40.0, 55.0, 70.0],
                         [25.0, 75.0, 12.5], [25.0, 75.0, 62.5]])
        p1 = np.concatenate([p1, half, p1[:5]])
        w1 = np.concatenate([w1, np.linspace(0.5, 1.5, len(half)), w1[:5]])
    return p1, w1


HALF_CASES = [('1d', True, 'axis'), ('1d', False, 'axis'),
              ('2d', True, 'axis'), ('2d', False, 'midpoint'),
              ('projected', True, 'axis'), ('projected', False, 'midpoint'),
              ('angular', False, 'axis')]


@pytest.mark.parametrize('mode,periodic,los', HALF_CASES)
def test_each_pair_once_doubled_is_the_full_auto_count(mode, periodic, los):
    """What the kernel's each-pair-once count does, in torch: each pair
    from its first point only, doubled, gives the plain version's full
    auto count (npairs bit for bit): the pair bin is the same from
    either end, half-box separations and the midpoint included."""
    p, w = symmetric_inputs(mode)
    if los == 'midpoint':
        p = p + SHIFT
    args, kwargs, _, _ = tcore.paircount_inputs(
        p, w, p, w, np.full(3, BOX), edges_of(mode), is_auto=True,
        **case_kwargs(mode, periodic, los))
    n, s = once_a_pair(*args, **kwargs)
    want_n, want_s = paircount_hist_plain(*args, **kwargs)
    np.testing.assert_array_equal(n.numpy(), want_n.numpy())
    assert want_n[1:-1].sum() > 0
    assert (s - want_s).abs().max() <= RTOL * want_s.abs().max()


def plain_bin(pa, pb, e, mode, nb2, los, origin, periodic):
    """The flat bin the plain fold body gives the pair (query pa,
    candidate pb), or -1 where it drops out."""
    from types import SimpleNamespace
    e = torch.as_tensor(e)
    grid = SimpleNamespace(pos_s=torch.as_tensor(pb)[None])
    body = pc._fold_body(grid, torch.ones(1, dtype=torch.float64), e, mode,
                         e.numel() - 1, nb2, PIMAX, los,
                         torch.as_tensor(origin), True,
                         torch.as_tensor(pa)[None],
                         torch.ones(1, dtype=torch.float64),
                         torch.ones(1, dtype=torch.bool))
    d = torch.as_tensor(pb - pa)[None, None]
    if periodic:
        d = d - torch.round(d / BOX) * BOX
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]
    nbins = pc.hist_bins(e.numel(), nb2)
    n, _ = body((torch.zeros(nbins, dtype=torch.float64),
                 torch.zeros(nbins, dtype=torch.float64)),
                torch.zeros((1, 1), dtype=torch.int64),
                torch.ones((1, 1), dtype=torch.bool), d, r2)
    hit = torch.nonzero(n).reshape(-1).tolist()
    return hit[0] if hit else -1


@pytest.mark.parametrize('mode,periodic,los', [
    ('1d', True, 2), ('2d', True, 2), ('2d', False, 'midpoint'),
    ('projected', True, 2), ('projected', False, 'midpoint')])
def test_pair_bin_is_the_same_from_either_end(mode, periodic, los):
    """The plain bin of (i, j) equals that of (j, i), bit for bit, on
    separations of exactly +-box/2 (periodic), on the edges and on
    seeded pairs, for the axis and the midpoint line of sight."""
    e = edges_of(mode) ** 2
    nb2 = {'2d': 5, 'projected': PIMAX}.get(mode, 1)
    origin = -SHIFT if los == 'midpoint' else np.zeros(3)
    rng = np.random.RandomState(17)
    a = rng.uniform(0, BOX, (40, 3))
    pairs = [(x, x + rng.normal(0, 8, 3)) for x in a]
    pairs += [(x, x + np.array([BOX / 2, 0, 0])) for x in a[:5]]
    pairs += [(x, x - np.array([0, 0, BOX / 2])) for x in a[5:10]]
    pairs += [(np.array([1.0, 2.0, 4.0]), np.array([1.0, 2.0 + r, 4.0]))
              for r in (3.0, 6.0, 9.0, 18.0)]
    seen = 0
    for pa, pb in pairs:
        ab = plain_bin(pa, pb, e, mode, nb2, los, origin, periodic)
        ba = plain_bin(pb, pa, e, mode, nb2, los, origin, periodic)
        assert ab == ba, (pa, pb, ab, ba)
        seen += ab >= 0
    assert seen > len(pairs) // 2


def catalogs(pkg, mode='box'):
    p1, w1, p2, w2 = inputs('1d')
    if mode == 'box':
        cols = ({'Position': p1, 'Weight': w1}, {'Position': p2,
                                                  'Weight': w2})
    else:
        rng = np.random.RandomState(5)
        cols = tuple({'RA': rng.uniform(0, 40, n), 'DEC': rng.uniform(-20, 20,
                                                                      n),
                      'Redshift': rng.uniform(0.05, 0.08, n), 'Weight': w}
                     for n, w in ((N1, w1), (N2, w2)))
    if pkg == 'jax':
        return [JArray(c, BoxSize=BOX) for c in cols]
    return [ArrayCatalog(c, BoxSize=BOX) for c in cols]


def assert_same_class_result(got, want):
    np.testing.assert_array_equal(got.pairs['npairs'],
                                  np.asarray(want.pairs['npairs']))
    w = np.asarray(want.pairs['wnpairs'])
    assert np.abs(got.pairs['wnpairs'] - w).max() <= RTOL * np.abs(w).max()
    for key in ('total_wnpairs', 'W1', 'W2'):
        assert got.attrs[key] == pytest.approx(want.attrs[key], rel=1e-14)
    for key in ('N1', 'N2', 'is_auto'):
        assert got.attrs[key] == want.attrs[key]


def test_simulation_box_paircount_class():
    j1, j2 = catalogs('jax')
    t1, t2 = catalogs('torch')
    want = JSimBox('2d', j1, EDGES, second=j2, Nmu=4, los='x')
    got = SimulationBoxPairCount('2d', t1, EDGES, second=t2, Nmu=4, los='x')
    assert_same_class_result(got, want)
    assert got.pairs.dims == ['r', 'mu']


def test_survey_paircount_class():
    j1, j2 = catalogs('jax', 'sky')
    t1, t2 = catalogs('torch', 'sky')
    want = JSurvey('2d', j1, EDGES, cosmo=JPlanck15, second=j2, Nmu=4)
    got = SurveyDataPairCount('2d', t1, EDGES, cosmo=Planck15, second=t2,
                              Nmu=4)
    assert got.pairs['npairs'].sum() > 0
    assert_same_class_result(got, want)


def test_survey_angular_auto_class():
    j1, _ = catalogs('jax', 'sky')
    t1, _ = catalogs('torch', 'sky')
    want = JSurvey('angular', j1, THETA)
    got = SurveyDataPairCount('angular', t1, THETA)
    assert got.pairs['npairs'].sum() > 0
    assert_same_class_result(got, want)


def test_paircount_save_load_roundtrip(tmp_path):
    t1, t2 = catalogs('torch')
    r = SimulationBoxPairCount('projected', t1, RP_EDGES, second=t2,
                               pimax=PIMAX)
    path = str(tmp_path / 'pairs.json')
    r.save(path)
    back = SimulationBoxPairCount.load(path)
    assert isinstance(back, PairCountBase)
    np.testing.assert_array_equal(back.pairs['npairs'], r.pairs['npairs'])
    np.testing.assert_array_equal(back.pairs['wnpairs'], r.pairs['wnpairs'])
    assert back.attrs['total_wnpairs'] == r.attrs['total_wnpairs']
    assert back.pairs.dims == ['rp', 'pi']


def test_rmax_and_modes():
    for mode, pimax in (('1d', None), ('2d', None), ('projected', 7.0),
                        ('angular', None)):
        assert tcore.rmax_of(mode, EDGES, pimax) == \
            jcore.rmax_of(mode, EDGES, pimax)
    with pytest.raises(ValueError):
        SimulationBoxPairCount('3d', catalogs('torch')[0], EDGES)
