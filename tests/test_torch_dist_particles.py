"""The particle algorithms across ranks against the JAX package: the slab
decomposition (balanced edges, ghost routes, the table reduce and
lookup), the distributed sort and ``CatalogSource.sort``, FOF with its
halo catalog, the pair counts with the 2PCFs, and KDDensity. One world
of 4 gloo CPU ranks (``tests/_torch_ranks.py`` ``particle_cases``)
answers every case at P = 1, 2 and 4 on N = 4096 and 4099 particles.

Bars: edges, routes, tables, sorts, labels, counts and the pair counts'
``npairs`` bit for bit; ``wnpairs`` and the weight totals within 1e-12
relative; halo centres within 1e-12 of the box.

JAX's multi-device FOF takes about a minute a catalog on this CPU, its
``paircount_dist`` 15-20 s a case and its distributed sort 9-27 s, so
the references are JAX's one device, with its distributed rules applied
in numpy: the distributed FOF's labels (each group rooted at its least
global index, halos by descending size, equal sizes by ascending root;
they do not depend on P) from JAX's one-device partition, and the
distributed sort's order (ties in catalog order, under ``reverse``
too) from numpy's stable sort, anchored by one JAX distributed sort.
The one-rank FOF roots a group at its first member in cell order, so
the port's one rank is held on halo count, sizes and partition.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as R
from nbodykit_tpu.algorithms.fof import _fof_labels
from nbodykit_tpu.algorithms.fof import fof_catalog as jax_fof_catalog
from nbodykit_tpu.algorithms.kdtree import KDDensity as JaxKDDensity
from nbodykit_tpu.algorithms.pair_counters.core import paircount
from nbodykit_tpu.parallel.domain import balanced_slab_edges
from nbodykit_tpu.parallel.runtime import cpu_mesh
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from _torch_threads import one_torch_thread  # noqa: F401

Ps = R.RANK_COUNTS
parts = R.parts


@pytest.fixture(scope='module')
def world():
    return R.run_world('particle_cases')


def joined(world, key, P):
    return np.concatenate(parts(world, key, P))


def canonical(labels):
    """Each grouped particle labelled by its group's least index; the
    particles in no group (label 0) stay -1."""
    out = np.full(len(labels), -1)
    grouped = np.flatnonzero(labels > 0)
    first = {}
    for i in grouped:
        first.setdefault(labels[i], i)
    out[grouped] = [first[labels[i]] for i in grouped]
    return out


def ieee_key(a):
    """numpy's view of ``sortable_key``: int64 keys in the float order,
    -0.0 before +0.0."""
    if a.dtype.kind != 'f':
        return a.astype('i8')
    b = a.astype('f8').view('i8')
    return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)


# -- the decomposition ----------------------------------------------------------

def test_balanced_edges_equal_jax(world):
    for n in R.NPARTS:
        x = jnp.asarray(R.clustered(n)['Position'][:, 0])
        for P in Ps:
            want = balanced_slab_edges(x, R.BOX, P, R.PT_LL)
            for got in parts(world, ('edges', n), P):
                np.testing.assert_array_equal(got, want)


def test_slab_routes_cover_the_margins(world):
    """Every rank receives exactly the particles of its slab, widened by
    the ghost band on the faces its ghosts cross (periodic in x or
    not), nothing drops, and a second payload comes back aligned."""
    rmax = R.PT_RMAX
    for n in R.NPARTS:
        x = R.clustered(n)['Position'][:, 0]
        for P in Ps[1:]:
            for ghosts, periodic in (('down', True), ('both', True),
                                     ('both', False), (None, True)):
                got = parts(world, ('route', n, ghosts, periodic), P)
                e = got[0]['edges']
                lo_band = rmax if ghosts == 'both' else 0.0
                hi_band = 0.0 if ghosts is None else rmax
                total = 0
                for d, g in enumerate(got):
                    np.testing.assert_array_equal(g['edges'], e)
                    assert g['dropped'] == 0 and g['aligned'], g
                    lo, hi = e[d] - lo_band, e[d + 1] + hi_band
                    m = (x >= lo) & (x < hi)
                    if periodic:
                        m |= (x - R.BOX >= lo) | (x + R.BOX < hi)
                    np.testing.assert_array_equal(np.sort(g['gid']),
                                                  np.flatnonzero(m))
                    total += len(g['gid'])
                assert total == sum(g['live'] for g in got)
                assert (total > n) == (ghosts is not None)


def test_scatter_reduce_and_gather_by_index(world):
    for n in R.NPARTS:
        s = R.scatter_inputs(n)
        for kind in ('int', 'float'):
            keep = s['valid'] if kind == 'float' else np.ones(n, bool)
            info = np.finfo('f8') if kind == 'float' else np.iinfo('i8')
            for op, init, ufunc in (('add', 0, np.add),
                                    ('min', info.max, np.minimum),
                                    ('max', info.min, np.maximum)):
                if kind == 'float' and op != 'add':
                    init = np.inf if op == 'min' else -np.inf
                want = np.full(R.PT_SIZE, init, dtype=s[kind].dtype)
                ufunc.at(want, s['idx'][keep], s[kind][keep])
                for P in Ps:
                    got = joined(world, ('scatter', n, kind, op), P)
                    if op == 'add' and kind == 'float':
                        np.testing.assert_allclose(got, want, rtol=1e-12,
                                                   atol=1e-12)
                    else:
                        np.testing.assert_array_equal(got, want)
        for P in Ps:
            np.testing.assert_array_equal(joined(world, ('gather', n), P),
                                          s['table'][s['idx']])


# -- the sorts -------------------------------------------------------------------

def test_dist_sort_equals_numpy(world):
    for n in R.NPARTS:
        d = R.clustered(n)
        for col in ('Key', 'Score'):
            keys = ieee_key(d[col])
            order = np.argsort(keys, kind='stable')
            for P in Ps:
                got = parts(world, ('dist_sort', n, col), P)
                np.testing.assert_array_equal(
                    np.concatenate([g['perm'] for g in got]), order)
                np.testing.assert_array_equal(
                    np.concatenate([g['keys'] for g in got]), keys[order])
                assert [len(g['perm']) for g in got] == \
                    [len(R.rows(keys, P, r)) for r in range(P)]


@functools.lru_cache(maxsize=None)
def jax_sorted(n, case, P):
    cat = JaxArray(R.clustered(n), BoxSize=R.BOX, comm=cpu_mesh(P))
    args = {'multi': (['Key', 'Score'],), 'reverse': ('Key', True),
            'float': ('Score',)}[case]
    s = cat.sort(*args)
    return {c: np.asarray(s[c]) for c in ('Key', 'Score', 'Position')}


def test_catalog_sort_equals_jax(world):
    """Multi-key, reversed and float sorts: one rank equals JAX's one
    device; P = 2 and 4 equal numpy's stable sort of the catalog (ties
    in catalog order, under ``reverse`` too), which equals JAX's
    distributed ``CatalogSource.sort`` on 2 devices (the reversed sort
    at N = 4099)."""
    anchor = jax_sorted(R.NPARTS[1], 'reverse', 2)
    for n in R.NPARTS:
        d = R.clustered(n)
        key, score = ieee_key(d['Key']), ieee_key(d['Score'])
        numpy_orders = {
            'multi': np.lexsort((score, key)),
            'reverse': np.argsort(~key, kind='stable'),
            'float': np.argsort(score, kind='stable')}
        if n == R.NPARTS[1]:
            for col, a in anchor.items():
                np.testing.assert_array_equal(
                    a, d[col][numpy_orders['reverse']])
        for case, order in numpy_orders.items():
            one = jax_sorted(n, case, 1)
            for P in Ps:
                got = parts(world, ('sort', n, case), P)
                for col in ('Key', 'Score', 'Position'):
                    cat = np.concatenate([g[col] for g in got])
                    want = d[col][order] if P > 1 else one[col]
                    np.testing.assert_array_equal(cat, want)
                assert [len(g['Key']) for g in got] == \
                    [len(R.rows(key, P, r)) for r in range(P)]


# -- FOF ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_fof(n, periodic):
    """The labels of JAX's distributed FOF from its one-device partition:
    groups of PT_NMIN or more labelled 1, 2, ... by descending size,
    equal sizes by ascending least member (``FOF._run_distributed``);
    and JAX's ``fof_catalog`` of them."""
    d = R.clustered(n)
    roots = np.asarray(_fof_labels(d['Position'], np.full(3, R.BOX),
                                   R.PT_LL, periodic=periodic))
    _, inv = np.unique(roots, return_inverse=True)
    least = np.full(inv.max() + 1, n)
    np.minimum.at(least, inv, np.arange(n))
    root = least[inv]
    counts = np.bincount(root, minlength=n)
    idx_e = np.flatnonzero(counts >= R.PT_NMIN)
    label_map = np.zeros(n, dtype='i8')
    label_map[idx_e[np.argsort(-counts[idx_e], kind='stable')]] = \
        np.arange(1, len(idx_e) + 1)
    labels = label_map[root]
    feats = jax_fof_catalog(JaxArray(d, BoxSize=R.BOX), jnp.asarray(labels),
                            len(idx_e) + 1, np.full(3, R.BOX),
                            periodic=periodic, peakcolumn='Density')
    return dict(labels=labels, nhalo=len(idx_e), features=feats)


@pytest.mark.parametrize('periodic', [True, False])
def test_fof_labels_equal_jax(world, periodic):
    for n in R.NPARTS:
        want = jax_fof(n, periodic)
        for P in Ps[1:]:
            got = parts(world, ('fof', n, periodic), P)
            assert all(g['branch'] == 'slab' for g in got)
            assert all(g['nhalo'] == want['nhalo'] for g in got)
            np.testing.assert_array_equal(
                np.concatenate([g['labels'] for g in got]), want['labels'])


def test_fof_matches_one_rank(world):
    """Halo count, sizes and partition equal the port's one rank, on the
    slab branch and (the sparse catalog at a linking length past a slab
    at P = 4) the gathered one."""
    cases = [(('fof', n, periodic), 'slab') for n in R.NPARTS
             for periodic in (True, False)] + [(('fof_wide',), None)]
    for key, branch in cases:
        one = world[0][key + (1,)]
        assert one['branch'] == 'one_rank'
        sizes = np.bincount(one['labels'])[1:]
        assert len(sizes) == one['nhalo'] and \
            np.all(np.diff(sizes) <= 0)
        for P in Ps[1:]:
            got = parts(world, key, P)
            want_branch = branch or ('gathered' if P == 4 else 'slab')
            assert all(g['branch'] == want_branch for g in got)
            labels = np.concatenate([g['labels'] for g in got])
            assert all(g['nhalo'] == one['nhalo'] for g in got)
            np.testing.assert_array_equal(np.bincount(labels)[1:], sizes)
            np.testing.assert_array_equal(canonical(labels),
                                          canonical(one['labels']))


def test_find_features_and_halos_equal_jax(world):
    """find_features across ranks: Length and the peaks equal JAX's
    ``fof_catalog`` of the same labels, the centres within 1e-12 of the
    box, each rank
    holding its row split of the halos; to_halos' HaloCatalog holds the
    halos past label 0, Mass = Length * particle mass."""
    for n in R.NPARTS:
        for periodic in (True, False):
            want = jax_fof(n, periodic)['features']
            for P in Ps[1:]:
                got = parts(world, ('fof', n, periodic), P)
                f = {c: np.concatenate([g['features'][c] for g in got])
                     for c in want}
                for c in ('Length', 'PeakPosition', 'PeakVelocity'):
                    np.testing.assert_array_equal(f[c], want[c])
                for c in ('CMPosition', 'CMVelocity'):
                    np.testing.assert_allclose(f[c], want[c], rtol=0,
                                               atol=1e-12 * R.BOX)
                h = {c: np.concatenate([g['halos'][c] for g in got])
                     for c in ('Position', 'Mass')}
                np.testing.assert_array_equal(h['Position'],
                                              f['CMPosition'][1:])
                np.testing.assert_array_equal(
                    h['Mass'], want['Length'][1:] * R.PT_MASS)
                assert all(g['halo_csize'] == len(want['Length']) - 1
                           for g in got)
                assert [len(g['features']['Length']) for g in got] == \
                    [len(R.rows(want['Length'], P, r)) for r in range(P)]


# -- pair counts -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_pairs(n, case):
    """JAX's one-device ``paircount`` of a case."""
    _, p1, w1, p2, w2, box, kw = [c for c in R.pair_inputs(n)
                                  if c[0] == case][0]
    return paircount(p1, w1, p2, w2, box, R.PT_EDGES, **kw)


@pytest.mark.parametrize('case', ['1d', '2d', 'projected', 'cross',
                                  'survey'])
def test_paircount_dist_equals_jax(world, case):
    """paircount_dist at every P equals JAX's one-device count (at N =
    4099; '1d' at both N) and the port's one rank."""
    for n in R.NPARTS:
        one = world[0]['pairs', n, case, 1]
        if n == R.NPARTS[1] or case == '1d':
            want = jax_pairs(n, case)
            np.testing.assert_array_equal(one['npairs'], want['npairs'])
            np.testing.assert_allclose(one['wnpairs'], want['wnpairs'],
                                       rtol=1e-12, atol=0)
        assert np.asarray(one['npairs']).sum() > 0
        for P in Ps[1:]:
            for got in parts(world, ('pairs', n, case), P):
                np.testing.assert_array_equal(got['npairs'], one['npairs'])
                np.testing.assert_allclose(got['wnpairs'], one['wnpairs'],
                                           rtol=1e-12, atol=0)


def test_pair_count_classes_across_ranks(world):
    """SimulationBoxPairCount (auto, cross), SurveyDataPairCount through
    SurveyData2PCF and both SimulationBox2PCF estimators across ranks
    (N = 4099) equal the port's one rank: npairs identical, wnpairs, the
    weight totals and xi within 1e-12 relative, on the slab branch; the
    sparse catalog's count past a slab at P = 4 takes the gathered
    branch."""
    def same(got, one, branch):
        np.testing.assert_array_equal(got['npairs'], one['npairs'])
        np.testing.assert_allclose(got['wnpairs'], one['wnpairs'],
                                   rtol=1e-12, atol=0)
        for k in ('total_wnpairs', 'W1', 'W2'):
            assert got[k] == pytest.approx(one[k], rel=1e-12, abs=0)
        assert (got['N1'], got['N2']) == (one['N1'], one['N2'])
        assert got['branch'] == branch and one['branch'] == 'one_rank'

    one = world[0]['classes', 1]
    for P in Ps[1:]:
        for r, got in enumerate(parts(world, ('classes',), P)):
            for case in ('box', 'box_cross'):
                same(got[case], one[case], 'slab')
            for est in ('natural', 'landy_szalay'):
                np.testing.assert_allclose(got[est], one[est],
                                           rtol=1e-12, atol=1e-14)
            for name in ('DD', 'DR', 'RR'):
                same(got['survey'][name], one['survey'][name], 'slab')
            np.testing.assert_allclose(got['survey']['corr'],
                                       one['survey']['corr'],
                                       rtol=1e-12, atol=1e-14)
            same(world[r]['box_wide', P], world[0]['box_wide', 1],
                 'gathered' if P == 4 else 'slab')
    assert one['box']['npairs'].sum() > 0
    assert world[0]['box_wide', 1]['npairs'].sum() > 0


# -- KDDensity ---------------------------------------------------------------------

def test_kddensity_counts_exact(world):
    """Neighbour counts equal JAX's one-device KDDensity at every P (the
    slab branch at P > 1); the sparse catalog's wide kernel takes the
    gathered branch at P = 4 and equals the one rank's density."""
    for n in R.NPARTS:
        jcat = JaxArray(R.clustered(n), BoxSize=R.BOX)
        kd = JaxKDDensity(jcat, margin=R.PT_KDD_MARGIN)
        vol = 4.0 / 3 * np.pi * kd.attrs['kernel_radius'] ** 3
        want = np.rint(np.asarray(kd.density) * vol)
        for P in Ps:
            got = parts(world, ('kdd', n), P)
            assert all(g['branch'] == ('slab' if P > 1 else 'one_rank')
                       for g in got)
            np.testing.assert_array_equal(
                np.rint(np.concatenate([g['counts'] for g in got])), want)
    one = world[0]['kdd_wide', 1]['density']
    for P in Ps[1:]:
        got = parts(world, ('kdd_wide',), P)
        assert all(g['branch'] == ('gathered' if P == 4 else 'slab')
                   for g in got)
        np.testing.assert_array_equal(
            np.concatenate([g['density'] for g in got]), one)
