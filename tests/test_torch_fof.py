"""The FOF flow through the PyTorch port and the JAX package on the same
seeded numpy positions: the neighbour offsets, the grid hash's cell
order, one sweep of the ``fof_sweep`` plain version against JAX's
``neighbor_min`` fold, the fixpoint labels and FOF's size-ordered labels
(exact, f4 and f8, uniform and clustered, periodic and not), the halo
columns of ``find_features`` (exact Length; 1e-12 at f8, 1e-5 at f4)
and of ``to_halos`` (1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu.algorithms import fof as jfof
from nbodykit_tpu.cosmology import Planck15 as JPlanck15
from nbodykit_tpu.ops import devicehash as jdh
from nbodykit_tpu.ops import gridhash as jgh
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from nbodykit_tpu_torch.algorithms import fof as tfof
from nbodykit_tpu_torch.cosmology import Planck15
from nbodykit_tpu_torch.lab import FOF, ArrayCatalog
from nbodykit_tpu_torch.ops import devicehash as tdh
from nbodykit_tpu_torch.ops import gridhash as tgh

BOX = 100.0
N = 2500
LL = 0.2 * BOX / N ** (1. / 3)      # 0.2 of the mean separation


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


def positions(kind, dtype, seed=7, n=N, box=BOX):
    """Uniform, or clustered: Gaussian blobs of 0.6 ll around 40 centres
    (some across the box boundary) plus a uniform background."""
    rng = np.random.RandomState(seed)
    if kind == 'uniform':
        pos = rng.uniform(0, box, (n, 3))
    else:
        centres = rng.uniform(0, box, (40, 3))
        centres[:4, 0] = [0.1, box - 0.1, 0.3, box - 0.2]
        nblob = (3 * n) // 4
        pos = np.concatenate([
            centres[rng.randint(40, size=nblob)]
            + rng.normal(scale=0.6 * LL, size=(nblob, 3)),
            rng.uniform(0, box, (n - nblob, 3))])
        pos = np.mod(pos, box)
    return pos.astype(dtype)


CASES = [(dt, kind, per) for dt in ('f4', 'f8')
         for kind in ('uniform', 'clustered') for per in (True, False)]
IDS = ['%s-%s-%s' % (dt, kind, 'periodic' if per else 'open')
       for dt, kind, per in CASES]

_jax_roots = {}


def jax_roots(dt, kind, periodic):
    """JAX's ``local_fof_labels`` (one jit per case, shared)."""
    key = (dt, kind, periodic)
    if key not in _jax_roots:
        pos = positions(kind, dt)
        valid = np.ones(N, bool)
        _jax_roots[key] = np.asarray(jax.jit(
            lambda p, v: jdh.local_fof_labels(
                p, v, np.full(3, BOX), LL, periodic=periodic))(pos, valid))
    return _jax_roots[key]


@pytest.mark.parametrize('periodic', [True, False])
@pytest.mark.parametrize('ncell', [1, 2, 3, 5])
def test_neighbor_offsets(ncell, periodic):
    for shape in ([ncell] * 3, [ncell, 3, 2]):
        assert tgh.neighbor_offsets(shape, periodic) == \
            jgh.neighbor_offsets(shape, periodic)


@pytest.mark.parametrize('dt,kind', [('f4', 'uniform'),
                                     ('f8', 'clustered')])
def test_grid_order_equals_jax(dt, kind):
    pos = positions(kind, dt)
    valid = np.ones(N, bool)
    valid[::97] = False
    jg = jdh.DeviceGridHash(jnp.asarray(pos), BOX, LL,
                            valid=jnp.asarray(valid))
    for order in ('argsort', 'radix'):
        tg = tdh.DeviceGridHash(torch.as_tensor(pos), BOX, LL,
                                valid=torch.as_tensor(valid), order=order)
        assert tg.offsets == jg.offsets
        np.testing.assert_array_equal(tg.order.numpy(), np.asarray(jg.order))
        np.testing.assert_array_equal(tg.flat_s.numpy(),
                                      np.asarray(jg.flat_s))
        np.testing.assert_array_equal(tg.pos_s.numpy(), np.asarray(jg.pos_s))
        np.testing.assert_array_equal(
            tg.cell_of(tg.pos_s).numpy(), np.asarray(jg.cell_of(jg.pos_s)))


@pytest.mark.parametrize('dt,kind,periodic', [CASES[0], CASES[7]],
                         ids=[IDS[0], IDS[7]])
def test_one_sweep_equals_jax_neighbor_min(dt, kind, periodic):
    """The plain version of ``fof_sweep`` on arbitrary labels (not the
    first sweep's arange), against JAX's fold with
    ``neighbor_min``'s body (devicehash.py:190-194)."""
    pos = positions(kind, dt)
    valid = np.ones(N, bool)
    valid[5::61] = False
    labels = np.random.RandomState(3).randint(0, N, N).astype('i4')
    box = np.full(3, BOX)

    def jax_sweep(p, v, lab):
        grid = jdh.DeviceGridHash(p, box, LL, valid=v, periodic=periodic)
        ci_s = grid.cell_of(grid.pos_s)
        ll2 = jnp.asarray(float(LL) ** 2, p.dtype)
        vs = grid.valid_s

        def body(best, j, ok, d, r2):
            ok = ok & vs & (r2 <= ll2)
            return jnp.minimum(best, jnp.where(ok, lab[j], best))
        return grid.fold(grid.pos_s, ci_s, body, lab)
    want = np.asarray(jax.jit(jax_sweep)(pos, valid, labels))

    tg = tdh.DeviceGridHash(torch.as_tensor(pos), box, LL,
                            valid=torch.as_tensor(valid), periodic=periodic)
    got = tg.sweep(tg.cell_of(tg.pos_s), torch.as_tensor(labels),
                   float(LL) ** 2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != labels).sum() > 20      # the sweep did work


@pytest.mark.parametrize('dt,kind,periodic', CASES, ids=IDS)
def test_local_fof_labels_equal_jax(dt, kind, periodic):
    pos = positions(kind, dt)
    got = tdh.local_fof_labels(torch.as_tensor(pos), None, np.full(3, BOX),
                               LL, periodic=periodic)
    want = jax_roots(dt, kind, periodic)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == 'clustered':
        assert np.bincount(want).max() >= 20       # real groups formed


@pytest.mark.parametrize('dt,kind,periodic', CASES, ids=IDS)
def test_fof_labels_equal_jax(dt, kind, periodic):
    """FOF's size-ordered labels (the relabel runs on the device in the
    port) equal the JAX FOF's relabel of the same roots."""
    pos = positions(kind, dt)
    nmin = 5
    cat = ArrayCatalog({'Position': pos}, BoxSize=BOX)
    fof = FOF(cat, linking_length=0.2, nmin=nmin, periodic=periodic)
    roots = jax_roots(dt, kind, periodic)
    uniq, inv, counts = np.unique(roots, return_inverse=True,
                                  return_counts=True)
    eligible = counts >= nmin
    order = np.argsort(-counts[eligible], kind='stable')
    label_map = np.zeros(len(uniq), dtype='i8')
    label_map[np.flatnonzero(eligible)[order]] = \
        np.arange(1, eligible.sum() + 1)
    np.testing.assert_array_equal(fof.labels.numpy(), label_map[inv])
    assert fof._halo_count == int(eligible.sum()) and fof.sweeps >= 1


_jax_fof = {}


def jax_fof(dt):
    """The JAX FOF on the clustered periodic catalog with Velocity and a
    density column (one jit per dtype, shared)."""
    if dt not in _jax_fof:
        pos = positions('clustered', dt)
        rng = np.random.RandomState(11)
        cols = {'Position': pos,
                'Velocity': rng.normal(size=(N, 3)).astype(dt),
                'Density': np.round(rng.uniform(0, 4, N), 1)}
        jcat = JaxArray(cols, BoxSize=BOX)
        _jax_fof[dt] = (cols, jfof.FOF(jcat, linking_length=0.2, nmin=20))
    return _jax_fof[dt]


@pytest.mark.parametrize('dt', ['f4', 'f8'])
def test_find_features_equal_jax(dt):
    cols, jf = jax_fof(dt)
    want = jf.find_features(peakcolumn='Density')
    fof = FOF(ArrayCatalog(cols, BoxSize=BOX), linking_length=0.2, nmin=20)
    got = fof.find_features(peakcolumn='Density')
    assert len(got) == len(want) >= 10
    np.testing.assert_array_equal(got['Length'].numpy(),
                                  np.asarray(want['Length']))
    assert int(got['Length'].sum()) == N
    rtol = 1e-12 if dt == 'f8' else 1e-5
    for col in ('CMPosition', 'CMVelocity', 'PeakPosition', 'PeakVelocity'):
        g, w = got[col].numpy(), np.asarray(want[col])
        assert g.dtype == w.dtype, col
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * BOX,
                                   err_msg=col)


def test_to_halos_columns_equal_jax():
    cols, jf = jax_fof('f8')
    jh = jf.to_halos(1e12, JPlanck15, 0.5)
    fof = FOF(ArrayCatalog(cols, BoxSize=BOX), linking_length=0.2, nmin=20)
    th = fof.to_halos(1e12, Planck15, 0.5)
    assert len(th) == len(jh)
    length = fof.find_features()['Length'][1:].numpy()
    np.testing.assert_array_equal(th['Mass'].numpy(), length * 1e12)
    for col in ('Position', 'Velocity', 'Mass', 'Radius', 'Concentration',
                'VelocityOffset'):
        np.testing.assert_allclose(th[col].numpy(), np.asarray(jh[col]),
                                   rtol=1e-12, atol=0, err_msg=col)


def brute_force_fof(pos, ll, box):
    """O(N^2) union-find with periodic distances."""
    parent = np.arange(len(pos))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(len(pos)):
        d = pos[i + 1:] - pos[i]
        d -= np.round(d / box) * box
        for j in np.flatnonzero((d ** 2).sum(-1) <= ll * ll) + i + 1:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[ri] = rj
    return np.array([find(i) for i in range(len(pos))])


def same_partition(a, b):
    """Do two labelings describe the same partition?"""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize('order', ['argsort', 'radix'])
def test_labels_equal_brute_force(order):
    """The groups of a union-find over all pairs, with either cell-order
    engine; each root is a member of its own group."""
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 50.0, size=(500, 3))
    got = tfof._fof_labels(torch.as_tensor(pos), np.full(3, 50.0), 3.0,
                           order=order).numpy()
    want = brute_force_fof(pos, 3.0, 50.0)
    assert same_partition(got, want)
    np.testing.assert_array_equal(got[got], got)
    assert 20 < len(set(want.tolist())) < 490


@pytest.mark.parametrize('dt,kind', [('f4', 'clustered'), ('f8', 'uniform')])
def test_radix_order_gives_argsort_labels(dt, kind):
    pos = torch.as_tensor(positions(kind, dt))
    stats = {}
    a = tfof._fof_labels(pos, np.full(3, BOX), LL, order='radix',
                         stats=stats)
    b = tfof._fof_labels(pos, np.full(3, BOX), LL, order='argsort')
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert stats['sweeps'] >= 2


def test_fof_catalog_empty_label_and_device():
    """An empty label keeps index 0 as its reference particle (JAX's
    in-order scatter), and the columns stay on the catalog's device."""
    pos = np.array([[1.0, 1, 1], [2, 2, 2], [3, 3, 3]])
    cat = ArrayCatalog({'Position': pos}, BoxSize=10.0)
    data = tfof.fof_catalog(cat, torch.tensor([0, 2, 2]), 4, np.full(3, 10.))
    np.testing.assert_array_equal(data['Length'].numpy(), [1, 0, 2, 0])
    np.testing.assert_allclose(data['CMPosition'].numpy(),
                               [[1, 1, 1], [1, 1, 1], [2.5, 2.5, 2.5],
                                [1, 1, 1]])
    assert all(v.device.type == 'cpu' for v in data.values())
