"""KDDensity, CylindricalGroups and FiberCollisions through the PyTorch
port and the JAX package on the same seeded numpy catalogs (all exact),
and the grid hash's plain fold for queries that are not the grid's own
against the JAX DeviceGridHash fold."""

import numpy as np
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu.algorithms.cgm import CylindricalGroups as JCGM
from nbodykit_tpu.algorithms.fibercollisions import FiberCollisions as JFC
from nbodykit_tpu.algorithms.kdtree import KDDensity as JKDD
from nbodykit_tpu.ops import devicehash as jdh
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JArray
from nbodykit_tpu_torch.lab import (ArrayCatalog, CylindricalGroups,
                                    FiberCollisions, KDDensity)
from nbodykit_tpu_torch.ops.devicehash import DeviceGridHash

BOX = 100.0


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


def positions(kind, n=1500, seed=3):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    if kind == 'clustered':
        centres = rng.uniform(0, BOX, (20, 3))
        centres[:2, 0] = [0.5, BOX - 0.5]
        k = (2 * n) // 3
        pos[:k] = np.mod(centres[rng.randint(20, size=k)]
                         + rng.normal(scale=2.0, size=(k, 3)), BOX)
        pos[k:k + 5] = pos[:5]                      # coincident duplicates
    return pos


@pytest.mark.parametrize('kind,margin', [('uniform', 1.0),
                                         ('clustered', 0.7)])
def test_kddensity(kind, margin):
    pos = positions(kind)
    want = np.asarray(JKDD(JArray({'Position': pos}, BoxSize=BOX),
                           margin=margin).density)
    kd = KDDensity(ArrayCatalog({'Position': pos}, BoxSize=BOX),
                   margin=margin)
    np.testing.assert_array_equal(kd.density.numpy(), want)
    assert kd.attrs['kernel_radius'] > 0 and want.max() > want.min()


CGM_CASES = [('periodic', dict(rperp=3.0, rpar=8.0)),
             ('open', dict(rperp=2.5, rpar=6.0, periodic=False,
                           flat_sky_los=[1, 0, 0])),
             ('two_keys', dict(rperp=3.0, rpar=5.0,
                               flat_sky_los=[0, 1, 0]))]


@pytest.mark.parametrize('name,kw', CGM_CASES, ids=[c for c, _ in CGM_CASES])
def test_cylindrical_groups(name, kw):
    rng = np.random.RandomState(4)
    pos = positions('clustered', seed=9)
    cols = {'Position': pos, 'Mass': rng.uniform(0, 1, len(pos)),
            'Rank2': rng.randint(0, 5, len(pos)).astype('f8')}
    rankby = ['Rank2', 'Mass'] if name == 'two_keys' else 'Mass'
    jcat = JArray(cols, BoxSize=BOX) if name != 'open' else JArray(cols)
    tcat = ArrayCatalog(cols, BoxSize=BOX) if name != 'open' \
        else ArrayCatalog(cols)
    want = JCGM(jcat, rankby=rankby, **kw).groups
    r = CylindricalGroups(tcat, rankby=rankby, **kw)
    for col in ('cgm_type', 'cgm_haloid', 'num_cgm_sats'):
        np.testing.assert_array_equal(r.groups[col].numpy(),
                                      np.asarray(want[col]))
    nsat = int(r.groups['cgm_type'].sum())
    assert 0 < nsat < len(pos) and r.rounds >= 2
    assert int(r.groups['num_cgm_sats'].sum()) == nsat


@pytest.mark.parametrize('radius,seed', [(0.05, 3), (0.12, 4)])
def test_fiber_collisions(radius, seed):
    """Pairs and multiplets in a 5 x 5 degree patch."""
    rng = np.random.RandomState(seed)
    ra = rng.uniform(0, 5, 2500)
    dec = rng.uniform(-2.5, 2.5, 2500)
    want = JFC(ra, dec, collision_radius=radius, seed=7).labels
    got = FiberCollisions(ra, dec, collision_radius=radius, seed=7).labels
    for col in ('Label', 'Collided', 'NeighborID'):
        np.testing.assert_array_equal(got[col].numpy(),
                                      np.asarray(want[col]))
    labels = got['Label'].numpy()
    assert np.bincount(labels)[1] > 2          # a multiplet
    assert int(got['Collided'].sum()) > 0


@pytest.mark.parametrize('periodic', [True, False])
def test_fold_of_foreign_queries(periodic):
    """The neighbours within r of queries that are not the grid's points
    (a count and the sum of the neighbours' slots), by the port's fold
    in blocks of slots and one slot a call, against the JAX
    DeviceGridHash fold."""
    import jax.numpy as jnp
    pts = positions('clustered', n=1200, seed=5)
    q = np.random.RandomState(6).uniform(-2, BOX + 2, (400, 3))
    if periodic:
        q = np.mod(q, BOX)
    r = 7.0
    jgrid = jdh.DeviceGridHash(jnp.asarray(pts), np.full(3, BOX), r,
                               periodic=periodic)
    qj = jnp.asarray(q)

    def jbody(carry, j, valid, d, r2):
        hit = valid & (r2 <= r * r)
        return (carry[0] + jnp.where(hit, 1, 0),
                carry[1] + jnp.where(hit, j, 0))
    want = jgrid.fold(qj, jgrid.cell_of(qj), jbody,
                      (jnp.zeros(400, jnp.int64), jnp.zeros(400, jnp.int64)))

    grid = DeviceGridHash(torch.as_tensor(pts), np.full(3, BOX), r,
                          periodic=periodic)
    qt = torch.as_tensor(q)

    def body(carry, j, valid, d, r2):
        hit = valid & (r2 <= r * r)
        if hit.dim() == 2:
            return (carry[0] + hit.sum(1), carry[1] + (j * hit).sum(1))
        return carry[0] + hit, carry[1] + j * hit
    zero = torch.zeros(400, dtype=torch.int64)
    for block in (None, 5):
        got = grid.fold(qt, grid.cell_of(qt), body, (zero, zero),
                        block=block)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize('periodic', [True, False])
def test_candidates_count_the_fold(periodic):
    """The candidate count of the kernels' bounds (``chip_smoke.py``)
    equals the valid candidates the plain fold visits."""
    from chip_smoke import candidates
    pts = positions('clustered', n=900, seed=12)
    grid = DeviceGridHash(torch.as_tensor(pts), np.full(3, BOX), 9.0,
                          periodic=periodic)
    q = torch.as_tensor(np.random.RandomState(13).uniform(0, BOX, (300, 3)))
    ci = grid.cell_of(q)
    live = torch.arange(300) % 4 != 1
    want = grid.fold(q, ci, lambda c, j, ok, d, r2: c + int(
        (ok & live[:, None]).sum()), 0, block=16)
    assert candidates(grid, ci, live) == want > 0
