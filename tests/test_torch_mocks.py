"""Seeded mocks through the PyTorch port and the JAX package on the same
seed: white noise, the particle grid, the copied cosmology, LinearMesh,
LogNormalCatalog and FFTPower on it (x64 on, as ``tests/conftest.py``
sets it).

Tolerances: the draws are JAX's (``tests/test_torch_rng.py``), so what
differs is float arithmetic. White noise and LinearMesh go through
torch's FFT and XLA's: 1e-12 of the field's largest value at f8, 1e-5
at f4 (the f4 normals' own 1e-5). The f8 LogNormal catalog has JAX's
per-cell counts and its columns to one f32 ulp of the box (scaled to
each column's units); at f4 lam carries the f4 normals' differences, so
N is held to 1e-3 and the painted field and P(k) to 1e-3.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nbodykit_tpu_torch
from nbodykit_tpu import cosmology as jcosmo
from nbodykit_tpu import mockmaker as jmock
from nbodykit_tpu.algorithms.fftpower import FFTPower as JaxFFTPower
from nbodykit_tpu.pmesh import ParticleMesh as JaxPM
from nbodykit_tpu.source.catalog.lognormal import \
    LogNormalCatalog as JaxLogNormal
from nbodykit_tpu.source.mesh.array import ArrayMesh as JaxArrayMesh
from nbodykit_tpu.source.mesh.linear import LinearMesh as JaxLinearMesh
from nbodykit_tpu.utils import as_numpy
from nbodykit_tpu_torch import cosmology as tcosmo
from nbodykit_tpu_torch import mockmaker as tmock
from nbodykit_tpu_torch import utils as tutils
from nbodykit_tpu_torch import rng
from nbodykit_tpu_torch.algorithms.fftpower import FFTPower
from nbodykit_tpu_torch.pmesh import ParticleMesh
from nbodykit_tpu_torch.source.catalog import LogNormalCatalog
from nbodykit_tpu_torch.source.mesh import ArrayMesh, LinearMesh

BOX, NMESH, NBAR, SEED = 500.0, 32, 3e-5, 42
SHAPE = (16, 12, 10)


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-300)
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, "max |diff| %g > %g * %g" % (err, tol, scale)


def _tol(dtype):
    return 1e-12 if dtype == 'f8' else 1e-5


def _plin(pkg, transfer='EisensteinHu'):
    return pkg.LinearPower(pkg.Planck15, 0.55, transfer)


# -- white noise and the particle grid ------------------------------------

@pytest.mark.parametrize('dtype', ['f8', 'f4'])
@pytest.mark.parametrize('unitary,inverted', [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_whitenoise(dtype, unitary, inverted):
    j = JaxPM(SHAPE, 300.0, dtype=dtype).generate_whitenoise(
        7, unitary=unitary, inverted_phase=inverted)
    t = ParticleMesh(SHAPE, 300.0, dtype=dtype).generate_whitenoise(
        7, unitary=unitary, inverted_phase=inverted)
    assert t.dtype == (torch.complex128 if dtype == 'f8'
                       else torch.complex64)
    _close(t.numpy(), as_numpy(j), _tol(dtype))
    if unitary:
        amp = np.abs(t.numpy())
        assert np.allclose(amp[amp > 0], 1.0, rtol=1e-5)


@pytest.mark.parametrize('dtype', ['f8', 'f4'])
@pytest.mark.parametrize('shift', [0.5, 0.0, 0.25])
def test_uniform_particle_grid(dtype, shift):
    j = JaxPM(SHAPE, (300.0, 200.0, 100.0)).generate_uniform_particle_grid(
        shift=shift, dtype=dtype)
    t = ParticleMesh(SHAPE, (300.0, 200.0, 100.0)) \
        .generate_uniform_particle_grid(shift=shift, dtype=dtype)
    got, ref = t.numpy(), as_numpy(j)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# -- the copied cosmology --------------------------------------------------

@pytest.mark.parametrize('name', ['Planck13', 'Planck15', 'WMAP5', 'WMAP7',
                                  'WMAP9'])
def test_cosmology_background(name):
    cj, ct = getattr(jcosmo, name), getattr(tcosmo, name)
    z = np.array([0.0, 0.55, 1.0, 3.0])
    _close(ct.efunc(z), cj.efunc(z), 1e-12)
    _close(ct.scale_independent_growth_rate(z),
           cj.scale_independent_growth_rate(z), 1e-12)
    _close(ct.scale_independent_growth_factor(z),
           cj.scale_independent_growth_factor(z), 1e-12)
    _close(ct.comoving_distance(z), cj.comoving_distance(z), 1e-12)
    assert ct.Omega0_m == cj.Omega0_m and ct.h == cj.h


@pytest.mark.parametrize('transfer', ['EisensteinHu', 'NoWiggleEisensteinHu'])
def test_linear_power_numpy_and_tensor(transfer):
    pj, pt = _plin(jcosmo, transfer), _plin(tcosmo, transfer)
    assert abs(pt.sigma8 - pj.sigma8) <= 1e-12 * pj.sigma8
    k = np.logspace(-4, 1, 300)
    _close(pt(k), pj(k), 1e-12)
    kt = np.concatenate([[0.0], k, [2e3]])
    for dt in (np.float64, np.float32):
        ref = np.asarray(pj(jnp.asarray(kt.astype(dt))))
        got = pt(torch.from_numpy(kt.astype(dt))).numpy()
        assert got[0] == 0.0
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_boltzmann_engine_not_ported_raises():
    """The engine is ported now: what used to raise here (the CLASS
    transfer, sigma8) equals the JAX package's, beside what needs no
    perturbation solve."""
    k = np.logspace(-4, 1, 40)
    _close(tcosmo.LinearPower(tcosmo.Planck15, 0.0, transfer='CLASS')(k),
           jcosmo.LinearPower(jcosmo.Planck15, 0.0, transfer='CLASS')(k),
           1e-12)
    assert tcosmo.Planck15.sigma8 == jcosmo.Planck15.sigma8
    assert tcosmo.Planck15.z_drag == jcosmo.Planck15.z_drag


# -- LinearMesh and ArrayMesh ---------------------------------------------

@pytest.mark.parametrize('dtype', ['f8', 'f4'])
@pytest.mark.parametrize('unitary', [False, True])
def test_linear_mesh(dtype, unitary):
    kw = dict(BoxSize=BOX, Nmesh=16, seed=3, unitary_amplitude=unitary,
              dtype=dtype)
    j = JaxLinearMesh(_plin(jcosmo), **kw)
    t = LinearMesh(_plin(tcosmo), **kw)
    _close(t.to_complex_field().value.numpy(),
           as_numpy(j.to_complex_field().value), _tol(dtype))
    _close(t.compute('real').value.numpy(),
           as_numpy(j.compute('real').value), _tol(dtype) * 10)
    assert t.attrs['seed'] == 3 and t.attrs['transfer'] == 'EisensteinHu'


def test_array_mesh():
    a = np.random.RandomState(5).normal(size=SHAPE)
    j = JaxArrayMesh(a, 300.0).compute('complex')
    t = ArrayMesh(a, 300.0, tag=1).compute('complex')
    _close(t.value.numpy(), as_numpy(j.value), 1e-12)
    np.testing.assert_array_equal(
        ArrayMesh(torch.from_numpy(a.astype('f4')), 300.0).compute().value,
        torch.from_numpy(a.astype('f4')))


# -- the lognormal mock ----------------------------------------------------

def _catalogs(dtype):
    kw = dict(nbar=NBAR, BoxSize=BOX, Nmesh=NMESH, bias=2.0, seed=SEED,
              dtype=dtype)
    return (JaxLogNormal(_plin(jcosmo), **kw),
            LogNormalCatalog(_plin(tcosmo), **kw))


@pytest.fixture(scope='module')
def catalogs_f8():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        return _catalogs('f8')


@pytest.fixture(scope='module')
def catalogs_f4():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        return _catalogs('f4')


def test_lognormal_counts_per_cell_f8():
    """JAX's lam and Poisson counts against the port's, cell by cell."""
    pj = JaxPM(NMESH, BOX, dtype='f8')
    delta, _ = jmock.gaussian_real_fields(pj, _plin(jcosmo), SEED)
    lam_j = NBAR * float(np.prod(pj.cellsize)) \
        * jmock.lognormal_transform(delta, bias=1.0).value
    k_pois = jax.random.split(jax.random.key(SEED))[0]
    counts_j = np.asarray(jax.random.poisson(k_pois, lam_j))

    pt = ParticleMesh(NMESH, BOX, dtype='f8')
    delta_k, _ = tmock.gaussian_complex_fields(pt, _plin(tcosmo), SEED)
    lam_t = tmock.lognormal_lambda(pt.c2r(delta_k.value), pt, NBAR, 2.0)
    _close(lam_t.numpy(), as_numpy(lam_j), 1e-12)
    counts_t = rng.poisson(rng.split(rng.key(SEED))[0], lam_t).numpy()
    np.testing.assert_array_equal(counts_t, counts_j)
    assert counts_t.sum() > 1000


def test_lognormal_counts_given_f4_lam():
    """At f4 lam differs in its last bits; given JAX's own f4 lam the
    counts are JAX's."""
    pj = JaxPM(NMESH, BOX, dtype='f4')
    delta, _ = jmock.gaussian_real_fields(pj, _plin(jcosmo), SEED)
    lam = (NBAR * float(np.prod(pj.cellsize))
           * jmock.lognormal_transform(delta, bias=1.0).value)
    k_pois = jax.random.split(jax.random.key(SEED))[0]
    ref = np.asarray(jax.random.poisson(k_pois, lam))
    got = rng.poisson(rng.split(rng.key(SEED))[0],
                      torch.from_numpy(np.array(as_numpy(lam)))).numpy()
    np.testing.assert_array_equal(got, ref)


def test_lognormal_catalog_f8(catalogs_f8):
    j, t = catalogs_f8
    assert t.size == j.size > 1000
    ulp = float(np.spacing(np.float32(BOX)))
    f = float(tcosmo.Planck15.scale_independent_growth_rate(0.55))
    vfac = f * 100.0 * float(tcosmo.Planck15.efunc(0.55)) / 1.55
    for col, tol in (('Position', ulp), ('Velocity', ulp * vfac),
                     ('VelocityOffset', ulp * f)):
        got, ref = t[col].numpy(), as_numpy(j[col])
        assert got.dtype == ref.dtype == np.float32
        d = np.abs(got.astype('f8') - ref)
        if col == 'Position':
            d = np.minimum(d, BOX - d)         # the periodic wrap
        assert d.max() <= tol, (col, d.max(), tol)
    assert float(t['Position'].min()) >= 0
    assert float(t['Position'].max()) < BOX
    assert t.attrs['seed'] == SEED and t.attrs['nbar'] == NBAR
    assert t.attrs['transfer'] == 'EisensteinHu'


def test_lognormal_catalog_f4(catalogs_f4):
    j, t = catalogs_f4
    assert abs(t.size - j.size) <= 1e-3 * j.size
    mj = j.to_mesh(Nmesh=NMESH, compensated=True).compute().value
    mt = t.to_mesh(Nmesh=NMESH, compensated=True).compute().value
    _close(mt.numpy(), as_numpy(mj), 1e-3)
    rj = JaxFFTPower(j, mode='1d', Nmesh=NMESH)
    rt = FFTPower(t, mode='1d', Nmesh=NMESH)
    np.testing.assert_array_equal(rt.power['modes'], rj.power['modes'])
    sel = rj.power['modes'] > 0
    _close(rt.power['power'].real[sel], rj.power['power'].real[sel], 1e-3)


def test_fftpower_on_lognormal_f8(catalogs_f8):
    """The benchmark's flow at test size: FFTPower(mode='2d', kmin,
    Nmu=10) on the f8 LogNormal catalog; modes identical, P to the
    BASELINE.md bar of 1e-4."""
    j, t = catalogs_f8
    kw = dict(mode='2d', Nmesh=NMESH, kmin=0.001, Nmu=10)
    rj, rt = JaxFFTPower(j, **kw), FFTPower(t, **kw)
    np.testing.assert_array_equal(rt.power['modes'], rj.power['modes'])
    sel = rj.power['modes'] > 0                # empty (k, mu) bins are NaN
    assert sel.sum() > 50 and (~sel).any()
    assert np.isnan(rt.power['power'][~sel]).all()
    _close(rt.power['power'].real[sel], rj.power['power'].real[sel], 1e-4)
    _close(rt.power['k'][sel], rj.power['k'][sel], 1e-10)
    assert rt.attrs['shotnoise'] == pytest.approx(rj.attrs['shotnoise'],
                                                  rel=1e-12)


def test_gaussian_fields_api():
    """gaussian_complex_fields / gaussian_real_fields with the
    displacement, against the JAX package's."""
    pj, pt = JaxPM(16, BOX, dtype='f8'), ParticleMesh(16, BOX, dtype='f8')
    dj, psij = jmock.gaussian_real_fields(pj, _plin(jcosmo), 9,
                                          compute_displacement=True)
    dt, psit = tmock.gaussian_real_fields(pt, _plin(tcosmo), 9,
                                          compute_displacement=True)
    _close(dt.value.numpy(), as_numpy(dj.value), 1e-12)
    for a, b in zip(psit, psij):
        _close(a.value.numpy(), as_numpy(b.value), 1e-12)
    _, kj = jmock.gaussian_complex_fields(pj, _plin(jcosmo), 9,
                                          compute_displacement=True)
    _, kt = tmock.gaussian_complex_fields(pt, _plin(tcosmo), 9,
                                          compute_displacement=True)
    for a, b in zip(kt, kj):
        _close(a.value.numpy(), as_numpy(b.value), 1e-12)
    lt = tmock.lognormal_transform(dt, bias=1.5).value
    lj = jmock.lognormal_transform(dj, bias=1.5).value
    _close(lt.numpy(), as_numpy(lj), 1e-12)


def test_poisson_sample_to_points_f8():
    """The mockmaker's sampler on the same f8 fields: the JAX package's
    positions and displacements (delta's buffer becomes lam in the
    port, so it gets its own copy)."""
    pj, pt = JaxPM(NMESH, BOX, dtype='f8'), ParticleMesh(NMESH, BOX,
                                                         dtype='f8')
    dj, psij = jmock.gaussian_real_fields(pj, _plin(jcosmo), SEED,
                                          compute_displacement=True)
    dt, psit = tmock.gaussian_real_fields(pt, _plin(tcosmo), SEED,
                                          compute_displacement=True)
    posj, dispj = jmock.poisson_sample_to_points(dj, psij, pj, NBAR,
                                                 bias=2.0, seed=SEED)
    post, dispt = tmock.poisson_sample_to_points(dt, psit, pt, NBAR,
                                                 bias=2.0, seed=SEED)
    assert post.shape == tuple(posj.shape) and post.shape[0] > 1000
    ulp = float(np.spacing(np.float32(BOX)))
    assert np.abs(post.numpy() - as_numpy(posj)).max() <= ulp
    _close(dispt.numpy(), as_numpy(dispj), 1e-6)


def test_lognormal_stage_timer_wraps_each_stage(catalogs_f8, monkeypatch):
    """With ``utils.stage_timer`` set, a LogNormalCatalog build
    enters each of its stages once, in order, and builds the same
    catalog as without it."""
    seen = []

    @contextlib.contextmanager
    def timer(name):
        seen.append(name)
        yield

    monkeypatch.setattr(tutils, 'stage_timer', timer)
    _, ref = catalogs_f8
    cat = LogNormalCatalog(_plin(tcosmo), nbar=NBAR, BoxSize=BOX,
                           Nmesh=NMESH, bias=2.0, seed=SEED, dtype='f8')
    assert seen == ['whitenoise', 'power', 'c2r_delta', 'lambda', 'poisson',
                    'points', 'displacement_c2r_gather', 'zeldovich']
    for col in ('Position', 'Velocity', 'VelocityOffset'):
        assert torch.equal(cat[col], ref[col])


@pytest.mark.parametrize('dtype', ['f8', 'f4'])
def test_poisson_cells_match_jax(dtype):
    """mockmaker.poisson_cells (the occupied-cells draw, sized by the
    lam sum nbar V) against the JAX package's counts on the same lam:
    the cells JAX's repeat keeps, their counts and Ntot. f8: the port's
    own lam (equal to JAX's to 1e-12); f4: JAX's lam handed over, as
    Queue C states for f4."""
    pj = JaxPM(NMESH, BOX, dtype=dtype)
    delta, _ = jmock.gaussian_real_fields(pj, _plin(jcosmo), SEED)
    lam_j = NBAR * float(np.prod(pj.cellsize)) \
        * jmock.lognormal_transform(delta, bias=1.0).value
    counts_j = np.asarray(jax.random.poisson(
        jax.random.split(jax.random.key(SEED))[0], lam_j)).reshape(-1)
    if dtype == 'f8':
        pt = ParticleMesh(NMESH, BOX, dtype='f8')
        delta_k, _ = tmock.gaussian_complex_fields(pt, _plin(tcosmo), SEED)
        lam_t = tmock.lognormal_lambda(pt.c2r(delta_k.value), pt, NBAR, 2.0)
    else:
        lam_t = torch.from_numpy(np.array(as_numpy(lam_j)))
    cells, counts, ntot = tmock.poisson_cells(lam_t, SEED,
                                              expected=NBAR * BOX ** 3)
    nz = np.flatnonzero(counts_j)
    np.testing.assert_array_equal(cells.numpy(), nz)
    np.testing.assert_array_equal(counts.numpy(), counts_j[nz])
    assert ntot == int(counts_j.sum()) > 1000
