"""ConvolvedFFTPower and the survey classes under it, through the PyTorch
port and the JAX package on the same numpy data and randoms.

Tolerances: f8 columns to 1e-10 of each column's largest value, ``modes``
identical, alpha, the normalizations and the shot noise to rel 1e-12,
the FKP field to 1e-12 of its maximum, the real Ylm to 1e-14, and an f4
mesh at the BASELINE.md bar of 1e-4."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu.algorithms.convpower import \
    ConvolvedFFTPower as JaxConvolved
from nbodykit_tpu.algorithms.convpower import FKPCatalog as JaxFKP
from nbodykit_tpu.algorithms.convpower import get_real_Ylm as jax_Ylm
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from nbodykit_tpu.source.catalog.species import \
    MultipleSpeciesCatalog as JaxSpecies
from nbodykit_tpu.utils import JSONEncoder as JaxEncoder
from nbodykit_tpu.utils import as_numpy
from nbodykit_tpu_torch.algorithms.convpower import (ConvolvedFFTPower,
                                                     FKPCatalog,
                                                     FKPWeightFromNbar,
                                                     get_real_Ylm)
from nbodykit_tpu_torch.lab import (ArrayCatalog, MultipleSpeciesCatalog,
                                    MultipleSpeciesCatalogMesh)
from nbodykit_tpu_torch.utils import JSONEncoder
from _torch_threads import one_torch_thread  # noqa: F401

NBAR = 2000 / 300.0 ** 3


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def _survey(seed=1, nd=2000, nr=6000):
    rng = np.random.RandomState(seed)
    data = {'Position': rng.uniform(100, 400, (nd, 3)),
            'NZ': NBAR * rng.uniform(0.8, 1.2, nd),
            'Weight': rng.uniform(0.5, 1.5, nd)}
    randoms = {'Position': rng.uniform(95, 410, (nr, 3)),
               'NZ': NBAR * rng.uniform(0.8, 1.2, nr)}
    randoms['NZ'] *= data['NZ'].sum() / nd / (randoms['NZ'].sum() / nr)
    return data, randoms


def _jax_fkp(data, randoms, **kw):
    cats = [JaxArray({k: jnp.asarray(v) for k, v in c.items()})
            if c is not None else None for c in (data, randoms)]
    return JaxFKP(*cats, **kw)


def _fkp(data, randoms, **kw):
    return FKPCatalog(ArrayCatalog(data),
                      ArrayCatalog(randoms) if randoms is not None
                      else None, **kw)


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.nanmax(np.abs(ref))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _compare_poles(tr, jr, rtol):
    np.testing.assert_array_equal(tr.poles['modes'], jr.poles['modes'])
    np.testing.assert_array_equal(tr.edges, jr.edges)
    _close(tr.poles['k'], jr.poles['k'], rtol)
    for ell in jr.attrs['poles']:
        col = 'power_%d' % ell
        assert tr.poles[col].dtype == np.complex128
        _close(tr.poles[col], np.asarray(jr.poles[col]), rtol)
    for key in ('alpha', 'data.norm', 'randoms.norm', 'shotnoise',
                'data.W', 'randoms.W', 'data.N', 'randoms.N'):
        assert tr.attrs[key] == pytest.approx(jr.attrs[key], rel=1e-12), key
    np.testing.assert_array_equal(tr.attrs['BoxSize'], jr.attrs['BoxSize'])


def _unit_vectors():
    rng = np.random.RandomState(4)
    v = rng.normal(size=(200, 3))
    v /= np.sqrt((v ** 2).sum(axis=1))[:, None]
    poles = np.array([[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0], [0, 1.0, 0],
                      [0, 0, 0.0]])
    return np.concatenate([v, poles])


@pytest.mark.parametrize('ell', [0, 1, 2, 3, 4])
def test_real_Ylm_matches_jax(ell):
    """Every m of each ell, at random unit vectors, the poles of the
    sphere, the equator and the zero vector, to 1e-14."""
    v = _unit_vectors()
    x, y, z = (torch.as_tensor(v[:, i]) for i in range(3))
    jx, jy, jz = (jnp.asarray(v[:, i]) for i in range(3))
    for m in range(-ell, ell + 1):
        got = get_real_Ylm(ell, m)(x, y, z).numpy()
        ref = np.asarray(jax_Ylm(ell, m)(jx, jy, jz))
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)


def test_real_Ylm_are_orthonormal():
    """The real Ylm up to ell = 4 are orthonormal on the sphere (a
    Lebedev-free check: Gauss-Legendre in cos(theta) times a uniform
    phi grid integrates these polynomials exactly)."""
    ct, wt = np.polynomial.legendre.leggauss(12)
    phi = np.arange(24) * 2 * np.pi / 24
    st = np.sqrt(1 - ct ** 2)
    x = torch.as_tensor(np.outer(st, np.cos(phi)).ravel())
    y = torch.as_tensor(np.outer(st, np.sin(phi)).ravel())
    z = torch.as_tensor(np.repeat(ct, 24))
    w = torch.as_tensor(np.repeat(wt, 24) * 2 * np.pi / 24)
    lm = [(l, m) for l in range(5) for m in range(-l, l + 1)]
    Y = [get_real_Ylm(l, m)(x, y, z) for l, m in lm]
    gram = np.array([[float((a * b * w).sum()) for b in Y] for a in Y])
    np.testing.assert_allclose(gram, np.eye(len(lm)), atol=1e-12)


def test_fkp_weight_and_bounding_box():
    """FKPWeightFromNbar, the P0 weights, the padded bounding box from
    the randoms (ceil of the padded extent), a given BoxSize, and an
    empty randoms slice that takes the box from the data."""
    data, randoms = _survey()
    assert FKPWeightFromNbar(0, 1.0) == 1.0
    assert FKPWeightFromNbar(1e4, 2e-4) == pytest.approx(1.0 / 3.0)
    t = _fkp(data, randoms, P0=1e4)
    j = _jax_fkp(data, randoms, P0=1e4)
    assert t.species == ['data', 'randoms']
    for name in ('data', 'randoms'):
        np.testing.assert_array_equal(t[name]['FKPWeight'].numpy(),
                                      as_numpy(j[name]['FKPWeight']))
        np.testing.assert_allclose(t[name]['FKPWeight'].numpy(),
                                   1 / (1 + 1e4 * t[name]['NZ'].numpy()),
                                   rtol=1e-15)
    for kw in ({}, {'BoxSize': 600.0}, {'BoxPad': 0.1}):
        tm = _fkp(data, randoms, **kw).to_mesh(Nmesh=16)
        jm = _jax_fkp(data, randoms, **kw).to_mesh(Nmesh=16)
        np.testing.assert_array_equal(tm.attrs['BoxSize'],
                                      jm.attrs['BoxSize'])
        np.testing.assert_array_equal(tm.attrs['BoxCenter'],
                                      jm.attrs['BoxCenter'])
    tm = _fkp(data, None).to_mesh(Nmesh=16)
    jm = _jax_fkp(data, None).to_mesh(Nmesh=16)
    assert len(tm.source['randoms']) == 0
    assert 'NZ' in tm.source['randoms'].columns
    np.testing.assert_array_equal(tm.attrs['BoxSize'], jm.attrs['BoxSize'])
    with pytest.raises(ValueError, match='not defined'):
        FKPCatalog(ArrayCatalog({'Position': data['Position']}),
                   ArrayCatalog(randoms))


@pytest.mark.parametrize('resampler,interlaced,dtype',
                         [('tsc', False, 'f8'), ('cic', True, 'f8'),
                          ('pcs', False, 'f4')])
def test_fkp_mesh_field_matches_jax(resampler, interlaced, dtype):
    """data - alpha randoms over the cell volume, to 1e-12 of the field
    maximum (1e-4 on an f4 mesh); alpha and the species attrs equal."""
    data, randoms = _survey()
    kw = dict(Nmesh=24, resampler=resampler, interlaced=interlaced,
              dtype=dtype)
    tf = _fkp(data, randoms).to_mesh(**kw).to_real_field()
    jf = _jax_fkp(data, randoms).to_mesh(**kw).to_real_field()
    ref = as_numpy(jf.value)
    assert tf.value.dtype == (torch.float64 if dtype == 'f8'
                              else torch.float32)
    tol = 1e-12 if dtype == 'f8' else 1e-4
    np.testing.assert_allclose(tf.value.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    assert set(tf.attrs) == set(jf.attrs)
    for key, val in jf.attrs.items():
        assert tf.attrs[key] == pytest.approx(val, rel=1e-12), key


RUNS = {
    # name: (FKPCatalog kwargs, to_mesh kwargs, run kwargs, rtol)
    'r2c_tsc_P0': ({'P0': 1e4}, dict(resampler='tsc'),
                   dict(poles=[0, 2, 4], dk=0.02), 1e-10),
    'r2c_cic_interlaced_dk0': ({}, dict(resampler='cic', interlaced=True),
                               dict(poles=[0, 2, 4], dk=0), 1e-10),
    'c2c_tsc': ({}, dict(resampler='tsc'),
                dict(poles=[0, 1, 2, 3, 4], dk=0.02), 1e-10),
    'c2c_cic_interlaced': ({}, dict(resampler='cic', interlaced=True),
                           dict(poles=[0, 1, 2, 3, 4], dk=0.02), 1e-10),
    'r2c_tsc_f4': ({}, dict(resampler='tsc', dtype='f4'),
                   dict(poles=[0, 2, 4], dk=0.02), 1e-4),
}


@pytest.fixture(scope='module')
def runs():
    """Each case of RUNS through both packages, once per module."""
    data, randoms = _survey()
    out = {}
    with nbodykit_tpu_torch.set_options(device='cpu'):
        for name, (fkw, mkw, rkw, rtol) in RUNS.items():
            tm = _fkp(data, randoms, **fkw).to_mesh(Nmesh=24, **mkw)
            jm = _jax_fkp(data, randoms, **fkw).to_mesh(Nmesh=24, **mkw)
            out[name] = (ConvolvedFFTPower(tm, **rkw),
                         JaxConvolved(jm, **rkw), rtol)
    return out


@pytest.mark.parametrize('name', sorted(RUNS))
def test_convolved_fftpower_matches_jax(runs, name):
    tr, jr, rtol = runs[name]
    _compare_poles(tr, jr, rtol)


def test_odd_poles_take_the_full_spectrum(runs, monkeypatch):
    """Any odd pole switches to the c2c transform (the transposed full
    layout); even poles alone stay on r2c."""
    from nbodykit_tpu_torch.pmesh import ParticleMesh
    seen = []
    real = ParticleMesh.forward_slabs

    def spy(self, slab, full=False):
        seen.append(full)
        return real(self, slab, full=full)
    monkeypatch.setattr(ParticleMesh, 'forward_slabs', spy)
    data, randoms = _survey(nd=300, nr=900)
    mesh = _fkp(data, randoms).to_mesh(Nmesh=8, resampler='cic')
    ConvolvedFFTPower(mesh, poles=[0, 2], dk=0.05)
    assert seen and not any(seen)
    seen.clear()
    r = ConvolvedFFTPower(mesh, poles=[1], dk=0.05)
    assert seen and all(seen)
    assert list(r.poles.variables) == ['k', 'power_1', 'modes']


def test_cross_mesh_matches_jax():
    """A cross mesh of the same FKPCatalog (another window) against the
    JAX package; alpha matches by construction."""
    data, randoms = _survey()
    tcat, jcat = _fkp(data, randoms), _jax_fkp(data, randoms)
    run = dict(poles=[0, 2], dk=0.02)
    tr = ConvolvedFFTPower(tcat.to_mesh(Nmesh=24, resampler='tsc'),
                           second=tcat.to_mesh(Nmesh=24, resampler='cic'),
                           **run)
    jr = JaxConvolved(jcat.to_mesh(Nmesh=24, resampler='tsc'),
                      second=jcat.to_mesh(Nmesh=24, resampler='cic'), **run)
    _compare_poles(tr, jr, 1e-10)


def test_mismatched_alpha_and_normalizations_raise():
    """A cross mesh of another geometry (alpha differs by > 1e-3) and an
    n(z) column whose data and randoms normalizations differ by > 5%
    raise, as in the JAX package."""
    data, randoms = _survey(nd=300, nr=900)
    mesh = _fkp(data, randoms).to_mesh(Nmesh=8)
    fewer = {k: v[:600] for k, v in randoms.items()}
    other = _fkp(data, fewer).to_mesh(Nmesh=8, BoxSize=mesh.attrs['BoxSize'],
                                      BoxCenter=mesh.attrs['BoxCenter'])
    with pytest.raises(ValueError, match='alpha'):
        ConvolvedFFTPower(mesh, poles=[0], second=other, dk=0.05)
    bad = dict(randoms, NZ=randoms['NZ'] * 1.2)
    for fkp, algorithm in ((_fkp(data, bad), ConvolvedFFTPower),
                           (_jax_fkp(data, bad), JaxConvolved)):
        with pytest.raises(ValueError, match='normalizations'):
            algorithm(fkp.to_mesh(Nmesh=8), poles=[0], dk=0.05)


def test_to_pkmu_matches_jax(runs):
    tr, jr, _ = runs['r2c_tsc_P0']
    mu_edges = np.linspace(0, 1, 4)
    t = tr.to_pkmu(mu_edges, 4)
    j = jr.to_pkmu(mu_edges, 4)
    for col in ('power', 'k', 'mu'):
        _close(t[col], np.asarray(j[col]), 1e-6 if col == 'power'
               else 1e-12)
    with pytest.raises(ValueError):
        runs['c2c_tsc'][0].to_pkmu(mu_edges, 6)


def test_save_load_both_formats(runs, tmp_path):
    """The current format round-trips, and reads a file the JAX package
    wrote; 'pre000305' reads the legacy layout (raw poles array beside
    flat edges) as the JAX package does."""
    tr, jr, _ = runs['c2c_tsc']
    path = str(tmp_path / 'cur.json')
    tr.save(path)
    back = ConvolvedFFTPower.load(path)
    np.testing.assert_array_equal(back.poles['power_3'],
                                  tr.poles['power_3'])
    np.testing.assert_array_equal(back.edges, tr.edges)
    assert back.attrs['alpha'] == tr.attrs['alpha']
    jpath = str(tmp_path / 'jax.json')
    jr.save(jpath)
    jback = ConvolvedFFTPower.load(jpath)
    _compare_poles(jback, tr, 1e-10)

    legacy = dict(edges=tr.edges, poles=tr.poles.data, attrs=tr.attrs)
    for enc, name in ((JSONEncoder, 'pt.json'), (JaxEncoder, 'jx.json')):
        lpath = str(tmp_path / name)
        with open(lpath, 'w') as ff:
            json.dump(legacy, ff, cls=enc)
        old = ConvolvedFFTPower.load(lpath, format='pre000305')
        ref = JaxConvolved.load(lpath, format='pre000305')
        for col in ('k', 'power_0', 'power_4', 'modes'):
            np.testing.assert_array_equal(old.poles[col], tr.poles[col])
            np.testing.assert_array_equal(old.poles[col],
                                          np.asarray(ref.poles[col]))
    with pytest.raises(ValueError, match='format'):
        ConvolvedFFTPower.load(path, format='nope')


def test_multiple_species_catalog_and_mesh():
    """Namespaced columns and attrs, column assignment through the
    container, and the summed 1 + delta mesh against the JAX package."""
    data, randoms = _survey(nd=500, nr=700)
    a = ArrayCatalog(data, BoxSize=300.0)
    b = ArrayCatalog(randoms, BoxSize=300.0)
    t = MultipleSpeciesCatalog(['a', 'b'], a, b)
    j = JaxSpecies(['a', 'b'], *(JaxArray({k: jnp.asarray(v) for k, v in
                                           c.items()}, BoxSize=300.0)
                                 for c in (data, randoms)))
    assert t.columns == j.columns
    assert t.attrs['a.BoxSize'] == 300.0 and len(t) == 1200
    t['b/Extra'] = np.arange(700.0)
    assert torch.equal(b['Extra'], torch.arange(700.0, dtype=torch.float64))
    with pytest.raises(ValueError):
        t['Extra'] = 1.0
    with pytest.raises(ValueError, match="'/'"):
        MultipleSpeciesCatalog(['a/b'], a)
    tm = t.to_mesh(Nmesh=16, BoxSize=512.0, resampler='tsc', dtype='f8')
    jm = j.to_mesh(Nmesh=16, BoxSize=512.0, resampler='tsc', dtype='f8')
    assert isinstance(tm, MultipleSpeciesCatalogMesh)
    tf, jf = tm.to_real_field(), jm.to_real_field()
    ref = as_numpy(jf.value)
    np.testing.assert_allclose(tf.value.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    for key, val in jf.attrs.items():
        assert tf.attrs[key] == pytest.approx(val, rel=1e-12), key


def test_catalog_view_slice_and_numpy_columns():
    """``cat[:0]``, boolean and index selections, ``view()`` keeping new
    columns off the base, column deletion, and numpy columns landing on
    the catalog's device."""
    data, _ = _survey(nd=50, nr=10)
    cat = ArrayCatalog(data)
    cat['NZ2'] = 2 * data['NZ']
    assert cat['NZ2'].device == cat.device
    empty = cat[:0]
    assert len(empty) == 0 and set(empty.columns) == set(cat.columns)
    mask = data['Weight'] > 1.0
    sub = cat[mask]
    assert len(sub) == int(mask.sum())
    np.testing.assert_array_equal(sub['Position'].numpy(),
                                  data['Position'][mask])
    idx = cat[torch.tensor([3, 1])]
    np.testing.assert_array_equal(idx['Weight'].numpy(),
                                  data['Weight'][[3, 1]])
    v = cat.view()
    v['Only'] = np.ones(50)
    assert 'Only' in v and 'Only' not in cat and v.base is cat
    assert v['Position'] is cat['Position']
    del cat['NZ2']
    assert 'NZ2' not in cat
    with pytest.raises(ValueError):
        del cat['Selection']
