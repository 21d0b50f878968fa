"""Halo occupation through the PyTorch port and the JAX package on the
same seeded numpy halos: the occupation functions and the mass-binned
percentile (1e-12), HaloCatalog's derived columns (1e-12), and
``populate`` with a seed (the same galaxy count and gal_type, Position
and Velocity to 1e-10 at f8)."""

import numpy as np
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu import hod as jhod
from nbodykit_tpu.cosmology import Planck15 as JPlanck15
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from nbodykit_tpu.source.catalog.halos import HaloCatalog as JaxHalos
from nbodykit_tpu_torch import hod as thod
from nbodykit_tpu_torch.cosmology import Planck15
from nbodykit_tpu_torch.lab import (ArrayCatalog, HaloCatalog, HODModel,
                                    HODModelFactory, PopulatedHaloCatalog,
                                    Zheng07Model)
from _torch_threads import one_torch_thread  # noqa: F401

BOX = 250.0


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def halo_columns(n=400, seed=5):
    rng = np.random.RandomState(seed)
    return {'Position': rng.uniform(0, BOX, (n, 3)),
            'Velocity': rng.normal(scale=300.0, size=(n, 3)),
            'Mass': 10 ** rng.uniform(12.0, 15.0, n)}


def both_halos(z=0.3, mdef='vir', **kw):
    cols = halo_columns(**kw)
    j = JaxHalos(JaxArray(cols, BoxSize=BOX), cosmo=JPlanck15, redshift=z,
                 mdef=mdef)
    t = HaloCatalog(ArrayCatalog(cols, BoxSize=BOX), cosmo=Planck15,
                    redshift=z, mdef=mdef)
    return j, t


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


MODELS = [('Zheng07Model', {}), ('Zheng07Model', {'logMmin': 12.5}),
          ('Leauthaud11Model', {}), ('Leauthaud11Model', {'threshold': 10.0}),
          ('Hearin15Model', {}), ('Hearin15Model', {'split': 0.3,
                                                    'assembias_strength': -0.8})]


@pytest.mark.parametrize('name,params', MODELS,
                         ids=['%s-%d' % (m[0], i) for i, m in
                              enumerate(MODELS)])
def test_occupation_functions_equal_jax(name, params):
    M = 10 ** np.linspace(11.0, 15.5, 200)
    j = getattr(jhod, name)(**params)
    t = getattr(thod, name)(**params)
    assert t.params == j.params
    _close(t.mean_ncen(M), j.mean_ncen(M), 1e-12)
    _close(t.mean_nsat(M), j.mean_nsat(M), 1e-12)
    if getattr(j, 'uses_assembly_bias', False):
        conc = np.random.RandomState(2).uniform(3, 12, M.size)
        pct = thod.mass_binned_percentile(M, conc)
        _close(pct, jhod.mass_binned_percentile(M, conc), 1e-12)
        _close(t.mean_ncen(M, percentile=pct),
               j.mean_ncen(M, percentile=pct), 1e-12)
        _close(t.mean_nsat(M, percentile=pct),
               j.mean_nsat(M, percentile=pct), 1e-12)


@pytest.mark.parametrize('mdef,z', [('vir', 0.0), ('200m', 0.5),
                                    ('500c', 1.2)])
def test_halo_catalog_columns_equal_jax(mdef, z):
    j, t = both_halos(z=z, mdef=mdef)
    for col in ('Position', 'Velocity', 'Mass', 'Radius', 'Concentration',
                'VelocityOffset'):
        assert t[col].device.type == 'cpu'
        _close(t[col], j[col], 1e-12)


def test_halo_mass_from_length():
    cols = halo_columns()
    length = np.random.RandomState(1).randint(20, 500, len(cols['Mass']))
    cols = {'Position': cols['Position'], 'Length': length}
    t = HaloCatalog(ArrayCatalog(cols, BoxSize=BOX), cosmo=Planck15,
                    redshift=0.0, particle_mass=2.5e11)
    assert t['Mass'].dtype == torch.float64
    np.testing.assert_array_equal(t['Mass'].numpy(), length * 2.5e11)


POPULATE = [('Zheng07Model', {'logMmin': 12.8}, 42),
            ('Zheng07Model', {}, 7),
            ('Leauthaud11Model', {'threshold': 10.2}, 3),
            ('Hearin15Model', {'threshold': 10.2, 'split': 0.4}, 11)]


@pytest.mark.parametrize('name,params,seed', POPULATE,
                         ids=['%s-%d' % (m[0], m[2]) for m in POPULATE])
def test_populate_equals_jax(name, params, seed):
    j, t = both_halos(z=0.2)
    jg = j.populate(getattr(jhod, name), seed=seed, **params)
    tg = t.populate(getattr(thod, name), seed=seed, **params)
    assert isinstance(tg, PopulatedHaloCatalog)
    assert len(tg) == len(jg)
    n_sat = int((np.asarray(jg['gal_type']) == 1).sum())
    assert n_sat > 0 and len(jg) - n_sat > 0
    np.testing.assert_array_equal(tg['gal_type'].numpy(),
                                  np.asarray(jg['gal_type']))
    _close(tg['HaloMass'], jg['HaloMass'], 1e-12)
    for col in ('Position', 'Velocity'):
        np.testing.assert_allclose(tg[col].numpy(), np.asarray(jg[col]),
                                   rtol=1e-10, atol=1e-10 * BOX,
                                   err_msg=col)
    assert tg.attrs['seed'] == seed
    assert tg['Position'].device.type == 'cpu'


def test_populate_entry_forms():
    """An HODModel, an occupation instance, a class with parameters and
    the factory give the same galaxies for one seed; parameters with an
    instance are refused."""
    _, t = both_halos()
    a = t.populate(Zheng07Model, seed=9, logMmin=12.6)
    b = t.populate(Zheng07Model(logMmin=12.6), seed=9)
    c = HODModel(Zheng07Model(logMmin=12.6), seed=9).populate(t)
    d = HODModelFactory(Zheng07Model(logMmin=12.6), seed=9)(t)
    for other in (b, c, d):
        np.testing.assert_array_equal(a['Position'].numpy(),
                                      other['Position'].numpy())
    with pytest.raises(ValueError, match='occupation class'):
        t.populate(Zheng07Model(), seed=1, logMmin=12.0)
