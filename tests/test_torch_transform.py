"""The survey column transforms, the halo property transforms and
RedshiftHistogram through the PyTorch port and the JAX package on the
same numpy columns, to 1e-10 relative (f8; 1e-12 for the halo
properties) and 1e-5 (f4 columns)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu import cosmology as jcosmo
from nbodykit_tpu import transform as jt
from nbodykit_tpu.algorithms.zhist import \
    RedshiftHistogram as JaxRedshiftHistogram
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from nbodykit_tpu.utils import as_numpy
from nbodykit_tpu_torch import cosmology as tcosmo
from nbodykit_tpu_torch import transform as tt
from nbodykit_tpu_torch.algorithms.zhist import (RedshiftHistogram,
                                                 scotts_bin_width)
from nbodykit_tpu_torch.lab import ArrayCatalog
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def _pos(n=500, seed=3, dtype='f8'):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-800, 800, (n, 3)).astype(dtype)
    pos[0] = 0                                    # the observer itself
    return pos


def _close(got, ref, rtol=1e-10):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_stack_and_constant_columns():
    rng = np.random.RandomState(1)
    a, b = rng.normal(size=10), rng.normal(size=10)
    got = tt.StackColumns(a, torch.as_tensor(b))
    assert got.device.type == 'cpu'
    _close(got, jt.StackColumns(a, b), 0)
    for value in (2.5, 7, [1.0, 2.0, 3.0]):
        got = tt.ConstantArray(value, 6)
        ref = np.asarray(jt.ConstantArray(value, 6))
        assert got.shape == ref.shape and got.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(got.numpy(), ref)


def test_concatenate_sources():
    rng = np.random.RandomState(2)
    c1 = {'Position': rng.normal(size=(5, 3)), 'Mass': rng.normal(size=5)}
    c2 = {'Position': rng.normal(size=(4, 3)), 'Mass': rng.normal(size=4),
          'Extra': np.ones(4)}
    t = tt.ConcatenateSources(ArrayCatalog(c1, a=1), ArrayCatalog(c2, b=2))
    j = jt.ConcatenateSources(JaxArray(c1, a=1), JaxArray(c2, b=2))
    assert t.columns == j.columns and len(t) == len(j) == 9
    assert t.attrs['a'] == 1 and t.attrs['b'] == 2
    for col in ('Position', 'Mass'):
        np.testing.assert_array_equal(t[col].numpy(), as_numpy(j[col]))
    t = tt.ConcatenateSources(ArrayCatalog(c1), ArrayCatalog(c2),
                              columns='Mass')
    assert 'Position' not in t and len(t) == 9
    with pytest.raises(ValueError, match='Extra'):
        tt.ConcatenateSources(ArrayCatalog(c1), ArrayCatalog(c2),
                              columns=['Extra'])


@pytest.mark.parametrize('frame', ['icrs', 'galactic'])
@pytest.mark.parametrize('dtype,rtol', [('f8', 1e-10), ('f4', 1e-5)])
def test_cartesian_to_equatorial(frame, dtype, rtol):
    pos = _pos(dtype=dtype)
    obs = [10.0, -20.0, 5.0]
    lon, lat = tt.CartesianToEquatorial(torch.as_tensor(pos), observer=obs,
                                        frame=frame)
    jlon, jlat = jt.CartesianToEquatorial(jnp.asarray(pos), observer=obs,
                                          frame=frame)
    assert lon.dtype == (torch.float64 if dtype == 'f8' else torch.float32)
    _close(lon, jlon, rtol)
    _close(lat, jlat, rtol)
    with pytest.raises(ValueError, match='frame'):
        tt.CartesianToEquatorial(pos, frame='fk5')


@pytest.mark.parametrize('frame', ['icrs', 'galactic'])
def test_sky_to_cartesian_and_back(frame):
    rng = np.random.RandomState(4)
    ra = rng.uniform(0, 360, 300)
    dec = rng.uniform(-90, 90, 300)
    z = rng.uniform(0.01, 1.5, 300)
    obs = [1.0, 2.0, 3.0]
    got = tt.SkyToCartesian(ra, dec, z, tcosmo.Planck15, observer=obs,
                            frame=frame)
    ref = jt.SkyToCartesian(ra, dec, z, jcosmo.Planck15, observer=obs,
                            frame=frame)
    _close(got, ref)
    _close(tt.SkyToUnitSphere(np.radians(ra), np.radians(dec),
                              degrees=False),
           jt.SkyToUnitSphere(np.radians(ra), np.radians(dec),
                              degrees=False))
    rng2 = np.random.RandomState(5)
    vel = rng2.normal(0, 300, (300, 3))
    out = tt.CartesianToSky(got, tcosmo.Planck15, velocity=vel,
                            observer=obs, frame=frame)
    jout = jt.CartesianToSky(ref, jcosmo.Planck15, velocity=vel,
                             observer=obs, frame=frame)
    for a, b in zip(out, jout):
        _close(a, b)
    ra2, dec2, z2 = tt.CartesianToSky(got, tcosmo.Planck15, observer=obs,
                                      frame=frame)
    # the round trip through the distance table returns the inputs
    np.testing.assert_allclose(z2.numpy(), z, rtol=1e-4)
    np.testing.assert_allclose(dec2.numpy(), dec, atol=1e-8)


def test_vector_projection():
    rng = np.random.RandomState(6)
    v, d = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    _close(tt.VectorProjection(v, d), jt.VectorProjection(v, d))
    _close(tt.VectorProjection(torch.as_tensor(v), [0, 0, 2]),
           jt.VectorProjection(v, [0, 0, 2]))


@pytest.mark.parametrize('bins', [None, 12, np.linspace(0.1, 1.0, 7)])
def test_redshift_histogram_matches_jax(bins):
    rng = np.random.RandomState(7)
    z = rng.uniform(0.1, 1.0, 4000) ** 1.3
    w = rng.uniform(0.5, 1.5, 4000)
    t = RedshiftHistogram(ArrayCatalog({'Redshift': z, 'W': w}), 0.1,
                          tcosmo.Planck15, bins=bins, weight='W')
    j = JaxRedshiftHistogram(JaxArray({'Redshift': jnp.asarray(z),
                                       'W': jnp.asarray(w)}), 0.1,
                             jcosmo.Planck15, bins=bins, weight='W')
    np.testing.assert_array_equal(t.bin_edges, j.bin_edges)
    for a, b in ((t.nbar, j.nbar), (t.dV, j.dV),
                 (t.hist['counts'], j.hist['counts'])):
        _close(a, b, 1e-12)
    zq = torch.linspace(0.0, 1.2, 50, dtype=torch.float64)
    _close(t.interpolate(zq), j.interpolate(zq.numpy()), 1e-12)
    assert scotts_bin_width(z) == pytest.approx(
        3.5 * z.std() / len(z) ** (1 / 3.))
    assert scotts_bin_width(np.ones(5)) == 0.1


@pytest.mark.parametrize('mdef', ['vir', '200m', '500c'])
@pytest.mark.parametrize('redshift', [0.0, 0.7, 'per-object'])
def test_halo_transforms_match_jax(mdef, redshift):
    rng = np.random.RandomState(4)
    mass = 10 ** rng.uniform(11, 15, 300)
    if redshift == 'per-object':
        redshift = rng.uniform(0, 2, 300)
    for name in ('HaloRadius', 'HaloConcentration',
                 'HaloVelocityDispersion'):
        got = getattr(tt, name)(torch.as_tensor(mass), tcosmo.Planck15,
                                redshift, mdef=mdef)
        assert got.device.type == 'cpu' and got.dtype == torch.float64
        _close(got, getattr(jt, name)(mass, jcosmo.Planck15, redshift,
                                      mdef=mdef), 1e-12)
