"""FFTRecon, the mesh filters and the slab iterator through the PyTorch
port and the JAX package on the same seeded numpy inputs at 32^3: the
filtered fields to 1e-5 of their maximum, the reconstructed field (LGS,
LRR, LF2) to 1e-4 of its maximum and its P(k) to 1e-4, the slab
coordinates exactly."""

import numpy as np
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu import meshtools as jmt
from nbodykit_tpu.algorithms.fftpower import FFTPower as JaxFFTPower
from nbodykit_tpu.algorithms.fftrecon import FFTRecon as JaxFFTRecon
from nbodykit_tpu.filters import Gaussian as JaxGaussian
from nbodykit_tpu.filters import TopHat as JaxTopHat
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from nbodykit_tpu.source.mesh.array import ArrayMesh as JaxArrayMesh
from nbodykit_tpu_torch import meshtools as tmt
from nbodykit_tpu_torch.base.mesh import MeshFilter
from nbodykit_tpu_torch.lab import (ArrayCatalog, ArrayMesh, FFTPower,
                                    FFTRecon, Gaussian, TopHat)
from _torch_threads import one_torch_thread  # noqa: F401

BOX, NMESH = 200.0, 32


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def _field(seed=1, dtype='f4'):
    return np.random.RandomState(seed).normal(
        size=(NMESH,) * 3).astype(dtype)


@pytest.mark.parametrize('name,r', [('TopHat', 12.0), ('Gaussian', 8.0)])
@pytest.mark.parametrize('dtype', ['f4', 'f8'])
def test_filters_match_jax(name, r, dtype):
    a = _field(dtype=dtype)
    flt = {'TopHat': TopHat, 'Gaussian': Gaussian}[name](r)
    jflt = {'TopHat': JaxTopHat, 'Gaussian': JaxGaussian}[name](r)
    got = ArrayMesh(a, BOX).apply(flt).compute().value.numpy()
    want = np.asarray(JaxArrayMesh(a, BOX).apply(jflt).compute().value)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the filter's kind and mode win over apply's defaults
    view = ArrayMesh(a, BOX).apply(flt, kind='index', mode='real')
    assert view.actions[-1][0] == 'complex'
    assert view.actions[-1][2] == 'wavenumber'


def test_field_apply_takes_the_filter_mode():
    """Field.apply of a complex-mode filter on a real field transforms
    first; the result equals the deferred MeshSource.apply."""
    mesh = ArrayMesh(_field(2), BOX)
    now = mesh.compute().apply(Gaussian(10.0))
    assert now.kind == 'complex'
    later = mesh.apply(Gaussian(10.0)).compute(mode='complex')
    torch.testing.assert_close(now.value, later.value, rtol=0, atol=0)

    class Scale(MeshFilter):
        mode = 'real'
        kind = 'index'

        def filter(self, coords, v):
            return v * 2
    back = now.apply(Scale())
    assert back.kind == 'real'


@pytest.mark.parametrize('symmetry_axis', [None, 2])
@pytest.mark.parametrize('axis', [0, 1, 2])
def test_slab_iterator_matches_jax(axis, symmetry_axis):
    k = [np.fft.fftfreq(8).reshape(8, 1, 1), np.fft.fftfreq(6).reshape(1, 6, 1),
         np.arange(5.0).reshape(1, 1, 5) - 1]
    got = list(tmt.SlabIterator([torch.as_tensor(c) for c in k], axis=axis,
                                symmetry_axis=symmetry_axis))
    want = list(jmt.SlabIterator(k, axis=axis, symmetry_axis=symmetry_axis))
    assert len(got) == len(want) == k[axis].shape[axis]
    los = [0, 0, 1]
    for g, w in zip(got, want):
        assert str(g) == str(w) and g.shape == w.shape
        np.testing.assert_array_equal(g.norm2(), w.norm2())
        np.testing.assert_array_equal(g.mu(los), w.mu(los))
        np.testing.assert_array_equal(g.nonsingular, w.nonsingular)
        np.testing.assert_array_equal(g.hermitian_weights,
                                      w.hermitian_weights)


def _catalogs(seed=3):
    """Clustered data (2000) and uniform randoms (6000) in f8."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, BOX, (30, 3))
    data = np.mod(centres[rng.randint(30, size=2000)]
                  + rng.normal(scale=12.0, size=(2000, 3)), BOX)
    ran = rng.uniform(0, BOX, (6000, 3))
    return data, ran


_jax = {}


def _jax_recon(scheme, revert):
    key = (scheme, revert)
    if key not in _jax:
        data, ran = _catalogs()
        r = JaxFFTRecon(JaxArray({'Position': data}, BoxSize=BOX),
                        JaxArray({'Position': ran}, BoxSize=BOX),
                        Nmesh=NMESH, bias=2.0, f=0.77, R=15, scheme=scheme,
                        revert_rsd_random=revert)
        field = np.asarray(r.compute().value)
        p = JaxFFTPower(r, mode='1d')
        _jax[key] = field, np.asarray(p.power['power'].real)
    return _jax[key]


@pytest.mark.parametrize('scheme,revert', [('LGS', False), ('LRR', True),
                                           ('LF2', False)])
def test_fftrecon_matches_jax(scheme, revert):
    data, ran = _catalogs()
    r = FFTRecon(ArrayCatalog({'Position': data}, BoxSize=BOX),
                 ArrayCatalog({'Position': ran}, BoxSize=BOX),
                 Nmesh=NMESH, bias=2.0, f=0.77, R=15, scheme=scheme,
                 revert_rsd_random=revert)
    field = r.compute().value
    assert field.dtype == torch.float32 and field.device.type == 'cpu'
    want, p_want = _jax_recon(scheme, revert)
    got = field.numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert abs(float(got.mean())) < 1e-4 * np.abs(want).max()
    p = FFTPower(r, mode='1d').power['power'].real
    ok = np.isfinite(p_want)
    assert np.isfinite(p[ok]).all()
    np.testing.assert_allclose(p[ok], p_want[ok], rtol=1e-4,
                               atol=1e-4 * np.abs(p_want[ok]).max())


def test_fftrecon_refuses_bad_arguments():
    data, ran = _catalogs()
    d = ArrayCatalog({'Position': data}, BoxSize=BOX)
    with pytest.raises(ValueError, match='scheme'):
        FFTRecon(d, d, Nmesh=8, scheme='XYZ')
    with pytest.raises(TypeError):
        FFTRecon(d, data, Nmesh=8)
