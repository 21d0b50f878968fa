"""FFTCorr and ProjectedFFTPower through the PyTorch port and the JAX
package on the same numpy catalog: ``modes`` identical, the other
columns to 1e-10 of each column's largest value on an f8 mesh (1e-4 on
an f4 mesh)."""

import numpy as np
import jax.numpy as jnp
import pytest

import nbodykit_tpu_torch
from nbodykit_tpu.algorithms.fftcorr import FFTCorr as JaxFFTCorr
from nbodykit_tpu.algorithms.fftpower import \
    ProjectedFFTPower as JaxProjected
from nbodykit_tpu.algorithms.fftpower import \
    _find_unique_edges as jax_unique_edges
from nbodykit_tpu.pmesh import ParticleMesh as JaxPM
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from nbodykit_tpu_torch.algorithms import FFTCorr, ProjectedFFTPower
from nbodykit_tpu_torch.algorithms.fftpower import _find_unique_edges
from nbodykit_tpu_torch.convert import catalog_from_numpy
from nbodykit_tpu_torch.pmesh import ParticleMesh
from _torch_threads import one_torch_thread  # noqa: F401

BOX = 200.0


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def _columns(n=3000, seed=5):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    # a clustered half, so xi and the projected power carry signal
    pos[::2] = (pos[::2] % 40.0) + 80.0
    return {'Position': pos, 'Weight': rng.uniform(0.5, 1.5, n)}


def _meshes(dtype='f8', **kw):
    cols = _columns()
    mesh_kw = dict(Nmesh=24, resampler='tsc', compensated=True,
                   dtype=dtype, **kw)
    jcat = JaxArray({k: jnp.asarray(v) for k, v in cols.items()},
                    BoxSize=BOX)
    return (catalog_from_numpy(cols, BOX).to_mesh(**mesh_kw),
            jcat.to_mesh(**mesh_kw))


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.nanmax(np.abs(ref))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _compare(t, j, cols, rtol):
    np.testing.assert_array_equal(t['modes'], np.asarray(j['modes']))
    for col in cols:
        _close(t[col], np.asarray(j[col]), rtol)


CORR_CASES = [
    # (dtype, mode, dr, poles, rtol)
    ('f8', '1d', None, [], 1e-10),
    ('f8', '2d', None, [0, 2, 4], 1e-10),
    ('f8', '1d', 0, [0, 2], 1e-10),
    ('f4', '2d', None, [0, 2], 1e-4),
]


@pytest.mark.parametrize('dtype,mode,dr,poles,rtol', CORR_CASES)
def test_fftcorr_matches_jax(dtype, mode, dr, poles, rtol):
    tm, jm = _meshes(dtype)
    kw = dict(mode=mode, dr=dr, poles=poles, Nmu=4)
    t, j = FFTCorr(tm, **kw), JaxFFTCorr(jm, **kw)
    cols = ['r', 'corr'] + (['mu'] if mode == '2d' else [])
    _compare(t.corr, j.corr, cols, rtol)
    if poles:
        _compare(t.poles, j.poles, ['r'] + ['corr_%d' % l for l in poles],
                 rtol)
    else:
        assert t.poles is None and j.poles is None
    np.testing.assert_array_equal(t.corr.edges['r'],
                                  np.asarray(j.corr.edges['r']))


def test_fftcorr_json_roundtrip(tmp_path):
    tm, _ = _meshes()
    r = FFTCorr(tm, mode='2d', poles=[0, 2])
    path = str(tmp_path / 'xi.json')
    r.save(path)
    back = FFTCorr.load(path)
    np.testing.assert_array_equal(back.corr['corr'], r.corr['corr'])
    np.testing.assert_array_equal(back.poles['corr_2'], r.poles['corr_2'])


@pytest.mark.parametrize('Nmesh,box', [(16, 100.0), ((8, 10, 12),
                                                      (80.0, 90.0, 100.0))])
def test_unique_real_edges_match_jax(Nmesh, box):
    """The dr=0 edges: every unique separation of a cubic and of an
    anisotropic mesh."""
    t = _find_unique_edges(ParticleMesh(Nmesh, box), 40.0, kind='real')
    j = jax_unique_edges(JaxPM(Nmesh, box), 40.0, kind='real')
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError):
        _find_unique_edges(ParticleMesh(8, 10.0), 5.0, kind='other')


@pytest.mark.parametrize('axes', [(0, 1), (2,), (2, 0)])
@pytest.mark.parametrize('dtype,rtol', [('f8', 1e-10), ('f4', 1e-4)])
def test_projected_fftpower_matches_jax(axes, dtype, rtol):
    tm, jm = _meshes(dtype)
    t, j = ProjectedFFTPower(tm, axes=axes), JaxProjected(jm, axes=axes)
    _compare(t.power, j.power, ['k', 'power'], rtol)
    assert t.attrs['axes'] == list(axes)


def test_projected_cross_and_roundtrip(tmp_path):
    """A cross spectrum with a second mesh (another window) and the JSON
    round trip."""
    tm, jm = _meshes()
    tm2, jm2 = _meshes(interlaced=True)
    t = ProjectedFFTPower(tm, second=tm2, axes=(0, 2), dk=0.05)
    j = JaxProjected(jm, second=jm2, axes=(0, 2), dk=0.05)
    _compare(t.power, j.power, ['k', 'power'], 1e-10)
    path = str(tmp_path / 'pp.json')
    t.save(path)
    back = ProjectedFFTPower.load(path)
    np.testing.assert_array_equal(back.power['power'], t.power['power'])
    with pytest.raises(ValueError):
        ProjectedFFTPower(tm, axes=(0, 1, 2))
