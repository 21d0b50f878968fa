"""The port's mesh resampling and preview, catalog sort and
``DistributedRNG.choice`` against the JAX package's (x64 on).

Resampling copies modes, so the port's ``_resample`` of the JAX
package's own complex field is bit-identical; whole ``compute(Nmesh=)``
runs differ only by the two FFT libraries' rounding (1e-12 of the field
maximum). Sorts and choices are bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nbodykit_tpu.base.mesh import Field as JaxField
from nbodykit_tpu.rng import DistributedRNG as JaxRNG
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArrayCatalog
from nbodykit_tpu.source.mesh.array import ArrayMesh as JaxArrayMesh
from nbodykit_tpu.utils import as_numpy

import nbodykit_tpu_torch
from nbodykit_tpu_torch import rng
from nbodykit_tpu_torch.convert import field_from_numpy
from nbodykit_tpu_torch.lab import ArrayCatalog, ArrayMesh, ParticleMesh
from _torch_threads import one_torch_thread  # noqa: F401

BOX = (100.0, 80.0, 60.0)


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def _field(shape, seed=0, dtype='f8'):
    return np.random.RandomState(seed).normal(size=shape).astype(dtype)


def _meshes(shape, dtype='f8'):
    x = _field(shape, dtype=dtype)
    return ArrayMesh(x, BOX), JaxArrayMesh(x, BOX)


def _close_field(a, b, rel=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rel * scale


# -- resampling ------------------------------------------------------------

RESAMPLES = [((16, 16, 16), 8), ((8, 8, 8), 16), ((16, 16, 16), 16),
             ((15, 15, 15), 9), ((9, 9, 9), 15), ((15, 15, 15), 15),
             ((16, 16, 16), 9), ((9, 9, 9), 16),
             ((16, 12, 10), (8, 14, 6)), ((16, 12, 10), (20, 7, 11)),
             ((12, 12, 12), (12, 6, 12))]


@pytest.mark.parametrize('src,dst', RESAMPLES)
def test_resample_copies_the_jax_modes(src, dst):
    """The same complex field in, the same modes out, bit for bit: down,
    up and to the same size, even and odd, per axis."""
    tmesh, jmesh = _meshes(src)
    jfield = jmesh.compute(mode='complex')
    tpm = ParticleMesh(src, BOX, dtype='f8')
    tfield = field_from_numpy(as_numpy(jfield.value), tpm, 'complex')
    j = jmesh._resample(jfield, dst)
    t = tmesh._resample(tfield, dst)
    assert t.kind == 'complex' and t.pm.shape_real == j.pm.shape_real
    assert t.pm.BoxSize.tolist() == list(BOX)
    np.testing.assert_array_equal(t.value.numpy(), as_numpy(j.value))


@pytest.mark.parametrize('src,dst', RESAMPLES)
@pytest.mark.parametrize('mode', ['real', 'complex'])
def test_compute_with_nmesh(src, dst, mode):
    tmesh, jmesh = _meshes(src)
    t = tmesh.compute(mode=mode, Nmesh=dst)
    j = jmesh.compute(mode=mode, Nmesh=dst)
    assert t.kind == j.kind == mode
    _close_field(t.value.numpy(), as_numpy(j.value))


def test_compute_with_nmesh_runs_the_actions_first():
    """Actions run at the source size, then the resample; a real field
    is transformed first."""
    tmesh, jmesh = _meshes((16, 16, 16))
    f = lambda k, v: v * (1 + k[0] ** 2 + k[1] ** 2 + k[2] ** 2)  # noqa
    t = tmesh.apply(f).compute(Nmesh=8)
    j = jmesh.apply(f).compute(Nmesh=8)
    _close_field(t.value.numpy(), as_numpy(j.value))
    # the same Nmesh is no resample at all
    same = tmesh.compute(Nmesh=16)
    np.testing.assert_array_equal(same.value.numpy(),
                                  tmesh.compute().value.numpy())


@pytest.mark.parametrize('dtype', ['f4', 'f8'])
def test_resample_keeps_the_dtype_and_device(dtype):
    tmesh, _ = _meshes((8, 8, 8), dtype)
    c = tmesh.compute(mode='complex', Nmesh=12)
    assert c.value.dtype == (torch.complex64 if dtype == 'f4'
                             else torch.complex128)
    assert c.value.device.type == 'cpu' and c.pm.dtype == np.dtype(dtype)


@pytest.mark.parametrize('axes,nmesh', [(None, None), ([0, 1], None),
                                        (2, None), ([0], 8), ([1, 2], 12),
                                        (None, (8, 6, 10)), ([0, 2], 9)])
def test_preview(axes, nmesh):
    tmesh, jmesh = _meshes((16, 12, 10))
    t = tmesh.preview(axes=axes, Nmesh=nmesh)
    j = jmesh.preview(axes=axes, Nmesh=nmesh)
    assert isinstance(t, np.ndarray)
    _close_field(t, j)


def test_field_preview_sums_the_other_axes():
    x = _field((6, 5, 4))
    pm = ParticleMesh((6, 5, 4), BOX, dtype='f8')
    t = field_from_numpy(x, pm)
    from nbodykit_tpu.pmesh import ParticleMesh as JaxPM
    j = JaxField(jnp.asarray(x), JaxPM((6, 5, 4), BOX, dtype='f8'), 'real')
    for axes in (None, [1], (0, 2), 2):
        np.testing.assert_allclose(t.preview(axes), j.preview(axes),
                                   rtol=1e-13)


# -- sort ------------------------------------------------------------------

def _catalog_data(n=3000, seed=5):
    rs = np.random.RandomState(seed)
    return {'a': rs.randint(0, 7, n),                 # many ties
            'b': rs.randint(0, 3, n).astype('f8'),
            'x': rs.normal(size=n),
            'Position': rs.uniform(0, 100, (n, 3)),
            'id': np.arange(n)}


def _catalogs():
    data = _catalog_data()
    j = JaxArrayCatalog({k: jnp.asarray(v) for k, v in data.items()},
                        BoxSize=100.0)
    assert j.comm is None
    return ArrayCatalog(data, BoxSize=100.0), j


@pytest.mark.parametrize('keys', ['x', 'a', ['a', 'b'], ['b', 'a', 'x'],
                                  ['a', 'x']])
@pytest.mark.parametrize('reverse', [False, True])
def test_sort(keys, reverse):
    t, j = _catalogs()
    ts, js = t.sort(keys, reverse=reverse), j.sort(keys, reverse=reverse)
    assert sorted(ts.columns) == sorted(js.columns)
    for c in ('a', 'b', 'x', 'Position', 'id'):
        np.testing.assert_array_equal(ts[c].numpy(), as_numpy(js[c]))
    assert ts.attrs['BoxSize'] == 100.0


def test_sort_reverse_reverses_ties_too():
    """On one device the whole order is flipped, ties included (the JAX
    package's single-device branch, not its docstring)."""
    t, _ = _catalogs()
    fwd = t.sort('a')['id'].numpy()
    rev = t.sort('a', reverse=True)['id'].numpy()
    np.testing.assert_array_equal(rev, fwd[::-1])


def test_sort_usecols():
    t, j = _catalogs()
    ts = t.sort(['b', 'x'], usecols=['id', 'Position'])
    js = j.sort(['b', 'x'], usecols=['id', 'Position'])
    for c in ('id', 'Position'):
        np.testing.assert_array_equal(ts[c].numpy(), as_numpy(js[c]))
    assert 'a' not in ts._columns


# -- randint and choice ----------------------------------------------------

@pytest.mark.parametrize('n', [1, 5, 16, 17, 100, 257, 4096, 10 ** 5 + 3])
@pytest.mark.parametrize('dtype', ['f8', 'f4'])
def test_cumsum_in_xla_order(n, dtype):
    p = np.random.RandomState(n).uniform(0, 1, n).astype(dtype)
    p /= p.sum()
    np.testing.assert_array_equal(rng.cumsum_xla(torch.from_numpy(p)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(p))))


@pytest.mark.parametrize('lo,hi', [(0, 1), (0, 7), (0, 2 ** 16), (-5, 1000),
                                   (3, 3), (9, 2), (0, 10 ** 9 + 7),
                                   (0, 2 ** 31 - 1)])
def test_randint(lo, hi):
    key = rng.fold_in(rng.key(11), 3)
    ref = jax.random.randint(jax.random.fold_in(jax.random.key(11), 3),
                             (999,), lo, hi)
    got = rng.randint(key, (999,), lo, hi)
    assert got.dtype == torch.int64 and np.asarray(ref).dtype == np.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


CHOICES = {
    'int': (7, None, None),
    'int_p': (7, np.array([0.1, 0.2, 0.3, 0.1, 0.1, 0.15, 0.05]),
              None),
    'int_p_zeros': (5, np.array([0.0, 0.5, 0.0, 0.5, 0.0]), None),
    'array': (np.arange(10) * 1.5, None, (3,)),
    'array_p': (np.array([2, 4, 8]), np.array([0.5, 0.25, 0.25]), (2, 2)),
    'rows': (np.arange(12.).reshape(4, 3), None, None),
    'many_p': (300, 'random', None),
    'f4_p': (40, 'random_f4', (2,)),
}


@pytest.mark.parametrize('case', sorted(CHOICES))
def test_choice_matches_jax(case):
    choices, p, item = CHOICES[case]
    if isinstance(p, str):
        p = np.random.RandomState(3).uniform(0, 1, choices)
        if case == 'f4_p':
            p = p.astype('f4')
        p = p / p.sum()
    t, j = rng.DistributedRNG(42, 1000), JaxRNG(42, 1000)
    t.uniform(), j.uniform()                 # choice follows other draws
    got = t.choice(choices, p=p, itemshape=item)
    ref = np.asarray(j.choice(choices, p=p, itemshape=item))
    assert tuple(got.shape) == ref.shape and got.device.type == 'cpu'
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the stream goes on in step
    np.testing.assert_array_equal(t.uniform().numpy(),
                                  np.asarray(j.uniform()))


def test_choice_checks_p():
    with pytest.raises(ValueError, match='p must be'):
        rng.DistributedRNG(1, 10).choice(3, p=[0.5, 0.5])
    with pytest.raises(ValueError, match='greater than 0'):
        rng.DistributedRNG(1, 10).choice(0)
    assert rng.DistributedRNG(1, 0).choice(4).shape == (0,)
