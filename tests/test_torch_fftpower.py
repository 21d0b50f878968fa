"""The slice as a whole: catalog -> paint -> r2c -> compensation ->
(k, mu) binning with multipoles, through the PyTorch port and the JAX
package on the same numpy catalog.

``modes`` must be identical; k, mu and power agree to rtol 1e-10 on an
f8 mesh and 1e-4 on an f4 mesh (the BASELINE.md bar), relative to each
column's largest value (poles of order 2 and 4 sit near zero)."""

import numpy as np
import jax.numpy as jnp
import pytest

import nbodykit_tpu_torch
from nbodykit_tpu.algorithms.fftpower import FFTPower as JaxFFTPower
from nbodykit_tpu.algorithms.fftpower import \
    project_to_basis as jax_project
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from nbodykit_tpu.source.catalog.uniform import \
    UniformCatalog as JaxUniform
from nbodykit_tpu.utils import as_numpy
from nbodykit_tpu_torch.algorithms.fftpower import FFTPower, \
    project_to_basis
from nbodykit_tpu_torch.convert import catalog_from_numpy, field_from_numpy
from nbodykit_tpu_torch.source.catalog import UniformCatalog
from _torch_threads import one_torch_thread  # noqa: F401

BOX = 200.0


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def _columns(n=4000, seed=21):
    rng = np.random.RandomState(seed)
    return {'Position': rng.uniform(0, BOX, (n, 3)),
            'Weight': rng.uniform(0.5, 1.5, n)}


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.nanmax(np.abs(ref))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _compare(tr, jr, rtol, cols):
    for stat in ('power', 'poles'):
        t, j = getattr(tr, stat), getattr(jr, stat)
        if j is None:
            assert t is None
            continue
        np.testing.assert_array_equal(t['modes'], j['modes'])
        for col in cols[stat]:
            _close(t[col], j[col], rtol)
    assert tr.attrs['shotnoise'] == pytest.approx(jr.attrs['shotnoise'],
                                                  rel=1e-14)


CASES = [
    # (dtype, interlaced, mode, dk, port paint method, rtol)
    ('f8', False, '2d', None, 'mxu', 1e-10),
    ('f8', False, '2d', None, 'scatter', 1e-10),
    ('f8', True, '2d', None, 'mxu', 1e-10),
    ('f8', False, '1d', 0, 'mxu', 1e-10),
    ('f4', False, '2d', None, 'mxu', 1e-4),
    ('f4', False, '1d', None, 'scatter', 1e-4),
]


@pytest.mark.parametrize('dtype,interlaced,mode,dk,method,rtol', CASES)
def test_fftpower_matches_jax(dtype, interlaced, mode, dk, method, rtol):
    cols = _columns()
    mesh_kw = dict(Nmesh=32, resampler='cic', compensated=True,
                   interlaced=interlaced, dtype=dtype)
    run_kw = dict(mode=mode, Nmu=5, poles=[0, 2, 4], dk=dk)
    jcat = JaxArray({k: jnp.asarray(v) for k, v in cols.items()},
                    BoxSize=BOX)
    jr = JaxFFTPower(jcat.to_mesh(**mesh_kw), **run_kw)
    tcat = catalog_from_numpy(cols, BOX)
    with nbodykit_tpu_torch.set_options(paint_method=method,
                                        paint_order='radix'):
        tr = FFTPower(tcat.to_mesh(**mesh_kw), **run_kw)
    power_cols = ['k', 'power'] + (['mu'] if mode == '2d' else [])
    _compare(tr, jr, rtol, {'power': power_cols,
                            'poles': ['k', 'power_0', 'power_2',
                                      'power_4']})
    assert tr.attrs['N1'] == jr.attrs['N1'] == 4000


def test_project_to_basis_on_a_carried_field():
    """A JAX complex field carried across with ``field_from_numpy``
    bins to the same (k, mu) statistics in the port."""
    from nbodykit_tpu.base.mesh import Field as JaxField
    from nbodykit_tpu.pmesh import ParticleMesh as JaxPM
    from nbodykit_tpu_torch.pmesh import ParticleMesh
    jpm = JaxPM((16, 12, 10), (100.0, 80.0, 60.0), dtype='f8')
    x = np.random.RandomState(2).normal(size=(16, 12, 10))
    c = jpm.r2c(jnp.asarray(x))
    jfield = JaxField(c * jnp.conj(c), jpm, 'complex')
    tpm = ParticleMesh((16, 12, 10), (100.0, 80.0, 60.0), dtype='f8')
    tfield = field_from_numpy(as_numpy(jfield.value), tpm, 'complex')
    kedges = np.arange(0, 0.5, 2 * np.pi / 100.0)
    edges = [kedges, np.linspace(-1, 1, 5)]
    (jk, jmu, jp, jn), (jk1, jpl, jn1) = jax_project(jfield, edges,
                                                     poles=[0, 1, 2])
    (tk, tmu, tp, tn), (tk1, tpl, tn1) = project_to_basis(tfield, edges,
                                                          poles=[0, 1, 2])
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tn1, jn1)
    for a, b in ((tk, jk), (tmu, jmu), (tp, jp), (tk1, jk1), (tpl, jpl)):
        _close(a, b, 1e-12)


def test_uniform_catalog_count_matches_jax():
    """N, and the threefry Position and Velocity bit for bit, at f8 and
    f4 (the columns come from the port's threefry, which draws JAX's
    values)."""
    for seed in (1, 42):
        for dtype in ('f8', 'f4'):
            t = UniformCatalog(nbar=3e-4, BoxSize=BOX, seed=seed,
                               dtype=dtype)
            j = JaxUniform(nbar=3e-4, BoxSize=BOX, seed=seed, dtype=dtype)
            assert t.size == j.size > 0
            pos = t['Position']
            assert tuple(pos.shape) == (t.size, 3)
            assert float(pos.min()) >= 0 and float(pos.max()) < BOX
            for col in ('Position', 'Velocity'):
                got, ref = t[col].numpy(), as_numpy(j[col])
                assert got.dtype == ref.dtype == np.dtype(dtype)
                np.testing.assert_array_equal(got, ref)
    again = UniformCatalog(nbar=3e-4, BoxSize=BOX, seed=42, dtype='f4')
    assert np.array_equal(again['Position'].numpy(), pos.numpy())


def test_fftpower_json_roundtrip(tmp_path):
    tcat = catalog_from_numpy(_columns(1000), BOX)
    r = FFTPower(tcat.to_mesh(Nmesh=16, compensated=True), mode='1d',
                 poles=[0, 2])
    path = str(tmp_path / 'p.json')
    r.save(path)
    back = FFTPower.load(path)
    np.testing.assert_array_equal(back.power['modes'], r.power['modes'])
    np.testing.assert_array_equal(back.poles['power_2'],
                                  r.poles['power_2'])


def test_lattice_shell_helpers_match_jax():
    import torch
    from nbodykit_tpu.ops import histogram as jhist
    from nbodykit_tpu_torch.ops import histogram as thist
    isq = np.arange(0, 3 * 17 ** 2 + 5).astype('i4')
    got = thist.lattice_shell_index(torch.as_tensor(isq), 20).numpy()
    ref = np.asarray(jhist.lattice_shell_index(jnp.asarray(isq), 20))
    np.testing.assert_array_equal(got, ref)
    edges = np.arange(0, 0.6, 2 * np.pi / 97.0)
    np.testing.assert_array_equal(
        thist.lattice_shell_edges(edges, 2 * np.pi / 100.0),
        jhist.lattice_shell_edges(edges, 2 * np.pi / 100.0))
