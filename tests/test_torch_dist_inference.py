"""The FFT bispectrum and the forward model's inference metrics across
ranks: ``Bispectrum(method='fft')`` of a catalog's f8 CIC mesh at Nmesh
16, nbins 2 and 4 (B within 1e-10 relative, ntri bit for bit: JAX's at
P = 1, the port's one rank at P = 2 and 4, the same on every rank);
``binned_power``, ``cross_correlation``, ``mean_cross_correlation``, the
FFTRecon baseline and the linear start of the forward model. One world
of 4 gloo CPU ranks (``tests/_torch_ranks.py`` ``inference_program``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as R
import nbodykit_tpu.forward as J
from nbodykit_tpu.algorithms.bispectrum import Bispectrum as JBispectrum
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from nbodykit_tpu.utils import as_numpy
from _torch_threads import one_torch_thread  # noqa: F401

Ps = R.RANK_COUNTS
parts, close = R.parts, R.close


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('inference') / 'modes.npy')
    np.save(path, jax_truth_modes())
    return R.run_world('inference_program', args=(path,))


@functools.lru_cache(maxsize=None)
def jax_model(steps, order, nmesh=R.FW_NMESH):
    return R.forward_model(J.ForwardModel, steps, order, nmesh=nmesh)


@functools.lru_cache(maxsize=None)
def jax_truth_modes():
    return as_numpy(jax_model(1, 1).linear_modes(R.MODES_SEED))


def same_nan(a, b):
    return np.array_equal(np.nan_to_num(a, nan=-1.0),
                          np.nan_to_num(b, nan=-1.0))


@functools.lru_cache(maxsize=None)
def jax_bispectrum(nbins):
    cat = JaxArray(R.bispectrum_catalog_columns(), BoxSize=R.BOX)
    b = JBispectrum(cat.to_mesh(Nmesh=R.BS_NMESH, dtype='f8'), nbins=nbins,
                    method='fft')
    return np.asarray(b.B['B']), np.asarray(b.B['ntri'])


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('nbins', R.BS_NBINS)
def test_bispectrum_across_ranks(world, nbins, P):
    """B within 1e-10 relative and ntri bit for bit: JAX's at one rank,
    the port's one rank at P = 2 and 4; the same result on every
    rank."""
    if P == 1:
        wantB, want_ntri = jax_bispectrum(nbins)
    else:
        one = world[0]['bispectrum', nbins, 1]
        wantB, want_ntri = one['B'], one['ntri']
    got = parts(world, ('bispectrum', nbins), P)
    closed = ~np.isnan(wantB)
    assert closed.any()
    for g in got:
        assert same_nan(g['ntri'], want_ntri)
        assert np.array_equal(np.isnan(g['B']), ~closed)
        np.testing.assert_allclose(g['B'][closed], wantB[closed],
                                   rtol=1e-10, atol=0)
        assert same_nan(g['B'], got[0]['B'])
        assert g['attrs']['method'] == 'fft'
        assert g['attrs']['nbins'] == nbins


@functools.lru_cache(maxsize=None)
def jax_metrics():
    m = jax_model(1, 2)
    modes = jnp.asarray(jax_truth_modes())
    b = m.modes_from_white(jnp.asarray(R.forward_inputs()['white']))
    return dict(
        binned_power=[np.asarray(v) for v in J.binned_power(m.lattice,
                                                            modes)],
        cross_correlation=[np.asarray(v) for v in J.cross_correlation(
            m.lattice, modes, b)],
        mean_cross_correlation=[float(J.mean_cross_correlation(
            m.lattice, modes, b, kmax)) for kmax in (None, 0.2)])


@pytest.mark.parametrize('P', Ps)
def test_inference_metrics_across_ranks(world, P):
    """binned_power, cross_correlation and mean_cross_correlation sum
    over every rank's slab: JAX's at one rank, the one rank's at P = 2
    and 4 (1e-10; mode counts identical); the linear start likewise;
    the FFTRecon baseline within 1e-5 of its largest mode (its mesh is
    f4) across ranks."""
    one = world[0]['inference', 1]
    want = jax_metrics() if P == 1 else one
    got = parts(world, ('inference',), P)
    for g in got:
        for name in ('binned_power', 'cross_correlation'):
            (k, v, n), (wk, wv, wn) = g[name], want[name]
            np.testing.assert_allclose(k, wk, rtol=1e-14)
            close(v, wv, 1e-10)
            np.testing.assert_array_equal(n, wn)
        np.testing.assert_allclose(g['mean_cross_correlation'],
                                   want['mean_cross_correlation'],
                                   rtol=1e-10)
    if P == 1:
        m8 = jax_model(1, 2, nmesh=R.FW_NG)
        li = np.asarray(J.linear_init(m8, jnp.asarray(
            R.forward_inputs()['obs8'])))
    else:
        li = one['linear_init']
        close(np.concatenate([g['baseline'] for g in got]), one['baseline'],
              1e-5)
    close(np.concatenate([g['linear_init'] for g in got]), li, 1e-10)
