"""The FFT algorithms across ranks: FFTPower, FFTCorr and
ProjectedFFTPower on a UniformCatalog whose ``comm`` is ``cpu_mesh(P)``,
the port against the JAX package at the same P (the mesh algorithms and
sources of ``_torch_ranks.SV_CASES`` are in test_torch_dist_survey.py).

One world of 4 gloo CPU ranks (``tests/_torch_ranks.py``
``fftpower_cases``) answers every case on ``cpu_mesh(1)``,
``cpu_mesh(2)`` and ``cpu_mesh(4)``. Every rank holds the same result.
``modes`` must be identical; the f8 columns agree to 1e-10 relative to
each column's largest value; the compressed wire formats of the slab
FFT ('bf16', 'int16') within the JAX package's own P(k) budgets
(tests/test_precision.py: the largest error over the bins below
k_Nyquist/2, relative to the mean |P|).
"""

import functools

import numpy as np
import pytest

import _torch_ranks as R
import nbodykit_tpu
from nbodykit_tpu.algorithms.fftcorr import FFTCorr as JaxFFTCorr
from nbodykit_tpu.algorithms.fftpower import FFTPower as JaxFFTPower
from nbodykit_tpu.algorithms.fftpower import \
    ProjectedFFTPower as JaxProjected
from nbodykit_tpu.parallel.runtime import cpu_mesh
from nbodykit_tpu.source.catalog.uniform import UniformCatalog as JaxUniform
from _torch_threads import one_torch_thread  # noqa: F401

Ps = R.RANK_COUNTS
JAX_LAB = dict(set_options=nbodykit_tpu.set_options, FFTPower=JaxFFTPower,
               FFTCorr=JaxFFTCorr, ProjectedFFTPower=JaxProjected)
BUDGETS = {'power_bf16': 1e-2, 'power_int16': 5e-4}
# the main path's case is held against JAX at every rank count; the
# others against JAX's one-device result, and every case against the
# port's one-rank result (a JAX multi-device FFTPower compiles for 20-50
# s on this CPU)
AT_P = ('power_2d',)


@pytest.fixture(scope='module')
def world():
    return R.run_world('fftpower_cases')


@functools.lru_cache(maxsize=None)
def jax_case(case, P):
    cat = JaxUniform(nbar=R.CAT_NBAR, BoxSize=R.CAT_BOX, seed=42,
                     comm=cpu_mesh(P))
    return R.fft_case(JAX_LAB, cat, case)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.nanmax(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _compare(got, want, rtol=1e-10):
    assert set(got) == set(want)
    for key, w in want.items():
        if key == 'shotnoise':
            assert got[key] == pytest.approx(w, rel=1e-14)
        elif key[1] == 'modes':
            np.testing.assert_array_equal(got[key], w)
        else:
            _close(got[key], w, rtol)


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('case', [c for c in R.FFT_CASES
                                  if c not in BUDGETS])
def test_fft_algorithms_match_jax(world, case, P):
    want = jax_case(case, P if case in AT_P else 1)
    for r in range(P):
        _compare(world[r][case, P], want)
    # and the same as the port's one rank
    _compare(world[0][case, P], world[0][case, 1])


def _pk_error(got, want):
    """The JAX precision test's measure: the largest |P - P_ref| over
    the bins with modes below k_Nyquist / 2, over the mean |P_ref|."""
    k, p, m = want['power', 'k'], want['power', 'power'].real, \
        want['power', 'modes']
    knyq = np.pi * R.FFT_NMESH / R.CAT_BOX
    sel = (m > 0) & np.isfinite(p) & (k <= 0.5 * knyq)
    assert sel.sum() >= 5
    return float((np.abs(got['power', 'power'].real[sel] - p[sel])
                  / np.abs(p[sel]).mean()).max())


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('case', sorted(BUDGETS))
def test_compressed_wire_within_jax_budget(world, case, P):
    """The port's compressed transform against JAX's same wire format,
    and against the port's plain wire, within JAX's budget; modes
    identical."""
    want = jax_case(case, P if case in AT_P else 1)
    for r in range(P):
        got = world[r][case, P]
        np.testing.assert_array_equal(got['power', 'modes'],
                                      want['power', 'modes'])
        assert _pk_error(got, want) < BUDGETS[case]
        assert _pk_error(got, world[r]['power_1d', P]) < BUDGETS[case]
