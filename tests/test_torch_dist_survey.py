"""The mesh algorithms and mesh sources across ranks on the slab path:
ConvolvedFFTPower, FFTRecon, RedshiftHistogram, ArrayMesh, LinearMesh
and the species mesh (``_torch_ranks.SV_CASES``), held to JAX at P = 1
and to the port's one rank at P = 2 and 4.

One world of 4 gloo CPU ranks (``tests/_torch_ranks.py``
``survey_cases``) answers every case on ``cpu_mesh(1)``, ``cpu_mesh(2)``
and ``cpu_mesh(4)``; ``survey_case(lab, case, comm)`` takes either
package's names, so the JAX side runs the same function on one device.
Every rank holds the same result.
"""

import functools

import numpy as np
import pytest

import _torch_ranks as R
from nbodykit_tpu import cosmology as jcosmo
from nbodykit_tpu.algorithms.convpower import \
    ConvolvedFFTPower as JaxConvolved
from nbodykit_tpu.algorithms.convpower import FKPCatalog as JaxFKP
from nbodykit_tpu.algorithms.fftrecon import FFTRecon as JaxFFTRecon
from nbodykit_tpu.algorithms.zhist import \
    RedshiftHistogram as JaxRedshiftHistogram
from nbodykit_tpu.base.mesh import FieldMesh as JaxFieldMesh
from nbodykit_tpu.algorithms.fftpower import FFTPower as JaxFFTPower
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from nbodykit_tpu.source.catalog.species import \
    MultipleSpeciesCatalog as JaxSpecies
from nbodykit_tpu.source.mesh.array import ArrayMesh as JaxArrayMesh
from nbodykit_tpu.source.mesh.linear import LinearMesh as JaxLinearMesh
from nbodykit_tpu.utils import as_numpy as jax_as_numpy
from _torch_threads import one_torch_thread  # noqa: F401

Ps = R.RANK_COUNTS


@pytest.fixture(scope='module')
def world():
    return R.run_world('survey_cases')


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.nanmax(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


JAX_SURVEY_LAB = dict(
    ArrayCatalog=JaxArray, ArrayMesh=JaxArrayMesh,
    ConvolvedFFTPower=JaxConvolved, FFTPower=JaxFFTPower,
    FFTRecon=JaxFFTRecon, FieldMesh=JaxFieldMesh, FKPCatalog=JaxFKP,
    LinearMesh=JaxLinearMesh,
    MultipleSpeciesCatalog=JaxSpecies, Planck15=jcosmo.Planck15,
    RedshiftHistogram=JaxRedshiftHistogram, as_numpy=jax_as_numpy)
# values each rank holds its own part of: x-slabs of a field, stacked in
# rank order; the species' row count and a mesh's x rows on this rank
SLABS = ('field',)
LOCAL = ('size', 'rows', 'seconds')
# the reconstructed field and its P(k) are f4: against JAX, the bar of
# tests/test_torch_fftrecon.py (1e-4 of the field's largest value, P(k)
# 1e-4); against the port's one rank, 1e-5 of the field's largest
RECON_JAX_RTOL = 1e-4
RECON_RANKS_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def jax_survey(case):
    """The JAX package's result of a survey case on one device."""
    return R.survey_case(JAX_SURVEY_LAB, case)


def _whole(world, case, P):
    """The case's result at P ranks: the slabs stacked in rank order,
    every other value rank 0's after checking each rank holds the same
    one."""
    out = {}
    for key, val in world[0][case, P].items():
        if key in LOCAL:
            continue
        if key in SLABS:
            out[key] = np.concatenate([world[r][case, P][key]
                                       for r in range(P)])
            continue
        for r in range(1, P):
            np.testing.assert_array_equal(world[r][case, P][key], val,
                                          err_msg=key)
        out[key] = val
    return out


def _compare_survey(case, got, want, rtol, field_rtol):
    assert set(got) == set(want) - set(LOCAL)
    for key, w in want.items():
        if key in LOCAL:
            continue
        g, w = np.asarray(got[key]), np.asarray(w)
        if key == 'modes' or w.dtype.kind in 'iub':
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif w.ndim == 0:
            assert float(g) == pytest.approx(float(w), rel=rtol), key
        elif key == 'field':
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=field_rtol
                                       * np.abs(w).max(), err_msg=key)
        elif key == 'power' and case.startswith('recon_'):
            # P(k) of an f4 field: rtol with the bar as atol, as in the
            # single-device recon test
            ok = np.isfinite(w)
            assert np.isfinite(g[ok]).all()
            np.testing.assert_allclose(
                g[ok], w[ok], rtol=field_rtol,
                atol=field_rtol * np.abs(w[ok]).max(), err_msg=key)
        else:
            _close(g, w, rtol)


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('case', R.SV_CASES)
def test_survey_algorithms_across_ranks(world, case, P):
    """At P = 1 the port on a 1-rank mesh equals the JAX package on one
    device; at P = 2 and 4 it equals the port's one rank: f8 columns and
    scalars within 1e-10 of each column's largest value, modes and
    integer columns identical, the f4 reconstructed field as stated
    above. Every rank holds the same result; the cp_sparse randoms (5
    rows) leave rank 3 of 4 with none, and the world still finishes."""
    got = _whole(world, case, P)
    recon = case.startswith('recon_')
    if P == 1:
        _compare_survey(case, got, jax_survey(case), 1e-10,
                        RECON_JAX_RTOL if recon else 1e-10)
    else:
        _compare_survey(case, got, _whole(world, case, 1), 1e-10,
                        RECON_RANKS_RTOL if recon else 1e-10)
    if case == 'species':
        sizes = [world[r][case, P]['size'] for r in range(P)]
        assert sum(sizes) == got['csize'] == 2001 + 1503
    if case in ('arraymesh', 'linearmesh'):
        # each rank's field is its x-slab
        assert [world[r][case, P]['rows'] for r in range(P)] == \
            [R.SV_NMESH // P] * P


def test_sparse_randoms_leave_a_rank_empty():
    """The case's premise: rank 3 of 4 holds none of the 5 randoms."""
    from nbodykit_tpu_torch.parallel.runtime import row_range
    n = len(R.SPARSE_RANDOMS)
    assert row_range(n, 4, 3) == (5, 5)
    assert [b - a for a, b in (row_range(n, 4, r) for r in range(4))] == \
        [2, 2, 1, 0]
