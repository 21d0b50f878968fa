"""Correlation functions from pair counts through the PyTorch port and the
JAX package on the same seeded numpy catalogs: SimulationBox2PCF with
the natural estimator in '1d', '2d' (wedges to multipoles) and
'projected' (wp), Landy-Szalay with randoms in a box and on the sky
(SurveyData2PCF), the analytic random pairs of every mode (all to 1e-10
relative, pair counts exact), and the JSON save of a result."""

import functools
import json

import numpy as np
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu.algorithms.paircount_tpcf import (
    SimulationBox2PCF as JBox2PCF, SurveyData2PCF as JSurvey2PCF)
from nbodykit_tpu.algorithms.paircount_tpcf import estimators as jest
from nbodykit_tpu.cosmology import Planck15 as JPlanck15
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JArray
from nbodykit_tpu_torch.algorithms.paircount_tpcf import estimators as test
from nbodykit_tpu_torch.binned_statistic import BinnedStatistic
from nbodykit_tpu_torch.cosmology import Planck15
from nbodykit_tpu_torch.lab import (ArrayCatalog, SimulationBox2PCF,
                                    SurveyData2PCF, WedgeBinnedStatistic)

BOX = 100.0
EDGES = np.linspace(4.0, 20.0, 5)
RP_EDGES = np.array([1.0, 3.0, 6.0, 10.0])
PIMAX = 10
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _on_cpu():
    # one intra-op thread: the plain folds are many small ops, and the
    # thread pools of parallel test workers slow each by milliseconds
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with nbodykit_tpu_torch.set_options(device='cpu'):
            yield
    finally:
        torch.set_num_threads(threads)


def box_columns(seed, n, clustered=True):
    """Half the points in 30 Gaussian blobs of 3 Mpc/h, half uniform."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    if clustered:
        centres = rng.uniform(0, BOX, (30, 3))
        k = n // 2
        pos[:k] = np.mod(centres[rng.randint(30, size=k)]
                         + rng.normal(scale=3.0, size=(k, 3)), BOX)
    return {'Position': pos, 'Weight': rng.uniform(0.5, 1.5, n)}


def sky_columns(seed, n):
    rng = np.random.RandomState(seed)
    return {'RA': rng.uniform(0, 30, n), 'DEC': rng.uniform(-15, 15, n),
            'Redshift': rng.uniform(0.04, 0.07, n),
            'Weight': rng.uniform(0.5, 1.5, n)}


def both(cols):
    return JArray(cols, BoxSize=BOX), ArrayCatalog(cols, BoxSize=BOX)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype='f8'),
                               np.asarray(want, dtype='f8'), rtol=RTOL,
                               atol=0, equal_nan=True)


NATURAL = [('1d', {}), ('2d', dict(Nmu=5)), ('projected', dict(pimax=PIMAX))]


@functools.lru_cache(maxsize=None)
def natural(mode):
    kw = dict(NATURAL)[mode]
    edges = RP_EDGES if mode == 'projected' else EDGES
    jd, td = both(box_columns(1, 1000))
    return (JBox2PCF(mode, jd, edges, **kw),
            SimulationBox2PCF(mode, td, edges, **kw))


@pytest.mark.parametrize('mode', [m for m, _ in NATURAL])
def test_natural_estimator(mode):
    want, got = natural(mode)
    np.testing.assert_array_equal(got.D1D2.pairs['npairs'],
                                  np.asarray(want.D1D2.pairs['npairs']))
    close(got.corr['corr'], want.corr['corr'])
    assert np.isfinite(got.corr['corr']).any()
    assert got.R1R2 is None


def test_wedges_to_poles():
    want, got = natural('2d')
    assert isinstance(got.corr, WedgeBinnedStatistic)
    pw, pg = want.corr.to_poles([0, 2, 4]), got.corr.to_poles([0, 2, 4])
    for ell in (0, 2, 4):
        close(pg['corr_%d' % ell], pw['corr_%d' % ell])
    close(pg['r'], pw['r'])


def test_projected_wp():
    want, got = natural('projected')
    close(got.wp['corr'], want.wp['corr'])
    close(got.wp['rp'], want.wp['rp'])
    assert got.corr.dims == ['rp', 'pi']


def test_landy_szalay_in_a_box():
    jd, td = both(box_columns(2, 800))
    jr, tr = both(box_columns(3, 1200, clustered=False))
    want = JBox2PCF('1d', jd, EDGES, randoms1=jr)
    got = SimulationBox2PCF('1d', td, EDGES, randoms1=tr)
    for name in ('D1D2', 'D1R2', 'R1R2'):
        np.testing.assert_array_equal(
            getattr(got, name).pairs['npairs'],
            np.asarray(getattr(want, name).pairs['npairs']))
    assert got.D2R1 is got.D1R2
    close(got.corr['corr'], want.corr['corr'])


def test_survey_landy_szalay():
    jd, td = both(sky_columns(4, 700))
    jr, tr = both(sky_columns(5, 1100))
    want = JSurvey2PCF('2d', jd, jr, EDGES, cosmo=JPlanck15, Nmu=4)
    got = SurveyData2PCF('2d', td, tr, EDGES, cosmo=Planck15, Nmu=4)
    for name in ('D1D2', 'D1R2', 'R1R2'):
        assert getattr(got, name).pairs['npairs'].sum() > 0
        np.testing.assert_array_equal(
            getattr(got, name).pairs['npairs'],
            np.asarray(getattr(want, name).pairs['npairs']))
    close(got.corr['corr'], want.corr['corr'])
    close(got.corr.to_poles([0, 2])['corr_2'],
          want.corr.to_poles([0, 2])['corr_2'])


@pytest.mark.parametrize('mode,kw', [
    ('1d', {}), ('2d', dict(Nmu=4)), ('projected', dict(pimax=7)),
    ('angular', {})])
def test_analytic_random_pairs(mode, kw):
    edges = np.array([0.5, 5.0, 30.0, 90.0]) if mode == 'angular' else EDGES
    close(test.analytic_random_pairs(mode, edges, 1000, np.full(3, BOX),
                                     **kw),
          jest.analytic_random_pairs(mode, edges, 1000, np.full(3, BOX),
                                     **kw))


def test_save_writes_the_correlation(tmp_path):
    _, got = natural('projected')
    path = str(tmp_path / 'xi.json')
    got.save(path)
    from nbodykit_tpu_torch.utils import JSONDecoder
    with open(path) as f:
        state = json.load(f, cls=JSONDecoder)
    back = BinnedStatistic.from_state(state['corr'])
    np.testing.assert_array_equal(back['corr'], got.corr['corr'])
    assert state['attrs']['pimax'] == PIMAX
    assert back.dims == ['rp', 'pi']
