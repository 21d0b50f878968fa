"""Two-point correlation functions from pair counts (counterpart of
``nbodykit_tpu/algorithms/paircount_tpcf/tpcf.py``): SimulationBox2PCF
with analytic or catalog randoms, SurveyData2PCF with Landy-Szalay, and
wp(rp). The counts run on the catalogs' device
(:mod:`..pair_counters`); the estimators are host numpy."""

import json
import logging

import numpy as np

from ...binned_statistic import BinnedStatistic
from ...utils import JSONEncoder
from ..pair_counters.mocksurvey import SurveyDataPairCount
from ..pair_counters.simbox import SimulationBoxPairCount
from .estimators import (WedgeBinnedStatistic, landy_szalay,
                         natural_estimator)


class BasePairCount2PCF(object):
    """Shared packaging: :attr:`corr` (and :attr:`wp` for 'projected')."""

    def _package(self, xi, mode, edges, Nmu=None, pimax=None):
        data = {'corr': np.atleast_1d(xi)}
        if mode == '1d':
            dims, bes = ['r'], [edges]
            data['r'] = 0.5 * (edges[1:] + edges[:-1])
        elif mode == '2d':
            dims = ['r', 'mu']
            mue = np.linspace(0, 1, Nmu + 1)
            bes = [edges, mue]
            data['r'] = np.broadcast_to(
                0.5 * (edges[1:] + edges[:-1])[:, None], xi.shape).copy()
            data['mu'] = np.broadcast_to(
                0.5 * (mue[1:] + mue[:-1])[None, :], xi.shape).copy()
        elif mode == 'projected':
            dims = ['rp', 'pi']
            pie = np.arange(0, int(pimax) + 1)
            bes = [edges, pie]
            data['rp'] = np.broadcast_to(
                0.5 * (edges[1:] + edges[:-1])[:, None], xi.shape).copy()
        elif mode == 'angular':
            dims, bes = ['theta'], [edges]
            data['theta'] = 0.5 * (edges[1:] + edges[:-1])
        cls = WedgeBinnedStatistic if mode == '2d' else BinnedStatistic
        self.corr = cls(dims, bes, data)
        self.corr.attrs.update(self.attrs)

        if mode == 'projected':
            self.wp = self._compute_wp(xi, pie)

    def _compute_wp(self, xi, piedges):
        """wp(rp) = 2 * sum_pi xi(rp, pi) dpi."""
        dpi = np.diff(piedges)
        wp = 2.0 * np.nansum(xi * dpi[None, :], axis=-1)
        edges = self.attrs['edges']
        out = BinnedStatistic(
            ['rp'], [edges],
            {'corr': wp, 'rp': 0.5 * (edges[1:] + edges[:-1])})
        out.attrs.update(self.attrs)
        return out

    def save(self, output):
        with open(output, 'w') as ff:
            json.dump(dict(corr=self.corr.__getstate__(),
                           attrs=self.attrs), ff, cls=JSONEncoder)


class SimulationBox2PCF(BasePairCount2PCF):
    """xi(r), xi(r, mu), xi(rp, pi) with wp, or w(theta) in a box.

    With ``randoms1=None`` and periodic data, RR is analytic (the
    natural estimator); otherwise Landy-Szalay with the given randoms.
    """

    logger = logging.getLogger('SimulationBox2PCF')

    def __init__(self, mode, data1, edges, Nmu=None, pimax=None,
                 data2=None, randoms1=None, randoms2=None,
                 periodic=True, BoxSize=None, los='z', weight='Weight',
                 show_progress=False):
        if BoxSize is None:
            BoxSize = data1.attrs['BoxSize']
        BoxSize = np.ones(3) * np.asarray(BoxSize, dtype='f8')
        self.attrs = dict(mode=mode, edges=np.asarray(edges, 'f8'),
                          Nmu=Nmu, pimax=pimax, periodic=periodic,
                          BoxSize=BoxSize, los=los)

        kw = dict(BoxSize=BoxSize, periodic=periodic, weight=weight,
                  los=los, Nmu=Nmu, pimax=pimax)
        self.D1D2 = SimulationBoxPairCount(mode, data1, edges,
                                           second=data2, **kw)

        if randoms1 is None:
            if not periodic and mode != 'angular':
                raise ValueError("need randoms for non-periodic data")
            xi = natural_estimator(self.D1D2.pairs, mode, BoxSize,
                                   Nmu=Nmu, pimax=pimax)
            self.R1R2 = None
        else:
            R1 = randoms1
            R2 = randoms2 if randoms2 is not None else randoms1
            self.D1R2 = SimulationBoxPairCount(mode, data1, edges,
                                               second=R2, **kw)
            self.D2R1 = self.D1R2 if data2 is None else \
                SimulationBoxPairCount(mode, data2, edges, second=R1, **kw)
            self.R1R2 = SimulationBoxPairCount(
                mode, R1, edges,
                second=None if randoms2 is None else R2, **kw)
            xi = landy_szalay(self.D1D2.pairs, self.D1R2.pairs,
                              self.R1R2.pairs, RD=self.D2R1.pairs)

        self._package(xi, mode, np.asarray(edges, 'f8'), Nmu=Nmu,
                      pimax=pimax)


class SurveyData2PCF(BasePairCount2PCF):
    """The Landy-Szalay correlation of survey data and randoms."""

    logger = logging.getLogger('SurveyData2PCF')

    def __init__(self, mode, data, randoms, edges, cosmo=None,
                 Nmu=None, pimax=None, ra='RA', dec='DEC',
                 redshift='Redshift', weight='Weight',
                 show_progress=False):
        self.attrs = dict(mode=mode, edges=np.asarray(edges, 'f8'),
                          Nmu=Nmu, pimax=pimax)
        kw = dict(cosmo=cosmo, Nmu=Nmu, pimax=pimax, ra=ra, dec=dec,
                  redshift=redshift, weight=weight)
        self.D1D2 = SurveyDataPairCount(mode, data, edges, **kw)
        self.D1R2 = SurveyDataPairCount(mode, data, edges,
                                        second=randoms, **kw)
        self.R1R2 = SurveyDataPairCount(mode, randoms, edges, **kw)
        xi = landy_szalay(self.D1D2.pairs, self.D1R2.pairs,
                          self.R1R2.pairs)
        self._package(xi, mode, np.asarray(edges, 'f8'), Nmu=Nmu,
                      pimax=pimax)
