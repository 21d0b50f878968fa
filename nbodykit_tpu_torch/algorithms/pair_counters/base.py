"""Shared machinery of the pair-count algorithms (counterpart of
``nbodykit_tpu/algorithms/pair_counters/base.py``): results as a
BinnedStatistic, and JSON persistence."""

import json

import numpy as np

from ...binned_statistic import BinnedStatistic
from ...utils import JSONDecoder, JSONEncoder


def package_result(counts, **attrs):
    """Wrap a :func:`.core.paircount` result dict into a BinnedStatistic
    with the reference's dims and variables (mode, edges, Nmu and pimax
    come from the attrs)."""
    mode = attrs['mode']
    edges = np.asarray(attrs['edges'])
    Nmu = attrs.get('Nmu')
    pimax = attrs.get('pimax')
    npairs = np.atleast_1d(counts['npairs'])
    wnpairs = np.atleast_1d(counts['wnpairs'])

    if mode == '1d':
        dims, bin_edges = ['r'], [edges]
    elif mode == '2d':
        dims = ['r', 'mu']
        bin_edges = [edges, np.linspace(0, 1, Nmu + 1)]
    elif mode == 'projected':
        dims = ['rp', 'pi']
        bin_edges = [edges, np.arange(0, int(pimax) + 1)]
    elif mode == 'angular':
        dims, bin_edges = ['theta'], [edges]
    else:
        raise ValueError(mode)

    shape = tuple(len(e) - 1 for e in bin_edges)
    data = {'npairs': npairs.reshape(shape),
            'wnpairs': wnpairs.reshape(shape)}
    out = BinnedStatistic(dims, bin_edges, data,
                          fields_to_sum=['npairs', 'wnpairs'])
    out.attrs.update(attrs)
    return out


class PairCountBase(object):
    """Base of SimulationBoxPairCount and SurveyDataPairCount: holds
    :attr:`pairs` and :attr:`attrs`, saved to and loaded from JSON."""

    def save(self, output):
        with open(output, 'w') as ff:
            json.dump(self.__getstate__(), ff, cls=JSONEncoder)

    @classmethod
    def load(cls, output, comm=None):
        with open(output, 'r') as ff:
            state = json.load(ff, cls=JSONDecoder)
        self = object.__new__(cls)
        self.__setstate__(state)
        return self

    def __getstate__(self):
        return dict(pairs=self.pairs.__getstate__(), attrs=self.attrs)

    def __setstate__(self, state):
        self.attrs = state['attrs']
        self.pairs = BinnedStatistic.from_state(state['pairs'])
