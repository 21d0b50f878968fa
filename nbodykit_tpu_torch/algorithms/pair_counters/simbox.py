"""SimulationBoxPairCount: pair counts in a box (counterpart of
``nbodykit_tpu/algorithms/pair_counters/simbox.py``), on the catalog's
device; the JAX package's domain-decomposed branch waits for the
multi-GPU port."""

import numpy as np

from ...utils import as_numpy
from .base import PairCountBase, package_result
from .core import paircount
from ...parallel.runtime import require_one_rank


def total_pairs(w1, w2, n1, n2, is_auto):
    """(W1, W2, total weighted pairs): the weight sums (numpy, in the
    columns' dtype) and W1 * W1 - sum w1^2 for an auto count, else
    W1 * W2; a missing weight column counts 1 a particle."""
    W1 = float(np.sum(w1)) if w1 is not None else float(n1)
    W2 = float(np.sum(w2)) if w2 is not None else float(n2)
    if is_auto:
        sumw2 = float(np.sum(np.asarray(w1) ** 2)) if w1 is not None \
            else float(n1)
        return W1, W2, W1 * W1 - sumw2
    return W1, W2, W1 * W2


class SimulationBoxPairCount(PairCountBase):
    """Weighted pairs in bins of separation, in a (periodic) box.

    mode : '1d', '2d', 'projected' or 'angular'; first, second :
    catalogs (second None: the auto count); edges; BoxSize (default
    first.attrs['BoxSize']); periodic; weight : the weight column; los :
    'x', 'y' or 'z'; Nmu ('2d'); pimax ('projected').

    Results in :attr:`pairs` (npairs, wnpairs); :attr:`attrs` hold the
    weighted pair totals the estimators normalise by.
    """

    def __init__(self, mode, first, edges, BoxSize=None, periodic=True,
                 weight='Weight', second=None, los='z', Nmu=None,
                 pimax=None, show_progress=False):
        require_one_rank(first, 'SimulationBoxPairCount')
        if mode not in ('1d', '2d', 'projected', 'angular'):
            raise ValueError("invalid mode %r" % mode)
        if mode == '2d' and Nmu is None:
            raise ValueError("mode='2d' requires Nmu")
        if mode == 'projected' and pimax is None:
            raise ValueError("mode='projected' requires pimax")
        los_i = {'x': 0, 'y': 1, 'z': 2}[los]

        if BoxSize is None:
            BoxSize = first.attrs['BoxSize']
        BoxSize = np.ones(3) * np.asarray(BoxSize, dtype='f8')

        self.first = first
        self.second = second
        self.attrs = dict(mode=mode, edges=np.asarray(edges),
                          BoxSize=BoxSize, periodic=periodic, los=los,
                          Nmu=Nmu, pimax=pimax, weight=weight)

        pos1 = first['Position']
        w1 = first[weight] if weight in first else None
        if second is None or second is first:
            pos2, w2 = pos1, w1
            is_auto = True
        else:
            pos2 = second['Position']
            w2 = second[weight] if weight in second else None
            is_auto = False

        counts = paircount(pos1, w1, pos2, w2, BoxSize, edges, mode=mode,
                           Nmu=Nmu, pimax=pimax, los=los_i,
                           periodic=periodic, is_auto=is_auto)

        w1n = as_numpy(w1) if w1 is not None else None
        w2n = w1n if is_auto else (as_numpy(w2) if w2 is not None
                                   else None)
        W1, W2, total = total_pairs(w1n, w2n, len(pos1), len(pos2), is_auto)
        self.attrs.update(total_wnpairs=total, W1=W1, W2=W2, N1=len(pos1),
                          N2=len(pos2), is_auto=is_auto)
        self.pairs = package_result(counts, **self.attrs)
