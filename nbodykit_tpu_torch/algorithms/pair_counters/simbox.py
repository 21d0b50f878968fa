"""SimulationBoxPairCount: pair counts in a box (counterpart of
``nbodykit_tpu/algorithms/pair_counters/simbox.py``), on the catalog's
device.

Across ranks the count is domain-decomposed (:func:`.core.paircount_dist`)
when r_max fits a slab of the work box (x over P; 4 for 'angular'),
else every rank gathers the catalogs and counts them whole, the JAX
package's dispatch; the weight totals are sums over the ranks.
"""

import logging

import numpy as np
import torch

from ...utils import as_numpy
from ...parallel.runtime import mesh_size
from .base import PairCountBase, package_result
from .core import paircount, paircount_dist, rmax_of


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


def rank_totals(w1, w2, n1, n2, is_auto, mesh):
    """(W1, W2, total weighted pairs, N1, N2) of :func:`total_pairs` over
    the ranks of ``mesh``, from this rank's weight columns (tensors or
    None) and row counts: each rank's numpy sums, summed over the ranks;
    on one rank :func:`total_pairs` itself."""
    w1n = as_numpy(w1) if w1 is not None else None
    w2n = w1n if is_auto else (as_numpy(w2) if w2 is not None else None)
    if mesh_size(mesh) == 1:
        return total_pairs(w1n, w2n, n1, n2, is_auto) + (n1, n2)
    local = [float(np.sum(w1n)) if w1n is not None else float(n1),
             float(np.sum(w2n)) if w2n is not None else float(n2),
             float(np.sum(w1n ** 2)) if w1n is not None else float(n1),
             float(n1), float(n2)]
    W1, W2, sumw2, N1, N2 = (float(v) for v in mesh.all_reduce(
        torch.tensor(local, dtype=torch.float64, device=mesh.device)).cpu())
    total = W1 * W1 - sumw2 if is_auto else W1 * W2
    return W1, W2, total, int(N1), int(N2)


def count_pairs(mesh, use_dist, pos1, w1, pos2, w2, box, edges, **kw):
    """The counts of this rank's rows: :func:`.core.paircount_dist` when
    ``use_dist``, else :func:`.core.paircount` of the rows of every rank
    (gathered on each, the JAX package's ``as_numpy``), or of these rows
    on one rank."""
    if use_dist:
        return paircount_dist(pos1, w1, pos2, w2, box, edges, mesh, **kw)
    if mesh_size(mesh) > 1:
        from ...parallel.domain import allgather_rows
        pos1, pos2 = allgather_rows(pos1, mesh), allgather_rows(pos2, mesh)
        w1, w2 = (None if w is None else allgather_rows(w, mesh)
                  for w in (w1, w2))
    return paircount(pos1, w1, pos2, w2, box, edges, **kw)


class SimulationBoxPairCount(PairCountBase):
    """Weighted pairs in bins of separation, in a (periodic) box.

    mode : '1d', '2d', 'projected' or 'angular'; first, second :
    catalogs (second None: the auto count); edges; BoxSize (default
    first.attrs['BoxSize']); periodic; weight : the weight column; los :
    'x', 'y' or 'z'; Nmu ('2d'); pimax ('projected').

    Results in :attr:`pairs` (npairs, wnpairs); :attr:`attrs` hold the
    weighted pair totals the estimators normalise by; :attr:`branch` is
    'one_rank', 'slab' or 'gathered' (across ranks, r_max wider than a
    slab).
    """

    logger = logging.getLogger('SimulationBoxPairCount')

    def __init__(self, mode, first, edges, BoxSize=None, periodic=True,
                 weight='Weight', second=None, los='z', Nmu=None,
                 pimax=None, show_progress=False):
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
        self.comm = first.comm
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

        nproc = mesh_size(self.comm)
        workx = 4.0 if mode == 'angular' else BoxSize[0]
        use_dist = nproc > 1 and rmax_of(mode, edges, pimax) <= workx / nproc
        self.branch = 'slab' if use_dist else (
            'gathered' if nproc > 1 else 'one_rank')
        self.logger.info("pair count branch %s", self.branch)
        counts = count_pairs(self.comm, use_dist, pos1, w1, pos2, w2,
                             BoxSize, edges, mode=mode, Nmu=Nmu, pimax=pimax,
                             los=los_i, periodic=periodic, is_auto=is_auto)

        W1, W2, total, N1, N2 = rank_totals(w1, w2, len(pos1), len(pos2),
                                            is_auto, self.comm)
        self.attrs.update(total_wnpairs=total, W1=W1, W2=W2, N1=N1,
                          N2=N2, is_auto=is_auto)
        self.pairs = package_result(counts, **self.attrs)
