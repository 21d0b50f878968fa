"""SurveyDataPairCount: pair counts of sky catalogs (counterpart of
``nbodykit_tpu/algorithms/pair_counters/mocksurvey.py``), on the
catalog's device.

Positions come as (ra, dec[, redshift]), made Cartesian with a
cosmology (unit vectors for 'angular'); the count is non-periodic in the
data's bounding box, with mu against the pair midpoint seen from the
observer (the Corrfunc-mocks convention). Across ranks the bounding
box and the weight totals are those of every rank's rows, and the count
is domain-decomposed when r_max fits a slab of the box (of 4 for
'angular'), else gathered, the JAX package's dispatch
(:func:`.simbox.count_pairs`).
"""

import logging

import numpy as np
import torch

from ... import transform
from ...parallel.runtime import mesh_size
from .base import PairCountBase, package_result
from .core import rmax_of
from .simbox import count_pairs, rank_totals


class SurveyDataPairCount(PairCountBase):
    """Weighted pairs of survey (sky) data.

    mode : '1d', '2d', 'projected' or 'angular'; first, second :
    catalogs with ra, dec (and redshift) columns; edges; cosmo : for the
    comoving distances; Nmu, pimax; weight : the weight column.
    :attr:`branch` is 'one_rank', 'slab' or 'gathered'.
    """

    logger = logging.getLogger('SurveyDataPairCount')

    def __init__(self, mode, first, edges, cosmo=None, second=None,
                 Nmu=None, pimax=None, ra='RA', dec='DEC',
                 redshift='Redshift', weight='Weight',
                 show_progress=False):
        if mode not in ('1d', '2d', 'projected', 'angular'):
            raise ValueError("invalid mode %r" % mode)
        if mode == '2d' and Nmu is None:
            raise ValueError("mode='2d' requires Nmu")
        if mode == 'projected' and pimax is None:
            raise ValueError("mode='projected' requires pimax")
        self.comm = first.comm
        self.attrs = dict(mode=mode, edges=np.asarray(edges), Nmu=Nmu,
                          pimax=pimax, weight=weight)
        nproc = mesh_size(self.comm)

        def get_pos(cat):
            if mode == 'angular':
                pos = transform.SkyToUnitSphere(cat[ra], cat[dec])
            else:
                if cosmo is None:
                    raise ValueError("need a cosmology to convert "
                                     "redshifts to distances")
                pos = transform.SkyToCartesian(cat[ra], cat[dec],
                                               cat[redshift], cosmo)
            return pos.to(torch.float64)

        pos1 = get_pos(first)
        w1 = first[weight] if weight in first else None
        if second is None or second is first:
            pos2, w2 = pos1, w1
            is_auto = True
        else:
            pos2 = get_pos(second)
            w2 = second[weight] if weight in second else None
            is_auto = False

        if mode == 'angular':
            box = np.ones(3)  # unused by the angular path
            kw = dict(mode=mode, periodic=False, is_auto=is_auto)
            workx = 4.0
        else:
            lo, hi = self._bounds(pos1, pos2)
            box = (hi - lo) * 1.001 + 1e-3
            kw = dict(mode=mode, Nmu=Nmu, pimax=pimax, periodic=False,
                      is_auto=is_auto, grid_origin=lo, pair_los='midpoint')
            workx = box[0]
        use_dist = nproc > 1 and rmax_of(mode, edges, pimax) <= workx / nproc
        self.branch = 'slab' if use_dist else (
            'gathered' if nproc > 1 else 'one_rank')
        self.logger.info("pair count branch %s", self.branch)
        counts = count_pairs(self.comm, use_dist, pos1, w1, pos2, w2, box,
                             edges, **kw)

        if is_auto and w1 is None:
            w1 = torch.ones(len(pos1), dtype=torch.float64,
                            device=pos1.device)
        W1, W2, total, N1, N2 = rank_totals(w1, w2, len(pos1), len(pos2),
                                            is_auto, self.comm)
        self.attrs.update(total_wnpairs=total, W1=W1, W2=W2, N1=N1,
                          N2=N2, is_auto=is_auto)
        self.pairs = package_result(counts, **self.attrs)

    def _bounds(self, pos1, pos2):
        """(lo, hi): the least and largest coordinates of both catalogs
        over every rank's rows (host f8)."""
        def ends(p, reduce, empty):
            if p.shape[0] == 0:
                return torch.full((3,), empty, dtype=p.dtype,
                                  device=p.device)
            return reduce(p, dim=0).values
        lo = torch.minimum(ends(pos1, torch.min, np.inf),
                           ends(pos2, torch.min, np.inf))
        hi = torch.maximum(ends(pos1, torch.max, -np.inf),
                           ends(pos2, torch.max, -np.inf))
        if mesh_size(self.comm) > 1:
            lo = self.comm.all_reduce(lo, 'min')
            hi = self.comm.all_reduce(hi, 'max')
        return lo.cpu().numpy(), hi.cpu().numpy()
