"""SurveyDataPairCount: pair counts of sky catalogs (counterpart of
``nbodykit_tpu/algorithms/pair_counters/mocksurvey.py``), on the
catalog's device; the JAX package's domain-decomposed branch waits for
the multi-GPU port.

Positions come as (ra, dec[, redshift]), made Cartesian with a
cosmology (unit vectors for 'angular'); the count is non-periodic in the
data's bounding box, with mu against the pair midpoint seen from the
observer (the Corrfunc-mocks convention).
"""

import numpy as np
import torch

from ... import transform
from ...utils import as_numpy
from .base import PairCountBase, package_result
from .core import paircount
from .simbox import total_pairs
from ...parallel.runtime import require_one_rank


class SurveyDataPairCount(PairCountBase):
    """Weighted pairs of survey (sky) data.

    mode : '1d', '2d', 'projected' or 'angular'; first, second :
    catalogs with ra, dec (and redshift) columns; edges; cosmo : for the
    comoving distances; Nmu, pimax; weight : the weight column.
    """

    def __init__(self, mode, first, edges, cosmo=None, second=None,
                 Nmu=None, pimax=None, ra='RA', dec='DEC',
                 redshift='Redshift', weight='Weight',
                 show_progress=False):
        require_one_rank(first, 'SurveyDataPairCount')
        if mode not in ('1d', '2d', 'projected', 'angular'):
            raise ValueError("invalid mode %r" % mode)
        if mode == '2d' and Nmu is None:
            raise ValueError("mode='2d' requires Nmu")
        if mode == 'projected' and pimax is None:
            raise ValueError("mode='projected' requires pimax")
        self.attrs = dict(mode=mode, edges=np.asarray(edges), Nmu=Nmu,
                          pimax=pimax, weight=weight)

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
        else:
            lo = torch.minimum(pos1.min(dim=0).values,
                               pos2.min(dim=0).values).cpu().numpy()
            hi = torch.maximum(pos1.max(dim=0).values,
                               pos2.max(dim=0).values).cpu().numpy()
            box = (hi - lo) * 1.001 + 1e-3
            kw = dict(mode=mode, Nmu=Nmu, pimax=pimax, periodic=False,
                      is_auto=is_auto, grid_origin=lo, pair_los='midpoint')
        counts = paircount(pos1, w1, pos2, w2, box, edges, **kw)

        w1n = as_numpy(w1) if w1 is not None else None
        w2n = w1n if is_auto else (as_numpy(w2) if w2 is not None
                                   else None)
        if is_auto and w1n is None:
            w1n = np.ones(len(pos1))
        W1, W2, total = total_pairs(w1n, w2n, len(pos1), len(pos2), is_auto)
        self.attrs.update(total_wnpairs=total, W1=W1, W2=W2, N1=len(pos1),
                          N2=len(pos2), is_auto=is_auto)
        self.pairs = package_result(counts, **self.attrs)
