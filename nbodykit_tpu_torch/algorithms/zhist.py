"""RedshiftHistogram: the weighted n(z) of a catalog (counterpart of
``nbodykit_tpu/algorithms/zhist.py``).

A histogram of a redshift column with Scott's-rule binning by default,
divided by the comoving volume of each shell in a fiducial cosmology.
The redshift and weight columns are read to the host once; the
histogram is numpy.
"""

import logging

import numpy as np

from ..binned_statistic import BinnedStatistic
from ..utils import as_numpy
from ..parallel.runtime import require_one_rank


def scotts_bin_width(data):
    """Scott's rule bin width: 3.5 sigma / N^(1/3) (0.1 for constant or
    empty data)."""
    data = np.asarray(data)
    sigma = data.std()
    n = len(data)
    if sigma == 0 or n == 0:
        return 0.1
    return 3.5 * sigma / n ** (1.0 / 3)


class RedshiftHistogram(object):
    """n(z) of a catalog.

    source : the catalog; fsky : the sky fraction it covers; cosmo :
    the cosmology of the comoving volumes; bins : an int, edges, or
    None for Scott's rule; redshift, weight : column names.

    Attributes: bin_edges, bin_centers, dV (comoving volume per bin,
    (Mpc/h)^3), nbar (weighted number density per bin), hist (a
    BinnedStatistic of z, nbar, counts, dV).
    """

    logger = logging.getLogger('RedshiftHistogram')

    def __init__(self, source, fsky, cosmo, bins=None, redshift='Redshift',
                 weight=None):
        require_one_rank(source, 'RedshiftHistogram')
        self.source = source
        self.attrs = dict(fsky=fsky, redshift=redshift, weight=weight)

        z = as_numpy(source[redshift])
        w = as_numpy(source[weight]) if weight is not None else \
            np.ones(len(z))

        if bins is None:
            dz = scotts_bin_width(z)
            bins = np.arange(z.min(), z.max() + dz, dz)
        elif np.isscalar(bins):
            bins = np.linspace(z.min(), z.max(), int(bins) + 1)
        bins = np.asarray(bins, dtype='f8')

        counts, _ = np.histogram(z, bins=bins, weights=w)

        # comoving volume of each shell, times fsky
        r = cosmo.comoving_distance(bins)
        dV = fsky * 4.0 / 3 * np.pi * np.diff(r ** 3)

        self.bin_edges = bins
        self.bin_centers = 0.5 * (bins[1:] + bins[:-1])
        self.dV = dV
        self.nbar = counts / dV

        data = {'z': self.bin_centers, 'nbar': self.nbar,
                'counts': counts, 'dV': dV}
        self.hist = BinnedStatistic(['z'], [bins], data,
                                    fields_to_sum=['counts', 'dV'])
        self.hist.attrs.update(self.attrs)

    def interpolate(self, z):
        """n(z) interpolated at redshifts ``z`` (0 outside the bins),
        to build an NZ column."""
        return np.interp(as_numpy(z), self.bin_centers, self.nbar,
                         left=0.0, right=0.0)

    def __getstate__(self):
        return dict(bin_edges=self.bin_edges, nbar=self.nbar,
                    dV=self.dV, attrs=self.attrs)
