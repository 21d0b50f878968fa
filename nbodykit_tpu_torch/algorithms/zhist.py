"""RedshiftHistogram: the weighted n(z) of a catalog (counterpart of
``nbodykit_tpu/algorithms/zhist.py``).

A histogram of a redshift column with Scott's-rule binning by default,
divided by the comoving volume of each shell in a fiducial cosmology.
The redshift and weight columns are read to the host once; the
histogram is numpy. With P ranks each rank bins its own rows and the
counts are summed over the ranks; the default bins take z's range and
Scott's rule (n, mean, sigma) over every rank, so every rank holds the
same histogram.
"""

import logging

import numpy as np
import torch

from ..binned_statistic import BinnedStatistic
from ..parallel.runtime import mesh_size
from ..utils import as_numpy


def scotts_bin_width(data, comm=None):
    """Scott's rule bin width: 3.5 sigma / N^(1/3) (0.1 for constant or
    empty data). With a ``comm`` of P ranks, ``data`` is this rank's
    part and sigma and N are those of every rank's data (two
    collectives: the count and sum, then the squared deviations)."""
    data = np.asarray(data)
    if mesh_size(comm) == 1:
        sigma = data.std()
        n = len(data)
    else:
        n, total = _summed(comm, [len(data), data.sum()])
        n = int(n)
        mean = total / n if n else 0.0
        sigma = np.sqrt(_summed(comm, [((data - mean) ** 2).sum()])[0]
                        / n) if n else 0.0
    if sigma == 0 or n == 0:
        return 0.1
    return 3.5 * sigma / n ** (1.0 / 3)


def _summed(comm, values, op='sum'):
    """The f64 ``op`` ('sum', 'min' or 'max') of each of ``values``
    over the ranks, as numpy."""
    t = torch.tensor(np.asarray(values, dtype='f8'), device=comm.device)
    return comm.all_reduce(t, op=op).cpu().numpy()


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
        self.source = source
        self.comm = source.comm
        ranks = mesh_size(self.comm) > 1
        self.attrs = dict(fsky=fsky, redshift=redshift, weight=weight)

        z = as_numpy(source[redshift])
        w = as_numpy(source[weight]) if weight is not None else \
            np.ones(len(z))

        if bins is None or np.isscalar(bins):
            if ranks:
                # a rank with no rows gives the identities of the min
                lo, neg_hi = _summed(
                    self.comm, [z.min(), -z.max()] if len(z) else
                    [np.inf, np.inf], 'min')
                zmin, zmax = z.dtype.type(lo), z.dtype.type(-neg_hi)
            else:
                zmin, zmax = z.min(), z.max()
        if bins is None:
            dz = scotts_bin_width(z, self.comm)
            bins = np.arange(zmin, zmax + dz, dz)
        elif np.isscalar(bins):
            bins = np.linspace(zmin, zmax, int(bins) + 1)
        bins = np.asarray(bins, dtype='f8')

        counts, _ = np.histogram(z, bins=bins, weights=w)
        if ranks:
            counts = _summed(self.comm, counts)

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
