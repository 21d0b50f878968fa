"""Correlation-function estimators from pair counts (counterpart of
``nbodykit_tpu/algorithms/paircount_tpcf/estimators.py``): analytic
uniform randoms, the natural and Landy-Szalay estimators, and wedges to
multipoles. Host numpy on the counts."""

import numpy as np

from ...binned_statistic import BinnedStatistic


class WedgeBinnedStatistic(BinnedStatistic):
    """A (r, mu) wedge dataset that can rotate into multipoles."""

    def to_poles(self, poles):
        """xi_ell(r) = (2 ell + 1) * sum_wedges xi(r, mu_c) P_ell(mu_c)
        dmu, over the wedge centres."""
        from numpy.polynomial.legendre import legval
        mu_edges = self.edges['mu']
        mu_c = 0.5 * (mu_edges[1:] + mu_edges[:-1])
        dmu = np.diff(mu_edges)
        xi = self['corr']
        data = {}
        for ell in poles:
            c = np.zeros(ell + 1)
            c[ell] = 1.0
            leg = legval(mu_c, c)
            data['corr_%d' % ell] = (2 * ell + 1) * np.nansum(
                xi * leg * dmu, axis=-1)
        data['r'] = self['r'].mean(axis=-1) if self['r'].ndim > 1 \
            else self['r']
        out = BinnedStatistic(['r'], [self.edges['r']], data)
        out.attrs.update(self.attrs)
        return out


def analytic_random_pairs(mode, edges, NR, BoxSize, Nmu=None,
                          pimax=None):
    """Expected (unweighted) pair counts of NR uniform points in a
    periodic box: the RR term without a random catalog. 'angular' takes
    the exact spherical-cap ring fraction (cos(theta_lo) -
    cos(theta_hi)) / 2 of the sphere."""
    V = np.prod(BoxSize)
    edges = np.asarray(edges, dtype='f8')
    if mode == '1d':
        vol = 4.0 / 3 * np.pi * np.diff(edges ** 3)
    elif mode == '2d':
        muedges = np.linspace(0, 1, Nmu + 1)
        vol = (4.0 / 3 * np.pi * np.diff(edges ** 3)[:, None]
               * np.diff(muedges)[None, :])
    elif mode == 'projected':
        piedges = np.arange(0, int(pimax) + 1)
        vol = (np.pi * np.diff(edges ** 2)[:, None]
               * 2.0 * np.diff(piedges)[None, :])
    elif mode == 'angular':
        frac = -0.5 * np.diff(np.cos(np.deg2rad(edges)))
        return NR * (NR - 1) * frac
    else:
        raise ValueError("no analytic randoms for mode %r" % mode)
    return NR * (NR - 1) * vol / V


def natural_estimator(DD, mode, BoxSize, Nmu=None, pimax=None):
    """xi = DD / RR_analytic - 1 with analytic periodic-box randoms."""
    edges = DD.attrs['edges']
    total = DD.attrs['total_wnpairs']
    RRfrac = analytic_random_pairs(mode, edges, 2, BoxSize, Nmu=Nmu,
                                   pimax=pimax) / 2.0
    fDD = DD['wnpairs'] / total
    with np.errstate(invalid='ignore', divide='ignore'):
        xi = fDD / RRfrac.reshape(fDD.shape) - 1.0
    return xi


def landy_szalay(DD, DR, RR, RD=None):
    """xi = (DD - DR - RD + RR) / RR, each count normalised by its total
    weighted pairs."""
    fDD = DD['wnpairs'] / DD.attrs['total_wnpairs']
    fDR = DR['wnpairs'] / DR.attrs['total_wnpairs']
    fRR = RR['wnpairs'] / RR.attrs['total_wnpairs']
    fRD = fDR if RD is None else RD['wnpairs'] / \
        RD.attrs['total_wnpairs']
    with np.errstate(invalid='ignore', divide='ignore'):
        xi = (fDD - fDR - fRD + fRR) / fRR
    return xi
