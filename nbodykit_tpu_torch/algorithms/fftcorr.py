"""FFTCorr: the correlation function xi(r) in a periodic box (counterpart
of ``nbodykit_tpu/algorithms/fftcorr.py``).

The FFTPower estimator taken back to configuration space: the c2r of
the 3-D power over the volume, binned in separation (r, mu) with
multipoles, ``dr=0`` giving one bin per unique lattice separation.
"""

import logging

import numpy as np

from ..binned_statistic import BinnedStatistic
from .fftpower import FFTBase, _find_unique_edges, project_to_basis


class FFTCorr(FFTBase):
    """xi(r), xi(r, mu) and multipoles xi_ell(r) in a periodic box.

    The parameters are :class:`FFTPower`'s with (dr, rmin, rmax) for the
    binning; results in :attr:`corr` / :attr:`poles`.
    """

    logger = logging.getLogger('FFTCorr')

    def __init__(self, first, mode, Nmesh=None, BoxSize=None, second=None,
                 los=[0, 0, 1], Nmu=5, dr=None, rmin=0., rmax=None,
                 poles=[]):
        if mode not in ['1d', '2d']:
            raise ValueError("mode must be '1d' or '2d'")
        if poles is None:
            poles = []
        if np.isscalar(los) or len(los) != 3:
            raise ValueError("line-of-sight must be a 3-vector")

        FFTBase.__init__(self, first, second, Nmesh, BoxSize)

        self.attrs['mode'] = mode
        self.attrs['los'] = los
        self.attrs['Nmu'] = Nmu
        self.attrs['poles'] = poles
        if dr is None:
            dr = self.attrs['BoxSize'].min() / self.attrs['Nmesh'].min()
        self.attrs['dr'] = dr
        self.attrs['rmin'] = rmin
        self.attrs['rmax'] = rmax

        self.corr, self.poles = self.run()
        self.attrs.update(self.corr.attrs)

    def run(self):
        if self.attrs['mode'] == '1d':
            self.attrs['Nmu'] = 1

        y3d, attrs = self._compute_3d_power(self.first, self.second)
        # back to configuration space: L^3 cancels with dk^3, so xi is
        # the inverse transform of p3d over V
        xi3d = y3d.c2r()
        del y3d
        xi3d.value /= float(self.attrs['BoxSize'].prod())

        dr = self.attrs['dr']
        rmin = self.attrs['rmin']
        rmax = self.attrs['rmax']
        if rmax is None:
            rmax = 0.5 * xi3d.pm.BoxSize.min() + dr / 2
        if dr > 0:
            redges = np.arange(rmin, rmax, dr)
            rcoords = None
        else:
            redges, rcoords = _find_unique_edges(xi3d.pm, rmax,
                                                 kind='real')

        muedges = np.linspace(0, 1, self.attrs['Nmu'] + 1, endpoint=True)
        edges = [redges, muedges]
        coords = [rcoords, None]
        result, pole_result = project_to_basis(
            xi3d, edges, poles=self.attrs['poles'], los=self.attrs['los'])

        if self.attrs['mode'] == '1d':
            cols = ['r', 'corr', 'modes']
            icols = [0, 2, 3]
            edges = edges[0:1]
            coords = coords[0:1]
        else:
            cols = ['r', 'mu', 'corr', 'modes']
            icols = [0, 1, 2, 3]

        dtype = np.dtype([(name, result[icol].dtype.str)
                          for icol, name in zip(icols, cols)])
        corr = np.squeeze(np.empty(result[0].shape, dtype=dtype))
        for icol, col in zip(icols, cols):
            corr[col][:] = np.squeeze(result[icol])

        poles = None
        if pole_result is not None:
            r, pole_arr, N = pole_result
            cols = ['r'] + ['corr_%d' % l for l in self.attrs['poles']] \
                + ['modes']
            vals = [r] + [p for p in pole_arr] + [N]
            dtype = np.dtype([(name, vals[i].dtype.str)
                              for i, name in enumerate(cols)])
            poles = np.empty(vals[0].shape, dtype=dtype)
            for i, col in enumerate(cols):
                poles[col][:] = vals[i]

        return self._make_datasets(edges, poles, corr, coords, attrs)

    def _make_datasets(self, edges, poles, corr, coords, attrs):
        dims = ['r'] if self.attrs['mode'] == '1d' else ['r', 'mu']
        corr = BinnedStatistic(dims, edges, corr, fields_to_sum=['modes'],
                               coords=coords, **attrs)
        if poles is not None:
            poles = BinnedStatistic(['r'], [corr.edges['r']], poles,
                                    fields_to_sum=['modes'],
                                    coords=[corr.coords['r']], **attrs)
        return corr, poles

    def __getstate__(self):
        return dict(corr=self.corr.__getstate__(),
                    poles=self.poles.__getstate__()
                    if self.poles is not None else None,
                    attrs=self.attrs)

    def __setstate__(self, state):
        self.attrs = state['attrs']
        self.corr = BinnedStatistic.from_state(state['corr'])
        self.poles = BinnedStatistic.from_state(state['poles']) \
            if state['poles'] is not None else None
